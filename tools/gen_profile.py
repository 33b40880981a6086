"""Micro-profile of the microsound generate internals on the device:
noise hash vs FFT pair vs envelopes at the bench-config grain shapes.

    python tools/gen_profile.py
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
from audio_suite_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import time
import numpy as np
import jax
import jax.numpy as jnp

from audio_suite_tpu.ops import noise


def drain(y):
    return float(jnp.sum(jnp.abs(jnp.ravel(y)).astype(jnp.float32)))


def time_device(fn, *args, K=10):
    y = fn(*args)
    drain(y)
    t0 = time.perf_counter()
    for _ in range(K):
        y = fn(*args)
    drain(y)
    return (time.perf_counter() - t0) / K


def main():
    print("device:", jax.devices()[0])
    E, L = 270, 32768
    seeds = jnp.arange(E, dtype=jnp.uint32) + 1000
    i = jnp.arange(L, dtype=jnp.int32)

    f_normal = jax.jit(lambda s: jax.vmap(
        lambda sd: noise.normal(sd, i, 0))(s))
    t = time_device(f_normal, seeds)
    print(f"normal [E,L] (12 hashes/sample): {t*1e3:.2f} ms")

    f_uni = jax.jit(lambda s: jax.vmap(
        lambda sd: noise.uniform(sd, i, 0))(s))
    t = time_device(f_uni, seeds)
    print(f"uniform [E,L] (1 hash/sample): {t*1e3:.2f} ms")

    x = jnp.asarray(np.random.default_rng(0)
                    .standard_normal((E, L)).astype(np.float32))
    f_rt = jax.jit(lambda v: jnp.fft.irfft(jnp.fft.rfft(v), n=L)
                   .astype(jnp.float32))
    t = time_device(f_rt, x)
    print(f"rfft+irfft roundtrip [E,L]: {t*1e3:.2f} ms")

    f_rfft = jax.jit(lambda v: jnp.fft.rfft(v))
    t = time_device(f_rfft, x)
    print(f"rfft [E,L]: {t*1e3:.2f} ms")

    f_env = jax.jit(lambda v: v * jnp.exp(
        -i.astype(jnp.float32) * jnp.float32(1e-6))[None, :])
    t = time_device(f_env, x)
    print(f"exp envelope mul [E,L]: {t*1e3:.2f} ms")


if __name__ == "__main__":
    main()
