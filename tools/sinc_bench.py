"""Sinc-vs-linear interpolation RTF on the current JAX device (the
north-star note's quality-mode resampler numbers).

    python tools/sinc_bench.py
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


def drain(y):
    return float(jnp.sum(jnp.abs(jnp.ravel(y)).astype(jnp.float32)))


def time_device(fn, K=5):
    y = fn()
    drain(y)
    t0 = time.perf_counter()
    for _ in range(K):
        y = fn()
    drain(y)
    return (time.perf_counter() - t0) / K


def test_audio(sr, seconds, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
         + 0.1 * rng.standard_normal(t.size))
    return (x / np.max(np.abs(x))).astype(np.float32)


def main():
    from audio_suite_tpu.models import tape, scrub
    print("device:", jax.devices()[0])
    sr = 48000
    seconds = 180.0
    audio = test_audio(sr, seconds)
    n = len(audio)
    markers = [int(n * f) for f in (0.12, 0.3, 0.45, 0.6, 0.8)]
    params = tape.TapeParams(
        sample_rate=sr, markers=markers,
        section_speeds=[1.0, 2.0, 0.5, 4.0, 0.25, 1.5],
        section_reverse=[False, True, False, True, False, False],
        tape_age=60, enable_splice_fx=True, anticlick_enabled=True)
    params.section_speeds = tape.fit_to_target_time(params, n, seconds)
    frames = tape.section_render_length(params, n)
    adev = jax.device_put(jnp.asarray(audio))
    adev.block_until_ready()
    prog = tape.build_tape_program(adev, params, frames, with_mod=False)
    asec = frames / sr

    t_lin = time_device(lambda: tape.tape_table_render(
        prog, device_out=True)[0])
    print(f"tape linear: {t_lin*1e3:.1f} ms  RTF {asec/t_lin:.0f}")
    t_new = time_device(lambda: tape.tape_table_render(
        prog, device_out=True, interp="sinc")[0])
    print(f"tape sinc: {t_new*1e3:.1f} ms  RTF {asec/t_new:.0f}")

    s_audio = test_audio(sr, 10.0)
    s_seconds = 30.0
    blocks = int(s_seconds * sr / scrub.BLOCK_SIZE)
    cfg = scrub.ScrubConfig(sample_rate=sr, head_count=3)
    trace = scrub.scripted_gesture_trace(
        blocks, sr, drag_events=[(2.0, 8.0, 3.0), (10.0, -14.0, 4.0),
                                 (20.0, 4.0, 5.0)],
        base_speed=0.5, jumps=[(15.0, 1000.0)])
    audio_sec = blocks * scrub.BLOCK_SIZE / sr

    t_slin = time_device(lambda: scrub.render_scrub(
        s_audio, cfg, trace, device_out=True))
    print(f"scrub linear: {t_slin*1e3:.1f} ms  RTF {audio_sec/t_slin:.0f}")
    t_snew = time_device(lambda: scrub.render_scrub(
        s_audio, cfg, trace, device_out=True, interp="sinc"))
    print(f"scrub sinc: {t_snew*1e3:.1f} ms  RTF {audio_sec/t_snew:.0f}")


if __name__ == "__main__":
    main()
