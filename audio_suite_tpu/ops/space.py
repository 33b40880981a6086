"""Space/'room as microsound' FX — ports of microsound_0.2.1/main_v2.py:409-445.

- early_reflection_cloud: the reference's per-tap delay loop becomes a sparse
  tap kernel (built host-side from the same RNG draws) convolved via
  partitioned FFT convolution.
- convolve_ir_short: np.convolve(x, ir, 'full')[:len(x)] == causal FIR —
  same partitioned FFT path (the BASELINE.json "partitioned FFT convolution"
  requirement).
- spectral_diffusion_stereo: asymmetric np.roll delays + sinusoidal phase
  rotation on the right channel.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import jax.numpy as jnp


def fft_convolve_causal(x, kernel, block: int = 1 << 17):
    """y[:len(x)] of np.convolve(x, kernel) via overlap-add partitioned FFT.

    x: f32[N], kernel: f32[K].  The hop is exactly nfft/2, so each output
    position receives contributions from exactly two frames and the
    overlap-add is a reshape + shifted add — no scatter.
    Bounded memory for minute-long renders (SURVEY.md §5).
    """
    x = jnp.asarray(x, jnp.float32)
    kernel = jnp.asarray(kernel, jnp.float32)
    N = x.shape[0]
    K = kernel.shape[0]
    if K == 0:
        return jnp.zeros_like(x)
    # cap the FFT size at 2^16: the frame batch [nblocks, nfft] is what
    # the partition holds in memory, so the cap bounds it for minute-long
    # renders whatever the kernel length; the extra blocks are cheap
    nfft = 1
    while nfft < max(2 * (K - 1), min(2 * block, 2 * N, 1 << 16), 16):
        nfft *= 2
    hop = nfft // 2                     # K - 1 <= hop by construction
    nblocks = (N + hop - 1) // hop
    pad_n = nblocks * hop
    xp = jnp.zeros(pad_n, jnp.float32).at[:N].set(x)
    frames = xp.reshape(nblocks, hop)
    Kf = jnp.fft.rfft(jnp.zeros(nfft, jnp.float32).at[:K].set(kernel))
    fp = jnp.concatenate(
        [frames, jnp.zeros((nblocks, nfft - hop), jnp.float32)], axis=-1)
    Y = jnp.fft.irfft(jnp.fft.rfft(fp) * Kf[None, :], n=nfft) \
        .astype(jnp.float32)
    # out[b*hop : (b+1)*hop] = Y[b, :hop] + Y[b-1, hop:]
    h1 = Y[:, :hop]
    h2 = jnp.concatenate([jnp.zeros((1, hop), jnp.float32), Y[:-1, hop:]])
    return (h1 + h2).reshape(-1)[:N]


def er_tap_kernel(taps: int, max_ms: float, sr: int, seed: int) -> np.ndarray:
    """Host: the reflection cloud's tap kernel (delays/gains exactly as
    main_v2.py:409-421, rng(seed+202): delays U(0.3,max_ms) ms, gains
    U(-1,1)*e^{-42 d}; identity tap at 0 for the dry copy)."""
    rng = np.random.default_rng(int(seed) + 202)
    delays = rng.uniform(0.3, max_ms, size=int(max(1, taps))) / 1000.0
    gains = rng.uniform(-1.0, 1.0, size=delays.size)
    gains *= np.exp(-delays * 42.0)
    k = np.zeros(int(round(max_ms / 1000.0 * sr)) + 2, np.float64)
    k[0] = 1.0
    for d, g in zip(delays, gains):
        off = int(round(d * sr))
        if off <= 0:
            continue
        if off < len(k):
            k[off] += g
    return k.astype(np.float32)


def _bessel_j(m: int, phi: float) -> float:
    """J_m(phi) by its power series (f64; converges in a few terms for the
    phi <= 0.9 this module uses).  No scipy in the image."""
    m = abs(int(m))
    term = (phi / 2.0) ** m / math.factorial(m)
    total = term
    for s in range(1, 24):
        term *= -(phi / 2.0) ** 2 / (s * (s + m))
        total += term
    return total


@lru_cache(maxsize=32)
def _diffusion_taps(phi: float) -> tuple:
    """The widener's phase rotation exp(i*phi*sin(4*pi*k/n)) is, by the
    Jacobi-Anger expansion, EXACTLY the circular sparse FIR
    sum_m J_m(phi) * shift(2m) — J_m decays superexponentially, so
    truncating where |J_m| < 1e-12 differs from the reference's FFT
    version (main_v2.py:423-436) by ~-240 dB.  Returns ((offset, w), ...)
    with even offsets 2m."""
    taps = []
    for m in range(-16, 17):
        w = _bessel_j(m, phi) * (-1.0 if (m < 0 and (m % 2) != 0) else 1.0)
        # J_{-m} = (-1)^m J_m
        if abs(w) >= 1e-12:
            taps.append((2 * m, float(np.float32(w))))
    return tuple(taps)


def spectral_diffusion_stereo(x, sr: int, width: float = 0.6):
    """Stereo widener (main_v2.py:423-436): circular rolls + phase rotation
    of the right channel. Returns [N, 2].

    The rotation runs as its exact Bessel-series sparse FIR (see
    _diffusion_taps) instead of an N-point FFT pair: the render lengths
    here are not powers of two, and a ~768 k-point Bluestein transform
    alone cost more device time than the rest of the FX chain."""
    width = float(np.clip(width, 0.0, 1.0))
    n = x.shape[0]
    if n < 64:
        return jnp.stack([x, x], axis=-1)
    dl = int(round((1 + 7 * width) * 0.0005 * sr))
    dr = int(round((1 + 9 * width) * 0.0007 * sr))
    L = jnp.roll(x, dl)
    R = jnp.roll(x, -dr)
    R2 = jnp.zeros_like(R)
    for off, w in _diffusion_taps(width * 0.9):
        R2 = R2 + jnp.float32(w) * jnp.roll(R, -off)
    return jnp.stack([L, R2], axis=-1)


def soft_clip(x, drive: float = 1.0):
    """tanh soft clip (main_v2.py:31-34)."""
    drive = float(drive)
    if drive <= 0:
        return x
    return jnp.tanh(x * drive) / np.tanh(drive)


def normalize(x, peak: float = 0.98):
    """Scale to peak (up or down, main_v2.py:26-29)."""
    m = jnp.max(jnp.abs(x))
    return jnp.where(m <= 0, x, x * (peak / jnp.maximum(m, 1e-30)))


def normalize_masked(x, mask, peak: float = 0.98):
    """normalize() where the peak is taken over the masked (true-length)
    region only — for padded grain buffers."""
    m = jnp.max(jnp.abs(jnp.where(mask, x, 0.0)))
    return jnp.where(m <= 0, x, x * (jnp.float32(peak) / jnp.maximum(m, 1e-30)))
