"""Exact-length real DFTs — the reference's grain FFTs run at the true
grain length (np.fft.rfft(x) with n = len(x), main_v2.py:39-163), not at
a padded power of two.  This module gives the spectral chain that
exact-n API over `jnp.fft`, which takes any n on every backend.

Semantics match np.fft.rfft / np.fft.irfft(Z, n=n) for any n >= 2,
odd or even.
"""
from __future__ import annotations

import jax.numpy as jnp


def rfft_n(x, n: int):
    """np.fft.rfft(x[..., :n]) at the EXACT length n (static host int).
    `x` may be longer than n (the grain buffers are padded; samples at or
    beyond n are ignored).  Returns complex64 [..., n//2 + 1]."""
    n = int(n)
    if x.shape[-1] != n:
        x = x[..., :n]
    return jnp.fft.rfft(x)


def irfft_n(Z, n: int, out_len: int | None = None):
    """np.fft.irfft(Z, n=n) at the exact length n as float32; optionally
    zero-padded back out to `out_len` (the grain buffer length L)."""
    y = jnp.fft.irfft(Z, n=int(n)).astype(jnp.float32)
    if out_len is not None and out_len > n:
        y = jnp.pad(y, ((0, 0),) * (y.ndim - 1) + ((0, out_len - n),))
    return y
