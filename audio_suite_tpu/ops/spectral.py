"""Spectral kernels for Microsound grains — ports of the rfft-domain DSP in
microsound_0.2.1/main_v2.py:39-163, vectorized/vmappable over grain batches.

Exact-length semantics (round 5): every op takes `n_fft` — the TRUE grain
length (static host int).  When given, the transform runs at exactly n_fft
(ops/exact_dft.py), the bin
grid is n_fft's, and the reference's short-grain guards apply
(main_v2.py:41,63,105,118,132,152: ops are identity below 8/16/64
samples) — matching the reference's exact-n rfft bit grid at ANY micro_ms.
Outputs are zero-padded back to the static buffer length L.

With n_fft=None the legacy padded-length convention remains (FFT at the
pow2 buffer length; documented framework semantics used by the
mixed-length fallback until the traced-n path lands).

`sr` may be traced (per-event design rates under bp_unfold automation).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import exact_dft


def _freqs(L: int, sr):
    """rfftfreq for padded length L at sample rate sr (main_v2.py:36-37)."""
    return jnp.arange(L // 2 + 1, dtype=jnp.float32) * (
        jnp.asarray(sr, jnp.float32) / jnp.float32(L))


def lowpass_fft(x, sr, cutoff, roll=0.0, n_fft=None):
    """FFT lowpass with cosine rolloff band (main_v2.py:39-59).  With
    n_fft the transform and bin grid run at the exact grain length
    (identity below 8 samples, main_v2.py:41)."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 8:
        return x
    nfft = int(n_fft) if n_fft is not None else L
    X = exact_dft.rfft_n(x, nfft)
    gain = _lowpass_gain(nfft, sr, cutoff, roll)
    return exact_dft.irfft_n(X * gain, nfft, out_len=L)


def bandpass_fft(x, sr, lo, hi, roll=0.0, n_fft=None):
    """FFT bandpass with cosine rolloffs (main_v2.py:61-101).  With n_fft
    the transform runs at the exact grain length (identity below 8
    samples, main_v2.py:63)."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 8:
        return x
    nfft = int(n_fft) if n_fft is not None else L
    nyq = 0.5 * jnp.asarray(sr, jnp.float32)
    lo = jnp.maximum(0.0, jnp.asarray(lo, jnp.float32))
    hi = jnp.minimum(jnp.maximum(lo, jnp.asarray(hi, jnp.float32)), nyq)
    roll = jnp.maximum(jnp.asarray(roll, jnp.float32), 0.0)
    X = exact_dft.rfft_n(x, nfft)
    f = _freqs(nfft, sr)

    # low edge (0 -> 1 over [lo-roll, lo])
    lo_f0 = jnp.maximum(0.0, lo - roll)
    t_lo = (f - lo_f0) / jnp.maximum(1e-12, lo - lo_f0)
    w_lo = 0.5 * (1.0 - jnp.cos(jnp.pi * jnp.clip(t_lo, 0.0, 1.0)))
    g_lo_roll = jnp.where(f < lo_f0, 0.0, jnp.where(f <= lo, w_lo, 1.0))
    g_lo_hard = jnp.where(f < lo, 0.0, 1.0)
    g_lo = jnp.where(lo > 0, jnp.where(roll <= 0, g_lo_hard, g_lo_roll), 1.0)

    # high edge (1 -> 0 over [hi, hi+roll])
    hi_f1 = jnp.minimum(nyq, hi + roll)
    t_hi = (f - hi) / jnp.maximum(1e-12, hi_f1 - hi)
    w_hi = 0.5 * (1.0 + jnp.cos(jnp.pi * jnp.clip(t_hi, 0.0, 1.0)))
    g_hi_roll = jnp.where(f > hi_f1, 0.0, jnp.where(f >= hi, w_hi, 1.0))
    g_hi_hard = jnp.where(f > hi, 0.0, 1.0)
    g_hi = jnp.where(hi < nyq, jnp.where(roll <= 0, g_hi_hard, g_hi_roll), 1.0)

    y = exact_dft.irfft_n(X * (g_lo * g_hi), nfft, out_len=L)
    return jnp.where(hi <= 0, jnp.zeros_like(y), y)


def _lerp_uniform(y, pos):
    """Linear interpolation of y (defined on the uniform grid 0..len-1) at
    fractional positions `pos`, zero outside the grid.  The uniform grid
    makes jnp.interp's per-query binary search unnecessary — direct
    index arithmetic instead."""
    nf = y.shape[-1]
    valid = (pos >= 0.0) & (pos <= jnp.float32(nf - 1))
    i0 = jnp.clip(jnp.floor(pos), 0.0, jnp.float32(nf - 2))
    t = pos - i0
    i0 = i0.astype(jnp.int32)
    v = y[i0] * (jnp.float32(1.0) - t) + y[i0 + 1] * t
    return jnp.where(valid, v, 0.0)


def _interp_spectrum(X, k_in):
    """np.interp of Re/Im at fractional bin positions, zero outside
    (main_v2.py:110-114).  Lerp on complex64 directly: scaling a complex by
    a real is per-component, so this equals separate Re/Im interpolation
    while halving the gathers."""
    return _lerp_uniform(X, k_in)


def _lerp_uniform_affine(y, scale, block: int = 512, max_scale: float = 4.0):
    """Gather-free lerp of y (uniform grid 0..nf-1) at AFFINE positions
    k*scale, zero outside the grid.

    Affine positions are monotone with
    bounded step, so each output block of `block` bins only reads a
    contiguous input window of ~max_scale*block bins.  Selection from the
    window is decomposed two-level — local = hi*128 + lo — so each output
    bin costs one 128-wide one-hot row (a matmul against the window
    reshaped [H, 128]) plus an H-wide one-hot mask-sum, O(128 + Wd/128)
    per bin instead of the O(Wd) single-level banded matrix (which was the
    grain chain's hot spot: 78 ms of an 85 ms chain at 270x16385).
    Out-of-window positions produce zeros (no one-hot row matches), so the
    kernel is safe for any scale; positions are only *in*-window (i.e.
    results match the gather lerp) for scale <= max_scale — the
    reference's stretch range is [0.25, 4] (main_v2.py:1006).

    Exactness: the two-level product selects exactly one element per level
    (products with 1.0/0.0, sums over a single nonzero), so a and b are
    EXACT selections and the final (1-t)*a + t*b matches the gather lerp
    bit-for-bit."""
    nf = y.shape[-1]
    A = -(-nf // block)
    nf_pad = A * block
    H = -(-(int(max_scale * block) + 8) // 128)
    Wd = H * 128
    ypad = jnp.concatenate([y, jnp.zeros(nf_pad + Wd + 128 - nf, y.dtype)])
    scale = jnp.asarray(scale, jnp.float32)
    is_complex = jnp.iscomplexobj(y)
    lo_iota = jnp.arange(128, dtype=jnp.int32)[None, :]
    hi_iota = jnp.arange(H, dtype=jnp.int32)[None, :]

    def two_level(x0, oh_lo, oh_hi):
        # x0: [H, 128] window; exact one-element selection per output bin
        sel = jnp.dot(oh_lo, x0.T, precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(oh_hi * sel, axis=1)

    def blk(_, a):
        k = (a * block + jnp.arange(block, dtype=jnp.int32)) \
            .astype(jnp.float32)
        pos = k * scale
        valid = (pos >= 0.0) & (pos <= jnp.float32(nf - 1))
        i0 = jnp.clip(jnp.floor(pos), 0.0, jnp.float32(nf - 2))
        t = pos - i0
        win = jnp.clip(
            jnp.floor(a.astype(jnp.float32) * jnp.float32(block) * scale)
            .astype(jnp.int32) - 2,
            0, nf_pad)
        local = i0.astype(jnp.int32) - win
        hi = local >> 7                       # arithmetic shift: local < 0
        lo = local - (hi << 7)                # ... still lands in [0, 128)
        oh_lo = (lo_iota == lo[:, None]).astype(jnp.float32)
        oh_hi = (hi_iota == hi[:, None]).astype(jnp.float32)
        # neighbor local+1 = the same one-hots over the 1-shifted window
        xw = jax.lax.dynamic_slice(ypad, (win,), (Wd + 128,))

        def lerp_part(xw_r):
            x0 = xw_r[:Wd].reshape(H, 128)
            x1 = xw_r[1:Wd + 1].reshape(H, 128)
            va = two_level(x0, oh_lo, oh_hi)
            vb = two_level(x1, oh_lo, oh_hi)
            return va * (jnp.float32(1.0) - t) + vb * t

        if is_complex:
            out = lerp_part(xw.real) + 1j * lerp_part(xw.imag)
        else:
            out = lerp_part(xw)
        out = out * valid.astype(jnp.float32)
        return None, out

    _, blocks = jax.lax.scan(blk, None, jnp.arange(A, dtype=jnp.int32))
    return blocks.reshape(-1)[:nf]


def fft_warp_power(x, power, n_fft=None):
    """Power-law frequency warp (main_v2.py:103-115).  With n_fft the
    warp grid is the exact grain length's (identity below 16 samples,
    main_v2.py:105).

    The warp grid is precomputed in f64 on the host when `power` is a
    concrete config constant (it always is from the engines —
    ChainCfg.nl_warp_power is static): a device f32 pow may be only
    ~1e-6 accurate, and its position error flips floor() bin decisions
    near kmax — -31 dBFS against the f64 oracle before this fix
    (tools/parity.py "microsound warp hi-rate").  With the host
    grid only the lerp arithmetic itself remains f32."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 16:
        return x
    nfft = int(n_fft) if n_fft is not None else L
    X = exact_dft.rfft_n(x, nfft)
    nf = X.shape[-1]
    if isinstance(power, (int, float, np.floating, np.integer)):
        k = np.arange(nf, dtype=np.float64)
        kmax = max(1.0, float(nf - 1))
        pos = (k / kmax) ** (1.0 / max(1e-6, float(power))) * kmax
        i0 = np.clip(np.floor(pos), 0.0, nf - 2).astype(np.int32)
        t = (pos - i0).astype(np.float32)   # pos in [0, kmax]: all valid
        Y = X[..., i0] * (np.float32(1.0) - t) + X[..., i0 + 1] * t
        return exact_dft.irfft_n(Y, nfft, out_len=L)
    k = jnp.arange(nf, dtype=jnp.float32)   # traced fallback
    kmax = jnp.maximum(1.0, k[-1])
    u = k / kmax
    u_in = jnp.power(u, 1.0 / jnp.maximum(1e-6, jnp.asarray(power, jnp.float32)))
    Y = _interp_spectrum(X, u_in * kmax)
    return exact_dft.irfft_n(Y, nfft, out_len=L)


def _lowpass_gain(L, sr, cutoff, roll):
    """The lowpass_fft gain curve [nf] for scalar (sr, cutoff, roll) —
    factored so the vmapped and batch-shared stretch paths use the
    identical arithmetic (main_v2.py:39-59 band shape)."""
    nyq = 0.5 * jnp.asarray(sr, jnp.float32)
    cutoff = jnp.clip(jnp.asarray(cutoff, jnp.float32), 1.0, nyq)
    roll = jnp.maximum(jnp.asarray(roll, jnp.float32), 0.0)
    f = _freqs(L, sr)
    f1 = jnp.minimum(nyq, cutoff + roll)
    t = (f - cutoff) / jnp.maximum(1e-12, f1 - cutoff)
    w_roll = 0.5 * (1.0 + jnp.cos(jnp.pi * jnp.clip(t, 0.0, 1.0)))
    gain_rolloff = jnp.where(f > f1, 0.0, jnp.where(f >= cutoff, w_roll, 1.0))
    gain_hard = jnp.where(f > cutoff, 0.0, 1.0)
    return jnp.where(roll <= 0, gain_hard, gain_rolloff)


def lowpass_stretch_fused(x, sr, cutoff, factor, roll=0.0, n_fft=None):
    """lowpass_fft followed by fft_partial_stretch in ONE spectral pass
    (2 transforms instead of 4): the irfft/rfft round-trip between them is
    the identity up to f32 rounding, so fusing matches the sequential pair
    within ~1 ulp (the oracle keeps the sequential structure; parity budget
    is -60 dBFS).  With n_fft both stages run on the exact grain length's
    bin grid; the reference's guards (lowpass identity below 8, stretch
    identity below 16) apply stage-wise."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 16:
        # stretch is identity below 16; lowpass below 8 — fall back to
        # the unfused lowpass so the guards match the reference stagewise
        return lowpass_fft(x, sr, cutoff, roll=roll, n_fft=n_fft)
    nfft = int(n_fft) if n_fft is not None else L
    X = exact_dft.rfft_n(x, nfft)
    Xg = X * _lowpass_gain(nfft, sr, cutoff, roll)

    factor = jnp.asarray(factor, jnp.float32)
    inv_f = jnp.float32(1.0) / jnp.maximum(1e-12, factor)
    Y = _lerp_uniform_affine(Xg, inv_f)
    Z = jnp.where(jnp.abs(factor - 1.0) < 1e-9, Xg, Y)
    return exact_dft.irfft_n(Z, nfft, out_len=L)


def lowpass_stretch_fused_shared(x, sr_v, cutoff_v, factor, roll=0.0,
                                 block: int = 128, max_scale: float = 4.0,
                                 shared_gain: bool = False, n_fft=None):
    """Batched lowpass_stretch_fused for a grain bank [E, L] whose stretch
    factor is SHARED across events (per-event cutoff/sr still vary).

    Under vmap the per-event traced scale makes XLA rebuild the selection
    one-hots for every event — E x nf x (128+H) element ops that dominated
    the grain chain.  With one shared scale the one-hots are built once per
    block and every event rides the same matmuls.

    All A output blocks are batched into ONE einsum (a per-block lax.scan
    serializes A=128 small matmuls).  Selection is a SINGLE one-hot over
    each block's whole window, contracted as [A,B,W]x[A,E,W] (the two-level
    lo/hi form materialized [A,E,H,128] reshapes and an [A,E,B,H]
    broadcast-reduce — XLA cost_analysis counted 6.7 GB of memory traffic;
    the flat form touches ~10x fewer bytes).  One nonzero product per
    output row, so results stay
    bit-identical to a direct gather."""
    E, L = x.shape
    if n_fft is not None and int(n_fft) < 16:
        return lowpass_fft(x, sr_v[:, None] if np.ndim(sr_v) else sr_v,
                           cutoff_v[:, None] if np.ndim(cutoff_v)
                           else cutoff_v, roll=roll, n_fft=n_fft)
    nfft = int(n_fft) if n_fft is not None else L
    if max_scale <= 0.5:
        # small selection window (downward stretch): double the block —
        # half the window-fetch iterations and bytes at identical einsum
        # flops (A halves, B doubles, W stays at the 256 floor)
        block = max(block, 256)
    X = exact_dft.rfft_n(x, nfft)
    nf = X.shape[-1]
    sr_v = jnp.asarray(sr_v, jnp.float32)
    cutoff_v = jnp.asarray(cutoff_v, jnp.float32)
    if shared_gain:
        # every event shares (sr, cutoff): one [nf] curve broadcast — the
        # identical per-element arithmetic, minus the [E, nf] cos batch
        Xg = X * _lowpass_gain(nfft, sr_v[0], cutoff_v[0], roll)[None, :]
    else:
        gains = jax.vmap(lambda s, c: _lowpass_gain(nfft, s, c, roll))(
            sr_v, cutoff_v)
        Xg = X * gains

    factor = jnp.asarray(factor, jnp.float32)
    scale = jnp.float32(1.0) / jnp.maximum(1e-12, factor)
    A = -(-nf // block)
    nf_pad = A * block
    H = -(-(int(max_scale * block) + 8) // 128)
    Wd = H * 128
    W = Wd + 128
    Xpad = jnp.concatenate(
        [Xg, jnp.zeros((E, nf_pad + W - nf), Xg.dtype)], axis=-1)

    a = jnp.arange(A, dtype=jnp.int32)
    k = (a[:, None] * block
         + jnp.arange(block, dtype=jnp.int32)[None, :]).astype(jnp.float32)
    pos = k * scale                                   # [A, B]
    valid = (pos >= 0.0) & (pos <= jnp.float32(nf - 1))
    i0 = jnp.clip(jnp.floor(pos), 0.0, jnp.float32(nf - 2))
    t = pos - i0
    win = jnp.clip(
        jnp.floor(a.astype(jnp.float32) * jnp.float32(block) * scale)
        .astype(jnp.int32) - 2,
        0, nf_pad)                                    # [A]
    local = i0.astype(jnp.int32) - win[:, None]       # [A, B] in [0, Wd)
    w_iota = jnp.arange(W, dtype=jnp.int32)[None, None, :]
    oh0 = (w_iota == local[..., None]).astype(jnp.float32)        # [A,B,W]
    oh1 = (w_iota == (local + 1)[..., None]).astype(jnp.float32)  # [A,B,W]
    # fold the lerp weights AND the validity mask into ONE selection
    # matrix (two nonzeros per output row: 1-t at lane i0, t at i0+1) so
    # the contraction is a single einsum instead of two plus two [A,E,B]
    # elementwise combine passes.  Exactness: the reduction sums exactly
    # two nonzero f32-faithful products — the same (1-t)*a + t*b the
    # separate einsums computed (zeros perturb nothing, two-term sums are
    # order-independent).
    vm = valid.astype(jnp.float32)
    wA = (oh0 * ((jnp.float32(1.0) - t) * vm)[..., None]
          + oh1 * (t * vm)[..., None])                            # [A,B,W]
    xw = jax.vmap(
        lambda w: jax.lax.dynamic_slice(Xpad, (0, w), (E, W)))(win)

    def lerp_part(xw_r):
        # [A,B,W] x [A,E,W] -> [A,E,B] at HIGHEST precision (exact selection)
        return jnp.einsum("abw,aew->aeb", wA, xw_r,
                          precision=jax.lax.Precision.HIGHEST)

    out = lerp_part(xw.real) + 1j * lerp_part(xw.imag)
    # out: [A, E, block] -> [E, nf]
    Y = jnp.moveaxis(out, 0, 1).reshape(E, nf_pad)[:, :nf]
    Z = jnp.where(jnp.abs(factor - 1.0) < 1e-9, Xg, Y)
    return exact_dft.irfft_n(Z, nfft, out_len=L)


def fft_partial_stretch(x, factor, n_fft=None):
    """Linear partial stretch via spectrum resampling (main_v2.py:117-128).
    The resample positions k/factor are affine, so the gather-free blockwise
    matmul lerp applies.  With n_fft the bin grid is the exact grain length's
    (identity below 16 samples, main_v2.py:118)."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 16:
        return x
    nfft = int(n_fft) if n_fft is not None else L
    X = exact_dft.rfft_n(x, nfft)
    inv_f = jnp.float32(1.0) / jnp.maximum(
        1e-12, jnp.asarray(factor, jnp.float32))
    Y = _lerp_uniform_affine(X, inv_f)
    y = exact_dft.irfft_n(Y, nfft, out_len=L)
    return jnp.where(jnp.abs(jnp.asarray(factor, jnp.float32) - 1.0) < 1e-9,
                     x, y)


def partial_lock_stretch(x, factor, top_n: int = 24, neighborhood: int = 4,
                         n_fft=None):
    """Peak-locked stretch: top-N spectral peaks remapped k -> k*factor with
    triangular spread + 0.12 dry (main_v2.py:130-148).  With n_fft the
    peak grid is the exact grain length's (identity below 64 samples,
    main_v2.py:132)."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 64:
        return x
    nfft = int(n_fft) if n_fft is not None else L
    X = exact_dft.rfft_n(x, nfft)
    nf = X.shape[-1]
    mag = jnp.abs(X)
    _, rel = jax.lax.top_k(mag[1:], top_n)
    peaks = rel.astype(jnp.int32) + 1
    k2 = jnp.round(peaks.astype(jnp.float32)
                   * jnp.asarray(factor, jnp.float32)).astype(jnp.int32)
    Y = jnp.zeros_like(X)
    for d in range(-neighborhood, neighborhood + 1):
        w = jnp.float32(1.0 - (abs(d) / (neighborhood + 1)))
        kk = k2 + d
        ok = (kk >= 1) & (kk < nf)
        Y = Y.at[jnp.where(ok, kk, nf)].add(
            jnp.where(ok, X[peaks] * w, 0.0), mode="drop")
    Y = Y + jnp.complex64(0.12) * X
    y = exact_dft.irfft_n(Y, nfft, out_len=L)
    return jnp.where(jnp.abs(jnp.asarray(factor, jnp.float32) - 1.0) < 1e-9,
                     x, y)


def cepstral_warp(x, factor, n_fft=None):
    """Cepstral envelope warp (main_v2.py:150-163).  With n_fft the whole
    cepstral round-trip runs at the exact grain length (identity below 64
    samples, main_v2.py:152).

    Framework semantics: the reference floors the magnitude at +1e-12
    absolute (f64).  In f32, bins the preceding filters zeroed carry FFT
    round-trip noise (~1e-7 relative), and log() of that noise floor is
    backend-dependent by several units, which the quefrency warp then smears
    across the whole spectrum.  The floor is therefore RELATIVE:
    max(mag, 1e-4 * peak) — a -80 dBFS spectral floor, below which the
    envelope is meaningless anyway."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 64:
        return x
    nfft = int(n_fft) if n_fft is not None else L
    X = exact_dft.rfft_n(x, nfft)
    mag = jnp.abs(X)
    floor = jnp.float32(1e-4) * jnp.maximum(jnp.max(mag), 1e-30)
    logmag = jnp.log(jnp.maximum(mag, floor))
    cep = exact_dft.irfft_n(
        jax.lax.complex(logmag, jnp.zeros_like(logmag)), nfft)
    if isinstance(factor, (int, float, np.floating, np.integer)):
        # static config factor: f64 host quefrency grid (same rationale
        # as fft_warp_power — f32 position division flips floor() bins)
        pos = (np.arange(nfft, dtype=np.float64)
               / max(1e-12, float(factor)))
        valid = pos <= float(nfft - 1)
        i0 = np.clip(np.floor(pos), 0.0, nfft - 2).astype(np.int32)
        t = (pos - i0).astype(np.float32)
        cep2 = (cep[..., i0] * (np.float32(1.0) - t)
                + cep[..., i0 + 1] * t) * valid.astype(np.float32)
    else:
        t = jnp.arange(nfft, dtype=jnp.float32)
        t_in = t / jnp.maximum(1e-12, jnp.asarray(factor, jnp.float32))
        cep2 = _lerp_uniform(cep, t_in)
    logmag2 = exact_dft.rfft_n(cep2, nfft).real
    mag2 = jnp.exp(logmag2)
    Y = mag2 * jnp.exp(1j * jnp.angle(X))
    return exact_dft.irfft_n(Y, nfft, out_len=L)


def grain_chain_exact(x, sr, n_fft: int, cutoff=None, roll=0.0,
                      warp_power=None, cep_factor=None, lock=None,
                      stretch=None):
    """The full grain spectral chain (lowpass -> power warp -> cepstral
    warp -> partial/lock stretch, main_v2.py:690-702) in ONE exact-length
    spectral pass.

    The reference round-trips irfft/rfft between stages; each round-trip
    is the identity up to f64 eps, so chaining the spectrum-domain stages
    directly matches it within f32 parity budgets — and keeps
    filter-zeroed bins EXACTLY zero into the cepstral stage, which is
    what lets the cepstral floor be the reference's literal
    `mag = |X| + 1e-12` (main_v2.py:153-154): re-transforming in f32
    would bury those zeros under ~1e-7-relative round-trip noise whose
    log is backend-dependent (the old relative-floor convention, demoted
    to the padded-L fallback).

    Per-stage reference guards apply at the static n: lowpass identity
    below 8, warps below 16/64, stretch below 16, lock below 64.
    `lock` is (top_n, neighborhood).  Returns f32 [..., L] (padded)."""
    L = x.shape[-1]
    n = int(n_fft)
    if n < 8:
        return x
    X = exact_dft.rfft_n(x, n)
    nf = X.shape[-1]

    if cutoff is not None:
        X = X * _lowpass_gain(n, sr, cutoff, roll)

    if warp_power is not None and n >= 16:
        k = np.arange(nf, dtype=np.float64)
        kmax = max(1.0, float(nf - 1))
        pos = (k / kmax) ** (1.0 / max(1e-6, float(warp_power))) * kmax
        i0 = np.clip(np.floor(pos), 0.0, nf - 2).astype(np.int32)
        t = (pos - i0).astype(np.float32)
        X = X[..., i0] * (np.float32(1.0) - t) + X[..., i0 + 1] * t

    if cep_factor is not None and n >= 64:
        mag = jnp.abs(X)
        logmag = jnp.log(mag + jnp.float32(1e-12))   # main_v2.py:153-154
        cep = exact_dft.irfft_n(
            jax.lax.complex(logmag, jnp.zeros_like(logmag)), n)
        pos = np.arange(n, dtype=np.float64) / max(1e-12, float(cep_factor))
        valid = pos <= float(n - 1)
        i0 = np.clip(np.floor(pos), 0.0, n - 2).astype(np.int32)
        t = (pos - i0).astype(np.float32)
        cep2 = (cep[..., i0] * (np.float32(1.0) - t)
                + cep[..., i0 + 1] * t) * valid.astype(np.float32)
        logmag2 = exact_dft.rfft_n(cep2, n).real
        mag2 = jnp.exp(logmag2)
        ph = jnp.where(mag > 0, X / (mag + 1e-30), 1.0 + 0j)
        X = mag2 * ph

    if lock is not None and n >= 64:
        top_n, neigh = lock
        factor = jnp.asarray(stretch, jnp.float32)
        mag = jnp.abs(X)
        _, rel = jax.lax.top_k(mag[1:], top_n)
        peaks = rel.astype(jnp.int32) + 1
        k2 = jnp.round(peaks.astype(jnp.float32) * factor).astype(jnp.int32)
        Y = jnp.zeros_like(X)
        for d in range(-neigh, neigh + 1):
            w = jnp.float32(1.0 - (abs(d) / (neigh + 1)))
            kk = k2 + d
            ok = (kk >= 1) & (kk < nf)
            Y = Y.at[jnp.where(ok, kk, nf)].add(
                jnp.where(ok, X[peaks] * w, 0.0), mode="drop")
        Y = Y + jnp.complex64(0.12) * X
        X = jnp.where(jnp.abs(factor - 1.0) < 1e-9, X, Y)
    elif stretch is not None and n >= 16:
        factor = jnp.asarray(stretch, jnp.float32)
        inv_f = jnp.float32(1.0) / jnp.maximum(1e-12, factor)
        Y = _lerp_uniform_affine(X, inv_f)
        X = jnp.where(jnp.abs(factor - 1.0) < 1e-9, X, Y)

    return exact_dft.irfft_n(X, n, out_len=L)


def multiband_unfold(x, gen_sr, bands_out_hz, unfolds, roll_hz=0.0,
                     n_fft=None):
    """Multi-band unfold (main_v2.py:493-500): each output band (lo,hi) is
    extracted at the design rate at (lo*u, hi*u) and reinterpreted at base_sr
    (reinterpretation itself is metadata — unfold_reinterpret main_v2.py:489
    is the identity on samples), then summed.  bands/unfolds are static."""
    out = None
    for (lo_out, hi_out), u in zip(bands_out_hz, unfolds):
        band = bandpass_fft(x, gen_sr, float(lo_out) * float(u),
                            float(hi_out) * float(u), roll=roll_hz,
                            n_fft=n_fft)
        out = band if out is None else out + band
    return out if out is not None else x


def stft_mag_db(x, sr: int, win: int = 2048, hop: int = 256,
                max_frames: int = 3000):
    """Framed rfft magnitude in dB for analysis views (main_v2.py:197-212)."""
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    w = jnp.asarray(np.hanning(win) if win > 1 else np.ones(win), jnp.float32)
    # np.hanning matches the reference hann (main_v2.py:17-21)
    if n < win:
        pad = jnp.zeros(win, jnp.float32).at[:n].set(
            x * w[:n] if n > 1 else x)
        X = jnp.fft.rfft(pad)
        return 20.0 * jnp.log10(jnp.maximum(jnp.abs(X), 1e-12))[:, None]
    frames = min(1 + (n - win) // hop, max_frames)
    idx = jnp.arange(frames)[:, None] * hop + jnp.arange(win)[None, :]
    segs = x[idx] * w[None, :]
    X = jnp.fft.rfft(segs, axis=-1)
    S = 20.0 * jnp.log10(jnp.maximum(jnp.abs(X), 1e-12))
    return S.T


def spectral_imprint_scan(mags, amount, smooth):
    """SpectralImprint memory across an event sequence (main_v2.py:565-581):
    mem_0 = mag_0; mem_i = smooth*mem_{i-1} + (1-smooth)*mag_i — a linear
    recurrence over events, evaluated as a log-depth associative scan.
    Returns mag2[E, nf] = (1-amount)*mag + amount*mem."""
    E = mags.shape[0]
    sm = jnp.float32(smooth)
    A = jnp.concatenate([jnp.ones((1,) + mags.shape[1:], jnp.float32),
                         jnp.full((E - 1,) + mags.shape[1:], sm)])
    B = jnp.concatenate([mags[:1],
                         (jnp.float32(1.0) - sm) * mags[1:]])

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, ar * bl + br

    _, mem = jax.lax.associative_scan(combine, (A, B), axis=0)
    amt = jnp.float32(amount)
    return (jnp.float32(1.0) - amt) * mags + amt * mem
