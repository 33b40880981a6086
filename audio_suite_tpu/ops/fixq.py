"""Exact int32 fixed-point tape-position arithmetic.

Why this exists
---------------
The reference apps integrate tape position with per-sample Python-float (f64)
accumulation (TapeTUC ``provide_samples``, tape-tuc-main/Tape_TUC_23-11-25_
auto-slice_n_record.py:767-911; Scrubber cumulative varispeed,
scrubber/scrubber_0.7.py:196-202; Grid Audio phase accumulator,
grid_audio_app_0.2/grid_audio_app.py:786-814).  Device code stays off float64,
and f32 position accumulation over minutes of audio drifts by whole samples.
Worse, varispeed playback makes *discrete* decisions from position (section
lookup, splice-envelope triggers, phase resets); any last-ulp disagreement
between a device kernel and a CPU oracle at a decision boundary snowballs into
large audio deviations.

So positions are represented exactly as an int32 pair::

    pos = whole + frac * 2**-POS_FRAC_BITS,   frac in [0, POS_ONE)

and every per-sample increment is quantized through *single-rounding* f32 ops
(one IEEE multiply, one exact power-of-two scale, one rint) that produce
bit-identical integers under XLA and NumPy.  All discrete decisions are then
pure integer comparisons — the JAX engines and the NumPy oracles in
``oracles/`` agree bit-for-bit, and the remaining (continuous) audio
math easily clears the −60 dBFS parity target in f32.

Quantization fidelity vs. the reference's f64 semantics: increments are
quantized to 2**-22 samples (≈2.4e-7); worst-case systematic drift over a
minutes-long render is a few millisamples of timing — far below audibility and
below the −60 dBFS budget.

Both JAX and NumPy mirrors live here; oracles must call the ``*_np`` versions.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

POS_FRAC_BITS = 22
POS_ONE = 1 << POS_FRAC_BITS          # 4194304
POS_MASK = POS_ONE - 1
POS_ONE_F = float(POS_ONE)
POS_INV_F = np.float32(1.0 / POS_ONE)


# ----------------------------------------------------------------------------
# Quantization (single-rounding, deterministic across NumPy and XLA)
# ----------------------------------------------------------------------------

def quantize_f32(x):
    """Round an f32 value to the 2**-POS_FRAC_BITS grid, staying in f32.

    ``x * POS_ONE`` is an exact power-of-two scale, ``rint`` uses
    round-half-even in both NumPy and XLA, and the downscale is exact again —
    so the result is bit-identical everywhere for identical f32 inputs.
    """
    x = jnp.asarray(x, jnp.float32)
    return (jnp.rint(x * jnp.float32(POS_ONE)) * POS_INV_F).astype(jnp.float32)


def quantize_f32_np(x):
    x = np.asarray(x, np.float32)
    return (np.rint(x * np.float32(POS_ONE)) * POS_INV_F).astype(np.float32)


def to_fix(x):
    """f32 value -> int32 fixed-point (2**-POS_FRAC_BITS units)."""
    x = jnp.asarray(x, jnp.float32)
    return jnp.rint(x * jnp.float32(POS_ONE)).astype(jnp.int32)


def to_fix_np(x):
    x = np.asarray(x, np.float32)
    return np.rint(x * np.float32(POS_ONE)).astype(np.int32)


def inc_fix(speed_q, mod_q):
    """Fixed-point per-sample increment from quantized f32 speed and mod.

    Exactly one f32 rounding (the multiply); the scale and rint are exact, so
    XLA cannot re-associate its way to a different integer.
    """
    r = jnp.asarray(speed_q, jnp.float32) * jnp.asarray(mod_q, jnp.float32)
    return jnp.rint(r * jnp.float32(POS_ONE)).astype(jnp.int32)


def inc_fix_np(speed_q, mod_q):
    r = np.float32(speed_q) * np.asarray(mod_q, np.float32)
    return np.rint(r * np.float32(POS_ONE)).astype(np.int32)


def split_pos_np(v) -> tuple[int, int]:
    """Split an absolute position (float, any magnitude up to 2**31 samples)
    into an exact (whole:int, frac:int) pair.  Use this — never ``to_fix`` —
    for large values like jump targets or head offsets: value * POS_ONE
    overflows int32 beyond ~512 samples."""
    v = float(v)
    w = int(np.floor(v))
    f = int(np.rint((v - w) * POS_ONE))
    if f >= POS_ONE:
        w += 1
        f -= POS_ONE
    return w, f


def fix_to_f32(whole, frac):
    """Approximate f32 view of a fixed-point position (for *continuous* math
    only — never for decisions)."""
    return jnp.asarray(whole, jnp.float32) + jnp.asarray(frac, jnp.float32) * POS_INV_F


# ----------------------------------------------------------------------------
# Position addition / normalization
# ----------------------------------------------------------------------------

def pos_add(whole, frac, inc, frac_bits: int = POS_FRAC_BITS):
    """(whole, frac) += inc  with carry normalization. inc may be negative;
    arithmetic right-shift implements floor division in both NumPy and XLA."""
    f = frac + inc
    carry = f >> frac_bits
    return whole + carry, f - (carry << frac_bits)


def pos_add_np(whole, frac, inc, frac_bits: int = POS_FRAC_BITS):
    f = frac + inc
    carry = f >> frac_bits
    return whole + carry, f - (carry << frac_bits)


# ----------------------------------------------------------------------------
# Segmented fixed-point prefix sum (Scrubber / Grid Audio phase accumulator)
# ----------------------------------------------------------------------------

def _seg_combine(a, b, frac_bits: int = POS_FRAC_BITS):
    """Associative combine for segmented fixed-point sums on int32 triples
    (whole, frac, has_reset).  Exact integer math — any association order
    yields identical results."""
    aw, af, ar = a
    bw, bf, br = b
    f = af + bf
    carry = f >> frac_bits
    w = aw + bw + carry
    f = f - (carry << frac_bits)
    # segmented: if b starts a new segment, drop a entirely
    w = jnp.where(br, bw, w)
    f = jnp.where(br, bf, f)
    return w, f, ar | br


def _hillis_steele_seg(w, f, r, axis, frac_bits: int = POS_FRAC_BITS):
    """Inclusive segmented scan via Hillis-Steele doubling along `axis`.

    Plain shift-pad-combine steps compile to a handful of static-shape HLO
    ops per level; ``lax.associative_scan``'s recursive odd/even slicing
    makes compile times explode past ~1M elements, so multi-M scans must
    come through here."""
    n = w.shape[axis]
    shift = 1
    while shift < n:
        def shifted(x, fill):
            pad = [(0, 0)] * x.ndim
            pad[axis] = (shift, 0)
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(0, n)
            return jnp.pad(x, pad, constant_values=fill)[tuple(sl)]
        w, f, r = _seg_combine(
            (shifted(w, 0), shifted(f, 0), shifted(r, False)), (w, f, r))
        shift *= 2
    return w, f, r


_SEG_BLOCK = 1024


def segmented_pos_cumsum(inc, reset, init_whole=0, init_frac=0):
    """Inclusive segmented prefix sum of fixed-point increments.

    positions[i] = (init + sum(inc[j] for j in (last reset before i) .. i))
    where ``reset[i]`` restarts the sum *at* element i (position i contributes
    its own increment starting from zero).  Runs as a two-level blocked
    segmented scan (in-block Hillis-Steele over [K, B] rows + a block-carry
    scan), the parallel replacement for the reference's per-sample Python
    accumulators.  Results are bit-identical to a sequential evaluation
    (exact int32 math, associative combine).

    Returns (whole[N] int32, frac[N] int32).
    """
    inc = jnp.asarray(inc, jnp.int32)
    reset = jnp.asarray(reset, jnp.bool_)
    n = inc.shape[0]

    w0 = inc >> POS_FRAC_BITS
    f0 = inc - (w0 << POS_FRAC_BITS)

    B = _SEG_BLOCK
    if n % B == 0 and n > B:
        K = n // B
        wb = w0.reshape(K, B)
        fb = f0.reshape(K, B)
        rb = reset.reshape(K, B)
        wb, fb, rb_seen = _hillis_steele_seg(wb, fb, rb, axis=1)
        # exclusive block-carry scan over the per-block aggregates
        aw, af, ar = wb[:, -1], fb[:, -1], rb_seen[:, -1]
        cw, cf, cr = _hillis_steele_seg(aw, af, ar, axis=0)
        # prefix for block k = inclusive aggregate of blocks < k
        pw = jnp.concatenate([jnp.zeros(1, jnp.int32), cw[:-1]])
        pf = jnp.concatenate([jnp.zeros(1, jnp.int32), cf[:-1]])
        # apply the block prefix to elements whose segment did not restart
        # within their own block
        fsum = fb + pf[:, None]
        carry = fsum >> POS_FRAC_BITS
        wsum = wb + pw[:, None] + carry
        fsum = fsum - (carry << POS_FRAC_BITS)
        w = jnp.where(rb_seen, wb, wsum).reshape(n)
        f = jnp.where(rb_seen, fb, fsum).reshape(n)
    else:
        w, f, _ = _hillis_steele_seg(w0, f0, reset, axis=0)

    # fold the initial position into segments that never saw a reset
    seen_reset = jnp.cumsum(reset.astype(jnp.int32)) > 0
    iw = jnp.where(seen_reset, 0, jnp.int32(init_whole))
    if_ = jnp.where(seen_reset, 0, jnp.int32(init_frac))
    f = f + if_
    carry = f >> POS_FRAC_BITS
    return w + iw + carry, f - (carry << POS_FRAC_BITS)


def segmented_pos_cumsum_np(inc, reset, init_whole=0, init_frac=0):
    """Sequential NumPy mirror (oracle). Bit-identical to the JAX version."""
    inc = np.asarray(inc, np.int64)  # headroom; results fit int32 by contract
    n = inc.shape[0]
    whole = np.zeros(n, np.int64)
    frac = np.zeros(n, np.int64)
    w = int(init_whole)
    f = int(init_frac)
    for i in range(n):
        if reset[i]:
            w = 0
            f = 0
        f += int(inc[i])
        carry = f >> POS_FRAC_BITS
        w += carry
        f -= carry << POS_FRAC_BITS
        whole[i] = w
        frac[i] = f
    return whole.astype(np.int32), frac.astype(np.int32)


# ----------------------------------------------------------------------------
# Integer gather for near-monotonic positions (blockwise one-hot read)
# ----------------------------------------------------------------------------

def gather_int_block_onehot(pat, idx, wrap: bool, span: int = 4,
                            B: int = 128, chunk: int = 512,
                            zero_cover: bool = True):
    """``pat[idx]`` for positions that advance by at most ``span`` per
    sample, as blockwise one-hot matmuls (HIGHEST precision, so selection
    is exact) instead of an element gather (Grid Audio's mixdown reads
    786 k positions per track, grid_audio_app.py:806-810).

    Each ``B``-sample output block reads a contiguous window of ``pat``
    anchored at its first position rounded DOWN to a multiple of B: the
    window fetch is then one lane-aligned row gather for all blocks at
    once, hoisted out of the chunk loop (per-anchor dynamic slices inside
    the loop serialize).  A one-hot row per
    output selects its element, so the result is BIT-IDENTICAL to the
    direct gather (one nonzero product per row).  Positions that jump
    backwards mid-block (Grid's phase resets land at 0 at arbitrary
    sample indices) fall outside that window and are claimed by a second
    window anchored at 0 — exclusive with the main window, so no row is
    ever double-counted; pass ``zero_cover=False`` to skip it for
    reset-free tracks.  Rows covered by neither (only positions a caller
    already masks invalid) read as 0.

    idx: int32 [T] in [0, n); T must be a multiple of B.
    """
    n = pat.shape[0]
    T = idx.shape[0]
    # aligned anchor wastes < B at the front: advance (span*(B-1)) plus
    # alignment slack, rounded up to whole B-rows
    WR = span + 2
    W = WR * B
    K = T // B
    KC = -(-K // chunk) * chunk

    idx2 = idx.reshape(K, B)
    if KC > K:
        idx2 = jnp.concatenate(
            [idx2, jnp.zeros((KC - K, B), idx2.dtype)])
    anchor = (idx2[:, 0] // B) * B
    if wrap:
        local = jnp.mod(idx2 - anchor[:, None], n)
    else:
        local = idx2 - anchor[:, None]

    # extension so every [anchor, anchor+W) window is in bounds; wrap
    # reads tile the pattern, clip reads pad with zeros.  Length rounded
    # to whole B-rows for the aligned row gather.
    ext_len = -(-(n + W) // B) * B
    if wrap:
        reps = -(-ext_len // n)
        ext = jnp.concatenate([pat] * max(2, reps))[:ext_len]
    else:
        ext = jnp.concatenate(
            [pat, jnp.zeros(ext_len - n, pat.dtype)])
    zero_win = ext[:W] if wrap else \
        jnp.concatenate([pat, jnp.zeros(W, pat.dtype)])[:W]
    # one aligned row gather for every block's window: [K, WR, B] -> [K, W]
    ext2d = ext.reshape(ext_len // B, B)
    rows = anchor // B
    win_all = jnp.take(ext2d, rows[:, None]
                       + jnp.arange(WR, dtype=jnp.int32)[None, :],
                       axis=0).reshape(KC, W)

    widx = jnp.arange(W, dtype=jnp.int32)[None, None, :]

    def do_chunk(_, c):
        loc = jax.lax.dynamic_slice_in_dim(local, c * chunk, chunk, 0)
        main = (loc >= 0) & (loc < W)   # clip-mode resets make loc negative
        oh = ((widx == loc[:, :, None]) & main[:, :, None]) \
            .astype(jnp.float32)
        win = jax.lax.dynamic_slice_in_dim(win_all, c * chunk, chunk, 0)
        y = jnp.einsum("kbw,kw->kb", oh, win,
                       precision=jax.lax.Precision.HIGHEST)
        if zero_cover:
            # reset landing zone: rows the main window missed, position < W
            ix = jax.lax.dynamic_slice_in_dim(idx2, c * chunk, chunk, 0)
            oh0 = ((widx == ix[:, :, None]) & (~main)[:, :, None]) \
                .astype(jnp.float32)
            y = y + jnp.einsum("kbw,w->kb", oh0, zero_win,
                               precision=jax.lax.Precision.HIGHEST)
        return None, y

    _, ys = jax.lax.scan(do_chunk, None,
                         jnp.arange(KC // chunk, dtype=jnp.int32))
    return ys.reshape(-1)[:T]


# ----------------------------------------------------------------------------
# Fractional gather (linear interpolation, optional wraparound)
# ----------------------------------------------------------------------------

def gather_linear_wrap(audio, whole, frac):
    """Wrap-around 2-tap linear interpolated read.

    Device form of Scrubber's ``sample_from_tape_array``
    (scrubber/scrubber_0.7.py:141-154): positions wrap mod N, two gathers, lerp.
    """
    n = audio.shape[0]
    pw = jnp.mod(whole, n)
    i1 = jnp.mod(pw + 1, n)
    fr = frac.astype(jnp.float32) * POS_INV_F
    s0 = audio[pw]
    s1 = audio[i1]
    return (jnp.float32(1.0) - fr) * s0 + fr * s1


def gather_linear_wrap_np(audio, whole, frac):
    n = audio.shape[0]
    pw = np.mod(whole, n)
    i1 = np.mod(pw + 1, n)
    fr = frac.astype(np.float32) * POS_INV_F
    s0 = audio[pw]
    s1 = audio[i1]
    return (np.float32(1.0) - fr) * s0 + fr * s1


# ----------------------------------------------------------------------------
# Fractional gather — windowed-sinc quality mode (opt-in)
# ----------------------------------------------------------------------------
#
# The engines default to 2-tap linear interpolation because that is the
# REFERENCE's semantics and the parity oracle's math.  The north star names windowed sinc as the
# production-resampler quality bar; this is that mode: Lanczos-windowed
# sinc over `taps` neighbours, weight-normalized (exact DC), one packed
# row gather + K transcendental weight passes per output sample,
# selected per render via the engines' interp="sinc" option.

def _lanczos_w(x, half):
    # sinc(x) * sinc(x/half) on |x| < half, 0 outside; jnp.sinc is the
    # normalized sinc
    return jnp.where(jnp.abs(x) < half,
                     jnp.sinc(x) * jnp.sinc(x / half), 0.0)


def _sinc_weight_dot(vals, fr, half):
    """Weight-normalized tap dot, accumulated in tap order with the same
    f32 multiplies/adds as the per-tap-gather formulation (bit-equal to it
    op-for-op; under jit XLA may contract the mul-adds into FMAs, as it
    could with the old form — the sinc twins are tolerance-based, 1e-5,
    unlike the linear path's bit-exact twins)."""
    acc = jnp.zeros(fr.shape, jnp.float32)
    wsum = jnp.zeros(fr.shape, jnp.float32)
    for t, j in enumerate(range(-half + 1, half + 1)):
        w = _lanczos_w(jnp.float32(j) - fr, half)
        acc = acc + w * vals[..., t]
        wsum = wsum + w
    return acc / wsum


def gather_sinc_wrap(audio, whole, frac, taps: int = 16):
    """Wrap-around Lanczos-windowed-sinc interpolated read (quality mode).

    Read point p = whole + frac*2^-22; taps at integer offsets
    j in [-taps/2+1, taps/2] with weights sinc(j-fr)*sinc((j-fr)/half),
    normalized to unit sum so constants pass through exactly.

    Element gathers cost per index, not per byte, so the `taps` neighbours of every sample are packed into a [n, taps] row
    table (taps cheap rolled copies of the audio) and the read becomes ONE
    row gather + an in-register weight dot — the same trick as the linear
    read's pair gather, at 1/taps the gather count of the naive form."""
    n = audio.shape[0]
    half = taps // 2
    fr = frac.astype(jnp.float32) * POS_INV_F
    # rows[i, t] = audio[(i + j_t) mod n],  j_t = t - half + 1
    rows = jnp.stack([jnp.roll(audio, half - 1 - t) for t in range(taps)],
                     axis=-1)
    vals = rows[jnp.mod(whole, n)]
    return _sinc_weight_dot(vals, fr, half)


def gather_sinc_clip(audio, whole, frac, taps: int = 16):
    """Edge-clamped variant (tape reads clamp at the buffer ends rather
    than wrapping, Tape…py:830-836 index clip).  `whole` is expected in
    [0, n) — the tape kernels clip positions before the read."""
    n = audio.shape[0]
    half = taps // 2
    fr = frac.astype(jnp.float32) * POS_INV_F
    # rows[i, t] = audio[clip(i + j_t, 0, n-1)] via edge-padded shifts
    cols = []
    for j in range(-half + 1, half + 1):
        if j >= 0:
            c = jnp.concatenate(
                [audio[j:], jnp.broadcast_to(audio[-1:], (min(j, n),))])[:n]
        else:
            c = jnp.concatenate(
                [jnp.broadcast_to(audio[:1], (min(-j, n),)), audio[:j]])[:n]
        cols.append(c)
    rows = jnp.stack(cols, axis=-1)
    vals = rows[jnp.clip(whole, 0, n - 1)]
    return _sinc_weight_dot(vals, fr, half)


def _lanczos_w_np(x, half):
    return np.where(np.abs(x) < half,
                    np.sinc(x) * np.sinc(x / half), 0.0).astype(np.float32)


def gather_sinc_wrap_np(audio, whole, frac, taps: int = 16):
    n = audio.shape[0]
    half = taps // 2
    fr = frac.astype(np.float32) * POS_INV_F
    acc = np.zeros(np.shape(whole), np.float32)
    wsum = np.zeros(np.shape(whole), np.float32)
    for j in range(-half + 1, half + 1):
        w = _lanczos_w_np(np.float32(j) - fr, half)
        acc = np.float32(acc + w * audio[np.mod(whole + j, n)])
        wsum = np.float32(wsum + w)
    return acc / wsum


# ----------------------------------------------------------------------------
# Significand rounding (FMA-contraction-proof multiplies)
# ----------------------------------------------------------------------------
#
# XLA freely contracts ``a*b + c`` into a single-rounded FMA, and neither
# optimization_barrier nor bitcast round-trips stop it (verified empirically
# on the CPU backend), so any float multiply feeding an add can round
# differently under jit than in a NumPy oracle.  The cure: round both
# multiply operands to <= 12-bit significands first.  Then the product has
# <= 24 significant bits, is EXACTLY representable in f32, and fused
# vs. unfused evaluation is bit-identical on every backend.  (Same
# quantized-semantics discipline as the tape position math above; the
# <= 2**-12 relative perturbation is documented framework semantics.)

_SIG_ROUND = np.int32(0x0800)
_SIG_MASK = np.int32(~0x0FFF)


def round_sig12(x):
    """Round f32 significand to 12 bits (round-half-up in mantissa space,
    carrying into the exponent naturally).  Integer bit ops — XLA cannot
    re-associate or contract through them."""
    x = jnp.asarray(x, jnp.float32)
    b = jax.lax.bitcast_convert_type(x, jnp.int32)
    b = (b + _SIG_ROUND) & _SIG_MASK
    return jax.lax.bitcast_convert_type(b, jnp.float32)


def round_sig12_np(x):
    x = np.asarray(x, np.float32)
    b = x.view(np.int32)
    b = ((b + _SIG_ROUND) & _SIG_MASK).astype(np.int32)
    return b.view(np.float32)


def sig12_pair(x):
    """Split f32 x into (hi, lo) 12-bit-significand pieces with
    hi + lo ≈ x to ~24 bits.  hi = round_sig12(x); the residual x - hi is
    exact in f32 (Sterbenz: hi is within 2**-12 relative of x), and lo is
    its 12-bit rounding.  Any product of two such pieces has a <= 24-bit
    significand, i.e. is EXACT in f32 — so sums of piece products are
    FMA-contraction-safe (fused and unfused round identically on every
    backend) while carrying twice the precision of a single q12 value."""
    x = jnp.asarray(x, jnp.float32)
    hi = round_sig12(x)
    lo = round_sig12(x - hi)
    return hi, lo


def sig12_pair_np(x):
    x = np.asarray(x, np.float32)
    hi = round_sig12_np(x)
    lo = round_sig12_np((x - hi).astype(np.float32))
    return hi, lo
