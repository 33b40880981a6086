"""Deterministic envelope -> mod-speed chain (JAX + NumPy twins).

Grid Audio's clock modulation derives a per-sample speed from the RMS
envelope of an earlier rendered track (grid_audio_app_0.2/
grid_audio_app.py:735-742: moving-average of x**2, sqrt, normalize to max,
speed = clip(1 + amount*env, 0.25, 4)).  To run the whole mixdown in ONE
device kernel, that chain must produce bit-identical results on host NumPy
and on device.

Cross-backend float hazards and how each is closed:

- **FMA contraction**: XLA fuses ``add(mul(a, b), c)`` into an FMA whose
  unrounded product diverges from NumPy's mul+add — measured on XLA:CPU,
  and ``lax.optimization_barrier`` does NOT stop it.  Defense: every float
  product in this module is EXACT (Veltkamp 12-bit split squares; exact
  power-of-two scales), so contraction cannot change the value.
- **Association order**: box sums are assembled from doubling level
  arrays (S_k[j] = sum of 2**k consecutive squares) by explicit shifted
  adds — the same DAG on both backends (XLA does not reassociate float
  adds), and every access is a STATIC shift, never a gather.
- **div / sqrt rounding**: XLA pins down neither across backends.  Defense: the
  normalize->sqrt->speed stage is pure int32 arithmetic (integer division
  is exact by definition; integer sqrt = f32 estimate + +-1 correction,
  exact regardless of the estimate's rounding).

Numerical fidelity vs the reference's f64 np.convolve chain: the envelope
is quantized to 15 bits, its normalization to 14, the mod amount to 2**-12,
and the box sums accumulate in f32 — a few 1e-4 worst-case on the speed
curve, a control-signal tolerance documented exactly like
grid.moving_average's O(n) rewrite.  What the twins buy is that the host
oracle, the host engine and the device engine all consume ONE bit-identical
speed array, so placement decisions (integer phase) never diverge.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import fixq

_HI_MASK = np.int32(np.uint32(0xFFFFF000).view(np.int32))  # drop 12 mantissa
_ENV_BITS = 15
_POS_ONE = np.int32(1 << fixq.POS_FRAC_BITS)
_SPEED_LO = np.int32(1 << (fixq.POS_FRAC_BITS - 2))      # 0.25
_SPEED_HI = np.int32(4 << fixq.POS_FRAC_BITS)            # 4.0


# ---------------------------------------------------------------------------
# Exact square via mantissa-mask splitting (products of 12-bit halves are
# exact, so FMA contraction is value-preserving).  The split itself is pure
# integer masking — a multiplicative Veltkamp split would reintroduce the
# very mul-feeding-sub contraction hazard it is meant to avoid.
# ---------------------------------------------------------------------------

def exact_sq(x):
    """x**2 with every multiply exact: hi = x with its low 12 mantissa bits
    zeroed (<=12-bit significand), lo = x - hi (exact, <=12 bits), square
    as hi*hi + (2*hi)*lo + lo*lo.  The two adds round, but adds are
    bit-identical IEEE ops on both backends."""
    x = jnp.asarray(x, jnp.float32)
    xb = jax.lax.bitcast_convert_type(x, jnp.int32)
    hi = jax.lax.bitcast_convert_type(xb & _HI_MASK, jnp.float32)
    lo = x - hi
    return (hi * hi + (hi + hi) * lo) + lo * lo


def exact_sq_np(x):
    x = np.asarray(x, np.float32)
    hi = (x.view(np.int32) & _HI_MASK).view(np.float32)
    lo = np.float32(x - hi)
    return np.float32(np.float32(np.float32(hi * hi)
                                 + np.float32(np.float32(hi + hi) * lo))
                      + np.float32(lo * lo))


# ---------------------------------------------------------------------------
# Box sums — binary decomposition over a zero-padded signal (shift-only)
# ---------------------------------------------------------------------------

def _box_sums_direct(x2, n, win, np_mod):
    """Box sums of the reference's clipped 'same' window: s[i] =
    sum x2[i - win//2 .. i + (win-1)//2] (out-of-range terms are zero —
    identical to np.convolve 'same' zero-padding, grid_audio_app.py:140).

    Zero-padding makes every window exactly `win` long, so the binary
    decomposition of the window length is CONSTANT across i: level arrays
    S_k[j] = sum P[j : j + 2**k] built by shifted adds, each window
    assembled from the set bits of win at static offsets.  Every access is
    a static shift — no per-element `level[idx]` gathers.  Zero prefix
    differences: the error stays
    RELATIVE to the box sum (a prefix-difference scheme turns accumulated
    magnitude into absolute error, which the sqrt amplifies near zero).

    Both twins perform the identical shift/add DAG in the identical order,
    so results are bit-equal (adding exact zeros is exact: x2 >= 0)."""
    levels = max(1, int(win).bit_length())
    lead = win // 2
    # slack: at level k the array has shrunk by 2**k - 1 and the term
    # offset can reach 2**k - 1, so 2*win of tail zeros keeps every
    # static slice in range
    m = lead + n + 2 * win + 2
    P = np_mod.pad(np_mod.asarray(x2, np.float32), (lead, m - lead - n))
    s = np_mod.zeros(n, np.float32)
    S = P
    off = 0
    for k in range(levels):
        if (win >> k) & 1:
            term = S[off:off + n]
            s = (s + term).astype(np.float32) if np_mod is np else s + term
        off += ((win >> k) & 1) << k
        if k + 1 < levels:
            sh = 1 << k
            nxt = S[sh:]
            if np_mod is np:
                S = np.float32(S[:-sh] + nxt) if sh < len(S) else S
            else:
                S = S[:-sh] + nxt
    return s


# ---------------------------------------------------------------------------
# Exact integer sqrt for 30-bit operands
# ---------------------------------------------------------------------------

def isqrt30(uq):
    """floor(sqrt(uq)) for int32 uq in [0, 2**30]: f32 sqrt estimate + one
    integer correction in each direction.  Exact no matter how the backend
    rounds sqrt (the estimate is within 1 of the true root at this range;
    (y+1)**2 <= 2**30 + 2**16 stays inside int32)."""
    uq = jnp.asarray(uq, jnp.int32)
    y = jnp.sqrt(uq.astype(jnp.float32)).astype(jnp.int32)
    y = jnp.where(y * y > uq, y - 1, y)
    y = jnp.where((y + 1) * (y + 1) <= uq, y + 1, y)
    return y


def isqrt30_np(uq):
    uq = np.asarray(uq, np.int32)
    y = np.sqrt(uq.astype(np.float32)).astype(np.int32)
    y = np.where(y * y > uq, y - 1, y)
    y = np.where((y + 1) * (y + 1) <= uq, y + 1, y)
    return y


def amount_q12(amount: float) -> int:
    """Mod amount quantized to 2**-12 (static per track; documented
    framework semantics for the user-facing parameter)."""
    return int(np.rint(float(amount) * (1 << 12)))


def _exp_scale_bits(smax_bits):
    """f32 whose value is 2**(29 - floor(log2(smax))), built from exponent
    bits only (exact scale factor; integer ops)."""
    e = (smax_bits >> 23) - 127                   # unbiased exponent
    return ((29 - e) + 127) << 23                 # bits of 2**(29-e)


def mod_speed_fix(placed, win: int, a_q12: int, n_valid=None):
    """Device twin: placed f32 [n] -> int32 speed in 2**-22 units, [0.25,4].

    Chain: box-sum of exact x**2 (shift-only binary decomposition; the /win of a
    true moving average cancels in the normalization), exponent-normalize
    so smax lands in [2**29, 2**30), two-stage integer division for a
    30-bit u = s/smax, 15-bit integer sqrt, speed = 1 + a*env saturated in
    int32 2**-22 units.

    `n_valid` (traced scalar, optional): true signal length when `placed`
    is zero-padded beyond it.  Box sums at i in [n_valid, n_valid + win/2)
    still overlap real audio through their lookback but are assembled with
    a different shift/add grouping than any host-twin window, so without
    masking a few-ulp rounding excess near a tie could push the max — and
    every derived speed — off the host twin's.  Masking pins the max
    domain to [0, n_valid), identical to the host twin computed at the
    true length."""
    placed = jnp.asarray(placed, jnp.float32)
    n = placed.shape[0]
    win = max(1, min(int(win), n))
    x2 = exact_sq(placed)
    s = _box_sums_direct(x2, n, win, jnp)
    s = jnp.maximum(s, 0.0)                       # cancellation guard
    if n_valid is not None:
        s = jnp.where(jnp.arange(n, dtype=jnp.int32) < n_valid, s, 0.0)
    smax = jnp.maximum(jnp.max(s), jnp.float32(2.0 ** -40))
    sb = jax.lax.bitcast_convert_type(smax, jnp.int32)
    scale = jax.lax.bitcast_convert_type(_exp_scale_bits(sb), jnp.float32)
    s_q = (s * scale).astype(jnp.int32)           # exact scale + trunc
    smax_q = (smax * scale).astype(jnp.int32)     # in [2**29, 2**30)
    d = jnp.maximum(smax_q >> _ENV_BITS, 1)
    # two-stage long division: full 30-bit quotient u = s/smax (a 15-bit
    # quotient's absolute error would blow up through the sqrt near zero)
    q1 = s_q // d
    r1 = s_q - q1 * d
    q2 = (r1 << _ENV_BITS) // d
    u30 = jnp.minimum((q1 << _ENV_BITS) + q2, jnp.int32(1 << 30))
    e15 = isqrt30(u30)                            # floor(sqrt(u) * 2**15)
    # a*env in 2**-22 units: f32 product (both factors exactly
    # representable; feeds min/cast, not an add -> no contraction hazard),
    # saturated before the int cast so huge amounts can't overflow int32
    t = (jnp.float32(float(a_q12)) * e15.astype(jnp.float32)
         * jnp.float32(2.0 ** -5))
    t = jnp.clip(t, np.float32(-(1 << 26)), np.float32(1 << 26))
    inc = _POS_ONE + t.astype(jnp.int32)
    return jnp.clip(inc, _SPEED_LO, _SPEED_HI)


def mod_speed_fix_np(placed, win: int, a_q12: int):
    placed = np.asarray(placed, np.float32)
    n = placed.shape[0]
    win = max(1, min(int(win), n))
    x2 = exact_sq_np(placed)
    s = _box_sums_direct(x2, n, win, np)
    s = np.maximum(s, np.float32(0.0))
    smax = np.maximum(np.max(s) if n else np.float32(0.0),
                      np.float32(2.0 ** -40))
    sb = int(np.float32(smax).view(np.int32))
    scale = np.int32(_exp_scale_bits(sb)).view(np.float32)
    s_q = (s * scale).astype(np.int32)
    smax_q = np.int32(np.float32(smax * scale))
    d = np.int32(max(int(smax_q) >> _ENV_BITS, 1))
    q1 = s_q // d
    r1 = s_q - q1 * d
    q2 = (r1 << _ENV_BITS) // d
    u30 = np.minimum((q1 << _ENV_BITS) + q2, np.int32(1 << 30))
    e15 = isqrt30_np(u30)
    t = np.float32(np.float32(np.float32(float(a_q12))
                              * e15.astype(np.float32))
                   * np.float32(2.0 ** -5))
    t = np.clip(t, np.float32(-(1 << 26)), np.float32(1 << 26))
    inc = _POS_ONE + t.astype(np.int32)
    return np.clip(inc, _SPEED_LO, _SPEED_HI).astype(np.int32)


def speed_q_from_fix_np(inc):
    """Exact f32 view of the fixed-point speeds (2**-22 units) — what the
    sequential oracle loop accumulates in f64."""
    return (np.asarray(inc, np.int32).astype(np.float32)
            * np.float32(1.0 / (1 << fixq.POS_FRAC_BITS)))
