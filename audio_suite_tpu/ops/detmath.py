"""Deterministic elementwise transcendentals (JAX + NumPy twins).

Why: oscillator phases in the reference synths reach thousands of radians in
f32 (e.g. pattern lab 0.1/app/synth_fm.py:106-112 computes sin(2*pi*hz*t) with
t up to the note length).  A 1-ulp difference between two backends' sin/exp2
becomes a phase error proportional to the phase magnitude, which phase-
modulation chains then amplify past the -60 dBFS parity budget.  These
routines make the *whole evaluation path* agree across NumPy and XLA to
~1e-7 absolute:

- arguments are expressed in CYCLES, reduced with ``x - rint(x)`` — an exact
  f32 operation (no Cody-Waite, no FMA-contraction hazard);
- the remaining polynomial/table steps only ever introduce errors at the
  output's own ulp scale (never amplified), so compiler FMA contraction is
  harmless;
- table lookups are continuous across index-rounding boundaries.

Every function has a NumPy twin (`*_np`) with the same operation sequence for
the oracles.
"""
from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

# sin(2*pi*v), cos(2*pi*v) Taylor coefficients in v (|v| <= 1/8)
_TWO_PI = 2.0 * np.pi
_S = [(_TWO_PI ** (2 * k + 1)) / math.factorial(2 * k + 1) * (-1) ** k
      for k in range(5)]
_C = [(_TWO_PI ** (2 * k)) / math.factorial(2 * k) * (-1) ** k
      for k in range(5)]
_S32 = [np.float32(c) for c in _S]
_C32 = [np.float32(c) for c in _C]

# exp2 polynomial: 2**r on |r| <= 0.5 as degree-7 Taylor (relative error
# ~5e-9, under one f32 ulp).  Branchless on purpose: the previous
# table-by-j/32 refinement cost a per-element 33-entry gather, which
# dominated Pattern Lab's vibrato buckets.
_LN2 = float(np.log(2.0))
_E2C = [np.float32(_LN2 ** k / math.factorial(k)) for k in range(1, 8)]


def _poly_sin(v):
    z = v * v
    return v * (_S32[0] + z * (_S32[1] + z * (_S32[2] + z * (_S32[3] + z * _S32[4]))))


def _poly_cos(v):
    z = v * v
    return _C32[0] + z * (_C32[1] + z * (_C32[2] + z * (_C32[3] + z * _C32[4])))


def sin_cycles(x):
    """sin(2*pi*x) for f32 x in cycles. |x| should stay below ~2**22 (above
    that, f32 cannot represent the phase at all)."""
    x = jnp.asarray(x, jnp.float32)
    x4 = x * jnp.float32(4.0)                   # exact
    q = jnp.rint(x4)
    v = (x4 - q) * jnp.float32(0.25)            # exact; |v| <= 1/8
    m = q.astype(jnp.int32) & 3
    sp = _poly_sin(v)
    cp = _poly_cos(v)
    return jnp.where(m == 0, sp,
                     jnp.where(m == 1, cp,
                               jnp.where(m == 2, -sp, -cp)))


def sin_cycles_np(x):
    x = np.asarray(x, np.float32)
    x4 = x * np.float32(4.0)
    q = np.rint(x4)
    v = ((x4 - q) * np.float32(0.25)).astype(np.float32)
    m = q.astype(np.int64).astype(np.int32) & 3
    z = v * v
    sp = v * (_S32[0] + z * (_S32[1] + z * (_S32[2] + z * (_S32[3] + z * _S32[4]))))
    cp = _C32[0] + z * (_C32[1] + z * (_C32[2] + z * (_C32[3] + z * _C32[4])))
    return np.where(m == 0, sp,
                    np.where(m == 1, cp,
                             np.where(m == 2, -sp, -cp))).astype(np.float32)


def sin_cycles_precise(x):
    """sin(2*pi*x) deterministic across NumPy/XLA/C++ to the FULL f32
    result (not just 12 bits): every multiply in the Horner recurrence
    takes two <=12-bit-significand operands (fixq.sig12_pair splits), so
    each product is exact in f32 and XLA's FMA contraction cannot change
    any rounding.  Accuracy ~2**-24 relative (the pair splits drop the
    lo*lo cross terms).  Use when a consumer needs more than the q12
    precision of round_sig12(sin_cycles(x)) while keeping bit-identical
    host/device twins — e.g. the scrub LFO, whose q12 curve integrated
    -55 dBFS of position drift over the 30 s bench config."""
    from .fixq import sig12_pair
    x = jnp.asarray(x, jnp.float32)
    x4 = x * jnp.float32(4.0)                   # exact
    q = jnp.rint(x4)
    v = (x4 - q) * jnp.float32(0.25)            # exact; |v| <= 1/8
    m = q.astype(jnp.int32) & 3
    zh, zl = sig12_pair(v * v)
    sp = _S32[4]
    for c in (_S32[3], _S32[2], _S32[1], _S32[0]):
        th, tl = sig12_pair(sp)
        sp = c + (zh * th + zh * tl + zl * th)
    vh, vl = sig12_pair(v)
    ph, pl = sig12_pair(sp)
    sp = vh * ph + vh * pl + vl * ph
    cp = _C32[4]
    for c in (_C32[3], _C32[2], _C32[1], _C32[0]):
        th, tl = sig12_pair(cp)
        cp = c + (zh * th + zh * tl + zl * th)
    return jnp.where(m == 0, sp,
                     jnp.where(m == 1, cp,
                               jnp.where(m == 2, -sp, -cp)))


def sin_cycles_precise_np(x):
    from .fixq import sig12_pair_np
    x = np.asarray(x, np.float32)
    x4 = x * np.float32(4.0)
    q = np.rint(x4)
    v = ((x4 - q) * np.float32(0.25)).astype(np.float32)
    m = q.astype(np.int64).astype(np.int32) & 3
    zh, zl = sig12_pair_np((v * v).astype(np.float32))
    sp = np.full_like(v, _S32[4])
    for c in (_S32[3], _S32[2], _S32[1], _S32[0]):
        th, tl = sig12_pair_np(sp)
        sp = (c + (zh * th + zh * tl + zl * th)).astype(np.float32)
    vh, vl = sig12_pair_np(v)
    ph, pl = sig12_pair_np(sp)
    sp = (vh * ph + vh * pl + vl * ph).astype(np.float32)
    cp = np.full_like(v, _C32[4])
    for c in (_C32[3], _C32[2], _C32[1], _C32[0]):
        th, tl = sig12_pair_np(cp)
        cp = (c + (zh * th + zh * tl + zl * th)).astype(np.float32)
    return np.where(m == 0, sp,
                    np.where(m == 1, cp,
                             np.where(m == 2, -sp, -cp))).astype(np.float32)


def exp2_precise(y):
    """2**y deterministic across NumPy/XLA/C++ to the FULL f32 result:
    like sin_cycles_precise, every multiply in the Horner recurrence takes
    two <=12-bit-significand operands (fixq.sig12_pair), so all products
    are exact in f32 and XLA's FMA contraction cannot change any rounding
    regardless of the surrounding fusion context.  (The plain exp2/exp2_np
    pair is bit-identical when compiled in ISOLATION, but inside a large
    fused kernel XLA may contract the `coef + r*inner` ladder into FMAs —
    measured: ~6e-4 of samples drift 1 ulp, which the FM vibrato chain
    amplifies by the carrier cycle count into DAC-step flips.)  Final
    power-of-two scale multiply is exact."""
    from .fixq import sig12_pair
    y = jnp.asarray(y, jnp.float32)
    k = jnp.rint(y)
    r = y - k                                    # exact, |r| <= 0.5
    rh, rl = sig12_pair(r)
    c = jnp.full_like(r, _E2C[6])
    for coef in (_E2C[5], _E2C[4], _E2C[3], _E2C[2], _E2C[1], _E2C[0]):
        th, tl = sig12_pair(c)
        c = coef + (rh * th + rh * tl + rl * th)
    ch, cl = sig12_pair(c)
    c = rh * ch + rh * cl + rl * ch
    val = jnp.float32(1.0) + c
    ki = jnp.clip(k.astype(jnp.int32), -126, 126)
    scale = jnp.asarray((ki + 127) << 23).view(jnp.float32)
    return val * scale


def exp2_precise_np(y):
    from .fixq import sig12_pair_np
    y = np.asarray(y, np.float32)
    k = np.rint(y)
    r = (y - k).astype(np.float32)
    rh, rl = sig12_pair_np(r)
    c = np.full_like(r, _E2C[6])
    for coef in (_E2C[5], _E2C[4], _E2C[3], _E2C[2], _E2C[1], _E2C[0]):
        th, tl = sig12_pair_np(c)
        c = (coef + (rh * th + rh * tl + rl * th)).astype(np.float32)
    ch, cl = sig12_pair_np(c)
    c = (rh * ch + rh * cl + rl * ch).astype(np.float32)
    val = (np.float32(1.0) + c).astype(np.float32)
    ki = np.clip(k.astype(np.int32), -126, 126)
    scale = np.asarray((ki + 127) << 23, np.int32).view(np.float32)
    return (val * scale).astype(np.float32)


def cos_cycles(x):
    return sin_cycles(jnp.asarray(x, jnp.float32) + jnp.float32(0.25))


def cos_cycles_np(x):
    return sin_cycles_np(np.asarray(x, np.float32) + np.float32(0.25))


def phase_ratio(freq_num: int, freq_den: int, sr: int):
    """Reduce an LFO frequency ``freq_num/freq_den`` Hz at integer sample
    rate ``sr`` to ``(num, m, inv_m)`` such that the phase in cycles at
    sample i is ``(((i mod m) * num) mod m) * inv_m`` — exact integer
    reduction, so the phase stays accurate for ANY sample index (an f32
    ``arange`` loses integer exactness past 2**24 ≈ 5.8 min at 48 kHz).
    ``m < 2**24`` is enforced so the reduced residue converts to f32
    exactly; the only rounding is the final inv_m multiply (~1 ulp of a
    value < num cycles), identical across NumPy/XLA/C++."""
    num = int(freq_num)
    m = int(freq_den) * int(sr)
    if m <= 0 or num < 0:
        raise ValueError("phase_ratio needs positive den*sr and num >= 0")
    g = math.gcd(num, m)
    num //= g
    m //= g
    if m >= 2 ** 24 or num * (m - 1) >= 2 ** 32:
        raise ValueError("phase_ratio residue would overflow exact range")
    return np.uint32(num), np.uint32(m), np.float32(1.0 / m)


def phase_cycles(i, num, m, inv_m):
    """Long-range-exact LFO phase in cycles for uint32 sample index i."""
    i = jnp.asarray(i, jnp.uint32)
    r = ((i % m) * num) % m
    return r.astype(jnp.float32) * jnp.float32(inv_m)


def phase_cycles_np(i, num, m, inv_m):
    i = np.asarray(i, np.uint32)
    r = ((i % np.uint32(m)) * np.uint32(num)) % np.uint32(m)
    return (r.astype(np.float32) * np.float32(inv_m)).astype(np.float32)


def frac_signed(x):
    """x - rint(x): exact signed fractional part in [-0.5, 0.5]."""
    x = jnp.asarray(x, jnp.float32)
    return x - jnp.rint(x)


def frac_signed_np(x):
    x = np.asarray(x, np.float32)
    return (x - np.rint(x)).astype(np.float32)


def exp2(y):
    """2**y for f32 y (|y| <= ~100), branchless polynomial + exponent
    scale.  Output agrees with the NumPy twin to ~1 ulp of the result."""
    y = jnp.asarray(y, jnp.float32)
    k = jnp.rint(y)
    r = y - k                                    # exact, |r| <= 0.5
    c = r * (_E2C[0] + r * (_E2C[1] + r * (_E2C[2] + r * (_E2C[3]
            + r * (_E2C[4] + r * (_E2C[5] + r * _E2C[6]))))))
    val = jnp.float32(1.0) + c
    ki = jnp.clip(k.astype(jnp.int32), -126, 126)
    scale = jnp.asarray((ki + 127) << 23).view(jnp.float32)
    return val * scale


def exp2_np(y):
    y = np.asarray(y, np.float32)
    k = np.rint(y)
    r = (y - k).astype(np.float32)
    c = r * (_E2C[0] + r * (_E2C[1] + r * (_E2C[2] + r * (_E2C[3]
            + r * (_E2C[4] + r * (_E2C[5] + r * _E2C[6]))))))
    val = (np.float32(1.0) + c).astype(np.float32)
    ki = np.clip(k.astype(np.int32), -126, 126)
    scale = np.asarray((ki + 127) << 23, np.int32).view(np.float32)
    return (val * scale).astype(np.float32)
