"""Envelope kernels (vectorized, mask-based — static shapes for vmap).

- adsr_clamped: the stage-clamped ADSR shared by the FM and PSG voices
  (pattern lab 0.1/app/synth_fm.py:64-99, app/synth_psg.py:42-77): stage
  lengths are clamped to the remaining note budget in order A, D, R, with
  sustain absorbing the rest.
- micro_fade_gain: 12 ms half-cosine fade-in/out (app/synth_fm.py:7-24).
- make_adsr: Microsound's curve-exponent ADSR (microsound_0.2.1/
  main_v2.py:172-195) for the global output envelope.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def adsr_clamped(i, n, A, D, R, s):
    """Vectorized stage-clamped ADSR.

    i : int32[L] sample indices (0..L-1, padded)
    n : int32 scalar — true note length
    A, D, R : int32 scalars — stage lengths in samples (host-precomputed
        ``int(sr * stage)`` with the reference's minimums applied)
    s : f32 scalar — sustain level
    Returns f32[L], zero outside [0, n).
    """
    n = jnp.int32(n)
    n_a = jnp.minimum(n, A)
    rem = jnp.maximum(0, n - n_a)
    n_d = jnp.minimum(rem, D)
    rem = jnp.maximum(0, rem - n_d)
    n_r = jnp.minimum(rem, R)
    n_s = jnp.maximum(0, rem - n_r)

    s = jnp.float32(s)
    one = jnp.float32(1.0)
    fi = i.astype(jnp.float32)

    # attack: linspace(0,1,n_a,endpoint=False)**2
    ramp_a = fi / jnp.maximum(1, n_a).astype(jnp.float32)
    val_a = ramp_a * ramp_a
    # decay: linspace(1,s,n_d,endpoint=False)
    kd = (i - n_a).astype(jnp.float32)
    val_d = one + (s - one) * (kd / jnp.maximum(1, n_d).astype(jnp.float32))
    # release: startv * linspace(1,0,n_r,endpoint=True)**2
    rel_start = n_a + n_d + n_s
    kr = (i - rel_start).astype(jnp.float32)
    denom = jnp.maximum(1, n_r - 1).astype(jnp.float32)
    ramp_r = jnp.where(n_r > 1, one - kr / denom, one)
    # startv = env[rel_start-1]: s if sustain exists, else last decay/attack
    last_d = one + (s - one) * ((n_d - 1).astype(jnp.float32)
                                / jnp.maximum(1, n_d).astype(jnp.float32))
    last_a_r = (n_a - 1).astype(jnp.float32) / jnp.maximum(1, n_a).astype(jnp.float32)
    last_a = last_a_r * last_a_r
    startv = jnp.where(n_s > 0, s,
                       jnp.where(n_d > 0, last_d,
                                 jnp.where(n_a > 0, last_a, s)))
    val_r = startv * ramp_r * ramp_r

    env = jnp.where(i < n_a, val_a,
                    jnp.where(i < n_a + n_d, val_d,
                              jnp.where(i < rel_start, s, val_r)))
    return jnp.where(i < n, env, jnp.float32(0.0))


def adsr_from_consts(i, n, n_a, n_d, n_r, inv_na, inv_nd, inv_dr, startv, s):
    """Stage-clamped ADSR from HOST-precomputed per-note constants.

    Replaces adsr_clamped's on-device f32 divisions (ramp = i / n_a etc.):
    XLA's device f32 division need not be correctly rounded, so the quotient could
    sit 1 ulp off the oracle's value — and a 1-ulp envelope wiggle upstream
    of the 14-bit DAC quantizer flips a whole quantization step (-78 dBFS
    per flip; coincident flips dominated the long-render parity error).
    With the reciprocals computed host-side (NumPy f32 division IS
    correctly rounded) every remaining op is a correctly-rounded f32
    multiply/add on all backends, so engine and oracle envelopes are
    bit-identical.

    n_a, n_d, n_r : int32 — host-clamped stage lengths (sum with n_s = n)
    inv_na : f32 = 1/max(1, n_a);  inv_nd : f32 = 1/max(1, n_d)
    inv_dr : f32 = 1/max(1, n_r - 1)
    startv : f32 — envelope value entering the release stage
    """
    one = jnp.float32(1.0)
    fi = i.astype(jnp.float32)
    ramp_a = fi * inv_na
    val_a = ramp_a * ramp_a
    kd = (i - n_a).astype(jnp.float32)
    val_d = one + (s - one) * (kd * inv_nd)
    rel_start = n - n_r
    kr = (i - rel_start).astype(jnp.float32)
    ramp_r = jnp.where(n_r > 1, one - kr * inv_dr, one)
    val_r = startv * (ramp_r * ramp_r)
    env = jnp.where(i < n_a, val_a,
                    jnp.where(i < n_a + n_d, val_d,
                              jnp.where(i < rel_start, s, val_r)))
    return jnp.where(i < n, env, jnp.float32(0.0))


def adsr_consts_np(n, A, D, R, s):
    """Host twin: stage lengths + reciprocals + release start value for
    adsr_from_consts, vectorized over note/op axes.  All f32 ops mirror the
    device formulas exactly (correctly-rounded NumPy arithmetic)."""
    n = np.asarray(n, np.int64)
    A = np.asarray(A, np.int64)
    D = np.asarray(D, np.int64)
    R = np.asarray(R, np.int64)
    s = np.asarray(s, np.float32)
    n_a = np.minimum(n, A)
    rem = np.maximum(0, n - n_a)
    n_d = np.minimum(rem, D)
    rem2 = np.maximum(0, rem - n_d)
    n_r = np.minimum(rem2, R)
    n_s = rem2 - n_r
    one = np.float32(1.0)
    inv_na = (one / np.maximum(1, n_a).astype(np.float32)).astype(np.float32)
    inv_nd = (one / np.maximum(1, n_d).astype(np.float32)).astype(np.float32)
    inv_dr = (one / np.maximum(1, n_r - 1).astype(np.float32)) \
        .astype(np.float32)
    last_d = (one + (s - one)
              * ((n_d - 1).astype(np.float32) * inv_nd)).astype(np.float32)
    la = ((n_a - 1).astype(np.float32) * inv_na).astype(np.float32)
    last_a = (la * la).astype(np.float32)
    startv = np.where(n_s > 0, s,
                      np.where(n_d > 0, last_d,
                               np.where(n_a > 0, last_a, s))) \
        .astype(np.float32)
    return dict(n_a=n_a.astype(np.int32), n_d=n_d.astype(np.int32),
                n_r=n_r.astype(np.int32), inv_na=inv_na, inv_nd=inv_nd,
                inv_dr=inv_dr, startv=startv)


def micro_fade_gain(i, n, fade_samples):
    """Gain curve of _apply_micro_fade (app/synth_fm.py:7-24): half-cosine
    fade over fade_n = clip(fade_samples, 8, n//3) samples at both ends,
    endpoints forced to zero; identity for n <= 16."""
    n = jnp.int32(n)
    fade_n = jnp.maximum(8, jnp.minimum(jnp.int32(fade_samples), n // 3))
    denom = jnp.maximum(1, fade_n - 1).astype(jnp.float32)
    # front ramp: 0.5 - 0.5 cos(pi * i/(fade_n-1))
    front = jnp.float32(0.5) - jnp.float32(0.5) * jnp.cos(
        jnp.pi * i.astype(jnp.float32) / denom)
    back_k = (n - 1 - i).astype(jnp.float32)
    back = jnp.float32(0.5) - jnp.float32(0.5) * jnp.cos(
        jnp.pi * back_k / denom)
    g = jnp.ones_like(front)
    g = jnp.where(i < fade_n, front, g)
    g = jnp.where(i >= n - fade_n, back, g)
    g = jnp.where((i == 0) | (i == n - 1), jnp.float32(0.0), g)
    return jnp.where(n <= 16, jnp.ones_like(g), g)


def make_adsr(n: int, sr: int, a_ms: float, d_ms: float, s: float,
              r_ms: float, curve: float = 1.8):
    """Microsound global ADSR with curve exponent (main_v2.py:172-195).
    Static-shape variant (n is a Python int — it's the output length)."""
    A = max(0, int(round(sr * a_ms / 1000.0)))
    D = max(0, int(round(sr * d_ms / 1000.0)))
    R = max(0, int(round(sr * r_ms / 1000.0)))
    s = float(np.clip(s, 0, 1))
    curve = float(max(1e-6, curve))

    # each ramp's pow (= exp/log pair) is evaluated on its OWN segment
    # only, then the segments concatenate — the A/D/R spans are a few ms
    # while n is minutes, and three full-length pow passes dominated the
    # whole FX chain.  Values are bit-identical to the masked full-length
    # form: f32 represents the integer indices < 2**24 exactly, so the
    # per-segment (i - pos) subtraction loses nothing.
    pos = 0
    parts = []
    if A > 0:
        seg = min(A, n)
        ia = jnp.arange(seg, dtype=jnp.float32)
        parts.append((ia / jnp.float32(A)) ** curve)
        pos = min(A, n)
    j = min(n, pos + D)
    if D > 0 and j > pos:
        idd = jnp.arange(j - pos, dtype=jnp.float32)
        parts.append(1.0 - (1.0 - s) * (idd / jnp.float32(j - pos)) ** curve)
    sus_start = j
    sus_end = max(sus_start, n - R)
    if sus_end > sus_start:
        parts.append(jnp.full(sus_end - sus_start, s, jnp.float32))
    if R > 0 and n > sus_end:
        ir_ = jnp.arange(n - sus_end, dtype=jnp.float32)
        r_ramp = (ir_ / jnp.float32(max(1, n - 1 - sus_end))) ** curve
        parts.append(jnp.float32(s) * (1.0 - r_ramp))
    if not parts:
        return jnp.ones(n, dtype=jnp.float32)
    env = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    if env.shape[0] < n:        # A+D+sus+R can undershoot when D spills
        env = jnp.concatenate(
            [env, jnp.ones(n - env.shape[0], jnp.float32)])
    return env[:n]
