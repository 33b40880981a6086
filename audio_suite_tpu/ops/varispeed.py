"""Varispeed tape-playback kernels.

Parallel re-formulations of the reference's per-sample Python playback loops:

- TapeTUC ``provide_samples`` (tape-tuc-main/Tape_TUC_23-11-25_auto-slice_n_
  record.py:767-911): sectioned varispeed with reverse, anti-click boundary
  dips, splice envelopes, inertia smoothing, wow/flutter speed modulation.
- Scrubber ``audio_callback`` (scrubber/scrubber_0.7.py:157-235): cumulative
  varispeed + multi-head fractional gather (see :mod:`..models.scrub`).

Positions use exact int32 fixed point (:mod:`.fixq`), so the section lookups,
splice triggers and phase wraps taken here are bit-identical to the NumPy
oracle (oracles/tape_ref.py).  Two engines are provided:

- :func:`tape_scan_render` — ``lax.scan`` over samples, handles every feature
  (including inertia, whose speed recurrence is inherently sequential).
- :func:`tape_segment_render` (below) — the default engine: the full
  control path (section crossings, quantized inertia, splice triggers,
  anti-click gains) is computed on the host — C++ (native/ast_runtime.cpp)
  with a NumPy fallback — and the device runs one parallel gather kernel.
  Decision-bit-identical to the scan engine (same quantized integers).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .fixq import POS_FRAC_BITS, POS_ONE, POS_INV_F, quantize_f32


@dataclasses.dataclass(frozen=True)
class TapeConsts:
    """Static (compile-time) playback configuration.

    Hashable so it can be a jit static argument; float fields are the exact
    f32 values the oracle uses (stored as Python floats of f32 values).
    """
    anticlick_on: bool
    smooth_len: int                 # boundary_smooth_len (400)
    anticlick_strength: float       # 0.3 + 0.5 * amt/100, as f32 value
    splice_on: bool
    inertia_on: bool
    alpha_q: float                  # inertia one-pole coefficient, f32 value
    initial_speed_q: float          # quantized initial current_speed


class TapeState(NamedTuple):
    whole: jnp.ndarray        # int32 — integer sample part of tape position
    frac: jnp.ndarray         # int32 — fractional part in 2**-POS_FRAC_BITS
    speed: jnp.ndarray        # f32   — current (inertia-smoothed) speed
    splice_rem: jnp.ndarray   # int32 — splice envelope samples remaining
    splice_idx: jnp.ndarray   # int32 — splice envelope read index


def _section_lookup(starts, ends, whole):
    """bisect_right(section_starts, pos) - 1, exactly (Tape…py:761-765).

    Positions have frac in [0,1) so the integer part alone decides the bucket.
    """
    num_secs = starts.shape[0]
    # bisect via elementwise sum over the (small) section table:
    # jnp.searchsorted lowers to a per-element loop of gathers; S passes
    # of compares are ~free
    sec = sum((whole >= starts[k]).astype(jnp.int32)
              for k in range(num_secs)) - 1
    sec = jnp.clip(sec, 0, num_secs - 1)
    sec_start = starts[sec]
    sec_end = ends[sec]
    sec_end = jnp.where(sec_end <= sec_start, sec_start + 1, sec_end)
    return sec, sec_start, sec_end


def _read_index(whole, frac, sec_start, sec_end, rev):
    """Map a (wrapped) position to the interpolation index/fraction.

    Mirrors Tape…py:823-836 including the reference's truncation-toward-zero
    ``int(read_pos)`` for the reverse branch when read_pos lands in (-1, 0).
    Returns (idx0:int32, fr:f32) with fr possibly negative in that edge case.
    """
    sec_len = sec_end - sec_start
    local_w = jnp.mod(whole - sec_start, sec_len)

    # forward: read_pos = sec_start + local
    idx_f = sec_start + local_w
    fr_f = frac.astype(jnp.float32) * POS_INV_F

    # reverse: read_pos = (sec_end - 1) - local
    a = sec_end - 1 - local_w                      # integer part before borrow
    has_frac = frac > 0
    idx_r = jnp.where(has_frac, a - 1, a)
    fr_r = jnp.where(has_frac, (POS_ONE - frac).astype(jnp.float32) * POS_INV_F,
                     jnp.float32(0.0))
    # read_pos in (-1, 0): int() truncates to 0, frac goes negative
    neg = (a == 0) & has_frac
    idx_r = jnp.where(neg, 0, idx_r)
    fr_r = jnp.where(neg, -frac.astype(jnp.float32) * POS_INV_F, fr_r)

    idx0 = jnp.where(rev, idx_r, idx_f)
    fr = jnp.where(rev, fr_r, fr_f)
    return idx0, fr


def _boundary_min_dist(boundaries, idx0):
    """min |idx0 - b| over the sorted boundary array (Tape…py:838-840).
    Direct elementwise min over the (small) boundary table — see
    _section_lookup for why not searchsorted."""
    nb = boundaries.shape[0]
    d = jnp.full(idx0.shape, jnp.int32(2**30))
    for k in range(nb):
        d = jnp.minimum(d, jnp.abs(idx0 - boundaries[k]))
    return d


def _boundary_hit(boundaries, idx0):
    nb = boundaries.shape[0]
    hit = jnp.zeros(idx0.shape, jnp.bool_)
    for k in range(nb):
        hit = hit | (idx0 == boundaries[k])
    return hit


@partial(jax.jit, static_argnames=("consts",))
def tape_scan_render(
    audio,            # f32[N] mono tape
    mod_q,            # f32[T] quantized wow/flutter speed modulation
    starts,           # i32[S] section start samples ([0] + markers)
    ends,             # i32[S] section end samples   (markers + [N])
    speeds_q,         # f32[S] quantized |section speed|
    reverse,          # bool[S]
    boundaries,       # i32[B] sorted(markers ∪ {0, N-1})
    splice_env,       # f32[E] splice gain envelope (1 + 0.8 e^{-5x}, E=256)
    consts: TapeConsts,
    state: TapeState | None = None,
):
    """Reference-complete sequential engine (lax.scan over output samples)."""
    n = audio.shape[0]
    env_len = splice_env.shape[0]

    strength = jnp.float32(consts.anticlick_strength)
    smooth_len = consts.smooth_len
    alpha_q = jnp.float32(consts.alpha_q)
    have_bounds = boundaries.shape[0] > 0

    if state is None:
        state = TapeState(
            whole=jnp.int32(0), frac=jnp.int32(0),
            speed=jnp.float32(consts.initial_speed_q),
            splice_rem=jnp.int32(0), splice_idx=jnp.int32(0),
        )

    inv_smooth = jnp.float32(1.0 / max(1, smooth_len))

    def step(st: TapeState, mod):
        whole = jnp.mod(st.whole, n)
        sec, sec_start, sec_end = _section_lookup(starts, ends, whole)
        idx0, fr = _read_index(whole, st.frac, sec_start, sec_end, reverse[sec])
        idx0 = jnp.clip(idx0, 0, n - 1)
        idx1 = jnp.minimum(idx0 + 1, n - 1)
        s = (jnp.float32(1.0) - fr) * audio[idx0] + fr * audio[idx1]

        if consts.anticlick_on and have_bounds and smooth_len > 0:
            dmin = _boundary_min_dist(boundaries, idx0)
            x = (smooth_len - dmin).astype(jnp.float32) * inv_smooth
            gain = jnp.maximum(jnp.float32(0.0), jnp.float32(1.0) - strength * x)
            s = jnp.where(dmin < smooth_len, s * gain, s)

        if consts.splice_on and have_bounds:
            hit = _boundary_hit(boundaries, idx0)
            trigger = hit & (st.splice_rem <= 0)
            rem = jnp.where(trigger, env_len, st.splice_rem)
            sidx = jnp.where(trigger, 0, st.splice_idx)
            apply = (rem > 0) & (sidx < env_len)
            s = jnp.where(apply, s * splice_env[jnp.clip(sidx, 0, env_len - 1)], s)
            rem = jnp.where(apply, rem - 1, rem)
            sidx = jnp.where(apply, sidx + 1, sidx)
        else:
            rem, sidx = st.splice_rem, st.splice_idx

        s = jnp.clip(s, -1.0, 1.0)

        target = speeds_q[sec]
        if consts.inertia_on:
            d = target - st.speed
            m = quantize_f32(d * alpha_q)
            speed = st.speed + m
        else:
            speed = target

        inc = jnp.rint((speed * mod) * jnp.float32(POS_ONE)).astype(jnp.int32)
        f = st.frac + inc
        carry = f >> POS_FRAC_BITS
        new_state = TapeState(whole + carry, f - (carry << POS_FRAC_BITS),
                              speed, rem, sidx)
        return new_state, s

    final, out = jax.lax.scan(step, state, mod_q)
    return out, final


# ----------------------------------------------------------------------------
# Segment engine: parallel trajectory + one device gather kernel
# ----------------------------------------------------------------------------
#
# The per-sample scan above is sequential per step — unusable against the
# ≥1000x realtime target.  But the
# tape trajectory is fully determined by host data (mod_q, section speeds,
# markers): positions are EXACT int32 fixed point, so the whole control path
# (section crossings, inertia convergence, splice triggers, anti-click
# distances) can be computed on the host with vectorized integer math,
# bit-identically to the scan, leaving the device exactly one embarrassingly
# parallel kernel: fractional gather + gain multiplies + clip.
#
# Inertia: the quantized one-pole speed lives on the 2**-POS_FRAC_BITS grid,
# so the recurrence is an integer map S -> S + m(S) with m(S) constant over
# runs; runs are enumerated instead of samples (a few hundred iterations per
# section visit instead of ~1e5), and the speed FREEZES exactly once the
# quantized step rounds to zero.

import numpy as np



def _speed_steps_np(speed_q: np.float32, target_q: np.float32,
                    alpha_q: np.float32, max_n: int) -> np.ndarray:
    """Speeds for up to max_n steps of the quantized one-pole
    speed += quantize_f32((target - speed) * alpha) (the scan's inertia
    branch), enumerated by runs of equal quantized step.  Returns the f32
    speeds array (may be shorter than max_n if the speed freezes — the
    caller extends with the frozen value)."""
    out = []
    s_int = int(np.rint(np.float64(speed_q) * POS_ONE))
    t_int = int(np.rint(np.float64(target_q) * POS_ONE))

    def step_int(si):
        d = np.float32(np.float32((t_int - si) * POS_INV_F))
        m = np.float32(d * alpha_q)
        return int(np.rint(np.float64(np.float32(m)) * POS_ONE))

    # vectorized accept-prefix run enumeration: evaluate the quantized step
    # over a window of candidate states at once (exact f32 path mirrored),
    # accept the leading stretch that still uses step m
    alpha_f = max(1e-12, float(alpha_q))
    n = 0
    while n < max_n:
        m = step_int(s_int)
        if m == 0:
            break
        k_max = min(max_n - n, int(1.0 / (alpha_f * abs(m))) + 64)
        cand = s_int + m * np.arange(1, k_max + 1, dtype=np.int64)
        d32 = ((t_int - cand).astype(np.float64)
               * POS_INV_F).astype(np.float32)
        m32 = d32 * np.float32(alpha_q)
        mv = np.rint(m32.astype(np.float64) * POS_ONE).astype(np.int64)
        diff = np.nonzero(mv != m)[0]
        k = int(diff[0]) + 1 if diff.size else k_max
        out.append(cand[:k])
        s_int = int(cand[k - 1])
        n += k
    if out:
        speeds_int = np.concatenate(out)
    else:
        speeds_int = np.zeros(0, np.int64)
    return (speeds_int.astype(np.float32) * POS_INV_F).astype(np.float32)


def tape_trajectory(audio_n: int, mod_q, starts, ends, speeds_q, reverse,
                    boundaries, splice_env_len: int, consts: TapeConsts,
                    init_whole: int = 0, init_frac: int = 0):
    """Host computation of the full playback control path, bit-identical to
    tape_scan_render's decisions.  Returns a dict with per-output-sample
    idx0 (i32), fr (f32), ga (anti-click gains f32), gs (splice gains f32)
    and the final TapeState fields."""
    T = len(mod_q)
    n = int(audio_n)
    mod_q = np.asarray(mod_q, np.float32)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    speeds_q = np.asarray(speeds_q, np.float32)
    reverse = np.asarray(reverse, bool)
    boundaries = np.asarray(boundaries, np.int64)
    num_secs = len(starts)

    whole = np.empty(T, np.int32)
    frac = np.empty(T, np.int32)
    sec_arr = np.empty(T, np.int32)

    w = int(init_whole)
    f = int(init_frac)
    speed = np.float32(consts.initial_speed_q)
    alpha_q = np.float32(consts.alpha_q)
    i = 0
    CHUNK = 1 << 16
    while i < T:
        w = w % n
        sec = min(max(int(np.searchsorted(starts, w, side="right")) - 1, 0),
                  num_secs - 1)
        sec_start = int(starts[sec])
        sec_end = int(ends[sec])
        if sec_end <= sec_start:
            sec_end = sec_start + 1
        target = np.float32(speeds_q[sec])

        # distance (fix units) until wrapped whole reaches sec_end
        d_fix = (sec_end - w) * POS_ONE - f

        # build the speed curve for this visit (inertia convergence runs,
        # then frozen), chunked until the crossing is found
        conv = (_speed_steps_np(speed, target, alpha_q, T - i)
                if consts.inertia_on else np.zeros(0, np.float32))
        j = i
        acc = 0
        while True:
            k0 = j - i
            kn = min(CHUNK, T - j)
            if kn <= 0:
                break
            spd = np.empty(kn, np.float32)
            c = min(max(len(conv) - k0, 0), kn)
            if c > 0:
                spd[:c] = conv[k0:k0 + c]
            if c < kn:
                if not consts.inertia_on:
                    spd[c:] = target
                elif len(conv) == 0:
                    spd[c:] = speed          # frozen from the start
                else:
                    spd[c:] = conv[-1]       # frozen after convergence
            # rint(speed*mod * POS_ONE): ONE f32 multiply + exact 2**22
            # scale, bit-identical to fixq.inc_fix on device
            inc = np.rint((spd * mod_q[j:j + kn])
                          * np.float32(POS_ONE)).astype(np.int64)
            csum = np.cumsum(inc)
            hit = int(np.searchsorted(csum, d_fix - acc, side="left"))
            m = min(hit + 1, kn)
            # positions for samples j..j+m-1: pre-advance state
            excl = np.concatenate([[0], csum[:m - 1]]) + acc
            fv = f + excl
            carry = fv >> POS_FRAC_BITS
            whole[j:j + m] = w + carry
            frac[j:j + m] = fv - (carry << POS_FRAC_BITS)
            sec_arr[j:j + m] = sec
            if hit < kn:
                # crossing happened after consuming samples j..j+hit
                fv_end = f + acc + int(csum[hit])
                carry = fv_end >> POS_FRAC_BITS
                w_end = w + carry
                f_end = fv_end - (carry << POS_FRAC_BITS)
                speed = np.float32(spd[hit])
                j += hit + 1
                w, f = int(w_end), int(f_end)
                break
            acc += int(csum[-1])
            speed = np.float32(spd[-1])
            j += kn
            if j >= T:
                fv_end = f + acc
                carry = fv_end >> POS_FRAC_BITS
                w, f = int(w + carry), int(fv_end - (carry << POS_FRAC_BITS))
                break
        i = j

    # ---- read index mapping (mirror of _read_index) ----
    wrapped = np.mod(whole, n)
    sec = sec_arr
    sec_start = starts[sec]
    sec_end = np.maximum(ends[sec], sec_start + 1)
    sec_len = sec_end - sec_start
    local_w = np.mod(wrapped - sec_start, sec_len)
    rev = reverse[np.clip(sec, 0, num_secs - 1)]

    idx_f = sec_start + local_w
    fr_f = frac.astype(np.float32) * POS_INV_F

    a = sec_end - 1 - local_w
    has_frac = frac > 0
    idx_r = np.where(has_frac, a - 1, a)
    fr_r = np.where(has_frac,
                    (POS_ONE - frac).astype(np.float32) * POS_INV_F,
                    np.float32(0.0))
    neg = (a == 0) & has_frac
    idx_r = np.where(neg, 0, idx_r)
    fr_r = np.where(neg, -frac.astype(np.float32) * POS_INV_F, fr_r)

    idx0 = np.where(rev, idx_r, idx_f)
    fr = np.where(rev, fr_r, fr_f).astype(np.float32)
    idx0 = np.clip(idx0, 0, n - 1).astype(np.int64)

    # ---- anti-click gains (mirror of the scan branch) ----
    ga = np.ones(T, np.float32)
    if consts.anticlick_on and len(boundaries) > 0 and consts.smooth_len > 0:
        jb = np.searchsorted(boundaries, idx0)
        nb = len(boundaries)
        lo = boundaries[np.clip(jb - 1, 0, nb - 1)]
        hi = boundaries[np.clip(jb, 0, nb - 1)]
        d_lo = np.where(jb - 1 >= 0, np.abs(idx0 - lo), 2**30)
        d_hi = np.where(jb < nb, np.abs(hi - idx0), 2**30)
        dmin = np.minimum(d_lo, d_hi)
        inv_smooth = np.float32(1.0 / max(1, consts.smooth_len))
        x = (consts.smooth_len - dmin).astype(np.float32) * inv_smooth
        gain = np.maximum(np.float32(0.0),
                          np.float32(1.0)
                          - np.float32(consts.anticlick_strength) * x)
        ga = np.where(dmin < consts.smooth_len, gain,
                      np.float32(1.0)).astype(np.float32)

    # ---- splice gains (greedy trigger suppression, mirror of scan state) --
    gs = np.ones(T, np.float32)
    splice_rem = 0
    splice_idx = 0
    if consts.splice_on and len(boundaries) > 0:
        jb = np.searchsorted(boundaries, idx0)
        nb = len(boundaries)
        hit = (jb < nb) & (boundaries[np.clip(jb, 0, nb - 1)] == idx0)
        hits = np.nonzero(hit)[0]
        env = None
        last_end = -1
        for t in hits:
            if t < last_end:
                continue
            if env is None:
                x = np.linspace(0, 1, splice_env_len, dtype=np.float32)
                env = (1.0 + 0.8 * np.exp(-5.0 * x)).astype(np.float32)
            e = min(T, t + splice_env_len)
            gs[t:e] = env[: e - t]
            last_end = t + splice_env_len
        if last_end > T:
            splice_rem = last_end - T
            splice_idx = splice_env_len - splice_rem

    final = dict(whole=int(w), frac=int(f),
                 speed=float(speed), splice_rem=int(splice_rem),
                 splice_idx=int(splice_idx))
    return dict(idx0=idx0.astype(np.int32), fr=fr, ga=ga, gs=gs,
                final=final)


# ----------------------------------------------------------------------------
# Table engine: compact host control tables + full on-device reconstruction
# ----------------------------------------------------------------------------
#
# The segment engine above still ships ~12 bytes per output sample
# (idx0/fr/gain) through the host->device link.  But the only *decisions* the host
# makes are (a) where section-crossing visits begin and with what entry
# position, (b) the quantized-inertia speed curve, and (c) splice trigger
# times.  Everything else is arithmetic the device can redo bit-identically:
#
# - wow/flutter mod: detmath twins (exact integer phase reduction, 12-bit
#   rounded sines, exact multiplies) — same construction the scrub engine
#   proves bit-exact between NumPy and XLA;
# - speeds: the quantized one-pole inertia produces *arithmetic progressions*
#   of the fixed-point speed integer (constant step m between re-roundings),
#   so a visit's whole speed curve compresses to a few (start, s0, m) runs
#   expanded on device as s0 + m*(i - start) — exact integer math;
# - positions: segmented fixed-point prefix sum (ops/fixq.py) with per-visit
#   bases, the scrub recipe;
# - read index / anti-click gains: elementwise integer math from positions;
# - splice gains: envelope scatter at the (sparse, non-overlapping) host
#   trigger times.
#
# Host->device payload per render drops from O(T) to O(visits + runs): KBs.


def _ap_runs(s_ints):
    """Segment an integer sequence into maximal arithmetic progressions.
    Returns a list of (start_index, s0, m) with
    s[j] = s0 + m*(j - start_index) for j in [start, next_start)."""
    c = len(s_ints)
    if c == 0:
        return []
    if c == 1:
        return [(0, int(s_ints[0]), 0)]
    d = np.diff(s_ints)
    chg = np.nonzero(np.diff(d) != 0)[0] + 1   # k with d[k] != d[k-1]
    runs = []
    p = 0
    while p < c:
        if p >= c - 1:
            runs.append((p, int(s_ints[p]), 0))
            break
        ci = int(np.searchsorted(chg, p, side="right"))
        q = int(chg[ci]) if ci < len(chg) else len(d)
        runs.append((p, int(s_ints[p]), int(d[p])))
        p = q + 1
    return runs


def tape_tables(audio_n: int, mod_q, starts, ends, speeds_q, reverse,
                boundaries, splice_env_len: int, consts: TapeConsts,
                init_whole: int = 0, init_frac: int = 0):
    """Host control path in compact-table form (NumPy reference; the C++
    twin is native_rt.tape_tables).  Decision-identical to tape_trajectory;
    returns visit/run/trigger tables + final state instead of per-sample
    arrays."""
    T = len(mod_q)
    n = int(audio_n)
    mod_q = np.asarray(mod_q, np.float32)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    speeds_q = np.asarray(speeds_q, np.float32)
    reverse = np.asarray(reverse, bool)
    boundaries = np.asarray(boundaries, np.int64)
    num_secs = len(starts)

    vis_start, vis_bw, vis_bf, vis_sec = [], [], [], []
    runs = []                      # (global_start, s0_int, m_int)

    w = int(init_whole)
    f = int(init_frac)
    speed = np.float32(consts.initial_speed_q)
    alpha_q = np.float32(consts.alpha_q)
    i = 0
    CHUNK = 1 << 16
    while i < T:
        w = w % n
        sec = min(max(int(np.searchsorted(starts, w, side="right")) - 1, 0),
                  num_secs - 1)
        sec_start = int(starts[sec])
        sec_end = int(ends[sec])
        if sec_end <= sec_start:
            sec_end = sec_start + 1
        target = np.float32(speeds_q[sec])
        d_fix = (sec_end - w) * POS_ONE - f

        vis_start.append(i)
        vis_bw.append(w)
        vis_bf.append(f)
        vis_sec.append(sec)

        conv = (_speed_steps_np(speed, target, alpha_q, T - i)
                if consts.inertia_on else np.zeros(0, np.float32))
        if consts.inertia_on:
            frozen = np.float32(conv[-1]) if len(conv) else speed
        else:
            frozen = target

        # crossing search (identical decisions to tape_trajectory)
        j = i
        acc = 0
        while True:
            k0 = j - i
            kn = min(CHUNK, T - j)
            if kn <= 0:
                break
            spd = np.empty(kn, np.float32)
            c = min(max(len(conv) - k0, 0), kn)
            if c > 0:
                spd[:c] = conv[k0:k0 + c]
            if c < kn:
                spd[c:] = frozen
            inc = np.rint((spd * mod_q[j:j + kn])
                          * np.float32(POS_ONE)).astype(np.int64)
            csum = np.cumsum(inc)
            hit = int(np.searchsorted(csum, d_fix - acc, side="left"))
            if hit < kn:
                fv_end = f + acc + int(csum[hit])
                carry = fv_end >> POS_FRAC_BITS
                w = int(w + carry)
                f = int(fv_end - (carry << POS_FRAC_BITS))
                speed = np.float32(spd[hit])
                j += hit + 1
                break
            acc += int(csum[-1])
            speed = np.float32(spd[-1])
            j += kn
            if j >= T:
                fv_end = f + acc
                carry = fv_end >> POS_FRAC_BITS
                w = int(w + carry)
                f = int(fv_end - (carry << POS_FRAC_BITS))
                break

        # speed runs for visit [i, j)
        L = j - i
        cL = min(L, len(conv))
        if cL > 0:
            s_ints = np.rint(conv[:cL].astype(np.float64)
                             * POS_ONE).astype(np.int64)
            for (rs, s0, m) in _ap_runs(s_ints):
                if rs < cL:
                    runs.append((i + rs, s0, m))
        if L > cL:
            frozen_int = int(np.rint(np.float64(frozen) * POS_ONE))
            if runs and runs[-1][1] == frozen_int and runs[-1][2] == 0 \
                    and cL == 0:
                pass                       # merged with previous frozen run
            else:
                runs.append((i + cL, frozen_int, 0))
        i = j

    # ---- vectorized position reconstruction (NumPy twin of the device
    # kernel) — needed host-side only to locate splice triggers ----
    vs = np.asarray(vis_start, np.int64)
    rs_a = np.asarray([r[0] for r in runs], np.int64)
    s0_a = np.asarray([r[1] for r in runs], np.int64)
    m_a = np.asarray([r[2] for r in runs], np.int64)
    ii = np.arange(T, dtype=np.int64)
    rid = np.searchsorted(rs_a, ii, side="right") - 1
    s_int = s0_a[rid] + m_a[rid] * (ii - rs_a[rid])
    spd_all = (s_int.astype(np.float32) * POS_INV_F).astype(np.float32)
    inc_all = np.rint((spd_all * mod_q) * np.float32(POS_ONE)).astype(np.int64)
    excl = np.cumsum(inc_all) - inc_all
    vid = np.searchsorted(vs, ii, side="right") - 1
    rel = excl - excl[vs[vid]]
    fv = np.asarray(vis_bf, np.int64)[vid] + rel
    carry = fv >> POS_FRAC_BITS
    whole = np.asarray(vis_bw, np.int64)[vid] + carry
    frac = fv - (carry << POS_FRAC_BITS)
    sec = np.asarray(vis_sec, np.int64)[vid]

    # read-index mapping (mirror of _read_index) for trigger detection
    wrapped = np.mod(whole, n)
    sec_start = starts[sec]
    sec_end = np.maximum(ends[sec], sec_start + 1)
    local_w = np.mod(wrapped - sec_start, sec_end - sec_start)
    rev = reverse[np.clip(sec, 0, num_secs - 1)]
    idx_f = sec_start + local_w
    a = sec_end - 1 - local_w
    has_frac = frac > 0
    idx_r = np.where(has_frac, a - 1, a)
    idx_r = np.where((a == 0) & has_frac, 0, idx_r)
    idx0 = np.where(rev, idx_r, idx_f)
    idx0 = np.clip(idx0, 0, n - 1)

    triggers = []
    splice_rem = 0
    splice_idx = 0
    hits = np.zeros(0, np.int64)
    if len(boundaries) > 0:
        jb = np.searchsorted(boundaries, idx0)
        nb = len(boundaries)
        hitm = (jb < nb) & (boundaries[np.clip(jb, 0, nb - 1)] == idx0)
        hits = np.nonzero(hitm)[0]
    if consts.splice_on and len(boundaries) > 0:
        last_end = -1
        for t in hits:
            if t < last_end:
                continue
            triggers.append(int(t))
            last_end = t + splice_env_len
        if last_end > T:
            splice_rem = last_end - T
            splice_idx = splice_env_len - splice_rem

    final = dict(whole=int(w), frac=int(f), speed=float(speed),
                 splice_rem=int(splice_rem), splice_idx=int(splice_idx))
    return dict(
        visit_start=np.asarray(vis_start, np.int32),
        visit_bw=np.asarray(vis_bw, np.int32),
        visit_bf=np.asarray(vis_bf, np.int32),
        visit_sec=np.asarray(vis_sec, np.int32),
        run_start=np.asarray([r[0] for r in runs], np.int32),
        run_s0=np.asarray([r[1] for r in runs], np.int32),
        run_m=np.asarray([r[2] for r in runs], np.int32),
        triggers=np.asarray(triggers, np.int32),
        # pre-suppression boundary-hit sample indices: the trace renderer's
        # splice state machine (models/tape.py) needs raw hits because a
        # carried-in envelope (rem > 0 at segment entry) changes WHICH hits
        # trigger — greedy-suppressed triggers can't recover that
        hits=np.asarray(hits, np.int64),
        final=final)


def _wow_flutter_device(T: int, mod_ints, mod_flts, phase0):
    """Device twin of models.tape.wow_flutter_mod (same op sequence:
    exact integer phase reduction -> detmath sine -> 12-bit rounding ->
    exact-product depth scaling -> clip -> grid quantize)."""
    from . import detmath
    from .fixq import round_sig12, quantize_f32 as qf32

    i = jnp.arange(T, dtype=jnp.uint32)
    sw = round_sig12(detmath.sin_cycles(
        phase0[0] + detmath.phase_cycles(i, mod_ints[0], mod_ints[1],
                                         mod_flts[0])))
    sf = round_sig12(detmath.sin_cycles(
        phase0[1] + detmath.phase_cycles(i, mod_ints[2], mod_ints[3],
                                         mod_flts[1])))
    mod = jnp.float32(1.0) + mod_flts[2] * sw + mod_flts[3] * sf
    mod = jnp.clip(mod, jnp.float32(0.1), jnp.float32(3.0))
    return qf32(mod)


def _tape_read_blockwise(audio, idx0, fr, span_blocks: int, patch_cap: int,
                         chunk: int = 256):
    """Clip-mode blockwise fractional read: row-aligned window fetch +
    two-level one-hot matmul selection, with detect-and-patch for the rare
    blocks whose positions jump (visit boundaries, section-loop wraps).

    The pair gather reads 8.7 M elements for a 3-minute render; fetching
    whole 128-lane rows via one jnp.take moves far fewer indices and the
    one-hot selection is bit-exact.
    Tape positions move at most `span_blocks` samples per output inside a
    section visit, but jump arbitrarily at visit starts and when a
    section loops (local_w wraps at sec_len, _read_index) — every block
    whose in-window offsets leave [0, Wold) is detected ON DEVICE and
    overwritten with the canonical gather values; the HOST guarantees the
    bad-block count fits `patch_cap` (wraps bounded by
    T*max_inc/min_sec_len; falls back to the pair gather otherwise)."""
    n = audio.shape[0]
    T = idx0.shape[0]
    B = 128
    Wold = 2 * span_blocks * B + 16
    W = -(-(Wold + 128 + 1) // 128) * 128
    H = W // 128
    WR = H + 1
    K = T // B
    KC = -(-K // chunk) * chunk

    pw = idx0.reshape(K, B)
    f2 = fr.reshape(K, B)
    anchor = pw[:, 0] - jnp.int32(span_blocks * B + 4)
    d = pw - anchor[:, None]
    ok = jnp.all((d >= 0) & (d < Wold), axis=1)       # [K]
    d = jnp.clip(d, 0, Wold - 1)                      # keep bad blocks tame

    bias = ((span_blocks * B + 4 + 127) // 128) * 128 + 256
    q = anchor + jnp.int32(bias)                      # >= 256, row space
    rows0 = q >> 7
    local = d + (q - (rows0 << 7))[:, None]           # [0, Wold + 128)

    # ext[i] = audio[i - bias], zero lead-in (never selected), last-sample
    # clamp tail (gives x1 = audio[n-1] at the end, clip semantics)
    total = bias + n + W + 384
    padded = -(-total // 128) * 128
    ext2d = jnp.concatenate([
        jnp.zeros(bias, audio.dtype), audio,
        jnp.full(padded - bias - n, audio[n - 1], audio.dtype)]) \
        .reshape(-1, 128)

    if KC > K:
        pad = KC - K
        rows0 = jnp.concatenate([rows0, jnp.zeros(pad, rows0.dtype)])
        local = jnp.concatenate([local, jnp.zeros((pad, B), local.dtype)])
        f2 = jnp.concatenate([f2, jnp.zeros((pad, B), f2.dtype)])

    ridx = rows0[:, None] + jnp.arange(WR, dtype=jnp.int32)[None, :]
    wide = jnp.take(ext2d, ridx, axis=0).reshape(KC, WR * 128)
    win0 = jax.lax.slice(wide, (0, 0), (KC, W))
    winS = jax.lax.slice(wide, (0, 1), (KC, W + 1))

    l_iota = jnp.arange(128, dtype=jnp.int32)[None, None, :]
    h_iota = jnp.arange(H, dtype=jnp.int32)[None, None, :]

    def do_chunk(_, c):
        loc = jax.lax.dynamic_slice_in_dim(local, c * chunk, chunk, 0)
        ff = jax.lax.dynamic_slice_in_dim(f2, c * chunk, chunk, 0)
        w0 = jax.lax.dynamic_slice_in_dim(win0, c * chunk, chunk, 0) \
            .reshape(chunk, H, 128)
        wS = jax.lax.dynamic_slice_in_dim(winS, c * chunk, chunk, 0) \
            .reshape(chunk, H, 128)
        lo = loc & 127
        hi = loc >> 7
        oh_lo = (l_iota == lo[:, :, None]).astype(jnp.float32)
        oh_hi = (h_iota == hi[:, :, None]).astype(jnp.float32)

        def sel(w3):
            s = jnp.einsum("kbl,khl->kbh", oh_lo, w3,
                           precision=jax.lax.Precision.HIGHEST)
            return jnp.sum(oh_hi * s, axis=-1)

        x0 = sel(w0)
        x1 = sel(wS)                     # winS[local] == win0[local + 1]
        return None, (jnp.float32(1.0) - ff) * x0 + ff * x1

    _, ys = jax.lax.scan(do_chunk, None,
                         jnp.arange(KC // chunk, dtype=jnp.int32))
    s = ys.reshape(-1)[:T]

    # patch bad blocks with the canonical gather (deterministic id order:
    # all bad blocks first, then highest-id ok blocks as harmless filler)
    score = (~ok).astype(jnp.int32) * K \
        + (K - 1 - jnp.arange(K, dtype=jnp.int32))
    _, bad_ids = jax.lax.top_k(score, patch_cap)
    flat = (bad_ids[:, None] * B
            + jnp.arange(B, dtype=jnp.int32)[None, :]).reshape(-1)
    gi = idx0[flat]
    gf = fr[flat]
    x0 = audio[gi]
    x1 = audio[jnp.minimum(gi + 1, n - 1)]
    pv = (jnp.float32(1.0) - gf) * x0 + gf * x1
    return s.at[flat].set(pv)


def _tape_read_blockwise_sinc(audio, idx0, fr, span_blocks: int,
                              patch_cap: int, taps: int = 16,
                              chunk: int = 256):
    """Blockwise 16-tap Lanczos sinc read (quality mode): the SAME
    row-aligned window fetch and one-hot selection as the linear read —
    the taps are 16 one-column-shifted views of one window, selected with
    ONE shared pair of one-hots and accumulated in the exact tap order of
    fixq._sinc_weight_dot (tolerance twins, 1e-5).  The packed [n, taps]
    row-gather form pays per row; the window fetch is shared work.  Edge semantics match
    fixq.gather_sinc_clip: indices clamp to [0, n-1] (the ext lead-in is
    audio[0]-filled, the tail audio[n-1]-filled).  Bad blocks (visit
    starts, section-loop wraps) are detected and patched with the
    canonical gather_sinc_clip values."""
    from . import fixq as _fx
    n = audio.shape[0]
    T = idx0.shape[0]
    B = 128
    half = taps // 2
    Wold = 2 * span_blocks * B + 16
    W = -(-(Wold + 256 + taps + 2) // 128) * 128
    H = W // 128
    WR = H + 1
    K = T // B
    KC = -(-K // chunk) * chunk

    pw = idx0.reshape(K, B)
    f2 = fr.reshape(K, B)
    anchor = pw[:, 0] - jnp.int32(span_blocks * B + 4)
    d = pw - anchor[:, None]
    ok = jnp.all((d >= 0) & (d < Wold), axis=1)
    d = jnp.clip(d, 0, Wold - 1)

    bias = ((span_blocks * B + 4 + 127) // 128) * 128 + 256
    q = anchor + jnp.int32(bias)
    # window starts one row EARLY so tap t's static column shift
    # (t - (half-1) relative to the sample) stays non-negative:
    # ext[rows0*128 + local + t] == ext[bias + pw + (t - half + 1)]
    rows0 = (q >> 7) - 1
    local = d + (q - ((q >> 7) << 7))[:, None] + jnp.int32(129 - half)

    total = bias + n + W + 384
    padded = -(-total // 128) * 128
    ext2d = jnp.concatenate([
        jnp.full(bias, audio[0], audio.dtype), audio,
        jnp.full(padded - bias - n, audio[n - 1], audio.dtype)]) \
        .reshape(-1, 128)
    # lead-in is audio[0]-filled: tap indices idx0 + j reach down to
    # j = -(half-1), which must clamp to audio[0] exactly like
    # gather_sinc_clip's edge-padded shifts

    if KC > K:
        pad = KC - K
        rows0 = jnp.concatenate([rows0, jnp.zeros(pad, rows0.dtype)])
        local = jnp.concatenate([local, jnp.zeros((pad, B), local.dtype)])
        f2 = jnp.concatenate([f2, jnp.zeros((pad, B), f2.dtype)])

    ridx = rows0[:, None] + jnp.arange(WR, dtype=jnp.int32)[None, :]
    wide = jnp.take(ext2d, ridx, axis=0).reshape(KC, WR * 128)

    h_iota = jnp.arange(H, dtype=jnp.int32)[None, None, :]
    pi = float(np.pi)
    lane = jnp.arange(256, dtype=jnp.int32)[None, None, :]

    def do_chunk(_, c):
        loc = jax.lax.dynamic_slice_in_dim(local, c * chunk, chunk, 0)
        ff = jax.lax.dynamic_slice_in_dim(f2, c * chunk, chunk, 0)
        wd = jax.lax.dynamic_slice_in_dim(wide, c * chunk, chunk, 0)
        w3 = wd.reshape(chunk, WR, 128)
        lo = loc & 127
        hi = loc >> 7

        # the 16 taps of a sample live in at most TWO 128-lane rows of its
        # window: select both rows with one einsum each, then fold the
        # tap WEIGHTS into a single multi-hot over the 256-lane pair and
        # reduce once — 16 separate one-hot selections cost ~16x the
        # contraction flops and dominated the read
        oh_hi0 = (h_iota == hi[:, :, None]).astype(jnp.float32)
        oh_hi1 = (h_iota == (hi + 1)[:, :, None]).astype(jnp.float32)
        row0 = jnp.einsum("kbh,khl->kbl", oh_hi0, w3[:, :H],
                          precision=jax.lax.Precision.HIGHEST)
        row1 = jnp.einsum("kbh,khl->kbl", oh_hi1, w3[:, :H],
                          precision=jax.lax.Precision.HIGHEST)
        pair = jnp.concatenate([row0, row1], axis=-1)   # [k, B, 256]

        # Lanczos weights by angle addition: at integer tap offsets,
        # sin(pi*(j-f)) = -(-1)^j sin(pi f) and sin(pi*(j-f)/half) expands
        # over static sin/cos(pi j/half) — THREE transcendentals per
        # sample instead of 2 per tap.  Agrees with fixq._lanczos_w to
        # ~ulp (the sinc twins are tolerance-based, 1e-5).
        sf = jnp.sin(jnp.float32(pi) * ff)
        sf8 = jnp.sin(jnp.float32(pi / half) * ff)
        cf8 = jnp.cos(jnp.float32(pi / half) * ff)

        ohw = jnp.zeros((chunk, B, 256), jnp.float32)
        wsum = jnp.zeros((chunk, B), jnp.float32)
        for t, j in enumerate(range(-half + 1, half + 1)):
            x = jnp.float32(j) - ff
            xs = jnp.where(x == 0.0, jnp.float32(1.0), x)
            sj = float(np.sin(pi * j / half))
            cj = float(np.cos(pi * j / half))
            s1 = (jnp.float32(-((-1.0) ** j)) * sf) / (jnp.float32(pi) * xs)
            s2 = (jnp.float32(sj) * cf8 - jnp.float32(cj) * sf8) \
                / (jnp.float32(pi / half) * xs)
            w = jnp.where(x == 0.0, jnp.float32(1.0),
                          jnp.where(jnp.abs(x) < half, s1 * s2,
                                    jnp.float32(0.0)))
            ohw = ohw + (lane == (lo + t)[:, :, None]) * w[:, :, None]
            wsum = wsum + w
        acc = jnp.sum(ohw * pair, axis=-1)
        return None, acc / wsum

    _, ys = jax.lax.scan(do_chunk, None,
                         jnp.arange(KC // chunk, dtype=jnp.int32))
    s = ys.reshape(-1)[:T]

    score = (~ok).astype(jnp.int32) * K \
        + (K - 1 - jnp.arange(K, dtype=jnp.int32))
    _, bad_ids = jax.lax.top_k(score, patch_cap)
    flat = (bad_ids[:, None] * B
            + jnp.arange(B, dtype=jnp.int32)[None, :]).reshape(-1)
    gi = idx0[flat]
    # canonical clip-mode sinc values for the patched samples; fr here is
    # already f32 (the kernel's fraction), so inline the weight dot on
    # per-tap clamped gathers (small: patch_cap*128 rows)
    gf = fr[flat]
    acc = jnp.zeros(flat.shape, jnp.float32)
    wsum = jnp.zeros(flat.shape, jnp.float32)
    for j in range(-half + 1, half + 1):
        w = _fx._lanczos_w(jnp.float32(j) - gf, half)
        acc = acc + w * audio[jnp.clip(gi + j, 0, n - 1)]
        wsum = wsum + w
    return s.at[flat].set(acc / wsum)


@partial(jax.jit, static_argnames=("consts", "t_total", "out_i16",
                                  "interp", "stereo", "blockwise_span",
                                  "patch_cap", "with_pieces"))
def tape_device_render(audio, mod_ints, mod_flts, phase0,
                       visit_start, visit_bw, visit_bf, visit_sec,
                       run_start, run_s0, run_m,
                       starts, ends, reverse, boundaries,
                       splice_trig, splice_env,
                       consts: TapeConsts, t_total: int,
                       out_i16: bool = False, interp: str = "linear",
                       stereo: bool = False, n_valid=None,
                       blockwise_span: int = 0, patch_cap: int = 0,
                       with_pieces: bool = False,
                       splice_off=None, splice_len=None):
    """Whole tape render on device from compact control tables.

    Bit-reproduces the segment engine's positions: the increments are the
    same single-rounded f32 products of exactly-representable operands, the
    visit bases pin each section visit to the host's decision, and all
    discrete mappings are integer math.  Audio differs from the scan engine
    only by elementwise f32 rounding (parity tests assert <= -120 dBFS).

    `n_valid` (traced scalar, optional): true frame count when t_total is
    the bucketed padded length — samples at ii >= n_valid are zeroed so
    the PADDED buffer is safe to consume directly (drains/sums see no
    garbage tail).  Callers keep the padded shape: slicing to the exact
    length mints a fresh XLA slice kernel per distinct length, which
    dominated fresh-program render loops."""
    n = audio.shape[0]
    T = int(t_total)
    i32 = jnp.int32
    ii = jnp.arange(T, dtype=i32)

    mod = _wow_flutter_device(T, mod_ints, mod_flts, phase0)
    rid = jnp.searchsorted(run_start, ii, side="right").astype(i32) - 1
    rid = jnp.clip(rid, 0, run_start.shape[0] - 1)
    s_int = run_s0[rid] + run_m[rid] * (ii - run_start[rid])
    spd = s_int.astype(jnp.float32) * POS_INV_F
    inc = jnp.rint((spd * mod) * jnp.float32(POS_ONE)).astype(i32)

    reset = jnp.zeros(T, jnp.bool_)
    if visit_start.shape[0] > 1:
        reset = reset.at[visit_start[1:]].set(True, mode="drop")
    inc_shift = jnp.concatenate([jnp.zeros(1, i32), inc[:-1]])
    inc_shift = jnp.where(reset, 0, inc_shift)
    from .fixq import segmented_pos_cumsum
    whole_rel, frac_rel = segmented_pos_cumsum(inc_shift, reset)
    vid = jnp.cumsum(reset.astype(i32))
    vid = jnp.clip(vid, 0, visit_bw.shape[0] - 1)
    f = frac_rel + visit_bf[vid]
    carry = f >> POS_FRAC_BITS
    whole = whole_rel + visit_bw[vid] + carry
    frac = f - (carry << POS_FRAC_BITS)

    wrapped = jnp.mod(whole, n)
    sec = visit_sec[vid]
    sec_start = starts[sec]
    sec_end = jnp.maximum(ends[sec], sec_start + 1)
    idx0, fr = _read_index(wrapped, frac, sec_start, sec_end, reverse[sec])
    idx0 = jnp.clip(idx0, 0, n - 1)

    gain = jnp.ones(T, jnp.float32)
    if consts.anticlick_on and boundaries.shape[0] > 0 and consts.smooth_len > 0:
        dmin = _boundary_min_dist(boundaries, idx0)
        inv_smooth = jnp.float32(1.0 / max(1, consts.smooth_len))
        x = (consts.smooth_len - dmin).astype(jnp.float32) * inv_smooth
        g = jnp.maximum(jnp.float32(0.0),
                        jnp.float32(1.0)
                        - jnp.float32(consts.anticlick_strength) * x)
        gain = jnp.where(dmin < consts.smooth_len, g, gain)
    if consts.splice_on and splice_trig.shape[0] > 0:
        E = splice_env.shape[0]
        j = jnp.arange(E, dtype=i32)[None, :]
        rows = splice_trig[:, None] + j
        if with_pieces:
            # trace path: each trigger is an envelope PIECE (t, off, len) —
            # a performance trace can pause an envelope mid-decay (splice
            # toggled off freezes rem/sidx, Tape…py:851-858) and resume it
            # in a later segment.  Application ranges never overlap, but a
            # piece's masked 1.0 filler rows CAN cross a neighbouring
            # piece, so scatter with max(): every env value > 1.0 beats
            # the filler and the result is order-independent.
            buf = jnp.ones(T + E, jnp.float32)
            idx = jnp.clip(splice_off[:, None] + j, 0, E - 1)
            vals = jnp.where(j < splice_len[:, None], splice_env[idx],
                             jnp.float32(1.0))
            buf = buf.at[rows.reshape(-1)].max(vals.reshape(-1))
        else:
            # triggers are >= E apart (host greedy suppression) so the
            # scatter rows never overlap; padding triggers sit at t_total
            # and land in the sliced-off tail of the T+E buffer
            buf = jnp.ones(T + E, jnp.float32)
            vals = jnp.broadcast_to(splice_env[None, :], rows.shape)
            buf = buf.at[rows.reshape(-1)].set(vals.reshape(-1))
        gain = gain * buf[:T]

    if interp == "sinc":
        # quality mode (fixq.gather_sinc_clip): Lanczos-windowed sinc.
        # fr is in 2^-22 units there; here fr is already f32 in [0,1)
        from .fixq import POS_ONE as _PO
        fq = jnp.rint(fr * jnp.float32(_PO)).astype(jnp.int32)
        from . import fixq as _fx
        if blockwise_span > 0:
            # same fraction quantization roundtrip as gather_sinc_clip
            frq = fq.astype(jnp.float32) * POS_INV_F
            s = _tape_read_blockwise_sinc(audio, idx0, frq, blockwise_span,
                                          patch_cap)
        else:
            s = _fx.gather_sinc_clip(audio, idx0, fq)
    elif blockwise_span > 0:
        # row-aligned blockwise matmul read with detect-and-patch
        s = _tape_read_blockwise(audio, idx0, fr, blockwise_span, patch_cap)
    else:
        # ONE packed pair gather instead of two element gathers: element
        # gathers cost per index, not per byte (same trick as the CA's
        # packed ember gather); values are identical so parity is exact
        pairs = jnp.stack(
            [audio, jnp.concatenate([audio[1:], audio[-1:]])], axis=-1)
        pr = pairs[idx0]
        s = (jnp.float32(1.0) - fr) * pr[:, 0] + fr * pr[:, 1]
    s = jnp.clip(s * gain, -1.0, 1.0)
    if n_valid is not None:
        s = jnp.where(ii < n_valid, s, jnp.float32(0.0))
    if stereo:
        # stereo export: identical samples on both channels, duplicated on
        # device so the (timed) d2h pull carries real stereo PCM bytes
        s = jnp.stack([s, s], axis=-1)
    if out_i16:
        q = jnp.clip(jnp.rint(s * jnp.float32(32768.0)), -32768.0, 32767.0)
        return q.astype(jnp.int16)
    return s


@jax.jit
def tape_gather_render(audio, idx0, fr, gain):
    """Device half of the segment engine: fractional gather + combined
    anti-click*splice gain + clip.  (Combining the two gain multiplies
    differs from the scan engine by <= 1 ulp of the sample — the parity
    tests assert <= -120 dBFS.)  Pure elementwise/gather — saturates HBM
    bandwidth instead of crawling through a sequential scan."""
    n = audio.shape[0]
    idx1 = jnp.minimum(idx0 + 1, n - 1)
    s = (jnp.float32(1.0) - fr) * audio[idx0] + fr * audio[idx1]
    s = s * gain
    return jnp.clip(s, -1.0, 1.0)


def tape_segment_render(audio, mod_q, starts, ends, speeds_q, reverse,
                        boundaries, splice_env, consts: TapeConsts):
    """Parallel tape engine: host exact trajectory + device gather kernel.
    Decision-exact vs tape_scan_render (same quantized integers); audio
    differs only by elementwise f32 rounding (<= 1 ulp per sample)."""
    from ..utils import native_rt
    traj = native_rt.tape_trajectory(
        len(mod_q), audio.shape[0], mod_q, starts, ends, speeds_q, reverse,
        boundaries, splice_env, consts, 0, 0)
    if traj is None:    # no compiler: NumPy fallback, same results
        traj = tape_trajectory(audio.shape[0], mod_q, starts, ends, speeds_q,
                               reverse, boundaries, splice_env.shape[0],
                               consts)
    # NumPy args transfer bundled with the single jit call; gains combined
    # host-side to ship one array instead of two
    out = tape_gather_render(audio, traj["idx0"], traj["fr"],
                             traj["ga"] * traj["gs"])
    return out, traj["final"]
