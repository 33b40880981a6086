"""FM / PSG voice kernels — the Mega Drive-ish synth as vmapped device math.

Ports of pattern lab 0.1/app/synth_fm.py (4-op phase-modulation voice with
feedback + vibrato) and app/synth_psg.py (duty square / 15-bit LFSR noise).
The reference's two per-sample Python loops become:

- one-pole lowpass  -> log-depth linear-recurrence associative scan
  (synth_fm.py:115-124, synth_psg.py:115-124)
- LFSR noise        -> pure gather: the LFSR transition is a bijection on
  15-bit states, so its orbits are precomputed once on host and a note's
  noise is a (base + i) mod cycle_len lookup (synth_psg.py:89-97)

All kernels take a padded sample-index vector i[L] plus a true length n and
mask internally, so notes of different lengths vmap into static-shape buckets.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from .envelopes import adsr_clamped, adsr_from_consts, micro_fade_gain
from . import detmath


# ----------------------------------------------------------------------------
# Quantizer (app/music.py:89-94)
# ----------------------------------------------------------------------------

def quantize_to_bits(x, levels_minus_1, inv_levels_m1):
    """Symmetric bit quantization; levels_minus_1 = 2**(bits-1) - 1 (f32).

    The downscale is a multiply by a host-precomputed f32 reciprocal, not a
    division: device f32 division is not guaranteed correctly rounded, and
    any last-ulp wiggle here lands directly on the quantizer's output grid.
    All ops stay f32 so the NumPy twin (utils/music.quantize_to_bits_f32_np)
    is bit-identical."""
    y = jnp.clip(x, -1.0, 1.0)
    return jnp.round(y * levels_minus_1) * inv_levels_m1


# ----------------------------------------------------------------------------
# One-pole lowpass as an associative scan
# ----------------------------------------------------------------------------

def one_pole_lp(x, a):
    """y[t] = a*y[t-1] + (1-a)*x[t], y[-1] = 0 (synth_fm.py:115-124).

    For the audio-rate cutoffs used by the synth (12-14 kHz -> a <= ~0.19)
    the impulse response (1-a)*a^k underflows one f32 ulp RELATIVE within
    ~13 taps, so the IIR is evaluated as a truncated FIR of K static
    shifted adds, K = first k with a^k < 2^-31 (truncation ~-190 dB,
    far under the -60 dBFS oracle budget; association differs from the
    sequential loop by output ulps).  This replaces a log-depth
    associative scan whose slice/pad ladder cost more device time than
    the entire voice math.  Falls back to the scan when a is too
    close to 1 for a short kernel (K would exceed 64)."""
    try:
        af = float(np.float32(a))   # requires a static (untraced) coefficient
        K, p = 1, af
        while p >= 2.0 ** -31 and K < 64:
            p *= af
            K += 1
    except (TypeError, jax.errors.TracerArrayConversionError):
        K = 64                       # traced coefficient -> scan path
        af = None
    if K >= 64:
        a = jnp.float32(a)
        b = (jnp.float32(1.0) - a) * x
        A = jnp.full_like(x, a)

        def combine(l, r):
            al, bl = l
            ar, br = r
            return al * ar, ar * bl + br

        _, y = jax.lax.associative_scan(combine, (A, b), axis=-1)
        return y
    w = ((1.0 - np.float64(af)) * np.float64(af) ** np.arange(K)) \
        .astype(np.float32)
    y = jnp.float32(w[0]) * x
    pad = [(0, 0)] * (x.ndim - 1)
    for k in range(1, K):
        xk = jnp.pad(x, pad + [(k, 0)])[..., :-k]
        y = y + jnp.float32(w[k]) * xk
    return y


# ----------------------------------------------------------------------------
# LFSR noise via orbit tables
# ----------------------------------------------------------------------------

def _lfsr_next(s: int) -> int:
    """synth_psg.py:92-95: bit = (s ^ (s>>1)) & 1; s' = (s>>1) | (bit<<14)."""
    bit = (s ^ (s >> 1)) & 1
    return (s >> 1) | (bit << 14)


@lru_cache(maxsize=1)
def lfsr_tables():
    """Decompose the 15-bit LFSR transition (a bijection) into orbits.

    Returns (orbit_pm1[f32 total_states], base[int32 2**15],
    pos[int32 2**15], clen[int32 2**15]) such that the k-th output sample for
    seed s is orbit_pm1[base[s] + (pos[s] + 1 + k) % clen[s]].
    """
    N = 1 << 15
    nxt = np.empty(N, np.int32)
    for s in range(N):
        nxt[s] = _lfsr_next(s)
    visited = np.zeros(N, bool)
    base = np.zeros(N, np.int32)
    pos = np.zeros(N, np.int32)
    clen = np.zeros(N, np.int32)
    flat = []
    for s0 in range(N):
        if visited[s0]:
            continue
        cyc = []
        s = s0
        while not visited[s]:
            visited[s] = True
            cyc.append(s)
            s = nxt[s]
        # s0's chain may lead into an existing cycle; the LFSR map is a
        # bijection so every chain IS a cycle, but guard anyway
        b = len(flat)
        for p, st in enumerate(cyc):
            base[st] = b
            pos[st] = p
            clen[st] = len(cyc)
        flat.extend(cyc)
    flat = np.asarray(flat, np.int32)
    orbit_pm1 = np.where((flat & 1) != 0, 1.0, -1.0).astype(np.float32)
    return orbit_pm1, base, pos, clen


def lfsr_noise(i, seed, orbit_pm1, base, pos, clen):
    """±1 noise samples for `seed` at indices i (device gather)."""
    s = seed & 0x7FFF
    b = base[s]
    p = pos[s]
    L = clen[s]
    idx = b + jnp.mod(p + 1 + i, L)
    return orbit_pm1[idx]


# ----------------------------------------------------------------------------
# PSG voice (synth_psg.py:100-124)
# ----------------------------------------------------------------------------

def psg_note(i, n, hz, vel, duty, use_noise, A, D, R, s, levels_m1,
             inv_levels_m1, fade_samples, lp_a, seed, orbit_pm1, base, pos,
             clen, sr, env_consts=None):
    """One PSG note over padded indices i[L]; masked beyond n.

    env_consts: optional (n_a, n_d, n_r, inv_na, inv_nd, inv_dr, startv)
    host-precomputed stage constants — division-free envelope, bit-identical
    to the oracle on every backend (envelopes.adsr_from_consts)."""
    if env_consts is not None:
        env = adsr_from_consts(i, n, *env_consts, s)
    else:
        env = adsr_clamped(i, n, A, D, R, s)
    # t via reciprocal multiply and phase via explicit floor-subtract:
    # exact-rounded IEEE ops on every backend, so the duty-cycle sign
    # decision below can never flip vs the NumPy oracle (a square flip is
    # a full +-2 swing -> ~-54 dBFS through the 10-bit quantizer)
    t = i.astype(jnp.float32) * jnp.float32(1.0 / float(sr))
    prod = t * hz
    phase = prod - jnp.floor(prod)
    square = jnp.where(phase < duty, jnp.float32(1.0), jnp.float32(-1.0))
    noise = lfsr_noise(i, seed, orbit_pm1, base, pos, clen)
    sig = jnp.where(use_noise, noise, square)
    y = sig * env * vel
    y = quantize_to_bits(y, levels_m1, inv_levels_m1)
    y = y * micro_fade_gain(i, n, fade_samples)
    y = one_pole_lp(y, lp_a)
    return jnp.where(i < n, y, jnp.float32(0.0))


# ----------------------------------------------------------------------------
# FM voice (synth_fm.py:127-191)
# ----------------------------------------------------------------------------

def fm_note(i, n, f_ops, vel, chan_params, fade_samples, lp_a1, lp_a2,
            dac_levels_m1, inv_dac_levels_m1, sr, alg_static=None,
            vib_static=None):
    """One 4-operator FM note over padded indices i[L].

    alg_static: when the caller buckets notes by algorithm (static), only
    that algorithm's operator stack is traced — the branchless all-three
    evaluation costs ~2x the transcendental work (9 op evaluations vs
    4-5).  None keeps the branchless path (callers with mixed algorithms
    in one batch, e.g. the dryrun's event-sharded job batch).

    vib_static: when the caller additionally buckets by lfo_depth > 0,
    False skips the vibrato chain entirely (the LFO sine + the exp2 —
    whose 33-entry table gather costs per element — vanish from
    the trace; values identical to the where(has_vib=False) select) and
    True applies it unconditionally.  None keeps the dynamic select.

    f_ops: f32[4] per-op frequencies in Hz (host-precomputed
      base * ratio * 2**(cents/1200), single f64->f32 cast).
    chan_params: dict of per-channel scalars/vectors gathered outside:
      level[4], index_cyc[4] (mod index / 2*pi — PM depth in cycles),
      A[4] D[4] R[4] (int32), s[4], algorithm (int32), feedback (f32),
      lfo_hz (f32), lfo_depth (f32)

    Phases are evaluated in CYCLES with exact frac reduction (ops/detmath.py)
    so the NumPy oracle matches bit-for-bit; the three algorithms are all
    evaluated and selected — branchless for vmap.

    FMA/division discipline: t comes from a reciprocal multiply (device
    division is not guaranteed correctly rounded), and every multiply that
    feeds an add (the PM terms, the feedback tap) uses 12-bit-rounded
    operands so the product is exact and XLA's FMA contraction cannot change
    rounding vs the oracle.  A last-ulp difference anywhere upstream of the
    14-bit DAC quantizer flips a whole quantization step (-78 dBFS).
    """
    t = i.astype(jnp.float32) * jnp.float32(1.0 / float(sr))

    if vib_static is None or vib_static:
        lfo_depth = chan_params["lfo_depth"]
        # precise (FMA-safe) twins: the plain sin_cycles/exp2 pair is
        # bit-identical to the NumPy oracle when compiled in isolation, but
        # inside this fused kernel XLA contracts their Horner ladders into
        # FMAs — measured ~9 one-ulp vib_ratio flips per long note, each
        # amplified by the carrier cycle count into a 14-bit DAC step flip
        vib = detmath.sin_cycles_precise(chan_params["lfo_hz"] * t)
        vib_ratio = detmath.exp2_precise((lfo_depth * vib)
                                         * jnp.float32(1.0 / 12.0))
        has_vib = (lfo_depth > 0.0) if vib_static is None else True

    def op_sig(k, pm_cyc):
        # carrier cycles, reduced before adding the (small) PM term so the
        # product can't contract with the add into an FMA
        c = f_ops[k] * t
        if vib_static is None:
            c = jnp.where(has_vib, c * vib_ratio, c)
        elif vib_static:
            c = c * vib_ratio
        r0 = detmath.frac_signed(c)
        if pm_cyc is not None:
            r0 = r0 + pm_cyc
        sig = detmath.sin_cycles(r0)
        if "env_n_a" in chan_params:
            # host-precomputed stage consts: no on-device division, so the
            # envelope is bit-identical to the oracle on every backend
            # (device f32 division need not be correctly rounded — see
            # envelopes.adsr_from_consts)
            env = adsr_from_consts(
                i, n, chan_params["env_n_a"][k], chan_params["env_n_d"][k],
                chan_params["env_n_r"][k], chan_params["env_inv_na"][k],
                chan_params["env_inv_nd"][k], chan_params["env_inv_dr"][k],
                chan_params["env_startv"][k], chan_params["s"][k])
        else:
            env = adsr_clamped(i, n, chan_params["A"][k],
                               chan_params["D"][k],
                               chan_params["R"][k], chan_params["s"][k])
        return sig * env * chan_params["level"][k]

    from .fixq import round_sig12
    fb = round_sig12(jnp.maximum(jnp.float32(0.0), chan_params["feedback"]))
    idx = round_sig12(chan_params["index_cyc"])

    def pm(k, m):
        # exact product (both operands 12-bit significands): immune to FMA
        # contraction into the r0 + pm add inside op_sig
        return idx[k] * round_sig12(m)

    # shared by algorithms 1 & 2: op4 with one-sample feedback delay
    o4 = op_sig(3, None)
    o4fb = o4 + fb * round_sig12(
        jnp.concatenate([jnp.zeros(1, jnp.float32), o4[:-1]]))
    use_fb = fb > 0
    o4_eff = jnp.where(use_fb, o4fb, o4)

    def y_alg1():
        # algorithm 1: 4 -> 3 -> 2 -> 1
        o3 = op_sig(2, pm(2, o4_eff))
        o2 = op_sig(1, pm(1, o3))
        return op_sig(0, pm(0, o2))

    def y_alg2():
        # algorithm 2: (4->3) + (2->1), sum * 0.6
        o3 = op_sig(2, pm(2, o4_eff))
        o2 = op_sig(1, None)
        o1 = op_sig(0, pm(0, o2))
        return (o3 + o1) * jnp.float32(0.6)

    def y_alg3():
        # algorithm 3: all carriers * 0.25
        return (op_sig(0, None) + op_sig(1, None) + op_sig(2, None)
                + o4) * jnp.float32(0.25)

    if alg_static is not None:
        y = {1: y_alg1, 2: y_alg2, 3: y_alg3}[int(alg_static)]()
    else:
        alg = chan_params["algorithm"]
        y = jnp.where(alg == 1, y_alg1(),
                      jnp.where(alg == 2, y_alg2(), y_alg3()))

    y = y * vel
    y = quantize_to_bits(y, dac_levels_m1, inv_dac_levels_m1)
    y = y * micro_fade_gain(i, n, fade_samples)
    y = one_pole_lp(y, lp_a1)
    y = one_pole_lp(y, lp_a2)
    return jnp.where(i < n, y, jnp.float32(0.0))
