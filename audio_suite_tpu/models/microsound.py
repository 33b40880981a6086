"""Microsound engine — granular/transient "unfold" synthesis on device.

Re-creates the full render pipeline of microsound_0.2.1/main_v2.py:588-792
(the reference suite's deepest pipeline) as a device-first design:

- event fields (Single/Poisson/Clustered/Hawkes) are host metadata
  (events/schedulers.py, main_v2.py:507-558);
- every per-event quantity that the reference derives from breakpoint lanes
  and its sequential RNG (lengths, design rates, amps, offsets, aux draws) is
  precomputed host-side into a "program" of stacked arrays — reference-exact
  randomness for all small draws (same np.random.default_rng(seed+i) streams);
- the per-event generator/warp chain (main_v2.py:651-727) runs as ONE vmapped
  device kernel over the event batch at a static padded length (grains are
  length-bucketed; FFTs run at the padded length — documented framework
  semantics, the NumPy oracle is the parity reference);
- the sequential event-feedback crossfade + SpectralImprint recurrence
  (main_v2.py:731-740, 565-581) runs as lax.scan over events;
- overlap-add placement is a single scatter-add (main_v2.py:742-755);
- global FX (ADSR, early-reflection cloud, IR convolution, stereo diffusion,
  soft clip, normalize; main_v2.py:760-781) run as partitioned-FFT device ops.

Events are processed in fixed-size chunks so arbitrarily dense event fields
render in bounded memory (SURVEY.md §5 long-context strategy); the feedback
carry flows across chunks.

Preset compatibility: `MicrosoundParams.from_dict` merges partial dicts over
factory defaults exactly like the reference's apply_params
(main_v2.py:1268-1294), so all reference preset JSONs load unchanged.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..events.schedulers import generate_event_times
from ..ops import envelopes, generators, pallas_oa, space, spectral
from ..utils.breakpoints import (parse_breakpoints, eval_breakpoints,
                                 eval_breakpoints_vec)
from ..utils.transfer import chunked_pull

GEN_MODES = (
    "Gaussian click", "Dust impulses", "Noise burst", "Skewed transient",
    "Resonant strike", "Crackle / corona", "Stick–slip friction",
    "Micro-chaos", "Wavelet atoms", "IR fragment", "Image scanline",
)
MAX_GEN_SR = 30_000_000  # design-rate clamp (main_v2.py:597)


@dataclass
class MicrosoundParams:
    """The reference's ~80-key parameter schema (get_params,
    main_v2.py:1166-1266) with the reference UI's factory defaults
    (main_v2.py:890-1165)."""
    base_sr: int = 48000
    out_dur_s: float = 8.0
    time_unfold: float = 25.0
    peak: float = 0.98
    sat_drive: float = 1.0
    stereo_on: bool = True
    stereo_width: float = 0.65

    gen_mode: str = "Gaussian click"
    micro_ms: float = 1.25
    seed: int = 12345
    dust_density: float = 0.02
    noise_tilt: float = -3.0
    ring_hz: float = 4200.0
    ring_decay_ms: float = 12.0

    crackle_alpha: float = 1.4
    crackle_density: float = 180.0
    crackle_kernel: int = 64

    ss_threshold: float = 0.9
    ss_build: float = 0.06
    ss_decay: float = 0.75
    ss_noise: float = 0.08

    chaos_r: float = 3.92
    chaos_gate: float = 0.35

    wav_base_hz: float = 2400.0
    wav_count: int = 8
    wav_spread: float = 0.6

    unfold_mode: str = "Classic reinterpret"
    partial_stretch: float = 1.0
    partial_lock_on: bool = False
    pl_top_n: int = 24
    pl_neigh: int = 4
    nl_warp_on: bool = False
    nl_warp_power: float = 1.25
    cep_warp_on: bool = False
    cep_factor: float = 1.2

    mb_b1: float = 2000.0
    mb_b2: float = 8000.0
    mb_b3: float = 20000.0
    mb_u1: float = 35.0
    mb_u2: float = 20.0
    mb_u3: float = 12.0
    mb_roll: float = 2000.0

    bandlimit_on: bool = True
    bandlimit_out_hz: float = 18000.0
    bandlimit_roll_hz: float = 2500.0

    event_process: str = "Poisson"
    grains_per_sec: float = 18.0
    max_grains: int = 4000
    grain_amp_rand: float = 0.35
    grain_offset_on: bool = True
    grain_offset_max_ms: float = 60.0
    cluster_size: int = 6
    cluster_spread_ms: float = 25.0
    hawkes_gain: float = 0.6
    hawkes_decay_s: float = 0.25

    bp_density: str = "0:18, 4:40, 8:14"
    bp_unfold: str = ""
    bp_cutoff: str = ""
    bp_stretch: str = ""

    res_bank_on: bool = False
    res_modes: int = 24
    res_fmin: float = 120.0
    res_fmax: float = 12000.0
    res_decay_ms: float = 80.0

    wg_on: bool = False
    wg_lines: int = 8
    wg_max_ms: float = 8.0
    wg_fb: float = 0.7

    event_feedback_on: bool = False
    event_feedback_amt: float = 0.35
    spectral_imprint_on: bool = False
    spectral_imprint_amt: float = 0.35
    spectral_imprint_smooth: float = 0.92

    er_cloud_on: bool = True
    er_taps: int = 320
    er_max_ms: float = 45.0
    space_ir_on: bool = False
    space_ir_max_samps: int = 12000

    env_a: float = 20.0
    env_d: float = 250.0
    env_s: float = 0.65
    env_r: float = 1800.0
    env_curve: float = 1.8

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "MicrosoundParams":
        """Factory-default merge for partial presets (main_v2.py:1276-1294):
        known keys override defaults, unknown keys are ignored."""
        fields = {f.name: f.type for f in dataclasses.fields(MicrosoundParams)}
        p = MicrosoundParams()
        for k, v in (d or {}).items():
            if k in fields:
                cur = getattr(p, k)
                if isinstance(cur, bool):
                    v = bool(v)
                elif isinstance(cur, int):
                    v = int(v)
                elif isinstance(cur, float):
                    v = float(v)
                else:
                    v = str(v)
                setattr(p, k, v)
        return p


def load_preset(path: str) -> MicrosoundParams:
    with open(path) as f:
        return MicrosoundParams.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# Host program builder
# ---------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _event_n(mode: str, gen_sr: int, micro_ms: float, have_ir: bool) -> int:
    """Per-mode minimum grain lengths (main_v2.py:221,273,285,305,319,337,352;
    IR-fragment falls back to the 16-sample floor when no IR is loaded,
    main_v2.py:335-336)."""
    base = round(gen_sr * micro_ms / 1000.0)
    if mode in ("Stick–slip friction", "Micro-chaos"):
        return int(max(64, base))
    if mode == "Wavelet atoms":
        return int(max(128, base))
    if mode == "IR fragment":
        return int(max(64, base)) if have_ir else int(max(16, base))
    if mode == "Image scanline":
        return int(max(64, base))
    return int(max(16, base))


def build_program_seq(params: MicrosoundParams, ir_audio=None, img_gray=None):
    """Scalar per-event twin of build_program — the original reference-shaped
    loop, kept as the bit-exactness ground truth for the vectorized builder
    (tests assert build_program == build_program_seq array-for-array).

    Precomputes the full event program: times, per-event scalars (lengths,
    rates, amps, offsets — reference-exact rng(seed+123456) consumption,
    main_v2.py:618-755) and per-event auxiliary draws (rng(seed+i) streams,
    main_v2.py:219-402)."""
    p = params
    base_sr = int(p.base_sr)
    out_n = int(max(1, round(float(p.out_dur_s) * base_sr)))
    base_unfold = max(1.0, float(p.time_unfold))

    bp_density = parse_breakpoints(p.bp_density)
    bp_unfold = parse_breakpoints(p.bp_unfold)
    bp_cutoff = parse_breakpoints(p.bp_cutoff)
    bp_stretch = parse_breakpoints(p.bp_stretch)

    rate = float(p.grains_per_sec)
    times = generate_event_times(
        p.event_process, float(p.out_dur_s), rate, seed=int(p.seed),
        cluster_size=int(p.cluster_size),
        cluster_spread_ms=float(p.cluster_spread_ms),
        hawkes_gain=float(p.hawkes_gain),
        hawkes_decay_s=float(p.hawkes_decay_s))
    times = times[: int(p.max_grains)]

    rng = np.random.default_rng(int(p.seed) + 123456)
    mode = p.gen_mode
    have_ir = ir_audio is not None and np.asarray(ir_audio).size >= 32

    ir_mono = None
    if ir_audio is not None:
        ir_mono = np.asarray(ir_audio, np.float64)
        if ir_mono.ndim > 1:
            ir_mono = ir_mono.mean(axis=1)

    ev = {k: [] for k in ("seed", "n", "gen_sr", "inv_gen_sr", "amp",
                          "offset", "start", "cutoff_gen", "stretch")}
    aux = {k: [] for k in ("dust_pos", "dust_amp", "dust_k", "dust_klen",
                           "ck_pos", "ck_amp", "wl_f0", "wl_sigma",
                           "wl_phase", "wl_shift", "frag", "frag_len",
                           "res_f", "res_ph", "wg_d", "wg_g", "wg_m")}

    for i, t0 in enumerate(times):
        dens = eval_breakpoints(bp_density, t0, default=rate)
        ufac = eval_breakpoints(bp_unfold, t0, default=base_unfold)
        cutoff_out = eval_breakpoints(bp_cutoff, t0,
                                      default=float(p.bandlimit_out_hz))
        stretch = eval_breakpoints(bp_stretch, t0,
                                   default=float(p.partial_stretch))

        amp = 1.0
        if rate > 0:
            amp *= float(np.clip(dens / max(1e-6, rate), 0.15, 4.0))
        amp *= float(rng.uniform(1.0 - float(p.grain_amp_rand),
                                 1.0 + float(p.grain_amp_rand)))

        ufac = max(1.0, float(ufac))
        gen_sr_evt = int(np.clip(int(round(base_sr * ufac)),
                                 base_sr, MAX_GEN_SR))
        n = _event_n(mode, gen_sr_evt, float(p.micro_ms), have_ir)

        start = int(round(t0 * base_sr))
        if start >= out_n:
            continue  # reference skips before the offset draw (:750)

        offset = 0
        if p.grain_offset_on:
            max_off = int(round(float(p.grain_offset_max_ms) / 1000.0
                                * base_sr))
            if max_off > 0:
                offset = int(rng.integers(0, max(1, min(max_off, n))))

        ev["seed"].append(int(p.seed) + i)
        ev["n"].append(n)
        ev["gen_sr"].append(float(gen_sr_evt))
        ev["inv_gen_sr"].append(float(np.float32(1.0)
                                      / np.float32(gen_sr_evt)))
        ev["amp"].append(amp)
        ev["offset"].append(offset)
        ev["start"].append(start)
        ev["cutoff_gen"].append(float(cutoff_out) * ufac)
        ev["stretch"].append(float(stretch))

        _event_aux_draws(p, mode, i, n, gen_sr_evt, have_ir, ir_mono,
                         img_gray, aux)

    E = len(ev["seed"])
    prog = {
        "out_n": out_n,
        "E": E,
        "gen_sr_base": int(np.clip(int(round(base_sr * base_unfold)),
                                   base_sr, MAX_GEN_SR)),
    }
    if E == 0:
        return prog

    L = _next_pow2(max(ev["n"]))
    prog["L"] = L
    for k in ("seed", "n", "offset", "start"):
        prog[k] = np.asarray(ev[k], np.int32)
    for k in ("gen_sr", "inv_gen_sr", "amp", "cutoff_gen", "stretch"):
        prog[k] = np.asarray(ev[k], np.float32)
    _finalize_aux(p, mode, prog, aux, L)
    return prog


def _event_aux_draws(p, mode, i, n, gen_sr_evt, have_ir, ir_mono, img_gray,
                     aux):
    """Per-event auxiliary draws (rng(seed+i) streams, main_v2.py:219-402);
    shared by the scalar twin and the vectorized builder."""
    if mode in _AUX_MODES:
        erng = np.random.default_rng(int(p.seed) + i)
        if mode == "Dust impulses":
            k = int(max(1, round(float(p.dust_density) * n)))
            idx = erng.integers(0, n, size=k)
            amps = erng.uniform(-1, 1, size=k)
            # assignment semantics: later writes win (main_v2.py:241-242)
            _, keep = np.unique(idx[::-1], return_index=True)
            keep = (len(idx) - 1) - keep
            aux["dust_pos"].append(idx[keep])
            aux["dust_amp"].append(amps[keep])
            aux["dust_k"].append(len(keep))
            aux["dust_klen"].append(max(8, int(0.01 * n)))
        elif mode == "Crackle / corona":
            steps = erng.pareto(float(p.crackle_alpha),
                                int(max(8, float(p.crackle_density))))
            tt = np.cumsum(steps)
            tt = tt[tt < n].astype(np.int64)
            amps = np.asarray([erng.uniform(-1, 1) for _ in range(len(tt))],
                              np.float64)
            aux["ck_pos"].append(tt)
            aux["ck_amp"].append(amps)
        elif mode == "Wavelet atoms":
            f0s, sigs, phs, shs = [], [], [], []
            for k in range(int(max(1, p.wav_count))):
                f0s.append(float(p.wav_base_hz)
                           * 2.0 ** erng.uniform(-p.wav_spread, p.wav_spread))
                sigs.append(max(0.03, float(p.micro_ms)
                                * erng.uniform(0.04, 0.18)) / 1000.0)
                phs.append(erng.uniform(0, 2 * np.pi) / (2 * np.pi))
                shs.append(int(erng.integers(-(n // 8), n // 8)))
            aux["wl_f0"].append(f0s)
            aux["wl_sigma"].append(sigs)
            aux["wl_phase"].append(phs)
            aux["wl_shift"].append(shs)
        elif mode == "IR fragment":
            if have_ir:
                st = int(erng.integers(0, max(1, ir_mono.size - 256)))
                sl = ir_mono[st:st + 256]
                aux["frag"].append(sl.astype(np.float32))
                aux["frag_len"].append(len(sl))
            else:
                aux["frag"].append(np.zeros(2, np.float32))
                aux["frag_len"].append(2)
        elif mode == "Image scanline":
            if img_gray is not None:
                h, w = img_gray.shape
                y = int(erng.integers(0, h))
                line = img_gray[y, :].astype(np.float64) / 255.0
                line = (line - line.mean()) * 2.0
                aux["frag"].append(line.astype(np.float32))
                aux["frag_len"].append(w)
            else:
                aux["frag"].append(np.zeros(2, np.float32))
                aux["frag_len"].append(2)

    if p.res_bank_on:
        rrng = np.random.default_rng(int(p.seed) + i + 321)
        modes = int(max(1, p.res_modes))
        fs, ps = [], []
        for k in range(modes):
            f = float(p.res_fmin) * ((float(p.res_fmax)
                                      / max(1.0, float(p.res_fmin)))
                                     ** (k / max(1, modes - 1)))
            f *= 2.0 ** rrng.uniform(-0.02, 0.02)
            ps.append(rrng.uniform(0, 2 * np.pi) / (2 * np.pi))
            fs.append(f)
        aux["res_f"].append(fs)
        aux["res_ph"].append(ps)
    if p.wg_on:
        wrng = np.random.default_rng(int(p.seed) + i + 777)
        ds, gs, ms = [], [], []
        for _ in range(int(max(1, p.wg_lines))):
            ds.append(int(max(1, round(wrng.uniform(0.4, float(p.wg_max_ms))
                                       / 1000.0 * gen_sr_evt))))
            gs.append(float(p.wg_fb) * wrng.uniform(0.6, 0.98))
            ms.append(wrng.uniform(0.15, 0.45))
        aux["wg_d"].append(ds)
        aux["wg_g"].append(gs)
        aux["wg_m"].append(ms)


def _finalize_aux(p, mode, prog, aux, L):
    """Stack the per-event aux rows into padded program arrays; shared by
    the scalar twin and the vectorized builder."""
    def pad2d(rows, dtype, fill=0):
        m = max((len(r) for r in rows), default=1)
        m = max(m, 1)
        out = np.full((len(rows), m), fill, dtype)
        for j, r in enumerate(rows):
            out[j, :len(r)] = r
        return out

    if mode == "Dust impulses":
        prog["dust_pos"] = pad2d(aux["dust_pos"], np.int32, fill=L)
        prog["dust_amp"] = pad2d(aux["dust_amp"], np.float32)
        prog["dust_k"] = np.asarray(aux["dust_k"], np.int32)
        prog["dust_klen"] = np.asarray(aux["dust_klen"], np.int32)
        prog["dust_kmax"] = int(max(aux["dust_klen"]))
    elif mode == "Crackle / corona":
        prog["ck_pos"] = pad2d(aux["ck_pos"], np.int32, fill=L)
        prog["ck_amp"] = pad2d(aux["ck_amp"], np.float32)
        prog["ck_klen"] = int(max(8, int(p.crackle_kernel)))
    elif mode == "Wavelet atoms":
        prog["wl_f0"] = pad2d(aux["wl_f0"], np.float32)
        prog["wl_sigma"] = pad2d(aux["wl_sigma"], np.float32)
        prog["wl_phase"] = pad2d(aux["wl_phase"], np.float32)
        prog["wl_shift"] = pad2d(aux["wl_shift"], np.int32)
    elif mode in ("IR fragment", "Image scanline"):
        prog["frag"] = pad2d(aux["frag"], np.float32)
        prog["frag_len"] = np.asarray(aux["frag_len"], np.int32)
    if p.res_bank_on:
        prog["res_f"] = pad2d(aux["res_f"], np.float32)
        prog["res_ph"] = pad2d(aux["res_ph"], np.float32)
    if p.wg_on:
        prog["wg_d"] = pad2d(aux["wg_d"], np.int32, fill=1)
        prog["wg_g"] = pad2d(aux["wg_g"], np.float32)
        prog["wg_m"] = pad2d(aux["wg_m"], np.float32)
        prog["wg_dmax"] = int(prog["wg_d"].max())
    return prog


_AUX_MODES = ("Dust impulses", "Crackle / corona", "Wavelet atoms",
              "IR fragment", "Image scanline")

_EVENT_N_FLOORS = {"Stick–slip friction": 64, "Micro-chaos": 64,
                   "Wavelet atoms": 128, "Image scanline": 64}


def build_program(params: MicrosoundParams, ir_audio=None, img_gray=None):
    """Vectorized event-program builder — the production path.

    Identical output to build_program_seq (asserted array-for-array by
    tests/test_microsound.py): the per-event breakpoint evals, clips,
    roundings and dtype conversions are NumPy-vectorized with the same IEEE
    op order, while the reference's sequential rng(seed+123456) stream is
    consumed in a minimal scalar loop (one uniform per event, one bounded
    integers draw per kept event — draw ORDER is part of the reference
    contract, main_v2.py:618-755, so those can't batch when interleaved).
    When grain offsets are off the whole amp stream batches into one
    rng.uniform(size=E) call (numpy Generator draws doubles in sequence, so
    the batched call consumes the stream identically).  The scalar loop was
    ~125 us/event of pure Python — 29 ms per bench render, 720 ms at the
    4000-event reference ceiling."""
    p = params
    base_sr = int(p.base_sr)
    out_n = int(max(1, round(float(p.out_dur_s) * base_sr)))
    base_unfold = max(1.0, float(p.time_unfold))

    bp_density = parse_breakpoints(p.bp_density)
    bp_unfold = parse_breakpoints(p.bp_unfold)
    bp_cutoff = parse_breakpoints(p.bp_cutoff)
    bp_stretch = parse_breakpoints(p.bp_stretch)

    rate = float(p.grains_per_sec)
    times = generate_event_times(
        p.event_process, float(p.out_dur_s), rate, seed=int(p.seed),
        cluster_size=int(p.cluster_size),
        cluster_spread_ms=float(p.cluster_spread_ms),
        hawkes_gain=float(p.hawkes_gain),
        hawkes_decay_s=float(p.hawkes_decay_s))
    times = np.asarray(times, np.float64)[: int(p.max_grains)]
    T = times.size

    rng = np.random.default_rng(int(p.seed) + 123456)
    mode = p.gen_mode
    have_ir = ir_audio is not None and np.asarray(ir_audio).size >= 32

    ir_mono = None
    if ir_audio is not None:
        ir_mono = np.asarray(ir_audio, np.float64)
        if ir_mono.ndim > 1:
            ir_mono = ir_mono.mean(axis=1)

    # vectorized per-event lanes (same IEEE arithmetic as the scalar twin)
    dens = eval_breakpoints_vec(bp_density, times, default=rate)
    ufac = np.maximum(1.0, eval_breakpoints_vec(bp_unfold, times,
                                                default=base_unfold))
    cutoff_out = eval_breakpoints_vec(bp_cutoff, times,
                                      default=float(p.bandlimit_out_hz))
    stretch = eval_breakpoints_vec(bp_stretch, times,
                                   default=float(p.partial_stretch))
    gen_sr_evt = np.clip(np.rint(base_sr * ufac).astype(np.int64),
                         base_sr, MAX_GEN_SR)
    floor_n = 64 if (mode == "IR fragment" and have_ir) else \
        _EVENT_N_FLOORS.get(mode, 16)
    n_ev = np.maximum(floor_n,
                      np.rint(gen_sr_evt * float(p.micro_ms) / 1000.0)
                      .astype(np.int64))
    start = np.rint(times * base_sr).astype(np.int64)
    keep = start < out_n
    amp_base = np.ones(T, np.float64)
    if rate > 0:
        amp_base = np.clip(dens / max(1e-6, rate), 0.15, 4.0)

    # the reference's sequential draw order: one amp uniform per event,
    # then (kept events only) one bounded integers draw
    max_off = 0
    if p.grain_offset_on:
        max_off = int(round(float(p.grain_offset_max_ms) / 1000.0 * base_sr))
    lo_a = 1.0 - float(p.grain_amp_rand)
    hi_a = 1.0 + float(p.grain_amp_rand)
    amp_u = np.empty(T, np.float64)
    offs = np.zeros(T, np.int64)
    if max_off > 0:
        bound = np.maximum(1, np.minimum(max_off, n_ev))
        for i in range(T):
            amp_u[i] = rng.uniform(lo_a, hi_a)
            if keep[i]:
                offs[i] = rng.integers(0, bound[i])
    elif T:
        amp_u[:] = rng.uniform(lo_a, hi_a, size=T)

    kept = np.flatnonzero(keep)
    E = int(kept.size)
    prog = {
        "out_n": out_n,
        "E": E,
        "gen_sr_base": int(np.clip(int(round(base_sr * base_unfold)),
                                   base_sr, MAX_GEN_SR)),
    }
    if E == 0:
        return prog

    n_k = n_ev[kept]
    L = _next_pow2(int(n_k.max()))
    prog["L"] = L
    prog["seed"] = (int(p.seed) + kept).astype(np.int32)
    prog["n"] = n_k.astype(np.int32)
    prog["offset"] = offs[kept].astype(np.int32)
    prog["start"] = start[kept].astype(np.int32)
    gsr_k = gen_sr_evt[kept]
    prog["gen_sr"] = gsr_k.astype(np.float32)
    prog["inv_gen_sr"] = np.float32(1.0) / gsr_k.astype(np.float32)
    prog["amp"] = (amp_base * amp_u)[kept].astype(np.float32)
    prog["cutoff_gen"] = (cutoff_out * ufac)[kept].astype(np.float32)
    prog["stretch"] = stretch[kept].astype(np.float32)

    if mode in _AUX_MODES or p.res_bank_on or p.wg_on:
        aux = {k: [] for k in ("dust_pos", "dust_amp", "dust_k", "dust_klen",
                               "ck_pos", "ck_amp", "wl_f0", "wl_sigma",
                               "wl_phase", "wl_shift", "frag", "frag_len",
                               "res_f", "res_ph", "wg_d", "wg_g", "wg_m")}
        for i in kept:
            _event_aux_draws(p, mode, int(i), int(n_ev[i]),
                             int(gen_sr_evt[i]), have_ir, ir_mono, img_gray,
                             aux)
        _finalize_aux(p, mode, prog, aux, L)
    return prog


# ---------------------------------------------------------------------------
# Device chain configuration (static compile key)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChainCfg:
    mode_id: int
    L: int
    out_n: int
    ec: int                      # events per chunk
    oa: str                      # overlap-add path: "tiled" | "dus"
    shared_stretch: bool         # all events share one stretch factor AND
    #                              the chain is generate->fused lp+stretch
    micro_ms: float
    noise_tilt: float
    ring_hz: float
    ring_decay_ms: float
    ss: tuple                    # (threshold, build, decay, noise)
    chaos: tuple                 # (r, gate)
    wav_count: int
    dust_kmax: int
    ck_klen: int
    bandlimit_on: bool
    bandlimit_roll: float
    nl_warp_on: bool
    nl_warp_power: float
    cep_warp_on: bool
    cep_factor: float
    partial_lock_on: bool
    pl_top_n: int
    pl_neigh: int
    res_on: bool
    res_modes: int
    res_decay_ms: float
    wg_on: bool
    wg_lines: int
    wg_dmax: int
    multiband: tuple             # () or ((b,u) pairs..., roll)
    fb_on: bool
    fb_amt: float
    imprint_on: bool
    imprint_amt: float
    imprint_smooth: float
    stretch_scale: float = 4.0   # static bound on 1/stretch for the shared
    #                              kernel's selection window; sized by ceil
    #                              into a handful of distinct H buckets, so
    #                              a x4 upward stretch stops paying the
    #                              x0.25 downward stretch's 6x window
    shared_gain: bool = False    # all events share (gen_sr, cutoff): the
    #                              lowpass curve is computed once, not per
    #                              event (identical per-element arithmetic)
    oa_win: int = 0              # overlap-add window length (1024-bucketed
    #                              cover of max true grain length n): the
    #                              pow2 FFT pad makes the window tail exact
    #                              zeros — the OA skips adding them (0 =
    #                              full L)
    n_fft: int = 0               # exact grain FFT length: when every event
    #                              in the program shares one true length n,
    #                              the spectral chain runs at EXACTLY n
    #                              (ops/exact_dft.py) — the reference's
    #                              exact-n rfft semantics (main_v2.py:
    #                              39-163) at any micro_ms.  0 = events
    #                              have mixed lengths: padded-L convention
    #                              (documented fallback)


def chain_cfg(params: MicrosoundParams, prog: dict, ec: int,
              oa: str | None = None) -> ChainCfg:
    """Static chain config for chunks of ec events; `oa` defaults to the
    device's overlap-add path (pallas_oa.oa_path)."""
    if int(prog.get("E", 0)) <= 0:
        # E==0 programs carry no event tables (build_program returns early);
        # the grain chain is undefined for them — render() skips it entirely
        raise ValueError("chain_cfg requires a non-empty event program "
                         "(prog['E'] == 0: nothing to chain)")
    p = params
    mb = ()
    if p.unfold_mode != "Classic reinterpret":
        bands = ((0.0, float(p.mb_b1)), (float(p.mb_b1), float(p.mb_b2)),
                 (float(p.mb_b2), float(p.mb_b3)))
        unfolds = (float(p.mb_u1), float(p.mb_u2), float(p.mb_u3))
        mb = (bands, unfolds, float(p.mb_roll))
    fuse = (bool(p.bandlimit_on) and not p.nl_warp_on and not p.cep_warp_on
            and not p.partial_lock_on)
    shared = (fuse and not p.res_bank_on and not p.wg_on and not mb
              and "stretch" in prog and len(prog["stretch"]) > 0
              and bool(np.all(prog["stretch"] == prog["stretch"][0])))
    stretch_scale = 4.0
    if shared:
        stretch_scale = float(
            max(0.25, 1.0 / max(1e-6, float(prog["stretch"][0]))))
    shared_gain = bool(
        shared and "gen_sr" in prog and "cutoff_gen" in prog
        and np.all(prog["gen_sr"] == prog["gen_sr"][0])
        and np.all(prog["cutoff_gen"] == prog["cutoff_gen"][0]))
    n_fft = 0
    if "n" in prog and len(prog["n"]) > 0 and \
            bool(np.all(prog["n"] == prog["n"][0])):
        n_fft = int(prog["n"][0])
    return ChainCfg(
        n_fft=n_fft,
        stretch_scale=stretch_scale,
        shared_gain=shared_gain,
        oa_win=_oa_window_len(prog),
        mode_id=GEN_MODES.index(p.gen_mode),
        L=int(prog["L"]), out_n=int(prog["out_n"]), ec=int(ec),
        oa=oa or pallas_oa.oa_path(),
        shared_stretch=shared,
        micro_ms=float(p.micro_ms), noise_tilt=float(p.noise_tilt),
        ring_hz=float(p.ring_hz), ring_decay_ms=float(p.ring_decay_ms),
        ss=(float(p.ss_threshold), float(p.ss_build), float(p.ss_decay),
            float(p.ss_noise)),
        chaos=(float(p.chaos_r), float(p.chaos_gate)),
        wav_count=int(max(1, p.wav_count)),
        dust_kmax=int(prog.get("dust_kmax", 8)),
        ck_klen=int(prog.get("ck_klen", 8)),
        bandlimit_on=bool(p.bandlimit_on),
        bandlimit_roll=float(p.bandlimit_roll_hz),
        nl_warp_on=bool(p.nl_warp_on), nl_warp_power=float(p.nl_warp_power),
        cep_warp_on=bool(p.cep_warp_on), cep_factor=float(p.cep_factor),
        partial_lock_on=bool(p.partial_lock_on),
        pl_top_n=int(p.pl_top_n), pl_neigh=int(p.pl_neigh),
        res_on=bool(p.res_bank_on), res_modes=int(max(1, p.res_modes)),
        res_decay_ms=float(p.res_decay_ms),
        wg_on=bool(p.wg_on), wg_lines=int(max(1, p.wg_lines)),
        wg_dmax=int(prog.get("wg_dmax", 1)),
        multiband=mb,
        fb_on=bool(p.event_feedback_on), fb_amt=float(p.event_feedback_amt),
        imprint_on=bool(p.spectral_imprint_on),
        imprint_amt=float(p.spectral_imprint_amt),
        imprint_smooth=float(p.spectral_imprint_smooth),
    )


# ---------------------------------------------------------------------------
# Device kernels
# ---------------------------------------------------------------------------

def _generate(ev: dict, cfg: ChainCfg):
    """The selected micro-generator for one event (main_v2.py:651-686);
    `cfg.mode_id` is static so only one branch is traced."""
    i = jnp.arange(cfg.L, dtype=jnp.int32)
    n = ev["n"]
    m = cfg.mode_id
    nfft = cfg.n_fft or None
    if m <= 4:
        return generators.gen_basic(
            i, n, ev["seed"], ev["gen_sr"], ev["inv_gen_sr"], cfg.micro_ms, m,
            ev.get("dust_pos", jnp.zeros(1, jnp.int32)),
            ev.get("dust_amp", jnp.zeros(1, jnp.float32)),
            ev.get("dust_k", jnp.int32(0)),
            ev.get("dust_klen", jnp.int32(8)),
            cfg.noise_tilt, cfg.ring_hz, cfg.ring_decay_ms,
            dust_kmax=cfg.dust_kmax, n_fft=nfft)
    if m == 5:    # Crackle / corona
        kern = generators.exp_kernel(cfg.ck_klen, 6.0)
        return generators.gen_crackle(i, n, ev["ck_pos"], ev["ck_amp"],
                                      jnp.asarray(kern), cfg.ck_klen)
    if m == 6:    # Stick–slip friction
        thr, build, decay, nz = cfg.ss
        return generators.gen_stick_slip(i, n, ev["seed"], jnp.float32(thr),
                                         jnp.float32(build),
                                         jnp.float32(decay), jnp.float32(nz))
    if m == 7:    # Micro-chaos
        r, gate = cfg.chaos
        kern = jnp.asarray(generators.exp_kernel(48, 5.0))
        return generators.gen_micro_chaos(i, n, ev["seed"], jnp.float32(r),
                                          jnp.float32(gate), kern)
    if m == 8:    # Wavelet atoms
        return generators.gen_wavelet_atoms(
            i, n, ev["inv_gen_sr"], ev["wl_f0"], ev["wl_sigma"],
            ev["wl_phase"], ev["wl_shift"], cfg.wav_count)
    if m == 9:    # IR fragment: interp -> hann -> normalize 0.9 (:333-348)
        x = generators.gen_from_fragment(i, n, ev["frag"], ev["frag_len"])
        x = x * generators.hann_t(i, n)
        return space.normalize_masked(x, i < n, 0.9)
    # Image scanline: interp -> hann -> exp smear (:350-362)
    x = generators.gen_from_fragment(i, n, ev["frag"], ev["frag_len"])
    x = x * generators.hann_t(i, n)
    kern = jnp.asarray(generators.exp_kernel(48, 5.0))
    x = generators.masked_conv_same(x, kern, 48)
    return jnp.where(i < n, x, 0.0)


def _one_grain(ev: dict, cfg: ChainCfg):
    """Full per-event chain (main_v2.py:651-727), static switches traced
    once; returns the grain at padded length, zero beyond its true n."""
    i = jnp.arange(cfg.L, dtype=jnp.int32)
    n = ev["n"]
    gsr = ev["gen_sr"]
    nfft = cfg.n_fft or None
    x = _generate(ev, cfg)

    fuse = (cfg.bandlimit_on and not cfg.nl_warp_on and not cfg.cep_warp_on
            and not cfg.partial_lock_on)
    if fuse:
        # lowpass + stretch share the rfft domain: one spectral pass
        x = spectral.lowpass_stretch_fused(x, gsr, ev["cutoff_gen"],
                                           ev["stretch"],
                                           roll=cfg.bandlimit_roll,
                                           n_fft=nfft)
    elif nfft is not None:
        # exact-length semantics: the WHOLE warp chain in one spectral
        # pass at the true grain length — filter-zeroed bins stay exactly
        # zero into the cepstral stage (spectral.grain_chain_exact)
        x = spectral.grain_chain_exact(
            x, gsr, nfft,
            cutoff=ev["cutoff_gen"] if cfg.bandlimit_on else None,
            roll=cfg.bandlimit_roll,
            warp_power=cfg.nl_warp_power if cfg.nl_warp_on else None,
            cep_factor=cfg.cep_factor if cfg.cep_warp_on else None,
            lock=((cfg.pl_top_n, cfg.pl_neigh)
                  if cfg.partial_lock_on else None),
            stretch=ev["stretch"])
    else:
        if cfg.bandlimit_on:
            x = spectral.lowpass_fft(x, gsr, ev["cutoff_gen"],
                                     roll=cfg.bandlimit_roll)
        if cfg.nl_warp_on:
            x = spectral.fft_warp_power(x, cfg.nl_warp_power)
        if cfg.cep_warp_on:
            x = spectral.cepstral_warp(x, cfg.cep_factor)

        if cfg.partial_lock_on:
            x = spectral.partial_lock_stretch(x, ev["stretch"],
                                              top_n=cfg.pl_top_n,
                                              neighborhood=cfg.pl_neigh)
        else:
            x = spectral.fft_partial_stretch(x, ev["stretch"])

    if cfg.res_on:
        y = generators.resonator_bank(x, i, n, ev["inv_gen_sr"], ev["res_f"],
                                      ev["res_ph"], cfg.res_decay_ms,
                                      cfg.res_modes)
        x = jnp.where(n >= 32, y, x)   # reference skips short grains (:372)

    if cfg.wg_on:
        y = generators.waveguide_splinters(x, n, ev["wg_d"], ev["wg_g"],
                                           ev["wg_m"], cfg.wg_lines,
                                           cfg.wg_dmax)
        x = jnp.where(n >= 64, y, x)   # reference skips short grains (:389)

    if cfg.multiband:
        bands, unfolds, roll = cfg.multiband
        x = spectral.multiband_unfold(x, gsr, bands, unfolds, roll_hz=roll,
                                      n_fft=nfft)
        # unfold_reinterpret itself is the identity on samples (:489-490)

    return jnp.where(i < n, x, 0.0)


def _fb_imprint_scan(grains, ns, carry, cfg: ChainCfg):
    """Sequential event-to-event feedback crossfade (main_v2.py:731-734) and
    SpectralImprint EMA (main_v2.py:565-581, 736-740) as lax.scan.

    With cfg.n_fft the imprint transform runs at the exact grain length
    (the reference's np.fft.rfft(x) at n = len(x)); the EMA memory lives
    on that length's bin grid.  (The reference RESETS the memory whenever
    the grain length changes, main_v2.py:574 — with uniform n that branch
    never fires after the first event.)"""
    j = jnp.arange(cfg.L, dtype=jnp.int32)
    from ..ops import exact_dft
    nfft = cfg.n_fft if cfg.n_fft else cfg.L
    nf = nfft // 2 + 1

    def step(c, inp):
        prev, prev_n, prev_valid, mem, mem_valid = c
        g, n = inp
        if cfg.fb_on:
            fb = jnp.float32(cfg.fb_amt)
            lim = jnp.minimum(n, prev_n)
            blend = (1.0 - fb) * g + fb * prev
            g = jnp.where(prev_valid & (j < lim), blend, g)
        if cfg.imprint_on and cfg.imprint_amt > 0:
            X = exact_dft.rfft_n(g, nfft)
            mag = jnp.abs(X)
            mem_new = jnp.where(mem_valid,
                                cfg.imprint_smooth * mem
                                + (1.0 - cfg.imprint_smooth) * mag, mag)
            mag2 = ((1.0 - cfg.imprint_amt) * mag
                    + cfg.imprint_amt * mem_new)
            ph = jnp.where(mag > 0, X / (mag + 1e-30), 1.0 + 0j)
            g2 = exact_dft.irfft_n(mag2 * ph, nfft, out_len=cfg.L)
            g2 = jnp.where(j < n, g2, 0.0)
            use = n >= 64                       # imprint gate (:572)
            g = jnp.where(use, g2, g)
            mem = jnp.where(use, mem_new, mem)
            mem_valid = mem_valid | use
        return (g, n, jnp.bool_(True), mem, mem_valid), g

    if carry is None:
        carry = (jnp.zeros(cfg.L, jnp.float32), jnp.int32(0),
                 jnp.bool_(False), jnp.zeros(nf, jnp.float32),
                 jnp.bool_(False))
    carry, out = jax.lax.scan(step, carry, (grains, ns))
    return carry, out


def chunk_body(cfg: ChainCfg):
    """Un-jitted renderer for one chunk of events: vmapped grain chain ->
    (optional) feedback scan -> overlap-add into the margin-layout output
    buffer (left margin L absorbs negative start-offset windows, right
    slack the overhanging tails; real audio lives at out[L : L+out_n]).
    (jit-wrapped by _chunk_fn; exposed for the compile-check entry point.)

    Overlap-add path per cfg.oa (ops/pallas_oa.py): "tiled" = the Pallas
    kernel over output tiles (GPU), "dus" = sequential
    dynamic-update-slice windows (CPU).  Both accumulate in event order,
    bit-identical to each other and to the sequential NumPy oracle's
    accumulation order."""

    def run(evs, carry, out):
        # oa_* entries are chunk-level control arrays, not per-event fields
        per_ev = {k: v for k, v in evs.items() if not k.startswith("oa_")}
        if cfg.shared_stretch:
            # generate->fused lowpass+stretch with ONE shared stretch
            # factor: hoist the spectral pass out of the vmap so the lerp
            # one-hots are built once per block instead of once per event
            raw = jax.vmap(lambda e: _generate(e, cfg))(per_ev)
            x = spectral.lowpass_stretch_fused_shared(
                raw, per_ev["gen_sr"], per_ev["cutoff_gen"],
                per_ev["stretch"][0], roll=cfg.bandlimit_roll,
                max_scale=cfg.stretch_scale, shared_gain=cfg.shared_gain,
                n_fft=cfg.n_fft or None)
            j2 = jnp.arange(cfg.L, dtype=jnp.int32)[None, :]
            grains = jnp.where(j2 < per_ev["n"][:, None], x, 0.0)
        else:
            grains = jax.vmap(lambda e: _one_grain(e, cfg))(per_ev)
        if cfg.fb_on or cfg.imprint_on:
            carry, grains = _fb_imprint_scan(grains, evs["n"], carry, cfg)
        # out[L + start + i] += amp * grain[offset + i]: window e lands at
        # oa_start = L + start - offset, grain values outside [offset, n)
        # are zeroed — an index shift instead of a per-sample offset gather
        j = jnp.arange(cfg.L, dtype=jnp.int32)
        valid = ((j[None, :] >= evs["offset"][:, None])
                 & (j[None, :] < evs["n"][:, None]))
        val = evs["amp"][:, None] * jnp.where(valid, grains, 0.0)
        if 0 < cfg.oa_win < cfg.L:
            # the pow2 FFT pad leaves [max n, L) exactly zero in every
            # window — adding zeros is the identity (out starts +0.0 and
            # +0 + -0 == +0), so the OA only walks the bucketed cover
            val = val[:, :cfg.oa_win]
        plan = None
        if cfg.oa == "tiled":
            plan = pallas_oa.TilePlan(evs["oa_ptr"], evs["oa_ev"],
                                      evs["oa_off"])
        out = pallas_oa.overlap_add(out, val, evs["oa_start"], plan=plan,
                                    path=cfg.oa)
        return carry, grains[-1], out

    return run


@functools.lru_cache(maxsize=32)
def _chunk_fn(cfg: ChainCfg):
    return jax.jit(chunk_body(cfg), donate_argnums=(2,))


_EV_CHUNK_KEYS = ("seed", "n", "gen_sr", "inv_gen_sr", "amp", "offset",
                  "start",
                  "cutoff_gen", "stretch", "dust_pos", "dust_amp", "dust_k",
                  "dust_klen", "ck_pos", "ck_amp", "wl_f0", "wl_sigma",
                  "wl_phase", "wl_shift", "frag", "frag_len", "res_f",
                  "res_ph", "wg_d", "wg_g", "wg_m")


def _oa_window_len(prog: dict) -> int:
    """Static OA window length: the 1024-sample-bucketed cover of the
    chunk's largest true grain length.  Grain buffers are padded to the
    pow2 FFT length L, but every sample at or beyond n is exactly zero —
    the overlap-add can skip them (bit-exact: adding +0.0 never changes
    the accumulator).  Bucketing keeps the compiled kernel stable under
    small n changes."""
    L = int(prog["L"])
    if "n" not in prog:
        return L
    n_max = int(np.max(prog["n"]))
    return min(L, max(1024, -(-n_max // 1024) * 1024))


def _chunk_events(prog: dict, cfg: ChainCfg) -> list:
    """Split the per-event arrays into padded chunks of cfg.ec events.
    Dummy padding events render nothing (amp 0, start beyond the buffer)
    and only ever appear in the final chunk, after all real events.

    Each chunk also carries its overlap-add control arrays for the
    margin-layout buffer: oa_start (= L + start - offset, always >= 0
    since offset < L) and, on the tiled path, the host tile plan
    (oa_ptr, oa_ev, oa_off; ops/pallas_oa.plan_tiles)."""
    E = prog["E"]
    ec = cfg.ec
    L = int(prog["L"])
    Lw = _oa_window_len(prog)    # the OA walks the trimmed window cover
    oa_len = pallas_oa.buffer_len(int(prog["out_n"]), L)
    chunks = []
    for s in range(0, E, ec):
        e = min(E, s + ec)
        c = {}
        for k in _EV_CHUNK_KEYS:
            if k not in prog:
                continue
            a = prog[k][s:e]
            if e - s < ec:
                pad = [(0, ec - (e - s))] + [(0, 0)] * (a.ndim - 1)
                fill = prog["out_n"] if k == "start" else (
                    16 if k == "n" else 0)
                a = np.pad(a, pad, constant_values=fill)
                if k == "gen_sr":
                    a[e - s:] = 48000.0
            # stay NumPy: args to a jitted call are transferred bundled
            # with the call instead of one device_put per array
            c[k] = a
        c["oa_start"] = (L + c["start"].astype(np.int64)
                         - c["offset"].astype(np.int64)).astype(np.int32)
        if cfg.oa == "tiled":
            c["oa_ptr"], c["oa_ev"], c["oa_off"] = pallas_oa.plan_tiles(
                c["oa_start"], Lw, oa_len)
        chunks.append(c)
    return chunks


# ---------------------------------------------------------------------------
# Global FX + render entry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FxCfg:
    out_n: int
    sr: int
    env: tuple            # (a, d, s, r, curve)
    er_on: bool
    ir_on: bool
    stereo_on: bool
    stereo_width: float
    sat_drive: float
    peak: float
    pcm16: bool = False   # return int16 PCM (wavcodec convention): the
    #                       natural WAV-bound output at half the d2h bytes


def fx_body(cfg: FxCfg):
    """Global FX chain.  When both the ER cloud and the IR are on, the two
    causal convolutions run as ONE partitioned conv with the combined
    kernel conv(er, ir) — convolution associativity; differs from the
    sequential pair only by FFT rounding (~-140 dBFS)."""
    def run(out, er_kernel, ir_kernel):
        a, d, s, r, curve = cfg.env
        env = envelopes.make_adsr(cfg.out_n, cfg.sr, a, d, s, r, curve)
        out = out * env
        if cfg.er_on:
            # er_kernel is already conv(er, ir) when the IR is also on
            out = space.fft_convolve_causal(out, er_kernel)
        elif cfg.ir_on:
            out = space.fft_convolve_causal(out, ir_kernel)
        if cfg.stereo_on:
            st = space.spectral_diffusion_stereo(out, cfg.sr,
                                                 width=cfg.stereo_width)
        else:
            st = jnp.stack([out, out], axis=-1)
        st = space.soft_clip(st, drive=cfg.sat_drive)
        st = space.normalize(st, peak=cfg.peak)
        if cfg.pcm16:
            q = jnp.clip(jnp.round(st * 32768.0), -32768.0, 32767.0)
            return q.astype(jnp.int16)
        return st

    return run


@functools.lru_cache(maxsize=32)
def _fx_fn(cfg: FxCfg):
    return jax.jit(fx_body(cfg))


@functools.lru_cache(maxsize=32)
def _fused_fn(cfg: ChainCfg, fx: FxCfg):
    """Single-chunk fast path: grain chunk + global FX as ONE jit dispatch.
    The OA buffer is created on device instead of shipping host zeros."""
    chunk = chunk_body(cfg)
    fxr = fx_body(fx)
    oa_len = pallas_oa.buffer_len(cfg.out_n, cfg.L)

    def run(evs, carry, er_kernel, ir_kernel):
        out = jnp.zeros(oa_len, jnp.float32)
        carry, grain_last, out = chunk(evs, carry, out)
        audio = out[cfg.L: cfg.L + fx.out_n]     # margin layout
        return carry, grain_last, fxr(audio, er_kernel, ir_kernel)

    return jax.jit(run)


def _micro_last(prog: dict, cfg: ChainCfg):
    """Raw generator output of the LAST event (the reference's micro_last
    microscope buffer, main_v2.py:688,788), truncated to its true length."""
    last = {k: jnp.asarray(prog[k][-1]) for k in _EV_CHUNK_KEYS
            if k in prog and k not in ("dust_kmax", "ck_klen", "wg_dmax")
            and not np.isscalar(prog[k])}
    x = jax.jit(lambda e: _generate(e, cfg))(last)
    return np.asarray(x)[: int(prog["n"][-1])]


_SPACE_KERNEL_CACHE: dict = {}


def _space_kernels(p: MicrosoundParams, ir_audio):
    """ER tap kernel, IR kernel, and (by conv associativity) their combined
    form — memoized on the ER params + IR content digest.  The host f64
    np.convolve of er*ir (~8k x 8k taps) cost ~40 ms PER RENDER on a
    single core; params-tweak loops re-render with the same space setup."""
    import hashlib

    ir_on = bool(p.space_ir_on) and ir_audio is not None
    irm = None
    if ir_on:
        irm = np.asarray(ir_audio, np.float64)
        if irm.ndim > 1:
            irm = irm.mean(axis=1)
        irm = irm[: int(p.space_ir_max_samps)]
        irm = irm[: min(irm.size, 8192)]       # convolve_ir_short cap (:441)
        ir_on = irm.size >= 8

    key = (bool(p.er_cloud_on), int(p.er_taps), float(p.er_max_ms),
           int(p.base_sr), int(p.seed),
           hashlib.blake2b(irm.tobytes(), digest_size=16).digest()
           if ir_on else None)
    hit = _SPACE_KERNEL_CACHE.get(key)
    if hit is not None:
        return hit

    er_kernel = np.zeros(2, np.float32)
    if p.er_cloud_on:
        er_kernel = space.er_tap_kernel(int(p.er_taps), float(p.er_max_ms),
                                        int(p.base_sr), int(p.seed))
    ir_kernel = irm.astype(np.float32) if ir_on else np.zeros(2, np.float32)
    if p.er_cloud_on and ir_on:
        # conv associativity: one partitioned conv with the combined kernel
        er_kernel = np.convolve(er_kernel.astype(np.float64),
                                irm).astype(np.float32)
    if len(_SPACE_KERNEL_CACHE) >= 8:
        _SPACE_KERNEL_CACHE.pop(next(iter(_SPACE_KERNEL_CACHE)))
    _SPACE_KERNEL_CACHE[key] = (er_kernel, ir_kernel, ir_on)
    return er_kernel, ir_kernel, ir_on


def render(params: MicrosoundParams, ir_audio=None, img_gray=None,
           event_chunk: int | None = None, progress=None,
           want_micro_last: bool = False, pcm16: bool = False,
           device_out: bool = False):
    """Full Microsound render (main_v2.py:588-792): returns (stereo
    [out_n, 2], meta dict) — f32, or int16 PCM with pcm16=True (device-side
    conversion halves the device->host transfer; the reference app writes
    PCM_16 WAVs anyway, main_v2.py:1519).  meta carries grain_last (the
    last event's post-chain grain) and, with want_micro_last, micro_last
    (the raw generator output) — the reference's microscope-view data
    (main_v2.py:786-791), and "oa", the overlap-add path taken ("tiled",
    "dus", or "none" without events)."""
    p = params
    prog = build_program(p, ir_audio=ir_audio, img_gray=img_gray)
    out_n = prog["out_n"]

    er_kernel, ir_kernel, ir_on = _space_kernels(p, ir_audio)
    fx = FxCfg(out_n=out_n, sr=int(p.base_sr),
               env=(float(p.env_a), float(p.env_d), float(p.env_s),
                    float(p.env_r), float(p.env_curve)),
               er_on=bool(p.er_cloud_on), ir_on=ir_on,
               stereo_on=bool(p.stereo_on),
               stereo_width=float(p.stereo_width),
               sat_drive=float(p.sat_drive), peak=float(p.peak),
               pcm16=bool(pcm16))

    grain_last = None
    oa = "none"
    if prog["E"] > 0:
        L = prog["L"]
        if event_chunk is None:
            # ~256 MB of grain buffers per chunk; bucket the chunk size so
            # seed-to-seed event-count jitter (Poisson/Hawkes fields)
            # reuses compiled kernels.  Sixteenth-octave quanta instead of
            # powers of two: pow2 padded E=270 to 512 and every per-event
            # stage (noise, FFTs, lerp, OA) paid the 1.9x — sixteenths cap
            # the padding waste at ~12% (quantum/E, at most 16 buckets per
            # octave, persistent-cached compiles)
            np2 = _next_pow2(max(1, prog["E"]))
            quantum = max(8, np2 // 16)
            bucketed = -(-prog["E"] // quantum) * quantum
            event_chunk = max(1, min(bucketed,
                                     (1 << 26) // max(1, L)))
        cfg = chain_cfg(p, prog, event_chunk)
        oa = cfg.oa
        chunks = _chunk_events(prog, cfg)
        carry = None
        if cfg.fb_on or cfg.imprint_on:
            nf_c = (cfg.n_fft if cfg.n_fft else L) // 2 + 1
            carry = (np.zeros(L, np.float32), np.int32(0),
                     np.bool_(False), np.zeros(nf_c, np.float32),
                     np.bool_(False))
        if len(chunks) == 1:
            carry, grain_last, stereo = _fused_fn(cfg, fx)(
                chunks[0], carry, er_kernel, ir_kernel)
            if progress:
                progress(100, "Done.")
            meta = {
                "out_sr": int(p.base_sr),
                "design_sr_base": prog["gen_sr_base"],
                # device array: pulled only on access (np.asarray)
                "grain_last": grain_last,
                "events": prog["E"],
                "oa": oa,
            }
            if want_micro_last:
                meta["micro_last"] = _micro_last(prog, cfg)
            return (stereo if device_out else chunked_pull(stereo)), meta
        fn = _chunk_fn(cfg)
        out = np.zeros(pallas_oa.buffer_len(out_n, L), np.float32)
        for ci, ch in enumerate(chunks):
            carry, grain_last, out = fn(ch, carry, out)
            if progress:
                progress(int(5 + 70 * (ci + 1) / len(chunks)),
                         f"Events chunk {ci + 1}/{len(chunks)}")
        out = jnp.asarray(out)[prog["L"]:prog["L"] + out_n]
    else:
        out = np.zeros(out_n, np.float32)

    stereo = _fx_fn(fx)(out, er_kernel, ir_kernel)

    meta = {
        "out_sr": int(p.base_sr),
        "design_sr_base": prog["gen_sr_base"],
        "events": prog["E"],
        "oa": oa,
        # device array (or None), same contract as the fused path:
        # np.asarray on access
        "grain_last": grain_last,
    }
    if want_micro_last and prog["E"] > 0:
        meta["micro_last"] = _micro_last(prog, chain_cfg(p, prog, 1))
    if progress:
        progress(100, "Done.")
    return (stereo if device_out else chunked_pull(stereo)), meta


def batch_render(params: MicrosoundParams, out_dir: str,
                 seeds=None, unfolds=None, stretches=None,
                 ir_audio=None, img_gray=None, manifest_path=None,
                 progress=None) -> list[str]:
    """Batch render over a seeds x unfolds x stretches grid
    (main_v2.py:1524-1596), with resumable manifests (SURVEY.md §5
    checkpoint/resume).  Returns the written WAV paths."""
    import os

    from ..parallel.batch import BatchManifest
    from ..utils import io as audio_io

    seeds = list(seeds) if seeds else [params.seed]
    unfolds = list(unfolds) if unfolds else [params.time_unfold]
    stretches = list(stretches) if stretches else [params.partial_stretch]

    os.makedirs(out_dir, exist_ok=True)
    jobs = [(s, u, st) for s in seeds for u in unfolds for st in stretches]
    job_ids = [f"seed{s}_unfold{u:g}_stretch{st:g}" for s, u, st in jobs]
    manifest = None
    if manifest_path:
        manifest = BatchManifest.open_or_create(manifest_path, job_ids)

    written = []
    pending = None     # (device stereo, path, jid, meta): 1-deep pipeline

    def _flush(item):
        stereo_dev, path, jid, meta = item
        try:
            audio_io.write_wav(path, np.asarray(stereo_dev),
                               int(params.base_sr))
            written.append(path)
            if manifest:
                manifest.mark(jid, "done", events=meta["events"])
        except Exception as e:   # per-item error isolation (SURVEY.md §5)
            if manifest:
                manifest.mark(jid, "failed",
                              error=f"{type(e).__name__}: {e}")
            else:
                raise

    for k, ((s, u, st), jid) in enumerate(zip(jobs, job_ids)):
        path = os.path.join(out_dir, jid + ".wav")
        if manifest and manifest.jobs.get(jid, {}).get("status") == "done":
            written.append(path)
            continue
        p = MicrosoundParams.from_dict(params.to_dict())
        p.seed = int(s)
        p.time_unfold = float(u)
        p.partial_stretch = float(st)
        try:
            # dispatch job k's device render, THEN pull job k-1: the
            # previous render's d2h transfer overlaps this one's compute
            # (jax dispatch is async), pipelining the batch through the
            # device->host link
            stereo_dev, meta = render(p, ir_audio=ir_audio,
                                      img_gray=img_gray, device_out=True)
            if pending is not None:
                _flush(pending)
            pending = (stereo_dev, path, jid, meta)
        except Exception as e:
            if manifest:
                manifest.mark(jid, "failed", error=f"{type(e).__name__}: {e}")
            else:
                raise
        if progress:
            progress(int(100 * (k + 1) / len(jobs)), jid)
    if pending is not None:
        _flush(pending)
    return written


def save_preset(params: MicrosoundParams, path: str):
    """Save the full parameter snapshot (main_v2.py:1296-1310 semantics:
    the JSON is the complete get_params dict, loadable by the reference)."""
    with open(path, "w") as f:
        json.dump(params.to_dict(), f, indent=2, sort_keys=True)


def load_image_gray(path: str):
    """Load an image as a grayscale uint8-range array for the Image
    scanline generator (main_v2.py:1415-1429 uses Qt's grayscale
    conversion; this uses PIL's 'L' mode — same ITU-R 601 luma)."""
    from PIL import Image
    img = Image.open(path).convert("L")
    return np.asarray(img, dtype=np.float64)
