"""TapeTUC engine — offline varispeed tape rendering.

Re-creates the full capability of the reference's realtime looper
(tape-tuc-main/Tape_TUC_23-11-25_auto-slice_n_record.py) as an offline,
jit-compiled render:

- markers -> sections with per-section speed (0.25-4) and reverse
  (Tape…py:491-543)
- duration-preserving "Fit to Target Time" retime (Tape…py:665-705)
- tape-age wow/flutter speed modulation (Tape…py:794-798, 884-891)
- anti-click boundary dips and splice envelopes (Tape…py:838-858)
- optional motor inertia (one-pole speed smoothing, Tape…py:874-882)
- energy-flux beat detection -> markers (Tape…py:913-995)
- undo stack over parameter snapshots (Tape…py:707-759)

"Recording" in the reference is a tap on the realtime output loop
(Tape…py:908-909); offline, the render *is* the recording — `render_tape`
returns the full output, and `write_wav` saves it (PCM_16 parity with
Tape…py:342).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import fixq, varispeed
from ..ops.varispeed import (TapeConsts, tape_scan_render,
                             tape_segment_render)
from ..utils import io as audio_io
from ..utils.transfer import chunked_pull


@dataclass
class TapeParams:
    """Full parameter state of a tape session (the reference's undo-snapshot
    key set, Tape…py:707-724)."""
    sample_rate: int = 48000
    markers: list = field(default_factory=list)          # sorted sample indices
    section_speeds: list = field(default_factory=lambda: [1.0])
    section_reverse: list = field(default_factory=lambda: [False])
    tape_age: int = 50
    enable_splice_fx: bool = True
    anticlick_enabled: bool = True
    anticlick_amount: int = 50
    inertia_enabled: bool = False
    inertia_amount: int = 50
    current_speed: float = 1.0
    play_pos: float = 0.0
    boundary_smooth_len: int = 400
    splice_env_len: int = 256

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_snapshot(d: dict) -> "TapeParams":
        return TapeParams(**d)


class UndoStack:
    """50-deep parameter-state undo (Tape…py:707-759)."""

    def __init__(self, depth: int = 50):
        self.depth = depth
        self._stack: list[dict] = []

    def push(self, params: TapeParams):
        self._stack.append(params.snapshot())
        if len(self._stack) > self.depth:
            self._stack.pop(0)

    def pop(self) -> Optional[TapeParams]:
        if not self._stack:
            return None
        return TapeParams.from_snapshot(self._stack.pop())

    def __len__(self):
        return len(self._stack)


def sections_from_markers(markers, num_samples):
    """starts = [0]+markers, ends = markers+[N] (Tape…py:491-501)."""
    m = sorted(int(x) for x in markers)
    starts = np.asarray([0] + m, dtype=np.int32)
    ends = np.asarray(m + [int(num_samples)], dtype=np.int32)
    return starts, ends


def boundary_array(markers, num_samples):
    s = set(int(x) for x in markers)
    s.add(0)
    if num_samples > 0:
        s.add(int(num_samples) - 1)
    return np.asarray(sorted(s), dtype=np.int32)


def fit_to_target_time(params: TapeParams, num_samples: int,
                       target_seconds: float) -> list[float]:
    """Duration-preserving retime: scales all section speeds by k =
    current_total_time / target, clamped to [0.25, 4] (Tape…py:665-705).
    Preserves speed *ratios* between sections."""
    if target_seconds <= 0 or num_samples <= 0:
        return list(params.section_speeds)
    sr = float(params.sample_rate)
    starts, ends = sections_from_markers(params.markers, num_samples)
    speeds = list(params.section_speeds)
    total_time = 0.0
    for i in range(len(starts)):
        length = max(1, int(ends[i]) - int(starts[i]))
        v = speeds[i] if i < len(speeds) and speeds[i] > 0 else 1.0
        total_time += length / (v * sr)
    if total_time <= 0:
        return speeds
    k = total_time / target_seconds
    return [float(np.clip(v * k, 0.25, 4.0)) for v in speeds]


def section_render_length(params: TapeParams, num_samples: int) -> int:
    """Output length for one full pass over the tape at the configured
    per-section speeds (ignoring wow/flutter): sum_i len_i / v_i."""
    starts, ends = sections_from_markers(params.markers, num_samples)
    speeds = params.section_speeds
    total = 0.0
    for i in range(len(starts)):
        length = max(1, int(ends[i]) - int(starts[i]))
        v = speeds[i] if i < len(speeds) and speeds[i] > 0 else 1.0
        total += length / v
    return int(round(total))


def wow_flutter_mod(num_frames: int, sample_rate: int, tape_age: int,
                    wow_phase0: float = 0.0, flutter_phase0: float = 0.0,
                    phase0_cycles=None):
    """Precomputed, quantized per-sample speed modulation.

    mod = clip(1 + wow_depth sin(wow) + flutter_depth sin(flutter), 0.1, 3)
    with depths scaled by tape age (Tape…py:794-798, 884-891); 0.4 Hz wow,
    7 Hz flutter.  Evaluated with the detmath f32 cycle-domain twin (phases
    in cycles, exact integer reduction via detmath.phase_ratio — stays
    exact at ANY frame count, unlike an f32 arange which degrades past
    2**24 frames ≈ 5.8 min at 48 kHz) and 12-bit-significand depths so
    the SAME curve is computable bit-identically on host NumPy, in C++,
    and on device — the engine and oracle consume this one array, so the
    position integrals agree exactly."""
    from ..ops import detmath
    from ..ops.fixq import round_sig12_np

    ints, flts, ph0 = wow_flutter_consts(sample_rate, tape_age,
                                         wow_phase0, flutter_phase0,
                                         phase0_cycles)
    i = np.arange(num_frames, dtype=np.uint32)
    sw = round_sig12_np(detmath.sin_cycles_np(
        ph0[0] + detmath.phase_cycles_np(i, ints[0], ints[1], flts[0])))
    sf = round_sig12_np(detmath.sin_cycles_np(
        ph0[1] + detmath.phase_cycles_np(i, ints[2], ints[3], flts[1])))
    mod = np.float32(1.0) + flts[2] * sw + flts[3] * sf
    mod = np.clip(mod, np.float32(0.1), np.float32(3.0))
    return fixq.quantize_f32_np(mod)


# Wow 0.4 Hz = 2/5, flutter 7 Hz = 7/1 (Tape…py:794-798) as exact integer
# rate ratios, shared by wow_flutter_consts and lfo_phase_cycles so the
# trace-segment phase continuation can never desync from the mod curve.
WOW_RATE_RATIO = (2, 5)
FLUTTER_RATE_RATIO = (7, 1)


def wow_flutter_consts(sample_rate: int, tape_age: int,
                       wow_phase0: float = 0.0, flutter_phase0: float = 0.0,
                       phase0_cycles=None):
    """Shared constants for the host/device wow-flutter twins:
    (ints u32[4] = wow num/m, flutter num/m;
     flts f32[4] = wow inv_m, flutter inv_m, wow depth, flutter depth;
     phase0 f32[2] in cycles).

    `phase0_cycles`, when given, overrides the radian phase args with exact
    f32 cycle-domain values (the trace renderer's segment continuation:
    see lfo_phase_cycles)."""
    from ..ops import detmath
    from ..ops.fixq import round_sig12_np

    a = max(0.0, min(1.0, tape_age / 100.0))
    wd = round_sig12_np(np.float32(0.001 + 0.006 * a))
    fd = round_sig12_np(np.float32(0.0005 + 0.003 * a))
    wn, wm, winv = detmath.phase_ratio(*WOW_RATE_RATIO, sample_rate)
    fn, fm, finv = detmath.phase_ratio(*FLUTTER_RATE_RATIO, sample_rate)
    ints = np.asarray([wn, wm, fn, fm], np.uint32)
    flts = np.asarray([winv, finv, wd, fd], np.float32)
    if phase0_cycles is not None:
        ph0 = np.asarray(phase0_cycles, np.float32)
    else:
        ph0 = np.asarray([wow_phase0 / (2.0 * np.pi),
                          flutter_phase0 / (2.0 * np.pi)], np.float32)
    return ints, flts, ph0


def lfo_phase_cycles(sample_rate: int, sample_offset: int):
    """Cycle-domain f32 LFO phases at a global output-sample offset
    (exact integer residue reduction — no f32 accumulation error at any
    offset).  A trace segment starting at global sample t0 passes these as
    phase0 so its locally-indexed wow/flutter curve continues the
    performance's global phase; both the engine and the oracle use this
    one convention, so their curves stay bit-identical."""
    from ..ops import detmath

    wn, wm, winv = detmath.phase_ratio(*WOW_RATE_RATIO, sample_rate)
    fn, fm, finv = detmath.phase_ratio(*FLUTTER_RATE_RATIO, sample_rate)
    i = np.uint32(sample_offset % (2**32))
    pw = detmath.phase_cycles_np(i, wn, wm, np.float32(winv))
    pf = detmath.phase_cycles_np(i, fn, fm, np.float32(finv))
    return (np.float32(pw), np.float32(pf))


def splice_envelope(env_len: int = 256) -> np.ndarray:
    """1 + 0.8 e^{-5x} over env_len samples (Tape…py:83-88)."""
    x = np.linspace(0, 1, env_len, dtype=np.float32)
    return (1.0 + 0.8 * np.exp(-5.0 * x)).astype(np.float32)


def build_tape_program(audio, params: TapeParams, num_frames: int,
                       with_mod: bool = True):
    """Precompute every array/constant the render kernels (and the NumPy
    oracle) need. Returns a dict of host NumPy arrays + a TapeConsts.

    `audio` may be a jax.Array already resident on the device (the tape is
    loaded once and rendered many times — keeping it device-side removes
    the dominant h2d transfer); it is passed through untouched.
    `with_mod=False` skips materializing the host wow/flutter curve (the
    device table engine synthesizes it in C++/on device instead)."""
    if not isinstance(audio, jax.Array):
        audio = np.asarray(audio, np.float32)
    n = int(audio.shape[0])
    if n < 2:
        raise ValueError("tape render needs at least 2 samples of audio")

    starts, ends = sections_from_markers(params.markers, n)
    nsec = len(starts)
    speeds = [abs(float(params.section_speeds[i])) if i < len(params.section_speeds)
              else 1.0 for i in range(nsec)]
    revs = [bool(params.section_reverse[i]) if i < len(params.section_reverse)
            else False for i in range(nsec)]
    speeds_q = fixq.quantize_f32_np(np.asarray(speeds, np.float32))

    dt = 1.0 / float(params.sample_rate)
    if params.inertia_enabled and params.inertia_amount > 0:
        tau = (20.0 + 480.0 * (params.inertia_amount / 100.0)) / 1000.0
        alpha = min(1.0, dt / tau) if tau > 0 else 1.0
    else:
        alpha = 1.0

    amt = max(0.0, min(1.0, params.anticlick_amount / 100.0))
    consts = TapeConsts(
        anticlick_on=bool(params.anticlick_enabled),
        smooth_len=int(params.boundary_smooth_len),
        anticlick_strength=float(np.float32(0.3 + 0.5 * amt)),
        splice_on=bool(params.enable_splice_fx),
        inertia_on=bool(params.inertia_enabled and params.inertia_amount > 0),
        alpha_q=float(np.float32(alpha)),
        initial_speed_q=float(fixq.quantize_f32_np(
            np.float32(abs(params.current_speed)))),
    )

    return {
        "audio": audio,
        "mod_q": (wow_flutter_mod(num_frames, params.sample_rate,
                                  params.tape_age) if with_mod else None),
        "mod_consts": wow_flutter_consts(params.sample_rate, params.tape_age),
        "starts": starts,
        "ends": ends,
        "speeds_q": np.asarray(speeds_q, np.float32),
        "reverse": np.asarray(revs, np.bool_),
        "boundaries": boundary_array(params.markers, n),
        "splice_env": splice_envelope(params.splice_env_len),
        "consts": consts,
        "num_frames": int(num_frames),
        "sample_rate": int(params.sample_rate),
        "tape_age": int(params.tape_age),
    }


_TAPE_PROG_CACHE: "OrderedDict" = None


def build_tape_program_cached(audio, params: TapeParams, num_frames: int,
                              with_mod: bool = True) -> dict:
    """build_tape_program memoized on (audio identity, params content,
    num_frames, with_mod), so re-renders of an unchanged tape+params skip
    the full host pre-pass (and, via the prog dict's "_tables" memo, the
    C++ trajectory walk).  The
    AUDIO is keyed by object identity, not content (hashing a 3-minute
    tape costs more than the build): callers must reuse the same array
    object across renders, which the load-once/render-many pattern already
    does.  LRU-bounded at 8 programs."""
    global _TAPE_PROG_CACHE
    import json as _json
    from collections import OrderedDict
    if _TAPE_PROG_CACHE is None:
        _TAPE_PROG_CACHE = OrderedDict()
    key = (id(audio), int(num_frames), bool(with_mod),
           _json.dumps(dataclasses.asdict(params), sort_keys=True,
                       default=str))
    ent = _TAPE_PROG_CACHE.pop(key, None)
    if ent is not None and ent["audio"] is audio:
        _TAPE_PROG_CACHE[key] = ent
        return ent["prog"]
    prog = build_tape_program(audio, params, num_frames, with_mod=with_mod)
    _TAPE_PROG_CACHE[key] = {"audio": audio, "prog": prog}
    while len(_TAPE_PROG_CACHE) > 8:
        _TAPE_PROG_CACHE.popitem(last=False)
    return prog


@jax.jit
def _dup_stereo(y):
    return jnp.stack([y, y], axis=-1)


def _pad_pow2(arr, fill, min_len=4):
    """Pad a 1-D int array to the next power-of-two length (static-shape
    bucketing: table sizes stop forcing fresh jit compiles)."""
    k = len(arr)
    cap = max(min_len, 1 << max(0, (k - 1).bit_length())) if k else min_len
    out = np.full(cap, fill, arr.dtype if k else np.int32)
    out[:k] = arr
    return out


def _device_consts(consts: TapeConsts) -> TapeConsts:
    """Normalize the TapeConsts fields the DEVICE kernel never reads
    (inertia/alpha/initial speed live entirely in the host table builder):
    they would otherwise be jit static-arg cache keys, so every inertia
    toggle / carried trace speed would mint a fresh XLA compilation."""
    return dataclasses.replace(consts, inertia_on=False, alpha_q=1.0,
                               initial_speed_q=1.0)


def _pack_tables(tables: dict, T: int, n_audio: int, starts, ends,
                 mod_flts, consts: TapeConsts, interp: str):
    """Shape-bucket the control tables and decide blockwise-read
    feasibility (shared by the single-program and trace renderers).
    Returns (packed dict of padded arrays, t_pad, span_b, cap)."""
    t_pad = -(-T // 32768) * 32768
    packed = dict(
        vs=_pad_pow2(tables["visit_start"], t_pad, min_len=64),
        bw=_pad_pow2(tables["visit_bw"], 0, min_len=64),
        bf=_pad_pow2(tables["visit_bf"], 0, min_len=64),
        vsec=_pad_pow2(tables["visit_sec"], 0, min_len=64),
        rs=_pad_pow2(tables["run_start"], t_pad, min_len=64),
        s0=_pad_pow2(tables["run_s0"], 0, min_len=64),
        rm=_pad_pow2(tables["run_m"], 0, min_len=64),
    )

    # blockwise-read feasibility (host decision, static): the span bound
    # comes from the run speeds x the wow/flutter depth; the patch cap
    # bounds visit starts + worst-case section-loop wraps
    # (T*max_inc/min_sec_len).  Unbounded (pathological marker spacing)
    # or tiny tapes fall back to the pair gather.
    span_b, cap = 0, 0
    if interp in ("linear", "sinc"):
        s0v = np.asarray(tables["run_s0"], np.int64)
        rmv = np.asarray(tables["run_m"], np.int64)
        rsv = np.asarray(tables["run_start"], np.int64)
        if s0v.size:
            run_len = np.diff(np.append(rsv, T))
            ends_spd = s0v + rmv * np.maximum(0, run_len)
            max_spd = max(np.abs(s0v).max(), np.abs(ends_spd).max()) \
                * float(fixq.POS_INV_F)
        else:
            max_spd = float(consts.initial_speed_q)
        wd, fd = float(mod_flts[2]), float(mod_flts[3])
        max_inc = max_spd * (1.0 + wd + fd) + 1e-6
        span_samples = int(np.ceil(max_inc)) + 1
        span_b = 1 << max(2, (max(1, span_samples) - 1).bit_length())
        sec_len = np.maximum(1, np.asarray(ends, np.int64)
                             - np.asarray(starts, np.int64))
        wraps = int(T * max_inc / float(sec_len.min()))
        bound = wraps + len(tables["visit_start"]) + 8
        cap = 1 << max(6, (bound - 1).bit_length())
        n_blocks = t_pad // 128
        if (cap > 2048 or cap > n_blocks // 2
                or n_audio <= 2 * span_b * 128 + 256):
            # patch set unbounded, would cover most blocks (top_k k must
            # not exceed the block count), or the tape is too small for
            # the window: the pair gather is the right engine
            span_b, cap = 0, 0
    return packed, t_pad, span_b, cap


def tape_table_render(prog: dict, out_i16: bool = False,
                      device_out: bool = False, interp: str = "linear",
                      stereo: bool = False):
    """Device tape engine: compact host control tables -> full on-device
    reconstruction (ops/varispeed.tape_device_render).  Host->device payload
    is O(visits + runs) ~ KBs instead of 12 bytes/output sample.
    device_out=True returns the PADDED device array (length bucketed to 32k
    blocks, zero beyond prog["num_frames"]) without the d2h pull — for
    pipelines that keep consuming on device, and for compute-only RTF
    measurement.  Padded because slicing to the exact frame count mints a
    fresh XLA slice kernel per distinct length; slice host-side if needed."""
    consts = prog["consts"]
    T = int(prog["num_frames"])
    n = int(prog["audio"].shape[0])
    # memoize the control tables on the program dict: the C++ trajectory
    # walk costs ~190 ms for a 3-minute render and depends only on the
    # program (a fresh prog is built whenever params change, so re-renders
    # of the same program skip straight to the device kernel)
    tables = prog.get("_tables")
    if tables is None:
        from ..utils import native_rt
        tables = native_rt.tape_tables(
            T, n, prog["mod_consts"], prog["starts"], prog["ends"],
            prog["speeds_q"], prog["reverse"], prog["boundaries"],
            len(prog["splice_env"]), consts)
        if tables is None:
            mod_q = prog["mod_q"]
            if mod_q is None:
                mod_q = wow_flutter_mod(T, int(prog["sample_rate"]),
                                        int(prog["tape_age"]))
            tables = varispeed.tape_tables(
                n, mod_q, prog["starts"], prog["ends"], prog["speeds_q"],
                prog["reverse"], prog["boundaries"], len(prog["splice_env"]),
                consts)
        prog["_tables"] = tables

    # shape bucketing: pad the render length to 32k blocks and every table
    # to a power of two (min 64) so repeated renders — including renders of
    # TWEAKED programs whose visit/run/trigger counts wander a little —
    # reuse the compiled kernel instead of flipping shape buckets
    ints, flts, ph0 = prog["mod_consts"]
    pk, t_pad, span_b, cap = _pack_tables(
        tables, T, int(prog["audio"].shape[0]), prog["starts"], prog["ends"],
        flts, consts, interp)
    trig = (_pad_pow2(tables["triggers"], t_pad, min_len=64)
            if len(tables["triggers"]) else np.zeros(0, np.int32))

    out = varispeed.tape_device_render(
        prog["audio"], ints, flts, ph0,
        pk["vs"], pk["bw"], pk["bf"], pk["vsec"], pk["rs"], pk["s0"],
        pk["rm"],
        prog["starts"], prog["ends"], prog["reverse"], prog["boundaries"],
        trig, prog["splice_env"],
        _device_consts(consts), t_pad, out_i16, interp, False,
        n_valid=jnp.int32(T), blockwise_span=span_b, patch_cap=cap)
    if stereo:
        # duplicate the MONO kernel's output in a separate tiny jit: a
        # stereo kernel variant is a second XLA compilation whose FMA
        # contraction choices may drift 1 ulp from the mono render
        out = _dup_stereo(out)
    if device_out:
        # PADDED buffer (zero beyond T): slicing to the exact T here would
        # compile a fresh XLA slice kernel for every distinct frame count
        # — callers get (padded, n_valid)
        # semantics via tables["final"]/T and slice host-side if needed
        return out, tables["final"]
    return chunked_pull(out, T), tables["final"]


def render_tape(audio, params: TapeParams,
                num_frames: Optional[int] = None,
                engine: str = "device",
                interp: str = "linear") -> np.ndarray:
    """Offline render of `num_frames` output samples (default: one full
    duration-preserving pass over the tape).

    engine="device" (default): compact host control tables + full on-device
    reconstruction (mod synthesis, run expansion, segmented position cumsum,
    gather) — KBs of h2d payload per render; pass a device-resident
    jax.Array as `audio` to skip the tape upload entirely.
    engine="segment": host exact per-sample trajectory + one device gather
    kernel.  engine="scan": the sequential reference-structured kernel, kept
    for cross-validation.  All three make bit-identical discrete decisions
    (same fixed-point integers)."""
    n = int(audio.shape[0]) if hasattr(audio, "shape") else len(audio)
    if num_frames is None:
        num_frames = section_render_length(params, n)
    if engine == "device":
        from ..utils import native_rt
        # the C++ table builder synthesizes its own mod curve; only the
        # NumPy fallback needs the host array
        prog = build_tape_program_cached(audio, params, num_frames,
                                         with_mod=native_rt.get_lib() is None)
        out, _ = tape_table_render(prog, interp=interp)
        return out
    prog = build_tape_program(audio, params, num_frames)
    if engine == "segment":
        out, _ = tape_segment_render(
            prog["audio"], prog["mod_q"], prog["starts"], prog["ends"],
            prog["speeds_q"], prog["reverse"], prog["boundaries"],
            prog["splice_env"], prog["consts"])
    else:
        out, _ = tape_scan_render(
            jnp.asarray(prog["audio"]), jnp.asarray(prog["mod_q"]),
            jnp.asarray(prog["starts"]), jnp.asarray(prog["ends"]),
            jnp.asarray(prog["speeds_q"]), jnp.asarray(prog["reverse"]),
            jnp.asarray(prog["boundaries"]), jnp.asarray(prog["splice_env"]),
            prog["consts"],
        )
    return np.asarray(out)


# ----------------------------------------------------------------------------
# Performance automation: TapeTrace
# ----------------------------------------------------------------------------
#
# TapeTUC is an instrument: the reference user mutates speeds/markers/toggles
# DURING playback under the RLock (Tape…py:768-788) and the recording tap
# captures that performance (Tape…py:902-909).  A TapeTrace is the offline,
# reproducible form of such a performance: a schedule of timed parameter
# mutations (exactly the set the GUI can make) rendered as segmented table
# programs with position/speed/splice state carried across segments.
#
# Semantics note: the reference applies GUI mutations at audio-pull-block
# granularity (whenever provide_samples next snapshots state); the trace
# applies them at the exact event sample — documented, strictly more precise.

#: ops a trace event may carry (mirroring the GUI actions under the RLock):
#:   set_speed {section, value}        speed spinbox (Tape…py:545-549)
#:   set_reverse {section, value}      reverse checkbox (Tape…py:551-556)
#:   add_marker {sample}               marker add (Tape…py:558-583)
#:   remove_marker {sample}            marker delete
#:   set_markers {markers}             wholesale marker edit / beat slicing
#:   set_age {value}                   tape-age slider 0-100
#:   set_splice {value}                splice FX toggle
#:   set_anticlick {value}             anti-click toggle
#:   set_anticlick_amount {value}      anti-click amount 0-100
#:   set_inertia {value}               inertia toggle
#:   set_inertia_amount {value}        inertia amount 0-100
#:   retime {target}                   Fit to Target Time (Tape…py:665-705)
#:   seek {sample}                     position jump
TRACE_OPS = {
    "set_speed": ("section", "value"),
    "set_reverse": ("section", "value"),
    "add_marker": ("sample",),
    "remove_marker": ("sample",),
    "set_markers": ("markers",),
    "set_age": ("value",),
    "set_splice": ("value",),
    "set_anticlick": ("value",),
    "set_anticlick_amount": ("value",),
    "set_inertia": ("value",),
    "set_inertia_amount": ("value",),
    "retime": ("target",),
    "seek": ("sample",),
}


@dataclass
class TapeTrace:
    """A recorded performance: events = [{"t": seconds, "op": ..., ...}]."""
    events: list = field(default_factory=list)

    def add(self, t: float, op: str, **kw) -> "TapeTrace":
        if op not in TRACE_OPS:
            raise ValueError(f"unknown trace op {op!r}")
        missing = [k for k in TRACE_OPS[op] if k not in kw]
        if missing:
            raise ValueError(
                f"trace op {op!r} at t={t} missing required "
                f"field(s) {missing} (got {sorted(kw)})")
        self.events.append({"t": float(t), "op": op, **kw})
        return self

    def to_json(self) -> str:
        import json
        return json.dumps({"events": self.events}, indent=2)

    @staticmethod
    def from_json(text: str) -> "TapeTrace":
        import json
        d = json.loads(text)
        tr = TapeTrace()
        for e in d.get("events", []):
            kw = {k: v for k, v in e.items() if k not in ("t", "op")}
            tr.add(e["t"], e["op"], **kw)
        return tr

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "TapeTrace":
        with open(path) as f:
            return TapeTrace.from_json(f.read())


def _rebuild_sections_preserving(p: TapeParams):
    """Marker-edit section rebuild: speeds/reverse preserved by index, new
    sections get 1.0/False (Tape…py:509-519 rebuild_table)."""
    nsec = len(p.markers) + 1
    p.section_speeds = [p.section_speeds[i] if i < len(p.section_speeds)
                        else 1.0 for i in range(nsec)]
    p.section_reverse = [p.section_reverse[i] if i < len(p.section_reverse)
                         else False for i in range(nsec)]


def apply_trace_op(params: TapeParams, ev: dict,
                   num_samples: int) -> TapeParams:
    """Apply one trace event to a parameter snapshot (pure: returns a new
    TapeParams).  `seek` does not touch params — the renderer consumes it."""
    p = TapeParams.from_snapshot(params.snapshot())
    op = ev["op"]
    if op == "set_speed":
        i = int(ev["section"])
        while len(p.section_speeds) <= i:
            p.section_speeds.append(1.0)
        p.section_speeds[i] = float(np.clip(ev["value"], 0.25, 4.0))
    elif op == "set_reverse":
        i = int(ev["section"])
        while len(p.section_reverse) <= i:
            p.section_reverse.append(False)
        p.section_reverse[i] = bool(ev["value"])
    elif op == "add_marker":
        s = int(ev["sample"])
        if 0 < s < num_samples and s not in p.markers:
            p.markers = sorted(p.markers + [s])
            _rebuild_sections_preserving(p)
    elif op == "remove_marker":
        s = int(ev["sample"])
        if s in p.markers:
            p.markers = [m for m in p.markers if m != s]
            _rebuild_sections_preserving(p)
    elif op == "set_markers":
        p.markers = sorted(int(m) for m in ev["markers"]
                           if 0 < int(m) < num_samples)
        _rebuild_sections_preserving(p)
    elif op == "set_age":
        p.tape_age = int(np.clip(ev["value"], 0, 100))
    elif op == "set_splice":
        p.enable_splice_fx = bool(ev["value"])
    elif op == "set_anticlick":
        p.anticlick_enabled = bool(ev["value"])
    elif op == "set_anticlick_amount":
        p.anticlick_amount = int(np.clip(ev["value"], 0, 100))
    elif op == "set_inertia":
        p.inertia_enabled = bool(ev["value"])
    elif op == "set_inertia_amount":
        p.inertia_amount = int(np.clip(ev["value"], 0, 100))
    elif op == "retime":
        p.section_speeds = fit_to_target_time(p, num_samples,
                                              float(ev["target"]))
    elif op == "seek":
        pass
    else:
        raise ValueError(f"unknown trace op {op!r}")
    return p


def build_trace_programs(audio, params: TapeParams, trace: TapeTrace,
                         num_frames: Optional[int] = None) -> list[dict]:
    """Split the output timeline at event times and build one table program
    per segment, threading position/speed state through the host table
    builder exactly as the realtime loop would (init_whole/init_frac +
    initial_speed_q are the previous segment's final state).  Wow/flutter
    phases continue via exact integer residues (lfo_phase_cycles), so a
    segment's locally-indexed curve equals the global performance curve.

    Each returned segment dict is a full build_tape_program-style program
    (the NumPy oracle renders it directly) plus t0/t1, init state, the
    prebuilt tables, and the raw boundary-hit list for the splice machine."""
    if not isinstance(audio, jax.Array):
        audio = np.asarray(audio, np.float32)
    n = int(audio.shape[0])
    if n < 2:
        raise ValueError("tape render needs at least 2 samples of audio")
    p = TapeParams.from_snapshot(params.snapshot())
    sr = int(p.sample_rate)
    if num_frames is None:
        num_frames = section_render_length(p, n)
    T = int(num_frames)

    grouped: dict[int, list] = {}
    for e in sorted(trace.events, key=lambda e: float(e["t"])):
        ts = int(round(float(e["t"]) * sr))
        if ts >= T:
            continue
        grouped.setdefault(max(0, ts), []).append(e)
    edges = [0] + sorted(t for t in grouped if t > 0) + [T]

    carry_w, carry_f = fixq.split_pos_np(float(p.play_pos) % n)
    carry_speed = abs(float(p.current_speed))

    segs = []
    for t0, t1 in zip(edges[:-1], edges[1:]):
        for e in grouped.get(t0, []):
            if e["op"] == "seek":
                carry_w, carry_f = fixq.split_pos_np(
                    float(e["sample"]) % n)
            else:
                p = apply_trace_op(p, e, n)
        Ts = t1 - t0

        starts, ends = sections_from_markers(p.markers, n)
        nsec = len(starts)
        speeds = [abs(float(p.section_speeds[i]))
                  if i < len(p.section_speeds) else 1.0
                  for i in range(nsec)]
        revs = [bool(p.section_reverse[i]) if i < len(p.section_reverse)
                else False for i in range(nsec)]
        speeds_q = fixq.quantize_f32_np(np.asarray(speeds, np.float32))

        dt = 1.0 / float(sr)
        if p.inertia_enabled and p.inertia_amount > 0:
            tau = (20.0 + 480.0 * (p.inertia_amount / 100.0)) / 1000.0
            alpha = min(1.0, dt / tau) if tau > 0 else 1.0
        else:
            alpha = 1.0
        amt = max(0.0, min(1.0, p.anticlick_amount / 100.0))
        consts = TapeConsts(
            anticlick_on=bool(p.anticlick_enabled),
            smooth_len=int(p.boundary_smooth_len),
            anticlick_strength=float(np.float32(0.3 + 0.5 * amt)),
            splice_on=bool(p.enable_splice_fx),
            inertia_on=bool(p.inertia_enabled and p.inertia_amount > 0),
            alpha_q=float(np.float32(alpha)),
            initial_speed_q=float(fixq.quantize_f32_np(
                np.float32(carry_speed))),
        )

        ph0c = lfo_phase_cycles(sr, t0)
        mints, mflts, mph0 = wow_flutter_consts(sr, p.tape_age,
                                                phase0_cycles=ph0c)
        mod_q = wow_flutter_mod(Ts, sr, p.tape_age, phase0_cycles=ph0c)
        boundaries = boundary_array(p.markers, n)

        tables = varispeed.tape_tables(
            n, mod_q, starts, ends, speeds_q, np.asarray(revs, np.bool_),
            boundaries, p.splice_env_len, consts,
            init_whole=int(carry_w), init_frac=int(carry_f))

        segs.append({
            "t0": t0, "t1": t1,
            "audio": audio,
            "mod_q": mod_q,
            "mod_consts": (mints, mflts, mph0),
            "starts": starts, "ends": ends,
            "speeds_q": np.asarray(speeds_q, np.float32),
            "reverse": np.asarray(revs, np.bool_),
            "boundaries": boundaries,
            "splice_env": splice_envelope(p.splice_env_len),
            "consts": consts,
            "num_frames": Ts,
            "sample_rate": sr,
            "tape_age": int(p.tape_age),
            "init_whole": int(carry_w), "init_frac": int(carry_f),
            "tables": tables,
            "hits": np.asarray(tables["hits"], np.int64),
            "params": TapeParams.from_snapshot(p.snapshot()),
        })
        fin = tables["final"]
        carry_w, carry_f = int(fin["whole"]), int(fin["frac"])
        carry_speed = float(fin["speed"])
    return segs


def _splice_pieces(segs: list[dict], env_len: int) -> list[tuple]:
    """Global splice state machine over the segments' raw boundary hits:
    mirrors the reference's per-sample rem/sidx evolution (Tape…py:851-858,
    oracle render_tape_np) at hit/segment-boundary granularity.  Splice-off
    segments FREEZE the state (the gate wraps both trigger and application).
    Returns [(global_t, env_offset, length)] — non-overlapping by
    construction."""
    rem, sidx = 0, 0
    pieces = []
    for s in segs:
        if not (s["consts"].splice_on and len(s["boundaries"]) > 0):
            continue                      # frozen through this segment
        t0, t1 = s["t0"], s["t1"]
        hits = s["hits"]
        nh = len(hits)
        hi = 0
        t = t0
        while t < t1:
            if rem > 0 and sidx < env_len:
                run = min(rem, t1 - t)
                pieces.append((t, sidx, run))
                sidx += run
                rem -= run
                t += run
                continue
            while hi < nh and t0 + int(hits[hi]) < t:
                hi += 1                   # hits during application: rem > 0
            if hi >= nh:
                break
            t = t0 + int(hits[hi])
            hi += 1
            rem, sidx = env_len, 0
    return pieces


def render_tape_trace(audio, params: TapeParams, trace: TapeTrace,
                      num_frames: Optional[int] = None,
                      interp: str = "linear",
                      return_state: bool = False):
    """Render a performance: `params` is the state at t=0, `trace` the timed
    mutations.  One device dispatch per segment (compiled kernels are shared
    across segments — the device-irrelevant consts fields are normalized),
    with position/speed/splice state carried bit-exactly via the host table
    builder.  Returns the rendered f32 array (and, with return_state, the
    final (params, whole, frac, speed) for record->reload continuations)."""
    segs = build_trace_programs(audio, params, trace, num_frames)
    env_len = int(params.splice_env_len)
    pieces = _splice_pieces(segs, env_len)

    outs = []
    for s in segs:
        t0, t1 = s["t0"], s["t1"]
        Ts = t1 - t0
        local = [(gt - t0, off, ln) for (gt, off, ln) in pieces
                 if t0 <= gt < t1]
        consts = s["consts"]
        mints, mflts, mph0 = s["mod_consts"]
        pk, t_pad, span_b, cap = _pack_tables(
            s["tables"], Ts, int(s["audio"].shape[0]), s["starts"],
            s["ends"], mflts, consts, interp)
        toff = tlen = None
        if local:
            trig = _pad_pow2(np.asarray([x[0] for x in local], np.int32),
                             t_pad, min_len=64)
            if not all(off == 0 and (ln == env_len or lt + ln == Ts)
                       for (lt, off, ln) in local):
                # partial pieces (an envelope paused/resumed across a
                # splice toggle): the piece-scatter path
                toff = _pad_pow2(np.asarray([x[1] for x in local],
                                            np.int32), 0, min_len=64)
                tlen = _pad_pow2(np.asarray([x[2] for x in local],
                                            np.int32), 0, min_len=64)
            # else: every piece is a full envelope — identical to the plain
            # trigger path, which keeps a no-event trace bit-equal to
            # render_tape (same compiled kernel)
        else:
            trig = np.zeros(0, np.int32)
        out = varispeed.tape_device_render(
            s["audio"], mints, mflts, mph0,
            pk["vs"], pk["bw"], pk["bf"], pk["vsec"], pk["rs"], pk["s0"],
            pk["rm"],
            s["starts"], s["ends"], s["reverse"], s["boundaries"],
            trig, s["splice_env"],
            _device_consts(consts), t_pad, False, interp, False,
            n_valid=jnp.int32(Ts), blockwise_span=span_b, patch_cap=cap,
            with_pieces=toff is not None, splice_off=toff, splice_len=tlen)
        outs.append((out, Ts))

    y = np.concatenate([chunked_pull(o, Ts) for (o, Ts) in outs]) \
        if outs else np.zeros(0, np.float32)
    if return_state:
        last = segs[-1]["tables"]["final"] if segs else {
            "whole": 0, "frac": 0, "speed": 1.0}
        final_params = segs[-1]["params"] if segs else params
        return y, {"params": final_params, "whole": int(last["whole"]),
                   "frac": int(last["frac"]),
                   "speed": float(last["speed"])}
    return y


def detect_beats(audio: np.ndarray, sample_rate: int,
                 sensitivity: int = 50) -> list[int]:
    """Energy-flux beat detection -> marker sample indices (Tape…py:913-995).

    normalize -> 1024/512 frame energies -> 3-tap moving average -> positive
    first difference -> threshold mean + sens*std -> local maxima with 0.2 s
    minimum gap.
    """
    x = np.asarray(audio, np.float32)
    n = len(x)
    if n <= 0 or sample_rate <= 0:
        return []
    max_abs = float(np.max(np.abs(x))) if x.size else 0.0
    if max_abs > 0:
        x = x / max_abs

    frame_size, hop = 1024, 512
    if n < frame_size + 1:
        return []
    num_frames = 1 + (n - frame_size) // hop
    if num_frames <= 1:
        return []

    # vectorized frame energies (reference loops per frame, Tape…py:939-944)
    idx = np.arange(num_frames)[:, None] * hop + np.arange(frame_size)[None, :]
    energies = np.sum(x[idx] * x[idx], axis=1, dtype=np.float32)

    if num_frames >= 3:
        kernel = np.ones(3, dtype=np.float32) / 3.0
        e_smooth = np.convolve(energies, kernel, mode="same")
    else:
        e_smooth = energies

    diff = np.maximum(e_smooth[1:] - e_smooth[:-1], 0.0)
    if diff.size == 0:
        return []
    mean = float(np.mean(diff))
    std = float(np.std(diff))
    sens = sensitivity / 100.0
    thresh = mean + sens * std
    min_gap = max(1, int(0.2 * sample_rate / hop))

    peaks = []
    last_peak = -min_gap
    for j in range(1, diff.size - 1):
        v = diff[j]
        if v < thresh:
            continue
        if not (v >= diff[j - 1] and v >= diff[j + 1]):
            continue
        if j - last_peak < min_gap:
            continue
        peaks.append(j)
        last_peak = j

    beats = [int(p * hop) for p in peaks]
    return sorted(set(b for b in beats if 0 < b < n))


def render_to_wav(in_path: str, out_path: str, params: TapeParams,
                  num_frames: Optional[int] = None):
    """Load -> render -> save (the offline equivalent of record/stop-record,
    Tape…py:302-345; PCM_16 subtype parity with Tape…py:342)."""
    audio, sr = audio_io.load_wav_mono(in_path)
    if sr != params.sample_rate:
        audio = audio_io.resample_to_rate(audio, sr, params.sample_rate)
    out = render_tape(audio, params, num_frames)
    audio_io.write_wav(out_path, out, params.sample_rate, subtype="PCM_16")
    return out
