"""Grid Audio engine — multi-track grid DAW mixdown.

Re-creates grid_audio_app_0.2/grid_audio_app.py's render path as device
kernels:

- data model (CellSource / Track / MasterClock, :156-233), division system
  with the sandboxed user-code path (:196-213), plugin cells
  (generate/event contracts wire-compatible with the reference examples),
  restart-event resolution (:601-706 — with the reference's missing
  ``import math`` bug FIXED rather than reproduced, SURVEY.md §7),
- the per-master-sample phase-accumulator placement loop (:786-814) becomes
  a fully parallel SEGMENTED CUMSUM over reset boundaries (SURVEY.md §7
  design decision 1): positions are integrated in f64 on the host (exact,
  vectorized — control data), while the audio path (pattern gather, gain,
  track sum, clip) is one jitted device kernel over a flattened pattern
  bank, shape-stable in the number of tracks.

Track patterns and user-script audio are host NumPy (arbitrary Python);
their outputs ship to device as the flat pattern bank.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import envdet, fixq
from ..plugins.host import load_py_module
from ..utils import io as audio_io
from ..utils.transfer import chunked_pull

DEFAULT_DIVISION_SNIPPET = "def divisions(total):\n    return [total/16.0]*16\n"


def divisions_uniform(total: float, n: int) -> List[float]:
    n = max(1, int(n))
    return [total / n] * n


def parse_float_list(text: str) -> List[float]:
    """Sync-point parser (grid_audio_app.py:118-131)."""
    pts: List[float] = []
    for part in (text or "").replace(";", ",").split(","):
        s = part.strip()
        if not s:
            continue
        try:
            v = float(s)
            if np.isfinite(v):
                pts.append(v)
        except Exception:
            pass
    pts.sort()
    return pts


def moving_average(x: np.ndarray, win: int) -> np.ndarray:
    """(grid_audio_app.py:133-140).  The reference computes the box filter
    with np.convolve — O(n*win), ~0.4 s for a minute of mod-source audio.
    Same box sums via an f64 cumulative sum in O(n); values agree with the
    convolution to f64 rounding (~1e-7 relative — the mod envelope is a
    control signal, documented framework semantics)."""
    if win <= 1:
        return x
    win = min(win, len(x))
    if win <= 1:
        return x
    n = len(x)
    c = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
    # np.convolve 'same' window for output i: x[i - win//2 ... i + (win-1)//2]
    lo = np.clip(np.arange(n) - win // 2, 0, n)
    hi = np.clip(np.arange(n) + (win - 1) // 2 + 1, 0, n)
    return ((c[hi] - c[lo]) / float(win)).astype(np.float32)


def rms_envelope(x: np.ndarray, win: int) -> np.ndarray:
    """(grid_audio_app.py:142-147)"""
    if len(x) == 0:
        return x.astype(np.float32, copy=False)
    xx = x.astype(np.float32, copy=False) ** 2
    sm = moving_average(xx, max(1, win))
    return np.sqrt(np.maximum(sm, 0.0)).astype(np.float32)


# ---------------------------------------------------------------------------
# Data model (grid_audio_app.py:156-233)
# ---------------------------------------------------------------------------

@dataclass
class CellSource:
    kind: str = "empty"   # "empty" | "wav" | "py"
    path: str = ""


@dataclass
class Track:
    name: str = "Track"
    gain_db: float = 0.0
    mode: str = "tempo_bpm"   # "tempo_bpm" | "tempo_spm" | "duration"
    bpm: float = 120.0
    seconds_per_measure: float = 2.0
    beats_per_measure: int = 4
    measures: int = 4
    duration_seconds: float = 8.0

    start_offset_seconds: float = 0.0
    loop_to_master: bool = False
    sync_points_text: str = ""

    mod_source_index: int = -1
    mod_amount: float = 0.0
    mod_smoothing_ms: float = 50.0

    division_mode: str = "uniform"   # "uniform" | "python"
    uniform_n: int = 16
    python_code: str = DEFAULT_DIVISION_SNIPPET

    cells: List[CellSource] = field(default_factory=list)

    def total_duration(self) -> float:
        if self.mode == "duration":
            return max(0.0, float(self.duration_seconds))
        if self.mode == "tempo_spm":
            return float(self.measures) * max(1e-6,
                                              float(self.seconds_per_measure))
        bpm = max(1e-6, float(self.bpm))
        beats = max(1, int(self.beats_per_measure))
        return float(self.measures) * (60.0 / bpm) * beats

    def build_divisions(self) -> List[float]:
        """Uniform N, or exec of user `divisions(total)` code, normalized
        to sum == total (grid_audio_app.py:196-213).

        The restricted-builtins dict mirrors the reference's whitelist but
        is NOT a security sandbox (escapable via object introspection, as
        in the reference): project files are trusted input, exactly like
        the reference's plugin cells."""
        total = self.total_duration()
        if total <= 0:
            return []
        if self.division_mode == "python":
            glb = {"__builtins__": {"range": range, "len": len, "sum": sum,
                                    "min": min, "max": max, "abs": abs,
                                    "float": float, "int": int}}
            loc: Dict[str, Any] = {}
            exec(self.python_code, glb, loc)
            if "divisions" not in loc:
                raise RuntimeError(
                    "Python divisions code must define: divisions(total)")
            out = [float(x) for x in loc["divisions"](total)]
            s = sum(out)
            if s <= 0:
                return []
            return [x * (total / s) for x in out]
        return divisions_uniform(total, self.uniform_n)

    def ensure_cells(self, n: int):
        n = max(0, int(n))
        if len(self.cells) < n:
            self.cells.extend(CellSource() for _ in range(n - len(self.cells)))
        elif len(self.cells) > n:
            self.cells = self.cells[:n]


@dataclass
class MasterClock:
    mode: str = "auto"   # "auto" | "fixed_seconds"
    fixed_seconds: float = 16.0

    def duration(self, tracks: List[Track]) -> float:
        if self.mode == "fixed_seconds":
            return max(0.01, float(self.fixed_seconds))
        m = 0.0
        for t in tracks:
            m = max(m, max(0.0, float(t.start_offset_seconds))
                    + max(0.0, t.total_duration()))
        return max(0.01, m)


@dataclass
class GridProject:
    tracks: List[Track] = field(default_factory=list)
    master: MasterClock = field(default_factory=MasterClock)
    sample_rate: int = 44100
    normalize: bool = False        # export-time 0.98 peak normalize


# ---------------------------------------------------------------------------
# Restart events (grid_audio_app.py:601-706)
# ---------------------------------------------------------------------------

MAX_EVENTS = 20000
MAX_OCCURRENCES = 10000


def collect_restart_events(project: GridProject,
                           master_dur: float) -> List[set]:
    """For every track x pattern-occurrence x py-cell with event(), build the
    context dict, call it, and resolve `{"restart_tracks": ..., "delay": s}`
    into per-track sets of master-sample reset indices.

    NOTE: the reference's occurrence count uses `math.ceil` without importing
    math (grid_audio_app.py:630 -> NameError whenever loop_to_master is on);
    this implementation fixes the bug instead of reproducing it."""
    tracks = project.tracks
    sr = project.sample_rate
    n_tracks = len(tracks)
    restarts: List[set] = [set() for _ in range(n_tracks)]
    events_count = 0
    name_map = {t.name: i for i, t in enumerate(tracks)}

    for src_ti, t in enumerate(tracks):
        divs = t.build_divisions()
        if not divs:
            continue
        t.ensure_cells(len(divs))
        pat_dur = float(sum(divs))
        if pat_dur <= 1e-9:
            continue
        starts = np.cumsum([0.0] + divs[:-1])
        start0 = float(t.start_offset_seconds)
        if t.loop_to_master:
            occs = int(math.ceil(max(0.0, master_dur - start0)
                                 / pat_dur)) + 1
        else:
            occs = 1
        occs = max(0, min(occs, MAX_OCCURRENCES))

        for occ in range(occs):
            occ_start = start0 + occ * pat_dur
            if occ_start > master_dur:
                break
            for ci, (cell, cs) in enumerate(zip(t.cells, starts)):
                if cell.kind != "py" or not cell.path:
                    continue
                try:
                    mod = load_py_module(cell.path)
                except Exception:
                    continue     # plugin errors isolated per cell (:644-645)
                if mod.event is None:
                    continue
                master_time = occ_start + float(cs)
                if master_time < 0.0 or master_time > master_dur:
                    continue
                ctx = {
                    "track_index": src_ti,
                    "track_name": t.name,
                    "cell_index": ci,
                    "cells_total": len(divs),
                    "cell_start": float(cs),
                    "cell_duration": float(divs[ci]),
                    "track_pattern_duration": float(pat_dur),
                    "track_offset": float(t.start_offset_seconds),
                    "track_loop_to_master": bool(t.loop_to_master),
                    "track_sync_points_master":
                        parse_float_list(t.sync_points_text),
                    "master_time": float(master_time),
                    "master_duration": float(master_dur),
                    "tracks": [{"index": i, "name": tt.name}
                               for i, tt in enumerate(tracks)],
                }
                try:
                    ev = mod.event(ctx)
                except Exception:
                    continue     # swallowed per event-cell (:670-672)
                if not isinstance(ev, dict):
                    continue
                targets = ev.get("restart_tracks", [])
                if targets == "all":
                    target_idx = list(range(n_tracks))
                elif targets == "all_except_self":
                    target_idx = [i for i in range(n_tracks) if i != src_ti]
                else:
                    target_idx = []
                    if isinstance(targets, (list, tuple)):
                        for it in targets:
                            if isinstance(it, int) and 0 <= it < n_tracks:
                                target_idx.append(it)
                            elif isinstance(it, str) and it in name_map:
                                target_idx.append(name_map[it])
                try:
                    delay = float(ev.get("delay", 0.0) or 0.0)
                except Exception:
                    delay = 0.0
                sidx = int(round((master_time + delay) * sr))
                if 0 <= sidx < int(round(master_dur * sr)) + 1:
                    for ti in target_idx:
                        restarts[ti].add(sidx)
                    events_count += 1
                    if events_count >= MAX_EVENTS:
                        return restarts
    return restarts


# ---------------------------------------------------------------------------
# Cell + pattern rendering (host: user scripts / wav files)
# ---------------------------------------------------------------------------

def render_cell_audio(cell: CellSource, sr: int, duration: float,
                      context: Dict[str, Any]) -> np.ndarray:
    """(grid_audio_app.py:816-837) — event-only scripts return silence."""
    duration = max(0.0, float(duration))
    if duration <= 0:
        return np.zeros(0, np.float32)
    if cell.kind == "wav":
        x, in_sr = audio_io.load_wav_mono(cell.path)
        x = audio_io.resample_to_rate(x, in_sr, sr)
        return audio_io.fit_to_duration(x, sr, duration)
    if cell.kind == "py":
        mod = load_py_module(cell.path)
        if mod.generate is None:
            return np.zeros(int(round(duration * sr)), np.float32)
        try:
            import inspect
            if len(inspect.signature(mod.generate).parameters) == 3:
                x = mod.generate(sr, duration, context)
            else:
                x = mod.generate(sr, duration)
        except TypeError:
            x = mod.generate(sr, duration)
        x = audio_io.to_mono(np.asarray(x, np.float32))
        return audio_io.fit_to_duration(x, sr, duration)
    return np.zeros(int(round(duration * sr)), np.float32)


def render_track_pattern(project: GridProject, ti: int, t: Track,
                         divs: List[float], pat_dur: float,
                         sync_pts_master: List[float]) -> np.ndarray:
    """Sum cells at cumulative-start offsets, clip +-1
    (grid_audio_app.py:758-784)."""
    sr = project.sample_rate
    pat_n = max(1, int(round(pat_dur * sr)))
    pat = np.zeros(pat_n, np.float32)
    starts = np.cumsum([0.0] + divs[:-1])
    for ci, (cell, dur, st) in enumerate(zip(t.cells, divs, starts)):
        if cell.kind == "empty":
            continue
        start_samp = int(round(float(st) * sr))
        ctx = {
            "track_index": ti,
            "track_name": t.name,
            "cell_index": ci,
            "cells_total": len(divs),
            "cell_start": float(st),
            "cell_duration": float(dur),
            "track_pattern_duration": float(pat_dur),
            "track_offset": float(t.start_offset_seconds),
            "track_loop_to_master": bool(t.loop_to_master),
            "track_sync_points_master": list(sync_pts_master),
        }
        seg = render_cell_audio(cell, sr, float(dur), ctx)
        end_samp = min(pat_n, start_samp + len(seg))
        if end_samp > start_samp:
            pat[start_samp:end_samp] += seg[:end_samp - start_samp]
    return np.clip(pat, -1.0, 1.0).astype(np.float32, copy=False)


# ---------------------------------------------------------------------------
# Placement: segmented-cumsum phase accumulator (grid_audio_app.py:786-814)
# ---------------------------------------------------------------------------

def placement_indices(n_total: int, pat_n: int, start_offset_seconds: float,
                      sr: int, loop_to_master: bool,
                      speed: Optional[np.ndarray], reset_samples: set,
                      start_idx: Optional[int] = None):
    """Vectorized twin of the reference's per-sample loop: returns
    (idx i64[n_total], valid bool[n_total]) such that
    out[i] = pat[idx[i]] where valid — exact f64 position integration,
    resets via segmented cumulative sums.  With 2**-22-quantized f32
    speeds the f64 accumulation is exact, so results are bit-identical to
    the device kernel's int32 fixed-point positions."""
    if start_idx is None:
        start_idx = int(round(start_offset_seconds * sr))

    # initial phase for negative offsets (:792-798)
    pre_phase = 0.0
    if start_idx < 0:
        prelen = -start_idx
        if speed is None:
            pre_phase = float(prelen)
        else:
            pre_phase = float(np.sum(np.asarray(
                speed[: min(prelen, len(speed))], np.float64)))

    # native sequential twin (exactly the reference loop, ~100x NumPy)
    from ..utils import native_rt
    nat = native_rt.grid_placement(n_total, pat_n, start_idx,
                                   bool(loop_to_master), speed,
                                   set(int(r) for r in reset_samples
                                       if 0 <= r < n_total), pre_phase)
    if nat is not None:
        return nat

    i = np.arange(n_total, dtype=np.int64)

    # increments: speed[i] (or 1.0), accumulated only where local >= 0
    if speed is None:
        inc = np.ones(n_total, np.float64)
    else:
        inc = np.ones(n_total, np.float64)
        m = min(n_total, len(speed))
        inc[:m] = np.asarray(speed[:m], np.float64)
    inc_eff = np.where(i - start_idx >= 0, inc, 0.0)
    C = np.concatenate([[0.0], np.cumsum(inc_eff)])    # C[i] = sum inc[<i]

    resets = np.asarray(sorted(r for r in reset_samples
                               if 0 <= r < n_total), np.int64)
    if resets.size:
        k = np.searchsorted(resets, i, side="right") - 1
        has_reset = k >= 0
        last_reset = np.where(has_reset, resets[np.clip(k, 0, None)], 0)
        base = np.where(has_reset, C[last_reset], 0.0)
        phase = C[i] - base + np.where(has_reset, 0.0, pre_phase)
    else:
        phase = C[i] + pre_phase

    local = i - start_idx
    valid = local >= 0
    if loop_to_master:
        idx = phase.astype(np.int64) % pat_n
    else:
        idx = phase.astype(np.int64)
        # break conditions: local >= pat_n breaks BEFORE reading i;
        # phase+inc >= pat_n breaks AFTER reading i (:799-814)
        stop_before = local >= pat_n
        stop_after = (phase + inc_eff >= pat_n) & valid
        b1 = int(np.argmax(stop_before)) if stop_before.any() else n_total
        b2 = (int(np.argmax(stop_after)) + 1) if stop_after.any() else n_total
        valid = valid & (i < min(b1, b2))
        valid = valid & (idx >= 0) & (idx < pat_n)
    idx = np.clip(idx, 0, pat_n - 1)
    return idx, valid


# ---------------------------------------------------------------------------
# Device table mixdown: ONE jitted kernel reconstructs every track's
# placement on device from compact control tables (resets + static config),
# computes the cross-track mod-speed chain with the envdet twins, gathers
# from the flat pattern bank, and mixes.  Host->device payload per render is
# the pattern bank + O(resets) ints — no per-sample index uploads
# (round-1 review item: the placed-track gather was host-only).
# ---------------------------------------------------------------------------

MIX_PAD = 32768          # render length bucketing (compile-cache reuse)


@dataclass(frozen=True)
class _TrackMeta:
    pat_n: int           # pattern length in samples (0 = silent track)
    base: int            # offset of this track's pattern in the flat bank
    start_idx: int       # start offset in master samples (may be < 0)
    loop: bool
    mod_src: int         # index of mod-source track, -1 = unmodulated
    win: int             # RMS window (samples)
    a_q12: int           # mod amount in 2**-12 units (envdet.amount_q12)
    gain: float          # linear gain, exact f32 value
    n_resets: int = 0    # static reset count (0 = skip the reset window)


@dataclass(frozen=True)
class _MixMeta:
    n_pad: int           # bucketed render length (the jit shape); the true
    #                      n_total is a TRACED scalar so re-rendering at a
    #                      tweaked master length reuses the compiled kernel
    tracks: tuple
    pcm16: bool = False


def _track_positions(i, inc, reset_mask, tm: _TrackMeta, n_total: int):
    """Exclusive segmented fixed-point positions + validity for one track
    (the reference's per-sample phase accumulator, grid_audio_app.py:786-814,
    as exact int32 math).  `inc` is the per-sample speed in 2**-22 units."""
    inc_eff = jnp.where(i >= tm.start_idx, inc, 0)
    shifted = jnp.concatenate([jnp.zeros(1, jnp.int32), inc_eff[:-1]])
    shifted = jnp.where(reset_mask, 0, shifted)

    if tm.start_idx < 0:
        if tm.mod_src >= 0:
            # pre-roll phase = sum of the first prelen increments; the
            # speed array is n_total long, so the reference's
            # np.sum(speed[:prelen]) saturates at n_total increments
            prelen = jnp.minimum(jnp.int32(-tm.start_idx), n_total)
            cw, cf = fixq.segmented_pos_cumsum(
                inc, jnp.zeros_like(reset_mask))
            pre_w, pre_f = cw[prelen - 1], cf[prelen - 1]
        else:
            # unit speed: pre-roll = the FULL -start_idx (uncapped —
            # capping at n_total diverged from the host/reference when the
            # offset preceded the master start by more than its length)
            pre_w, pre_f = jnp.int32(-tm.start_idx), jnp.int32(0)
    else:
        pre_w, pre_f = jnp.int32(0), jnp.int32(0)

    whole, frac = fixq.segmented_pos_cumsum(shifted, reset_mask,
                                            init_whole=pre_w,
                                            init_frac=pre_f)
    local = i - tm.start_idx
    valid = (local >= 0) & (i < n_total)
    if tm.loop:
        idx = jnp.remainder(whole, tm.pat_n)
    else:
        idx = whole
        stop_before = local >= tm.pat_n       # break BEFORE reading i
        wa, _ = fixq.pos_add(whole, frac, inc_eff)
        stop_after = (wa >= tm.pat_n) & valid  # break AFTER reading i
        sb = jnp.cumsum(stop_before.astype(jnp.int32)) > 0
        sa = (jnp.cumsum(stop_after.astype(jnp.int32))
              - stop_after.astype(jnp.int32)) > 0
        valid = valid & ~sb & ~sa & (idx >= 0) & (idx < tm.pat_n)
    return jnp.clip(idx, 0, tm.pat_n - 1), valid


def _mix_body(meta: _MixMeta):
    def run(flat_pat, resets, n_valid):
        """resets: int32 [n_tracks, R_pad], entries >= n_pad are padding;
        n_valid: traced true render length (output beyond it is zero and
        sliced off by the host).  The mod chain runs at the padded length
        with its box sums masked beyond n_valid (envdet.mod_speed_fix
        n_valid), so the max-normalization domain — and every derived
        speed at i < n_valid — is bit-identical to the host twin's
        n_total-length computation."""
        i = jnp.arange(meta.n_pad, dtype=jnp.int32)
        placed_cache = {}
        mix = jnp.zeros(meta.n_pad, jnp.float32)
        mod_srcs = {tm.mod_src for tm in meta.tracks if tm.mod_src >= 0}
        for ti, tm in enumerate(meta.tracks):
            if tm.pat_n <= 0:
                placed = jnp.zeros(meta.n_pad, jnp.float32)
            else:
                if tm.mod_src >= 0:
                    # n_valid masks the padded-tail box sums so the
                    # max-normalization domain matches the host twin's
                    # n_total-length computation exactly
                    inc = envdet.mod_speed_fix(
                        placed_cache[tm.mod_src], tm.win, tm.a_q12,
                        n_valid=n_valid)
                else:
                    inc = jnp.full(meta.n_pad, 1 << fixq.POS_FRAC_BITS,
                                   jnp.int32)
                reset_mask = jnp.zeros(meta.n_pad, jnp.bool_) \
                    .at[resets[ti]].set(True, mode="drop")
                idx, valid = _track_positions(i, inc, reset_mask, tm,
                                              n_valid)
                # the flat bank is gain-premultiplied on the host: a device
                # `gather*gain + mix` would FMA-contract and diverge from
                # the host twin by 1 ulp.  The read itself is the blockwise
                # one-hot matmul kernel (bit-identical to the element
                # gather it replaces): speeds are clipped to [0.25, 4] by
                # envdet, so span=4 bounds every block's window.
                pat = jax.lax.slice(flat_pat, (tm.base,),
                                    (tm.base + tm.pat_n,))
                read = fixq.gather_int_block_onehot(
                    pat, idx, wrap=bool(tm.loop),
                    zero_cover=tm.n_resets > 0)
                placed = jnp.where(valid, read, jnp.float32(0.0))
            if ti in mod_srcs:
                placed_cache[ti] = placed
            mix = mix + placed                 # pinned track order
        mix = jnp.clip(mix, -1.0, 1.0)
        if meta.pcm16:
            # PCM16 device conversion (the reference exports PCM_16 WAVs:
            # soundfile's WAV default subtype) at half the d2h bytes
            return jnp.clip(jnp.round(mix * 32768.0), -32768.0, 32767.0) \
                .astype(jnp.int16)
        return mix

    return run


@functools.lru_cache(maxsize=32)
def _mix_fn(meta: _MixMeta):
    return jax.jit(_mix_body(meta))


def mod_speed_for_track(placed_src: np.ndarray, smoothing_ms: float,
                        amount: float, sr: int) -> np.ndarray:
    """Quantized f32 per-sample speed from a mod-source track's placed
    audio — the envdet twin chain shared bit-for-bit by the host engine,
    the device kernel and the oracle tests (grid_audio_app.py:735-742
    semantics; numerical tolerance documented in ops/envdet.py)."""
    win = max(1, int(round(max(0.0, smoothing_ms) * 0.001 * sr)))
    inc = envdet.mod_speed_fix_np(placed_src, win, envdet.amount_q12(amount))
    return envdet.speed_q_from_fix_np(inc)


def _build_mix_program(project: GridProject):
    """Host pre-pass shared by both engines: restart events, per-track
    patterns, reset tables, and the static placement config."""
    sr = project.sample_rate
    master_dur = project.master.duration(project.tracks)
    n_total = int(round(master_dur * sr))
    restarts = collect_restart_events(project, master_dur)

    rows = []
    for ti, t in enumerate(project.tracks):
        divs = t.build_divisions()
        pat = np.zeros(0, np.float32)
        pat_dur = float(sum(divs)) if divs else 0.0
        sync_pts = parse_float_list(t.sync_points_text)
        if divs and pat_dur > 1e-9:
            t.ensure_cells(len(divs))
            pat = render_track_pattern(project, ti, t, divs, pat_dur,
                                       sync_pts)
        reset = set(int(round(p * sr)) for p in sync_pts if p >= 0.0)
        reset |= restarts[ti]
        reset = np.asarray(sorted(r for r in reset if 0 <= r < n_total),
                           np.int32)
        modded = (t.mod_source_index >= 0 and t.mod_amount > 0
                  and t.mod_source_index < ti and len(pat) > 0)
        rows.append({
            "pat": pat,
            "start_idx": int(round(t.start_offset_seconds * sr)),
            "loop": bool(t.loop_to_master),
            "resets": reset,
            "mod_src": int(t.mod_source_index) if modded else -1,
            "win": max(1, min(n_total,
                              int(round(max(0.0, t.mod_smoothing_ms)
                                        * 0.001 * sr)))),
            "a_q12": envdet.amount_q12(t.mod_amount) if modded else 0,
            "gain": float(np.float32(10.0 ** (float(t.gain_db) / 20.0))),
        })
    return n_total, rows


def _host_mixdown(n_total: int, rows: list, return_tracks: bool):
    """Host engine: exact integer placement via placement_indices (f64
    accumulation of 2**-22-quantized speeds is exact, so it matches the
    device kernel's int32 positions bit-for-bit), host gather + mix."""
    placed_tracks: List[np.ndarray] = []
    mix = np.zeros(n_total, np.float32)
    for row in rows:
        pat = row["pat"]
        if len(pat) == 0:
            placed_tracks.append(np.zeros(n_total, np.float32))
            continue
        speed = None
        if row["mod_src"] >= 0:
            inc = envdet.mod_speed_fix_np(placed_tracks[row["mod_src"]],
                                          row["win"], row["a_q12"])
            speed = envdet.speed_q_from_fix_np(inc)
        idx, valid = placement_indices(
            n_total, len(pat), 0.0, 1, row["loop"], speed,
            set(int(r) for r in row["resets"]), start_idx=row["start_idx"])
        placed = np.where(valid, pat[idx], 0.0).astype(np.float32) \
            * np.float32(row["gain"])
        placed_tracks.append(placed)
        mix = mix + placed                     # pinned track order
    mix = np.clip(mix, -1.0, 1.0).astype(np.float32)
    return (mix, placed_tracks) if return_tracks else (mix, None)


_BANK_CACHE: "OrderedDict[bytes, object]" = None


def _bank_device_cached(flat_pat: np.ndarray):
    """Device-side pattern-bank cache keyed on content hash: re-renders of
    an unchanged project (the tweak-and-rerender loop) ship only the
    KB-scale reset tables instead of re-uploading MBs of pattern audio.
    Bounded at 8 banks, least-recently-used evicted."""
    global _BANK_CACHE
    import hashlib
    from collections import OrderedDict
    if _BANK_CACHE is None:
        _BANK_CACHE = OrderedDict()
    key = hashlib.blake2b(flat_pat.view(np.uint8), digest_size=16).digest()
    dev = _BANK_CACHE.pop(key, None)
    if dev is None:
        dev = jax.device_put(jnp.asarray(flat_pat))
    _BANK_CACHE[key] = dev
    while len(_BANK_CACHE) > 8:
        _BANK_CACHE.popitem(last=False)
    return dev


@dataclass(frozen=True)
class _PreparedMix:
    """Host pre-pass product for the device engine: static meta + the
    device-resident bank + reset tables.  Build once (prepare_device_mix),
    re-dispatch many times — the bank concat/pad/content-hash cost ~6 ms
    per call for the 4-track bench project, dwarfing the kernel itself."""
    meta: "_MixMeta"
    flat_pat: object      # device array (bank, gain-premultiplied)
    resets: object        # int32 [n_tracks, r_cap]


def prepare_device_mix(n_total: int, rows: list,
                       pcm16: bool = False) -> _PreparedMix:
    n_pad = -(-max(1, n_total) // MIX_PAD) * MIX_PAD
    bases, flat, metas = [], [], []
    off = 0
    for row in rows:
        bases.append(off)
        flat.append(row["pat"] * np.float32(row["gain"]))
        off += len(row["pat"])
    flat_pat = (np.concatenate(flat).astype(np.float32)
                if off else np.zeros(1, np.float32))
    # pad the bank to a power of two (compile-cache bucketing); base offsets
    # are static meta so padding never aliases into a real pattern
    cap = 1 << max(4, int(np.ceil(np.log2(max(2, flat_pat.size)))))
    flat_pat = np.pad(flat_pat, (0, cap - flat_pat.size))
    flat_pat = _bank_device_cached(flat_pat)

    r_max = max([len(r["resets"]) for r in rows] + [1])
    r_cap = 1 << int(np.ceil(np.log2(max(2, r_max))))
    resets = np.full((len(rows), r_cap), n_pad, np.int32)
    for ti, row in enumerate(rows):
        resets[ti, :len(row["resets"])] = row["resets"]

    for ti, row in enumerate(rows):
        metas.append(_TrackMeta(
            pat_n=len(row["pat"]), base=bases[ti],
            start_idx=row["start_idx"], loop=row["loop"],
            mod_src=row["mod_src"], win=row["win"], a_q12=row["a_q12"],
            gain=row["gain"], n_resets=len(row["resets"])))
    meta = _MixMeta(n_pad=n_pad, tracks=tuple(metas), pcm16=pcm16)
    return _PreparedMix(meta=meta, flat_pat=flat_pat, resets=resets)


def _device_mixdown(n_total: int, rows: list, device_out: bool = False,
                    pcm16: bool = False, prepared: _PreparedMix = None):
    """Device engine: flat pattern bank + reset tables -> one jit call."""
    prep = prepared if prepared is not None \
        else prepare_device_mix(n_total, rows, pcm16)
    y = _mix_fn(prep.meta)(prep.flat_pat, prep.resets, np.int32(n_total))
    if device_out:
        return y          # padded to n_pad (zero tail); compute-only use
    return chunked_pull(y, n_total)


_PROGRAM_CACHE: "OrderedDict" = None


def _project_cache_key(project: GridProject) -> bytes:
    """Content hash of everything _build_mix_program reads: the full
    project dict plus (path, mtime_ns, size) of every referenced cell
    file — the same invalidation contract as plugins.host's module cache,
    so editing a user script on disk rebuilds on the next render."""
    import hashlib
    import json as _json
    import os as _os
    h = hashlib.blake2b(digest_size=16)
    h.update(_json.dumps(project_to_dict(project), sort_keys=True).encode())
    for t in project.tracks:
        for c in t.cells:
            if c.kind in ("py", "wav") and c.path:
                try:
                    st = _os.stat(c.path)
                    h.update(f"{c.path}:{st.st_mtime_ns}:{st.st_size}"
                             .encode())
                except OSError:
                    h.update(f"{c.path}:missing".encode())
    return h.digest()


def build_mix_program_cached(project: GridProject):
    """_build_mix_program memoized on project content (the host pre-pass — user-script cell rendering, pattern
    assembly, restart resolution — was paid on every render of an
    UNCHANGED project).  Returns (n_total, rows, prepared_mix); the
    prepared device mix (bank upload + reset tables, ~12 ms) rides the
    same entry.  LRU-bounded at 4 projects."""
    global _PROGRAM_CACHE
    from collections import OrderedDict
    if _PROGRAM_CACHE is None:
        _PROGRAM_CACHE = OrderedDict()
    key = _project_cache_key(project)
    entry = _PROGRAM_CACHE.pop(key, None)
    if entry is None:
        n_total, rows = _build_mix_program(project)
        entry = {"n_total": n_total, "rows": rows, "prep": {}}
    _PROGRAM_CACHE[key] = entry
    while len(_PROGRAM_CACHE) > 4:
        _PROGRAM_CACHE.popitem(last=False)
    return entry


def render_mixdown(project: GridProject,
                   return_tracks: bool = False,
                   engine: str = "device",
                   pcm16: bool = False):
    """Full mixdown (grid_audio_app.py:708-756): restart pre-pass ->
    per-track pattern -> mod-speed envelope -> reset-aware placement ->
    gain -> sum -> clip (+ optional 0.98 peak normalize).

    engine="device" (default): the whole placement + mod chain + mix runs
    as ONE jitted kernel from compact tables.  engine="host": NumPy twin
    (exact same integers/floats; the measured fallback and the
    cross-validation path).  return_tracks always uses the host twin since
    it materializes every placed track anyway.

    pcm16=True (device engine only, incompatible with project.normalize):
    int16 PCM conversion on device — the reference exports PCM_16 WAVs
    anyway (soundfile's default) and the pull is half the bytes."""
    entry = build_mix_program_cached(project)
    n_total, rows = entry["n_total"], entry["rows"]

    if engine == "device" and not return_tracks:
        want_pcm16 = pcm16 and not project.normalize
        prep = entry["prep"].get(want_pcm16)
        if prep is None:
            prep = prepare_device_mix(n_total, rows, pcm16=want_pcm16)
            entry["prep"][want_pcm16] = prep
        if want_pcm16:
            return _device_mixdown(n_total, rows, pcm16=True, prepared=prep)
        mix = _device_mixdown(n_total, rows, prepared=prep)
        placed_tracks = None
    else:
        mix, placed_tracks = _host_mixdown(n_total, rows, True)

    if project.normalize:
        peak = float(np.max(np.abs(mix))) if mix.size else 0.0
        if peak > 1e-12:
            mix = (mix * (0.98 / peak)).astype(np.float32)

    if return_tracks:
        return mix, placed_tracks
    return mix


def export_wav(project: GridProject, path: str) -> np.ndarray:
    """Render + save (grid_audio_app.py:579-598)."""
    mix = render_mixdown(project)
    audio_io.write_wav(path, mix, project.sample_rate)
    return mix


# ---------------------------------------------------------------------------
# Project JSON I/O (the framework's config-file replacement for the UI)
# ---------------------------------------------------------------------------

def project_to_dict(project: GridProject) -> dict:
    import dataclasses
    return {
        "sample_rate": project.sample_rate,
        "normalize": project.normalize,
        "master": {"mode": project.master.mode,
                   "fixed_seconds": project.master.fixed_seconds},
        "tracks": [
            {**{k: v for k, v in dataclasses.asdict(t).items()
                if k != "cells"},
             "cells": [{"kind": c.kind, "path": c.path} for c in t.cells]}
            for t in project.tracks],
    }


def project_from_dict(d: dict) -> GridProject:
    tracks = []
    for td in d.get("tracks", []):
        cells = [CellSource(c.get("kind", "empty"), c.get("path", ""))
                 for c in td.get("cells", [])]
        kw = {k: v for k, v in td.items()
              if k in Track.__dataclass_fields__ and k != "cells"}
        tracks.append(Track(cells=cells, **kw))
    m = d.get("master", {})
    return GridProject(
        tracks=tracks,
        master=MasterClock(m.get("mode", "auto"),
                           m.get("fixed_seconds", 16.0)),
        sample_rate=int(d.get("sample_rate", 44100)),
        normalize=bool(d.get("normalize", False)))


def load_project(path: str) -> GridProject:
    import json
    import os
    with open(path) as f:
        project = project_from_dict(json.load(f))
    base = os.path.dirname(os.path.abspath(path))
    for t in project.tracks:
        for c in t.cells:
            if c.path and not os.path.isabs(c.path):
                c.path = os.path.normpath(os.path.join(base, c.path))
    return project


def save_project(project: GridProject, path: str):
    import json
    with open(path, "w") as f:
        json.dump(project_to_dict(project), f, indent=2)
