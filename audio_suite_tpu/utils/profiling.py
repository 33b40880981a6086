"""Render observability (SURVEY.md §5 tracing/profiling): per-render meta
(peak dBFS, realtime factor, duration) and a stage timer.

The reference's only instrumentation is progress callbacks
(microsound_0.2.1/main_v2.py:599-600,757-758 — kept by the engines); the
framework's first-class metric is audio-seconds rendered per wall second
(BASELINE.json), so every CLI render reports it.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np


def peak_dbfs(audio) -> float:
    m = float(np.max(np.abs(np.asarray(audio)))) if np.size(audio) else 0.0
    if m <= 0:
        return float("-inf")
    return 20.0 * float(np.log10(m))


def render_meta(audio, sample_rate: int, wall_seconds: float) -> dict:
    audio = np.asarray(audio)
    dur = audio.shape[0] / float(sample_rate)
    return {
        "seconds": round(dur, 6),
        "sample_rate": int(sample_rate),
        "peak_dbfs": round(peak_dbfs(audio), 2),
        "wall_s": round(wall_seconds, 4),
        "rtf": round(dur / wall_seconds, 2) if wall_seconds > 0 else None,
    }


class StageTimer:
    """Named wall-clock stages; `report()` gives an ordered dict."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) \
                + time.perf_counter() - t0

    def report(self) -> dict:
        return {k: round(v, 4) for k, v in self.stages.items()}


@contextmanager
def device_trace(trace_dir: str | None):
    """Capture a jax.profiler device trace into `trace_dir` (TensorBoard /
    Perfetto format — xplane.pb + trace.json.gz under plugins/profile/).

    The SURVEY §5 tracing requirement beyond wall-clock stages: per-op
    device timelines for the jitted render kernels.  No-op when trace_dir
    is falsy, so callers can thread a CLI flag straight through.  Adds a
    block_until_ready-style sync on exit only implicitly via profiler
    stop; callers timing the same region should treat traced runs as
    non-representative (tracing adds overhead)."""
    if not trace_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(str(trace_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """jax.profiler.TraceAnnotation context: labels a host-side region so
    it shows up on the captured timeline alongside device ops."""
    import jax

    return jax.profiler.TraceAnnotation(name)
