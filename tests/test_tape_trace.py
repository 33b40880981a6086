"""TapeTrace performance automation.

The reference TapeTUC is an instrument: the user mutates speeds/markers/
toggles DURING playback under the RLock (Tape…py:768-788) and the recording
captures the performance (Tape…py:902-909).  These tests drive the trace
renderer (segmented table programs with carried position/speed/splice state)
against the sequential NumPy oracle rendering the same segment programs with
carried state.
"""
import numpy as np
import pytest

from audio_suite_tpu.models import tape as T
from audio_suite_tpu.ops import fixq
from audio_suite_tpu.utils import io as audio_io
from oracles.tape_ref import render_tape_np


def dbfs(err, ref):
    peak = float(np.max(np.abs(ref))) if np.size(ref) else 1.0
    e = float(np.max(np.abs(err))) if np.size(err) else 0.0
    if e == 0.0:
        return -200.0
    return 20.0 * np.log10(e / max(peak, 1e-12))


SR = 8000


def _tape(n=SR * 2, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.5 * np.sin(2 * np.pi * 180 * t)
         + 0.2 * np.sin(2 * np.pi * 733 * t)
         + 0.05 * rng.standard_normal(n))
    return np.asarray(x, np.float32)


def _perf_trace():
    """A dense performance touching every op family."""
    tr = T.TapeTrace()
    tr.add(0.20, "set_speed", section=0, value=1.7)
    tr.add(0.45, "set_reverse", section=1, value=True)
    tr.add(0.70, "set_age", value=95)
    tr.add(0.90, "add_marker", sample=SR // 2)
    tr.add(1.10, "set_inertia", value=True)
    tr.add(1.15, "set_inertia_amount", value=80)
    tr.add(1.40, "set_splice", value=False)
    tr.add(1.55, "set_splice", value=True)
    tr.add(1.80, "seek", sample=100)
    tr.add(2.05, "set_anticlick_amount", value=90)
    tr.add(2.30, "remove_marker", sample=SR // 2)
    tr.add(2.60, "retime", target=1.2)
    return tr


def _oracle_trace_render(audio, params, trace, num_frames):
    """Sequential oracle: render each segment program with carried state,
    asserting the oracle's own position carry matches the engine's."""
    segs = T.build_trace_programs(audio, params, trace, num_frames)
    rem, sidx = 0, 0
    outs = []
    for k, s in enumerate(segs):
        # the engine's init state must equal the oracle's carry
        if k > 0:
            assert s["init_whole"] == prev_state["whole"] or seeked[k], \
                f"segment {k} whole carry diverged"
            assert s["init_frac"] == prev_state["frac"] or seeked[k]
        out, st = render_tape_np(
            s, init={"whole": s["init_whole"], "frac": s["init_frac"],
                     "rem": rem, "sidx": sidx},
            return_state=True)
        rem, sidx = st["rem"], st["sidx"]
        prev_state = st
        outs.append(out)
    return np.concatenate(outs) if outs else np.zeros(0, np.float32)


# which segments start with a seek (engine init intentionally != carry)
def _seek_flags(params, trace, sr, T_total):
    times = sorted({max(0, int(round(float(e["t"]) * sr)))
                    for e in trace.events
                    if int(round(float(e["t"]) * sr)) < T_total})
    edges = [0] + [t for t in times if t > 0]
    seek_t = {int(round(float(e["t"]) * sr)) for e in trace.events
              if e["op"] == "seek"}
    return [t in seek_t for t in edges]


seeked = []


def test_trace_parity_vs_oracle():
    global seeked
    audio = _tape()
    p = T.TapeParams(sample_rate=SR, markers=[3000, 9000],
                     section_speeds=[1.0, 0.5, 2.0],
                     section_reverse=[False, False, True],
                     tape_age=40, inertia_enabled=False,
                     current_speed=1.0)
    tr = _perf_trace()
    nf = SR * 3
    seeked = _seek_flags(p, tr, SR, nf)
    ref = _oracle_trace_render(audio, p, tr, nf)
    got = T.render_tape_trace(audio, p, tr, num_frames=nf)
    assert got.shape == ref.shape == (nf,)
    d = dbfs(got - ref, ref)
    assert d <= -120.0, f"trace parity {d:.1f} dBFS"


def test_trace_splice_freeze_across_segments():
    """An envelope interrupted by a splice-off segment must RESUME (frozen
    rem/sidx) when splice turns back on — reference per-sample gate
    semantics (Tape…py:851-858)."""
    global seeked
    audio = _tape(n=SR)
    # boundary at 0 triggers an envelope immediately (idx0 == 0 at start);
    # toggle splice off 100 samples in, back on 60 samples later
    p = T.TapeParams(sample_rate=SR, markers=[SR // 2],
                     section_speeds=[1.0, 1.0], tape_age=0,
                     anticlick_enabled=False)
    tr = T.TapeTrace()
    tr.add(100 / SR, "set_splice", value=False)
    tr.add(160 / SR, "set_splice", value=True)
    nf = 600
    seeked = _seek_flags(p, tr, SR, nf)
    ref = _oracle_trace_render(audio, p, tr, nf)
    got = T.render_tape_trace(audio, p, tr, num_frames=nf)
    d = dbfs(got - ref, ref)
    assert d <= -120.0, f"splice freeze parity {d:.1f} dBFS"
    # the envelope must actually bridge the gap: samples right after
    # splice-on resume mid-envelope (gain > 1 region persists)
    base = T.render_tape_trace(audio,
                               T.TapeParams(sample_rate=SR,
                                            markers=[SR // 2],
                                            section_speeds=[1.0, 1.0],
                                            tape_age=0,
                                            anticlick_enabled=False,
                                            enable_splice_fx=False),
                               T.TapeTrace(), num_frames=nf)
    resumed = got[160:240]
    plain = base[160:240]
    assert np.max(np.abs(resumed - plain)) > 0, \
        "envelope did not resume after the splice-off gap"


def test_trace_deterministic_and_json_roundtrip():
    audio = _tape(n=SR)
    p = T.TapeParams(sample_rate=SR, markers=[2000],
                     section_speeds=[1.3, 0.7])
    tr = _perf_trace()
    txt = tr.to_json()
    tr2 = T.TapeTrace.from_json(txt)
    assert tr2.events == tr.events
    a = T.render_tape_trace(audio, p, tr, num_frames=SR)
    b = T.render_tape_trace(audio, p, tr2, num_frames=SR)
    np.testing.assert_array_equal(a, b)


def test_trace_record_reload_midtrace(tmp_path):
    """The record->reload loop (Tape…py:902-909, 347-386): render the first
    part of a performance, save it as the recording, reload it as the new
    tape source, and continue performing on it."""
    audio = _tape(n=SR)
    p = T.TapeParams(sample_rate=SR, markers=[3000],
                     section_speeds=[1.0, 1.5])
    part_a = T.TapeTrace()
    part_a.add(0.25, "set_speed", section=1, value=0.5)
    out_a, st = T.render_tape_trace(audio, p, part_a, num_frames=SR,
                                    return_state=True)
    wav = str(tmp_path / "rec.wav")
    audio_io.write_wav(wav, out_a, SR, subtype="PCM_16")
    tape2, sr2 = audio_io.load_wav_mono(wav)
    assert sr2 == SR and len(tape2) == len(out_a)

    # continue the performance on the recorded tape
    p2 = T.TapeParams(sample_rate=SR)
    part_b = T.TapeTrace()
    part_b.add(0.10, "set_reverse", section=0, value=True)
    out_b = T.render_tape_trace(tape2, p2, part_b, num_frames=SR // 2)
    assert out_b.shape == (SR // 2,)
    assert np.isfinite(out_b).all() and np.max(np.abs(out_b)) > 0.01


def test_trace_speed_carry_is_engine_final():
    """return_state's speed equals the quantized table-builder carry."""
    audio = _tape(n=SR)
    p = T.TapeParams(sample_rate=SR, inertia_enabled=True,
                     inertia_amount=70, current_speed=2.0,
                     markers=[4000], section_speeds=[0.5, 1.0])
    tr = T.TapeTrace()
    tr.add(0.3, "set_speed", section=0, value=3.0)
    out, st = T.render_tape_trace(audio, p, tr, num_frames=SR,
                                  return_state=True)
    assert out.shape == (SR,)
    # speed lives on the 2^-22 grid
    q = float(fixq.quantize_f32_np(np.float32(st["speed"])))
    assert q == st["speed"]


def test_trace_empty_is_plain_render():
    """A trace with no events must equal render_tape exactly."""
    audio = _tape(n=SR)
    p = T.TapeParams(sample_rate=SR, markers=[2500],
                     section_speeds=[1.0, 1.25],
                     section_reverse=[False, True], tape_age=60)
    nf = SR
    a = T.render_tape_trace(audio, p, T.TapeTrace(), num_frames=nf)
    b = T.render_tape(audio, p, num_frames=nf)
    np.testing.assert_array_equal(a, b)
