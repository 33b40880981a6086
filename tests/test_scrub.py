"""Scrubber engine vs. NumPy oracle."""
import numpy as np
import pytest

from audio_suite_tpu.models import scrub
from audio_suite_tpu.models.scrub import ScrubConfig, GestureTrace
from audio_suite_tpu.utils.metrics import max_dev_dbfs
from oracles.scrub_ref import render_scrub_np


@pytest.fixture(scope="module")
def audio():
    sr = 44100
    rng = np.random.default_rng(3)
    t = np.arange(sr * 2) / sr
    x = 0.6 * np.sin(2 * np.pi * 330 * t) + 0.2 * rng.standard_normal(t.size)
    return (x / np.max(np.abs(x))).astype(np.float32)


def run_both(audio, cfg, trace, pos0=0.0):
    prog = scrub.build_scrub_program(audio, cfg, trace, pos0,
                                     with_inc=True)
    ref = render_scrub_np(prog)
    out = scrub.render_scrub(audio, cfg, trace, pos0)
    return out, ref


def test_forward_play_parity(audio):
    cfg = ScrubConfig(sample_rate=44100, seed=11)
    trace = scrub.constant_trace(40, base_speed=1.0)
    out, ref = run_both(audio, cfg, trace)
    assert max_dev_dbfs(out, ref) <= -60.0
    assert np.max(np.abs(out)) > 0.1


def test_reverse_and_gesture_parity(audio):
    cfg = ScrubConfig(sample_rate=44100, seed=5, head_count=2)
    trace = scrub.scripted_gesture_trace(
        60, 44100, drag_events=[(0.2, 4.0, 0.3), (0.8, -6.0, 0.2)],
        base_speed=-0.5, jumps=[(0.7, 20000.0)])
    out, ref = run_both(audio, cfg, trace, pos0=30000.0)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_single_head(audio):
    cfg = ScrubConfig(sample_rate=44100, seed=8, head_count=1)
    trace = scrub.constant_trace(20, base_speed=0.25)
    out, ref = run_both(audio, cfg, trace)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_dropouts_gate_blocks(audio):
    """With a seed that triggers dropouts, some blocks are attenuated by
    exactly 1-0.35 relative to a no-dropout render."""
    cfg = ScrubConfig(sample_rate=44100, seed=0, dropouts=True,
                      stretch_jitter=False)
    cfg_off = ScrubConfig(sample_rate=44100, seed=0, dropouts=False,
                          stretch_jitter=False)
    nb = 400
    trace = scrub.constant_trace(nb, base_speed=1.0)
    prog = scrub.build_scrub_program(audio, cfg, trace)
    env = prog["env_blocks"]
    assert np.any(env < 1.0), "seed should trigger at least one dropout"
    out_on = scrub.render_scrub(audio, cfg, trace)
    out_off = scrub.render_scrub(audio, cfg_off, trace)
    b = int(np.argmax(env < 1.0))
    sl = slice(b * cfg.block_size, (b + 1) * cfg.block_size)
    ratio = out_on[sl] / np.where(np.abs(out_off[sl]) < 1e-9, 1, out_off[sl])
    mask = np.abs(out_off[sl]) > 1e-3
    assert np.allclose(ratio[mask], 1.0 - scrub.DROPOUT_DEPTH, atol=1e-5)


def test_speed_clamp():
    """Gesture speeds beyond MAX_TAPE_SPEED are clamped
    (scrubber_0.7.py:175-176)."""
    cfg = ScrubConfig(sample_rate=44100, seed=1, stretch_jitter=False,
                      dropouts=False)
    trace = scrub.constant_trace(4, base_speed=1.0, gesture=1e9)
    audio = np.sin(np.linspace(0, 100, 44100)).astype(np.float32)
    prog = scrub.build_scrub_program(audio, cfg, trace,
                                     with_inc=True)
    max_inc = np.max(np.abs(prog["inc_fix"])) / scrub.fixq.POS_ONE
    assert max_inc <= (scrub.MAX_TAPE_SPEED / 44100) * 1.01


def test_head_offset_semantics():
    """A head at offset +2000 must actually read 2000 samples ahead —
    regression for int32 overflow when packing large offsets."""
    sr = 44100
    audio = np.zeros(sr, np.float32)
    audio[10000] = 1.0
    cfg = ScrubConfig(sample_rate=sr, seed=1, head_count=1,
                      head_offsets=(0.0, 2000.0, 0.0),
                      stretch_jitter=False, dropouts=False)
    trace = scrub.constant_trace(30, base_speed=0.5)
    out = scrub.render_scrub(audio, cfg, trace, tape_pos0=0.0)
    # head reads pos+2000: impulse at 10000 is hit when pos = 8000, i.e. at
    # output sample ~8000 / inc where inc = 0.5 (sub-MAX speed, no clamping)
    peak = int(np.argmax(np.abs(out)))
    assert abs(peak - 16000) < 300  # wow/flutter detunes by up to ~0.8%


def test_friction_decay():
    """Gesture speed decays by ~0.93 per GUI frame when not dragging
    (scrubber_0.7.py:270-271)."""
    trace = scrub.scripted_gesture_trace(
        200, 44100, drag_events=[(0.0, 5.0, 0.1)], base_speed=0.0)
    g = trace.gesture_speed
    peak = np.max(np.abs(g))
    assert peak > 0
    assert abs(g[-1]) < peak * 0.01  # decayed to ~nothing


def test_live_head_control_parity(audio):
    """Live control events (keys 1/2/3 head count, Z/X C/V B/N offset
    nudges, R reset, Up/Down base speed — scrubber_0.7.py:320-361) rendered
    with per-segment reads must match the oracle."""
    cfg = ScrubConfig(sample_rate=44100, seed=21)
    trace = scrub.scripted_gesture_trace(
        80, 44100, drag_events=[(0.3, 5.0, 0.4)], base_speed=0.5,
        jumps=[(1.2, 15000.0)],
        key_events=[(0.2, "2"), (0.5, "Z"), (0.5, "Z"), (0.8, "1"),
                    (1.0, "V"), (1.3, "3"), (1.5, "R"), (1.6, "Down")])
    assert trace.head_count is not None
    out, ref = run_both(audio, cfg, trace, pos0=5000.0)
    assert max_dev_dbfs(out, ref) <= -60.0
    # the trace must actually produce several control segments
    prog = scrub.build_scrub_program(audio, cfg, trace, 5000.0)
    assert len(prog["head_segments"]) >= 5


def test_live_head_count_switch_semantics(audio):
    """Blocks before a '1' key mix 3 heads, blocks after read only the
    center head — check against static-config renders of the same
    positions."""
    sr = 44100
    cfg = ScrubConfig(sample_rate=sr, seed=7, stretch_jitter=False,
                      dropouts=False)
    nb = 30
    switch_b = 14
    switch_sec = switch_b * cfg.block_size / sr
    trace = scrub.scripted_gesture_trace(
        nb, sr, base_speed=1.0, key_events=[(switch_sec, "1")])
    out = scrub.render_scrub(audio, cfg, trace)
    # static 3-head and 1-head renders with the SAME gesture trace
    t_static = scrub.scripted_gesture_trace(nb, sr, base_speed=1.0)
    out3 = scrub.render_scrub(audio, ScrubConfig(
        sample_rate=sr, seed=7, head_count=3, stretch_jitter=False,
        dropouts=False), t_static)
    out1 = scrub.render_scrub(audio, ScrubConfig(
        sample_rate=sr, seed=7, head_count=1, stretch_jitter=False,
        dropouts=False), t_static)
    cut = switch_b * cfg.block_size
    assert max_dev_dbfs(out[:cut], out3[:cut]) <= -120.0
    assert max_dev_dbfs(out[cut:], out1[cut:]) <= -120.0


def test_live_offset_nudge_moves_read_head():
    """Nudging head 2's offset (+200 x5 via V) shifts where the center
    head reads from."""
    sr = 44100
    audio = np.zeros(sr, np.float32)
    audio[12000] = 1.0
    cfg = ScrubConfig(sample_rate=sr, seed=1, head_count=1,
                      head_offsets=(0.0, 0.0, 0.0),
                      stretch_jitter=False, dropouts=False)
    nb = 30
    trace = scrub.scripted_gesture_trace(
        nb, sr, base_speed=0.5,
        key_events=[(0.0, "1")] + [(0.0, "V")] * 5)
    out = scrub.render_scrub(audio, cfg, trace)
    # center head offset 1000: impulse hit when pos = 11000, inc = 0.5
    peak = int(np.argmax(np.abs(out)))
    assert abs(peak - 22000) < 300


def test_device_increment_twin_bit_exact(audio):
    """The on-device increment synthesis must equal the NumPy twin the
    oracle consumes, bit for bit."""
    import jax
    from audio_suite_tpu.models.scrub import _inc_device, _inc_np, _mod_consts
    import jax.numpy as jnp

    sr = 44100
    nb, bs = 37, 1024
    rng = np.random.default_rng(0)
    base = scrub.fixq.round_sig12_np(
        rng.uniform(-0.9, 0.9, nb).astype(np.float32)) \
        if hasattr(scrub, "fixq") else None
    from audio_suite_tpu.ops.fixq import round_sig12_np
    base = round_sig12_np(rng.uniform(-0.9, 0.9, nb).astype(np.float32))
    js = round_sig12_np(rng.uniform(0, 0.007, nb).astype(np.float32))
    c = _mod_consts(sr)
    a = _inc_np(base, js, 42, bs, c)
    cj = (jnp.asarray(c["ints"]), jnp.asarray(c["flts"]))
    b = np.asarray(jax.jit(
        lambda: _inc_device(jnp.asarray(base), jnp.asarray(js),
                            np.uint32(42), bs, cj))())
    assert np.array_equal(a, b)
