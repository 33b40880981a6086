"""The shipped content library must actually render:
every grid cell, pattern-lab generator script, microsound preset and IR in
examples/ is exercised here without touching /root/reference."""
import glob
import json
import os

import numpy as np
import pytest

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "examples")


# ---------------------------------------------------------------------------
# Grid cells
# ---------------------------------------------------------------------------

CELLS = sorted(glob.glob(os.path.join(EX, "cells", "*.py")))


def test_cell_library_is_complete():
    assert len(CELLS) >= 12, [os.path.basename(c) for c in CELLS]


@pytest.mark.parametrize("path", CELLS,
                         ids=[os.path.basename(c) for c in CELLS])
def test_cell_contract(path):
    from audio_suite_tpu.plugins.host import load_py_module
    mod = load_py_module(path)
    ctx = {
        "track_index": 1, "track_name": "t", "cell_index": 2,
        "cells_total": 8, "cell_start": 1.0, "cell_duration": 0.5,
        "track_pattern_duration": 4.0, "track_offset": 0.0,
        "track_loop_to_master": True,
        "track_sync_points_master": [2.0, 5.0],
        "master_time": 1.0, "master_duration": 8.0,
        "tracks": [{"index": i, "name": f"t{i}"} for i in range(3)],
    }
    produced = False
    if mod.generate is not None:
        import inspect
        sr, dur = 22050, 0.25
        nargs = len(inspect.signature(mod.generate).parameters)
        y = mod.generate(sr, dur, ctx) if nargs == 3 else mod.generate(sr, dur)
        y = np.asarray(y, np.float32)
        assert y.ndim == 1 and y.size > 0
        assert np.isfinite(y).all()
        assert float(np.max(np.abs(y))) > 1e-4, "silent cell"
        produced = True
    if mod.event is not None:
        ev = mod.event(ctx)
        assert isinstance(ev, dict)
        produced = True
    assert produced


def test_grid_showcase_project_renders():
    from audio_suite_tpu.models import grid
    project = grid.load_project(os.path.join(EX, "grid_showcase.json"))
    mix = grid.render_mixdown(project)
    n = int(12.0 * project.sample_rate)
    assert mix.shape == (n,)
    assert np.isfinite(mix).all()
    assert float(np.max(np.abs(mix))) > 0.05
    # the showcase includes restart-event cells; they must actually resolve
    restarts = grid.collect_restart_events(
        project, project.master.duration(project.tracks))
    assert any(len(v) for v in restarts), \
        "no restart events resolved from the showcase project"


def test_restart_count_inference_mutates_output():
    """The sync_mutating_lattice / restart_handshake family must actually
    RESPOND to sync-point projection (restart_mutating_euclid.py:16-56
    technique): different sync layouts -> different inferred restart index
    -> different audio / event delay."""
    from audio_suite_tpu.plugins.host import load_py_module
    base_ctx = {
        "track_index": 2, "cell_index": 1, "cells_total": 4,
        "cell_start": 1.0, "cell_duration": 1.0,
        "track_pattern_duration": 4.0, "track_offset": 0.0,
        "tracks": [{"index": i, "name": f"t{i}"} for i in range(3)],
    }
    lat = load_py_module(os.path.join(EX, "cells", "sync_mutating_lattice.py"))
    a = lat.generate(22050, 0.5, dict(base_ctx, track_sync_points_master=[]))
    b = lat.generate(22050, 0.5, dict(base_ctx,
                                      track_sync_points_master=[1.2, 5.2]))
    assert np.max(np.abs(np.asarray(a) - np.asarray(b))) > 1e-3, \
        "sync points did not mutate the lattice"

    hs = load_py_module(os.path.join(EX, "cells", "restart_handshake.py"))
    ev0 = hs.event(dict(base_ctx, track_sync_points_master=[]))
    ev2 = hs.event(dict(base_ctx, track_sync_points_master=[0.5, 4.5]))
    assert ev0["restart_tracks"] == [1] and ev0["delay"] == 0.0
    assert ev2["restart_tracks"] == [1] and ev2["delay"] > 0.0


# ---------------------------------------------------------------------------
# Pattern Lab generator scripts
# ---------------------------------------------------------------------------

PATTERNS = sorted(glob.glob(os.path.join(EX, "patterns", "*.py")))


def test_pattern_library_is_complete():
    assert len(PATTERNS) >= 3


@pytest.mark.parametrize("path", PATTERNS,
                         ids=[os.path.basename(p) for p in PATTERNS])
def test_pattern_script_renders(path):
    from audio_suite_tpu.models import patternlab as pl
    cfg = pl.RenderConfig(sample_rate=22050, seconds=2.0, bpm=120, seed=3)
    events = pl.generate("Python Script", cfg, script_path=path)
    assert len(events) > 0
    y, _ = pl.render(events, cfg)
    assert y.shape == (int(2.0 * 22050),)
    assert float(np.max(np.abs(y))) > 0.01


# ---------------------------------------------------------------------------
# Microsound presets + IR bank
# ---------------------------------------------------------------------------

PRESETS = sorted(glob.glob(os.path.join(EX, "presets", "*.json")))
IRS = sorted(glob.glob(os.path.join(EX, "irs", "*.wav")))


def test_preset_and_ir_banks_are_complete():
    assert len(PRESETS) >= 4
    assert len(IRS) >= 2


@pytest.mark.parametrize("path", PRESETS,
                         ids=[os.path.basename(p) for p in PRESETS])
def test_microsound_preset_renders(path):
    from audio_suite_tpu.models import microsound as ms
    from audio_suite_tpu.utils import wavcodec
    with open(path) as f:
        d = json.load(f)
    # shrink for test runtime; keeps every engine path the preset selects
    d.update(base_sr=16000, out_dur_s=0.5, max_grains=48,
             er_taps=min(64, int(d.get("er_taps", 64))))
    p = ms.MicrosoundParams.from_dict(d)
    assert p.gen_mode in ms.GEN_MODES, p.gen_mode
    ir = None
    if d.get("space_ir_on"):
        ir, sr = wavcodec.read_wav(IRS[0])
        assert sr == 48000
    stereo, meta = ms.render(p, ir_audio=ir)
    assert stereo.shape[1] == 2
    assert np.isfinite(stereo).all()
    assert float(np.max(np.abs(stereo))) > 0.01


def test_ir_bank_loads_and_is_causal():
    from audio_suite_tpu.utils import wavcodec
    for path in IRS:
        x, sr = wavcodec.read_wav(path)
        assert sr == 48000
        assert 1024 <= len(x) <= 8192
        assert float(np.max(np.abs(x))) <= 1.0
        assert float(np.max(np.abs(x[: len(x) // 8]))) \
            >= float(np.max(np.abs(x[-len(x) // 8:]))), \
            "IR energy should decay"
