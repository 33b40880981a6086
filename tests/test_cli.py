"""CLI integration: drive `python -m audio_suite_tpu.cli` as a subprocess
(the real module entry point users run)."""
import os
import subprocess
import sys

import numpy as np

from audio_suite_tpu.utils import io as audio_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               # persistent compile cache: repeated CLI subprocesses would
               # otherwise each pay full XLA compiles on this 1-CPU box
               JAX_COMPILATION_CACHE_DIR=os.path.join(REPO, ".jax_cache"),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1")
    return subprocess.run([sys.executable, "-m", "audio_suite_tpu.cli",
                           *args], capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=600)


REF_PL_EXAMPLES = "/root/reference/pattern lab 0.1/examples"


def test_cli_scrub_grid_microsound(tmp_path):
    sr = 8000
    t = np.arange(sr) / sr
    wav = str(tmp_path / "in.wav")
    audio_io.write_wav(wav, (0.5 * np.sin(2 * np.pi * 220 * t))
                       .astype(np.float32), sr)

    r = _run(["scrub", wav, "-o", str(tmp_path / "s.wav"),
              "--seconds", "2", "--heads", "2", "--base-speed", "0.5",
              "--drag", "0.5:6.0:1.0"])
    assert r.returncode == 0, r.stderr
    y, sr2 = audio_io.read_wav(str(tmp_path / "s.wav"))
    assert sr2 == sr and np.isfinite(y).all()

    # grid: minimal 2-track project around a wav cell + a restart cell
    import json
    cell = tmp_path / "blip.py"
    cell.write_text(
        "import numpy as np\n"
        "def generate(sr, dur):\n"
        "    n = int(sr * dur)\n"
        "    return (0.4 * np.sin(2*np.pi*330*np.arange(n)/sr)"
        ").astype(np.float32)\n")
    project = {
        "sample_rate": sr,
        "master": {"mode": "fixed_seconds", "fixed_seconds": 2.0},
        "tracks": [
            {"name": "a", "mode": "duration", "duration_seconds": 1.0,
             "uniform_n": 4, "loop_to_master": True,
             "cells": [{"kind": "wav", "path": wav},
                       {"kind": "py", "path": str(cell)},
                       {"kind": "empty", "path": ""},
                       {"kind": "py", "path": str(cell)}]},
            {"name": "b", "mode": "duration", "duration_seconds": 0.5,
             "uniform_n": 2, "loop_to_master": True, "gain_db": -6.0,
             "mod_source_index": 0, "mod_amount": 0.5,
             "cells": [{"kind": "py", "path": str(cell)},
                       {"kind": "empty", "path": ""}]},
        ],
    }
    proj_path = tmp_path / "proj.json"
    proj_path.write_text(json.dumps(project))
    r = _run(["grid", str(proj_path), "-o", str(tmp_path / "g.wav")])
    assert r.returncode == 0, r.stderr
    y, sr2 = audio_io.read_wav(str(tmp_path / "g.wav"))
    assert sr2 == sr and len(y) == 2 * sr and np.isfinite(y).all()
    assert float(np.max(np.abs(y))) > 1e-4

    r = _run(["microsound", "-o", str(tmp_path / "m.wav"),
              "--dur", "0.2", "--seed", "3"])
    assert r.returncode == 0, r.stderr
    y, _ = audio_io.read_wav(str(tmp_path / "m.wav"))
    assert np.isfinite(y).all()


def test_cli_patternlab_reference_example_script(tmp_path):
    """The --script path (ensure_pattern_lab_examples_importable +
    load_script_generator) against a reference Pattern Lab example
    (SURVEY §2.3 examples row)."""
    script = os.path.join(REF_PL_EXAMPLES, "fibonacci_clock_desync.py")
    if not os.path.exists(script):
        import pytest
        pytest.skip("reference mount unavailable")
    r = _run(["patternlab", "-o", str(tmp_path / "fib.wav"),
              "--script", script, "--seconds", "2",
              "--gen", "root_midi=60", "--gen", "a=5"])
    assert r.returncode == 0, r.stderr
    y, _ = audio_io.read_wav(str(tmp_path / "fib.wav"))
    assert np.isfinite(y).all() and float(np.max(np.abs(y))) > 1e-4


def test_pattern_lab_reference_examples_render():
    """All 3 reference example scripts run through the _common shim and
    render end-to-end via the API (no subprocess)."""
    if not os.path.isdir(REF_PL_EXAMPLES):
        import pytest
        pytest.skip("reference mount unavailable")
    from pathlib import Path

    from audio_suite_tpu.models import patternlab as pl
    from audio_suite_tpu.plugins.host import (
        ensure_pattern_lab_examples_importable, load_script_generator)

    ensure_pattern_lab_examples_importable()
    cfg = pl.RenderConfig(sample_rate=22050, seconds=2.0, bpm=120, seed=3)
    for name in ("fibonacci_clock_desync.py", "prime_delay_illusion.py",
                 "pythag_spiral_organ.py"):
        gen = load_script_generator(Path(REF_PL_EXAMPLES) / name)
        events = gen(cfg)
        assert events, name
        y, used = pl.render(events, cfg)
        assert np.isfinite(y).all(), name
        assert float(np.max(np.abs(y))) > 1e-4, name


def test_cli_tape_and_patternlab(tmp_path):
    sr = 8000
    t = np.arange(sr) / sr
    wav = str(tmp_path / "in.wav")
    audio_io.write_wav(wav, (0.5 * np.sin(2 * np.pi * 220 * t))
                       .astype(np.float32), sr)

    r = _run(["tape", wav, "-o", str(tmp_path / "t.wav"),
              "--markers", "0.4", "--speeds", "1.0,2.0"])
    assert r.returncode == 0, r.stderr
    y, sr2 = audio_io.read_wav(str(tmp_path / "t.wav"))
    assert sr2 == sr and len(y) > 0

    r = _run(["patternlab", "-o", str(tmp_path / "p.wav"),
              "--generator", "Glass Cells", "--seconds", "1"])
    assert r.returncode == 0, r.stderr
    y, _ = audio_io.read_wav(str(tmp_path / "p.wav"))
    assert np.isfinite(y).all()

    r = _run(["forestfire", "--steps", "30", "--seed", "2"])
    assert r.returncode == 0, r.stderr
    assert "OSC events" in r.stdout
