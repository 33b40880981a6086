"""Prove the system on the GPU: every engine's main path at full size
through the CLI and the public API, parity against the NumPy oracles on
the card, the hand-written kernel against its plain reference, and the
tests marked `gpu`.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Everything runs in this one process (a second JAX process on the card
would find its memory taken).  Any failed phase exits non-zero, and so
does a process whose first JAX device is not a GPU; neither prints the
result line.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Rendered WAVs go to smoke_out/ (gitignored).
"""
import argparse
import contextlib
import glob
import io
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "smoke_out")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


# the Microsound ceiling: 240 s at 192 kHz (main_v2.py:894-902) with a
# 4000-event field — forces event chunking and a 46 M-sample overlap-add
CEILING = dict(
    base_sr=192000, out_dur_s=240.0, time_unfold=100.0,
    gen_mode="Noise burst", micro_ms=1.0, grains_per_sec=40.0,
    max_grains=4000, partial_stretch=4.0, bandlimit_on=True,
    bandlimit_out_hz=18000.0, bandlimit_roll_hz=2500.0,
    er_cloud_on=True, space_ir_on=False, stereo_on=True,
    bp_density="", bp_unfold="", bp_cutoff="", bp_stretch="", seed=5)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def phase(name):
    print(f"\n=== {name}", flush=True)


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------

def device_phase() -> str:
    import jax

    from audio_suite_tpu.utils import native_rt

    phase("device")
    card = card_line()
    print(card)
    print("jax", jax.__version__, jax.devices())
    print("native host runtime:",
          "loaded" if native_rt.get_lib() is not None else "not loaded "
          "(NumPy twins)")
    return card


# ---------------------------------------------------------------------------
# Phase 2: engines at full size
# ---------------------------------------------------------------------------

def _cli(argv) -> str:
    """Run the CLI's main() in this process; return what it printed."""
    from audio_suite_tpu.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(list(argv))
    return buf.getvalue()


def _timed_twice(fn):
    """(first-call seconds incl. compile, warm seconds, warm result)."""
    t0 = time.perf_counter()
    fn()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = fn()
    return cold, time.perf_counter() - t0, res


def _read_back(path, frames, sr, channels):
    """Read a rendered WAV back with the repo's codec and check it."""
    import numpy as np

    from audio_suite_tpu.utils import io as audio_io

    y, got_sr = audio_io.read_wav(path, always_2d=True)
    assert got_sr == sr, (path, got_sr, sr)
    assert y.shape == (frames, channels), (path, y.shape, frames, channels)
    assert np.isfinite(y).all(), path
    peak = float(np.max(np.abs(y)))
    assert 1e-3 < peak <= 1.0 + 1e-6, (path, peak)
    return frames / sr, peak


def engines_phase(card: str) -> list:
    import numpy as np

    import bench
    from audio_suite_tpu.events import rules as R
    from audio_suite_tpu.models import forestfire as ff
    from audio_suite_tpu.models import grid
    from audio_suite_tpu.models import microsound as ms
    from audio_suite_tpu.models import patternlab as pl
    from audio_suite_tpu.models import scrub, tape
    from audio_suite_tpu.ops import pallas_oa as poa
    from audio_suite_tpu.utils import io as audio_io

    phase("engines at full size (CLI and public API)")
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    rows = []

    def record(name, cold, warm, audio_s, oa="-", note=""):
        row = {"render": name, "wall_s": round(warm, 4),
               "first_call_s": round(cold, 2), "audio_s": round(audio_s, 3),
               "rtf": round(audio_s / warm, 1), "oa": oa}
        rows.append(row)
        print(f"{name}: wall {warm:.4f} s (first call {cold:.2f} s), audio "
              f"{audio_s:.3f} s, RTF {audio_s / warm:.1f}x, overlap-add "
              f"{oa}{note} | {card}", flush=True)

    def path(name):
        return os.path.join(OUT, name)

    # tape: 180 s at 48 kHz, six mixed-speed fwd/rev sections (CLI)
    audio, tp = bench.tape_setup()
    sr = tp.sample_rate
    audio_io.write_wav(path("tape_in.wav"), audio, sr)
    # half a sample past each marker: the CLI's int(t * sr) lands on it
    marks = ",".join(repr((m + 0.5) / sr) for m in tp.markers)
    argv = ["tape", path("tape_in.wav"), "-o", path("tape.wav"),
            "--markers", marks, "--speeds", "1,2,0.5,4,0.25,1.5",
            "--reverse", "0,1,0,1,0,0", "--tape-age", str(tp.tape_age),
            "--target-time", str(len(audio) / sr)]
    cold, warm, _ = _timed_twice(lambda: _cli(argv))
    # the CLI's retime must land on the bench program's frame count
    frames = tape.section_render_length(tp, len(audio))
    secs, _ = _read_back(path("tape.wav"), frames, sr, 1)
    record(f"tape {len(audio) / sr:g} s source, retimed (CLI)", cold, warm,
           secs)

    # scrub: 30 s, 3 heads, scripted drags and a jump (public API)
    s_audio, s_cfg, s_trace = bench.scrub_setup()

    def scrub_render():
        y = scrub.render_scrub(s_audio, s_cfg, s_trace)
        audio_io.write_wav(path("scrub.wav"), y, s_cfg.sample_rate)
        return y

    cold, warm, y = _timed_twice(scrub_render)
    secs, _ = _read_back(path("scrub.wav"), len(y), s_cfg.sample_rate, 1)
    assert len(y) == s_trace.num_blocks * scrub.BLOCK_SIZE
    record("scrub 30 s, 3 heads (API)", cold, warm, secs)

    # Microsound: the bench's 4 s at 192 kHz field with ER + IR (CLI)
    mp, ir = bench.microsound_setup()
    ms.save_preset(mp, path("ms_bench.json"))
    audio_io.write_wav(path("ir.wav"), ir, int(mp.base_sr))
    argv = ["microsound", path("ms_bench.json"), "-o", path("ms_bench.wav"),
            "--ir", path("ir.wav")]
    cold, warm, text = _timed_twice(lambda: _cli(argv))
    oa = text.split("overlap-add")[-1].strip()
    n_out = int(round(mp.out_dur_s * mp.base_sr))
    secs, _ = _read_back(path("ms_bench.wav"), n_out, int(mp.base_sr), 2)
    record("microsound 4 s @ 192 kHz x100, 400 grains (CLI)", cold, warm,
           secs, oa)

    # Microsound ceiling (CLI)
    cp = ms.MicrosoundParams.from_dict(CEILING)
    ms.save_preset(cp, path("ms_ceiling.json"))
    argv = ["microsound", path("ms_ceiling.json"), "-o",
            path("ms_ceiling.wav")]
    cold, warm, text = _timed_twice(lambda: _cli(argv))
    assert f"{cp.max_grains} events" in text, text
    oa = text.split("overlap-add")[-1].strip()
    n_out = int(round(cp.out_dur_s * cp.base_sr))
    secs, _ = _read_back(path("ms_ceiling.wav"), n_out, int(cp.base_sr), 2)
    record(f"microsound ceiling {cp.out_dur_s:g} s @ {cp.base_sr} Hz, "
           f"{cp.max_grains} events (CLI)", cold, warm, secs, oa)

    # Pattern Lab: 8 s of every built-in generator (public API)
    p_cfg, events = bench.patternlab_setup()

    def pl_render():
        y, ev = pl.render(events, p_cfg)
        audio_io.write_wav(path("patternlab.wav"), y, p_cfg.sample_rate)
        return y, ev

    cold, warm, (y, ev) = _timed_twice(pl_render)
    synth = pl.MegaDriveInspiredSynth(p_cfg.sample_rate, seed=p_cfg.seed)
    prep = synth.prepare(pl.apply_time_ops(events, p_cfg), p_cfg.seconds)
    secs, _ = _read_back(path("patternlab.wav"), len(y), p_cfg.sample_rate,
                         1)
    record(f"patternlab 8 s, {len(ev)} notes, {len(prep.spec)} buckets "
           "(API)", cold, warm, secs, prep.oa)
    sec = p_cfg.seconds
    cold, warm, text = _timed_twice(lambda: _cli(
        ["patternlab", "-o", path("pl_cli.wav"), "--generator",
         "Glass Cells", "--seconds", str(sec)]))
    sr_cli = pl.RenderConfig().sample_rate
    secs, _ = _read_back(path("pl_cli.wav"), int(round(sec * sr_cli)),
                         sr_cli, 1)
    record(f"patternlab {sec:g} s, Glass Cells (CLI)", cold, warm, secs,
           poa.oa_path())

    # grid: 16 s, 4 tracks of examples/cells (CLI); Forest Fire: 480 CA
    # steps at 220x160 (CLI), its rules to OSC bytes (public API)
    project = bench.grid_setup()
    grid.save_project(project, path("grid.json"))
    cold, warm, _ = _timed_twice(lambda: _cli(
        ["grid", path("grid.json"), "-o", path("grid.wav")]))
    g_sr = project.sample_rate
    secs, _ = _read_back(path("grid.wav"),
                         int(project.master.fixed_seconds * g_sr), g_sr, 1)
    record("grid 16 s, 4 py-cell tracks (CLI)", cold, warm, secs)

    cold, warm, text = _timed_twice(lambda: _cli(
        ["forestfire", "--steps", "480", "--seed", "2", "--ignite",
         "110,80", "--stats-out", path("ff_stats.json")]))
    with open(path("ff_stats.json")) as f:
        stats = json.load(f)
    assert stats["t"] == 480, stats
    record("forestfire 480 steps 220x160 (CLI)", cold, warm, 480 / 30.0,
           note=f", {text.split(' OSC events')[0].strip()} OSC events")

    def ff_osc():
        model = ff.ForestFireModel(ff.ModelParams(), seed=2)
        model.ignite_at(110, 80, radius=4)
        eng = R.WatchEngine(now_fn=lambda: 0.0)
        eng.set_rules([R.ThresholdRule(metric_key="burning", op=">",
                                       threshold=50, edge="rising",
                                       cooldown_s=0.0)])
        rec = R.OSCRecorder()
        eng.run_stream(ff.stats_rows_to_dicts(model.simulate(480)),
                       rec.send)
        return [R.encode_message(a, *args) for a, args in rec.messages]

    cold, warm, packets = _timed_twice(ff_osc)
    assert packets and all(len(b) % 4 == 0 for b in packets)
    addr, _args = R.decode_message(packets[0])
    assert addr.startswith("/"), addr
    record(f"forestfire rules -> {len(packets)} OSC packets "
           f"({sum(map(len, packets))} bytes) (API)", cold, warm,
           480 / 30.0)
    assert all(np.isfinite(r["rtf"]) for r in rows)
    return rows


# ---------------------------------------------------------------------------
# Phase 3: parity on the card
# ---------------------------------------------------------------------------

def parity_phase() -> list:
    import parity

    phase("parity vs the NumPy oracles (tools/parity.py quick sweep)")
    rows = parity.quick()
    bad = [r["check"] for r in rows if not r["ok"]]
    assert not bad, f"parity beyond its bar: {bad}"
    return rows


# ---------------------------------------------------------------------------
# Phase 4: kernels on the card
# ---------------------------------------------------------------------------

def _median_s(fn, n=7):
    import jax
    import numpy as np

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def kernels_phase(card: str) -> list:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from audio_suite_tpu.ops import pallas_oa as poa

    phase("kernels on the card: tiled overlap-add vs the DUS loop")
    rows = []
    rng = np.random.default_rng(0)
    # (E, window, out_n, L, sorted): the bench Microsound chunk, the
    # ceiling's 46 M-sample chunk, an unsorted note field
    for E, W, out_n, L, is_sorted in [(416, 19456, 768000, 32768, True),
                                      (2048, 20480, 46_080_000, 32768, True),
                                      (3000, 8192, 400000, 8192, False)]:
        N = poa.buffer_len(out_n, L)
        starts = rng.integers(0, N - W + 1, E)
        if is_sorted:
            starts = np.sort(starts)
        vals = jnp.asarray(rng.standard_normal((E, W)).astype(np.float32))
        out0 = jnp.zeros(N, jnp.float32)
        plan = tuple(jnp.asarray(a) for a in poa.plan_tiles(starts, W, N))
        st = jnp.asarray(starts.astype(np.int32))
        tiled = jax.jit(lambda o, v, p: poa.tiled_overlap_add(
            o, v, poa.TilePlan(*p)))
        dus = jax.jit(poa.overlap_add_dus)
        a = np.asarray(tiled(out0, vals, plan))
        b = np.asarray(dus(out0, vals, st))
        equal = bool(np.array_equal(a.view(np.uint32), b.view(np.uint32)))
        t_tiled = _median_s(lambda: tiled(out0, vals, plan))
        t_dus = _median_s(lambda: dus(out0, vals, st), n=3)
        row = {"E": E, "window": W, "buffer": N, "sorted": is_sorted,
               "bit_equal": equal, "tiled_ms": round(t_tiled * 1e3, 4),
               "dus_ms": round(t_dus * 1e3, 4)}
        rows.append(row)
        print(f"OA E={E} window={W} buffer={N} sorted={is_sorted}: "
              f"bit-equal {equal}, tiled {t_tiled * 1e3:.4f} ms, DUS "
              f"{t_dus * 1e3:.4f} ms | {card}", flush=True)
        assert equal, row

    phase("tests marked gpu (pytest, this process)")

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    # tests/conftest.py pins its process to the CPU unless told that the
    # process keeps its device
    os.environ["AUDIO_SUITE_TEST_DEVICE"] = "gpu"
    count = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_pallas_oa.py")],
                     plugins=[count])
    print(f"gpu tests: {count.passed} passed, pytest exit {int(rc)}")
    assert int(rc) == 0 and count.passed >= 6, (int(rc), count.passed)
    return rows


# ---------------------------------------------------------------------------
# --multi: the sharded paths on four cards
# ---------------------------------------------------------------------------

def multi_phase(n: int, card: str) -> dict:
    import jax
    import numpy as np

    import __graft_entry__ as ge
    from audio_suite_tpu.models import forestfire as ff
    from audio_suite_tpu.models import microsound as ms
    from audio_suite_tpu.parallel import ca
    from audio_suite_tpu.parallel.batch import make_mesh
    from audio_suite_tpu.utils.metrics import max_dev_dbfs

    assert len(jax.devices()) >= n, jax.devices()
    phase(f"sharded engine layouts on {n} devices (__graft_entry__)")
    t0 = time.perf_counter()
    res = ge.run_multichip_checks(n)
    for k, v in res.items():
        print(f"{k}: {v}")
    print(f"checks took {time.perf_counter() - t0:.1f} s | {card}")

    phase(f"preset bank: 9 Microsound presets, jobs spread over {n} "
          "devices vs one device")
    presets = sorted(glob.glob(os.path.join(ROOT, "examples", "presets",
                                            "*.json")))
    assert len(presets) == 9, presets
    params = [ms.load_preset(p) for p in presets]
    devs = jax.devices()[:n]

    def render_on(dev, p):
        with jax.default_device(dev):
            return ms.render(p, device_out=True)[0]

    def batch(assign):
        outs = [render_on(assign(i), p) for i, p in enumerate(params)]
        return [np.asarray(o) for o in outs]       # pulls wait for all

    single = batch(lambda i: devs[0])
    t0 = time.perf_counter()
    single = batch(lambda i: devs[0])
    t_single = time.perf_counter() - t0
    spread = batch(lambda i: devs[i % n])
    t0 = time.perf_counter()
    spread = batch(lambda i: devs[i % n])
    t_spread = time.perf_counter() - t0
    worst = -200.0
    for p, a, b in zip(presets, spread, single):
        d = max_dev_dbfs(a, b)
        worst = max(worst, d)
        print(f"  {os.path.basename(p)}: {a.shape[0]} frames, "
              f"{'bit-equal' if np.array_equal(a, b) else f'{d:.1f} dBFS'}")
    audio_s = sum(a.shape[0] / float(p.base_sr)
                  for a, p in zip(single, params))
    print(f"batch: {audio_s:.1f} s of audio, one device {t_single:.3f} s, "
          f"{n} devices {t_spread:.3f} s, worst deviation {worst:.1f} dBFS"
          f" | {card}")
    # XLA autotunes each device's compile on its own and may pick another
    # algorithm for an op, which moves the last bits; a misrouted or
    # corrupted job reads near 0 dBFS
    assert worst <= -90.0, worst

    phase("row-sharded Forest Fire CA at 2048x2048 vs the dense engine")
    steps = 120
    pf = ff.ModelParams(h=2048, w=2048)
    model = ff.ForestFireModel(pf, seed=3)
    model.ignite_at(1024, 1024, radius=16)
    carry0 = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
              for k, v in model._np.items()}
    mesh = make_mesh(n, axis_names=("sp",))
    t0 = time.perf_counter()
    carry_sh, stats_sh = ca.simulate_sharded(pf, carry0, steps, mesh,
                                             seed=3)
    t_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats_dense = model.simulate(steps)
    t_dense = time.perf_counter() - t0
    assert np.array_equal(np.asarray(stats_dense, np.int64),
                          np.asarray(stats_sh, np.int64))
    for k in ("state", "fuel", "moisture", "age"):
        assert np.array_equal(model._np[k], np.asarray(carry_sh[k])), k
    print(f"CA {steps} steps 2048x2048: bit-exact; sharded {t_sh:.2f} s, "
          f"dense {t_dense:.2f} s (first calls, compile included) | {card}")
    return res


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the paths across four GPUs")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev}", file=sys.stderr)
        return 2
    from audio_suite_tpu.utils import compile_cache

    print("compile cache:", compile_cache.enable())
    t0 = time.perf_counter()
    card = device_phase()
    if args.multi:
        multi_phase(4, card)
    else:
        engines_phase(card)
        parity_phase()
        kernels_phase(card)
    print(f"\nall phases passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:                  # any failed phase
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
