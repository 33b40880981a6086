"""On-device parity sweep: every engine vs its NumPy oracle on the
CURRENT default JAX device.  The CPU test suite cannot see how another
backend contracts, rounds and lowers (a default-precision convolution in
a reduced-precision matrix unit lands near -51 dBFS), so run this on the
accelerator.

    python tools/parity.py            # quick sweep (seconds)
    python tools/parity.py --long     # + long-render configs (minutes:
                                      #   128 s / >=6k-note Pattern Lab,
                                      #   60 s tape, 60 s scrub — the
                                      #   error-accumulation regime the
                                      #   quick sweep cannot see)

`quick()` and `long()` return one row per check; chip_smoke.py runs the
quick sweep through them.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from audio_suite_tpu.utils.metrics import max_dev_dbfs  # noqa: E402


def _reporter(rows):
    def report(tag, dev, limit=-60.0):
        """A dBFS deviation row (limit in dBFS), or an exactness row when
        `dev` is a bool (True = bit-exact)."""
        if isinstance(dev, bool):
            row = {"check": tag, "value": "bit-exact" if dev else
                   "DIVERGED", "limit": "bit-exact", "ok": dev}
        else:
            row = {"check": tag, "value": round(float(dev), 1),
                   "limit": limit, "ok": bool(dev <= limit)}
        rows.append(row)
        value = row["value"]
        if not isinstance(value, str):
            value = f"{value:8.1f} dBFS"
        print(f"{tag:<34} {value:>13}   {'OK' if row['ok'] else 'FAIL'}",
              flush=True)
    return report


def quick() -> list:
    """The quick sweep (seconds): one row per engine path."""
    rows = []
    report = _reporter(rows)

    sr = 48000
    rng = np.random.default_rng(7)
    t = np.arange(sr * 2) / sr
    audio = (0.5 * np.sin(2 * np.pi * 220 * t)
             + 0.1 * rng.standard_normal(t.size)).astype(np.float32)

    from audio_suite_tpu.models import tape
    from oracles.tape_ref import render_tape_np
    p = tape.TapeParams(sample_rate=sr, markers=[30000, 60000],
                        section_speeds=[1.0, 2.5, 0.4],
                        section_reverse=[False, True, False],
                        tape_age=70, inertia_enabled=True, inertia_amount=50)
    prog = tape.build_tape_program(audio, p, 40000)
    report("tape (inertia/splice/rev)",
           max_dev_dbfs(tape.render_tape(audio, p, 40000),
                        render_tape_np(prog)), -120.0)

    from audio_suite_tpu.models import scrub
    from oracles.scrub_ref import render_scrub_np
    cfg = scrub.ScrubConfig(sample_rate=sr, seed=5, head_count=3)
    trace = scrub.scripted_gesture_trace(
        40, sr, drag_events=[(0.2, 5.0, 0.3)], base_speed=0.5,
        jumps=[(0.5, 9000.0)])
    sprog = scrub.build_scrub_program(audio, cfg, trace, with_inc=True)
    report("scrub (3 heads/jump)",
           max_dev_dbfs(scrub.render_scrub(audio, cfg, trace),
                        render_scrub_np(sprog)), -120.0)

    # --- TapeTrace live performance (round-4 path: trace-segmented table
    # programs threading position/speed/splice/LFO state, tape.py:601-743)
    trace = tape.TapeTrace()
    trace.add(0.20, "set_speed", section=0, value=1.7)
    trace.add(0.45, "set_reverse", section=1, value=True)
    trace.add(0.70, "set_age", value=95)
    trace.add(0.90, "add_marker", sample=sr // 2)
    trace.add(1.10, "set_inertia", value=True)
    trace.add(1.15, "set_inertia_amount", value=80)
    trace.add(1.40, "seek", sample=100)
    trace.add(1.60, "retime", target=1.2)
    pt = tape.TapeParams(sample_rate=sr, markers=[30000, 60000],
                         section_speeds=[1.0, 0.5, 2.0],
                         section_reverse=[False, False, True],
                         tape_age=40, current_speed=1.0)
    nf_tr = sr * 2
    segs = tape.build_trace_programs(audio, pt, trace, nf_tr)
    rem, sidx = 0, 0
    seg_outs = []
    for s in segs:
        o, st = render_tape_np(
            s, init={"whole": s["init_whole"], "frac": s["init_frac"],
                     "rem": rem, "sidx": sidx}, return_state=True)
        rem, sidx = st["rem"], st["sidx"]
        seg_outs.append(o)
    ref_tr = np.concatenate(seg_outs)
    report("tape TRACE (8-op live perf)",
           max_dev_dbfs(tape.render_tape_trace(audio, pt, trace,
                                               num_frames=nf_tr),
                        ref_tr), -100.0)

    # --- scrub live key events (round-4 path: per-control-segment reads
    # over one global position pass, scrub.py:648)
    ktrace = scrub.scripted_gesture_trace(
        60, sr, drag_events=[(0.3, 5.0, 0.4)], base_speed=0.5,
        jumps=[(0.9, 15000.0)],
        key_events=[(0.2, "2"), (0.4, "Z"), (0.4, "Z"), (0.6, "1"),
                    (0.8, "V"), (1.0, "3"), (1.1, "R"), (1.2, "Down")])
    kprog = scrub.build_scrub_program(audio, cfg, ktrace, 5000.0,
                                      with_inc=True)
    assert len(kprog["head_segments"]) >= 5
    report("scrub KEYS (live controls)",
           max_dev_dbfs(scrub.render_scrub(audio, cfg, ktrace, 5000.0),
                        render_scrub_np(kprog)), -60.0)

    from audio_suite_tpu.models import microsound as ms
    from oracles.microsound_ref import render_ref
    for mode in ("Noise burst", "Micro-chaos", "Dust impulses",
                 "Crackle / corona", "Wavelet atoms", "Stick–slip friction"):
        mp = ms.MicrosoundParams.from_dict(dict(
            base_sr=8000, out_dur_s=0.4, time_unfold=2.0, micro_ms=4.0,
            seed=4242, grains_per_sec=20.0, max_grains=64, gen_mode=mode,
            bandlimit_on=True, bandlimit_out_hz=3000.0,
            bandlimit_roll_hz=500.0, er_cloud_on=True, er_taps=64,
            er_max_ms=20.0, stereo_on=True, partial_stretch=1.5,
            bp_density="", bp_unfold="", bp_cutoff="", bp_stretch=""))
        mprog = ms.build_program(mp)
        out, _ = ms.render(mp)
        report(f"microsound {mode[:16]}",
               max_dev_dbfs(out, render_ref(mp, mprog)))

    # high-rate NON-shared warp chain: per-event stretch breakpoints at a
    # design rate that pushes L to 16384 or more, so the vmapped
    # per-event spectral path runs at the long grain transforms
    mp = ms.MicrosoundParams.from_dict(dict(
        base_sr=96000, out_dur_s=0.25, time_unfold=60.0, micro_ms=4.0,
        seed=77, grains_per_sec=40.0, max_grains=16,
        gen_mode="Noise burst", bandlimit_on=True,
        bandlimit_out_hz=18000.0, bandlimit_roll_hz=2500.0,
        nl_warp_on=True, nl_warp_power=1.3, er_cloud_on=False,
        stereo_on=True, bp_density="", bp_unfold="", bp_cutoff="",
        bp_stretch="0:1.0, 0.12:2.4"))
    mprog = ms.build_program(mp)
    assert int(mprog["L"]) >= 16384, mprog["L"]
    out, _ = ms.render(mp)
    report("microsound warp hi-rate", max_dev_dbfs(out, render_ref(mp, mprog)))

    from audio_suite_tpu.models import patternlab as pl
    from oracles.patternlab_ref import render_np
    rc = pl.RenderConfig(sample_rate=22050, seconds=1.0, bpm=140, seed=4)
    events = pl.generate("Glass Cells", rc) + pl.generate("Fibonacci Gate",
                                                          rc)[:20]
    y, ev = pl.render(events, rc)
    report("patternlab FM+PSG", max_dev_dbfs(y, render_np(ev, rc)))

    from audio_suite_tpu.models import forestfire as ff
    from oracles.forestfire_ref import simulate_np
    model = ff.ForestFireModel(ff.ModelParams(w=64, h=48), seed=3)
    model.ignite_at(30, 20, radius=3)
    carry0 = {k: (v.copy() if isinstance(v, np.ndarray) else v)
              for k, v in model._np.items()}
    stats = model.simulate(60)
    _, stats_ref = simulate_np(carry0, 60, ff.ModelParams(w=64, h=48),
                               seed=3)
    report("forestfire CA (60 steps)", bool(np.array_equal(stats, stats_ref)))

    # grid: device table mixdown must equal the host twin BIT-FOR-BIT on
    # this device (integer placement + envdet twins), and the device's
    # overlap-add path must match the sequential DUS accumulation exactly
    from audio_suite_tpu.models import grid
    from audio_suite_tpu.ops import envdet
    import jax.numpy as jnp
    from audio_suite_tpu.ops import pallas_oa as poa
    n_total = sr * 2
    g_rng = np.random.default_rng(11)
    g_rows = [
        {"pat": g_rng.uniform(-0.5, 0.5, 17321).astype(np.float32),
         "start_idx": 0, "loop": True,
         "resets": np.asarray([4000, 61000], np.int32), "mod_src": -1,
         "win": 1200, "a_q12": 0, "gain": 1.0},
        {"pat": g_rng.uniform(-0.5, 0.5, 9001).astype(np.float32),
         "start_idx": -500, "loop": True, "resets": np.zeros(0, np.int32),
         "mod_src": 0, "win": 960, "a_q12": envdet.amount_q12(0.9),
         "gain": float(np.float32(0.7))},
    ]
    mix_d = grid._device_mixdown(n_total, g_rows)
    mix_h, _ = grid._host_mixdown(n_total, g_rows, False)
    report("grid device==host mixdown", bool(np.array_equal(mix_d, mix_h)))

    E, L = 24, 4096
    out_len = poa.buffer_len(sr, L)
    vals = jnp.asarray(g_rng.standard_normal((E, L)).astype(np.float32))
    starts = g_rng.integers(0, sr, E) + L      # unsorted, like notes
    o0 = jnp.zeros(out_len, jnp.float32)
    got = np.asarray(poa.overlap_add(o0, vals, starts,
                                     path=poa.oa_path()))
    dus = np.asarray(poa.overlap_add_dus(
        o0, vals, jnp.asarray(starts.astype(np.int32))))
    report(f"OA {poa.oa_path()} == sequential DUS",
           bool(np.array_equal(got.view(np.uint32), dus.view(np.uint32))))
    return rows


def long() -> list:
    """Long-render parity: quantizer / phase-accumulation error grows with
    render length and note count, so the -60 dBFS budget must be shown AT
    LENGTH on the device, not only at the quick sweep's seconds-scale
    configs."""
    rows = []
    report = _reporter(rows)

    # --- Pattern Lab: 128 s, >=6000 notes (synth_fm.py:27-36 quantizer
    # error regime) ---
    from audio_suite_tpu.models import patternlab as pl
    from oracles.patternlab_ref import render_np
    rc = pl.RenderConfig(sample_rate=44100, seconds=128.0, bpm=168, seed=17)
    events = []
    for gen in pl.list_generators():
        if gen == "Python Script":
            continue
        events.extend(pl.generate(gen, rc))
    t0 = time.perf_counter()
    y, ev = pl.render(events, rc)
    t_dev = time.perf_counter() - t0
    assert len(ev) >= 6000, f"long config must have >=6k notes, got {len(ev)}"
    t0 = time.perf_counter()
    ref = render_np(ev, rc)
    t_ref = time.perf_counter() - t0
    print(f"  patternlab: {len(ev)} notes / {rc.seconds:.0f} s "
          f"(device {t_dev:.1f} s, oracle {t_ref:.1f} s)")
    report(f"patternlab long ({len(ev)} notes)", max_dev_dbfs(y, ref))

    # --- Tape: 60 s render, mixed speeds/reverse, inertia + splice fx ---
    from audio_suite_tpu.models import tape
    from oracles.tape_ref import render_tape_np
    sr = 48000
    rng = np.random.default_rng(23)
    t = np.arange(sr * 60) / sr
    audio = (0.5 * np.sin(2 * np.pi * 220 * t)
             + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
             + 0.1 * rng.standard_normal(t.size)).astype(np.float32)
    n = len(audio)
    p = tape.TapeParams(
        sample_rate=sr, markers=[int(n * f) for f in (0.15, 0.4, 0.7)],
        section_speeds=[1.0, 2.5, 0.4, 1.7],
        section_reverse=[False, True, False, True],
        tape_age=70, inertia_enabled=True, inertia_amount=50,
        enable_splice_fx=True, anticlick_enabled=True)
    frames = sr * 60
    prog = tape.build_tape_program(audio, p, frames)
    t0 = time.perf_counter()
    y_t = tape.render_tape(audio, p, frames)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_t = render_tape_np(prog)
    t_ref = time.perf_counter() - t0
    print(f"  tape: {frames / sr:.0f} s render "
          f"(device {t_dev:.1f} s, oracle {t_ref:.1f} s)")
    report("tape long (60 s inertia/rev)", max_dev_dbfs(y_t, ref_t), -100.0)

    # --- Scrub: 60 s gesture, 3 heads, jumps + dropout ---
    from audio_suite_tpu.models import scrub
    from oracles.scrub_ref import render_scrub_np
    cfg = scrub.ScrubConfig(sample_rate=sr, seed=5, head_count=3)
    blocks = int(60.0 * sr / scrub.BLOCK_SIZE)
    trace = scrub.scripted_gesture_trace(
        blocks, sr,
        drag_events=[(2.0, 8.0, 3.0), (12.0, -14.0, 4.0), (25.0, 4.0, 5.0),
                     (40.0, -6.0, 6.0)],
        base_speed=0.5, jumps=[(18.0, 9000.0), (45.0, 120000.0)])
    sprog = scrub.build_scrub_program(audio[: sr * 10], cfg, trace,
                                      with_inc=True)
    t0 = time.perf_counter()
    y_s = scrub.render_scrub(audio[: sr * 10], cfg, trace)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_s = render_scrub_np(sprog)
    t_ref = time.perf_counter() - t0
    print(f"  scrub: {blocks * scrub.BLOCK_SIZE / sr:.0f} s render "
          f"(device {t_dev:.1f} s, oracle {t_ref:.1f} s)")
    report("scrub long (60 s, 3 heads)", max_dev_dbfs(y_s, ref_s), -100.0)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--long", action="store_true",
                    help="also run the long-render configs (minutes)")
    ap.add_argument("--long-only", action="store_true",
                    help="run ONLY the long-render configs")
    args = ap.parse_args(argv)
    import jax

    from audio_suite_tpu.utils import compile_cache

    compile_cache.enable()
    print(f"device: {jax.devices()[0]}")
    rows = [] if args.long_only else quick()
    if args.long or args.long_only:
        rows += long()
    failures = [r["check"] for r in rows if not r["ok"]]
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("all checks within their bars on this device")


if __name__ == "__main__":
    main()
