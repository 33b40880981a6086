"""Device-trace op breakdown for any engine's hot call: captures a
jax.profiler trace of N repetitions and prints the top ops by device
time.  This is how the round-3b targets were found (the lerp
window-fetch while-loops, the one-hot materialization in the tape read,
the noise-draw fusion).

    python tools/trace_top.py microsound   # bench config 3 fused call
    python tools/trace_top.py tape         # config 1 device render
    python tools/trace_top.py patternlab   # config 4 prepared dispatch
"""
import collections
import glob
import gzip
import json
import os
import sys
import tempfile

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
from audio_suite_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np
import jax
import jax.numpy as jnp

REPS = 3


def _microsound():
    from audio_suite_tpu.models import microsound as ms
    from audio_suite_tpu.ops import space

    sr, seconds = 192000, 4.0
    rng = np.random.default_rng(11)
    ir = (rng.standard_normal(8192)
          * np.exp(-np.arange(8192) / 800.0)).astype(np.float32)
    p = ms.MicrosoundParams.from_dict(dict(
        base_sr=sr, out_dur_s=seconds, time_unfold=100.0,
        gen_mode="Noise burst", micro_ms=1.0, grains_per_sec=60.0,
        max_grains=400, partial_stretch=4.0, bandlimit_on=True,
        bandlimit_out_hz=18000.0, bandlimit_roll_hz=2500.0,
        er_cloud_on=True, space_ir_on=True, stereo_on=True, seed=5))
    prog = ms.build_program(p, ir_audio=ir)
    ec = max(1, min(prog["E"], (1 << 26) // max(1, prog["L"])))
    cfg = ms.chain_cfg(p, prog, ec)
    chunks = ms._chunk_events(prog, cfg)
    er = space.er_tap_kernel(int(p.er_taps), float(p.er_max_ms), sr,
                             int(p.seed))
    irm = ir[:8192].astype(np.float32)
    er_comb = np.convolve(er.astype(np.float64),
                          irm.astype(np.float64)).astype(np.float32)
    fx = ms.FxCfg(out_n=prog["out_n"], sr=sr,
                  env=(float(p.env_a), float(p.env_d), float(p.env_s),
                       float(p.env_r), float(p.env_curve)),
                  er_on=True, ir_on=True, stereo_on=True,
                  stereo_width=float(p.stereo_width),
                  sat_drive=float(p.sat_drive), peak=float(p.peak))
    fused = ms._fused_fn(cfg, fx)
    c0 = {k: jnp.asarray(v) for k, v in chunks[0].items()}
    er_d = jnp.asarray(er_comb)
    ir_d = jnp.asarray(irm)
    return lambda: fused(c0, None, er_d, ir_d)[2]


def _tape():
    from audio_suite_tpu.models import tape

    sr, seconds = 48000, 180.0
    t = np.arange(int(sr * seconds)) / sr
    audio = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    n = len(audio)
    markers = [int(n * f) for f in (0.12, 0.3, 0.45, 0.6, 0.8)]
    params = tape.TapeParams(
        sample_rate=sr, markers=markers,
        section_speeds=[1.0, 2.0, 0.5, 4.0, 0.25, 1.5],
        section_reverse=[False, True, False, True, False, False],
        tape_age=60, enable_splice_fx=True, anticlick_enabled=True)
    params.section_speeds = tape.fit_to_target_time(params, n, seconds)
    frames = tape.section_render_length(params, n)
    adev = jax.device_put(jnp.asarray(audio))
    adev.block_until_ready()
    prog = tape.build_tape_program(adev, params, frames, with_mod=False)
    return lambda: tape.tape_table_render(prog, device_out=True,
                                          stereo=True)[0]


def _patternlab():
    from audio_suite_tpu.models import patternlab as pl

    cfg = pl.RenderConfig(sample_rate=44100, seconds=8.0, bpm=128, seed=9)
    events = []
    for gen in pl.list_generators():
        if gen != "Python Script":
            events.extend(pl.generate(gen, cfg))
    ev = pl.apply_time_ops(events, cfg)
    synth = pl.MegaDriveInspiredSynth(cfg.sample_rate, seed=cfg.seed)
    prep = synth.prepare(ev, cfg.seconds)
    return lambda: synth.render_prepared(prep, master_gain=cfg.master_gain,
                                         device_out=True)


TARGETS = {"microsound": _microsound, "tape": _tape,
           "patternlab": _patternlab}


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "microsound"
    fn = TARGETS[name]()
    print("device:", jax.devices()[0])
    y = fn()
    jax.block_until_ready(y)
    td = tempfile.mkdtemp(prefix="trace_top_")
    jax.profiler.start_trace(td)
    for _ in range(REPS):
        y = fn()
    jax.block_until_ready(y)
    jax.profiler.stop_trace()
    files = glob.glob(td + "/**/*.trace.json.gz", recursive=True)
    with gzip.open(files[-1]) as f:
        tr = json.load(f)
    durs = collections.Counter()
    for ev in tr.get("traceEvents", []):
        if ev.get("ph") == "X" and "dur" in ev \
                and not ev.get("name", "").startswith("$"):
            durs[ev["name"]] += ev["dur"]
    print(f"top ops (us per call, {REPS} reps):")
    for nm, d in durs.most_common(25):
        print("%9.1f us  %s" % (d / REPS, nm[:100]))


if __name__ == "__main__":
    main()
