"""Roofline check for the two sub-1000x compute kernels (grid mixdown,
microsound fused chain): XLA cost_analysis flops/bytes vs measured device
time -> implied memory bandwidth and FLOP rate, so optimization targets
the actual bound instead of guesses.

    python tools/roofline.py [grid|ms]
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
from audio_suite_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import time
import numpy as np
import jax
import jax.numpy as jnp


def drain(y):
    return float(jnp.sum(jnp.abs(jnp.ravel(y)).astype(jnp.float32)))


def time_device(fn, K=20):
    y = fn()
    drain(y)
    t0 = time.perf_counter()
    for _ in range(K):
        y = fn()
    drain(y)
    return (time.perf_counter() - t0) / K


def report(name, compiled, secs):
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    flops = ca.get("flops", 0.0)
    bytes_ = ca.get("bytes accessed", 0.0)
    print(f"{name}: {secs*1e3:.2f} ms | {flops/1e9:.2f} GFLOP "
          f"({flops/secs/1e12:.2f} TFLOP/s) | {bytes_/1e6:.1f} MB accessed "
          f"({bytes_/secs/1e9:.1f} GB/s)")
    for k in sorted(ca):
        if k.startswith("bytes accessed") and ca[k] > bytes_ * 0.02:
            print(f"    {k}: {ca[k]/1e6:.1f} MB")


def grid_case():
    from audio_suite_tpu.models import grid
    cells_dir = os.path.join(_ROOT, "examples", "cells")
    cell_files = ["slow_pulse_pad.py", "euclid_clicks.py",
                  "shard_scatter.py", "poly_impulses.py"]
    sr, seconds = 48000, 16.0
    tracks = []
    for ti in range(4):
        t = grid.Track(name=f"t{ti}", mode="duration",
                       duration_seconds=2.0 + ti, uniform_n=8,
                       loop_to_master=True, gain_db=-3.0 * ti,
                       sync_points_text="4.0, 9.5" if ti else "")
        if ti >= 1:
            t.mod_source_index = ti - 1
            t.mod_amount = 0.6
        t.ensure_cells(t.uniform_n)
        for ci in range(t.uniform_n):
            t.cells[ci] = grid.CellSource(
                kind="py", path=os.path.join(cells_dir, cell_files[ti]))
        tracks.append(t)
    project = grid.GridProject(
        tracks=tracks, master=grid.MasterClock("fixed_seconds", seconds),
        sample_rate=sr)
    n_total, rows = grid._build_mix_program(project)
    prep = grid.prepare_device_mix(n_total, rows)
    fn = grid._mix_fn(prep.meta)
    lowered = fn.lower(prep.flat_pat, prep.resets, jnp.int32(n_total))
    compiled = lowered.compile()
    t = time_device(lambda: fn(prep.flat_pat, prep.resets,
                               jnp.int32(n_total)))
    report(f"grid mixdown [{prep.meta.n_pad}]", compiled, t)


def ms_case():
    from audio_suite_tpu.models import microsound as ms
    from audio_suite_tpu.ops import space
    sr, seconds = 192000, 4.0
    rng = np.random.default_rng(11)
    ir = (rng.standard_normal(8192) * np.exp(-np.arange(8192) / 800.0)) \
        .astype(np.float32)
    p = ms.MicrosoundParams.from_dict(dict(
        base_sr=sr, out_dur_s=seconds, time_unfold=100.0,
        gen_mode="Noise burst", micro_ms=1.0, grains_per_sec=60.0,
        max_grains=400, partial_stretch=4.0, bandlimit_on=True,
        bandlimit_out_hz=18000.0, bandlimit_roll_hz=2500.0,
        er_cloud_on=True, space_ir_on=True, stereo_on=True,
        bp_density="", bp_unfold="", bp_cutoff="", bp_stretch="", seed=5))
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
    er_d = jax.device_put(jnp.asarray(er_comb))
    ir_d = jax.device_put(jnp.asarray(irm))
    # the fused fn is a jitted callable: lower via jax.jit wrapper
    wrapped = jax.jit(lambda c: fused(c, None, er_d, ir_d)[2])
    compiled = wrapped.lower(c0).compile()
    t = time_device(lambda: wrapped(c0))
    report(f"microsound fused [E={cfg.ec} L={cfg.L}]", compiled, t)

    # stage splits with the same K=20 protocol
    per_ev = {k: v for k, v in c0.items() if not k.startswith("oa_")}
    gen = jax.jit(lambda evs: jax.vmap(lambda e: ms._generate(e, cfg))(evs))
    cg = gen.lower(per_ev).compile()
    t = time_device(lambda: gen(per_ev))
    report("  generate", cg, t)

    from audio_suite_tpu.ops import spectral
    raw = gen(per_ev)
    raw.block_until_ready()
    lp = jax.jit(lambda r, evs: spectral.lowpass_stretch_fused_shared(
        r, evs["gen_sr"], evs["cutoff_gen"], evs["stretch"][0],
        roll=cfg.bandlimit_roll))
    cl = lp.lower(raw, per_ev).compile()
    t = time_device(lambda: lp(raw, per_ev))
    report("  lp_stretch_shared", cl, t)


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    print("device:", jax.devices()[0])
    if which in ("grid", "both"):
        grid_case()
    if which in ("ms", "both"):
        ms_case()


if __name__ == "__main__":
    main()
