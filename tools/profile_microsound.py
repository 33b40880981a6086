"""Split config-3 (Microsound) wall time into compute vs d2h vs host build.

Run on the accelerator. Prints one JSON line with the breakdown.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from audio_suite_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np
import jax


def main():
    from audio_suite_tpu.models import microsound as ms
    from audio_suite_tpu.ops import space

    sr = 192000
    seconds = 4.0
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

    res = {"device": str(jax.devices()[0].platform)}

    # host program build
    t0 = time.perf_counter()
    prog = ms.build_program(p, ir_audio=ir)
    res["host_build_s"] = round(time.perf_counter() - t0, 4)
    res["E"] = int(prog["E"])
    res["L"] = int(prog["L"])
    res["out_n"] = int(prog["out_n"])

    # full render (includes d2h) - timed best of 3 after warmup
    def t_best(fn, rep=3):
        fn()
        best = float("inf")
        for _ in range(rep):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    res["full_render_s"] = round(t_best(
        lambda: ms.render(p, ir_audio=ir)), 4)

    # pieces: build once, then time the fused device call with/without d2h
    from audio_suite_tpu.ops import pallas_oa

    out_n = prog["out_n"]
    ec = max(1, min(prog["E"], (1 << 26) // max(1, prog["L"])))
    cfg = ms.chain_cfg(p, prog, ec)
    chunks = ms._chunk_events(prog, cfg)
    res["oa"] = cfg.oa
    oa_len = pallas_oa.buffer_len(out_n, prog["L"])
    er_kernel = space.er_tap_kernel(int(p.er_taps), float(p.er_max_ms),
                                    int(p.base_sr), int(p.seed))
    irm = ir[:8192].astype(np.float32)
    er_comb = np.convolve(er_kernel.astype(np.float64),
                          irm.astype(np.float64)).astype(np.float32)
    fx = ms.FxCfg(out_n=out_n, sr=sr,
                  env=(float(p.env_a), float(p.env_d), float(p.env_s),
                       float(p.env_r), float(p.env_curve)),
                  er_on=True, ir_on=True, stereo_on=True,
                  stereo_width=float(p.stereo_width),
                  sat_drive=float(p.sat_drive), peak=float(p.peak))
    fused = ms._fused_fn(cfg, fx)
    out0 = np.zeros(oa_len, np.float32)

    def dev_only():
        _, _, st = fused(chunks[0], None, er_comb, irm)
        st.block_until_ready()

    res["device_call_nod2h_s"] = round(t_best(dev_only), 4)

    def dev_d2h():
        _, _, st = fused(chunks[0], None, er_comb, irm)
        np.asarray(st)

    res["device_call_d2h_s"] = round(t_best(dev_d2h), 4)

    # chunk only (grain chain + scatter, no FX)
    fn = ms._chunk_fn(cfg)

    def chunk_only():
        _, _, o = fn(chunks[0], None, np.zeros(oa_len, np.float32))
        o.block_until_ready()

    res["chunk_only_s"] = round(t_best(chunk_only), 4)

    # grain chain only (vmapped _one_grain, no scatter)
    import jax.numpy as jnp

    @jax.jit
    def grains_only_f(evs):
        per_ev = {k: v for k, v in evs.items() if not k.startswith("oa_")}
        return jax.vmap(lambda e: ms._one_grain(e, cfg))(per_ev)

    def grains_only():
        g = grains_only_f(chunks[0])
        g.block_until_ready()

    res["grains_only_s"] = round(t_best(grains_only), 4)

    # FX only
    fxf = ms._fx_fn(fx)
    outf = jax.device_put(np.zeros(out_n, np.float32))

    def fx_only():
        st = fxf(outf, er_comb, irm)
        st.block_until_ready()

    res["fx_only_s"] = round(t_best(fx_only), 4)

    res["rtf_full"] = round(seconds / res["full_render_s"], 2)
    res["rtf_nod2h"] = round(seconds / res["device_call_nod2h_s"], 2)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
