"""Dissect the microsound fused-call cost on the current device
(bench config 3 shapes): chain vs FX vs sub-stages.

    python tools/ms_profile.py
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

from audio_suite_tpu.models import microsound as ms
from audio_suite_tpu.ops import pallas_oa, space, spectral


def drain(y):
    return float(jnp.sum(jnp.abs(jnp.ravel(y)).astype(jnp.float32)))


K = 20
_NULL = None


def _null_latency():
    """Measured K-amortized drain-roundtrip floor (same protocol as
    bench.py): without it the dispatch-and-drain roundtrip divided by K
    reads as per-call cost and dwarfs the cheap sub-stages."""
    global _NULL
    if _NULL is None:
        f = jax.jit(lambda v: v + 1.0)
        x = jnp.zeros((), jnp.float32)
        float(f(x))
        t0 = time.perf_counter()
        for _ in range(K):
            y = f(x)
        float(y)
        _NULL = (time.perf_counter() - t0) / K
    return _NULL


def time_device(fn, K=K):
    null = _null_latency()
    y = fn()
    drain(y)
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(K):
            y = fn()
        drain(y)
        t = (time.perf_counter() - t0) / K - null
        best = t if best is None else min(best, t)
    return max(1e-9, best)


def main():
    print("device:", jax.devices()[0])
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
    prog = ms.build_program(p, ir_audio=ir)
    print("E", prog["E"], "L", prog["L"], "out_n", prog["out_n"])
    np2 = ms._next_pow2(max(1, prog["E"]))
    quantum = max(8, np2 // 16)
    ec = max(1, min(-(-prog["E"] // quantum) * quantum,
                    (1 << 26) // max(1, prog["L"])))
    cfg = ms.chain_cfg(p, prog, ec)
    chunks = ms._chunk_events(prog, cfg)
    print("ec", ec, "chunks", len(chunks), "oa", cfg.oa)
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
    for v in c0.values():
        v.block_until_ready()
    er_d = jax.device_put(jnp.asarray(er_comb))
    ir_d = jax.device_put(jnp.asarray(irm))

    t_fused = time_device(lambda: fused(c0, None, er_d, ir_d)[2])
    print(f"fused total: {t_fused*1e3:.2f} ms  RTF {seconds/t_fused:.0f}")

    # chain only (chunk -> OA buffer), no FX
    oa_len = pallas_oa.buffer_len(cfg.out_n, cfg.L)
    chain = ms.chunk_body(cfg)

    @jax.jit
    def chain_only(evs):
        out = jnp.zeros(oa_len, jnp.float32)
        _, _, out = chain(evs, None, out)
        return out

    t_chain = time_device(lambda: chain_only(c0))
    print(f"chain+OA: {t_chain*1e3:.2f} ms")

    # generate only
    per_ev = {k: v for k, v in c0.items() if not k.startswith("oa_")}

    @jax.jit
    def gen_only(evs):
        return jax.vmap(lambda e: ms._generate(e, cfg))(evs)

    t_gen = time_device(lambda: gen_only(per_ev))
    print(f"generate: {t_gen*1e3:.2f} ms")

    # generate + shared lowpass-stretch
    @jax.jit
    def gen_lp(evs):
        raw = jax.vmap(lambda e: ms._generate(e, cfg))(evs)
        x = spectral.lowpass_stretch_fused_shared(
            raw, evs["gen_sr"], evs["cutoff_gen"], evs["stretch"][0],
            roll=cfg.bandlimit_roll)
        return x

    if cfg.shared_stretch:
        t_genlp = time_device(lambda: gen_lp(per_ev))
        print(f"generate+lp_stretch: {t_genlp*1e3:.2f} ms "
              f"(lp_stretch ~ {(t_genlp-t_gen)*1e3:.2f} ms)")

    # fx only
    fxf = ms._fx_fn(fx)
    audio_dev = jax.device_put(
        jnp.asarray(rng.standard_normal(prog["out_n"]).astype(np.float32)))
    audio_dev.block_until_ready()
    t_fx = time_device(lambda: fxf(audio_dev, er_d, ir_d))
    print(f"fx total: {t_fx*1e3:.2f} ms")

    # fx sub-stages
    from audio_suite_tpu.ops import envelopes
    a, d, s, r, curve = fx.env

    env_fn = jax.jit(lambda x: x * envelopes.make_adsr(
        fx.out_n, fx.sr, a, d, s, r, curve))
    t_env = time_device(lambda: env_fn(audio_dev))
    print(f"  adsr mul: {t_env*1e3:.2f} ms")

    # jit ONCE outside the timed lambda: a fresh jax.jit(...) object per
    # call misses the jit cache and re-compiles every iteration — the
    # sub-stage numbers used to read seconds of compile time as "cost"
    conv_fn = jax.jit(space.fft_convolve_causal)
    t_conv = time_device(lambda: conv_fn(audio_dev, er_d))
    print(f"  partitioned conv (er*ir {er_comb.shape[0]}): "
          f"{t_conv*1e3:.2f} ms")

    st_fn = jax.jit(lambda x: space.spectral_diffusion_stereo(
        x, fx.sr, width=fx.stereo_width))
    t_st = time_device(lambda: st_fn(audio_dev))
    print(f"  stereo diffusion: {t_st*1e3:.2f} ms")

    tail_fn = jax.jit(lambda x: jnp.clip(jnp.round(space.normalize(
        space.soft_clip(jnp.stack([x, x], -1), drive=fx.sat_drive),
        peak=fx.peak) * 32768.0), -32768.0, 32767.0).astype(jnp.int16))
    t_tail = time_device(lambda: tail_fn(audio_dev))
    print(f"  clip+norm+pcm16: {t_tail*1e3:.2f} ms")


if __name__ == "__main__":
    main()
