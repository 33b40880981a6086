"""Microsound engine vs. NumPy oracle (SURVEY.md §4 test plan): every grain
generator mode, the spectral-warp chain, feedback/imprint recurrences,
multiband unfold, global FX, chunked rendering, and reference-preset
compatibility."""
import glob
import json
import os

import numpy as np
import pytest

from audio_suite_tpu.models import microsound as ms
from audio_suite_tpu.utils.metrics import max_dev_dbfs
from oracles.microsound_ref import render_ref

PRESET_DIR = "/root/reference/microsound_0.2.1/presets"


def small_params(**kw):
    """A fast, fully-featured config: tiny rates so tests stay quick but all
    code paths execute."""
    base = dict(
        base_sr=8000, out_dur_s=0.4, time_unfold=2.0, micro_ms=4.0,
        seed=4242, event_process="Poisson", grains_per_sec=30.0,
        max_grains=64, grain_amp_rand=0.35, grain_offset_on=True,
        grain_offset_max_ms=10.0, bandlimit_on=True, bandlimit_out_hz=3000.0,
        bandlimit_roll_hz=500.0, er_cloud_on=True, er_taps=64, er_max_ms=20.0,
        stereo_on=True, stereo_width=0.6, env_a=5.0, env_d=50.0, env_s=0.7,
        env_r=100.0, bp_density="", bp_unfold="", bp_cutoff="", bp_stretch="",
    )
    base.update(kw)
    return ms.MicrosoundParams.from_dict(base)


def run_both(p, ir_audio=None, img_gray=None, event_chunk=None):
    prog = ms.build_program(p, ir_audio=ir_audio, img_gray=img_gray)
    ref = render_ref(p, prog, ir_audio=ir_audio)
    out, meta = ms.render(p, ir_audio=ir_audio, img_gray=img_gray,
                          event_chunk=event_chunk)
    assert out.shape == ref.shape
    return out, ref, meta


BASIC_MODES = ["Gaussian click", "Dust impulses", "Noise burst",
               "Skewed transient", "Resonant strike"]


@pytest.mark.parametrize("mode", BASIC_MODES)
def test_basic_modes_parity(mode):
    p = small_params(gen_mode=mode, ring_hz=900.0, ring_decay_ms=3.0,
                     dust_density=0.05, noise_tilt=-3.0)
    out, ref, meta = run_both(p)
    assert meta["events"] > 2
    assert max_dev_dbfs(out, ref) <= -60.0


def test_crackle_parity():
    p = small_params(gen_mode="Crackle / corona", crackle_alpha=1.4,
                     crackle_density=60.0, crackle_kernel=32)
    out, ref, _ = run_both(p)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_stick_slip_parity():
    p = small_params(gen_mode="Stick–slip friction", grains_per_sec=15.0)
    out, ref, _ = run_both(p)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_micro_chaos_parity():
    p = small_params(gen_mode="Micro-chaos", grains_per_sec=15.0)
    out, ref, _ = run_both(p)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_wavelet_parity():
    p = small_params(gen_mode="Wavelet atoms", wav_base_hz=600.0,
                     wav_count=4, wav_spread=0.6, micro_ms=10.0,
                     grains_per_sec=12.0)
    out, ref, _ = run_both(p)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_ir_fragment_parity():
    rng = np.random.default_rng(3)
    ir = rng.standard_normal(2048).astype(np.float32) * 0.5
    p = small_params(gen_mode="IR fragment", grains_per_sec=15.0)
    out, ref, _ = run_both(p, ir_audio=ir)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_image_scanline_parity():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(32, 64)).astype(np.float64)
    p = small_params(gen_mode="Image scanline", grains_per_sec=15.0)
    out, ref, _ = run_both(p, img_gray=img)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_warp_chain_parity():
    """nonlinear warp + cepstral warp + partial stretch together."""
    p = small_params(gen_mode="Noise burst", nl_warp_on=True,
                     nl_warp_power=1.4, cep_warp_on=True, cep_factor=1.3,
                     partial_stretch=1.7)
    out, ref, _ = run_both(p)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_partial_lock_parity():
    p = small_params(gen_mode="Resonant strike", ring_hz=700.0,
                     partial_lock_on=True, partial_stretch=2.0,
                     pl_top_n=12, pl_neigh=3)
    out, ref, _ = run_both(p)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_resonator_waveguide_parity():
    p = small_params(gen_mode="Gaussian click", res_bank_on=True,
                     res_modes=8, res_fmin=100.0, res_fmax=2500.0,
                     res_decay_ms=20.0, wg_on=True, wg_lines=2,
                     wg_max_ms=2.0, wg_fb=0.6, grains_per_sec=10.0,
                     out_dur_s=0.25)
    out, ref, _ = run_both(p)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_multiband_unfold_parity():
    p = small_params(gen_mode="Noise burst", unfold_mode="Multi-band unfold",
                     mb_b1=500.0, mb_b2=1500.0, mb_b3=3500.0,
                     mb_u1=3.0, mb_u2=2.0, mb_u3=1.5, mb_roll=200.0,
                     time_unfold=3.0)
    out, ref, _ = run_both(p)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_feedback_imprint_parity():
    p = small_params(gen_mode="Noise burst", event_feedback_on=True,
                     event_feedback_amt=0.4, spectral_imprint_on=True,
                     spectral_imprint_amt=0.35, spectral_imprint_smooth=0.9)
    out, ref, _ = run_both(p)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_breakpoint_lanes_parity():
    """breakpoint automation drives per-event density/unfold/cutoff/stretch
    (and therefore variable grain lengths)."""
    p = small_params(gen_mode="Noise burst",
                     bp_density="0:10, 0.2:60, 0.4:20",
                     bp_unfold="0:1.5, 0.4:3",
                     bp_cutoff="0:2000, 0.4:3500",
                     bp_stretch="0:0.8, 0.4:1.6")
    out, ref, meta = run_both(p)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_chunked_render_matches_unchunked():
    p = small_params(gen_mode="Gaussian click", event_feedback_on=True,
                     event_feedback_amt=0.3)
    out1, _ = ms.render(p, event_chunk=None)
    out2, _ = ms.render(p, event_chunk=3)
    assert max_dev_dbfs(out1, out2) <= -100.0


def test_ir_convolution_and_hawkes():
    rng = np.random.default_rng(11)
    ir = (rng.standard_normal(512) * np.exp(-np.arange(512) / 64.0)) \
        .astype(np.float32)
    p = small_params(gen_mode="Gaussian click", event_process="Hawkes",
                     hawkes_gain=0.8, space_ir_on=True,
                     space_ir_max_samps=512)
    out, ref, _ = run_both(p, ir_audio=ir)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_single_and_clustered_processes():
    for proc in ("Single", "Clustered"):
        p = small_params(gen_mode="Noise burst", event_process=proc)
        out, ref, _ = run_both(p)
        assert max_dev_dbfs(out, ref) <= -60.0, proc


@pytest.mark.skipif(not os.path.isdir(PRESET_DIR),
                    reason="reference presets not mounted")
def test_all_reference_presets_load():
    """All 27 reference preset JSONs load unchanged (main_v2.py:1268-1294
    factory-default merge semantics)."""
    paths = sorted(glob.glob(os.path.join(PRESET_DIR, "*.json")))
    assert len(paths) >= 20
    for path in paths:
        with open(path) as f:
            d = json.load(f)
        p = ms.MicrosoundParams.from_dict(d)
        assert p.gen_mode in ms.GEN_MODES, path
        assert p.base_sr >= 44100
        # the program builder must accept every preset (scaled down so the
        # test stays fast: duration and grain caps only)
        p.out_dur_s = min(p.out_dur_s, 0.05)
        p.max_grains = min(p.max_grains, 4)
        prog = ms.build_program(p)
        assert prog["out_n"] > 0


@pytest.mark.skipif(not os.path.isdir(PRESET_DIR),
                    reason="reference presets not mounted")
def test_all_reference_presets_render():
    """Every reference preset renders end-to-end (scaled to 50 ms / 2 grains
    so the suite stays fast — generator mode, unfold factor, FX switches and
    the rest of the preset are exercised unchanged)."""
    paths = sorted(glob.glob(os.path.join(PRESET_DIR, "*.json")))
    rng = np.random.default_rng(1)
    ir = (rng.standard_normal(2048) * 0.3).astype(np.float32)
    img = rng.integers(0, 256, size=(16, 32)).astype(np.float64)
    rendered = 0
    for path in paths:
        with open(path) as f:
            p = ms.MicrosoundParams.from_dict(json.load(f))
        p.out_dur_s = 0.05
        p.max_grains = 2
        p.micro_ms = min(p.micro_ms, 2.0)
        out, meta = ms.render(p, ir_audio=ir, img_gray=img)
        assert out.shape[0] == int(round(0.05 * p.base_sr)), path
        assert np.isfinite(out).all(), path
        rendered += 1
    assert rendered >= 20


# ---------------------------------------------------------------------------
# Reference-ceiling scale (main_v2.py:894-902: SR up to 192 kHz, duration up
# to 240 s; main_v2.py:596-597: design-rate clamp at 30 MHz)
# ---------------------------------------------------------------------------

def _ceiling_params():
    return ms.MicrosoundParams.from_dict(dict(
        base_sr=192000, out_dur_s=240.0, time_unfold=100.0,
        gen_mode="Noise burst", micro_ms=1.0, grains_per_sec=40.0,
        max_grains=4000, partial_stretch=4.0, bandlimit_on=True,
        bandlimit_out_hz=18000.0, bandlimit_roll_hz=2500.0,
        er_cloud_on=True, space_ir_on=False, stereo_on=True,
        bp_density="", bp_unfold="", bp_cutoff="", bp_stretch="", seed=5))


def test_ceiling_240s_192k_chunked_oa_parity():
    """240 s at 192 kHz (the documented maximum, main_v2.py:894-902) with a
    4000-event field: the event chunking engages (>= 2 chunks), per-chunk
    grain memory stays bounded at <= 2^26 floats, and the overlap-add
    output matches the oracle on a truncated prefix window.  (The
    full-length oracle is infeasible — its FX tail is an O(N*K)
    np.convolve at N = 46 M — but the OA accumulation is causal in event
    start, so the prefix comparison is exact: grain j contributes to
    indices >= start_j only.)"""
    from audio_suite_tpu.ops import pallas_oa
    from oracles.microsound_ref import _one_grain
    import jax.numpy as jnp

    p = _ceiling_params()
    prog = ms.build_program(p)
    assert prog["out_n"] == 46_080_000
    assert prog["E"] == 4000
    L = int(prog["L"])

    ec = max(1, min(ms._next_pow2(max(1, prog["E"])),
                    (1 << 26) // max(1, L)))
    assert ec * L <= (1 << 26)            # bounded grain memory per chunk
    cfg = ms.chain_cfg(p, prog, ec)
    chunks = ms._chunk_events(prog, cfg)
    assert len(chunks) >= 2               # chunking actually engages

    fn = ms._chunk_fn(cfg)
    out = np.zeros(pallas_oa.buffer_len(prog["out_n"], L), np.float32)
    carry = None
    for ch in chunks:
        carry, _, out = fn(ch, carry, out)
    W = 4 * 192000                        # 4 s truncated oracle window
    dev_prefix = np.asarray(out[L:L + W])

    cfg_ref = ms.chain_cfg(p, prog, prog["E"])
    ref = np.zeros(W)
    in_window = 0
    for idx in range(prog["E"]):
        start = int(prog["start"][idx])
        if start >= W:
            continue
        e = {k: prog[k][idx] for k in
             ("seed", "n", "gen_sr", "inv_gen_sr", "amp", "offset",
              "start", "cutoff_gen", "stretch")}
        for k in ("dust_k", "dust_klen", "frag_len"):
            if k in prog:
                e[k] = prog[k][idx]
        g = _one_grain(e, cfg_ref, prog, idx)
        n = int(e["n"])
        off = int(e["offset"])
        lim = min(W - start, n - off)
        if lim > 0:
            ref[start:start + lim] += float(e["amp"]) * g[off:off + lim]
        in_window += 1
    assert in_window >= 32                # the window check is meaningful
    assert max_dev_dbfs(dev_prefix, ref) <= -60.0


def test_ceiling_240s_192k_end_to_end():
    """The full public-API render at the reference ceiling: 240 s at
    192 kHz, 4000 events, chunked chain + global FX + device PCM16 — the
    'arbitrarily dense fields render in bounded memory' claim, demonstrated
    at the documented maximum."""
    import time
    p = _ceiling_params()
    t0 = time.time()
    y, meta = ms.render(p, pcm16=True)
    wall = time.time() - t0
    assert y.shape == (46_080_000, 2)
    assert y.dtype == np.int16
    yf = y[::977].astype(np.float32)      # strided probe: finite + nonzero
    assert np.isfinite(yf).all()
    assert np.abs(y).max() > 1000         # normalized output actually there
    assert meta["events"] == 4000
    print(f"\nceiling end-to-end: {wall:.1f} s wall for 240 s @ 192 kHz")


def test_ceiling_gen_sr_30mhz_clamp_parity():
    """Unfold x200 at 192 kHz pushes the design rate to 38.4 MHz; the
    reference clamps at 30 MHz (main_v2.py:596-597) and so does
    build_program — full render parity vs the oracle at the clamp."""
    p = small_params(
        base_sr=192000, out_dur_s=0.3, time_unfold=200.0, micro_ms=1.0,
        grains_per_sec=30.0, max_grains=12, gen_mode="Noise burst",
        bandlimit_on=True, bandlimit_out_hz=18000.0,
        bandlimit_roll_hz=2500.0, er_cloud_on=False, stereo_on=True,
        grain_offset_on=False)
    prog = ms.build_program(p)
    assert prog["gen_sr_base"] == 30_000_000
    assert np.all(np.asarray(prog["gen_sr"]) == 30_000_000.0)
    assert int(prog["L"]) >= 30_000       # 1 ms of 30 MHz design rate
    out, ref, meta = run_both(p)
    assert max_dev_dbfs(out, ref) <= -60.0


def test_vectorized_build_matches_scalar_twin():
    """build_program (vectorized lanes + minimal rng loop) must equal the
    scalar per-event twin build_program_seq array-for-array: the sequential
    rng(seed+123456) stream order is part of the reference contract
    (main_v2.py:618-755)."""
    rng = np.random.default_rng(11)
    ir = (rng.standard_normal(4096)
          * np.exp(-np.arange(4096) / 800.0)).astype(np.float32)
    img = rng.uniform(0, 255, (32, 200)).astype(np.uint8)
    cases = [dict(gen_mode=m) for m in ms.GEN_MODES]
    cases += [
        dict(gen_mode="Gaussian click", bp_density="0:18, 0.2:40, 0.4:14",
             bp_unfold="0:2, 0.3:8", bp_cutoff="0:3000, 0.4:800",
             bp_stretch="0:1.0, 0.2:2.5"),
        dict(gen_mode="Resonant strike", res_bank_on=True, wg_on=True),
        dict(gen_mode="Noise burst", grain_offset_on=False),
        dict(gen_mode="Noise burst", grain_offset_max_ms=0.0),
        dict(gen_mode="Dust impulses", event_process="Clustered"),
        dict(gen_mode="Crackle / corona", event_process="Hawkes"),
        dict(gen_mode="Noise burst", event_process="Single"),
        dict(gen_mode="Noise burst", out_dur_s=0.05),
    ]
    for c in cases:
        p = small_params(**c)
        kw = {}
        if c["gen_mode"] == "IR fragment":
            kw["ir_audio"] = ir
        if c["gen_mode"] == "Image scanline":
            kw["img_gray"] = img
        a = ms.build_program_seq(p, **kw)
        b = ms.build_program(p, **kw)
        assert set(a.keys()) == set(b.keys()), c
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, (c, k)
                assert np.array_equal(a[k], b[k]), (c, k)
            else:
                assert a[k] == b[k], (c, k)
    # IR fragment with no IR loaded falls back to the 16-sample floor
    p = small_params(gen_mode="IR fragment")
    a = ms.build_program_seq(p)
    b = ms.build_program(p)
    for k in a:
        ok = (np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
              else a[k] == b[k])
        assert ok, k
