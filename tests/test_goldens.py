"""Golden regression snapshots.

The parity tests compare engines against NumPy oracles that live in this
repo — a paired engine+oracle change could drift semantics silently.  These
tests pin absolute outputs across ≥3 fixtures per engine (incl. grid, the
round-4 TapeTrace / key-event scrub paths, and the sinc quality mode):

- 64 decimated sample values (catch waveform changes),
- full-length RMS in dB (catch global gain/energy drift the decimation
  grid could miss),
- 8 octave-band energies in dB (catch spectrally localized drift — a
  filter-cutoff bug that leaves broadband RMS almost unchanged),

plus short-render fingerprints for every reference microsound preset and a
mutation check proving a 1e-3 perturbation in any single pipeline stage
fails at least one golden.

Values are compared at the 1e-4 level (samples) / 0.01 dB (energies), not
bit patterns, so results survive XLA/NumPy version bumps while catching
any real semantic change.

Regenerate intentionally with:
    python tests/test_goldens.py regen            # named fixtures
    python tests/test_goldens.py regen-presets    # reference presets
"""
import glob
import json
import os
import sys

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GOLDEN_PATH = os.path.join(GOLDEN_DIR, "fingerprints.json")
PRESET_GOLDEN_PATH = os.path.join(GOLDEN_DIR, "preset_fingerprints.json")
PRESET_DIR = "/root/reference/microsound_0.2.1/presets"
TOL = 1e-4       # decimated samples (abs)
TOL_DB = 0.01    # RMS / band energies (dB)


def _fingerprint(x, k=64):
    """Decimated samples + full-length RMS + 8 octave-band energies."""
    x = np.asarray(x, np.float64)
    flat = x.ravel()
    idx = np.linspace(0, len(flat) - 1, k).astype(int)
    samples = [round(float(v), 6) for v in flat[idx]]
    rms = float(np.sqrt(np.mean(flat * flat)))
    rms_db = round(20.0 * np.log10(max(rms, 1e-12)), 4)
    # octave bands descending from Nyquist on the (possibly multichannel)
    # signal flattened channel-major: band i covers normalized frequency
    # (2^-(8-i), 2^-(7-i)] of Nyquist, band 0 additionally absorbs DC..2^-8
    spec = np.abs(np.fft.rfft(flat)) ** 2
    n = len(spec)
    edges = [0] + [max(1, int(n * 2.0 ** -(8 - i))) for i in range(9)]
    bands = []
    for i in range(8):
        e = float(np.sum(spec[edges[i]:edges[i + 1]]))
        bands.append(round(10.0 * np.log10(max(e, 1e-20)), 4))
    return {"samples": samples, "rms_db": rms_db, "bands_db": bands}


def _compare(key, got, want):
    """Raise AssertionError if fingerprints differ beyond tolerance."""
    if isinstance(want, list):  # integer stats rows
        assert got == want, (key, "stats mismatch")
        return
    a = np.asarray(got["samples"], np.float64)
    b = np.asarray(want["samples"], np.float64)
    assert a.shape == b.shape, key
    dev = float(np.max(np.abs(a - b)))
    assert dev <= TOL, (key, "samples", dev)
    assert abs(got["rms_db"] - want["rms_db"]) <= TOL_DB, (key, "rms")
    ba = np.asarray(got["bands_db"], np.float64)
    bb = np.asarray(want["bands_db"], np.float64)
    assert float(np.max(np.abs(ba - bb))) <= TOL_DB, (key, "bands")


def _matches(got, want):
    try:
        _compare("", got, want)
        return True
    except AssertionError:
        return False


# ---------------------------------------------------------------------------
# Fixture configs.  Each builder takes an optional `mut` dict used by the
# mutation-sensitivity test to perturb exactly one pipeline stage by a 1e-3
# relative factor; mut=None renders the golden config.
# ---------------------------------------------------------------------------

SR = 8000
EPS = 1e-3


def _test_audio(scale=1.0):
    t = np.arange(SR * 2) / SR
    return (scale * (0.5 * np.sin(2 * np.pi * 220 * t)
                     + 0.25 * np.sin(2 * np.pi * 933 * t))).astype(np.float32)


def _m(mut, stage, base):
    """base * (1+EPS) when this stage is the mutated one."""
    return base * (1.0 + EPS) if mut == stage else base


def render_tape(mut=None):
    from audio_suite_tpu.models import tape
    p = tape.TapeParams(
        sample_rate=SR, markers=[6000, 11000],
        section_speeds=[1.0, _m(mut, "speed", 2.0), 0.5],
        section_reverse=[False, True, False],
        tape_age=_m(mut, "age", 70.0), inertia_enabled=True,
        inertia_amount=_m(mut, "inertia", 50.0))
    return tape.render_tape(_test_audio(_m(mut, "input", 1.0)), p, 20000)


def render_tape_splicefx(mut=None):
    from audio_suite_tpu.models import tape
    p = tape.TapeParams(
        sample_rate=SR, markers=[4000, 9000, 13000],
        section_speeds=[0.7, 1.4, _m(mut, "speed", 2.2), 0.9],
        section_reverse=[True, False, False, True],
        tape_age=_m(mut, "age", 30.0), enable_splice_fx=True,
        anticlick_enabled=True)
    return tape.render_tape(_test_audio(), p, 18000)


def render_tape_trace(mut=None):
    from audio_suite_tpu.models import tape
    tr = tape.TapeTrace()
    tr.add(0.20, "set_speed", section=0, value=_m(mut, "trace_speed", 1.7))
    tr.add(0.45, "set_reverse", section=1, value=True)
    tr.add(0.70, "set_age", value=95)
    tr.add(0.90, "add_marker", sample=SR // 2)
    tr.add(1.10, "set_inertia", value=True)
    tr.add(1.40, "seek", sample=100)
    tr.add(1.60, "retime", target=_m(mut, "retime", 1.2))
    p = tape.TapeParams(sample_rate=SR, markers=[5000, 10000],
                        section_speeds=[1.0, 0.5, 2.0],
                        section_reverse=[False, False, True],
                        tape_age=40, current_speed=1.0)
    return tape.render_tape_trace(_test_audio(), p, tr, num_frames=SR * 2)


def render_tape_sinc(mut=None):
    from audio_suite_tpu.models import tape
    p = tape.TapeParams(sample_rate=SR, markers=[7000],
                        section_speeds=[1.3, _m(mut, "speed", 0.6)],
                        section_reverse=[False, True],
                        tape_age=55.0)
    return tape.render_tape(_test_audio(), p, 16000, interp="sinc")


def render_scrub(mut=None):
    from audio_suite_tpu.models import scrub
    cfg = scrub.ScrubConfig(sample_rate=SR, seed=5, head_count=3)
    trace = scrub.scripted_gesture_trace(
        30, SR, drag_events=[(0.5, _m(mut, "drag", 5.0), 0.5)],
        base_speed=_m(mut, "base_speed", 0.5), jumps=[(2.0, 4000.0)])
    return scrub.render_scrub(_test_audio(), cfg, trace)


def render_scrub_keys(mut=None):
    from audio_suite_tpu.models import scrub
    cfg = scrub.ScrubConfig(sample_rate=SR, seed=5, head_count=3)
    trace = scrub.scripted_gesture_trace(
        40, SR, drag_events=[(0.3, 4.0, 0.4)],
        base_speed=_m(mut, "base_speed", 0.5), jumps=[(0.9, 3000.0)],
        key_events=[(0.2, "2"), (0.4, "Z"), (0.6, "1"), (0.8, "V"),
                    (1.0, "3"), (1.2, "Down")])
    return scrub.render_scrub(_test_audio(_m(mut, "input", 1.0)), cfg,
                              trace, 2000.0)


def render_scrub_sinc(mut=None):
    from audio_suite_tpu.models import scrub
    cfg = scrub.ScrubConfig(sample_rate=SR, seed=11, head_count=1)
    trace = scrub.scripted_gesture_trace(
        30, SR, drag_events=[(0.4, _m(mut, "drag", -6.0), 0.6)],
        base_speed=0.8)
    return scrub.render_scrub(_test_audio(), cfg, trace, interp="sinc")


def render_microsound(mut=None):
    from audio_suite_tpu.models import microsound as ms
    mp = ms.MicrosoundParams.from_dict(dict(
        base_sr=SR, out_dur_s=0.4, time_unfold=_m(mut, "unfold", 2.0),
        micro_ms=4.0, gen_mode="Noise burst",
        grains_per_sec=25.0, max_grains=16,
        partial_stretch=_m(mut, "stretch", 1.5), er_taps=32,
        er_max_ms=_m(mut, "er", 15.0), seed=99,
        # env stage mutated via the CONTINUOUS curve exponent: attack ms is
        # rounded to integer samples (make_adsr, matching the reference),
        # so a 1e-3 bump of a_ms=20 is legitimately bit-identical
        env_a=20.0, env_s=_m(mut, "env", 0.65),
        bp_density="", bp_unfold="", bp_cutoff="", bp_stretch=""))
    out, _ = ms.render(mp)
    return out


def render_microsound_chaos(mut=None):
    from audio_suite_tpu.models import microsound as ms
    mp = ms.MicrosoundParams.from_dict(dict(
        base_sr=SR, out_dur_s=0.4, time_unfold=3.0, micro_ms=8.0,
        gen_mode="Micro-chaos", chaos_r=3.92, chaos_gate=0.35,
        grains_per_sec=15.0, max_grains=12, nl_warp_on=True,
        nl_warp_power=_m(mut, "warp", 1.25),
        bandlimit_on=True, bandlimit_out_hz=_m(mut, "cutoff", 3000.0),
        bandlimit_roll_hz=500.0, seed=41, er_cloud_on=False,
        bp_density="", bp_unfold="", bp_cutoff="", bp_stretch=""))
    out, _ = ms.render(mp)
    return out


def render_microsound_cepstral(mut=None):
    from audio_suite_tpu.models import microsound as ms
    mp = ms.MicrosoundParams.from_dict(dict(
        base_sr=SR, out_dur_s=0.4, time_unfold=2.5, micro_ms=6.0,
        gen_mode="Crackle / corona", crackle_density=150.0,
        cep_warp_on=True, cep_factor=_m(mut, "cepstral", 1.2),
        grains_per_sec=20.0, max_grains=12, stereo_on=True,
        stereo_width=_m(mut, "width", 0.65), seed=17, er_cloud_on=False,
        bp_density="", bp_unfold="", bp_cutoff="", bp_stretch=""))
    out, _ = ms.render(mp)
    return out


def render_patternlab(mut=None):
    from audio_suite_tpu.models import patternlab as pl
    rc = pl.RenderConfig(sample_rate=22050, seconds=1.0,
                         bpm=_m(mut, "bpm", 140.0),
                         master_gain=_m(mut, "gain", 0.9), seed=4)
    y, _ = pl.render(pl.generate("Glass Cells", rc), rc)
    return y


def render_patternlab_fib(mut=None):
    from audio_suite_tpu.models import patternlab as pl
    rc = pl.RenderConfig(sample_rate=22050, seconds=1.5, bpm=150.0,
                         swing=_m(mut, "swing", 0.3),
                         micro_jitter=2.0, seed=8)
    y, _ = pl.render(pl.generate("Fibonacci Gate", rc), rc)
    return y


def render_patternlab_canon(mut=None):
    from audio_suite_tpu.models import patternlab as pl
    rc = pl.RenderConfig(sample_rate=22050, seconds=1.5, bpm=120.0,
                         time_stretch=_m(mut, "stretch", 1.25), seed=3)
    y, _ = pl.render(pl.generate("Pythagorean Canon", rc), rc)
    return y


_JAX_CELLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "audio_suite_tpu", "plugins",
    "jax_cells.py")


def _grid_project(mut):
    from audio_suite_tpu.models import grid
    cell = grid.CellSource(kind="py", path=_JAX_CELLS)
    empty = grid.CellSource()
    t0 = grid.Track(name="pulse", mode="tempo_bpm", bpm=120.0,
                    beats_per_measure=4, measures=1, loop_to_master=True,
                    uniform_n=8,
                    cells=[cell, empty, cell, empty,
                           cell, empty, cell, empty])
    t1 = grid.Track(name="tone", mode="duration", duration_seconds=2.0,
                    loop_to_master=True, uniform_n=4,
                    gain_db=_m(mut, "gain", -6.0),
                    mod_source_index=0, mod_amount=_m(mut, "mod", 0.6),
                    mod_smoothing_ms=_m(mut, "smooth", 40.0),
                    sync_points_text="1.0, 2.6",
                    cells=[cell, empty, empty, cell])
    return grid.GridProject(
        sample_rate=22050, normalize=False,
        master=grid.MasterClock(mode="fixed_seconds", fixed_seconds=4.0),
        tracks=[t0, t1])


def render_grid(mut=None):
    from audio_suite_tpu.models import grid
    return grid.render_mixdown(_grid_project(mut))


def render_grid_pydiv(mut=None):
    from audio_suite_tpu.models import grid
    prj = _grid_project(mut)
    prj.tracks[0].division_mode = "python"
    prj.tracks[0].python_code = (
        "def divisions(total):\n"
        "    w = [1.0, 2.0, 1.0, 3.0, 1.0, 2.0]\n"
        "    s = sum(w)\n"
        "    return [total * x / s for x in w]\n")
    prj.tracks[0].ensure_cells(6)
    return grid.render_mixdown(prj)


def render_grid_host(mut=None):
    """Host-twin engine on the offset/restart config (bit-identical to
    device by construction; pins the twin independently)."""
    from audio_suite_tpu.models import grid
    prj = _grid_project(mut)
    prj.tracks[1].start_offset_seconds = -0.35
    return grid.render_mixdown(prj, engine="host")


def _forest_model(mut, seed=9, w=64, h=48):
    from audio_suite_tpu.models import forestfire as ff
    p = ff.ModelParams(
        w=w, h=h,
        base_spread=_m(mut, "spread", 0.37),
        rain_chance=_m(mut, "rain", 0.015),
        regrow_rate=_m(mut, "regrow", 0.006),
        wind_strength=_m(mut, "wind", 0.75))
    model = ff.ForestFireModel(p, seed=seed)
    model.ignite_at(30, 20, radius=3)
    return model


def render_forest_stats(mut=None):
    # 600 steps: a 1e-3 probability perturbation flips a Bernoulli draw
    # only when a uniform lands inside the moved window — ~50 steps of
    # draws was measurably too few for the mutation check (zero flips),
    # 500+ flips reliably
    m = _forest_model(mut)
    return [int(v) for v in np.asarray(m.simulate(600)).sum(axis=0)]


def render_forest_rgb(mut=None):
    m = _forest_model(mut, seed=21)
    m.simulate(40)
    return np.asarray(m.render_rgb(), np.float64) / 255.0


def render_forest_windy(mut=None):
    # dry, lightning-heavy config: fire must stay ALIVE for the whole run
    # or the wind mutation has no draws to act on (at rain_chance=0.05 the
    # burn dies out by step ~60 and the check was insensitive)
    from audio_suite_tpu.models import forestfire as ff
    p = ff.ModelParams(w=96, h=64, wind_dir_deg=190.0,
                       wind_strength=_m(mut, "wind", 1.4),
                       rain_chance=_m(mut, "rain", 0.01),
                       lightning_rate=2e-4)
    m = ff.ForestFireModel(p, seed=33)
    m.ignite_at(48, 32, radius=4)
    return [int(v) for v in np.asarray(m.simulate(400)).sum(axis=0)]


FIXTURES = {
    "tape": render_tape,
    "tape_splicefx": render_tape_splicefx,
    "tape_trace": render_tape_trace,
    "tape_sinc": render_tape_sinc,
    "scrub": render_scrub,
    "scrub_keys": render_scrub_keys,
    "scrub_sinc": render_scrub_sinc,
    "microsound": render_microsound,
    "microsound_chaos": render_microsound_chaos,
    "microsound_cepstral": render_microsound_cepstral,
    "patternlab": render_patternlab,
    "patternlab_fib": render_patternlab_fib,
    "patternlab_canon": render_patternlab_canon,
    "grid": render_grid,
    "grid_pydiv": render_grid_pydiv,
    "grid_host": render_grid_host,
    "forestfire_stats": render_forest_stats,
    "forestfire_rgb": render_forest_rgb,
    "forestfire_windy": render_forest_windy,
}

# (fixture, stage) pairs for the mutation-sensitivity check: every pipeline
# stage of every engine, perturbed by 1e-3, must fail its golden.
MUTATIONS = [
    ("tape", "input"), ("tape", "speed"), ("tape", "age"),
    ("tape", "inertia"),
    ("tape_splicefx", "speed"), ("tape_splicefx", "age"),
    ("tape_trace", "trace_speed"), ("tape_trace", "retime"),
    ("tape_sinc", "speed"),
    ("scrub", "drag"), ("scrub", "base_speed"),
    ("scrub_keys", "base_speed"), ("scrub_keys", "input"),
    ("scrub_sinc", "drag"),
    ("microsound", "unfold"), ("microsound", "stretch"),
    ("microsound", "er"), ("microsound", "env"),
    ("microsound_chaos", "warp"), ("microsound_chaos", "cutoff"),
    ("microsound_cepstral", "cepstral"), ("microsound_cepstral", "width"),
    ("patternlab", "bpm"), ("patternlab", "gain"),
    ("patternlab_fib", "swing"), ("patternlab_canon", "stretch"),
    ("grid", "gain"), ("grid", "mod"), ("grid", "smooth"),
    ("grid_host", "gain"),
    ("forestfire_stats", "spread"), ("forestfire_windy", "wind"),
]


def _render_all():
    return {k: (fn() if k.endswith(("stats", "windy"))
                else _fingerprint(fn()))
            for k, fn in FIXTURES.items()}


def _render_presets():
    """Short-render fingerprints for every reference microsound preset
    (scaled like test_all_reference_presets_render: 50 ms / 2 grains so
    the generator mode, unfold chain and FX switches of each preset are
    exercised with bounded suite cost)."""
    from audio_suite_tpu.models import microsound as ms
    rng = np.random.default_rng(1)
    ir = (rng.standard_normal(2048) * 0.3).astype(np.float32)
    img = rng.integers(0, 256, size=(16, 32)).astype(np.float64)
    out = {}
    for path in sorted(glob.glob(os.path.join(PRESET_DIR, "*.json"))):
        with open(path) as f:
            p = ms.MicrosoundParams.from_dict(json.load(f))
        p.out_dur_s = 0.05
        p.max_grains = 2
        p.micro_ms = min(p.micro_ms, 2.0)
        stereo, _ = ms.render(p, ir_audio=ir, img_gray=img)
        if float(np.max(np.abs(stereo))) == 0.0:
            # sparse schedulers (e.g. 18 grains/s under x25 unfold) place no
            # grain inside 50 ms — a silent fingerprint pins nothing, so
            # widen the window until the preset actually sounds
            p.out_dur_s = 0.5
            p.max_grains = 8
            stereo, _ = ms.render(p, ir_audio=ir, img_gray=img)
        name = os.path.splitext(os.path.basename(path))[0]
        out[f"preset:{name}"] = _fingerprint(stereo, k=32)
    return out


def test_goldens_match():
    with open(GOLDEN_PATH) as f:
        want = json.load(f)
    got = _render_all()
    assert set(got) == set(want)
    assert len(want) >= 19
    for key in want:
        _compare(key, got[key], want[key])


@pytest.mark.skipif(not os.path.isdir(PRESET_DIR),
                    reason="reference presets not mounted")
def test_preset_goldens_match():
    with open(PRESET_GOLDEN_PATH) as f:
        want = json.load(f)
    got = _render_presets()
    assert set(got) == set(want)
    assert len(want) >= 20
    for key in want:
        _compare(key, got[key], want[key])


@pytest.mark.parametrize("fixture,stage", MUTATIONS,
                         ids=[f"{f}:{s}" for f, s in MUTATIONS])
def test_golden_mutation_sensitivity(fixture, stage):
    """A 1e-3 relative perturbation in any single pipeline stage must fail
    the fixture's golden — proves the fingerprints actually constrain each
    stage rather than fingerprinting dead parameters."""
    with open(GOLDEN_PATH) as f:
        want = json.load(f)[fixture]
    got = FIXTURES[fixture](mut=stage)
    if not isinstance(want, list):
        got = _fingerprint(got)
    assert not _matches(got, want), (fixture, stage, "golden insensitive")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        with open(GOLDEN_PATH, "w") as f:
            json.dump(_render_all(), f, indent=1)
        print(f"wrote {GOLDEN_PATH} ({len(FIXTURES)} fixtures)")
    elif len(sys.argv) > 1 and sys.argv[1] == "regen-presets":
        data = _render_presets()
        with open(PRESET_GOLDEN_PATH, "w") as f:
            json.dump(data, f, indent=1)
        print(f"wrote {PRESET_GOLDEN_PATH} ({len(data)} presets)")
