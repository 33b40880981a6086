"""Pattern Lab: kernel-level and end-to-end parity vs. the NumPy oracle."""
import numpy as np
import jax.numpy as jnp
import pytest

from audio_suite_tpu.events.notes import NoteEvent, RenderConfig, apply_time_ops
from audio_suite_tpu.models import patternlab as pl
from audio_suite_tpu.ops import synth as synth_ops
from audio_suite_tpu.utils.metrics import max_dev_dbfs
from audio_suite_tpu.utils import music
from oracles import patternlab_ref as ref

SR = 44100


def test_lfsr_orbit_matches_sequential():
    orbit, base, pos, clen = synth_ops.lfsr_tables()
    for seed in [1, 2, 77, 12345, 0x7FFF]:
        n = 500
        want = ref._noise_lfsr(n, seed=seed)
        i = jnp.arange(n, dtype=jnp.int32)
        got = np.asarray(synth_ops.lfsr_noise(
            i, jnp.int32(seed), jnp.asarray(orbit), jnp.asarray(base),
            jnp.asarray(pos), jnp.asarray(clen)))
        assert np.array_equal(got, want), f"LFSR mismatch for seed {seed}"


def test_adsr_matches_reference():
    from audio_suite_tpu.ops.envelopes import adsr_clamped
    for n in [50, 441, 4410, 22050]:
        for (a, d, s, r) in [(0.01, 0.2, 0.6, 0.15), (0.5, 0.5, 0.3, 0.5),
                             (0.001, 0.0, 1.0, 0.001)]:
            want = ref._adsr_env(n, SR, a, d, s, r, 0.004, 0.008)
            A = int(SR * max(0.004, a))
            D = int(SR * max(1e-4, d))
            R = int(SR * max(0.008, r))
            i = jnp.arange(n, dtype=jnp.int32)
            got = np.asarray(adsr_clamped(i, n, A, D, R, np.float32(s)))
            assert np.max(np.abs(got - want)) < 1e-5, (n, a, d, s, r)


def test_fm_note_parity():
    n = 8000
    chans = pl.default_fm_channels()
    tab = pl._fm_channel_tables(chans, SR)
    s = pl.MegaDriveInspiredSynth(SR)
    i = jnp.arange(8192, dtype=jnp.int32)
    for chan in range(6):
        cp = {k: jnp.asarray(tab[k][chan]) for k in tab
              if not k.startswith("_")}
        f_ops = pl.fm_op_freqs(tab, np.asarray([chan]), np.asarray([60.0]))[0]
        got = np.asarray(synth_ops.fm_note(
            i, jnp.int32(n), jnp.asarray(f_ops),
            jnp.float32(0.8), cp, s._fade, jnp.float32(s._lp1),
            jnp.float32(s._lp2), jnp.float32(s._dac_m1),
            jnp.float32(np.float32(1.0 / float(s._dac_m1))), SR))[:n]
        want = ref.render_fm_note_np(SR, n, 60.0, 0.8, chans[chan])
        assert max_dev_dbfs(got, want) <= -60.0, f"chan {chan}"


def test_psg_note_parity():
    n = 4000
    chans = pl.default_psg_channels()
    tab = pl._psg_channel_tables(chans, SR)
    s = pl.MegaDriveInspiredSynth(SR)
    orbit, base, pos, clen = synth_ops.lfsr_tables()
    i = jnp.arange(4096, dtype=jnp.int32)
    for chan in range(4):
        got = np.asarray(synth_ops.psg_note(
            i, jnp.int32(n), jnp.float32(music.midi_to_hz(57.0)),
            jnp.float32(0.7), jnp.float32(tab["duty"][chan]),
            jnp.bool_(tab["noise"][chan]), jnp.int32(tab["A"][chan]),
            jnp.int32(tab["D"][chan]), jnp.int32(tab["R"][chan]),
            jnp.float32(tab["s"][chan]), jnp.float32(tab["levels_m1"][chan]),
            jnp.float32(tab["inv_levels_m1"][chan]),
            s._fade, jnp.float32(s._psg_lp), jnp.int32(101),
            jnp.asarray(orbit), jnp.asarray(base), jnp.asarray(pos),
            jnp.asarray(clen), SR))[:n]
        want = ref.render_psg_note_np(SR, n, 57.0, 0.7, chans[chan], seed=101)
        assert max_dev_dbfs(got, want) <= -60.0, f"chan {chan}"


@pytest.mark.parametrize("gen_name", ["Glass Cells", "Fibonacci Gate",
                                      "Prime Phase", "Pythagorean Canon"])
def test_full_render_parity(gen_name):
    cfg = RenderConfig(sample_rate=SR, seconds=2.0, bpm=140.0, swing=0.1,
                       micro_jitter=0.002, seed=42)
    events = pl.generate(gen_name, cfg)
    assert len(events) > 0
    got, ev = pl.render(events, cfg)
    want = ref.render_np(ev, cfg)
    assert got.shape == want.shape
    assert max_dev_dbfs(got, want) <= -60.0
    assert np.max(np.abs(got)) > 0.01  # actually made sound


def test_apply_time_ops_swing():
    cfg = RenderConfig(bpm=120.0, swing=0.3, time_stretch=1.0,
                       micro_jitter=0.0)
    sec_16 = 60.0 / 120.0 / 4.0
    events = [NoteEvent(t0=0.0, dur=0.1, midi=60),
              NoteEvent(t0=sec_16, dur=0.1, midi=60)]
    out = apply_time_ops(events, cfg)
    assert out[0].t0 == 0.0
    assert abs(out[1].t0 - (sec_16 + 0.3 * sec_16)) < 1e-9


def test_generators_ignore_unknown_kwargs():
    """Reference bug fixed: ui_main.py:414-428 passes kwargs patterns.py
    generators don't accept (TypeError in the reference)."""
    cfg = RenderConfig(seconds=1.0)
    ev = pl.pattern_fibonacci(cfg, pulse_every=4, base_step=0.25)
    assert len(ev) > 0
    ev = pl.pattern_prime_phase(cfg, prime_a=23, prime_b=31)
    assert len(ev) > 0


def test_preset_roundtrip(tmp_path):
    preset = {"name": "t", "generator": "Glass Cells",
              "cfg": {"sample_rate": SR, "seconds": 1.0, "seed": 3},
              "gen": {"root_midi": 57, "voices": 1}}
    p = tmp_path / "p.json"
    pl.save_preset(p, preset)
    loaded = pl.load_preset(p)
    assert loaded == preset
    y, ev = pl.render_preset(loaded)
    assert y.shape[0] == SR
    assert np.max(np.abs(y)) > 0.01


def test_euclidean_rhythm():
    pat = music.euclidean_rhythm(8, 3)
    assert pat.sum() == 3 and len(pat) == 8
    pat = music.euclidean_rhythm(16, 16)
    assert pat.sum() == 16
    pat = music.euclidean_rhythm(13, 0)
    assert pat.sum() == 0


def test_script_generator(tmp_path):
    script = tmp_path / "gen.py"
    script.write_text(
        "from audio_suite_tpu.events.notes import NoteEvent\n"
        "def generate(cfg, root=60, **kw):\n"
        "    return [NoteEvent(t0=0.1*i, dur=0.2, midi=root+i) for i in range(4)]\n")
    cfg = RenderConfig(seconds=1.0)
    ev = pl.generate("Python Script", cfg, script_path=str(script), root=50)
    assert len(ev) == 4 and ev[0].midi == 50


def test_long_render_parity_floor():
    """Quantizer-flip floor on a LONG render: >= 60 s and
    >= 2k notes must stay within the -60 dBFS budget.  The FMA/division
    hardening in ops/synth.py (reciprocal-multiply t, f32 quantizer twin,
    12-bit-rounded PM/feedback operands) keeps residual flips at the
    single-14-bit-step level (~-78 dBFS)."""
    cfg = RenderConfig(sample_rate=SR, seconds=62.0, bpm=140.0, seed=5)
    events = []
    for k in range(8):
        c2 = RenderConfig(sample_rate=SR, seconds=62.0, bpm=140.0, seed=5 + k)
        evs = (pl.generate("Glass Cells", c2)
               + pl.generate("Fibonacci Gate", c2))
        for e in evs:
            e.t0 += k * 7.75
        events.extend(evs)
    assert len(events) >= 2000, len(events)
    got, ev = pl.render(events, cfg)
    want = ref.render_np(ev, cfg)
    assert max_dev_dbfs(got, want) <= -60.0
    assert np.max(np.abs(got)) > 0.01
