"""Unit coverage for the ops/utils layers: deterministic noise twins,
cycle-domain transcendentals, fixed-point math, significand rounding,
breakpoints, schedulers, music math, WAV codec, OSC vs rules interplay."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from audio_suite_tpu.ops import detmath, fixq, noise
from audio_suite_tpu.utils import music
from audio_suite_tpu.utils.breakpoints import eval_breakpoints, parse_breakpoints
from audio_suite_tpu.events.schedulers import generate_event_times


def test_noise_twins_bit_identical():
    i = np.arange(4096, dtype=np.uint32)
    for stream in (0, 3, 17):
        for seed in (0, 1, 123456789):
            a = np.asarray(jax.jit(
                lambda: noise.uniform(jnp.uint32(seed), jnp.asarray(i),
                                      jnp.uint32(stream)))())
            b = noise.uniform_np(np.uint32(seed), i, np.uint32(stream))
            assert np.array_equal(a, b)
            c = np.asarray(jax.jit(
                lambda: noise.normal(jnp.uint32(seed), jnp.asarray(i),
                                     jnp.uint32(stream)))())
            d = noise.normal_np(np.uint32(seed), i, np.uint32(stream))
            assert np.array_equal(c, d)


def test_noise_distributions():
    i = np.arange(200000, dtype=np.uint32)
    u = noise.uniform_np(7, i, 0)
    assert 0.49 < float(u.mean()) < 0.51
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    g = noise.normal_np(7, i, 1)
    assert abs(float(g.mean())) < 0.01
    assert 0.98 < float(g.std()) < 1.02


def test_detmath_twins_and_accuracy():
    """Twins agree to output-ulp scale (XLA FMA-contracts the polynomial:
    ~1 ulp wiggle, never amplified — the detmath docstring's contract) and
    both are accurate vs f64 references even at huge phases."""
    x = np.linspace(-1000, 1000, 100001).astype(np.float32)
    a = np.asarray(jax.jit(detmath.sin_cycles)(jnp.asarray(x)))
    b = detmath.sin_cycles_np(x)
    assert float(np.max(np.abs(a - b))) < 2e-7
    ref = np.sin(2 * np.pi * x.astype(np.float64))
    assert float(np.max(np.abs(b - ref))) < 2e-6
    y = np.linspace(-20, 20, 10001).astype(np.float32)
    e1 = np.asarray(jax.jit(detmath.exp2)(jnp.asarray(y)))
    e2 = detmath.exp2_np(y)
    rel_t = np.abs(e1.astype(np.float64) / e2.astype(np.float64) - 1.0)
    assert float(rel_t.max()) < 3e-7
    rel = np.abs(e2.astype(np.float64) / (2.0 ** y.astype(np.float64)) - 1.0)
    assert float(rel.max()) < 1e-6


def test_detmath_phase_cycles_long_range_exact():
    """phase_ratio/phase_cycles stay exact at sample indices far past 2**24
    (where an f32 arange loses integer exactness), and the JAX/NumPy twins
    are bit-identical."""
    sr = 48000
    for (fn_, fd_) in [(2, 5), (7, 1), (1, 2), (6, 1)]:   # 0.4/7/0.5/6 Hz
        num, m, inv = detmath.phase_ratio(fn_, fd_, sr)
        # indices around 2**25 (~11.6 min at 48 kHz) plus small ones
        i = np.concatenate([np.arange(0, 4096, dtype=np.uint32),
                            (2 ** 25 + np.arange(4096)).astype(np.uint32)])
        got = detmath.phase_cycles_np(i, num, m, inv)
        true = ((fn_ / fd_ / sr) * i.astype(np.float64)) % 1.0
        # compare on the circle (got may be in [0, num) cycles pre-reduction)
        d = np.abs((got.astype(np.float64) - true + 0.5) % 1.0 - 0.5)
        assert float(d.max()) < 1e-6, (fn_, fd_, float(d.max()))
        dev = np.asarray(jax.jit(
            lambda ii: detmath.phase_cycles(ii, num, m, inv))(jnp.asarray(i)))
        assert np.array_equal(dev, got)


def test_fixq_segmented_cumsum_twins():
    rng = np.random.default_rng(0)
    inc = rng.integers(-(1 << 23), 1 << 23, size=5000).astype(np.int32)
    reset = rng.random(5000) < 0.01
    w1, f1 = fixq.segmented_pos_cumsum(jnp.asarray(inc), jnp.asarray(reset),
                                       init_whole=3, init_frac=12345)
    w2, f2 = fixq.segmented_pos_cumsum_np(inc, reset, 3, 12345)
    assert np.array_equal(np.asarray(w1), w2)
    assert np.array_equal(np.asarray(f1), f2)
    assert (f2 >= 0).all() and (f2 < fixq.POS_ONE).all()


def test_round_sig12_products_exact():
    rng = np.random.default_rng(1)
    a = fixq.round_sig12_np(rng.uniform(-8, 8, 2000).astype(np.float32))
    b = fixq.round_sig12_np(rng.uniform(-8, 8, 2000).astype(np.float32))
    p32 = (a * b).astype(np.float64)
    p64 = a.astype(np.float64) * b.astype(np.float64)
    assert np.array_equal(p32, p64)
    # and the relative perturbation is <= 2**-12
    x = rng.uniform(0.1, 8, 2000).astype(np.float32)
    q = fixq.round_sig12_np(x)
    assert float(np.max(np.abs(q / x - 1.0))) <= 2 ** -12


def test_breakpoints_reference_semantics():
    pts = parse_breakpoints(" 0:18, 4:40 , 8:14, bad, 2:")
    assert pts == [(0.0, 18.0), (4.0, 40.0), (8.0, 14.0)]
    assert eval_breakpoints(pts, -1.0, 99) == 18.0
    assert eval_breakpoints(pts, 10.0, 99) == 14.0
    assert eval_breakpoints(pts, 2.0, 99) == pytest.approx(29.0)
    assert eval_breakpoints([], 1.0, 42.5) == 42.5
    assert parse_breakpoints("") == []


def test_schedulers_reference_exact_rng():
    """Same rng(seed+9999) streams as main_v2.py:507-558."""
    t1 = generate_event_times("Poisson", 4.0, 25.0, seed=7)
    rng = np.random.default_rng(7 + 9999)
    ref, t = [], 0.0
    while t < 4.0:
        t += rng.exponential(1.0 / 25.0)
        if t < 4.0:
            ref.append(t)
    assert t1 == ref
    assert generate_event_times("Single", 4.0, 25.0, seed=7) == [0.0]
    assert generate_event_times("Poisson", 4.0, 0.0, seed=7) == [0.0]
    tc = generate_event_times("Clustered", 2.0, 30.0, seed=3)
    assert tc == sorted(tc) and all(0 <= x < 2.0 for x in tc)
    th = generate_event_times("Hawkes", 2.0, 20.0, seed=3)
    assert all(0 <= x < 2.01 for x in th) and len(th) > 5


def test_music_math():
    assert music.midi_to_hz(69) == pytest.approx(440.0)
    assert music.midi_to_hz(81) == pytest.approx(880.0)
    assert music.primes_upto(20) == [2, 3, 5, 7, 11, 13, 17, 19]
    # pythagorean fifth folding stays in [1, 2)
    for st in range(-12, 13):
        r = music.pythagorean_ratio(st)
        assert 1.0 <= r < 2.0
    e = music.euclidean_rhythm(8, 3)
    assert int(np.sum(e)) == 3 and len(e) == 8
    e2 = music.euclidean_rhythm(8, 3, rotate=2)
    assert int(np.sum(e2)) == 3


def test_wav_codec_roundtrip(tmp_path):
    from audio_suite_tpu.utils import io as audio_io
    rng = np.random.default_rng(0)
    for ch in (1, 2):
        x = (0.7 * rng.standard_normal((1000, ch))).astype(np.float32)
        x = np.clip(np.squeeze(x), -1, 1)
        for subtype in (None, "PCM_16"):
            path = str(tmp_path / f"t{ch}_{subtype}.wav")
            audio_io.write_wav(path, x, 22050, subtype=subtype)
            y, sr = audio_io.read_wav(path)
            assert sr == 22050
            tol = 1e-4 if subtype == "PCM_16" else 1e-7
            assert np.max(np.abs(np.squeeze(y) - x)) < tol


def test_spectral_filters_vs_numpy():
    """lowpass/bandpass kernels vs direct NumPy mirrors at padded length."""
    from audio_suite_tpu.ops import spectral
    from oracles.microsound_ref import _bandpass_fft, _lowpass_fft
    rng = np.random.default_rng(2)
    L = 512
    x = np.zeros(L, np.float32)
    x[:300] = rng.standard_normal(300).astype(np.float32)
    sr = 48000.0
    for cutoff, roll in ((8000.0, 0.0), (8000.0, 2000.0), (100.0, 50.0)):
        a = np.asarray(jax.jit(
            lambda v: spectral.lowpass_fft(v, sr, cutoff, roll))(
            jnp.asarray(x)))
        b = _lowpass_fft(x.astype(np.float64), sr, cutoff, roll)
        assert float(np.max(np.abs(a - b))) < 1e-5, (cutoff, roll)
    for lo, hi, roll in ((500.0, 6000.0, 0.0), (0.0, 4000.0, 1000.0),
                         (1000.0, 24000.0, 500.0)):
        a = np.asarray(jax.jit(
            lambda v: spectral.bandpass_fft(v, sr, lo, hi, roll))(
            jnp.asarray(x)))
        b = _bandpass_fft(x.astype(np.float64), sr, lo, hi, roll)
        assert float(np.max(np.abs(a - b))) < 1e-5, (lo, hi, roll)


def test_adsr_clamped_edge_cases_vs_oracle():
    """The vectorized stage-clamped ADSR vs the reference-exact sequential
    implementation across edge cases: note shorter than attack, than A+D,
    zero-ish stages, sustain-absorbing long notes."""
    from audio_suite_tpu.ops.envelopes import adsr_clamped
    from oracles.patternlab_ref import _adsr_env

    sr = 8000
    L = 4096
    i = jnp.arange(L, dtype=jnp.int32)
    cases = [
        # (n, a, d, s, r)
        (8, 0.01, 0.2, 0.6, 0.1),       # shorter than attack
        (100, 0.01, 0.2, 0.6, 0.1),     # inside decay
        (900, 0.01, 0.05, 0.5, 0.05),   # inside release
        (4000, 0.01, 0.05, 0.5, 0.05),  # long sustain
        (300, 0.004, 1e-4, 0.0, 0.008), # minimum stages, zero sustain
        (50, 0.004, 1e-4, 1.0, 0.008),  # full sustain level
    ]
    for n, a, d, s, r in cases:
        A = int(sr * max(0.004, a))
        D = int(sr * max(1e-4, d))
        R = int(sr * max(0.008, r))
        got = np.asarray(jax.jit(
            lambda: adsr_clamped(i, jnp.int32(n), jnp.int32(A), jnp.int32(D),
                                 jnp.int32(R), jnp.float32(s)))())
        want = np.zeros(L, np.float32)
        want[:n] = _adsr_env(n, sr, a, d, s, r, 0.004, 0.008)
        assert np.max(np.abs(got - want)) < 1e-6, (n, a, d, s, r)


def test_sinc_interpolation_quality_and_twins():
    """Opt-in windowed-sinc read (the quality mode): must
    reconstruct a bandlimited signal much better than the linear default,
    and the device/NumPy twins must agree."""
    import jax.numpy as jnp

    from audio_suite_tpu.ops import fixq

    n = 8192
    sr = 8000.0
    f0 = 441.0
    x = np.sin(2 * np.pi * f0 * np.arange(n) / sr).astype(np.float32)

    # read at speed 1.37 from sample 64 (away from wrap edges)
    T = 4000
    pos = 64.0 + 1.37 * np.arange(T)
    whole = np.floor(pos).astype(np.int32)
    frac = np.rint((pos - whole) * fixq.POS_ONE).astype(np.int32)
    ideal = np.sin(2 * np.pi * f0 * pos / sr).astype(np.float64)

    lin = np.asarray(fixq.gather_linear_wrap(
        jnp.asarray(x), jnp.asarray(whole), jnp.asarray(frac)))
    snc = np.asarray(fixq.gather_sinc_wrap(
        jnp.asarray(x), jnp.asarray(whole), jnp.asarray(frac)))
    sl = slice(16, T - 16)
    err_lin = float(np.sqrt(np.mean((lin[sl] - ideal[sl]) ** 2)))
    err_snc = float(np.sqrt(np.mean((snc[sl] - ideal[sl]) ** 2)))
    assert err_snc < err_lin / 20.0, (err_lin, err_snc)

    snc_np = fixq.gather_sinc_wrap_np(x, whole, frac)
    assert float(np.max(np.abs(snc - snc_np))) < 1e-5


def test_sinc_mode_through_engines():
    """interp="sinc" renders through tape and scrub end-to-end."""
    from audio_suite_tpu.models import scrub, tape

    sr = 16000
    t = np.arange(sr) / sr
    audio = (0.6 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)

    p = tape.TapeParams(sample_rate=sr, markers=[6000],
                        section_speeds=[1.3, 0.7],
                        section_reverse=[False, True])
    y_lin = tape.render_tape(audio, p, 8000)
    y_snc = tape.render_tape(audio, p, 8000, interp="sinc")
    assert y_snc.shape == y_lin.shape and np.isfinite(y_snc).all()
    # same signal to first order, different interpolation detail
    assert np.max(np.abs(y_snc - y_lin)) < 0.2
    assert not np.array_equal(y_snc, y_lin)

    # NOTE: two heads sit 4000 samples apart; pick a frequency that is
    # NOT k/2 periods over that span or the heads cancel exactly
    audio2 = (0.6 * np.sin(2 * np.pi * 347 * t)).astype(np.float32)
    cfg = scrub.ScrubConfig(sample_rate=sr, head_count=2)
    tr = scrub.scripted_gesture_trace(20, sr, drag_events=[(0.1, 4.0, 0.3)],
                                      base_speed=0.7)
    s_lin = scrub.render_scrub(audio2, cfg, tr)
    s_snc = scrub.render_scrub(audio2, cfg, tr, interp="sinc")
    assert s_snc.shape == s_lin.shape and np.isfinite(s_snc).all()
    assert np.abs(s_lin).max() > 1e-3 and np.abs(s_snc).max() > 1e-3
    assert not np.array_equal(s_snc, s_lin)


def test_blockwise_read_vs_gather():
    """The scrub blockwise read (row-aligned fetch + two-level one-hot
    matmul selection) must equal the per-element gather_linear_wrap to ~ulp on a
    random walk with reverse motion and wrap, for every head layout."""
    from audio_suite_tpu.models import scrub

    rng = np.random.default_rng(3)
    n = 5000
    audio = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    T = 128 * 96
    inc = rng.uniform(-1.0, 1.0, T)
    pos = (np.cumsum(inc) * (1 << fixq.POS_FRAC_BITS)).astype(np.int64) \
        + 123456
    whole = jnp.asarray(((pos >> fixq.POS_FRAC_BITS) % n).astype(np.int32))
    frac = jnp.asarray(
        (pos & ((1 << fixq.POS_FRAC_BITS) - 1)).astype(np.int32))

    for offs in [(0,), (-2000, 0, 2000), (-150, 37)]:
        got = np.asarray(
            scrub._read_blockwise_heads(audio, whole, frac, offs, 1))
        want = np.zeros(T, np.float32)
        for off in offs:
            w2 = jnp.mod(whole + off, n)
            want += np.asarray(fixq.gather_linear_wrap(audio, w2, frac))
        # head-window sums reorder f32 adds: a few ulp, never more
        assert float(np.max(np.abs(got - want))) < 2e-6, offs


def test_lowpass_stretch_shared_is_exact_gather_lerp():
    """The shared-stretch spectral kernel's one-hot matmul selection must
    equal a direct per-bin gather+lerp of the lowpassed spectrum (one
    nonzero product per output row), at every window-size bucket the
    static stretch hint can produce."""
    from audio_suite_tpu.ops import spectral

    rng = np.random.default_rng(1)
    E, L = 5, 2048
    x = rng.standard_normal((E, L)).astype(np.float32)
    sr_v = (192000.0 * rng.uniform(0.5, 1.0, E)).astype(np.float32)
    cut = np.full(E, 18000.0, np.float32)

    for factor in (4.0, 1.7, 0.5, 0.26):
        hint = max(0.25, 1.0 / factor)
        got = np.asarray(spectral.lowpass_stretch_fused_shared(
            jnp.asarray(x), jnp.asarray(sr_v), jnp.asarray(cut),
            np.float32(factor), roll=2500.0, max_scale=hint))

        # direct reference: same jnp FFTs, gather+lerp selection
        X = jnp.fft.rfft(jnp.asarray(x))
        nf = X.shape[-1]
        g = jnp.stack([spectral._lowpass_gain(L, float(s), float(c), 2500.0)
                       for s, c in zip(sr_v, cut)])
        Xg = X * g
        scale = np.float32(1.0) / np.float32(factor)
        pos = jnp.arange(nf, dtype=jnp.float32) * scale
        valid = (pos >= 0.0) & (pos <= np.float32(nf - 1))
        i0 = jnp.clip(jnp.floor(pos), 0.0, np.float32(nf - 2))
        t = pos - i0
        i0 = i0.astype(jnp.int32)
        X0, X1 = Xg[:, i0], Xg[:, i0 + 1]

        def lerp(a, b):
            return a * (np.float32(1.0) - t) + b * t

        Y = (lerp(X0.real, X1.real) + 1j * lerp(X0.imag, X1.imag)) \
            * valid.astype(jnp.float32)
        want = np.asarray(jnp.fft.irfft(Y, n=L).astype(jnp.float32))
        dev = float(np.max(np.abs(got - want)))
        # identical selection; only the final irfft rounding differs
        assert dev < 2e-6, (factor, dev)


def test_pow2_fft_matches_numpy():
    """rfft_n / irfft_n at the pow2 grain and partitioned-conv sizes match
    np.fft to f32 accuracy, and follow the c2r convention: the imaginary
    parts of the DC/Nyquist bins do not contribute."""
    import jax
    import jax.numpy as jnp
    from audio_suite_tpu.ops import exact_dft

    rng = np.random.default_rng(7)
    for L in (16384, 32768, 65536):   # 65536 = the partitioned-conv nfft
        x = rng.standard_normal((3, L)).astype(np.float32)
        ref = np.fft.rfft(x.astype(np.float64))
        got = np.asarray(jax.jit(lambda v: exact_dft.rfft_n(v, L))(
            jnp.asarray(x)))
        scale = np.max(np.abs(ref))
        assert np.max(np.abs(got - ref)) / scale < 2e-6, L
        y = np.asarray(jax.jit(lambda z: exact_dft.irfft_n(z, L))(
            jnp.asarray(ref.astype(np.complex64))))
        # f32 reduction error grows ~sqrt(L)
        assert np.max(np.abs(y - np.fft.irfft(ref, n=L))) \
            < 2e-6 * (L / 16384) ** 0.5, L

    L = 16384
    Z = (rng.standard_normal(L // 2 + 1)
         + 1j * rng.standard_normal(L // 2 + 1)).astype(np.complex64)
    got = np.asarray(exact_dft.irfft_n(jnp.asarray(Z), L))
    ref = np.fft.irfft(Z.astype(np.complex128), n=L)
    assert np.max(np.abs(got - ref)) < 2e-5
