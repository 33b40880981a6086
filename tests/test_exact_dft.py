"""Exact-length DFT API vs np.fft in f64 at arbitrary n (the reference's
grain transforms run at the true grain length, main_v2.py:39-163)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_suite_tpu.ops import exact_dft


def _roundtrip_err(n, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    X = np.asarray(exact_dft.rfft_n(x, n))
    ref_X = np.fft.rfft(x.astype(np.float64))
    fwd_err = np.abs(X - ref_X).max() / max(1e-12, np.abs(ref_X).max())
    y = np.asarray(exact_dft.irfft_n(X.astype(np.complex64), n))
    ref_y = np.fft.irfft(ref_X, n=n)
    inv_err = np.abs(y - ref_y).max()
    return fwd_err, inv_err


# composite lengths (grain lengths at common rates: 19200 = the bench's
# 1 ms grain at 192 kHz x100 unfold) and primes / near-primes
FOUR_NS = [1500, 19200, 37500, 960, 4800, 2048 * 3, 1155, 44100]
BLUE_NS = [1499, 4099, 65537, 2017, 9973]


@pytest.mark.parametrize("n", FOUR_NS)
def test_four_step_exact(n):
    fe, ie = _roundtrip_err(n)
    assert fe < 5e-6, f"n={n} fwd rel err {fe}"
    assert ie < 5e-5, f"n={n} inv err {ie}"


@pytest.mark.parametrize("n", BLUE_NS)
def test_bluestein_exact(n):
    fe, ie = _roundtrip_err(n)
    assert fe < 2e-5, f"n={n} fwd rel err {fe}"
    assert ie < 2e-4, f"n={n} inv err {ie}"


@pytest.mark.parametrize("n", [15, 16, 17, 63, 64, 255, 1024, 1500])
def test_public_api_any_n(n):
    """rfft_n/irfft_n match np.fft at any n, including odd n and inputs
    longer than n (padded grain buffers)."""
    rng = np.random.default_rng(n)
    L = n + 37
    x = rng.standard_normal((3, L)).astype(np.float32)
    X = np.asarray(exact_dft.rfft_n(x, n))
    ref = np.fft.rfft(x[..., :n].astype(np.float64))
    assert np.abs(X - ref).max() < 1e-4 * max(1.0, np.abs(ref).max())
    y = np.asarray(exact_dft.irfft_n(X.astype(np.complex64), n, out_len=L))
    assert y.shape == (3, L)
    ref_y = np.fft.irfft(ref, n=n)
    assert np.abs(y[..., :n] - ref_y).max() < 2e-5
    assert np.abs(y[..., n:]).max() == 0.0


@pytest.mark.parametrize("n", [945, 1001, 4725])  # odd composite
def test_four_step_odd_n(n):
    fe, ie = _roundtrip_err(n)
    assert fe < 5e-6 and ie < 5e-5


def test_wrapper_out_len_padding():
    """irfft_n pads with exact zeros up to out_len, and never truncates:
    out_len <= n leaves the length-n result as it is."""
    n, L = 1500, 2048
    Z = np.fft.rfft(np.random.default_rng(1).standard_normal(n))
    y = np.asarray(exact_dft.irfft_n(jnp.asarray(Z, jnp.complex64), n,
                                     out_len=L))
    assert y.shape == (L,)
    assert np.all(y[n:] == 0.0) and np.any(y[:n] != 0.0)
    for out_len in (None, n, n - 10):
        y2 = exact_dft.irfft_n(jnp.asarray(Z, jnp.complex64), n,
                               out_len=out_len)
        assert y2.shape == (n,)


def test_wrapper_dtypes():
    """complex64 spectra out of rfft_n, float32 signals out of irfft_n —
    the grain chain's carry and buffer dtypes."""
    x = jnp.ones((2, 100), jnp.float32)
    X = exact_dft.rfft_n(x, 64)
    assert X.dtype == jnp.complex64 and X.shape == (2, 33)
    y = exact_dft.irfft_n(X, 64, out_len=100)
    assert y.dtype == jnp.float32 and y.shape == (2, 100)


def test_wrapper_under_vmap():
    """vmap over a batch axis (how the grain chain calls it) equals the
    batched call, bit for bit."""
    rng = np.random.default_rng(7)
    n, L = 19200, 20000
    x = jnp.asarray(rng.standard_normal((4, L)).astype(np.float32))
    f = jax.jit(lambda v: exact_dft.irfft_n(exact_dft.rfft_n(v, n), n,
                                            out_len=L))
    via_vmap = np.asarray(jax.jit(jax.vmap(f))(x))
    direct = np.asarray(f(x))
    assert np.array_equal(via_vmap, direct)
    ref = np.fft.irfft(np.fft.rfft(np.asarray(x, np.float64)[:, :n]), n=n)
    assert np.max(np.abs(direct[:, :n] - ref)) < 5e-6
