"""Overlap-add: the tiled Pallas kernel against the sequential DUS loop,
bit for bit; the host tile plan; the path chooser; and both engines
rendered through each path.

CPU tests run the kernel through the Pallas interpreter.  Tests marked
`gpu` run the kernel as compiled for the card (chip_smoke.py runs them).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from audio_suite_tpu.ops import pallas_oa as poa


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _oa_both(out0, vals, starts, interpret=True):
    """(tiled, dus) results for the same inputs."""
    plan = poa.plan_tiles(starts, vals.shape[1], out0.shape[0])
    tiled = poa.tiled_overlap_add(jnp.asarray(out0), jnp.asarray(vals), plan,
                                  interpret=interpret)
    dus = poa.overlap_add_dus(jnp.asarray(out0), jnp.asarray(vals),
                              jnp.asarray(np.asarray(starts, np.int32)))
    return np.asarray(tiled), np.asarray(dus)


def _case(name, rng):
    """(out0, vals, starts) for one layout of windows over the tiles."""
    T = poa.TILE
    if name == "sorted":
        E, L, N = 12, 1500, 8 * T
        starts = np.sort(rng.integers(0, N - L + 1, E))
    elif name == "unsorted":                  # Pattern Lab's note order
        E, L, N = 12, 700, 8 * T
        starts = rng.integers(0, N - L + 1, E)
    elif name == "straddle":                  # every window crosses a tile
        E, L, N = 6, 2 * T + 5, 8 * T
        starts = np.asarray([T - 3, T + 1, 2 * T - 1, 3 * T + 7, 5, 4 * T])
    elif name == "empty_tiles":               # most tiles see no event
        E, L, N = 3, 100, 16 * T
        starts = np.asarray([10, 7 * T + 500, 15 * T + 2])
    elif name == "single":
        E, L, N = 1, 300, 2 * T
        starts = np.asarray([T - 150])
    elif name == "buffer_edges":              # first and last samples
        E, L, N = 4, T, 4 * T
        starts = np.asarray([0, 3 * T, 0, 3 * T])
    elif name == "nonzero_out":
        E, L, N = 9, 1200, 6 * T
        starts = rng.integers(0, N - L + 1, E)
    else:
        raise ValueError(name)
    vals = rng.standard_normal((E, L)).astype(np.float32)
    out0 = np.zeros(N, np.float32)
    if name == "nonzero_out":
        out0 = rng.standard_normal(N).astype(np.float32)
        out0[::7] = -0.0                      # signed zeros stay untouched
    return out0, vals, starts


CASES = ["sorted", "unsorted", "straddle", "empty_tiles", "single",
         "buffer_edges", "nonzero_out"]


@pytest.mark.parametrize("name", CASES)
def test_tiled_matches_dus_bitwise(name):
    out0, vals, starts = _case(name, np.random.default_rng(CASES.index(name)))
    tiled, dus = _oa_both(out0, vals, starts)
    assert np.array_equal(_bits(tiled), _bits(dus)), name


def test_tiled_composes_across_calls():
    """Two passes into one buffer (Microsound's event chunks) equal the
    DUS loop over the same two passes."""
    rng = np.random.default_rng(5)
    N, L = 8 * poa.TILE, 900
    out_t = out_d = jnp.zeros(N, jnp.float32)
    for _ in range(2):
        vals = jnp.asarray(rng.standard_normal((7, L)).astype(np.float32))
        starts = rng.integers(0, N - L + 1, 7)
        out_t = poa.tiled_overlap_add(out_t, vals,
                                      poa.plan_tiles(starts, L, N),
                                      interpret=True)
        out_d = poa.overlap_add_dus(out_d, vals,
                                    jnp.asarray(starts.astype(np.int32)))
    assert np.array_equal(_bits(out_t), _bits(out_d))


def _brute_plan(starts, L, N, tile=poa.TILE):
    """Per tile, the ascending event indices whose window covers it."""
    cover = [[] for _ in range(N // tile)]
    for e, s in enumerate(np.clip(starts, 0, N - L)):
        for t in range(N // tile):
            if s < (t + 1) * tile and s + L > t * tile:
                cover[t].append(e)
    return cover


@pytest.mark.parametrize("L", [1, 256, 1024, 1025, 3000])
def test_plan_tiles_csr(L):
    rng = np.random.default_rng(L)
    tile = poa.TILE
    N = 8 * tile
    starts = rng.integers(-50, N - L + 60, 40)   # includes clamped starts
    plan = poa.plan_tiles(starts, L, N)
    assert plan.ptr.dtype == plan.ev.dtype == plan.off.dtype == np.int32
    assert plan.ptr.shape == (N // tile + 1,)
    assert plan.ev.shape == plan.off.shape == (poa.plan_capacity(40, L),)
    assert plan.ptr[0] == 0 and np.all(np.diff(plan.ptr) >= 0)
    clamped = np.clip(starts, 0, N - L)
    for t, want in enumerate(_brute_plan(starts, L, N)):
        lo, hi = plan.ptr[t], plan.ptr[t + 1]
        assert list(plan.ev[lo:hi]) == want, t
        assert np.array_equal(plan.off[lo:hi],
                              t * tile - clamped[plan.ev[lo:hi]])
        assert np.all(plan.off[lo:hi] > -tile)
        assert np.all(plan.off[lo:hi] < L)
    assert plan.ptr[-1] <= plan.ev.shape[0]


def test_plan_clamps_like_dus():
    """Out-of-range starts are clamped the way dynamic_slice clamps them,
    so the kernel stays bit-equal to the DUS loop even there."""
    rng = np.random.default_rng(9)
    N, L = 4 * poa.TILE, 700
    vals = rng.standard_normal((4, L)).astype(np.float32)
    starts = np.asarray([-300, N - L + 200, 5, N])
    tiled, dus = _oa_both(np.zeros(N, np.float32), vals, starts)
    assert np.array_equal(_bits(tiled), _bits(dus))


def test_buffer_len_tiles_and_margins():
    for out_n, L in [(1, 1), (48000, 4096), (768000, 32768),
                     (46_080_000, 32768)]:
        n = poa.buffer_len(out_n, L)
        assert n % poa.TILE == 0
        assert n >= out_n + 2 * L and n - (out_n + 2 * L) < poa.TILE


def test_oa_path_chooser():
    assert poa.oa_path("gpu") == "tiled"
    assert poa.oa_path("cpu") == "dus"
    assert poa.oa_path() == "dus"          # the test process runs on CPU
    with pytest.raises(RuntimeError, match="no overlap-add path"):
        poa.oa_path("rocm")


def test_overlap_add_dispatch():
    """overlap_add routes by path; the tiled path builds its plan from
    NumPy starts when none is given."""
    rng = np.random.default_rng(2)
    N, L = 4 * poa.TILE, 500
    vals = jnp.asarray(rng.standard_normal((5, L)).astype(np.float32))
    starts = rng.integers(0, N - L + 1, 5)
    out0 = jnp.zeros(N, jnp.float32)
    dus = poa.overlap_add(out0, vals, jnp.asarray(starts.astype(np.int32)))
    tiled = poa.overlap_add(out0, vals, starts, path="tiled")
    assert np.array_equal(_bits(dus), _bits(tiled))


def _ms_params():
    from audio_suite_tpu.models import microsound as ms
    return ms.MicrosoundParams.from_dict(dict(
        base_sr=8000, out_dur_s=0.4, time_unfold=3.0, micro_ms=2.0,
        gen_mode="Gaussian click", grains_per_sec=25.0, max_grains=24,
        bandlimit_on=True, bandlimit_out_hz=3000.0, er_cloud_on=False,
        stereo_on=True, bp_density="", bp_unfold="", bp_cutoff="",
        bp_stretch="", seed=3))


def _render_both_paths(monkeypatch, render):
    """render() once per OA path: "dus", then "tiled" (the interpreter
    off a GPU)."""
    outs = {}
    for path in ("dus", "tiled"):
        monkeypatch.setattr(poa, "oa_path", lambda platform=None, p=path: p)
        outs[path] = render()
    return outs["dus"], outs["tiled"]


@pytest.mark.parametrize("event_chunk", [None, 7])
def test_microsound_tiled_equals_dus(monkeypatch, event_chunk):
    """One fused chunk, and several chunks into one buffer."""
    from audio_suite_tpu.models import microsound as ms
    p = _ms_params()
    dus, tiled = _render_both_paths(
        monkeypatch, lambda: ms.render(p, event_chunk=event_chunk)[0])
    assert np.abs(dus).max() > 0
    assert np.array_equal(_bits(dus), _bits(tiled))


def test_patternlab_tiled_equals_dus(monkeypatch):
    """Every bucket's notes through the tiled kernel, in bucket order."""
    from audio_suite_tpu.models import patternlab as pl
    rc = pl.RenderConfig(sample_rate=22050, seconds=1.0, bpm=140, seed=4)

    def render():
        events = (pl.generate("Glass Cells", rc)
                  + pl.generate("Fibonacci Gate", rc)[:20])
        synth = pl.MegaDriveInspiredSynth(rc.sample_rate, seed=rc.seed)
        prep = synth.prepare(pl.apply_time_ops(events, rc), rc.seconds)
        assert len(prep.spec) >= 2
        return synth.render_prepared(prep)

    dus, tiled = _render_both_paths(monkeypatch, render)
    assert np.abs(dus).max() > 0
    assert np.array_equal(_bits(dus), _bits(tiled))


# ---------------------------------------------------------------------------
# On the card: the compiled kernel, and the one-hot reads
# ---------------------------------------------------------------------------

GPU_SHAPES = [
    # (E, window, out_n, L, sorted): the bench's Microsound chunk, the
    # Microsound ceiling's chunk (46 M samples), an unsorted note field
    (416, 19456, 768000, 32768, True),
    (2048, 20480, 46_080_000, 32768, True),
    (3000, 8192, 400000, 8192, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES,
                         ids=["microsound", "ceiling", "notes"])
def test_gpu_tiled_kernel_bitwise(gpu, shape):
    E, W, out_n, L, is_sorted = shape
    rng = np.random.default_rng(E)
    N = poa.buffer_len(out_n, L)
    starts = rng.integers(0, N - W + 1, E)
    if is_sorted:
        starts = np.sort(starts)
    vals = rng.standard_normal((E, W)).astype(np.float32)
    tiled, dus = _oa_both(np.zeros(N, np.float32), vals, starts,
                          interpret=False)
    assert np.array_equal(_bits(tiled), _bits(dus))


@pytest.mark.gpu
def test_gpu_engines_tiled_equals_dus(gpu, monkeypatch):
    from audio_suite_tpu.models import microsound as ms
    p = _ms_params()
    dus, tiled = _render_both_paths(monkeypatch,
                                    lambda: ms.render(p, event_chunk=7)[0])
    assert np.array_equal(_bits(dus), _bits(tiled))


@pytest.mark.gpu
def test_gpu_onehot_int_read_bitwise(gpu):
    """Grid's blockwise one-hot read (HIGHEST-precision matmuls) equals
    the element gather bit for bit at the bench's 16 s x 48 kHz track."""
    from audio_suite_tpu.ops import fixq
    rng = np.random.default_rng(4)
    n, T = 96000, 16 * 48000
    pat = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    idx = jnp.asarray((np.arange(T) % n).astype(np.int32))
    got = fixq.gather_int_block_onehot(pat, idx, wrap=True,
                                       zero_cover=False)
    assert np.array_equal(_bits(got), _bits(pat[idx]))


@pytest.mark.gpu
def test_gpu_blockwise_heads_read(gpu):
    """Scrub's blockwise read equals gather + lerp: bit for bit with one
    head, within a few ulp where head sums are reordered."""
    from audio_suite_tpu.models import scrub
    from audio_suite_tpu.ops import fixq
    rng = np.random.default_rng(3)
    n = 10 * 48000
    audio = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    T = 1024 * 1406                       # 30 s of 1024-sample blocks
    inc = rng.uniform(-1.0, 1.0, T)
    pos = (np.cumsum(inc) * (1 << fixq.POS_FRAC_BITS)).astype(np.int64) \
        + 123456
    whole = jnp.asarray(((pos >> fixq.POS_FRAC_BITS) % n).astype(np.int32))
    frac = jnp.asarray(
        (pos & ((1 << fixq.POS_FRAC_BITS) - 1)).astype(np.int32))
    for offs in [(0,), (-2000, 0, 2000)]:
        got = np.asarray(
            scrub._read_blockwise_heads(audio, whole, frac, offs, 1))
        want = np.zeros(T, np.float32)
        for off in offs:
            w2 = jnp.mod(whole + off, n)
            want += np.asarray(fixq.gather_linear_wrap(audio, w2, frac))
        if len(offs) == 1:
            assert np.array_equal(_bits(got), _bits(want))
        else:
            assert float(np.max(np.abs(got - want))) < 2e-6
