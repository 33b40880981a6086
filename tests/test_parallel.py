"""Multi-chip parallelism on the 8-virtual-device CPU mesh (SURVEY.md §4
'multi-chip without a cluster'): dp-sharded batch renders, psum mixdown
collective, batch manifests, and the driver entry points."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from audio_suite_tpu.parallel import batch as pb


def require_devices(n=8):
    if len(jax.devices()) < n:
        pytest.skip(f"need {n} virtual devices, have {len(jax.devices())}")


def test_mesh_shapes():
    require_devices(8)
    m1 = pb.make_mesh(8)
    assert m1.devices.shape == (8,) and m1.axis_names == ("dp",)
    m2 = pb.make_mesh(8, axis_names=("dp", "ev"))
    assert int(np.prod(m2.devices.shape)) == 8
    assert len(m2.devices.shape) == 2


def test_batch_render_sharded_matches_single():
    require_devices(8)
    mesh = pb.make_mesh(8)

    def kernel(seed_and_gain):
        seed, gain = seed_and_gain[0], seed_and_gain[1]
        i = jnp.arange(512, dtype=jnp.float32)
        return gain * jnp.sin(i * (seed + 1.0) * 0.001)

    args = jnp.stack([jnp.arange(16, dtype=jnp.float32),
                      jnp.linspace(0.1, 1.0, 16, dtype=jnp.float32)], axis=1)
    out_sharded = pb.batch_render(kernel, args, mesh=mesh)
    out_single = pb.batch_render(kernel, args, mesh=None)
    assert out_sharded.shape == (16, 512)
    np.testing.assert_array_equal(out_sharded, out_single)


def test_sharded_sum_collective():
    require_devices(8)
    mesh = pb.make_mesh(8)
    rng = np.random.default_rng(0)
    parts = rng.standard_normal((8, 1024)).astype(np.float32)
    got = np.asarray(pb.sharded_sum(jnp.asarray(parts), mesh))
    want = parts.sum(axis=0)
    assert np.max(np.abs(got - want)) < 1e-5


def test_batch_manifest_resume(tmp_path):
    path = str(tmp_path / "manifest.json")
    m = pb.BatchManifest.open_or_create(path, ["a", "b", "c"])
    assert sorted(m.pending()) == ["a", "b", "c"]
    m.mark("a", "done", rtf=12.0)
    m.mark("b", "failed", error="boom")
    m2 = pb.BatchManifest.load(path)
    assert sorted(m2.pending()) == ["b", "c"]
    # reopening with extra jobs keeps old state
    m3 = pb.BatchManifest.open_or_create(path, ["a", "b", "c", "d"])
    assert sorted(m3.pending()) == ["b", "c", "d"]
    assert m3.jobs["a"]["rtf"] == 12.0


def test_graft_entry_compiles():
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()


def test_dryrun_multichip_8():
    require_devices(8)
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_microsound_batch_render_manifest(tmp_path):
    from audio_suite_tpu.models import microsound as ms

    p = ms.MicrosoundParams.from_dict(dict(
        base_sr=8000, out_dur_s=0.2, gen_mode="Gaussian click",
        grains_per_sec=20.0, max_grains=8, er_cloud_on=False,
        stereo_on=False, bp_density=""))
    man = str(tmp_path / "m.json")
    paths = ms.batch_render(p, str(tmp_path), seeds=[1, 2],
                            stretches=[1.0, 1.5], manifest_path=man)
    assert len(paths) == 4
    assert all(os.path.exists(pth) for pth in paths)
    m = pb.BatchManifest.load(man)
    assert not m.pending()
    # resume: nothing re-rendered (paths returned from manifest)
    paths2 = ms.batch_render(p, str(tmp_path), seeds=[1, 2],
                             stretches=[1.0, 1.5], manifest_path=man)
    assert paths2 == paths


def test_pallas_overlap_add_fallback_matches_reference():
    """overlap_add (the chooser: DUS loop on CPU, tiled kernel on GPU)
    must match the sequential reference accumulation."""
    import jax.numpy as jnp
    from audio_suite_tpu.ops import pallas_oa

    rng = np.random.default_rng(0)
    E, L, out_len = 5, 1024, 8192
    vals = rng.standard_normal((E, L)).astype(np.float32)
    starts = np.asarray([0, 64, 1111, 4096, 7000], np.int32)
    ref = np.zeros(out_len, np.float32)
    for e in range(E):
        ref[starts[e]:starts[e] + L] += vals[e]
    got = np.asarray(pallas_oa.overlap_add(
        jnp.zeros(out_len, jnp.float32), jnp.asarray(vals),
        jnp.asarray(starts)))
    assert np.max(np.abs(got - ref)) < 1e-5


def test_sharded_fir_conv_matches_single_device():
    """Timeline-sharded FIR convolution with ppermute halo exchange vs the
    single-device partitioned FFT convolution (SURVEY.md §5 long-context)."""
    from audio_suite_tpu.parallel import timeline as tl

    require_devices(8)
    mesh = pb.make_mesh(8)
    rng = np.random.default_rng(0)
    N = 8 * 4096
    x = rng.standard_normal(N).astype(np.float32)

    for K in (129, 4096, 9000):    # sub-block, exactly block, multi-hop
        kernel = (rng.standard_normal(K)
                  * np.exp(-np.arange(K) / (K / 6))).astype(np.float32)
        got = np.asarray(tl.sharded_fir_conv(x, kernel, mesh))
        want = tl.sharded_conv_reference(x, kernel)
        scale = max(1e-9, float(np.max(np.abs(want))))
        assert np.max(np.abs(got - want)) / scale < 1e-5, K


def test_batch_render_pipelined_matches_single(tmp_path):
    """The pipelined batch (pull k overlaps compute k+1) must write the
    same audio as individual renders."""
    from audio_suite_tpu.models import microsound as ms
    from audio_suite_tpu.utils import io as audio_io

    p = ms.MicrosoundParams.from_dict(dict(
        base_sr=8000, out_dur_s=0.4, time_unfold=3.0, micro_ms=2.0,
        gen_mode="Gaussian click", grains_per_sec=25.0, max_grains=24,
        bandlimit_on=True, bandlimit_out_hz=3000.0, er_cloud_on=False,
        stereo_on=True, bp_density="", bp_unfold="", bp_cutoff="",
        bp_stretch="", seed=3))
    paths = ms.batch_render(p, str(tmp_path), seeds=[3, 4, 5])
    assert len(paths) == 3
    for seed, path in zip([3, 4, 5], paths):
        p2 = ms.MicrosoundParams.from_dict(p.to_dict())
        p2.seed = seed
        want, _ = ms.render(p2)
        got, sr = audio_io.read_wav(path)
        assert sr == 8000
        # write_wav default FLOAT roundtrips exactly
        assert np.allclose(got, want, atol=1e-6), seed


def test_exact_dft_under_sharded_vmap():
    """The exact-length DFT must compose with the dp-sharded batch path:
    the grain batch shards over the mesh and each shard transforms its
    own rows, matching np.fft in f64."""
    require_devices(8)
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map
    from audio_suite_tpu.ops import exact_dft

    mesh = pb.make_mesh(8)
    rng = np.random.default_rng(3)
    L = 16384
    x = rng.standard_normal((8, 4, L)).astype(np.float32)

    def per_shard(xs):
        # xs: [1, 4, L] on each device
        return exact_dft.irfft_n(exact_dft.rfft_n(xs, L), L)

    f = jax.jit(shard_map(per_shard, mesh=mesh,
                          in_specs=P("dp"), out_specs=P("dp")))
    xd = jax.device_put(x, NamedSharding(mesh, P("dp")))
    got = np.asarray(f(xd))
    ref = np.fft.irfft(np.fft.rfft(x.astype(np.float64), axis=-1),
                       n=L, axis=-1)
    assert np.max(np.abs(got - ref)) < 5e-6   # f32 roundtrip, 2 transforms
    # and under plain vmap over the sharded leading axis
    g = jax.jit(jax.vmap(jax.vmap(lambda v: exact_dft.rfft_n(v, L))))
    got2 = np.asarray(jnp.abs(g(x)))
    ref2 = np.abs(np.fft.rfft(x.astype(np.float64), axis=-1))
    assert np.max(np.abs(got2 - ref2)) / np.max(ref2) < 2e-6


def test_ca_spatial_sharding_bit_exact():
    """parallel/ca.py: the row-sharded Forest Fire CA (ppermute stencil
    halos, all_gather'd ember candidates, psum stats) is bit-identical to
    the single-device engine over a 40-step trajectory — same stats rows,
    same final state/fuel/moisture/age fields."""
    require_devices(8)
    from audio_suite_tpu.models import forestfire as ff
    from audio_suite_tpu.parallel import ca

    mesh = pb.make_mesh(8, axis_names=("sp",))
    params = ff.ModelParams()            # h=160 divides over 8 shards
    model = ff.ForestFireModel(params, seed=2)
    model.ignite_at(110, 80, radius=4)
    carry0 = {k: np.array(v) for k, v in model._np.items()}

    carry_sh, stats_sh = ca.simulate_sharded(params, carry0, 40, mesh,
                                             seed=2)
    stats_dense = model.simulate(40)

    assert np.array_equal(np.asarray(stats_dense, np.int64),
                          np.asarray(stats_sh, np.int64))
    final_dense = model._np
    for k in ("state", "fuel", "moisture", "age"):
        assert np.array_equal(final_dense[k], np.asarray(carry_sh[k])), k
    assert int(np.asarray(carry_sh["t"])) == int(final_dense["t"])

    # embers actually flew and fires actually spread across shard rows
    # during the window (otherwise the halo/all_gather paths were idle)
    assert stats_sh[:, 6].sum() > 0          # embers column
    assert stats_sh[-1, 2] > stats_sh[0, 2]  # burning grew


def test_ca_sharding_rejects_indivisible_grid():
    require_devices(8)
    from audio_suite_tpu.models import forestfire as ff
    from audio_suite_tpu.parallel import ca

    mesh = pb.make_mesh(8, axis_names=("sp",))
    params = ff.ModelParams(h=150)       # 150 % 8 != 0
    with pytest.raises(ValueError, match="divide"):
        ca.sharded_sim_fn(params, 1, 4, mesh)
