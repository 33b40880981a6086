"""Multi-host dispatch (SURVEY.md §2.7): two OS processes
join a jax.distributed runtime over local TCP (gloo CPU collectives), build
the (dp_host, dp_chip) global mesh, shard a batch render over both axes, and
verify every process receives the full replicated result."""
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dcn_batch_dispatch(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"p{i}.json") for i in range(2)]
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # workers force their own cpu platform + 2 local devices
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "audio_suite_tpu.parallel.distributed",
         coord, "2", str(i), outs[i]],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    results = []
    for p, out in zip(procs, outs):
        stdout, stderr = p.communicate(timeout=240)
        assert p.returncode == 0, f"rc={p.returncode}\n{stdout}\n{stderr}"
        with open(out) as f:
            results.append(json.load(f))

    for r in results:
        assert r["ok"], r
        assert r["process_count"] == 2
        assert r["global_devices"] == 4
        assert r["mesh_shape"] == [2, 2]
        assert r["max_err"] < 1e-4
        assert r["mix_err"] < 1e-3
    assert {r["process_id"] for r in results} == {0, 1}


def test_single_process_distributed_api_degenerates():
    """The same API works in-process: (1, n_local) mesh, replicated result."""
    import numpy as np

    from audio_suite_tpu.parallel import distributed as D

    mesh = D.make_global_mesh()
    assert mesh.devices.shape[0] == 1

    import jax.numpy as jnp
    amps = np.linspace(0.1, 1.0, 2 * mesh.devices.size).astype(np.float32)
    got = D.distributed_batch_render(
        lambda a: a * jnp.ones(16, jnp.float32), (amps,), mesh)
    assert got.shape == (len(amps), 16)
    assert np.allclose(got, amps[:, None], atol=1e-7)
