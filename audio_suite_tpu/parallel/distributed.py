"""Multi-host (DCN) batch dispatch — jax.distributed + a global device mesh.

The reference suite is single-process (SURVEY.md §2.7: its only process
boundary is the OSC UDP socket, forest_fire_OSC_0.1/osc_out.py:12-25); its
only batch feature is Microsound's seeds×unfolds×stretches grid loop
(microsound_0.2.1/main_v2.py:1524-1596) run serially on one machine.  The
framework scales that batch loop across HOSTS:

- every participating process calls :func:`init_distributed` (standard
  ``jax.distributed.initialize`` coordinator handshake over TCP),
- :func:`make_global_mesh` builds a ``(dp_host, dp_chip)`` mesh whose first
  axis is the process boundary — collectives over ``dp_host`` cross the
  network between hosts, collectives over ``dp_chip`` stay within a host,
- :func:`distributed_batch_render` shards the job batch over BOTH axes and
  replicates the results back to every host (the jit's out-sharding is the
  allgather; no manual collectives needed).

Tested without a cluster via two local CPU processes speaking the same
protocol (gloo CPU collectives) — tests/test_distributed.py, the multi-host
analog of the 8-virtual-device single-process tests (SURVEY.md §4).

Run one process of the built-in self-test with::

    python -m audio_suite_tpu.parallel.distributed \
        <coordinator host:port> <num_processes> <process_id> <out.json>
"""
from __future__ import annotations

import json

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, **kw) -> None:
    """Join the multi-process runtime (idempotent).  Must run before any
    call that initializes the XLA backend (jax.devices etc.)."""
    if getattr(jax.distributed, "is_initialized", lambda: False)():
        return
    jax.distributed.initialize(coordinator_address,
                               num_processes=int(num_processes),
                               process_id=int(process_id), **kw)


def make_global_mesh(axis_names=("dp_host", "dp_chip")) -> Mesh:
    """Global mesh over every device of every process: shape
    ``(process_count, local_device_count)``, first axis = process boundary
    (DCN), second = within-host devices (ICI).  With one process this
    degenerates to ``(1, n_local)`` and stays valid."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_proc = jax.process_count()
    local = len(devs) // max(1, n_proc)
    return Mesh(np.asarray(devs).reshape(n_proc, local), axis_names)


def put_global_batch(mesh: Mesh, tree, axes=("dp_host", "dp_chip")):
    """Shard a pytree (identical host NumPy on every process) with its
    leading axis split over `axes`.  Leading dims must be divisible by the
    total mesh size (pad jobs with no-ops to round up — mirrors the static
    shape discipline used everywhere else)."""
    def put(x):
        x = np.asarray(x)
        sh = NamedSharding(mesh, P(axes, *([None] * (x.ndim - 1))))
        return jax.make_array_from_callback(x.shape, sh,
                                            lambda idx, _x=x: _x[idx])

    return jax.tree_util.tree_map(put, tree)


def distributed_batch_render(kernel, batched_args, mesh: Mesh | None = None,
                             axes=("dp_host", "dp_chip")):
    """``vmap(kernel)`` over the leading batch axis, sharded over the global
    mesh; results are replicated to every process (the out-sharding performs
    the cross-host allgather) and returned as host NumPy.

    `kernel` maps one job's arrays -> one result pytree, exactly like
    :func:`audio_suite_tpu.parallel.batch.batch_render` — this is its
    multi-host twin."""
    if mesh is None:
        mesh = make_global_mesh(axes if isinstance(axes, tuple) else (axes,))
    args = put_global_batch(mesh, batched_args, axes)
    out_sh = NamedSharding(mesh, P())           # replicate to every host
    f = jax.jit(jax.vmap(kernel), out_shardings=out_sh)
    out = f(*args) if isinstance(args, tuple) else f(args)
    return jax.tree_util.tree_map(np.asarray, out)


# ---------------------------------------------------------------------------
# Self-test worker (the 2-process CPU test drives this; also usable manually
# to validate a real multi-host DCN setup before launching a long batch)
# ---------------------------------------------------------------------------

def _selftest(coordinator: str, num_processes: int, process_id: int,
              out_path: str, local_devices: int = 2) -> dict:
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    opt = "--xla_force_host_platform_device_count"
    if opt not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} {opt}={int(local_devices)}".strip()
    jax.config.update("jax_platforms", "cpu")

    init_distributed(coordinator, num_processes, process_id)
    mesh = make_global_mesh()
    n_dev = mesh.devices.size

    # one render job = a decaying partial stack (tiny stand-in for a real
    # engine job; the dispatch path is identical for any kernel)
    sr, n = 8000, 1024
    B = 2 * n_dev
    freqs = (110.0 * (1 + np.arange(B))).astype(np.float32)

    def job(f0):
        t = jnp.arange(n, dtype=jnp.float32) / sr
        env = jnp.exp(-t * 30.0)
        return (jnp.sin(2 * jnp.pi * f0 * t)
                + 0.5 * jnp.sin(2 * jnp.pi * 2.0 * f0 * t)) * env

    got = distributed_batch_render(job, (freqs,), mesh)

    # NumPy oracle (f64) — every process must hold the full, correct batch
    t = np.arange(n) / sr
    want = (np.sin(2 * np.pi * freqs[:, None] * t)
            + 0.5 * np.sin(2 * np.pi * 2.0 * freqs[:, None] * t)) \
        * np.exp(-t * 30.0)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))

    # cross-host mixdown: psum over BOTH axes (dp_chip=ICI, dp_host=DCN)
    gjobs = put_global_batch(mesh, jnp.asarray(got))
    mix = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0),
                             out_shardings=NamedSharding(mesh, P()))(gjobs))
    mix_err = float(np.max(np.abs(mix - want.sum(axis=0))))

    res = {
        "ok": bool(err < 1e-4 and mix_err < 1e-3),
        "process_id": int(jax.process_index()),
        "process_count": int(jax.process_count()),
        "global_devices": int(n_dev),
        "mesh_shape": list(mesh.devices.shape),
        "batch": int(B),
        "max_err": err,
        "mix_err": mix_err,
    }
    with open(out_path, "w") as f:
        json.dump(res, f)
    return res


if __name__ == "__main__":
    import sys

    r = _selftest(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                  sys.argv[4])
    print(json.dumps(r))
    sys.exit(0 if r["ok"] else 1)
