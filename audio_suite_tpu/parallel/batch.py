"""Multi-chip batch parallelism: meshes, sharded batch renders, collective
mixdowns, and resumable batch manifests.

The reference suite is single-process (SURVEY.md §2.7) — its only "batch"
feature is Microsound's seeds×unfolds×stretches grid loop
(microsound_0.2.1/main_v2.py:1524-1596).  The framework makes batch
rendering a first-class data-parallel component:

- within a device: vmap over grains/notes/tracks (the engine kernels)
- across devices: a `jax.sharding.Mesh` with a "dp" axis over render jobs
                  (seeds × presets × grid variations)
- within a job:   an optional "ev" axis sharding one render's event batch,
                  reduced with a psum collective (the mixdown-as-collective
                  pattern; also used by Grid Audio's track sum)
- across hosts:   jax.distributed + the same mesh spanning hosts
                  (initialize with `jax.distributed.initialize()` first)

Tests fake an 8-device CPU platform via
``--xla_force_host_platform_device_count`` (SURVEY.md §4).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def shard_map(f, mesh, in_specs, out_specs):
    """jax.shard_map without varying-axes type checks: a Pallas kernel
    (the tiled overlap-add) inside the body carries no such types."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def make_mesh(n_devices: int | None = None, axis_names=("dp",),
              shape: tuple | None = None) -> Mesh:
    """Build a device mesh.  1-axis ("dp") by default; pass axis_names and
    shape for 2-D (dp, ev) layouts.  Uses the first n_devices devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[: int(n_devices)]
    n = len(devs)
    if shape is None:
        shape = (n,) if len(axis_names) == 1 else None
    if shape is None:
        # factor n into len(axis_names) axes, largest first
        k = len(axis_names)
        dims = [n] + [1] * (k - 1)
        for i in range(1, k):
            for f in (2, 3):
                if dims[0] % f == 0 and dims[0] > f:
                    dims[0] //= f
                    dims[i] *= f
                    break
        shape = tuple(dims)
    arr = np.asarray(devs).reshape(shape)
    return Mesh(arr, axis_names)


def shard_batch(mesh: Mesh, tree, axis: str = "dp"):
    """device_put a pytree with its leading axis sharded over `axis`
    (leading-dim size must divide the axis size or be a multiple of it)."""
    sharding = NamedSharding(mesh, P(axis))

    def put(x):
        x = jnp.asarray(x)
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    del sharding
    return jax.tree_util.tree_map(put, tree)


def batch_render(kernel, batched_args, mesh: Mesh | None = None,
                 axis: str = "dp"):
    """Run `vmap(kernel)` over the leading batch axis, sharded across the
    mesh.  `kernel` maps one job's arrays -> one result pytree.  With no
    mesh, runs single-device.  Returns host NumPy results."""
    f = jax.jit(jax.vmap(kernel))
    if mesh is not None:
        batched_args = shard_batch(mesh, batched_args, axis)
    out = f(*batched_args) if isinstance(batched_args, tuple) \
        else f(batched_args)
    return jax.tree_util.tree_map(np.asarray, out)


def sharded_sum(parts, mesh: Mesh, axis: str = "dp"):
    """Collective mixdown: parts [S, T] with S sharded over `axis` ->
    sum over S via an on-device psum (the Grid Audio track-sum /
    batch-reduction pattern, riding ICI)."""
    S, T = parts.shape

    def local_sum(x):
        return jax.lax.psum(jnp.sum(x, axis=0), axis)

    f = shard_map(local_sum, mesh, in_specs=P(axis, None),
                  out_specs=P())
    return jax.jit(f)(parts)


# ---------------------------------------------------------------------------
# Batch manifests (checkpoint/resume for batch renders, SURVEY.md §5)
# ---------------------------------------------------------------------------

@dataclass
class BatchManifest:
    """Resumable record of a batch render: one entry per job with status,
    so a failed shard is re-renderable without redoing the rest."""
    path: str
    jobs: dict

    @staticmethod
    def create(path: str, job_ids: list[str]) -> "BatchManifest":
        m = BatchManifest(path=path,
                          jobs={j: {"status": "pending"} for j in job_ids})
        m.save()
        return m

    @staticmethod
    def load(path: str) -> "BatchManifest":
        with open(path) as f:
            return BatchManifest(path=path, jobs=json.load(f))

    @staticmethod
    def open_or_create(path: str, job_ids: list[str]) -> "BatchManifest":
        if os.path.exists(path):
            m = BatchManifest.load(path)
            for j in job_ids:
                m.jobs.setdefault(j, {"status": "pending"})
            return m
        return BatchManifest.create(path, job_ids)

    def pending(self) -> list[str]:
        return [j for j, v in self.jobs.items() if v["status"] != "done"]

    def mark(self, job_id: str, status: str, **info):
        self.jobs[job_id] = {"status": status, **info}
        self.save()

    def save(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.jobs, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
