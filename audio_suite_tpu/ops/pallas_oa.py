"""Overlap-add of event windows into a long buffer.

Overlap-add is the placement step shared by Microsound grains
(main_v2.py:742-755) and Pattern Lab notes: out[start_e + j] += vals[e, j].
Every path here adds the windows in event order, so overlapping regions
round exactly like the sequential NumPy oracle's accumulation; an atomic
scatter-add would not (its order changes from run to run).

Two paths, one contract, one chooser (`oa_path`):

- ``overlap_add_dus(out, vals, starts)``: a ``fori_loop`` of one
  dynamic-slice read-modify-write per event.  Portable; the CPU path.
- ``tiled_overlap_add(out, vals, plan)``: a Pallas kernel through Triton
  (the GPU path).  Parallel over output tiles: a host plan
  (`plan_tiles`) lists, for each tile, the events whose window covers
  it, in ascending event index.  Each tile loads its `out` values once,
  adds every covering event's masked slice in list order, and stores
  once — the same ``((out + v1) + v2) + ...`` per sample as the DUS
  loop, so the two are bit-equal.  Notes need not be start-sorted.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

TILE = 1024                      # output samples per kernel block
NUM_WARPS = 4                    # 128 threads: 8 samples each


def oa_path(platform: str | None = None) -> str:
    """The overlap-add path for a platform (default: JAX's first device):
    "tiled" (the Pallas kernel) on the GPU, "dus" on the CPU."""
    if platform is None:
        platform = jax.devices()[0].platform
    if platform == "gpu":
        return "tiled"
    if platform == "cpu":
        return "dus"
    raise RuntimeError(f"no overlap-add path for platform {platform!r}")


def buffer_len(out_n: int, L: int) -> int:
    """Margin-layout OA buffer length (samples) for a render of out_n
    samples with windows of L: left margin L (absorbs negative starts down
    to -L), right slack L for windows overhanging the end, rounded up to
    whole tiles."""
    raw = L + out_n + L
    return -(-raw // TILE) * TILE


def overlap_add_dus(out, vals, starts):
    """Sequential window read-modify-write via dynamic_update_slice.

    Starts MUST be in [0, len(out)-L]: XLA clamps out-of-range
    dynamic-slice starts, which would silently MOVE a window instead of
    cropping it — callers use a margin buffer (see engines) so every
    window is in range.
    """
    E, L = vals.shape

    def body(e, out):
        start = jnp.clip(starts[e], 0, out.shape[0] - L)
        win = jax.lax.dynamic_slice(out, (start,), (L,))
        return jax.lax.dynamic_update_slice(out, win + vals[e], (start,))

    return jax.lax.fori_loop(0, E, body, out)


# ---------------------------------------------------------------------------
# Tile plan (host, concrete starts)
# ---------------------------------------------------------------------------

class TilePlan(NamedTuple):
    """CSR map from output tiles to covering events.  Entries of tile t are
    ptr[t]:ptr[t+1]; each holds the event's row `ev` and `off`, the
    window index at the tile's first sample (tile*TILE - start, in
    (-TILE, L)).  Arrays are padded to a bound fixed by (E, L, out_len),
    so one compiled kernel serves every plan of that shape."""
    ptr: np.ndarray              # i32[n_tiles + 1]
    ev: np.ndarray               # i32[cap]
    off: np.ndarray              # i32[cap]


def plan_capacity(E: int, L: int) -> int:
    """Static bound on plan entries: a window of L samples covers at most
    ceil(L / TILE) + 1 tiles."""
    return max(1, E * (-(-L // TILE) + 1))


def plan_tiles(starts, L: int, out_len: int) -> TilePlan:
    """Build the tile plan for concrete window starts.  Starts are clamped
    to [0, out_len - L] exactly as `overlap_add_dus` clamps them."""
    tile = TILE
    assert out_len % tile == 0 and L <= out_len, (out_len, L)
    starts = np.clip(np.asarray(starts, np.int64), 0, out_len - L)
    E = starts.shape[0]
    n_tiles = out_len // tile
    t0 = starts // tile
    counts = (starts + L - 1) // tile - t0 + 1
    ev = np.repeat(np.arange(E, dtype=np.int64), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    tiles = np.repeat(t0, counts) + np.arange(ev.size) - first
    order = np.argsort(tiles, kind="stable")      # keeps event order
    ev, tiles = ev[order], tiles[order]
    cap = plan_capacity(E, L)
    ptr = np.zeros(n_tiles + 1, np.int32)
    ptr[1:] = np.cumsum(np.bincount(tiles, minlength=n_tiles))
    ev_p = np.zeros(cap, np.int32)
    off_p = np.zeros(cap, np.int32)
    ev_p[:ev.size] = ev
    off_p[:ev.size] = tiles * tile - starts[ev]
    return TilePlan(ptr, ev_p, off_p)


# ---------------------------------------------------------------------------
# Tiled kernel (Pallas, Triton route)
# ---------------------------------------------------------------------------

def _tile_kernel(ptr_ref, ev_ref, off_ref, vals_ref, out_in_ref, out_ref,
                 *, L: int, tile: int):
    t = pl.program_id(0)
    j = jax.lax.broadcasted_iota(jnp.int32, (tile,), 0)

    def add(k, acc):
        e = ev_ref[k]
        off = off_ref[k]
        # vals rows carry `tile` zeros on both sides, so the slice is in
        # bounds for any off in (-tile, L); the mask keeps samples outside
        # the window untouched (adding +0.0 would turn -0.0 into +0.0)
        v = vals_ref[e, pl.ds(off + tile, tile)]
        w = j + off
        return jnp.where((w >= 0) & (w < L), acc + v, acc)

    out_ref[...] = jax.lax.fori_loop(ptr_ref[t], ptr_ref[t + 1], add,
                                     out_in_ref[...])


@lru_cache(maxsize=32)
def _tiled_fn(E: int, L: int, out_len: int, cap: int, interpret: bool):
    tile = TILE
    n_tiles = out_len // tile
    whole = pl.BlockSpec()                 # the full array, every block
    block = pl.BlockSpec((tile,), lambda t: (t,))
    kernel = pl.pallas_call(
        lambda *refs: _tile_kernel(*refs, L=L, tile=tile),
        out_shape=jax.ShapeDtypeStruct((out_len,), jnp.float32),
        grid=(n_tiles,),
        in_specs=[whole, whole, whole, whole, block],
        out_specs=block,
        input_output_aliases={4: 0},
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="tiled_overlap_add",
    )

    def run(out, vals, ptr, ev, off):
        vals = jnp.pad(vals.astype(jnp.float32), ((0, 0), (tile, tile)))
        return kernel(ptr, ev, off, vals, out)

    return run


def tiled_overlap_add(out, vals, plan, *, interpret: bool | None = None):
    """out f32[out_len] += windows vals f32[E, L] per a `plan_tiles` plan
    (out_len % TILE == 0).  The kernel is compiled for the GPU; elsewhere
    (interpret=None off a GPU, or interpret=True) it runs through the
    Pallas interpreter, which is how the CPU tests reach it."""
    if interpret is None:
        interpret = jax.devices()[0].platform != "gpu"
    E, L = vals.shape
    ptr, ev, off = (jnp.asarray(a, jnp.int32) for a in plan)
    fn = _tiled_fn(E, L, out.shape[0], ev.shape[0], bool(interpret))
    return fn(out, vals, ptr, ev, off)


def overlap_add(out, vals, starts, plan: TilePlan | None = None,
                path: str | None = None):
    """The OA chooser: `oa_path()` picks the tiled kernel on the GPU and
    the DUS loop on the CPU.  The tiled path needs a plan: pass one built
    from concrete starts on the host, or concrete (NumPy) `starts`."""
    path = path or oa_path()
    if path == "dus":
        return overlap_add_dus(out, vals, jnp.asarray(starts, jnp.int32))
    if plan is None:
        plan = plan_tiles(np.asarray(starts), vals.shape[1], out.shape[0])
    return tiled_overlap_add(out, vals, plan)
