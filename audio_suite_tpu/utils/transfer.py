"""Device->host transfer helpers.

Large renders are pulled in a few ~MB windows: `copy_to_host_async` on
every window queues the transfers back-to-back without a host round trip
between them, then the host assembles.  Small arrays skip the machinery
(the fixed per-pull cost dominates).  The chunk count and size threshold
are untuned for the GPU's link (ROADMAP C4).

Every window is cut with ONE static length (pow2-bucketed) at a TRACED
offset: a render length that shifts run to run (param tweaks change the
frame count by a few hundred samples) must never mint fresh XLA slice
kernels — the naive `arr[a:b]` bakes both bounds into the compiled op and
recompiles per distinct length, which dominated the whole param-tweak
loop."""
from __future__ import annotations

import functools

import numpy as np

_TARGET_CHUNKS = 8        # async window pulls per large array
_MIN_BYTES = 3e6          # below this a single pull


@functools.lru_cache(maxsize=64)
def _window_fn(C: int):
    """jitted fixed-length window cut: static length C, traced offset —
    one compiled kernel per (array shape, C), reused for every offset."""
    import jax

    return jax.jit(
        lambda a, off: jax.lax.dynamic_slice_in_dim(a, off, C, axis=0))


def chunked_pull(dev_arr, n_valid: int | None = None) -> np.ndarray:
    """Pull a device array to host as NumPy, chunked along axis 0.

    `n_valid`: true length along axis 0 when the array carries padding —
    only whole windows covering the valid prefix cross the link.  Works on
    NumPy inputs too (no-op slice)."""
    n = int(dev_arr.shape[0] if n_valid is None else n_valid)
    if isinstance(dev_arr, np.ndarray):
        return dev_arr[:n]
    N = int(dev_arr.shape[0])
    n = min(n, N)
    if n <= 0:
        return np.zeros((0,) + tuple(dev_arr.shape[1:]),
                        np.dtype(dev_arr.dtype))
    itemsize = np.dtype(dev_arr.dtype).itemsize
    row = itemsize * int(np.prod(dev_arr.shape[1:], dtype=np.int64))
    # pow2-bucketed window rows: ~n/_TARGET_CHUNKS, so C takes a new value
    # only when the render length doubles — not on every few-sample shift
    C = 1 << max(10, int(np.ceil(np.log2(max(1.0, n / _TARGET_CHUNKS)))))
    if n * row < _MIN_BYTES or C >= N:
        # whole-array pull: the device shape itself is stable (engines
        # bucket their padded lengths), slice on the host
        return np.asarray(dev_arr)[:n]
    k = -(-n // C)
    offs = [min(j * C, N - C) for j in range(k)]
    win = _window_fn(C)
    parts = [win(dev_arr, np.int32(off)) for off in offs]
    for p in parts:
        p.copy_to_host_async()
    out = np.empty((n,) + tuple(dev_arr.shape[1:]), np.dtype(dev_arr.dtype))
    for j, (off, p) in enumerate(zip(offs, parts)):
        a = j * C
        b = min(n, a + C)
        ph = np.asarray(p)
        out[a:b] = ph[a - off:b - off]
    return out
