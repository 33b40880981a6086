"""Forest Fire CA step-rate vs grid size on the current device.

The reference simulates a fixed 220x160 grid at ~30 Hz on desktop CPU
(forest_fire_OSC_0.1/main.py:430-433).  This measures the device engine's
steps/second at the reference size and at progressively larger grids —
the single-chip scaling context for the row-sharded CA in parallel/ca.py
(grids beyond one chip's HBM or step budget shard over a mesh).

    python tools/ca_bench.py [n_steps]
"""
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
from audio_suite_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np
import jax

from audio_suite_tpu.models import forestfire as ff


def main():
    print("device:", jax.devices()[0])
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 480
    for (h, w) in ((160, 220), (512, 512), (1024, 1024), (2048, 2048)):
        params = ff.ModelParams(h=h, w=w)
        model = ff.ForestFireModel(params, seed=2)
        model.ignite_at(w // 2, h // 2, radius=max(2, h // 50))
        model.simulate(n_steps)           # compile + settle
        t0 = time.perf_counter()
        stats = model.simulate(n_steps)
        dt = time.perf_counter() - t0
        rate = n_steps / dt
        cells = h * w
        print(f"{h:5d}x{w:<5d} ({cells/1e6:6.2f} M cells): "
              f"{rate:9.1f} steps/s  ({rate/30.0:8.1f}x the reference "
              f"30 Hz tick)  {rate*cells/1e9:7.2f} Gcell-steps/s  "
              f"burning[-1]={int(stats[-1, 2])}")


if __name__ == "__main__":
    main()
