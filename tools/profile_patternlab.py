"""Stage breakdown of the Pattern Lab bench-batch compute on the current
device: bucket census, voice math vs overlap-add vs master bus."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from audio_suite_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np
import jax
import jax.numpy as jnp

from audio_suite_tpu.models import patternlab as pl
from audio_suite_tpu.ops import synth as synth_ops, pallas_oa


def timeit(fn, K=10):
    y = fn(); jax.block_until_ready(y)
    t0 = time.perf_counter()
    for _ in range(K):
        y = fn()
    jax.block_until_ready(y)
    # subtract measured null-dispatch latency
    t = (time.perf_counter() - t0) / K
    return t


def main():
    cfg = pl.RenderConfig(sample_rate=44100, seconds=8.0, bpm=128, seed=9)
    events = []
    for gen in pl.list_generators():
        if gen == "Python Script":
            continue
        events.extend(pl.generate(gen, cfg))
    ev = pl.apply_time_ops(events, cfg)
    synth = pl.MegaDriveInspiredSynth(cfg.sample_rate, seed=cfg.seed)
    print(f"{len(ev)} events over {cfg.seconds}s, "
          f"overlap-add path {pallas_oa.oa_path()}")

    batch = pl.prepare_note_batch(ev, pl.RenderConfig(
        sample_rate=synth.sr, seconds=cfg.seconds, seed=synth.seed))
    print("n_total", batch["n_total"], "count", batch["count"])
    lens = batch["n"]
    print("note len: min/med/max", lens.min(), int(np.median(lens)), lens.max())
    print("psg:", int(batch["is_psg"].sum()), "fm:", int((~batch["is_psg"]).sum()))
    from collections import Counter
    c = Counter()
    for is_psg in (False, True):
        sel = np.nonzero(batch["is_psg"] == is_psg)[0]
        for x in lens[sel]:
            c[(is_psg, pl._bucket_len(int(x)))] += 1
    print("buckets:", dict(sorted(c.items())))

    # full render
    t = timeit(lambda: synth.render(ev, seconds=cfg.seconds,
                                    master_gain=cfg.master_gain,
                                    device_out=True))
    print(f"full render: {t*1e3:.2f} ms  (rtf {cfg.seconds/t:.0f})")

    # null latency
    one = jax.jit(lambda x: x + 1)
    xs = jnp.zeros(8, jnp.float32)
    tn = timeit(lambda: one(xs))
    print(f"null dispatch+BUR: {tn*1e3:.2f} ms")
    print(f"net render: {(t-tn)*1e3:.2f} ms (rtf {cfg.seconds/max(1e-9,t-tn):.0f})")

if __name__ == "__main__":
    main()

def drain_timeit(fn, K=10):
    """Data-dependent scalar readback drain (the bench's protocol)."""
    def drain(y):
        return float(jnp.sum(jnp.abs(jnp.ravel(y)).astype(jnp.float32)))
    y = fn(); drain(y)
    t0 = time.perf_counter()
    for _ in range(K):
        y = fn()
    drain(y)
    return (time.perf_counter() - t0) / K


def main2():
    cfg = pl.RenderConfig(sample_rate=44100, seconds=8.0, bpm=128, seed=9)
    events = []
    for gen in pl.list_generators():
        if gen == "Python Script":
            continue
        events.extend(pl.generate(gen, cfg))
    ev = pl.apply_time_ops(events, cfg)
    synth = pl.MegaDriveInspiredSynth(cfg.sample_rate, seed=cfg.seed)

    # null latency under the drain protocol
    one = jax.jit(lambda x: x + 1)
    xs = jnp.zeros(8, jnp.float32)
    tn = drain_timeit(lambda: one(xs), K=10)
    print(f"null (drain protocol, amortized over 10): {tn*1e3:.2f} ms")

    t = drain_timeit(lambda: synth.render(ev, seconds=cfg.seconds,
                                          master_gain=cfg.master_gain,
                                          device_out=True), K=10)
    print(f"full render (drain): {t*1e3:.2f} ms  rtf {cfg.seconds/t:.0f}")

    # host-only time: bucket prep + dispatch overhead without device wait
    t0 = time.perf_counter()
    for _ in range(10):
        y = synth.render(ev, seconds=cfg.seconds, master_gain=cfg.master_gain,
                         device_out=True)
    th = (time.perf_counter() - t0) / 10
    print(f"host prep+enqueue only: {th*1e3:.2f} ms")

if __name__ == "__main__":
    main2()
