"""NumPy oracle for the Pattern Lab synth.

Direct port of the reference voice/render code paths:
- _adsr_env / _apply_micro_fade / _one_pole_lp / render_fm_note
  (pattern lab 0.1/app/synth_fm.py)
- _adsr / _square / _noise_lfsr / render_psg_note (app/synth_psg.py)
- MegaDriveInspiredSynth.render event loop (app/renderer.py:79-132)

The phase computations mirror the engine's f32 ops exactly where a discrete
decision follows (square-wave duty comparison), so PSG edges land on the same
samples; everything else is tolerance-compared.
"""
from __future__ import annotations

import numpy as np

from audio_suite_tpu.utils.music import midi_to_hz, quantize_to_bits_f32_np
from audio_suite_tpu.models.patternlab import (
    YM2612_DAC_BITS, POST_LP_HZ, default_fm_channels, default_psg_channels,
)
from audio_suite_tpu.events.notes import prepare_note_batch, RenderConfig


def _apply_micro_fade(x: np.ndarray, sr: int, fade_ms: float = 12.0) -> np.ndarray:
    """app/synth_fm.py:7-24 (the live half of the function; the code after
    the first return is dead in the reference)."""
    x = np.asarray(x, dtype=np.float32).reshape(-1).copy()
    n = int(x.shape[0])
    if n <= 16:
        return x
    fade_n = int(round(sr * (fade_ms / 1000.0)))
    fade_n = int(max(8, min(fade_n, n // 3)))
    if fade_n <= 1:
        return x
    t = np.linspace(0.0, np.pi, fade_n, dtype=np.float32)
    ramp = 0.5 - 0.5 * np.cos(t)
    x[:fade_n] *= ramp
    x[-fade_n:] *= ramp[::-1]
    x[0] = 0.0
    x[-1] = 0.0
    return x


def _adsr_env(n, sr, a, d, s, r, min_a, min_r):
    """app/synth_fm.py:64-99 / synth_psg.py:48-77 (min_a/min_r differ).

    Ramp arithmetic is the framework's host-const convention
    (ops/envelopes.adsr_consts_np / adsr_from_consts): correctly-rounded
    f32 reciprocal MULTIPLIES instead of the reference's f64 linspace
    steps.  Values differ from the literal reference by <= ~1 ulp of the
    envelope (the same order as the reference's own f32 noise); what it
    buys is a BIT-IDENTICAL envelope between this oracle and the device
    engine — device f32 division need not be correctly rounded, and 1-ulp
    envelope wiggles upstream of the DAC quantizer flipped quantization
    steps that dominated long-render parity error."""
    from audio_suite_tpu.ops.envelopes import adsr_consts_np

    a = max(min_a, float(a))
    d = max(1e-4, float(d))
    r = max(min_r, float(r))
    A, D, R = int(sr * a), int(sr * d), int(sr * r)
    s32 = np.float32(s)
    ec = adsr_consts_np(n, A, D, R, s32)
    n_a, n_d, n_r = int(ec["n_a"]), int(ec["n_d"]), int(ec["n_r"])

    i = np.arange(n, dtype=np.int64)
    fi = i.astype(np.float32)
    one = np.float32(1.0)
    ramp_a = (fi * ec["inv_na"]).astype(np.float32)
    val_a = (ramp_a * ramp_a).astype(np.float32)
    kd = (i - n_a).astype(np.float32)
    val_d = (one + (s32 - one) * (kd * ec["inv_nd"])).astype(np.float32)
    rel_start = n - n_r
    kr = (i - rel_start).astype(np.float32)
    ramp_r = (np.where(n_r > 1, one - kr * ec["inv_dr"], one)
              .astype(np.float32))
    val_r = (ec["startv"] * (ramp_r * ramp_r)).astype(np.float32)
    env = np.where(i < n_a, val_a,
                   np.where(i < n_a + n_d, val_d,
                            np.where(i < rel_start, s32, val_r)))
    return env.astype(np.float32)


def _one_pole_lp(x, sr, cutoff_hz, min_cutoff=20.0):
    """app/synth_fm.py:115-124 (f64 accumulator, f32 output)."""
    cutoff_hz = float(max(min_cutoff, cutoff_hz))
    a = np.exp(-2.0 * np.pi * cutoff_hz / float(sr))
    y = np.empty_like(x, dtype=np.float32)
    prev = 0.0
    for i in range(x.shape[0]):
        prev = a * prev + (1.0 - a) * float(x[i])
        y[i] = prev
    return y


def _noise_lfsr(n: int, seed: int = 1) -> np.ndarray:
    """app/synth_psg.py:89-97"""
    lfsr = seed & 0x7FFF
    out = np.empty(n, dtype=np.float32)
    for i in range(n):
        bit = (lfsr ^ (lfsr >> 1)) & 1
        lfsr = (lfsr >> 1) | (bit << 14)
        out[i] = 1.0 if (lfsr & 1) else -1.0
    return out


def _square(sr, hz, n, duty):
    """app/synth_psg.py:83-86, with f32 ops matching the engine bit for bit
    (reciprocal-multiply t, explicit floor-subtract phase)."""
    t = np.arange(n, dtype=np.float32) * np.float32(1.0 / float(sr))
    prod = (t * np.float32(hz)).astype(np.float32)
    phase = (prod - np.floor(prod)).astype(np.float32)
    return np.where(phase < np.float32(duty), 1.0, -1.0).astype(np.float32)


def render_fm_note_np(sr, n, midi, vel, p):
    """app/synth_fm.py:127-191 with note length n precomputed.

    Phases are evaluated in cycles through the deterministic math twins
    (audio_suite_tpu/ops/detmath.py) — the framework-defined semantics the
    engine uses; equivalent to the reference up to f32 phase noise the
    reference itself exhibits at large sin arguments.
    """
    from audio_suite_tpu.ops import detmath as dm
    from audio_suite_tpu.ops.fixq import round_sig12_np as r12
    base = midi_to_hz(midi)
    ops = p.ops
    t = np.arange(n, dtype=np.float32) * np.float32(1.0 / float(sr))

    if p.lfo_depth > 0.0:
        # precise (FMA-safe) twins, matching ops/synth.py's vibrato chain:
        # plain sin_cycles/exp2 drift 1 ulp vs the engine once XLA fuses the
        # FM kernel (FMA contraction of the Horner ladders)
        vib = dm.sin_cycles_precise_np(np.float32(p.lfo_hz) * t)
        vib_ratio = dm.exp2_precise_np((np.float32(p.lfo_depth) * vib)
                                       * np.float32(1.0 / 12.0))
    else:
        vib_ratio = None

    def op_sig(op, pm_cyc):
        det = 2.0 ** (op.detune_cents / 1200.0)
        f = np.float32(base * op.ratio * det)
        c = f * t
        if vib_ratio is not None:
            c = c * vib_ratio
        r0 = dm.frac_signed_np(c)
        if pm_cyc is not None:
            r0 = r0 + pm_cyc
        sig = dm.sin_cycles_np(r0)
        env = _adsr_env(n, sr, op.a, op.d, op.s, op.r, 0.004, 0.008)
        return (sig * env * np.float32(op.level)).astype(np.float32)

    def icyc(op):
        # 12-bit-rounded PM depth — with the modulator also rounded the
        # product is exact, so the engine's r0 + pm add cannot be changed
        # by XLA FMA contraction (framework semantics, both sides)
        return r12(np.float32(op.index / (2.0 * np.pi)))

    def pm(op, m):
        return icyc(op) * r12(m)

    fb = float(max(0.0, p.feedback))
    fb32 = r12(np.float32(fb))
    if p.algorithm == 1:
        o4 = op_sig(ops[3], None)
        if fb > 0:
            o4 = o4 + fb32 * r12(np.concatenate(
                [[0.0], o4[:-1]]).astype(np.float32))
        o3 = op_sig(ops[2], pm(ops[2], o4))
        o2 = op_sig(ops[1], pm(ops[1], o3))
        o1 = op_sig(ops[0], pm(ops[0], o2))
        y = o1
    elif p.algorithm == 2:
        o4 = op_sig(ops[3], None)
        if fb > 0:
            o4 = o4 + fb32 * r12(np.concatenate(
                [[0.0], o4[:-1]]).astype(np.float32))
        o3 = op_sig(ops[2], pm(ops[2], o4))
        o2 = op_sig(ops[1], None)
        o1 = op_sig(ops[0], pm(ops[0], o2))
        y = (o3 + o1) * np.float32(0.6)
    else:
        y = (op_sig(ops[0], None) + op_sig(ops[1], None)
             + op_sig(ops[2], None) + op_sig(ops[3], None)) * np.float32(0.25)

    y = (y * np.float32(vel)).astype(np.float32)
    y = quantize_to_bits_f32_np(y, YM2612_DAC_BITS)
    y = _apply_micro_fade(y, sr)
    y = _one_pole_lp(y, sr, POST_LP_HZ)
    y = _one_pole_lp(y, sr, 14000.0)
    return y.astype(np.float32)


def render_psg_note_np(sr, n, midi, vel, p, seed=1):
    """app/synth_psg.py:100-124 with note length n precomputed."""
    env = _adsr_env(n, sr, p.a, p.d, p.s, p.r, 0.003, 0.006)
    if p.noise:
        sig = _noise_lfsr(n, seed=seed)
    else:
        hz = midi_to_hz(midi)
        sig = _square(sr, hz, n, duty=float(np.clip(p.duty, 0.05, 0.95)))
    y = sig * env * np.float32(vel)
    y = quantize_to_bits_f32_np(y.astype(np.float32), int(p.bits))
    y = _apply_micro_fade(y, sr)
    y = _one_pole_lp(y, sr, 12000.0, min_cutoff=50.0)
    return y.astype(np.float32)


def render_np(events, cfg: RenderConfig, fm_channels=None, psg_channels=None,
              master_gain=None) -> np.ndarray:
    """app/renderer.py:79-132 (events already time-op'd)."""
    sr = int(cfg.sample_rate)
    fm = fm_channels or default_fm_channels()
    psg = psg_channels or default_psg_channels()
    mg = cfg.master_gain if master_gain is None else master_gain

    batch = prepare_note_batch(events, cfg)
    n_total = batch["n_total"]
    y = np.zeros(n_total, dtype=np.float32)
    if batch["count"]:
        for j in range(batch["count"]):
            start = int(batch["start"][j])
            n = int(batch["n"][j])
            if batch["is_psg"][j]:
                p = psg[int(batch["chan"][j])]
                note = render_psg_note_np(sr, n, batch["midi"][j],
                                          batch["vel"][j], p,
                                          seed=int(cfg.seed) + int(batch["k"][j]))
            else:
                p = fm[int(batch["chan"][j])]
                note = render_fm_note_np(sr, n, batch["midi"][j],
                                         batch["vel"][j], p)
            tail = n_total - start
            seg = min(note.shape[0], tail)
            if seg > 0:
                y[start:start + seg] += note[:seg]
    y = np.tanh(y).astype(np.float32)
    y *= float(mg)
    return y
