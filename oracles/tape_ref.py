"""NumPy oracle for the TapeTUC varispeed render.

Line-by-line port of the reference hot loop (tape-tuc-main/
Tape_TUC_23-11-25_auto-slice_n_record.py:767-911 `provide_samples`), with the
position/speed state held in the same exact int32 fixed-point representation
as the device engine (audio_suite_tpu/ops/fixq.py).  Every discrete decision
(section lookup, splice trigger, boundary distance) is integer math and
therefore bit-identical to the engine; the f32 audio math matches to ~1 ulp.

This is the test ground truth for audio_suite_tpu.models.tape.
"""
from __future__ import annotations

import numpy as np

from audio_suite_tpu.ops.fixq import (
    POS_FRAC_BITS, POS_ONE, POS_INV_F, quantize_f32_np,
)


def render_tape_np(prog: dict, init: dict | None = None,
                   return_state: bool = False):
    """Sequential render of `prog` (from models.tape.build_tape_program).

    `init` optionally carries state across segmented renders (the TapeTrace
    oracle): {"whole", "frac", "rem", "sidx"} — speed always comes from
    prog["consts"].initial_speed_q (the trace builder embeds the carried
    speed there, matching the engine).  With return_state the final
    (whole, frac, rem, sidx) comes back for the next segment."""
    audio = np.asarray(prog["audio"], np.float32)
    mod_q = np.asarray(prog["mod_q"], np.float32)
    starts = np.asarray(prog["starts"], np.int64)
    ends = np.asarray(prog["ends"], np.int64)
    speeds_q = np.asarray(prog["speeds_q"], np.float32)
    reverse = np.asarray(prog["reverse"], np.bool_)
    boundaries = np.asarray(prog["boundaries"], np.int64)
    env = np.asarray(prog["splice_env"], np.float32)
    c = prog["consts"]
    T = int(prog["num_frames"])

    n = len(audio)
    num_secs = len(starts)
    env_len = len(env)
    bset = set(int(b) for b in boundaries)
    have_bounds = len(boundaries) > 0

    strength = np.float32(c.anticlick_strength)
    smooth_len = int(c.smooth_len)
    inv_smooth = np.float32(1.0 / max(1, smooth_len))
    alpha_q = np.float32(c.alpha_q)

    whole = 0
    frac = 0
    speed = np.float32(c.initial_speed_q)
    rem = 0
    sidx = 0
    if init is not None:
        whole = int(init.get("whole", 0))
        frac = int(init.get("frac", 0))
        rem = int(init.get("rem", 0))
        sidx = int(init.get("sidx", 0))

    out = np.zeros(T, np.float32)
    one = np.float32(1.0)

    for i in range(T):
        whole = whole % n

        # --- section lookup (Tape…py:761-765, 816-822) ---
        sec = int(np.searchsorted(starts, whole, side="right")) - 1
        if sec < 0:
            sec = 0
        if sec >= num_secs:
            sec = num_secs - 1
        sec_start = int(starts[sec])
        sec_end = int(ends[sec])
        if sec_end <= sec_start:
            sec_end = sec_start + 1
        sec_len = sec_end - sec_start
        local_w = (whole - sec_start) % sec_len

        # --- read index (Tape…py:824-836, incl. int() truncation) ---
        if reverse[sec]:
            a = sec_end - 1 - local_w
            if frac > 0:
                if a == 0:
                    idx0 = 0
                    fr = np.float32(-frac) * POS_INV_F
                else:
                    idx0 = a - 1
                    fr = np.float32(POS_ONE - frac) * POS_INV_F
            else:
                idx0 = a
                fr = np.float32(0.0)
        else:
            idx0 = sec_start + local_w
            fr = np.float32(frac) * POS_INV_F

        if idx0 < 0:
            idx0 = 0
        if idx0 > n - 1:
            idx0 = n - 1
        idx1 = min(idx0 + 1, n - 1)
        s = (one - fr) * audio[idx0] + fr * audio[idx1]

        # --- anti-click boundary dip (Tape…py:838-849) ---
        if c.anticlick_on and smooth_len > 0 and have_bounds:
            j = int(np.searchsorted(boundaries, idx0))
            dmin = 2**30
            if j - 1 >= 0:
                dmin = min(dmin, abs(idx0 - int(boundaries[j - 1])))
            if j < len(boundaries):
                dmin = min(dmin, abs(int(boundaries[j]) - idx0))
            if dmin < smooth_len:
                x = np.float32(smooth_len - dmin) * inv_smooth
                gain = one - strength * x
                if gain < 0.0:
                    gain = np.float32(0.0)
                s = s * gain

        # --- splice envelope (Tape…py:851-858) ---
        if c.splice_on and have_bounds:
            if idx0 in bset and rem <= 0:
                rem = env_len
                sidx = 0
            if rem > 0 and sidx < env_len:
                s = s * env[sidx]
                rem -= 1
                sidx += 1

        if s > 1.0:
            s = np.float32(1.0)
        if s < -1.0:
            s = np.float32(-1.0)
        out[i] = s

        # --- speed target + inertia (Tape…py:863-882) ---
        target = speeds_q[sec]
        if c.inertia_on:
            d = np.float32(target - speed)
            m = quantize_f32_np(d * alpha_q)
            speed = np.float32(speed + m)
        else:
            speed = target

        # --- wow/flutter + advance (Tape…py:884-893) ---
        inc = int(np.rint(np.float32(speed * mod_q[i]) * np.float32(POS_ONE)))
        f = frac + inc
        carry = f >> POS_FRAC_BITS
        whole = whole + carry
        frac = f - (carry << POS_FRAC_BITS)

    if return_state:
        return out, {"whole": whole, "frac": frac, "speed": float(speed),
                     "rem": rem, "sidx": sidx}
    return out
