"""NumPy oracle for the Microsound engine.

Mirrors audio_suite_tpu/models/microsound.py stage-for-stage on the host in
float64 (np.fft instead of XLA FFT, noise/detmath NumPy twins instead of the
device kernels), consuming the SAME host program from build_program().  This
is the framework's CPU reference implementation of the semantics of
microsound_0.2.1/main_v2.py:588-792 under the documented padded-length grain
convention; the engine must match it to <= -60 dBFS (BASELINE.json metric).
"""
from __future__ import annotations

import numpy as np

from audio_suite_tpu.ops import detmath, noise
from audio_suite_tpu.ops.generators import (STREAM_BUILD, STREAM_EXC,
                                            STREAM_GATE, STREAM_MAIN,
                                            STREAM_OUT, STREAM_TILT_IM)
from audio_suite_tpu.models.microsound import GEN_MODES, chain_cfg
from audio_suite_tpu.ops.space import er_tap_kernel


def _hann_t(i, n):
    nf = max(1.0, n - 1.0)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * i / nf)
    return np.ones_like(w) if n <= 1 else w


def _edge_fade(i, n):
    fade = max(8, int(0.01 * n))
    w = np.ones(len(i))
    up = i / fade
    down = (n - i) / fade
    w = np.where(i < fade, up, w)
    w = np.where(i >= n - fade, down, w)
    return w


def _conv_same_masked(x, kernel, klen):
    k = kernel[:klen]
    full = np.convolve(x, k, mode="full")
    start = (klen - 1) // 2
    out = np.zeros(len(x))
    seg = full[start:start + len(x)]
    out[:len(seg)] = seg
    return out


def _exp_kernel(K, end):
    return np.exp(-np.linspace(0.0, end, K))


def _tilted_noise(i, n, seed, gen_sr, tilt, L, n_fft=0):
    # framework semantics (round 3): the spectrum is drawn directly —
    # complex Gaussian with component variance n/2 (the rfft distribution
    # of n-sample white noise) — mirroring ops/generators._tilted_noise.
    # With n_fft (round 5) the spectrum lives on the TRUE grain length's
    # bin grid, matching the reference's exact-n rfft (main_v2.py:224-233).
    nfft = int(n_fft) if n_fft else L
    nf = nfft // 2 + 1
    k = np.arange(nf)
    wr = noise.normal_np(seed, k, STREAM_MAIN).astype(np.float64)
    wi = noise.normal_np(seed, k, STREAM_TILT_IM).astype(np.float64)
    f = k * (gen_sr / nfft)
    if f.size > 1:
        f[0] = f[1]
    alpha = np.log2(10.0 ** (tilt / 20.0))
    shape = (f / max(1e-12, f[1])) ** alpha
    g = shape * np.sqrt(0.5 * n)
    y = np.fft.irfft((wr + 1j * wi) * g, n=nfft)
    if nfft < L:
        y = np.concatenate([y, np.zeros(L - nfft)])
    return y


def _generate(e, cfg, prog, idx):
    L = cfg.L
    i = np.arange(L)
    n = int(e["n"])
    seed = int(e["seed"])
    gsr = float(e["gen_sr"])
    t = i / gsr
    micro_s = cfg.micro_ms / 1000.0
    m = cfg.mode_id

    if m == 0:
        sigma = float(max(1, int(0.0025 * n)))
        g = np.exp(-0.5 * (i / sigma) ** 2)
        x = g * (noise.normal_np(seed, i, STREAM_MAIN) * 0.12 + 1.0)
    elif m == 1:
        imp = np.zeros(L)
        k = int(e["dust_k"])
        pos = prog["dust_pos"][idx][:k]
        amp = prog["dust_amp"][idx][:k]
        imp[pos] += amp
        klen = int(e["dust_klen"])
        ker = np.exp(-6.0 * np.arange(klen) / max(1, klen - 1))
        x = _conv_same_masked(imp, ker, klen)
    elif m == 2:
        w = _tilted_noise(i, n, seed, gsr, cfg.noise_tilt, L,
                          n_fft=cfg.n_fft)
        x = w * np.exp(-t / max(1e-6, micro_s * 0.25))
    elif m == 3:
        w = _tilted_noise(i, n, seed, gsr, cfg.noise_tilt, L,
                          n_fft=cfg.n_fft)
        w = np.maximum(0.0, w)
        d = np.diff(w, prepend=w[0])
        x = d * np.exp(-t / max(1e-6, micro_s * 0.2))
    elif m == 4:
        f = max(10.0, cfg.ring_hz)
        tau = max(1e-6, cfg.ring_decay_ms / 1000.0)
        # f32 phase path identical to the device kernel (detmath twins):
        # reciprocal multiply, never a traced division
        t32 = i.astype(np.float32) * np.float32(e["inv_gen_sr"])
        s = detmath.sin_cycles_np(np.float32(f) * t32).astype(np.float64)
        s = s * np.exp(-t / tau)
        exc = noise.normal_np(seed, i, STREAM_EXC) * np.exp(
            -t / max(1e-6, micro_s * 0.15))
        x = 0.9 * s + 0.25 * exc
    elif m == 5:      # crackle
        imp = np.zeros(L)
        pos = prog["ck_pos"][idx]
        amp = prog["ck_amp"][idx]
        for pp, aa in zip(pos, amp):
            if pp < n:
                imp[pp] += aa
        y = _conv_same_masked(imp, _exp_kernel(cfg.ck_klen, 6.0), cfg.ck_klen)
        return np.where(i < n, y, 0.0)
    elif m == 6:      # stick-slip
        thr, build, decay, nz = cfg.ss
        bn = noise.normal_np(seed, i, STREAM_BUILD)
        on = noise.normal_np(seed, i, STREAM_OUT)
        x = np.zeros(L)
        sticking, force = True, 0.0
        for j in range(n):
            if sticking:
                force += build * (float(bn[j]) * nz + 0.2)
                if abs(force) > thr:
                    sticking = False
            else:
                x[j] = force + 0.25 * float(on[j])
                force *= decay
                if abs(force) < 0.02:
                    sticking = True
                    force = 0.0
        x = x * _hann_t(i, n)
        return np.where(i < n, x, 0.0)
    elif m == 7:      # micro-chaos
        r, gate = cfg.chaos
        gates = noise.uniform_np(seed, i, STREAM_GATE)
        xs = np.zeros(L)
        # the logistic map is chaotic: iterate in f32 with the exact device
        # op order or the trajectories diverge exponentially
        r32 = np.float32(r)
        y = np.float32((seed % 10000)) * np.float32(1.0 / 10000.0)
        one = np.float32(1.0)
        half = np.float32(0.5)
        for j in range(n):
            y = np.float32(np.float32(r32 * y) * np.float32(one - y))
            if gates[j] < np.float32(gate):
                xs[j] = np.float32(y - half)
        x = _conv_same_masked(xs, _exp_kernel(48, 5.0), 48)
        x = x * _hann_t(i, n)
        return np.where(i < n, x, 0.0)
    elif m == 8:      # wavelet atoms
        x = np.zeros(L)
        for k in range(cfg.wav_count):
            f0 = np.float32(prog["wl_f0"][idx][k])
            sig = np.float32(prog["wl_sigma"][idx][k])
            ph = np.float32(prog["wl_phase"][idx][k])
            sh = int(prog["wl_shift"][idx][k])
            src = np.mod(i - sh, max(1, n))
            # f32 path identical to morlet_atom_t on device
            tt = ((src.astype(np.float32) - np.float32(n) / np.float32(2.0))
                  * np.float32(e["inv_gen_sr"]))
            env = np.exp(-0.5 * (tt / max(np.float32(1e-9), sig)) ** 2)
            car = detmath.cos_cycles_np(f0 * tt + ph).astype(np.float64)
            x += (1.0 / (1 + k * 0.6)) * env * car
        x = x * _hann_t(i, n)
        return np.where(i < n, x, 0.0)
    else:             # fragment modes (IR / scanline)
        frag = prog["frag"][idx].astype(np.float64)
        fl = int(e["frag_len"])
        pos = i / max(1, n - 1) * max(1, fl - 1)
        i0 = np.minimum(np.clip(pos.astype(np.int64), 0, len(frag) - 2),
                        max(0, fl - 2))
        fr = pos - i0
        x = frag[i0] * (1.0 - fr) + frag[i0 + 1] * fr
        x = np.where(i < n, x, 0.0)
        x = x * _hann_t(i, n)
        if m == 9:    # IR fragment: normalize to 0.9
            mx = np.max(np.abs(np.where(i < n, x, 0.0)))
            if mx > 0:
                x = x * (np.float32(0.9) / max(mx, 1e-30))
        else:         # scanline: exp smear
            x = np.where(i < n, x, 0.0)
            x = _conv_same_masked(x, _exp_kernel(48, 5.0), 48)
        return np.where(i < n, x, 0.0)

    x = x * _edge_fade(i, n)
    return np.where(i < n, x, 0.0)


def _freqs(L, sr):
    return np.arange(L // 2 + 1) * (sr / L)


def _pad_back(y, L):
    return y if len(y) >= L else np.concatenate([y, np.zeros(L - len(y))])


def _lowpass_gain_np(nfft, sr, cutoff, roll):
    """The lowpass gain curve on the exact-n bin grid (main_v2.py:39-59),
    mirroring spectral._lowpass_gain."""
    nyq = 0.5 * sr
    cutoff = float(np.clip(np.float32(cutoff), 1.0, np.float32(nyq)))
    roll = max(roll, 0.0)
    f = _freqs(nfft, sr)
    if roll <= 0:
        return np.where(f > cutoff, 0.0, 1.0)
    f1 = min(nyq, cutoff + roll)
    t = (f - cutoff) / max(1e-12, f1 - cutoff)
    w = 0.5 * (1.0 + np.cos(np.pi * np.clip(t, 0.0, 1.0)))
    return np.where(f > f1, 0.0, np.where(f >= cutoff, w, 1.0))


def _lowpass_fft(x, sr, cutoff, roll, n_fft=0):
    L = len(x)
    nfft = int(n_fft) if n_fft else L
    if n_fft and nfft < 8:          # reference guard (main_v2.py:41)
        return x
    nyq = 0.5 * sr
    cutoff = float(np.clip(np.float32(cutoff), 1.0, np.float32(nyq)))
    roll = max(roll, 0.0)
    X = np.fft.rfft(x[:nfft])
    f = _freqs(nfft, sr)
    if roll <= 0:
        gain = np.where(f > cutoff, 0.0, 1.0)
    else:
        f1 = min(nyq, cutoff + roll)
        t = (f - cutoff) / max(1e-12, f1 - cutoff)
        w = 0.5 * (1.0 + np.cos(np.pi * np.clip(t, 0.0, 1.0)))
        gain = np.where(f > f1, 0.0, np.where(f >= cutoff, w, 1.0))
    return _pad_back(np.fft.irfft(X * gain, n=nfft), L)


def _bandpass_fft(x, sr, lo, hi, roll, n_fft=0):
    L = len(x)
    nfft = int(n_fft) if n_fft else L
    if n_fft and nfft < 8:          # reference guard (main_v2.py:63)
        return x
    nyq = 0.5 * sr
    lo = max(0.0, lo)
    hi = min(max(lo, hi), nyq)
    roll = max(roll, 0.0)
    if hi <= 0:
        return np.zeros_like(x)
    X = np.fft.rfft(x[:nfft])
    f = _freqs(nfft, sr)
    if lo <= 0:
        g_lo = np.ones_like(f)
    elif roll <= 0:
        g_lo = np.where(f < lo, 0.0, 1.0)
    else:
        lo_f0 = max(0.0, lo - roll)
        t = (f - lo_f0) / max(1e-12, lo - lo_f0)
        w = 0.5 * (1.0 - np.cos(np.pi * np.clip(t, 0.0, 1.0)))
        g_lo = np.where(f < lo_f0, 0.0, np.where(f <= lo, w, 1.0))
    if hi >= nyq:
        g_hi = np.ones_like(f)
    elif roll <= 0:
        g_hi = np.where(f > hi, 0.0, 1.0)
    else:
        f1 = min(nyq, hi + roll)
        t = (f - hi) / max(1e-12, f1 - hi)
        w = 0.5 * (1.0 + np.cos(np.pi * np.clip(t, 0.0, 1.0)))
        g_hi = np.where(f > f1, 0.0, np.where(f >= hi, w, 1.0))
    return _pad_back(np.fft.irfft(X * g_lo * g_hi, n=nfft), L)


def _interp_spec(X, k_in):
    k = np.arange(X.size)
    re = np.interp(k_in, k, X.real, left=0.0, right=0.0)
    im = np.interp(k_in, k, X.imag, left=0.0, right=0.0)
    return re + 1j * im


def _one_grain(e, cfg, prog, idx):
    i = np.arange(cfg.L)
    n = int(e["n"])
    gsr = float(e["gen_sr"])
    nfft = int(cfg.n_fft) if cfg.n_fft else cfg.L
    exact = bool(cfg.n_fft)
    x = _generate(e, cfg, prog, idx)
    stretch = float(e["stretch"])

    if exact:
        # ONE spectral pass at the true grain length, mirroring
        # spectral.grain_chain_exact (the engine's exact-length chain);
        # the reference's irfft/rfft round-trips between stages are the
        # identity up to eps, and the fused form keeps filter-zeroed bins
        # exactly zero into the cepstral stage.
        if nfft >= 8:
            X = np.fft.rfft(x[:nfft])
            nf = X.size
            if cfg.bandlimit_on:
                X = X * _lowpass_gain_np(nfft, gsr, float(e["cutoff_gen"]),
                                         cfg.bandlimit_roll)
            if cfg.nl_warp_on and nfft >= 16:
                k = np.arange(nf)
                kmax = max(1.0, float(nf - 1))
                u_in = (k / kmax) ** (1.0 / max(1e-6, cfg.nl_warp_power))
                X = _interp_spec(X, u_in * kmax)
            if cfg.cep_warp_on and nfft >= 64:
                mag = np.abs(X)
                logmag = np.log(mag + 1e-12)      # main_v2.py:153-154
                cep = np.fft.irfft(logmag, n=nfft)
                tt = np.arange(nfft)
                cep2 = np.interp(tt / max(1e-12, cfg.cep_factor), tt, cep,
                                 left=0.0, right=0.0)
                logmag2 = np.fft.rfft(cep2).real
                ph = np.where(mag > 0, X / (mag + 1e-30), 1.0 + 0j)
                X = np.exp(logmag2) * ph
            if abs(stretch - 1.0) >= 1e-9:
                if cfg.partial_lock_on and nfft >= 64:
                    mag = np.abs(X)
                    peaks = np.argsort(-mag[1:],
                                       kind="stable")[:cfg.pl_top_n] + 1
                    Y = np.zeros_like(X)
                    k2 = np.round(peaks
                                  * np.float32(stretch)).astype(np.int64)
                    for d in range(-cfg.pl_neigh, cfg.pl_neigh + 1):
                        w = 1.0 - abs(d) / (cfg.pl_neigh + 1)
                        kk = k2 + d
                        ok = (kk >= 1) & (kk < nf)
                        np.add.at(Y, kk[ok], X[peaks[ok]] * np.float32(w))
                    X = Y + 0.12 * X
                elif not cfg.partial_lock_on and nfft >= 16:
                    k = np.arange(nf)
                    X = _interp_spec(X, k / max(1e-12, stretch))
            x = _pad_back(np.fft.irfft(X, n=nfft), cfg.L)
    else:
        if cfg.bandlimit_on:
            x = _lowpass_fft(x, gsr, float(e["cutoff_gen"]),
                             cfg.bandlimit_roll)
        if cfg.nl_warp_on:
            X = np.fft.rfft(x)
            k = np.arange(X.size)
            kmax = max(1.0, k[-1])
            u = k / kmax
            u_in = u ** (1.0 / max(1e-6, cfg.nl_warp_power))
            x = np.fft.irfft(_interp_spec(X, u_in * kmax), n=cfg.L)
        if cfg.cep_warp_on:
            X = np.fft.rfft(x)
            mag = np.abs(X)
            floor = 1e-4 * max(np.max(mag), 1e-30)  # relative spectral floor
            cep = np.fft.irfft(np.log(np.maximum(mag, floor)), n=cfg.L)
            tt = np.arange(cfg.L)
            cep2 = np.interp(tt / max(1e-12, cfg.cep_factor), tt, cep,
                             left=0.0, right=0.0)
            logmag2 = np.fft.rfft(cep2).real
            x = np.fft.irfft(np.exp(logmag2) * np.exp(1j * np.angle(X)),
                             n=cfg.L)

        if abs(stretch - 1.0) >= 1e-9:
            X = np.fft.rfft(x)
            if cfg.partial_lock_on:
                nf = X.size
                mag = np.abs(X)
                # jax.lax.top_k breaks ties toward the lower index — mirror
                # with a stable descending argsort
                peaks = np.argsort(-mag[1:], kind="stable")[:cfg.pl_top_n] + 1
                Y = np.zeros_like(X)
                k2 = np.round(peaks * np.float32(stretch)).astype(np.int64)
                for d in range(-cfg.pl_neigh, cfg.pl_neigh + 1):
                    w = 1.0 - abs(d) / (cfg.pl_neigh + 1)
                    kk = k2 + d
                    ok = (kk >= 1) & (kk < nf)
                    np.add.at(Y, kk[ok], X[peaks[ok]] * np.float32(w))
                Y = Y + 0.12 * X
                x = np.fft.irfft(Y, n=cfg.L)
            else:
                k = np.arange(X.size)
                x = np.fft.irfft(_interp_spec(X, k / max(1e-12, stretch)),
                                 n=cfg.L)

    if cfg.res_on and n >= 32:
        t = i / gsr
        tau = max(1e-6, cfg.res_decay_ms / 1000.0)
        env = np.exp(-t / tau)
        out = np.zeros(cfg.L)
        t32 = i.astype(np.float32) * np.float32(e["inv_gen_sr"])
        for k in range(cfg.res_modes):
            f = np.float32(prog["res_f"][idx][k])
            ph = np.float32(prog["res_ph"][idx][k])
            car = detmath.sin_cycles_np(f * t32 + ph).astype(np.float64)
            out += (1.0 / (1 + k * 0.35)) * car * env
        peak = max(1e-12, np.max(np.abs(np.where(i < n, out, 0.0))))
        out = out / peak
        x = 0.55 * x + 0.45 * out * np.sign(x)

    if cfg.wg_on and n >= 64:
        y = x.copy()
        for ln in range(cfg.wg_lines):
            d = int(prog["wg_d"][idx][ln])
            g = float(prog["wg_g"][idx][ln])
            mix = float(prog["wg_m"][idx][ln])
            buf = np.zeros(d)
            wp = 0
            for tj in range(cfg.L):
                v = y[tj] + g * buf[wp]
                buf[wp] = v
                wp = (wp + 1) % d
                y[tj] = (1.0 - mix) * y[tj] + mix * v
        x = y

    if cfg.multiband:
        bands, unfolds, roll = cfg.multiband
        acc = None
        for (lo, hi), u in zip(bands, unfolds):
            b = _bandpass_fft(x, gsr, lo * u, hi * u, roll, n_fft=cfg.n_fft)
            acc = b if acc is None else acc + b
        x = acc

    return np.where(i < n, x, 0.0)


def render_ref(params, prog, ir_audio=None):
    """Host-reference render from a prebuilt program (same `prog` the device
    engine consumes)."""
    p = params
    out_n = prog["out_n"]
    out = np.zeros(out_n)
    grain_last = None

    if prog["E"] > 0:
        cfg = chain_cfg(p, prog, prog["E"])
        L = cfg.L
        prev = None
        prev_n = 0
        mem = None
        for idx in range(prog["E"]):
            e = {k: prog[k][idx] for k in
                 ("seed", "n", "gen_sr", "inv_gen_sr", "amp", "offset",
                  "start", "cutoff_gen", "stretch")}
            for k in ("dust_k", "dust_klen", "frag_len"):
                if k in prog:
                    e[k] = prog[k][idx]
            g = _one_grain(e, cfg, prog, idx)
            n = int(e["n"])

            if cfg.fb_on and prev is not None:
                lim = min(n, prev_n)
                g[:lim] = (1.0 - cfg.fb_amt) * g[:lim] + cfg.fb_amt * prev[:lim]
            if cfg.imprint_on and cfg.imprint_amt > 0 and n >= 64:
                nfft_im = int(cfg.n_fft) if cfg.n_fft else L
                X = np.fft.rfft(g[:nfft_im])
                mag = np.abs(X)
                if mem is None:
                    mem = mag.copy()
                else:
                    mem = cfg.imprint_smooth * mem \
                        + (1.0 - cfg.imprint_smooth) * mag
                mag2 = (1.0 - cfg.imprint_amt) * mag + cfg.imprint_amt * mem
                ph = np.where(mag > 0, X / (mag + 1e-30), 1.0 + 0j)
                g = _pad_back(np.fft.irfft(mag2 * ph, n=nfft_im), L)
                g[n:] = 0.0
            prev = g.copy()
            prev_n = n
            grain_last = g

            start = int(e["start"])
            off = int(e["offset"])
            amp = float(e["amp"])
            lim = min(out_n - start, n - off)
            if lim > 0:
                out[start:start + lim] += amp * g[off:off + lim]

    # global FX (main_v2.py:760-781)
    env = _make_adsr(out_n, p.base_sr, p.env_a, p.env_d, p.env_s, p.env_r,
                     p.env_curve)
    out = out * env

    if p.er_cloud_on:
        k = er_tap_kernel(int(p.er_taps), float(p.er_max_ms),
                          int(p.base_sr), int(p.seed)).astype(np.float64)
        out = np.convolve(out, k, mode="full")[:out_n]

    if p.space_ir_on and ir_audio is not None:
        irm = np.asarray(ir_audio, np.float64)
        if irm.ndim > 1:
            irm = irm.mean(axis=1)
        irm = irm[: int(p.space_ir_max_samps)]
        irm = irm[: min(irm.size, 8192)]
        if irm.size >= 8:
            out = np.convolve(out, irm.astype(np.float32).astype(np.float64),
                              mode="full")[:out_n]

    if p.stereo_on and out_n >= 64:
        width = float(np.clip(p.stereo_width, 0.0, 1.0))
        dl = int(round((1 + 7 * width) * 0.0005 * p.base_sr))
        dr = int(round((1 + 9 * width) * 0.0007 * p.base_sr))
        Lc = np.roll(out, dl)
        R = np.roll(out, -dr)
        X = np.fft.rfft(R)
        k = np.arange(X.size)
        kmax = max(1.0, k[-1])
        rot = np.exp(1j * np.float32(width * 0.9)
                     * np.sin(2 * np.pi * k / kmax).astype(np.float32)
                     .astype(np.float64))
        R2 = np.fft.irfft(X * rot, n=out_n)
        st = np.column_stack([Lc, R2])
    else:
        st = np.column_stack([out, out])

    if p.sat_drive > 0:
        st = np.tanh(st * p.sat_drive) / np.tanh(p.sat_drive)
    m = np.max(np.abs(st))
    if m > 0:
        st = st * (p.peak / m)
    return st


def _make_adsr(n, sr, a_ms, d_ms, s, r_ms, curve):
    A = max(0, int(round(sr * a_ms / 1000.0)))
    D = max(0, int(round(sr * d_ms / 1000.0)))
    R = max(0, int(round(sr * r_ms / 1000.0)))
    s = float(np.clip(s, 0, 1))
    curve = max(1e-6, float(curve))
    env = np.ones(n)
    i = 0
    if A > 0:
        env[:A] = (np.arange(min(A, n)) / A) ** curve
        i = A
    j = min(n, i + D)
    if D > 0 and j > i:
        env[i:j] = 1.0 - (1.0 - s) * ((np.arange(j - i) / (j - i)) ** curve)
    sus_start = j
    sus_end = max(sus_start, n - R)
    if sus_end > sus_start:
        env[sus_start:sus_end] = s
    if R > 0 and n > sus_end:
        r = np.linspace(0, 1, n - sus_end, endpoint=True)
        env[sus_end:] = s * (1.0 - r ** curve)
    return env
