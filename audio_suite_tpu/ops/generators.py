"""Microsound micro-event generators — vmapped device kernels.

Ports of the 11 grain modes in microsound_0.2.1/main_v2.py:219-362.  Each
kernel renders one event over padded indices i[L] given the event's true
length n (traced) and design rate gen_sr (traced), using:

- counter-based deterministic noise (ops/noise.py) for per-sample randomness
  (streams are event-seeded like the reference's ``seed + i``),
- host-precomputed auxiliary draws for small per-event randomness (crackle
  spike times, wavelet atom parameters, IR slice choice, image row) shipped
  as arrays,
- deterministic cycle-domain oscillators (ops/detmath.py).

Per-sample recurrences (stick-slip, micro-chaos) run as lax.scan over the
padded length, vmapped across the event batch.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import detmath, noise

# noise stream ids (framework-defined)
STREAM_MAIN = 0
STREAM_EXC = 1
STREAM_BUILD = 2
STREAM_OUT = 3
STREAM_GATE = 4
STREAM_TILT_IM = 5   # imaginary component of the drawn tilt-noise spectrum


def hann_t(i, n):
    """hann(n) over padded indices (main_v2.py:17-21)."""
    nf = jnp.maximum(1, n - 1).astype(jnp.float32)
    w = jnp.float32(0.5) - jnp.float32(0.5) * jnp.cos(
        jnp.float32(2.0 * np.pi) * i.astype(jnp.float32) / nf)
    return jnp.where(n <= 1, jnp.ones_like(w), w)


def edge_fade(i, n, frac=0.01, min_fade=8):
    """gen_basic's 1% edge fade (main_v2.py:265-268)."""
    fade = jnp.maximum(min_fade, (jnp.float32(frac) * n.astype(jnp.float32))
                       .astype(jnp.int32))
    ff = fade.astype(jnp.float32)
    up = i.astype(jnp.float32) / ff
    down = (n - i).astype(jnp.float32) / ff   # linspace(1,0,fade,endpoint=False)
    w = jnp.ones_like(up)
    w = jnp.where(i < fade, up, w)
    # w[-fade:] = linspace(1,0,fade,endpoint=False): value (n-i)/fade
    w = jnp.where(i >= n - fade, down, w)
    return w


def masked_conv_same(x, kernel, klen):
    """np.convolve(x, kernel, mode='same') with a (possibly traced) kernel
    length `klen` inside a static buffer (main_v2.py:244-245 etc.)."""
    L = x.shape[-1]
    K = kernel.shape[-1]
    k = jnp.where(jnp.arange(K) < klen, kernel, 0.0)
    # precision: HIGHEST keeps f32 fidelity — a default-precision
    # convolution may run in a reduced-precision matrix unit (bf16 or
    # TF32, ~1e-3 relative error), which breaks the -60 dBFS budget
    full = jnp.convolve(x, k, mode="full",
                        precision=jax.lax.Precision.HIGHEST)
    start = (klen - 1) // 2                          # np 'same' offset
    full = jnp.concatenate([full, jnp.zeros(K, x.dtype)])
    return jax.lax.dynamic_slice(full, (start,), (L,))


def exp_kernel(K: int, end: float):
    """exp(-linspace(0, end, K)) as a static host array."""
    return np.exp(-np.linspace(0.0, end, K)).astype(np.float32)


def exp_kernel_t(K: int, klen, end: float):
    """exp(-linspace(0, end, klen)) inside a static-size buffer of K entries,
    zero beyond klen (device twin of exp_kernel for traced klen)."""
    j = jnp.arange(K, dtype=jnp.float32)
    step = jnp.float32(end) / jnp.maximum(1, klen - 1).astype(jnp.float32)
    k = jnp.exp(-j * step)
    return jnp.where(jnp.arange(K) < klen, k, 0.0)


def _tilted_noise(i, n, seed, gen_sr, tilt_db_per_oct, L, n_fft=None):
    """Spectrally tilted Gaussian noise (main_v2.py:224-233).

    Framework semantics (round 3): the SPECTRUM is drawn directly — the
    rfft of n-sample white Gaussian noise is complex Gaussian with
    per-component variance n/2 — which skips the forward transform
    entirely (the reference filters time-domain noise through
    rfft -> shape -> irfft; one transform instead of two, measured
    2.36 -> 1.09 ms on the [270, 32768] grain batch, tools/fft_sizes.py).
    Same counter-noise determinism (streams MAIN + TILT_IM over bin
    indices); the NumPy oracle draws the identical spectrum.

    With n_fft (round 5 exact-length semantics) the spectrum is drawn on
    the TRUE grain length's bin grid (nf = n_fft//2 + 1) and inverted at
    exactly n_fft — matching the reference's exact-n rfft of n white
    samples; without it, the legacy padded-length grid."""
    nfft = int(n_fft) if n_fft is not None else L
    nf = nfft // 2 + 1
    k = jnp.arange(nf, dtype=jnp.int32)
    wr = noise.normal(seed, k, STREAM_MAIN)
    wi = noise.normal(seed, k, STREAM_TILT_IM)
    # f/f1 == bin index exactly (f = k*gen_sr/nfft, f1 = gen_sr/nfft), so
    # the tilt shape is gen_sr-INDEPENDENT: one [nf] pow instead of an
    # [E, nf] transcendental per event under vmap (XLA hoists ops with
    # no batched operands out of the event batch)
    r = k.astype(jnp.float32).at[0].set(1.0)
    alpha = jnp.log2(jnp.float32(10.0) ** (jnp.asarray(tilt_db_per_oct,
                                                       jnp.float32) / 20.0))
    g = (r ** alpha) * jnp.sqrt(jnp.float32(0.5) * n.astype(jnp.float32))
    W = jax.lax.complex(wr * g, wi * g)
    from . import exact_dft
    return exact_dft.irfft_n(W, nfft, out_len=L)


def gen_basic(i, n, seed, gen_sr, inv_gen_sr, micro_ms, mode_id: int,
              dust_pos, dust_amp, dust_k, dust_klen, noise_tilt, ring_hz,
              ring_decay_ms, dust_kmax: int = 4096, n_fft=None):
    """Modes of gen_basic (main_v2.py:219-269); `mode_id` is STATIC (the
    reference's gen_mode is a global render parameter, so only the selected
    branch is traced/compiled).

    mode_id: 0 Gaussian click, 1 Dust impulses, 2 Noise burst,
             3 Skewed transient, 4 Resonant strike, 5 default noise.
    dust_pos/dust_amp: host-drawn impulse positions/amps [Smax] (mode 1,
    rng(seed+i) like the reference's integers/uniform draws).
    """
    L = i.shape[0]
    # t via host-computed reciprocal multiply: XLA's vectorized f32 divide
    # rounds differently under jit than eager IEEE division, which matters
    # for the sin phases below (detmath parity contract)
    t = i.astype(jnp.float32) * jnp.asarray(inv_gen_sr, jnp.float32)
    micro_s = jnp.asarray(micro_ms, jnp.float32) / 1000.0

    if mode_id == 0:      # Gaussian click
        sigma = jnp.maximum(1, (jnp.float32(0.0025) * n.astype(jnp.float32))
                            .astype(jnp.int32)).astype(jnp.float32)
        g = jnp.exp(-0.5 * (i.astype(jnp.float32) / sigma) ** 2)
        x = g * (noise.normal(seed, i, STREAM_MAIN) * jnp.float32(0.12) + 1.0)
    elif mode_id == 1:    # Dust impulses -> exp-kernel smear
        imp = jnp.zeros(L, jnp.float32)
        valid = jnp.arange(dust_pos.shape[0]) < dust_k
        imp = imp.at[jnp.where(valid, dust_pos, L)].add(
            jnp.where(valid, dust_amp, 0.0), mode="drop")
        x = masked_conv_same(imp, exp_kernel_t(dust_kmax, dust_klen, 6.0),
                             dust_klen)
    elif mode_id == 2:    # Noise burst
        tn = _tilted_noise(i, n, seed, gen_sr, noise_tilt, L, n_fft=n_fft)
        env2 = jnp.exp(-t / jnp.maximum(1e-6, micro_s * 0.25))
        x = tn * env2
    elif mode_id == 3:    # Skewed transient
        tn = _tilted_noise(i, n, seed, gen_sr, noise_tilt, L, n_fft=n_fft)
        w3 = jnp.maximum(0.0, tn)
        d3 = jnp.diff(w3, prepend=w3[:1])
        env3 = jnp.exp(-t / jnp.maximum(1e-6, micro_s * 0.2))
        x = d3 * env3
    elif mode_id == 4:    # Resonant strike
        f4 = jnp.maximum(10.0, jnp.asarray(ring_hz, jnp.float32))
        tau4 = jnp.maximum(1e-6,
                           jnp.asarray(ring_decay_ms, jnp.float32) / 1000.0)
        s4 = detmath.sin_cycles(f4 * t) * jnp.exp(-t / tau4)
        exc = noise.normal(seed, i, STREAM_EXC) * jnp.exp(
            -t / jnp.maximum(1e-6, micro_s * 0.15))
        x = jnp.float32(0.9) * s4 + jnp.float32(0.25) * exc
    else:                 # default noise
        x = noise.normal(seed, i, STREAM_MAIN) * jnp.float32(0.1)

    x = x * edge_fade(i, n)
    return jnp.where(i < n, x, 0.0)


def gen_crackle(i, n, spike_pos, spike_amp, kernel, klen):
    """Pareto-interval crackle (main_v2.py:271-281); spike times/amps drawn
    host-side with the reference's np RNG."""
    L = i.shape[0]
    imp = jnp.zeros(L, jnp.float32)
    valid = spike_pos < n
    imp = imp.at[jnp.where(valid, spike_pos, L)].add(
        jnp.where(valid, spike_amp, 0.0), mode="drop")
    y = masked_conv_same(imp, kernel, klen)
    return jnp.where(i < n, y, 0.0)


def gen_stick_slip(i, n, seed, threshold, build, decay, noise_amt):
    """Stateful stick-slip friction loop (main_v2.py:283-301) as lax.scan."""
    L = i.shape[0]
    b_noise = noise.normal(seed, i, STREAM_BUILD)
    o_noise = noise.normal(seed, i, STREAM_OUT)

    def step(carry, inp):
        sticking, force = carry
        bn, on = inp
        force_stick = force + build * (bn * noise_amt + jnp.float32(0.2))
        new_sticking_s = jnp.abs(force_stick) <= threshold
        out_slip = force + jnp.float32(0.25) * on
        force_slip = force * decay
        back_to_stick = jnp.abs(force_slip) < jnp.float32(0.02)
        force_slip = jnp.where(back_to_stick, 0.0, force_slip)
        out = jnp.where(sticking, 0.0, out_slip)
        new_force = jnp.where(sticking, force_stick, force_slip)
        new_sticking = jnp.where(sticking, new_sticking_s, back_to_stick)
        return (new_sticking, new_force), out

    (_, _), xs = jax.lax.scan(step, (jnp.bool_(True), jnp.float32(0.0)),
                              (b_noise, o_noise))
    x = xs * hann_t(i, n)
    return jnp.where(i < n, x, 0.0)


def gen_micro_chaos(i, n, seed, r, gate, chaos_kernel):
    """Gated logistic map (main_v2.py:303-315) as lax.scan + exp smear.

    y0 uses a reciprocal MULTIPLY, not a division: XLA's vectorized f32
    divide rounds differently under jit than eager/NumPy IEEE division, and
    a 1-ulp difference in a chaotic map's seed diverges exponentially."""
    y0 = (seed % 10000).astype(jnp.float32) * jnp.float32(1.0 / 10000.0)
    gates = noise.uniform(seed, i, STREAM_GATE)

    def step(y, u):
        y2 = r * y * (jnp.float32(1.0) - y)
        v = y2 - jnp.float32(0.5)
        out = jnp.where(u < gate, v, 0.0)
        return y2, out

    _, xs = jax.lax.scan(step, y0, gates)
    xs = jnp.where(i < n, xs, 0.0)   # reference buffer ends at n (:305)
    x = masked_conv_same(xs, chaos_kernel, chaos_kernel.shape[0])
    x = x * hann_t(i, n)
    return jnp.where(i < n, x, 0.0)


def morlet_atom_t(i, n, inv_gen_sr, f0, sigma_s, phase_cyc):
    """Morlet atom over padded indices (main_v2.py:165-170), cycles domain."""
    t = (i.astype(jnp.float32) - n.astype(jnp.float32) / 2.0) \
        * jnp.asarray(inv_gen_sr, jnp.float32)
    envl = jnp.exp(-0.5 * (t / jnp.maximum(1e-9, sigma_s)) ** 2)
    carrier = detmath.cos_cycles(f0 * t + phase_cyc)
    return envl * carrier


def gen_wavelet_atoms(i, n, inv_gen_sr, f0s, sigma_ss, phase_cycs, shifts,
                      count):
    """Random Morlet cloud (main_v2.py:317-331); per-atom params host-drawn."""
    L = i.shape[0]
    x = jnp.zeros(L, jnp.float32)
    Amax = f0s.shape[0]
    for k in range(Amax):
        atom = morlet_atom_t(i, n, inv_gen_sr, f0s[k], sigma_ss[k],
                             phase_cycs[k])
        # np.roll(atom, shift)[:n]: gather at (i - shift) mod n  — the
        # reference rolls the length-n atom buffer
        src = jnp.mod(i - shifts[k], jnp.maximum(1, n))
        atom_r = morlet_atom_t(src, n, inv_gen_sr, f0s[k], sigma_ss[k],
                               phase_cycs[k])
        gain = jnp.float32(1.0) / (1.0 + k * jnp.float32(0.6))
        x = x + jnp.where(k < count, gain * atom_r, 0.0)
    x = x * hann_t(i, n)
    return jnp.where(i < n, x, 0.0)


def gen_from_fragment(i, n, frag, frag_len):
    """Shared tail of IR-fragment / image-scanline modes: linear interp of a
    host-provided fragment (true length frag_len inside a padded buffer) to
    length n (main_v2.py:333-362).  Normalization / smearing differ per mode
    and are applied by the caller."""
    S = frag.shape[0]
    # np.interp(linspace(0,1,n), linspace(0,1,frag_len), frag)
    pos = i.astype(jnp.float32) / jnp.maximum(1, n - 1).astype(jnp.float32) \
        * jnp.maximum(1, frag_len - 1).astype(jnp.float32)
    i0 = jnp.clip(pos.astype(jnp.int32), 0, S - 2)
    i0 = jnp.minimum(i0, jnp.maximum(0, frag_len - 2))
    fr = pos - i0.astype(jnp.float32)
    x = frag[i0] * (1.0 - fr) + frag[i0 + 1] * fr
    return jnp.where(i < n, x, 0.0)


# ----------------------------------------------------------------------------
# Physical models (main_v2.py:369-402)
# ----------------------------------------------------------------------------

def resonator_bank(x, i, n, inv_gen_sr, freqs, phase_cycs, decay_ms, modes):
    """24-mode resonator (main_v2.py:369-384). freqs/phases host-drawn
    (log-spaced ±2% detune). Note the reference's output mixes through
    sign(x) — a discontinuous gate documented in the oracle."""
    t = i.astype(jnp.float32) * jnp.asarray(inv_gen_sr, jnp.float32)
    tau = jnp.maximum(1e-6, jnp.asarray(decay_ms, jnp.float32) / 1000.0)
    envl = jnp.exp(-t / tau)
    out = jnp.zeros_like(x)
    Mmax = freqs.shape[0]
    for k in range(Mmax):
        carrier = detmath.sin_cycles(freqs[k] * t + phase_cycs[k])
        gain = jnp.float32(1.0) / (1.0 + k * jnp.float32(0.35))
        out = out + jnp.where(k < modes, gain * carrier * envl, 0.0)
    peak = jnp.maximum(1e-12, jnp.max(jnp.abs(jnp.where(i < n, out, 0.0))))
    out = out / peak
    y = jnp.float32(0.55) * x + jnp.float32(0.45) * out * jnp.sign(x)
    return jnp.where(i < n, y, 0.0)


def waveguide_splinters(x, n, delays, gains, mixes, lines: int, dmax: int):
    """N feedback delay lines, per-sample circular buffers
    (main_v2.py:386-402) — lax.scan per line over the grain."""
    y = x
    for l in range(lines):
        d = delays[l]
        g = gains[l]
        mix = mixes[l]

        def step(carry, yt):
            buf, wp = carry
            v = yt + g * buf[wp]
            buf = buf.at[wp].set(v)
            wp = jnp.where(wp + 1 >= d, 0, wp + 1)
            out = (jnp.float32(1.0) - mix) * yt + mix * v
            return (buf, wp), out

        (_, _), y = jax.lax.scan(
            step, (jnp.zeros(dmax, jnp.float32), jnp.int32(0)), y)
    return jnp.where(jnp.arange(x.shape[0]) < n, y, 0.0)
