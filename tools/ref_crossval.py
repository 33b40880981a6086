"""Cross-validation against the LITERAL reference implementation.

Every parity number in tests/ is engine-vs-repo-oracle; the oracles adopt
documented framework conventions (padded-length grain FFTs, int32 fixed-point
positions, spectrum-drawn tilt noise, 12-bit-significand LFO factors,
counter-based noise).  This harness closes the loop: it loads the actual
reference code from /root/reference — importing the Qt-free modules directly
and extracting the Qt-entangled functions by AST source-slice exec — and
measures the framework against it, driving both sides with IDENTICAL random
draws wherever the reference draws randomness (SURVEY.md §7 "hard parts":
kernels accept injected noise / the reference rng is shimmed to replay the
framework's counter-noise realization).

Conventions quantified here (each measured; docs/CROSSVAL.md):
- padded-length grain FFTs  vs exact-length rfft (main_v2.py:39-163)
- spectrum-drawn tilt noise vs time-domain noise + forward FFT (:224-233)
- int32 fixed-point tape/scrub positions vs float positions (Tape…py:824-893)
- 12-bit-significand wow/flutter factors vs f64 math.sin accumulation
- polynomial cycle-domain sin (ops/detmath.py) vs np.sin

Run:  python tools/ref_crossval.py           (current default JAX device)
      JAX_PLATFORMS=cpu python tools/ref_crossval.py
"""
from __future__ import annotations

import ast
import dataclasses
import math
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from audio_suite_tpu.utils.metrics import max_dev_dbfs  # noqa: E402

REF = "/root/reference"

# ----------------------------------------------------------------------------
# Reference loaders: import Qt-free modules directly; AST-slice the rest
# ----------------------------------------------------------------------------

_SAFE_IMPORTS = {"sys", "os", "json", "math", "bisect", "threading",
                 "importlib", "importlib.util", "inspect", "traceback",
                 "dataclasses", "typing", "numpy", "pathlib"}


class _StubMeta(type):
    def __getattr__(cls, k):
        return _stub_class(k)


def _stub_class(name="Stub"):
    return _StubMeta(name, (), {
        "__init__": lambda self, *a, **k: None,
        "__getattr__": lambda self, k: _stub_class(k)(),
        "__call__": lambda self, *a, **k: _stub_class("call")(),
    })


class _StubModule(types.ModuleType):
    def __getattr__(self, k):
        return _stub_class(k)


def _keep_import(node) -> bool:
    if isinstance(node, ast.Import):
        return all(a.name.split(".")[0] in _SAFE_IMPORTS for a in node.names)
    if isinstance(node, ast.ImportFrom):
        return (node.module or "").split(".")[0] in _SAFE_IMPORTS
    return False


def _exec_slice(path: str, keep_classes=(), np_proxy=None) -> dict:
    """Exec a reference module's top-level functions + assignments (+ selected
    classes) into a namespace with Qt/soundfile/sounddevice stubbed out.
    `np_proxy` replaces the namespace's `np` (for rng interception)."""
    with open(path) as f:
        src = f.read()
    tree = ast.parse(src)
    kept = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            if _keep_import(node):
                kept.append(node)
        elif isinstance(node, ast.ClassDef):
            if node.name in keep_classes:
                kept.append(node)
        elif isinstance(node, (ast.If,)):
            continue  # skip __main__ guard
        elif isinstance(node, ast.Expr):
            continue  # docstrings / calls
        else:
            kept.append(node)  # FunctionDef, Assign, AnnAssign
    mod = ast.Module(body=kept, type_ignores=[])
    code = compile(mod, path, "exec")
    qt = _StubModule("qt_stub")
    ns = {
        "QtCore": qt, "QtWidgets": qt, "QtGui": qt, "QIODevice": object,
        "QAudioFormat": _stub_class(), "QAudioSink": _stub_class(),
        "QAudioSource": _stub_class(), "QMediaDevices": _stub_class(),
        "pg": qt, "sf": qt, "sd": qt,
        "QAction": _stub_class(), "QApplication": _stub_class(),
        "QMainWindow": object, "QMessageBox": _stub_class(),
        "Qt": _stub_class(),
        # grid_audio_app.py uses math.ceil without importing math (the
        # documented reference bug, SURVEY.md §7) — provide it, matching
        # the framework's fix
        "math": math,
    }
    exec(code, ns)
    if np_proxy is not None:
        ns["np"] = np_proxy
    return ns


class _NpProxy(types.ModuleType):
    """numpy passthrough with a replaceable `.random` (shim legacy np.random
    and np.random.default_rng as the reference code sees them)."""

    def __init__(self, random_obj):
        super().__init__("numpy_proxy")
        self._random = random_obj

    def __getattr__(self, k):
        if k == "random":
            return self._random
        return getattr(np, k)


class ShimGen:
    """Wraps np.random.default_rng(seed); overrides selected draw methods.

    override(method_name) = fn(real_gen, call_index, *args, **kwargs).
    """

    def __init__(self, seed, **overrides):
        self._g = np.random.default_rng(seed)
        self._ov = overrides
        self._counts: dict = {}

    def __getattr__(self, k):
        if k.startswith("_"):
            raise AttributeError(k)
        if k in self._ov:
            ov = self._ov[k]

            def call(*a, **kw):
                c = self._counts.get(k, 0)
                self._counts[k] = c + 1
                return ov(self._g, c, *a, **kw)
            return call
        return getattr(self._g, k)


def load_ref_microsound(np_proxy=None) -> dict:
    return _exec_slice(os.path.join(REF, "microsound_0.2.1", "main_v2.py"),
                       keep_classes=("SpectralImprint",), np_proxy=np_proxy)


def load_ref_tape() -> dict:
    return _exec_slice(
        os.path.join(REF, "tape-tuc-main",
                     "Tape_TUC_23-11-25_auto-slice_n_record.py"),
        keep_classes=("TapeLooper",))


def load_ref_scrub(np_proxy=None) -> dict:
    return _exec_slice(os.path.join(REF, "scrubber", "scrubber_0.7.py"),
                       np_proxy=np_proxy)


def load_ref_grid() -> tuple:
    """Returns (namespace, RefGrid) where RefGrid carries the MainWindow
    render methods rebound onto a plain object (tracks/master/sr attrs)."""
    path = os.path.join(REF, "grid_audio_app_0.2", "grid_audio_app.py")
    ns = _exec_slice(path, keep_classes=("CellSource", "Track",
                                         "MasterClock", "LoadedModule"))
    with open(path) as f:
        tree = ast.parse(f.read())
    methods = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "MainWindow":
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and item.name in (
                        "_collect_restart_events", "render_mixdown",
                        "_render_track_pattern", "_render_track_to_master",
                        "render_cell_audio"):
                    methods.append(item)
    cls = ast.ClassDef(name="RefGrid", bases=[], keywords=[],
                       body=methods, decorator_list=[])
    mod = ast.Module(body=[cls], type_ignores=[])
    ast.fix_missing_locations(mod)
    exec(compile(mod, path + ":MainWindow", "exec"), ns)
    return ns, ns["RefGrid"]


def load_ref_patternlab():
    """Import the reference pattern-lab `app` package directly (Qt-free)."""
    import importlib
    name = "ref_pl"
    if name not in sys.modules:
        pkg_dir = os.path.join(REF, "pattern lab 0.1")
        pkg = types.ModuleType(name)
        pkg.__path__ = [pkg_dir]
        sys.modules[name] = pkg
    app = importlib.import_module(name + ".app")
    return app


def load_ref_forestfire():
    import importlib
    name = "ref_ff"
    if name not in sys.modules:
        pkg = types.ModuleType(name)
        pkg.__path__ = [os.path.join(REF, "forest_fire_OSC_0.1")]
        sys.modules[name] = pkg
    model = importlib.import_module(name + ".model")
    watchers = importlib.import_module(name + ".watchers")
    return model, watchers


# ----------------------------------------------------------------------------
# Result rows
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class Row:
    name: str
    dev_dbfs: float
    bound: float            # documented acceptance bound for this row
    note: str = ""

    @property
    def ok(self) -> bool:
        return self.dev_dbfs <= self.bound


def _row(name, a, b, bound=-60.0, note=""):
    return Row(name, max_dev_dbfs(a, b), bound, note)


# ----------------------------------------------------------------------------
# Microsound: kernel tier (deterministic + injected-draw kernels)
# ----------------------------------------------------------------------------

def crossval_microsound_kernels() -> list[Row]:
    from audio_suite_tpu.ops import spectral, space, envelopes, generators
    from audio_suite_tpu.ops import noise
    from audio_suite_tpu.ops.generators import (STREAM_MAIN, STREAM_EXC,
                                                STREAM_TILT_IM, STREAM_BUILD,
                                                STREAM_OUT, STREAM_GATE)
    import jax.numpy as jnp
    ref = load_ref_microsound()
    rows: list[Row] = []
    rng = np.random.default_rng(42)
    sr = 48000

    # a deterministic broadband test grain (same input both sides)
    n = 2048
    x = (rng.standard_normal(n) * np.hanning(n)).astype(np.float64)
    x32 = x.astype(np.float32)

    # --- FFT filters / warps at MATCHED length (pow2: padded == exact) ---
    rows.append(_row("lowpass_fft (pow2 len)",
                     np.asarray(spectral.lowpass_fft(jnp.asarray(x32), sr,
                                                     6000.0, 1500.0)),
                     ref["lowpass_fft"](x, sr, 6000.0, 1500.0)))
    rows.append(_row("bandpass_fft (pow2 len)",
                     np.asarray(spectral.bandpass_fft(jnp.asarray(x32), sr,
                                                      800.0, 9000.0, 700.0)),
                     ref["bandpass_fft"](x, sr, 800.0, 9000.0, 700.0)))
    rows.append(_row("fft_warp_power",
                     np.asarray(spectral.fft_warp_power(jnp.asarray(x32),
                                                        1.3)),
                     ref["fft_warp_power"](x, 1.3)))
    rows.append(_row("fft_partial_stretch",
                     np.asarray(spectral.fft_partial_stretch(
                         jnp.asarray(x32), 1.7)),
                     ref["fft_partial_stretch"](x, 1.7)))
    rows.append(_row("partial_lock_stretch",
                     np.asarray(spectral.partial_lock_stretch(
                         jnp.asarray(x32), 1.5, 24, 4)),
                     ref["partial_lock_stretch"](x, 1.5, 24, 4)))
    rows.append(_row("cepstral_warp",
                     np.asarray(spectral.cepstral_warp(jnp.asarray(x32),
                                                       1.2)),
                     ref["cepstral_warp"](x, 1.2), bound=-55.0,
                     note="log/exp of near-zero mags amplifies f32 "
                          "rounding; bound documented"))

    # --- the padded-length convention, quantified (n=1500 -> L=2048) ---
    ntr = 1500
    xt = x[:ntr]
    xp = np.zeros(n, np.float32)
    xp[:ntr] = xt
    lp_pad = np.asarray(spectral.lowpass_fft(jnp.asarray(xp), sr,
                                             6000.0, 1500.0))[:ntr]
    rows.append(_row("lowpass padded-L convention", lp_pad,
                     ref["lowpass_fft"](xt, sr, 6000.0, 1500.0),
                     bound=-18.0,
                     note="measured convention delta on broadband noise: "
                          "same filter spec on the zero-padded grain "
                          "(finer bin grid + linear-convolution tails) vs "
                          "the reference's n-point circular form; "
                          "documented framework semantics; exact when the grain "
                          "length lands on the pow2 bucket (rows above)"))
    # the stretch convention changes the bin grid -> the padded output is a
    # different REALIZATION of the same spectral map; the semantic check is
    # that partials land at the same frequencies
    f0 = 3000.0
    tt = np.arange(ntr) / sr
    sine = (np.sin(2 * np.pi * f0 * tt) * np.hanning(ntr))
    sp = np.zeros(n, np.float32)
    sp[:ntr] = sine
    st_pad = np.asarray(spectral.fft_partial_stretch(jnp.asarray(sp),
                                                     1.7))[:ntr]
    st_ref = ref["fft_partial_stretch"](sine, 1.7)

    def peak_hz(y):
        Y = np.abs(np.fft.rfft(y * np.hanning(len(y)), n=1 << 16))
        k = int(np.argmax(Y))
        # parabolic interpolation around the peak
        a, b, c = Y[k - 1], Y[k], Y[k + 1]
        dk = 0.5 * (a - c) / (a - 2 * b + c)
        return (k + dk) * sr / (1 << 16)
    df = abs(peak_hz(st_pad) - peak_hz(st_ref))
    rows.append(Row("stretch padded-L: partial remap frequency",
                    20 * np.log10(max(1e-12, df / f0)), -35.0,
                    f"stretched partial lands within {df:.1f} Hz of the "
                    f"reference's (both ~{peak_hz(st_ref):.0f} Hz); the "
                    f"sample realizations differ by design (bin grids), "
                    f"measured "
                    f"{max_dev_dbfs(st_pad, st_ref):.1f} dBFS — documented "
                    f"framework semantics"))

    # --- atoms / envelopes / display ---
    i = np.arange(n, dtype=np.int32)
    m_ref = ref["morlet_atom"](sr, 1000.0 * n / sr, 900.0, 8.0, 0.3)
    m_fw = np.asarray(generators.morlet_atom_t(
        jnp.asarray(i), jnp.int32(len(m_ref)), np.float32(1.0 / sr),
        np.float32(900.0), np.float32(8.0 / 1000.0),
        np.float32(0.3 / (2 * np.pi))))[:len(m_ref)]
    rows.append(_row("morlet_atom", m_fw, m_ref))

    e_ref = ref["make_adsr"](sr, sr, 12.0, 80.0, 0.6, 200.0, 1.8)
    e_fw = envelopes.make_adsr(sr, sr, 12.0, 80.0, 0.6, 200.0, 1.8)
    rows.append(_row("make_adsr", np.asarray(e_fw), e_ref))

    s_ref = ref["stft_mag_db"](x, sr, 512, 128)
    s_fw = np.asarray(spectral.stft_mag_db(x32, sr, 512, 128))
    rows.append(Row("stft_mag_db", float(np.max(np.abs(s_fw - s_ref))) and
                    20 * np.log10(max(1e-300,
                                      np.max(np.abs(s_fw - s_ref)) / 96.0)),
                    -60.0, "dB-domain; normalized to 96 dB display range"))

    # --- space FX ---
    er_ref = ref["early_reflection_cloud"](x, sr, taps=120, max_ms=30.0,
                                           seed=7)
    ker = space.er_tap_kernel(120, 30.0, sr, seed=7)
    er_fw = np.asarray(space.fft_convolve_causal(jnp.asarray(x32),
                                                 jnp.asarray(ker)))
    rows.append(_row("early_reflection_cloud", er_fw, er_ref))

    ir = (np.exp(-np.linspace(0, 8, 600))
          * rng.standard_normal(600)).astype(np.float64)
    cv_ref = ref["convolve_ir_short"](x, ir)
    cv_fw = np.asarray(space.fft_convolve_causal(
        jnp.asarray(x32), jnp.asarray(ir.astype(np.float32))))
    rows.append(_row("convolve_ir_short", cv_fw, cv_ref))

    sd_ref = ref["spectral_diffusion_stereo"](x, sr, 0.6)
    sd_fw = np.asarray(space.spectral_diffusion_stereo(jnp.asarray(x32), sr,
                                                       0.6))
    rows.append(_row("spectral_diffusion_stereo (Jacobi-Anger)", sd_fw,
                     sd_ref,
                     note="framework evaluates exp(i w sin) via truncated "
                          "Jacobi-Anger tap expansion"))

    rows.append(_row("soft_clip",
                     np.asarray(space.soft_clip(jnp.asarray(x32), 1.4)),
                     ref["soft_clip"](x, 1.4)))
    rows.append(_row("normalize",
                     np.asarray(space.normalize(jnp.asarray(x32), 0.98)),
                     ref["normalize"](x, 0.98)))

    # --- unfold_multiband ---
    mb_ref = ref["unfold_multiband"](x, sr * 4, sr, [(0, 2000.0),
                                                     (2000.0, 8000.0),
                                                     (8000.0, 20000.0)],
                                     [4.0, 2.0, 1.0], roll_hz=500.0)
    mb_fw = np.asarray(spectral.multiband_unfold(
        jnp.asarray(x32), sr * 4, ((0.0, 2000.0), (2000.0, 8000.0),
                                   (8000.0, 20000.0)),
        (4.0, 2.0, 1.0), roll_hz=500.0))
    rows.append(_row("unfold_multiband", mb_fw, mb_ref))

    # --- breakpoints ---
    from audio_suite_tpu.utils import breakpoints as bp
    s = "0:1.0, 2.5:3.5, 4:0.2"
    pts_r = ref["parse_breakpoints"](s)
    pts_f = bp.parse_breakpoints(s)
    ts = np.linspace(-1, 6, 301)
    ev_r = np.asarray([ref["eval_breakpoints"](pts_r, t, 7.0) for t in ts])
    ev_f = np.asarray([bp.eval_breakpoints(pts_f, t, 7.0) for t in ts])
    rows.append(_row("breakpoint lanes", ev_f, ev_r, bound=-120.0))

    # --- event schedulers (host port, same rng stream: expect exact) ---
    from audio_suite_tpu.events.schedulers import generate_event_times
    for proc in ("Single", "Poisson", "Clustered", "Hawkes"):
        tr = ref["generate_event_times"](proc, 4.0, 25.0, 77,
                                         cluster_size=5,
                                         cluster_spread_ms=30.0,
                                         hawkes_gain=0.7,
                                         hawkes_decay_s=0.2)
        tf = generate_event_times(proc, 4.0, 25.0, 77, cluster_size=5,
                                  cluster_spread_ms=30.0, hawkes_gain=0.7,
                                  hawkes_decay_s=0.2)
        rows.append(_row(f"scheduler {proc}", np.asarray(tf), np.asarray(tr),
                         bound=-200.0, note="same host rng stream"))

    # --- SpectralImprint recurrence ---
    from audio_suite_tpu.ops.spectral import spectral_imprint_scan
    grains = rng.standard_normal((6, n)) * np.hanning(n)
    imp = ref["SpectralImprint"]()
    outs_ref = np.stack([imp.apply(g, amount=0.4, smooth=0.9)
                         for g in grains])
    mags = np.abs(np.fft.rfft(grains.astype(np.float32), axis=-1))
    mags2 = np.asarray(spectral_imprint_scan(jnp.asarray(mags,
                                                         jnp.float32),
                                             0.4, 0.9))
    X = np.fft.rfft(grains.astype(np.float32), axis=-1)
    outs_fw = np.fft.irfft(mags2 * np.exp(1j * np.angle(X)), n=n, axis=-1)
    rows.append(_row("SpectralImprint EMA", outs_fw, outs_ref))

    # --- injected-draw generators: reference consumes the framework's
    #     counter-noise realization, so only the MATH is compared ---
    ev_seed = 991
    L = 2048
    gen_sr = 64000
    micro_ms = 1000.0 * L / gen_sr       # exact n == L (pow2)
    iL = jnp.arange(L, dtype=jnp.int32)
    nL = jnp.int32(L)
    inv_sr = np.float32(1.0) / np.float32(gen_sr)

    def fw_gen_basic(mode_id, **kw):
        z = jnp.zeros(4, jnp.int32)
        return np.asarray(generators.gen_basic(
            iL, nL, jnp.uint32(ev_seed), jnp.float32(gen_sr), inv_sr,
            jnp.float32(micro_ms), mode_id,
            kw.get("dust_pos", z), kw.get("dust_amp", z.astype(jnp.float32)),
            kw.get("dust_k", jnp.int32(0)), kw.get("dust_klen", jnp.int32(8)),
            jnp.float32(kw.get("noise_tilt", -3.0)),
            jnp.float32(kw.get("ring_hz", 4200.0)),
            jnp.float32(kw.get("ring_decay_ms", 12.0)),
            dust_kmax=4))

    def normals(stream, count):
        return noise.normal_np(np.uint32(ev_seed),
                               np.arange(count, dtype=np.uint32),
                               np.uint32(stream)).astype(np.float64)

    # Gaussian click
    shim = ShimGen(ev_seed, standard_normal=lambda g, c, nn:
                   normals(STREAM_MAIN, nn))
    proxy = _NpProxy(types.SimpleNamespace(default_rng=lambda s: shim))
    ref_i = load_ref_microsound(np_proxy=proxy)
    g_ref = ref_i["gen_basic"](gen_sr, micro_ms, ev_seed, "Gaussian click",
                               0.02, -3.0, 4200.0, 12.0)
    rows.append(_row("gen Gaussian click (injected)", fw_gen_basic(0),
                     g_ref))

    # Noise burst / Skewed transient: inject time noise whose rfft equals
    # the framework's drawn spectrum (the spectrum-drawn convention is an
    # exact reparametrization at matched length)
    nf = L // 2 + 1
    wr = noise.normal_np(np.uint32(ev_seed),
                         np.arange(nf, dtype=np.uint32), 0)
    wi = noise.normal_np(np.uint32(ev_seed),
                         np.arange(nf, dtype=np.uint32),
                         np.uint32(STREAM_TILT_IM))
    W = (wr.astype(np.float64) + 1j * wi.astype(np.float64)) \
        * np.sqrt(0.5 * L)
    w_time = np.fft.irfft(W, n=L)

    for mode_name, mode_id in (("Noise burst", 2), ("Skewed transient", 3)):
        shim = ShimGen(ev_seed, standard_normal=lambda g, c, nn:
                       w_time.copy())
        proxy = _NpProxy(types.SimpleNamespace(default_rng=lambda s: shim))
        ref_i = load_ref_microsound(np_proxy=proxy)
        g_ref = ref_i["gen_basic"](gen_sr, micro_ms, ev_seed, mode_name,
                                   0.02, -4.5, 4200.0, 12.0)
        rows.append(_row(f"gen {mode_name} (spectrum-drawn == "
                         f"time-drawn + FFT)",
                         fw_gen_basic(mode_id, noise_tilt=-4.5), g_ref))

    # Resonant strike
    shim = ShimGen(ev_seed, standard_normal=lambda g, c, nn:
                   normals(STREAM_EXC, nn))
    proxy = _NpProxy(types.SimpleNamespace(default_rng=lambda s: shim))
    ref_i = load_ref_microsound(np_proxy=proxy)
    g_ref = ref_i["gen_basic"](gen_sr, micro_ms, ev_seed, "Resonant strike",
                               0.02, -3.0, 3100.0, 9.0)
    rows.append(_row("gen Resonant strike (injected)",
                     fw_gen_basic(4, ring_hz=3100.0, ring_decay_ms=9.0),
                     g_ref,
                     note="includes detmath polynomial sin vs np.sin"))

    # Stick-slip: branch-replay shim assigns the reference's scalar draws
    # from the framework's two parallel streams
    b_draws = normals(STREAM_BUILD, L)
    o_draws = normals(STREAM_OUT, L)
    ss = dict(threshold=0.9, build=0.06, decay=0.75, noise=0.08)

    class _SSState:
        def __init__(self):
            self.i = 0
            self.sticking = True
            self.force = 0.0

        def draw(self, g, c):
            v = b_draws[self.i] if self.sticking else o_draws[self.i]
            # replicate the reference recurrence (f64) to track the branch
            if self.sticking:
                self.force += ss["build"] * (v * ss["noise"] + 0.2)
                if abs(self.force) > ss["threshold"]:
                    self.sticking = False
            else:
                self.force *= ss["decay"]
                if abs(self.force) < 0.02:
                    self.sticking = True
                    self.force = 0.0
            self.i += 1
            return v

    st = _SSState()
    shim = ShimGen(ev_seed, standard_normal=lambda g, c: st.draw(g, c))
    proxy = _NpProxy(types.SimpleNamespace(default_rng=lambda s: shim))
    ref_i = load_ref_microsound(np_proxy=proxy)
    g_ref = ref_i["gen_stick_slip"](gen_sr, micro_ms, ev_seed, **ss)
    g_fw = np.asarray(generators.gen_stick_slip(
        iL, nL, jnp.uint32(ev_seed), jnp.float32(0.9), jnp.float32(0.06),
        jnp.float32(0.75), jnp.float32(0.08)))
    rows.append(_row("gen stick-slip (injected, branch replay)", g_fw,
                     g_ref))

    # Micro-chaos: same injected gates; the logistic map is chaotic, so
    # f32-vs-f64 divergence is EXPECTED — measure the agreement prefix
    gates = noise.uniform_np(np.uint32(ev_seed),
                             np.arange(L, dtype=np.uint32),
                             np.uint32(STREAM_GATE)).astype(np.float64)
    shim = ShimGen(ev_seed, random=lambda g, c: gates[c])
    proxy = _NpProxy(types.SimpleNamespace(default_rng=lambda s: shim))
    ref_i = load_ref_microsound(np_proxy=proxy)
    g_ref = ref_i["gen_micro_chaos"](gen_sr, micro_ms, ev_seed, 3.92, 0.35)
    kern = jnp.asarray(np.exp(-np.linspace(0, 5, 48)).astype(np.float32))
    g_fw = np.asarray(generators.gen_micro_chaos(
        iL, nL, jnp.uint32(ev_seed), jnp.float32(3.92), jnp.float32(0.35),
        kern))
    d = np.abs(g_fw - g_ref)
    prefix = int(np.argmax(d > 1e-3)) if np.any(d > 1e-3) else L
    # single-grain RMS of a chaotic signal is itself noisy (+-1.3 dB at
    # L=2048); the distributional check averages energy over seeds
    e_fw, e_ref = 0.0, 0.0
    for sd in range(ev_seed, ev_seed + 16):
        gates_s = noise.uniform_np(np.uint32(sd),
                                   np.arange(L, dtype=np.uint32),
                                   np.uint32(STREAM_GATE)) \
            .astype(np.float64)
        shim_s = ShimGen(sd, random=lambda g, c, _gs=gates_s: _gs[c])
        proxy_s = _NpProxy(types.SimpleNamespace(
            default_rng=lambda s, _sh=shim_s: _sh))
        ref_s = load_ref_microsound(np_proxy=proxy_s)
        gr = ref_s["gen_micro_chaos"](gen_sr, micro_ms, sd, 3.92, 0.35)
        gf = np.asarray(generators.gen_micro_chaos(
            iL, nL, jnp.uint32(sd), jnp.float32(3.92), jnp.float32(0.35),
            kern))
        e_fw += float(np.mean(gf ** 2))
        e_ref += float(np.mean(gr ** 2))
    rms_ratio_db = 10 * np.log10(max(1e-12, e_fw / max(1e-12, e_ref)))
    chaos_ok = prefix >= 16 and abs(rms_ratio_db) < 0.5
    rows.append(Row("gen micro-chaos (chaotic map)",
                    -float(prefix) if chaos_ok else 0.0, -16.0,
                    f"the logistic map is chaotic: ANY precision "
                    f"difference diverges exponentially, so sample parity "
                    f"vs the f64 reference is impossible by construction "
                    f"(framework parity is defined vs the f32 twin). "
                    f"Measured: identical gate draws, {prefix}-sample "
                    f"agreement prefix (f32 eps * e^(lambda k) reaches "
                    f"1e-3 at k~25), 16-seed mean energy ratio "
                    f"{rms_ratio_db:+.2f} dB"))

    # Resonator bank / waveguide: host draws already use the reference's
    # rng(seed+321 / +777) streams — compare directly
    res_rng = np.random.default_rng(ev_seed + 321)
    fs, ps = [], []
    modes = 12
    for k in range(modes):
        f = 120.0 * ((12000.0 / 120.0) ** (k / (modes - 1)))
        f *= 2.0 ** res_rng.uniform(-0.02, 0.02)
        fs.append(f)
        ps.append(res_rng.uniform(0, 2 * np.pi) / (2 * np.pi))
    r_ref = ref["resonator_bank"](x, gen_sr, modes=modes, f_min=120.0,
                                  f_max=12000.0, decay_ms=60.0, seed=ev_seed)
    r_fw = np.asarray(generators.resonator_bank(
        jnp.asarray(x32), iL, nL, inv_sr,
        jnp.asarray(fs, jnp.float32), jnp.asarray(ps, jnp.float32),
        jnp.float32(60.0), jnp.int32(modes)))
    rows.append(_row("resonator_bank (same host draws)", r_fw, r_ref,
                     bound=-55.0,
                     note="sign(x)-gated mix amplifies 1-ulp sin "
                          "differences at zero crossings"))

    wrng = np.random.default_rng(ev_seed + 777)
    lines = 4
    ds_, gs_, ms_ = [], [], []
    for _ in range(lines):
        ds_.append(int(max(1, round((wrng.uniform(0.4, 6.0) / 1000.0)
                                    * gen_sr))))
        gs_.append(0.6 * wrng.uniform(0.6, 0.98))
        ms_.append(wrng.uniform(0.15, 0.45))
    wg_ref = ref["waveguide_splinters"](x, gen_sr, lines=lines, max_ms=6.0,
                                        feedback=0.6, seed=ev_seed)
    wg_fw = np.asarray(generators.waveguide_splinters(
        jnp.asarray(x32), nL, jnp.asarray(ds_, jnp.int32),
        jnp.asarray(gs_, jnp.float32), jnp.asarray(ms_, jnp.float32),
        lines, max(ds_) + 1))
    rows.append(_row("waveguide_splinters (same host draws)", wg_fw, wg_ref))

    return rows


# ----------------------------------------------------------------------------
# Microsound: end-to-end render vs the literal reference render()
# ----------------------------------------------------------------------------

def _ms_params(mode: str, **over):
    from audio_suite_tpu.models import microsound as ms
    base = dict(
        base_sr=32000, out_dur_s=0.5, time_unfold=2.0,
        micro_ms=1000.0 * 2048 / 64000.0,   # n == L == 2048 (pow2)
        seed=500, grains_per_sec=30.0, max_grains=48, gen_mode=mode,
        event_process="Poisson",
        bandlimit_on=True, bandlimit_out_hz=9000.0,
        bandlimit_roll_hz=2000.0, partial_stretch=1.0,
        er_cloud_on=True, er_taps=96, er_max_ms=25.0,
        stereo_on=True, stereo_width=0.6, grain_offset_on=True,
        grain_offset_max_ms=20.0, grain_amp_rand=0.3,
        bp_density="", bp_unfold="", bp_cutoff="", bp_stretch="")
    base.update(over)
    return ms.MicrosoundParams.from_dict(base)


def _ref_params_dict(p, ir_audio=None, img_gray=None) -> dict:
    d = dataclasses.asdict(p)
    d["_ir_audio"] = ir_audio
    d["_img_gray"] = img_gray
    return d


def _ms_shim_factory(p, mode: str):
    """np.random.default_rng replacement for the reference render():
    real rngs for the host-side streams the framework already mirrors
    bit-exactly; per-event injection shims for the counter-noise draws."""
    from audio_suite_tpu.ops import noise
    from audio_suite_tpu.ops.generators import (STREAM_MAIN, STREAM_EXC,
                                                STREAM_TILT_IM, STREAM_GATE,
                                                STREAM_BUILD, STREAM_OUT)
    from audio_suite_tpu.models.microsound import build_program
    S = int(p.seed)
    prog = build_program(p)
    E0 = int(p.max_grains)
    event_seeds = set(range(S, S + max(E0, 256)))
    L = int(prog.get("L", 2048))
    # exact-length semantics (round 5): with a uniform true grain length
    # the engine draws the tilt-noise spectrum on the n-grid (the rfft of
    # n white samples) — the shim must hand the reference that same white
    # noise, i.e. irfft of the drawn spectrum AT n.  Mixed-length programs
    # keep the padded-L grid (the engine's documented fallback).
    ns_arr = prog.get("n")
    n_tilt = L
    if ns_arr is not None and len(ns_arr) > 0 and \
            bool(np.all(ns_arr == ns_arr[0])):
        n_tilt = int(ns_arr[0])

    def normals(ev_seed, stream, count):
        return noise.normal_np(np.uint32(ev_seed),
                               np.arange(count, dtype=np.uint32),
                               np.uint32(stream)).astype(np.float64)

    def factory(seed_int):
        seed_int = int(seed_int)
        if seed_int not in event_seeds:
            return np.random.default_rng(seed_int)
        ev = seed_int
        if mode == "Gaussian click":
            return ShimGen(ev, standard_normal=lambda g, c, nn:
                           normals(ev, STREAM_MAIN, nn))
        if mode in ("Noise burst", "Skewed transient"):
            def timenoise(g, c, nn):
                base = n_tilt if nn <= n_tilt else nn
                nf = base // 2 + 1
                wr = normals(ev, STREAM_MAIN, nf)
                wi = normals(ev, STREAM_TILT_IM, nf)
                W = (wr + 1j * wi) * np.sqrt(0.5 * base)
                return np.fft.irfft(W, n=base)[:nn]
            return ShimGen(ev, standard_normal=timenoise)
        if mode == "Resonant strike":
            return ShimGen(ev, standard_normal=lambda g, c, nn:
                           normals(ev, STREAM_EXC, nn))
        if mode == "Stick–slip friction":
            b = normals(ev, STREAM_BUILD, L)
            o = normals(ev, STREAM_OUT, L)
            st = {"i": 0, "sticking": True, "force": 0.0}

            def draw(g, c):
                v = b[st["i"]] if st["sticking"] else o[st["i"]]
                if st["sticking"]:
                    st["force"] += float(p.ss_build) * (v * float(p.ss_noise)
                                                        + 0.2)
                    if abs(st["force"]) > float(p.ss_threshold):
                        st["sticking"] = False
                else:
                    st["force"] *= float(p.ss_decay)
                    if abs(st["force"]) < 0.02:
                        st["sticking"] = True
                        st["force"] = 0.0
                st["i"] += 1
                return v
            return ShimGen(ev, standard_normal=draw)
        if mode == "Micro-chaos":
            gates = noise.uniform_np(np.uint32(ev),
                                     np.arange(L, dtype=np.uint32),
                                     np.uint32(STREAM_GATE)) \
                .astype(np.float64)
            return ShimGen(ev, random=lambda g, c: gates[c])
        # Dust / Crackle / Wavelet / IR fragment / Image scanline: the
        # framework host-draws these with the reference's own rng streams
        return np.random.default_rng(seed_int)

    return factory


def crossval_microsound_e2e(modes=None) -> list[Row]:
    from audio_suite_tpu.models import microsound as ms
    rows: list[Row] = []
    modes = modes or ["Gaussian click", "Dust impulses", "Noise burst",
                      "Skewed transient", "Resonant strike",
                      "Crackle / corona", "Stick–slip friction",
                      "Wavelet atoms", "IR fragment"]
    rng = np.random.default_rng(3)
    ir = (np.exp(-np.linspace(0, 7, 1200))
          * rng.standard_normal(1200)).astype(np.float64)

    for mode in modes:
        over = {}
        if mode == "Micro-chaos":
            continue  # chaotic map: covered at kernel tier (prefix row)
        p = _ms_params(mode, **over)
        ir_in = ir if mode == "IR fragment" else None
        factory = _ms_shim_factory(p, mode)
        proxy = _NpProxy(types.SimpleNamespace(default_rng=factory))
        ref = load_ref_microsound(np_proxy=proxy)
        ref_out, _ = ref["render"](_ref_params_dict(p, ir_audio=ir_in))
        fw_out, _ = ms.render(p, ir_audio=ir_in)
        bound = -60.0
        note = ""
        if mode == "Stick–slip friction":
            bound = -40.0
            note = ("f32 scan recurrence vs f64 reference loop: branch "
                    "flips near the stick threshold are possible; "
                    "measured")
        rows.append(_row(f"microsound e2e [{mode}]", np.asarray(fw_out),
                         ref_out, bound=bound, note=note))

    # feedback + imprint + warps on (the sequential recurrences), dust mode
    p = _ms_params("Dust impulses", event_feedback_on=True,
                   event_feedback_amt=0.45, spectral_imprint_on=True,
                   spectral_imprint_amt=0.4, spectral_imprint_smooth=0.9,
                   nl_warp_on=True, nl_warp_power=1.3,
                   partial_stretch=1.0)
    factory = _ms_shim_factory(p, "Dust impulses")
    proxy = _NpProxy(types.SimpleNamespace(default_rng=factory))
    ref = load_ref_microsound(np_proxy=proxy)
    ref_out, _ = ref["render"](_ref_params_dict(p))
    from audio_suite_tpu.models import microsound as ms2
    fw_out, _ = ms2.render(p)
    rows.append(_row("microsound e2e [feedback+imprint+warp]",
                     np.asarray(fw_out), ref_out))

    # multiband unfold + resonator + waveguide.  Carrier is Noise burst:
    # the resonator's sign(x) gate (main_v2.py:384) is discontinuous at
    # x == 0, and a Gaussian click's tail underflows to exactly 0 in f32
    # while the f64 reference keeps denormals — sign() then disagrees over
    # the whole flat tail and the mix decorrelates (measured +2.9 dBFS).
    # A noise carrier has no flat region, so only the discontinuity's
    # genuine zero-crossing sensitivity remains.
    p = _ms_params("Noise burst", unfold_mode="Multiband",
                   mb_b1=2000.0, mb_b2=6000.0, mb_b3=12000.0,
                   mb_u1=2.0, mb_u2=2.0, mb_u3=2.0, mb_roll=500.0,
                   res_bank_on=True, res_modes=12, res_fmin=150.0,
                   res_fmax=9000.0, res_decay_ms=40.0,
                   wg_on=True, wg_lines=3, wg_max_ms=4.0, wg_fb=0.55)
    factory = _ms_shim_factory(p, "Noise burst")
    proxy = _NpProxy(types.SimpleNamespace(default_rng=factory))
    ref = load_ref_microsound(np_proxy=proxy)
    ref_out, _ = ref["render"](_ref_params_dict(p))
    fw_out, _ = ms2.render(p)
    rows.append(_row("microsound e2e [multiband+res+waveguide]",
                     np.asarray(fw_out), ref_out, bound=-55.0,
                     note="resonator sign(x) gate; measured"))

    return rows


def _ms_e2e_row(name, p, ir_in=None, bound=-60.0, note="") -> Row:
    """One framework-vs-literal-reference render comparison with the
    counter-noise injection shim."""
    from audio_suite_tpu.models import microsound as ms
    factory = _ms_shim_factory(p, p.gen_mode)
    proxy = _NpProxy(types.SimpleNamespace(default_rng=factory))
    ref = load_ref_microsound(np_proxy=proxy)
    ref_out, _ = ref["render"](_ref_params_dict(p, ir_audio=ir_in))
    fw_out, _ = ms.render(p, ir_audio=ir_in)
    return _row(name, np.asarray(fw_out), ref_out, bound=bound, note=note)


#: reference presets driven at their OWN micro_ms (non-pow2 grain lengths)
#: — gen_mode-diverse, no bp_unfold (uniform n); (file, bound, note)
_EXACT_PRESETS = [
    ("basinski_melodic_loop.json", -60.0, ""),      # Gaussian click+imprint
    ("closed_curve_air.json", -25.0,
     "cep-warp phase of filter-zeroed bins; chaotic in the reference "
     "(f64 roundtrip noise angles) — mag envelope matches to 3e-4; "
     "measured"),                                    # Noise burst + cep
    ("friction_lattice.json", -40.0,
     "stick-slip f32 branch flips; measured"),      # Stick-slip + waveguide
    ("micro_carillon.json", -60.0, ""),             # Wavelet atoms
    ("melodic_dust_chime.json", -60.0, ""),         # Crackle / corona
    ("room_as_particle.json", -60.0, ""),           # IR fragment + imprint
    ("infra_tone_lattice.json", -55.0,
     "resonator sign(x) gate; measured"),           # Resonant strike + res
]


def crossval_microsound_e2e_exactlen(presets=None) -> list[Row]:
    """Exact-length e2e rows (round 5): the engine's spectral chain runs at
    the TRUE grain length (ops/exact_dft.py), so renders are compared at
    REFERENCE-DEFAULT micro_ms values — non-pow2 grain lengths the padded-L
    convention could not reproduce (its broadband delta measured -20.6
    dBFS; see the demoted convention row)."""
    import json as _json
    from audio_suite_tpu.models import microsound as ms
    rows: list[Row] = []

    # reference-default micro_ms (1.25 ms -> n=80 at gen_sr 64 kHz) and the
    # previously-documented -20.6 dBFS case (n=1500, L=2048)
    for mode, micro_ms, tag in [
            ("Noise burst", 1.25, "default micro_ms, n=80"),
            ("Gaussian click", 1.25, "default micro_ms, n=80"),
            ("Noise burst", 1000.0 * 1500 / 64000.0,
             "n=1500 — the old padded-L -20.6 dBFS case"),
            ("Skewed transient", 1000.0 * 1500 / 64000.0, "n=1500"),
    ]:
        p = _ms_params(mode, micro_ms=micro_ms, partial_stretch=1.5)
        rows.append(_ms_e2e_row(
            f"microsound e2e exact-n [{mode}, {tag}]", p))

    preset_dir = os.path.join(REF, "microsound_0.2.1", "presets")
    for fname, bound, note in (presets or _EXACT_PRESETS):
        with open(os.path.join(preset_dir, fname)) as f:
            d = _json.load(f)
        # shorten for runtime; keep the preset's own micro_ms / gen chain
        d.update(out_dur_s=0.5, max_grains=48, seed=500,
                 bp_density="", bp_cutoff="", bp_stretch="", bp_unfold="")
        p = ms.MicrosoundParams.from_dict(d)
        ir_in = None
        if p.gen_mode == "IR fragment":
            rngi = np.random.default_rng(3)
            ir_in = (np.exp(-np.linspace(0, 7, 1200))
                     * rngi.standard_normal(1200)).astype(np.float64)
        rows.append(_ms_e2e_row(
            f"microsound e2e preset [{fname.removesuffix('.json')}, "
            f"micro_ms={d.get('micro_ms')}]", p, ir_in=ir_in,
            bound=bound, note=note))
    return rows


# ----------------------------------------------------------------------------
# TapeTUC: the literal provide_samples hot loop (Tape…py:767-911)
# ----------------------------------------------------------------------------

class _MathSinQueue(types.ModuleType):
    """math proxy whose sin() pops injected values (everything else is real
    math).  provide_samples calls math.sin exactly twice per output sample
    (wow then flutter, Tape…py:884-891)."""

    def __init__(self, values):
        super().__init__("math_proxy")
        self._q = np.asarray(values, np.float64)
        self._i = 0

    def sin(self, _x):
        v = self._q[self._i]
        self._i += 1
        return float(v)

    def __getattr__(self, k):
        return getattr(math, k)


def _mk_ref_looper(ns, audio, sr, markers, speeds, revs, *, tape_age=50,
                   splice_on=True, anticlick_on=True, anticlick_amount=50,
                   inertia_on=False, inertia_amount=50):
    """Instantiate the reference TapeLooper without Qt: __new__ + the exact
    attribute set from Tape…py:50-105, then the real
    recompute_boundaries_and_sections."""
    import threading
    TL = ns["TapeLooper"]
    lp = TL.__new__(TL)
    lp.lock = threading.RLock()
    lp.audio_data = np.asarray(audio, np.float32)   # load path dtype

    lp.sample_rate = sr
    lp.num_samples = len(audio)
    lp.play_pos = 0.0
    lp.markers = sorted(int(m) for m in markers)
    lp.section_speeds = list(speeds)
    lp.section_reverse = list(revs)
    lp.tape_age = tape_age
    lp.enable_splice_fx = splice_on
    lp.inertia_enabled = inertia_on
    lp.inertia_amount = inertia_amount
    lp.current_speed = 1.0
    lp.boundary_smooth_len = 400
    lp.anticlick_enabled = anticlick_on
    lp.anticlick_amount = anticlick_amount
    lp.wow_phase = 0.0
    lp.flutter_phase = 0.0
    lp.splice_env_len = 256
    x = np.linspace(0, 1, lp.splice_env_len, dtype=np.float32)
    lp.splice_env = 1.0 + 0.8 * np.exp(-5.0 * x)
    lp.splice_remaining = 0
    lp.splice_index = 0
    lp.undo_stack = []
    lp._suppress_undo = False
    lp.is_recording = False
    lp.recompute_boundaries_and_sections()
    return lp


def _ref_tape_out(lp, T, block=4800):
    """Pull T frames through the literal hot loop in realtime-sized blocks
    (the per-block f64 phase wrap at Tape…py:895-897 is part of the
    semantics)."""
    outs = []
    t = 0
    while t < T:
        b = min(block, T - t)
        outs.append(lp.provide_samples(b))
        t += b
    return np.concatenate(outs).astype(np.float64) / 32767.0


def _tape_test_signal(n, sr, seed=11, f_max=1200.0):
    """Band-limited test tape: position-drift deviations scale with the
    signal's per-sample slope, so the tape rows use a <=1.2 kHz mixture
    (documented in the row notes; broadband parity is covered by the
    engine-vs-oracle suite where positions are bit-identical)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = np.zeros(n)
    for f in np.linspace(90.0, f_max, 12):
        x += rng.uniform(0.3, 1.0) * np.sin(
            2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    x *= 0.6 / np.max(np.abs(x))
    return x.astype(np.float32)


def _fw_tape_params(sr, markers, speeds, revs, **kw):
    from audio_suite_tpu.models.tape import TapeParams
    return TapeParams(sample_rate=sr, markers=list(markers),
                      section_speeds=list(speeds),
                      section_reverse=list(revs), **kw)


def _fw_tape_i16(audio, params, T):
    """Framework render quantized with the reference's int16 convention
    (int() truncation toward zero, Tape…py:860-861)."""
    from audio_suite_tpu.models.tape import render_tape
    y = render_tape(np.asarray(audio, np.float32), params, T)
    return np.trunc(np.clip(y, -1.0, 1.0) * 32767.0) / 32767.0


def crossval_tape(bench_seconds: float = 0.0) -> list[Row]:
    """`bench_seconds > 0` switches to the BENCH-LENGTH regime: a
    bench-config-1-scale source (3 min) driven for the full
    duration, raw 12-bit mod convention (no injection), so the mod-curve
    drift integral is measured where the bench actually scores rather
    than at 1 s. Emits only the bench rows in that mode."""
    from audio_suite_tpu.models import tape as fw_tape
    rows: list[Row] = []
    sr = 48000
    if bench_seconds > 0:
        T = int(bench_seconds * sr)
        n = T                          # 3-min-scale source, covered once
        markers = [int(n * 0.30), int(n * 0.65)]
    else:
        n = 30000
        T = 48000
        markers = [9000, 19500]
    audio = _tape_test_signal(n, sr)
    speeds = [1.0, 0.5, 2.0]          # exactly representable after fixq
    revs = [False, True, False]

    # --- convention row: the quantized wow/flutter curve itself ---
    mod_fw = fw_tape.wow_flutter_mod(T, sr, 50)
    a = 50 / 100.0
    wd, fd = 0.001 + 0.006 * a, 0.0005 + 0.003 * a
    wp = 2 * np.pi * 0.4 * np.arange(T, dtype=np.float64) / sr
    fp = 2 * np.pi * 7.0 * np.arange(T, dtype=np.float64) / sr
    mod_ref = np.clip(1.0 + wd * np.sin(wp) + fd * np.sin(fp), 0.1, 3.0)
    rows.append(Row("tape wow/flutter mod curve (12-bit sin + fixq)",
                    max_dev_dbfs(np.asarray(mod_fw, np.float64), mod_ref),
                    -115.0,
                    "f64 math.sin accumulation (Tape…py:884-891) vs the "
                    "framework's cycle-domain 12-bit-significand twin; the "
                    "e2e consequence is the position-drift integral of "
                    "this delta"))

    def run_pair(name, bound, note, *, markers=markers, speeds=speeds,
                 revs=revs, T=T, inject_mod=True, **kw):
        lkw = dict(kw)
        p = _fw_tape_params(sr, markers, speeds, revs,
                            tape_age=lkw.pop("tape_age", 50),
                            enable_splice_fx=lkw.pop("splice_on", True),
                            anticlick_enabled=lkw.pop("anticlick_on", True),
                            anticlick_amount=lkw.pop("anticlick_amount", 50),
                            inertia_enabled=lkw.pop("inertia_on", False),
                            inertia_amount=lkw.pop("inertia_amount", 50))
        ns = load_ref_tape()
        if inject_mod:
            # feed the reference loop sin values that reproduce the
            # framework's quantized mod curve exactly: sin_wow[i] =
            # (mod_q[i]-1)/wd, sin_flutter[i] = 0 -> mod_ref == mod_q to
            # f64 rounding.  Isolates the int32 fixed-point position
            # algebra + interpolation + anticlick/splice decisions from
            # the (separately measured) mod-curve convention.
            prog = fw_tape.build_tape_program(np.asarray(audio, np.float32),
                                              p, T)
            mq = np.asarray(prog["mod_q"], np.float64)
            aa = p.tape_age / 100.0
            wd_l = 0.001 + 0.006 * aa
            q = np.zeros(2 * T)
            q[0::2] = (mq - 1.0) / wd_l
            ns["math"] = _MathSinQueue(q)   # methods resolve math via ns
        lp = _mk_ref_looper(ns, audio, sr, markers, speeds, revs,
                            tape_age=p.tape_age,
                            splice_on=p.enable_splice_fx,
                            anticlick_on=p.anticlick_enabled,
                            anticlick_amount=p.anticlick_amount,
                            inertia_on=p.inertia_enabled,
                            inertia_amount=p.inertia_amount)
        ref_out = _ref_tape_out(lp, T)
        fw_out = _fw_tape_i16(audio, p, T)
        drift = None
        from audio_suite_tpu.models.tape import build_tape_program, \
            tape_table_render
        prog = build_tape_program(np.asarray(audio, np.float32), p, T)
        _, final = tape_table_render(prog)
        import audio_suite_tpu.ops.fixq as fixq
        fw_pos = float(final["whole"]) \
            + float(final["frac"]) * float(fixq.POS_INV_F)
        drift = abs(fw_pos % n - float(lp.play_pos) % n)
        drift = min(drift, n - drift)
        rows.append(_row(name, fw_out, ref_out, bound=bound,
                         note=note + f"; final-position drift "
                              f"{drift:.2e} samples"))

    if bench_seconds > 0:
        run_pair(f"tape e2e [raw 12-bit mod convention, "
                 f"{bench_seconds:.0f} s BENCH length]",
                 -60.0, "bench config 1 duration: the full documented "
                        "convention delta with the mod-curve quantization "
                        "drift integrated over the whole performance "
                        "(the q12 sin error is oscillatory/near-zero-mean, "
                        "so the drift integral is bounded, not linear)",
                 splice_on=False, inject_mod=False)
        return rows

    # splice triggers (idx0 == boundary hit, Tape…py:851-853) are discrete
    # events: any reimplementation that does not replicate the reference's
    # float trajectory bit-for-bit can hit a boundary one output sample
    # earlier/later (envelope shifted by 1) or, at speeds > 1, skip a hit
    # the other side makes.  Measured separately; the algebra rows below
    # keep splice off.
    run_pair("tape e2e [mod-injected, anticlick, speeds+reverse]",
             -55.0, "fixed-point position algebra vs f64 floats; measured",
             splice_on=False)
    run_pair("tape e2e [mod-injected, inertia 60]",
             -25.0, "documented convention: the 2**-22-grid one-pole "
                    "FREEZES within 2**-23/alpha of the target (here "
                    "<=1.8e-3, i.e. <=0.18% speed — below the age-50 wow "
                    "depth of 0.45%) while the f64 reference converges "
                    "asymptotically; the freeze is what compresses the "
                    "speed curve into run tables (ops/varispeed.py:217-222)",
             splice_on=False, inertia_on=True, inertia_amount=60,
             speeds=[1.0, 0.5, 1.25], revs=[False, False, False])
    run_pair("tape e2e [mod-injected, splice on, unit speeds]",
             -30.0, "splice trigger alignment: a 1-sample envelope shift "
                    "at a boundary hit costs env-slope*|x| ~= -36 dBFS; "
                    "measured", speeds=[1.0, 1.0, 1.0],
             revs=[False, False, False])
    run_pair("tape e2e [raw 12-bit mod convention]",
             -35.0, "no injection: the full documented convention delta "
                    "(mod-curve quantization integrates into position "
                    "drift over 1 s)", splice_on=False, inject_mod=False)

    # --- detect_beats: exact marker parity ---
    rng = np.random.default_rng(5)
    beats_sig = np.zeros(sr * 3, np.float32)
    for k in range(0, sr * 3, sr // 2):
        L = 2000
        beats_sig[k:k + L] += (np.exp(-np.linspace(0, 8, L))
                               * np.sin(2 * np.pi * 180.0
                                        * np.arange(L) / sr)).astype(
            np.float32)
    beats_sig += 0.01 * rng.standard_normal(sr * 3).astype(np.float32)
    ns = load_ref_tape()
    lp = _mk_ref_looper(ns, beats_sig, sr, [], [1.0], [False])
    lp.beat_sens = types.SimpleNamespace(value=lambda: 50)
    lp.push_undo = lambda: None
    lp.update_markers = lambda: None
    lp.rebuild_table = lambda: None
    lp.detect_beats()
    ref_beats = list(lp.markers)
    fw_beats = fw_tape.detect_beats(beats_sig, sr, sensitivity=50)
    rows.append(Row("tape detect_beats (exact markers)",
                    -200.0 if fw_beats == ref_beats else 0.0, -200.0,
                    f"{len(ref_beats)} beats; exact list equality"))

    # --- fit-to-target-time retime formula (Tape…py:665-705) ---
    lp2 = _mk_ref_looper(ns, audio, sr, markers, [1.3, 0.6, 2.2],
                         [False, False, False])
    lp2.target_time_edit = types.SimpleNamespace(text=lambda: "1.7")
    lp2.push_undo = lambda: None
    lp2.rebuild_table = lambda: None
    lp2.on_apply_target_time()
    p3 = _fw_tape_params(sr, markers, [1.3, 0.6, 2.2],
                         [False, False, False])
    fw_speeds = fw_tape.fit_to_target_time(p3, n, 1.7)
    rows.append(_row("tape fit-to-target-time speeds",
                     np.asarray(fw_speeds), np.asarray(lp2.section_speeds),
                     bound=-200.0))

    return rows


# ----------------------------------------------------------------------------
# Scrubber: the literal audio_callback (scrubber_0.7.py:157-235)
# ----------------------------------------------------------------------------

class _LegacyRandomShim:
    """np.random module shim for the scrubber callback: randn is zeroed
    (stretch jitter disabled on both sides for injected rows), rand/randint
    replay the framework's host dropout rng sequence."""

    def __init__(self, rand_q, randint_q):
        self._rand = list(rand_q)
        self._randint = list(randint_q)

    def randn(self, *shape):
        return np.zeros(shape, np.float64)

    def rand(self):
        # empty queue => dropouts disabled on the framework side; return a
        # value that can never trigger (the reference still draws per block)
        return self._rand.pop(0) if self._rand else 1.0

    def randint(self, lo, hi):
        return self._randint.pop(0)

    def __getattr__(self, k):
        return getattr(np.random, k)


class _NpSinQueue(types.ModuleType):
    """numpy proxy: np.sin pops injected block vectors (wow then flutter
    per callback); np.random is replaceable; everything else passes
    through."""

    def __init__(self, sin_blocks, random_obj):
        super().__init__("numpy_sin_proxy")
        self._q = list(sin_blocks)
        self._random = random_obj

    def sin(self, x):
        return self._q.pop(0)

    def __getattr__(self, k):
        if k == "random":
            return self._random
        return getattr(np, k)


def _dropout_replay(seed, nb):
    """Replay the framework's dropout rng sequence
    (models/scrub.build_scrub_program) as (rand draws, randint draws)."""
    from audio_suite_tpu.models.scrub import (DROPOUT_PROB,
                                              DROPOUT_MIN_BLOCKS,
                                              DROPOUT_MAX_BLOCKS)
    rng = np.random.default_rng(seed)
    rand_q, randint_q = [], []
    active, left = False, 0
    for _ in range(nb):
        if active:
            left -= 1
            if left <= 0:
                active = False
        else:
            r = rng.random()
            rand_q.append(r)
            if r < DROPOUT_PROB:
                k = int(rng.integers(DROPOUT_MIN_BLOCKS,
                                     DROPOUT_MAX_BLOCKS + 1))
                randint_q.append(k)
                active, left = True, k
    return rand_q, randint_q


def crossval_scrub(bench_seconds: float = 0.0) -> list[Row]:
    """`bench_seconds > 0`: BENCH-LENGTH regime — the
    raw LFO convention driven for the bench config 2 duration so the q12
    LFO drift integral is measured at performance length. Emits only the
    bench rows in that mode."""
    from audio_suite_tpu.models import scrub as fw_scrub
    from audio_suite_tpu.ops import fixq
    import jax.numpy as jnp
    rows: list[Row] = []

    if bench_seconds <= 0:
        # --- kernel row: the fractional wrap-around tape sampler ---
        ns = load_ref_scrub()
        rng = np.random.default_rng(21)
        n = 16384
        tape = (rng.standard_normal(n) * 0.5).astype(np.float32)
        ns["audio_data"] = tape
        pos = rng.uniform(-3 * n, 3 * n, size=4096)
        ref_s = ns["sample_from_tape_array"](pos)
        wf = np.asarray([fixq.split_pos_np(p) for p in pos], np.int64)
        fw_s = np.asarray(fixq.gather_linear_wrap(
            jnp.asarray(tape), jnp.asarray(wf[:, 0], jnp.int32),
            jnp.asarray(wf[:, 1], jnp.int32)))
        rows.append(_row("scrub sample_from_tape_array", fw_s, ref_s,
                         bound=-55.0,
                         note="reference float positions carry f64->f32 "
                              "rounding near wrap; framework reads at exact "
                              "22-bit fixed-point positions"))

    # --- e2e: drive the literal callback block-by-block ---
    sr = 32768            # dyadic sr => block speeds exact under 12-bit sig
    bs = 1024
    nb = int(bench_seconds * sr / bs) if bench_seconds > 0 else 40  # 1.25 s
    n_tape = 32768 if bench_seconds <= 0 else 32768 * 8
    tape = _tape_test_signal(n_tape, sr, seed=31, f_max=900.0)

    def run_scrub(name, bound, note, base_speed, gesture_blocks, jumps,
                  heads, inject_lfo=True, dropouts=True, decompose=False):
        cfg = fw_scrub.ScrubConfig(sample_rate=sr, head_count=heads,
                                   block_size=bs, seed=77,
                                   stretch_jitter=False, dropouts=dropouts)
        trace = fw_scrub.GestureTrace(
            base_speed=np.full(nb, base_speed, np.float64),
            gesture_speed=np.asarray(gesture_blocks, np.float64),
            jump=np.asarray(jumps, np.float64))
        prog = fw_scrub.build_scrub_program(tape, cfg, trace,
                                            with_inc=True)
        fw_out = fw_scrub.render_scrub(tape, cfg, trace)

        # framework final position from the bit-identical NumPy twin
        inc = np.asarray(prog["inc_fix"], np.int64)
        reset = prog["reset"]
        seg = np.cumsum(reset.astype(np.int64))
        pos_fix = np.zeros(len(inc), np.int64)
        base_fix = (prog["seg_bases_whole"].astype(np.int64)
                    * fixq.POS_ONE + prog["seg_bases_frac"])
        acc = base_fix[0]
        for i in range(len(inc)):
            if reset[i]:
                acc = base_fix[seg[i]]
            pos_fix[i] = acc
            acc += inc[i]
        fw_final = float(acc) / fixq.POS_ONE

        # reference side
        sin_blocks = []
        if inject_lfo:
            consts = fw_scrub._mod_consts(sr)
            ci, cf_ = consts["ints"], consts["flts"]
            from audio_suite_tpu.ops import detmath, fixq as fq
            i = np.arange(nb * bs, dtype=np.uint32)
            swh, swl = fq.sig12_pair_np(detmath.sin_cycles_precise_np(
                detmath.phase_cycles_np(i, ci[0], ci[1], cf_[0])))
            sfh, sfl = fq.sig12_pair_np(detmath.sin_cycles_precise_np(
                detmath.phase_cycles_np(i, ci[2], ci[3], cf_[1])))
            # the framework's f32 hi/lo wow/flutter contributions
            # (models/scrub._inc_np), scaled so WOW_DEPTH * injected
            # reproduces them in the reference's f64 math
            wow = cf_[2] * swh + cf_[2] * swl + cf_[4] * swh
            flut = cf_[3] * sfh + cf_[3] * sfl + cf_[5] * sfh
            for b in range(nb):
                s, e = b * bs, (b + 1) * bs
                sin_blocks.append(wow[s:e].astype(np.float64)
                                  / fw_scrub.WOW_DEPTH)
                sin_blocks.append(flut[s:e].astype(np.float64)
                                  / fw_scrub.FLUTTER_DEPTH)
        rand_q, randint_q = _dropout_replay(77, nb) if dropouts else ([], [])
        rnd = _LegacyRandomShim(rand_q, randint_q)
        proxy = (_NpSinQueue(sin_blocks, rnd) if inject_lfo
                 else _NpProxy(rnd))
        ns2 = load_ref_scrub(np_proxy=proxy)
        ns2["STRETCH_DEPTH"] = 0.0
        if not dropouts:
            ns2["DROPOUT_PROB"] = -1.0
        ns2["audio_data"] = tape.astype(np.float32)
        ns2["sample_rate"] = sr
        ns2["tape_pos"] = 0.0
        ns2["playback_time"] = 0.0
        ns2["current_head_count"] = heads
        outs = []
        for b in range(nb):
            if np.isfinite(trace.jump[b]):
                ns2["tape_pos"] = float(trace.jump[b])
            ns2["base_speed_factor"] = float(trace.base_speed[b])
            ns2["gesture_speed"] = float(trace.gesture_speed[b])
            o = np.zeros((bs, 2), np.float32)
            ns2["audio_callback"](o, bs, None, None)
            outs.append(o[:, 0].copy())
        ref_out = np.concatenate(outs).astype(np.float64)
        ref_final = float(ns2["tape_pos"])
        drift = abs((fw_final - ref_final + n_tape / 2) % n_tape
                    - n_tape / 2)
        note = note + f"; final-position drift {drift:.2e} samples"
        if decompose:
            # f64 ground truth of the ideal semantics: exact time vector,
            # f64 sin, f64 position integral — attributes the residual
            total = np.clip(np.asarray(trace.base_speed) * sr
                            + np.asarray(trace.gesture_speed),
                            -fw_scrub.MAX_TAPE_SPEED,
                            fw_scrub.MAX_TAPE_SPEED)
            tt = np.arange(nb * bs, dtype=np.float64) / sr
            sf64 = (1.0 + fw_scrub.WOW_DEPTH
                    * np.sin(2 * np.pi * fw_scrub.WOW_FREQ * tt)
                    + fw_scrub.FLUTTER_DEPTH
                    * np.sin(2 * np.pi * fw_scrub.FLUTTER_FREQ * tt))
            ideal = float(np.sum(np.repeat(total / sr, bs) * sf64))
            note += (f"; final-pos error vs f64-exact semantics: "
                     f"reference {abs(ref_final - ideal):.2e} smp, "
                     f"framework {abs(fw_final - ideal):.2e} smp — the "
                     f"residual IS the reference's f32 unwrapped-position "
                     f"rounding (ulp 0.03 smp at |pos|~5e5 by 30 s)")
        rows.append(_row(name, np.asarray(fw_out, np.float64), ref_out,
                         bound=bound, note=note))

    # dyadic gestures: exact under the 12-bit block-speed convention
    if bench_seconds > 0:
        gest = np.zeros(nb)
        gest[nb // 5:2 * nb // 5] = 4096.0
        gest[2 * nb // 5:3 * nb // 5] = -2048.0
        run_scrub(f"scrub e2e [raw convention, 3 heads, "
                  f"{bench_seconds:.0f} s BENCH length]",
                  -45.0, "bench config 2 duration; DOCUMENTED CONVENTION: "
                         "the framework keeps exact fixed-point positions "
                         "+ ~2**-24 LFO (detmath.sin_cycles_precise) while "
                         "the reference accumulates its unwrapped position "
                         "in f32, whose ulp reaches 0.03 samples by 30 s — "
                         "the deviation is the reference's own rounding "
                         "(see decomposition)",
                  0.5, gest, np.full(nb, np.nan), 3, inject_lfo=False,
                  decompose=True)
        return rows

    gest = np.zeros(nb)
    gest[8:16] = 4096.0
    gest[16:24] = -2048.0
    jumps = np.full(nb, np.nan)
    jumps[28] = 12288.0
    run_scrub("scrub e2e [LFO-injected, 3 heads, drags+jump+dropouts]",
              -60.0, "f32 cumsum positions (reference) vs exact int "
                     "prefix sum", 0.5, gest, jumps, 3)
    run_scrub("scrub e2e [LFO-injected, 1 head, reverse base]",
              -60.0, "negative base speed wrap", -0.25, np.zeros(nb),
              np.full(nb, np.nan), 1, dropouts=False)
    run_scrub("scrub e2e [raw LFO convention, 2 heads]",
              -40.0, "no injection: 12-bit cycle-domain LFO vs np.sin on "
                     "an f32 time vector; drift integrates over 1.25 s",
              0.5, gest, np.full(nb, np.nan), 2, inject_lfo=False)

    return rows


# ----------------------------------------------------------------------------
# Pattern Lab: the reference app package imports Qt-free — drive it directly
# ----------------------------------------------------------------------------

def _ev_tuple(e):
    return (float(e.t0), float(e.dur), float(e.midi), float(e.vel),
            int(e.chan), str(e.engine))


def _to_fw_events(ref_events):
    from audio_suite_tpu.events.notes import NoteEvent
    return [NoteEvent(t0=float(e.t0), dur=float(e.dur), midi=float(e.midi),
                      vel=float(e.vel), chan=int(e.chan),
                      engine=str(e.engine)) for e in ref_events]


def crossval_patternlab(long_seconds: float = 0.0,
                        long_only: bool = False) -> list[Row]:
    import importlib
    load_ref_patternlab()
    r_music = importlib.import_module("ref_pl.app.music")
    r_patterns = importlib.import_module("ref_pl.app.patterns")
    r_renderer = importlib.import_module("ref_pl.app.renderer")
    r_events = importlib.import_module("ref_pl.app.events")
    from audio_suite_tpu.utils import music as fw_music
    from audio_suite_tpu.models import patternlab as fw_pl
    from audio_suite_tpu.events.notes import RenderConfig
    rows: list[Row] = []

    if long_only:
        ckw = dict(sample_rate=44100, seconds=float(long_seconds),
                   bpm=132.0, swing=0.0, time_stretch=1.0,
                   micro_jitter=0.002, master_gain=0.9, seed=4242)
        rc = r_events.RenderConfig(**ckw)
        fc = RenderConfig(**ckw)
        ev_r = r_patterns.generate("Fibonacci Gate", rc,
                                   steps=int(long_seconds * 8))
        y_ref, _ = r_renderer.render(ev_r, rc)
        y_fw, _ = fw_pl.render(_to_fw_events(ev_r), fc)
        rows.append(_row(
            f"patternlab e2e [long {long_seconds:.0f}s BENCH length]",
            np.asarray(y_fw, np.float64), np.asarray(y_ref, np.float64),
            bound=-60.0,
            note=f"error-accumulation regime vs the literal reference "
                 f"({len(ev_r)} notes, {long_seconds:.0f} s)"))
        return rows

    # --- music math (host, expect exact) ---
    midis = np.linspace(20.0, 110.0, 181)
    rows.append(_row("patternlab midi_to_hz",
                     np.asarray([fw_music.midi_to_hz(m) for m in midis]),
                     np.asarray([r_music.midi_to_hz(m) for m in midis]),
                     bound=-200.0))
    st = list(range(-12, 13))
    rows.append(_row("patternlab pythagorean_ratio",
                     np.asarray([fw_music.pythagorean_ratio(s) for s in st]),
                     np.asarray([r_music.pythagorean_ratio(s) for s in st]),
                     bound=-200.0))
    ok = (fw_music.primes_upto(500) == r_music.primes_upto(500)
          and fw_music.fibonacci(40) == r_music.fibonacci(40))
    for steps, pulses, rot in ((16, 5, 0), (13, 5, 3), (8, 3, 7),
                               (12, 12, 1), (7, 0, 0)):
        ok = ok and np.array_equal(
            fw_music.euclidean_rhythm(steps, pulses, rot),
            r_music.euclidean_rhythm(steps, pulses, rot))
    rng = np.random.default_rng(9)
    xq = rng.uniform(-1.3, 1.3, 4096)
    ok = ok and np.allclose(fw_music.quantize_to_bits_np(xq, 10),
                            r_music.quantize_to_bits(xq, 10), atol=0)
    rows.append(Row("patternlab music primes/fib/euclid/quantizer",
                    -200.0 if ok else 0.0, -200.0, "exact equality"))

    # --- generators: event-stream parity (same rng streams, expect exact)
    cfg_kw = dict(sample_rate=44100, seconds=6.0, bpm=132.0, swing=0.0,
                  time_stretch=1.0, micro_jitter=0.0, master_gain=0.9,
                  seed=4242)
    r_cfg = r_events.RenderConfig(**cfg_kw)
    f_cfg = RenderConfig(**cfg_kw)
    gens = ["Glass Cells", "Fibonacci Gate", "Prime Phase",
            "Pythagorean Canon"]
    gen_kwargs = {"Glass Cells": dict(drift=1.0)}
    for g in gens:
        kw = gen_kwargs.get(g, {})
        ev_r = r_patterns.generate(g, r_cfg, **kw)
        ev_f = fw_pl.generate(g, f_cfg, **kw)
        same = (len(ev_r) == len(ev_f)
                and all(_ev_tuple(a) == _ev_tuple(b)
                        for a, b in zip(ev_r, ev_f)))
        rows.append(Row(f"patternlab events [{g}]",
                        -200.0 if same else 0.0, -200.0,
                        f"{len(ev_r)} events, exact"))

    # --- e2e renders vs the literal reference renderer ---
    def run_e2e(name, gen, cfg_over, bound, note="", kw=None):
        ckw = dict(cfg_kw)
        ckw.update(cfg_over)
        rc = r_events.RenderConfig(**ckw)
        fc = RenderConfig(**ckw)
        ev_r = r_patterns.generate(gen, rc, **(kw or {}))
        y_ref, _ = r_renderer.render(ev_r, rc)
        y_fw, _ = fw_pl.render(_to_fw_events(ev_r), fc)
        rows.append(_row(name, np.asarray(y_fw, np.float64),
                         np.asarray(y_ref, np.float64), bound=bound,
                         note=note + f" ({len(ev_r)} notes, "
                              f"{ckw['seconds']:.0f} s)"))

    run_e2e("patternlab e2e [Glass Cells + jitter/swing]", "Glass Cells",
            dict(micro_jitter=0.004, swing=0.2), -60.0,
            "apply_time_ops rng parity + FM bank")
    run_e2e("patternlab e2e [Fibonacci Gate]", "Fibonacci Gate", {}, -60.0,
            "FM + PSG noise LFSR")
    run_e2e("patternlab e2e [Prime Phase]", "Prime Phase", {}, -60.0)
    run_e2e("patternlab e2e [Pythagorean Canon]", "Pythagorean Canon",
            {}, -60.0, "fractional midi")
    if long_seconds > 0:
        run_e2e(f"patternlab e2e [long {long_seconds:.0f}s stress]",
                "Fibonacci Gate",
                dict(seconds=float(long_seconds), micro_jitter=0.002),
                -60.0, "error-accumulation regime vs the literal reference",
                kw=dict(steps=int(long_seconds * 8)))
    return rows


# ----------------------------------------------------------------------------
# Grid Audio vs the literal reference (grid_audio_app.py)
# ----------------------------------------------------------------------------

_GRID_CLICK = """\
import numpy as np
def generate(sr, dur):
    n = int(round(dur * sr))
    x = np.zeros(n, dtype=np.float32)
    k = max(1, n // 4)
    x[::k] = 0.8
    x[1::k] = -0.5
    return x
"""

_GRID_MELODIC = """\
import numpy as np
def generate(sr, dur, context):
    n = int(round(dur * sr))
    t = np.arange(n, dtype=np.float32) / np.float32(sr)
    f = np.float32(220.0 * (1.0 + context["cell_index"]
                            / max(1, context["cells_total"])))
    return (0.35 * np.sin(2.0 * np.pi * f * t)).astype(np.float32)
"""

_GRID_EV_ALL_EXCEPT = """\
import numpy as np
def generate(sr, dur):
    n = int(round(dur * sr))
    x = np.zeros(n, dtype=np.float32)
    x[:32] = 0.7
    return x
def event(context):
    if context["cell_index"] == 0 and context["master_time"] > 0.5:
        return {"restart_tracks": "all_except_self", "delay": 0.01}
    return {}
"""

_GRID_EV_NAMES = """\
import numpy as np
def generate(sr, dur):
    n = int(round(dur * sr))
    x = np.zeros(n, dtype=np.float32)
    x[:16] = -0.6
    return x
def event(context):
    return {"restart_tracks": ["Pulse", 2], "delay": 0.0}
"""

_GRID_DIV_CODE = "def divisions(total):\n    return [3, 1, 2, 2, 1, 3]\n"


def _grid_scripts(tmpdir: str) -> dict:
    paths = {}
    for name, src in (("click", _GRID_CLICK), ("melodic", _GRID_MELODIC),
                      ("ev_all", _GRID_EV_ALL_EXCEPT),
                      ("ev_names", _GRID_EV_NAMES)):
        p = os.path.join(tmpdir, f"xval_{name}.py")
        with open(p, "w") as f:
            f.write(src)
        paths[name] = p
    return paths


def _grid_tracks(track_cls, cell_cls, sc: dict, wav_path: str) -> list:
    """The same 3-track project built on either side's dataclasses:
    loop_to_master + uniform divisions, python divisions + wav resample,
    mod-source speed + sync points + cross-track restarts."""
    t0 = track_cls(name="Pulse", mode="tempo_bpm", bpm=120.0,
                   beats_per_measure=4, measures=1, uniform_n=8,
                   loop_to_master=True)
    t0.cells = [cell_cls(kind="py", path=sc["click"]) if i % 2 == 0
                else cell_cls(kind="empty", path="") for i in range(8)]
    t1 = track_cls(name="Wav", mode="duration", duration_seconds=2.5,
                   division_mode="python", python_code=_GRID_DIV_CODE,
                   start_offset_seconds=0.35, gain_db=-2.5)
    t1.cells = [cell_cls(kind="wav", path=wav_path),
                cell_cls(kind="py", path=sc["ev_names"]),
                cell_cls(kind="empty", path=""),
                cell_cls(kind="py", path=sc["melodic"]),
                cell_cls(kind="empty", path=""),
                cell_cls(kind="empty", path="")]
    t2 = track_cls(name="Mod", mode="duration", duration_seconds=3.0,
                   uniform_n=6, loop_to_master=True,
                   sync_points_text="1.0, 2.2",
                   mod_source_index=0, mod_amount=1.5,
                   mod_smoothing_ms=80.0)
    t2.cells = [cell_cls(kind="py", path=sc["ev_all"])] \
        + [cell_cls(kind="py", path=sc["melodic"]) for _ in range(5)]
    return [t0, t1, t2]


def crossval_grid() -> list[Row]:
    import tempfile

    from audio_suite_tpu.models import grid as fw_grid
    from audio_suite_tpu.utils import io as fw_io

    rows: list[Row] = []
    ns, RefGrid = load_ref_grid()
    rng = np.random.default_rng(7)

    # --- helper kernels (grid_audio_app.py:26-151) ---
    x = (rng.standard_normal(44100) * 0.3).astype(np.float32)
    rows.append(_row("grid _resample_linear",
                     fw_io.resample_linear(x, 44100, 48000),
                     ns["_resample_linear"](x, 44100, 48000), bound=-100.0))
    rows.append(_row("grid _fit_to_duration (pad + trunc)",
                     np.concatenate([fw_io.fit_to_duration(x, 44100, 1.25),
                                     fw_io.fit_to_duration(x, 44100, 0.4)]),
                     np.concatenate([ns["_fit_to_duration"](x, 44100, 1.25),
                                     ns["_fit_to_duration"](x, 44100, 0.4)]),
                     bound=-200.0, note="exact"))
    rows.append(_row("grid _normalize_peak",
                     fw_io.normalize_peak(x * 3.0),
                     ns["_normalize_peak"](x * 3.0), bound=-120.0))
    win = int(round(80.0 * 0.001 * 44100))
    rows.append(_row("grid moving_average convention (cumsum vs convolve)",
                     fw_grid.moving_average(x * x, win),
                     ns["moving_average"](x * x, win), bound=-80.0,
                     note="f64 prefix sums vs the reference's f32 "
                          "np.convolve; documented framework semantics"))
    rows.append(_row("grid rms_envelope convention",
                     fw_grid.rms_envelope(x, win),
                     ns["rms_envelope"](x, win), bound=-80.0))
    pl_ok = (fw_grid.parse_float_list(" 2.5;1.0, nope, 0.5 ,")
             == ns["parse_float_list"](" 2.5;1.0, nope, 0.5 ,"))
    rows.append(Row("grid parse_float_list", -200.0 if pl_ok else 0.0,
                    -200.0, "exact list equality"))

    with tempfile.TemporaryDirectory() as td:
        sc = _grid_scripts(td)
        wav_path = os.path.join(td, "xval_tone.wav")
        t = np.arange(int(0.7 * 32000), dtype=np.float32) / 32000.0
        fw_io.write_wav(wav_path, (0.5 * np.sin(2 * np.pi * 330.0 * t))
                        .astype(np.float32), 32000)
        # the reference reads WAVs through soundfile (grid_audio_app.py:65);
        # shim sf.read with the framework codec so both sides decode the
        # same PCM16 samples — an I/O shim, not a semantics change
        ns["sf"] = types.SimpleNamespace(
            read=lambda path, always_2d=False: fw_io.read_wav(
                path, always_2d=always_2d))

        ref_tracks = _grid_tracks(ns["Track"], ns["CellSource"], sc, wav_path)
        rg = RefGrid()
        rg.tracks = ref_tracks
        rg.master = ns["MasterClock"](mode="fixed_seconds", fixed_seconds=6.0)
        rg.sr = 44100

        fw_tracks = _grid_tracks(fw_grid.Track, fw_grid.CellSource, sc,
                                 wav_path)
        proj = fw_grid.GridProject(
            tracks=fw_tracks,
            master=fw_grid.MasterClock(mode="fixed_seconds",
                                       fixed_seconds=6.0),
            sample_rate=44100)

        # --- division normalization (python mode, sandboxed exec) ---
        div_ok = (fw_tracks[1].build_divisions()
                  == ref_tracks[1].build_divisions())
        rows.append(Row("grid python divisions (exec + normalize)",
                        -200.0 if div_ok else 0.0, -200.0,
                        "exact list equality"))

        # --- restart-event resolution (grid_audio_app.py:601-706) ---
        master_dur = rg.master.duration(rg.tracks)
        ref_restarts = rg._collect_restart_events(master_dur)
        fw_restarts = fw_grid.collect_restart_events(proj, master_dur)
        rs_ok = [sorted(a) == sorted(b)
                 for a, b in zip(fw_restarts, ref_restarts)]
        n_ev = sum(len(s) for s in ref_restarts)
        rows.append(Row("grid restart-event sets (all_except_self + names)",
                        -200.0 if all(rs_ok) else 0.0, -200.0,
                        f"{n_ev} restart samples across 3 tracks; exact"))

        # --- mod-speed convention: the framework computes per-sample speed
        # with the envdet fixed-point chain (2**-22 speed grid, q12 amount)
        # so the device int32 positions are bit-identical to the host; the
        # reference uses f32 rms/clip directly ---
        y_fw_host, placed = fw_grid.render_mixdown(proj, engine="host",
                                                   return_tracks=True)
        src = np.asarray(placed[0], np.float32)
        win = int(round(80.0 * 0.001 * 44100))
        env = ns["rms_envelope"](src, max(1, win))
        env = (env / float(np.max(env))).astype(np.float32)
        sp_ref = np.clip(1.0 + 1.5 * env, 0.25, 4.0).astype(np.float32)
        sp_fw = fw_grid.mod_speed_for_track(src, 80.0, 1.5, 44100)
        rows.append(_row("grid mod-speed convention (envdet 2^-22 chain)",
                         sp_fw, sp_ref, bound=-80.0,
                         note="per-sample speed control signal"))

        # --- placement accumulator: the literal reference per-sample loop
        # (grid_audio_app.py:786-814) consuming the FRAMEWORK's speed
        # array, vs the framework's segmented-cumsum placement ---
        n_total = int(round(master_dur * 44100))
        reset2 = set(int(round(p * 44100))
                     for p in ns["parse_float_list"](
                         ref_tracks[2].sync_points_text) if p >= 0.0)
        reset2 |= ref_restarts[2]
        divs2 = ref_tracks[2].build_divisions()
        pat2 = rg._render_track_pattern(
            2, ref_tracks[2], divs2, float(sum(divs2)),
            ns["parse_float_list"](ref_tracks[2].sync_points_text))
        y_ref_place = np.zeros(n_total, np.float32)
        rg._render_track_to_master(y_ref_place, pat2, len(pat2),
                                   ref_tracks[2].start_offset_seconds, True,
                                   sp_fw, reset2)
        rows.append(_row("grid placement loop (fw speed injected into ref)",
                         np.asarray(placed[2], np.float64),
                         y_ref_place.astype(np.float64), bound=-120.0,
                         note="resets + loop + mod; reference per-sample "
                              "f64 loop vs segmented cumsum"))

        # --- e2e mixdown without modulation: everything except the speed
        # convention (restarts, sync resets, loop, wav resample, division
        # exec, gains, clip) ---
        for tl in (ref_tracks, fw_tracks):
            tl[2].mod_amount = 0.0
        y_ref_nomod = rg.render_mixdown()
        y_fw_nomod_h = fw_grid.render_mixdown(proj, engine="host")
        y_fw_nomod_d = fw_grid.render_mixdown(proj, engine="device")
        rows.append(_row("grid e2e mixdown (unmodulated, host twin)",
                         y_fw_nomod_h, y_ref_nomod, bound=-120.0,
                         note="restarts + sync resets + wav resample + "
                              "gains + clip"))
        rows.append(_row("grid e2e mixdown (unmodulated, device engine)",
                         y_fw_nomod_d, y_ref_nomod, bound=-120.0))
        for tl in (ref_tracks, fw_tracks):
            tl[2].mod_amount = 1.5

        # --- raw speed convention e2e: the ~1e-5 speed delta INTEGRATES
        # into the read position, so the modulated track's audio is a
        # time-shifted read (max drift below) — sample-wise dBFS saturates
        # under a time shift and is reported in the note instead ---
        y_ref_raw = rg.render_mixdown()
        drift = float(np.max(np.abs(np.cumsum(
            sp_fw.astype(np.float64) - sp_ref.astype(np.float64)))))
        audio_dev = max_dev_dbfs(y_fw_host, y_ref_raw)
        rows.append(Row(
            "grid e2e raw speed convention (read-position drift)",
            20.0 * np.log10(max(drift, 1e-10) / n_total), -80.0,
            f"max read-position drift {drift:.2f} samples "
            f"({drift / 44.1:.3f} ms) over {n_total} ({n_total / 44100:.0f} s "
            f"render); sample-wise audio dev {audio_dev:.1f} dBFS "
            "(time-shifted sine reads; documented framework semantics)"))
    return rows


# ----------------------------------------------------------------------------
# Forest Fire vs the literal reference (forest_fire_OSC_0.1)
# ----------------------------------------------------------------------------

class _FFReplay:
    """np.random.Generator stand-in that serves the FRAMEWORK's
    counter-noise realization to the reference model in the reference's
    draw order (model.py:127-217).  Data-dependent draws (per-ember d /
    jitter / landing-ignite, per-regrow fuel) are mapped cell-for-cell:
    the shim predicts the reference's own masks with the reference's f64
    formulas, reading the model's state at the same point in the step."""

    def __init__(self, model_ref, p_fw, seed, ffm, fnoise, q12np):
        self.m = model_ref
        self.p = p_fw
        self.seed = np.uint32(seed)
        self.ffm, self.fnoise, self.q12np = ffm, fnoise, q12np
        self.H, self.W = p_fw.h, p_fw.w
        self.cells = np.arange(self.H * self.W,
                               dtype=np.uint32).reshape(self.H, self.W)
        self.qc = ffm.quantized_consts(p_fw)
        self.collisions = 0

    def begin_step(self, k: int):
        self._k = k
        self._grid_calls = 0
        self._emit_field = None
        self._emit_idx = None
        self._d = self._jx = self._jy = None
        self._grow: list = []

    # -- framework draw sites ------------------------------------------------
    def _base(self):
        return np.uint32(self._k) * np.uint32(self.ffm._SITES)

    def _u(self, site):
        return self.fnoise.uniform_np(self.seed, self.cells,
                                      self._base() + np.uint32(site))

    def _nrm(self, site):
        return self.fnoise.normal_np(
            self.seed, self.cells,
            self._base() + np.uint32(self.ffm._NRM_OFFSET)
            + np.uint32(site))

    # -- reference Generator API ----------------------------------------------
    def random(self, size=None):
        ffm = self.ffm
        if size is None:   # rain scalar (model.py:127)
            return float(self.fnoise.uniform_np(
                self.seed, np.uint32(0),
                self._base() + np.uint32(ffm._S_RAIN)))
        if isinstance(size, tuple):   # grid fields, in step order
            self._grid_calls += 1
            c = self._grid_calls
            if c == 1:
                return self._u(ffm._S_SPREAD)
            if c == 2:
                return self._u(ffm._S_LIGHT)
            if c == 3:
                self._emit_field = self._u(ffm._S_EMIT)
                return self._emit_field
            if c == 4:
                f = self._u(ffm._S_GROW_E)
                self._queue_grow(f, empty=True)
                return f
            if c == 5:
                f = self._u(ffm._S_GROW_A)
                self._queue_grow(f, empty=False)
                return f
            raise AssertionError("unexpected grid draw")
        # 1-D: per-ember landing-ignite draws (model.py:193) — serve the
        # framework's draw AT THE LANDING CELL (destination-draw); embers
        # sharing a landing share the draw on both sides by construction
        n = int(size)
        yy, xx = self._landings()
        assert n == len(yy), (n, len(yy))
        u_ig = self._u(self.ffm._S_IGNITE)
        self.collisions += n - len(set(zip(yy.tolist(), xx.tolist())))
        return u_ig[yy, xx]

    def _emit_cells(self):
        if self._emit_idx is None:
            emit = ((self.m.state == 2)   # FIRE, post-burnout state
                    & (self._emit_field < self.p.ember_rate))
            self._emit_idx = np.argwhere(emit)
        return self._emit_idx

    def integers(self, lo, hi, size=None):
        idx = self._emit_cells()
        assert int(size) == idx.shape[0] and int(lo) == 3
        df = (np.float32(3.0)
              + np.floor(self._u(self.ffm._S_DIST)
                         * np.float32(self.p.ember_max_dist + 1 - 3)))
        self._d = df[idx[:, 0], idx[:, 1]].astype(np.int64)
        return self._d

    def normal(self, loc=0.0, scale=1.0, size=None):
        idx = self._emit_cells()
        sig = np.float32(self.qc["sig"])
        jx_f = self.q12np(self._nrm(self.ffm._S_JX)) * sig
        jy_f = self.q12np(self._nrm(self.ffm._S_JY)) * sig
        self._jx = jx_f[idx[:, 0], idx[:, 1]].astype(np.float64)
        self._jy = jy_f[idx[:, 0], idx[:, 1]].astype(np.float64)
        return np.stack([self._jx, self._jy], axis=1)

    def _landings(self):
        idx = self._emit_cells()
        wx, wy = self.m._wind_vec()
        dx = (wx * self._d + self._jx).astype(np.int32)
        dy = (wy * self._d + self._jy).astype(np.int32)
        yy = (idx[:, 0] + dy) % self.H
        xx = (idx[:, 1] + dx) % self.W
        return yy, xx

    def _queue_grow(self, field, empty: bool):
        p, m, ffm = self.p, self.m, self.ffm
        mask_state = (m.state == (0 if empty else 3))   # EMPTY / ASH
        grow_mod = np.clip(0.6 + 0.8 * m.moisture, 0.0, 1.6)
        rate = p.regrow_rate if empty else p.ash_regrow_rate
        mask = mask_state & (field < rate * grow_mod)
        idx = np.argwhere(mask)
        if idx.shape[0] == 0:
            return   # the reference skips the uniform call (model.py:210)
        site = ffm._S_FUEL_E if empty else ffm._S_FUEL_A
        base_v = np.float32(0.5 if empty else 0.55)
        cf = np.float32(self.qc["c03"] if empty else self.qc["c035n"])
        vals = (base_v + cf * self.q12np(self._u(site)))
        self._grow.append(vals[idx[:, 0], idx[:, 1]])

    def uniform(self, lo, hi, size=None):
        vals = self._grow.pop(0)
        assert int(size) == len(vals)
        return vals


def crossval_forestfire() -> list[Row]:
    import audio_suite_tpu.models.forestfire as ffm
    from audio_suite_tpu.events import rules as fw_rules
    from audio_suite_tpu.ops import noise as fnoise
    from audio_suite_tpu.ops.fixq import round_sig12_np as q12np

    ref_model, ref_watchers = load_ref_forestfire()
    rows: list[Row] = []

    kw_small = dict(w=64, h=48)

    # --- init parity: same np.random.default_rng stream (model.py:74-96) ---
    m_ref = ref_model.ForestFireModel(ref_model.ModelParams(**kw_small),
                                      seed=5)
    m_fw = ffm.ForestFireModel(ffm.ModelParams(**kw_small), seed=5)
    s = m_fw._np
    init_ok = (np.array_equal(s["state"], m_ref.state)
               and np.array_equal(s["fuel"], m_ref.fuel)
               and np.array_equal(s["moisture"], m_ref.moisture))
    elev_dev = max_dev_dbfs(np.asarray(s["elev"], np.float64),
                            np.asarray(m_ref.elev, np.float64))
    rows.append(Row("ff init reset() state/fuel/moisture",
                    -200.0 if init_ok else 0.0, -200.0,
                    "bit-exact (same default_rng stream, model.py:74-96)"))
    rows.append(Row("ff init elev q12 convention", elev_dev, -72.0,
                    "framework rounds elev to 12-bit significands so "
                    "terrain products are exact (forestfire.py:132-134)"))

    # --- interactive brush edits (model.py:224-258) ---
    for m in (m_ref, m_fw):
        m.ignite_at(20, 12, radius=3)
        m.set_tree_at(40, 30, radius=2)
        m.clear_at(8, 40, radius=2)
    s = m_fw._np
    brush_ok = (np.array_equal(s["state"], m_ref.state)
                and np.array_equal(s["fuel"], m_ref.fuel))
    rows.append(Row("ff brush edits (ignite/set_tree/clear)",
                    -200.0 if brush_ok else 0.0, -200.0, "exact"))

    # --- render_rgb on identical state (model.py:273-309) ---
    rgb_dev = max_dev_dbfs(
        np.asarray(m_fw.render_rgb(), np.float64) / 255.0,
        np.asarray(m_ref.render_rgb(), np.float64) / 255.0)
    rows.append(Row("ff render_rgb (identical state)", rgb_dev, -47.0,
                    "f32 vs f64 color math may flip a uint8 count "
                    "(1/255 = -48.1 dBFS)"))

    # --- per-step shadow trajectories with the replay shim -------------------
    # Design: each step, the reference model is RESYNCED to the framework's
    # pre-step state (bit-identical fields incl. the q12 elev), then both
    # sides step on IDENTICAL random draws.  Any post-step state flip is
    # therefore caused purely by the framework's documented arithmetic
    # conventions (12-bit-significand constants/fields so device f32
    # products are exact).  Each flip must be *explained*: its governing uniform draw
    # has to sit inside the tiny interval between the two conventions'
    # thresholds at that cell (spread/lightning/regrow/ember-ignite), or be
    # on an ember path (landing shifts / shared-landing draws,
    # forestfire.py:324-333).  This quantifies the convention instead of
    # demanding an impossible bit-exact free trajectory.
    def _conv_thresholds(p, qc, elev, state0, fuel0, moist0, rain_flag):
        """Both conventions' threshold fields, following step order
        (model.py:127-213 vs forestfire.py:276-373)."""
        f32 = np.float32
        gy, gx = np.gradient(elev)
        # reference convention (f32 arrays, f64 scalars)
        ang = np.deg2rad(p.wind_dir_deg)
        wx_r, wy_r = float(np.cos(ang)), float(np.sin(ang))
        m = moist0
        if rain_flag:
            m = np.clip(m + f32(p.rain_strength), 0.0, 1.0)
        base_r = np.clip(0.45 - 0.20 * elev, 0.05, 0.7).astype(f32)
        m_r_ = np.clip(m + f32(p.moisture_relax) * (base_r - m), 0.0, 1.0)
        burning = state0 == 2
        f_r_ = np.where(burning,
                        np.clip(fuel0 - f32(p.fuel_burn_rate), 0.0, 1.0),
                        fuel0)
        dot_r = gx * wx_r + gy * wy_r
        slope_r = 1.0 + p.slope_strength * np.clip(-dot_r, 0.0, 1.0)
        wind_r = 1.0 + p.wind_strength * np.clip(dot_r + 0.5, 0.0, 1.0) * 0.6
        mt_r = 1.0 - np.clip(m_r_, 0.0, 1.0)
        ref = {
            "spread": np.clip(p.base_spread * mt_r
                              * (0.35 + 0.65 * np.clip(f_r_, 0.0, 1.0))
                              * slope_r * wind_r, 0.0, 0.99),
            "light": p.lightning_rate * mt_r,
            "ignite": np.clip(p.spotting_strength * (1.0 - m_r_)
                              * (0.25 + 0.75 * f_r_), 0.0, 0.95),
            "grow_e": p.regrow_rate * np.clip(0.6 + 0.8 * m_r_, 0.0, 1.6),
            "grow_a": p.ash_regrow_rate
            * np.clip(0.6 + 0.8 * m_r_, 0.0, 1.6),
        }
        # framework convention (forestfire.py terrain_static + step_device)
        q = q12np
        base_f = np.clip(f32(0.45) - f32(qc["c020"]) * elev, 0.05, 0.7)
        m_f_ = m + f32(qc["relax"]) * q(base_f - m)
        m_f_ = np.clip(m_f_, 0.0, 1.0)
        dot_f = q(gx.astype(f32)) * f32(qc["wx"]) \
            + q(gy.astype(f32)) * f32(qc["wy"])
        slope_f = f32(1.0) + f32(qc["slope"]) * q(np.clip(-dot_f, 0.0, 1.0))
        wind_f = f32(1.0) + q(f32(qc["wind"])
                              * np.clip(dot_f + f32(0.5), 0.0, 1.0)) \
            * f32(qc["c06"])
        mt_f = f32(1.0) - np.clip(m_f_, 0.0, 1.0)
        gm_f = np.clip(f32(0.6) + f32(qc["c08"]) * q(m_f_), 0.0, 1.6)
        fw = {
            "spread": np.clip(f32(p.base_spread) * mt_f
                              * (f32(0.35) + f32(qc["c065"])
                                 * q(np.clip(f_r_, 0.0, 1.0)))
                              * slope_f * wind_f, 0.0, 0.99),
            "light": f32(p.lightning_rate) * mt_f,
            "ignite": np.clip(f32(p.spotting_strength) * (f32(1.0) - m_f_)
                              * (f32(0.25) + f32(qc["c075"]) * q(f_r_)),
                              0.0, 0.95),
            "grow_e": f32(p.regrow_rate) * gm_f,
            "grow_a": f32(p.ash_regrow_rate) * gm_f,
        }
        return ref, fw, (m_r_, m_f_, f_r_)

    def traj(name, params_kw, seed, K, flip_budget, field_bound, note):
        p_fw = ffm.ModelParams(**params_kw)
        qc = ffm.quantized_consts(p_fw)
        m_r = ref_model.ForestFireModel(ref_model.ModelParams(**params_kw),
                                        seed=seed)
        m_f = ffm.ForestFireModel(p_fw, seed=seed)
        for m in (m_r, m_f):
            m.ignite_at(params_kw["w"] // 2, params_kw["h"] // 2, radius=3)
        shim = _FFReplay(m_r, p_fw, seed, ffm, fnoise, q12np)
        m_r.rng = shim
        sites = ("spread", "light", "ignite", "grow_e", "grow_a")
        site_ids = {"spread": ffm._S_SPREAD, "light": ffm._S_LIGHT,
                    "ignite": ffm._S_IGNITE, "grow_e": ffm._S_GROW_E,
                    "grow_a": ffm._S_GROW_A}
        flips = explained = ember_flips = 0
        stats_exact = 0
        moist_dev = fuel_dev = 0.0
        gap_max = 0.0
        for k in range(K):
            # resync: reference <- framework pre-step state, bit-identical
            s0 = m_f._np
            m_r.state = np.asarray(s0["state"], np.int8).copy()
            m_r.fuel = np.asarray(s0["fuel"], np.float32).copy()
            m_r.moisture = np.asarray(s0["moisture"], np.float32).copy()
            m_r.age = np.asarray(s0["age"], np.uint16).copy()
            m_r.elev = np.asarray(s0["elev"], np.float32).copy()
            state0 = m_r.state.copy()
            fuel0 = m_r.fuel.copy()
            moist0 = m_r.moisture.copy()
            shim.begin_step(k)
            rain_u = float(fnoise.uniform_np(
                np.uint32(seed), np.uint32(0),
                np.uint32(k) * np.uint32(ffm._SITES)
                + np.uint32(ffm._S_RAIN)))
            m_r.step()
            m_f.step()
            s1 = m_f._np
            if m_f.get_stats() == m_r.get_stats():
                stats_exact += 1
            diff = np.asarray(s1["state"]) != m_r.state
            nd = int(diff.sum())
            moist_dev = max(moist_dev, float(np.abs(
                np.asarray(s1["moisture"], np.float64)
                - m_r.moisture).max()))
            same = ~diff
            fuel_dev = max(fuel_dev, float(np.abs(
                np.asarray(s1["fuel"], np.float64)[same]
                - np.asarray(m_r.fuel, np.float64)[same]).max()))
            if nd == 0:
                continue
            flips += nd
            t_ref, t_fw, _ = _conv_thresholds(
                p_fw, qc, m_r.elev, state0, fuel0, moist0,
                rain_u < p_fw.rain_chance)
            draws = {s_: shim._u(site_ids[s_]) for s_ in sites}
            for s_ in sites:
                gap_max = max(gap_max, float(
                    np.abs(t_ref[s_] - t_fw[s_]).max()))
            for y, x in np.argwhere(diff):
                hit = False
                for s_ in sites:
                    lo = min(t_ref[s_][y, x], t_fw[s_][y, x]) - 1e-7
                    hi = max(t_ref[s_][y, x], t_fw[s_][y, x]) + 1e-7
                    if lo <= draws[s_][y, x] <= hi:
                        hit = True
                        break
                if hit:
                    explained += 1
                elif 2 in (int(s1["state"][y, x]), int(m_r.state[y, x])):
                    # FIRE on exactly one side, no marginal local draw:
                    # ember landing shifted by the q12 wind vector, or a
                    # shared-landing draw (forestfire.py:324-333)
                    ember_flips += 1
        cells = K * p_fw.h * p_fw.w
        unexplained = flips - explained - ember_flips
        field_db = 20.0 * np.log10(max(moist_dev, fuel_dev, 1e-12))
        ok = (flips <= flip_budget and unexplained == 0
              and field_db <= field_bound)
        rows.append(Row(
            name, field_db if ok else 0.0, field_bound,
            f"{flips} state flips / {cells} cell-steps "
            f"({explained} threshold-marginal, {ember_flips} ember-path, "
            f"{unexplained} unexplained; budget {flip_budget}); "
            f"max threshold gap {gap_max:.2e}; {stats_exact}/{K} "
            f"stats-exact; moisture/fuel per-step dev {field_db:.1f} dBFS; "
            f"{shim.collisions} landing collisions; {note}"))

    # (a) neutral terrain/wind: only the q12 rate constants differ
    traj("ff shadow-step [no wind/slope, 60 steps, injected draws]",
         dict(**kw_small, wind_strength=0.0, slope_strength=0.0,
              wind_dir_deg=0.0),
         seed=5, K=60, flip_budget=12, field_bound=-100.0,
         note="q12 rate constants only")
    # (b) wind+slope active, dir=0 keeps the wind vector exact (cos 0 = 1)
    traj("ff shadow-step [wind 0.75 + slope 0.35 @ 0 deg, 40 steps]",
         dict(**kw_small, wind_dir_deg=0.0),
         seed=5, K=40, flip_budget=12, field_bound=-100.0,
         note="q12 slope/wind boosts in spread_p")
    # (c) full defaults, 25 deg wind: q12(cos/sin) can shift ember landings
    traj("ff shadow-step [full defaults @ 25 deg wind, 30 steps]",
         dict(**kw_small), seed=5, K=30, flip_budget=12, field_bound=-100.0,
         note="q12 wind vector vs f64 cos/sin (documented)")

    # --- threshold rule engine vs watchers.py (injected clock) ---
    class _Clock:
        t = 0.0

        def perf_counter(self):
            return self.t

    clock = _Clock()
    ref_watchers.time = clock
    fw_eng = fw_rules.WatchEngine(now_fn=clock.perf_counter)
    ref_eng = ref_watchers.WatchEngine()
    rule_kw = [
        dict(metric_key="burning", op=">", threshold=40.0, hysteresis=5.0,
             edge="rising", cooldown_s=0.2, osc_address="/fire/burning_hi"),
        dict(metric_key="ignitions", op=">", threshold=3.0, edge="both",
             cooldown_s=0.0, osc_address="/fire/ignitions_spike",
             send_state=False),
        dict(metric_key="trees", op="band", threshold=800.0,
             threshold_hi=2000.0, hysteresis=20.0, edge="level",
             cooldown_s=0.5, osc_address="/fire/trees_band",
             send_value=False),
        dict(metric_key="rain", op=">", threshold=0.5, edge="falling",
             cooldown_s=0.0, osc_address="/fire/rain_end"),
    ]
    fw_eng.set_rules([fw_rules.ThresholdRule(**k) for k in rule_kw])
    ref_eng.set_rules([ref_watchers.ThresholdRule(**k) for k in rule_kw])
    stats_stream = ffm.stats_rows_to_dicts(m_fw.simulate(240))
    sent_fw, sent_ref = [], []
    leds_ok = True
    for row_ in stats_stream:
        clock.t += 1.0 / 30.0
        led_f = fw_eng.update(row_, lambda a, *p: sent_fw.append((a, p)))
        led_r = ref_eng.update(row_, lambda a, *p: sent_ref.append((a, p)))
        leds_ok = leds_ok and (led_f == led_r)
    ok = sent_fw == sent_ref and leds_ok and len(sent_fw) > 0
    rows.append(Row("ff WatchEngine rules -> OSC stream (240 steps)",
                    -200.0 if ok else 0.0, -200.0,
                    f"{len(sent_ref)} sends, LED states + payloads exact"))
    return rows


# ----------------------------------------------------------------------------
# Table / entry point
# ----------------------------------------------------------------------------

def print_rows(rows: list[Row], title: str):
    print(f"\n== {title} ==")
    bad = 0
    for r in rows:
        flag = "OK " if r.ok else "FAIL"
        print(f"  {r.name:<52} {r.dev_dbfs:9.1f} dBFS  "
              f"(bound {r.bound:7.1f})  {flag}  {r.note}")
        bad += 0 if r.ok else 1
    return bad


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--section", default="all")
    ap.add_argument("--long-seconds", type=float, default=0.0,
                    help="add a long-render patternlab stress row")
    ap.add_argument("--device", action="store_true",
                    help="run on JAX's default device; default is the CPU")
    args = ap.parse_args()
    if not args.device:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
    failures = 0
    if args.section in ("all", "kernels"):
        failures += print_rows(crossval_microsound_kernels(),
                               "Microsound kernels vs literal reference")
    if args.section in ("all", "microsound"):
        failures += print_rows(crossval_microsound_e2e(),
                               "Microsound e2e vs literal reference")
    if args.section in ("all", "microsound", "exactlen"):
        failures += print_rows(
            crossval_microsound_e2e_exactlen(),
            "Microsound e2e EXACT-LENGTH (reference-default micro_ms)")
    if args.section in ("all", "tape"):
        failures += print_rows(crossval_tape(),
                               "TapeTUC vs literal reference")
    if args.section in ("all", "scrub"):
        failures += print_rows(crossval_scrub(),
                               "Scrubber vs literal reference")
    if args.section in ("all", "patternlab"):
        failures += print_rows(
            crossval_patternlab(long_seconds=args.long_seconds),
            "Pattern Lab vs literal reference")
    if args.section in ("all", "grid"):
        failures += print_rows(crossval_grid(),
                               "Grid Audio vs literal reference")
    if args.section in ("all", "forestfire"):
        failures += print_rows(crossval_forestfire(),
                               "Forest Fire vs literal reference")
    if args.section == "benchlen":
        # crossval at the durations the bench scores.
        failures += print_rows(crossval_tape(bench_seconds=180.0),
                               "TapeTUC BENCH-LENGTH (180 s raw)")
        failures += print_rows(crossval_scrub(bench_seconds=30.0),
                               "Scrubber BENCH-LENGTH (30 s raw)")
        failures += print_rows(
            crossval_patternlab(long_seconds=64.0, long_only=True),
            "Pattern Lab BENCH-LENGTH (64 s)")
    print(f"\n{'ALL OK' if failures == 0 else f'{failures} FAILURES'}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
