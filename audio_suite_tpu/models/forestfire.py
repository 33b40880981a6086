"""Forest Fire CA engine — the reference's fuel/moisture/wind/terrain/ember
cellular automaton (forest_fire_OSC_0.1/model.py) as a jit-compiled
stencil with lax.scan over steps.

Design (SURVEY.md §7 decision 5):
- initialization stays host NumPy and is REFERENCE-EXACT (same
  np.random.default_rng(seed) draw order as model.py:74-96);
- the per-step randomness becomes counter-based noise (ops/noise.py) keyed
  by (seed, cell, step*site) — embarrassingly parallel, bit-identical
  between the device kernel and the NumPy oracle;
- the 8-neighbour spread mask is a roll-stencil (model.py:146-153), ember
  spotting is a full-grid masked scatter (every cell computes its landing,
  non-emitting cells contribute nothing — uniform work instead of argwhere,
  model.py:176-196);
- every multiply that feeds an add uses operands rounded to 12-bit
  significands (ops/fixq.round_sig12), making the product EXACT in f32:
  XLA's FMA contraction (which neither optimization_barrier nor bitcasts
  block — verified empirically) then cannot change any rounding, so the
  device trajectory is bit-identical to the NumPy oracle on every backend.
  The <=2**-12 relative perturbation of rates/boosts is documented
  framework semantics (same discipline as the tape position math);
- simulate() scans N steps on device and streams per-step stats back as
  arrays (the metric stream feeding events/rules.py thresholds -> OSC).

Interactive brush edits (ignite/set-tree/clear, model.py:224-258) operate on
the host-side state mirror.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import noise
from ..ops.fixq import round_sig12, round_sig12_np

EMPTY, TREE, FIRE, ASH = 0, 1, 2, 3

# per-step noise stream sites (uniform sites; normals get _NRM_OFFSET)
_SITES = 16
_S_RAIN, _S_SPREAD, _S_LIGHT, _S_EMIT, _S_DIST, _S_IGNITE, _S_GROW_E, \
    _S_GROW_A, _S_FUEL_E, _S_FUEL_A = range(10)
_S_JX, _S_JY = 10, 11
_NRM_OFFSET = 1 << 20
EMBER_CAP = 1024    # max emitting cells whose embers land per step


@dataclass(unsafe_hash=True)
class ModelParams:
    """(model.py:12-46).  unsafe_hash: instances key the jit cache in
    _sim_fn; treat them as immutable after first use."""
    w: int = 220
    h: int = 160
    p_tree_init: float = 0.62
    lightning_rate: float = 3e-6
    base_spread: float = 0.37
    fuel_burn_rate: float = 0.18
    burnout_fuel: float = 0.05
    ember_rate: float = 0.035
    ember_max_dist: int = 18
    spotting_strength: float = 0.9
    regrow_rate: float = 0.006
    ash_regrow_rate: float = 0.003
    moisture_relax: float = 0.01
    rain_chance: float = 0.015
    rain_strength: float = 0.25
    wind_dir_deg: float = 25.0
    wind_strength: float = 0.75
    slope_strength: float = 0.35
    show_moisture_overlay: bool = False
    # fast_noise=True fuses the per-cell draw sites (16-bit uniform pairs
    # + byte-sliced Irwin-Hall(4) ember jitter, ops/noise.py): ~4x less
    # hash work per cell-step at large grids.  Its own documented stream
    # family — trajectories differ from the default mode (both are
    # framework semantics; the reference's RNG differs from either), and
    # the NumPy oracle twins both bit-exactly.
    fast_noise: bool = False

    def wind_vec(self):
        ang = np.deg2rad(self.wind_dir_deg)
        return float(np.float32(np.cos(ang))), float(np.float32(np.sin(ang)))

    def static_key(self) -> tuple:
        return (self.w, self.h, self.lightning_rate, self.base_spread,
                self.fuel_burn_rate, self.burnout_fuel, self.ember_rate,
                self.ember_max_dist, self.spotting_strength,
                self.regrow_rate, self.ash_regrow_rate, self.moisture_relax,
                self.rain_chance, self.rain_strength, self.wind_dir_deg,
                self.wind_strength, self.slope_strength, self.fast_noise)


def quantized_consts(params: ModelParams) -> dict:
    """Rate/boost constants rounded to 12-bit significands (shared by the
    device kernel and the NumPy oracle)."""
    q = lambda v: float(round_sig12_np(np.float32(v)))
    wx, wy = params.wind_vec()
    return {
        "relax": q(params.moisture_relax),
        "c020": q(0.20),
        "slope": q(params.slope_strength),
        "wind": q(params.wind_strength),
        "c06": q(0.6),
        "c065": q(0.65),
        "c075": q(0.75),
        "c08": q(0.8),
        "c03": q(0.3),
        "c035n": q(0.35),
        "c0005": q(0.005),
        "wx": q(wx),
        "wy": q(wy),
        "sig": q(1.25 + 1.4 * params.wind_strength),
    }


def init_state(params: ModelParams, seed: int = 1) -> dict:
    """Reference-exact initialization (model.py:74-96, same rng stream)."""
    p = params
    rng = np.random.default_rng(seed)
    shape = (p.h, p.w)

    state = np.zeros(shape, np.int8)
    trees = rng.random(shape) < p.p_tree_init
    state[trees] = TREE

    fuel = np.zeros(shape, np.float32)
    fuel[trees] = rng.uniform(0.75, 1.0, size=int(trees.sum())) \
        .astype(np.float32)

    base = _smooth_noise(rng, shape, 3)
    base = 0.15 + 0.55 * base
    jitter = rng.normal(0.0, 0.06, size=shape).astype(np.float32)
    moisture = np.clip(base + jitter, 0.0, 1.0).astype(np.float32)

    hills = _smooth_noise(rng, shape, 4)
    # 12-bit significand so terrain-gradient products are exact (see module
    # docstring)
    elev = round_sig12_np((hills ** 1.7).astype(np.float32))

    return {
        "state": state.astype(np.int32),
        "fuel": fuel,
        "moisture": moisture,
        "elev": elev,
        "age": np.zeros(shape, np.int32),
        "t": np.int32(0),
    }


def _smooth_noise(rng, shape, blur_iters: int) -> np.ndarray:
    """9-point box blur noise (model.py:101-115)."""
    x = rng.random(shape).astype(np.float32)
    for _ in range(int(blur_iters)):
        x = (x
             + np.roll(x, 1, 0) + np.roll(x, -1, 0)
             + np.roll(x, 1, 1) + np.roll(x, -1, 1)
             + np.roll(np.roll(x, 1, 0), 1, 1)
             + np.roll(np.roll(x, 1, 0), -1, 1)
             + np.roll(np.roll(x, -1, 0), 1, 1)
             + np.roll(np.roll(x, -1, 0), -1, 1)
             ) / 9.0
    mn, mx = float(x.min()), float(x.max())
    if mx - mn < 1e-6:
        return np.zeros(shape, np.float32)
    return (x - mn) / (mx - mn)


def _roll_or8(m):
    """8-neighbour OR stencil (model.py:146-153)."""
    return (jnp.roll(m, 1, 0) | jnp.roll(m, -1, 0)
            | jnp.roll(m, 1, 1) | jnp.roll(m, -1, 1)
            | jnp.roll(jnp.roll(m, 1, 0), 1, 1)
            | jnp.roll(jnp.roll(m, 1, 0), -1, 1)
            | jnp.roll(jnp.roll(m, -1, 0), 1, 1)
            | jnp.roll(jnp.roll(m, -1, 0), -1, 1))


def terrain_static(params: ModelParams, elev):
    """Step-invariant terrain fields (elev never changes): the gradient/
    wind dot product, uphill slope boost and wind boost, hoisted out of the
    per-step scan.  Same f32 values the oracle computes per step."""
    p = params
    qc = quantized_consts(p)
    q12 = round_sig12
    wx, wy = jnp.float32(qc["wx"]), jnp.float32(qc["wy"])
    gy, gx = jnp.gradient(elev)
    dot = q12(gx) * wx + q12(gy) * wy
    uphill = jnp.clip(-dot, 0.0, 1.0)
    slope_boost = jnp.float32(1.0) + jnp.float32(qc["slope"]) * q12(uphill)
    wind_clip = jnp.clip(dot + jnp.float32(0.5), 0.0, 1.0)
    wind_boost = jnp.float32(1.0) + q12(jnp.float32(qc["wind"])
                                        * wind_clip) * jnp.float32(qc["c06"])
    baseline = jnp.clip(jnp.float32(0.45)
                        - jnp.float32(qc["c020"]) * elev, 0.05, 0.7)
    return {"slope_boost": slope_boost, "wind_boost": wind_boost,
            "baseline": baseline}


class DenseSpatial:
    """Spatial coupling of the CA step on one device (the default).

    step_device routes everything that reaches OUTSIDE a cell's own row
    block through this adapter — the global cell-index grid that keys the
    counter-based RNG, the 8-neighbour stencil, the ember candidate
    selection + arrival scatter, and the stat reductions — so
    parallel/ca.py can swap in a row-sharded implementation (ppermute
    halos, all_gather'd ember candidates, psum stats) while every
    per-cell arithmetic op stays THE SAME CODE: the sharded trajectory is
    bit-identical to this one by construction."""

    def cells(self, H: int, W: int):
        """Global cell-index grid [H, W] (uint32) for the RNG streams."""
        return jnp.arange(H * W, dtype=jnp.uint32).reshape(H, W)

    def rows(self, H: int):
        """Global row-index column [H, 1] (int32) for ember landings."""
        return jnp.arange(H, dtype=jnp.int32)[:, None]

    def roll_or8(self, m):
        return _roll_or8(m)

    def ember_arrivals(self, emit, lin, H: int, W: int):
        """Ember arrival mask from the emit mask and per-cell landing
        indices (global linear).  Returns bool [H, W].

        Emitters are sparse (ember_rate * fire cells); a dense 35k-index
        scatter pays per index on every step.  Compact
        emitters to EMBER_CAP slots via top_k over their linear indices
        (largest first; deterministic, mirrored by the oracle) and
        scatter only those.  The cap binds only if >EMBER_CAP cells emit
        in one step — >83% of the grid simultaneously burning at default
        params."""
        key = jnp.where(emit.reshape(-1),
                        jnp.arange(H * W, dtype=jnp.int32), -1)
        sel, _ = jax.lax.top_k(key, min(EMBER_CAP, H * W))
        ok_sel = sel >= 0
        land = lin.reshape(-1)[jnp.clip(sel, 0, H * W - 1)]
        arrivals = jnp.zeros(H * W, jnp.int32).at[land].add(
            ok_sel.astype(jnp.int32))
        return (arrivals > 0).reshape(H, W)

    def rsum(self, x):
        """Grid-wide int32 sum (psum over the mesh axis when sharded)."""
        return jnp.sum(x.astype(jnp.int32))


_DENSE_SPATIAL = DenseSpatial()


def step_device(carry, step_idx, params: ModelParams, seed: int,
                terrain: dict | None = None,
                spatial: DenseSpatial | None = None):
    """One CA step (model.py:121-222) on device.  Returns (carry', stats).

    `spatial` (default DenseSpatial) supplies every spatially-coupled
    piece; parallel/ca.py passes its row-sharded adapter here."""
    p = params
    H, W = p.h, p.w
    sp = spatial if spatial is not None else _DENSE_SPATIAL
    state, fuel, moisture, elev, age = (carry["state"], carry["fuel"],
                                        carry["moisture"], carry["elev"],
                                        carry["age"])
    cells = sp.cells(H, W)
    base_stream = step_idx.astype(jnp.uint32) * jnp.uint32(_SITES)

    def u(site, idx=None):
        return noise.uniform(jnp.uint32(seed),
                             cells if idx is None else idx,
                             base_stream + jnp.uint32(site))

    def nrm(site):
        return noise.normal(jnp.uint32(seed), cells,
                            base_stream + jnp.uint32(_NRM_OFFSET + 0)
                            + jnp.uint32(site))

    qc = quantized_consts(p)
    q12 = round_sig12
    wx, wy = jnp.float32(qc["wx"]), jnp.float32(qc["wy"])

    # per-cell randomness, hoisted: 10 draw sites + 2 jitter normals.
    # fast_noise=True fuses them — each 16-bit uniform_pair serves TWO
    # sites from one hash and the ember jitter drops from Irwin-Hall(12)
    # to byte-sliced Irwin-Hall(4), cutting per-cell hash mixes 32 -> 7.
    # Lightning keeps its own 24-bit draw in BOTH modes: its rate (~3e-6)
    # is below 16-bit granularity.  The draws are pure in (seed, step,
    # cell), so hoisting is semantics-free; the NumPy oracle mirrors both
    # branches bit-exactly (oracles/forestfire_ref.py).
    if p.fast_noise:
        d_spread, d_emit = noise.uniform_pair(
            jnp.uint32(seed), cells, base_stream + jnp.uint32(_S_SPREAD))
        d_ignite, d_dist = noise.uniform_pair(
            jnp.uint32(seed), cells, base_stream + jnp.uint32(_S_IGNITE))
        d_grow_e, d_grow_a = noise.uniform_pair(
            jnp.uint32(seed), cells, base_stream + jnp.uint32(_S_GROW_E))
        d_fuel_e, d_fuel_a = noise.uniform_pair(
            jnp.uint32(seed), cells, base_stream + jnp.uint32(_S_FUEL_E))
        jx_raw = noise.normal_ih4(
            jnp.uint32(seed), cells,
            base_stream + jnp.uint32(_NRM_OFFSET + _S_JX))
        jy_raw = noise.normal_ih4(
            jnp.uint32(seed), cells,
            base_stream + jnp.uint32(_NRM_OFFSET + _S_JY))
    else:
        d_spread, d_emit = u(_S_SPREAD), u(_S_EMIT)
        d_ignite, d_dist = u(_S_IGNITE), u(_S_DIST)
        d_grow_e, d_grow_a = u(_S_GROW_E), u(_S_GROW_A)
        d_fuel_e, d_fuel_a = u(_S_FUEL_E), u(_S_FUEL_A)
        jx_raw, jy_raw = nrm(_S_JX), nrm(_S_JY)
    d_light = u(_S_LIGHT)

    # rain (scalar per step)
    rain = noise.uniform(jnp.uint32(seed), jnp.uint32(0),
                         base_stream + jnp.uint32(_S_RAIN)) \
        < jnp.float32(p.rain_chance)
    moisture = jnp.where(rain,
                         jnp.clip(moisture + jnp.float32(p.rain_strength),
                                  0.0, 1.0),
                         moisture)

    if terrain is None:
        terrain = terrain_static(p, elev)

    # moisture relax toward elevation baseline (all multiplies exact:
    # 12-bit x 12-bit significands)
    moisture = moisture + jnp.float32(qc["relax"]) \
        * q12(terrain["baseline"] - moisture)
    moisture = jnp.clip(moisture, 0.0, 1.0)

    # burning consumes fuel -> ash
    burning = state == FIRE
    fuel = jnp.where(burning,
                     jnp.clip(fuel - jnp.float32(p.fuel_burn_rate), 0.0, 1.0),
                     fuel)
    state = jnp.where(burning & (fuel <= jnp.float32(p.burnout_fuel)),
                      ASH, state)

    # neighbourhood fire mask
    fire = state == FIRE
    fire_n = sp.roll_or8(fire)
    trees = state == TREE

    # terrain + wind bias: hoisted (terrain_static)
    slope_boost = terrain["slope_boost"]
    wind_boost = terrain["wind_boost"]

    fuel_term = jnp.clip(fuel, 0.0, 1.0)
    moist_term = jnp.float32(1.0) - jnp.clip(moisture, 0.0, 1.0)
    spread_p = (jnp.float32(p.base_spread) * moist_term
                * (jnp.float32(0.35)
                   + jnp.float32(qc["c065"]) * q12(fuel_term))
                * slope_boost * wind_boost)
    spread_p = jnp.clip(spread_p, 0.0, 0.99)

    will_spread = trees & fire_n & (d_spread < spread_p)
    lightning = trees & (d_light
                         < jnp.float32(p.lightning_rate) * moist_term)
    ignitions = will_spread | lightning

    # ember spotting: every cell computes its landing; non-emitters masked.
    # Ignition is evaluated at the LANDING cell from its own fields and its
    # own rng draw (destination-draw) — the arrival scatter is the only
    # per-index op; a source-side evaluation needs a 35k-element gather of
    # (moisture, fuel, state) at the landings.  Semantics vs the reference (model.py:176-196, per-ember
    # Bernoulli at the landing): identical unless >=2 embers land on one
    # cell in one step, where one shared draw replaces independent draws —
    # a statistically negligible, documented framework choice (reference
    # parity is statistical anyway: different RNG).
    emit = fire & (d_emit < jnp.float32(p.ember_rate))
    d = (jnp.float32(3.0)
         + jnp.floor(d_dist
                     * jnp.float32(p.ember_max_dist + 1 - 3)))
    sig = jnp.float32(qc["sig"])
    jx = q12(jx_raw) * sig     # exact: 12x12-bit significands
    jy = q12(jy_raw) * sig
    dx = (wx * d + jx).astype(jnp.int32)   # wx*d exact: 12-bit x small int
    dy = (wy * d + jy).astype(jnp.int32)
    yi = sp.rows(H)
    xi = jnp.arange(W, dtype=jnp.int32)[None, :]
    yy = jnp.mod(yi + dy, H)
    xx = jnp.mod(xi + dx, W)
    lin = yy * W + xx
    arrived = sp.ember_arrivals(emit, lin, H, W)
    p_ember = jnp.clip(
        jnp.float32(p.spotting_strength)
        * (jnp.float32(1.0) - moisture)
        * (jnp.float32(0.25) + jnp.float32(qc["c075"]) * q12(fuel)),
        0.0, 0.95)
    ember_ignitions = arrived & trees & (d_ignite < p_ember)

    ignitions = ignitions | ember_ignitions
    n_ignitions = sp.rsum(ignitions)
    n_embers = sp.rsum(emit)
    state = jnp.where(ignitions, FIRE, state)

    # regrowth
    empty = state == EMPTY
    ash = state == ASH
    grow_mod = jnp.clip(jnp.float32(0.6)
                        + jnp.float32(qc["c08"]) * q12(moisture), 0.0, 1.6)
    regrow_empty = empty & (d_grow_e
                            < jnp.float32(p.regrow_rate) * grow_mod)
    regrow_ash = ash & (d_grow_a
                        < jnp.float32(p.ash_regrow_rate) * grow_mod)

    fuel_new_e = jnp.float32(0.5) + jnp.float32(qc["c03"]) * q12(d_fuel_e)
    fuel_new_a = jnp.float32(0.55) \
        + jnp.float32(qc["c035n"]) * q12(d_fuel_a)
    state = jnp.where(regrow_empty | regrow_ash, TREE, state)
    fuel = jnp.where(regrow_empty, fuel_new_e, fuel)
    fuel = jnp.where(regrow_ash, fuel_new_a, fuel)
    age = jnp.where(regrow_empty | regrow_ash, 0, age)

    trees2 = state == TREE
    age = jnp.where(trees2, jnp.clip(age + 1, 0, 65535), age)
    fuel = jnp.where(trees2,
                     jnp.clip(fuel + (jnp.float32(0.003)
                                      + jnp.float32(qc["c0005"])
                                      * q12(moisture)),
                              0.0, 1.0),
                     fuel)

    carry = {"state": state, "fuel": fuel, "moisture": moisture,
             "elev": elev, "age": age, "t": carry["t"] + 1}
    stats = jnp.stack([
        carry["t"],
        sp.rsum(state == TREE),
        sp.rsum(state == FIRE),
        sp.rsum(state == ASH),
        sp.rsum(state == EMPTY),
        n_ignitions,
        n_embers,
        rain.astype(jnp.int32),
    ])
    return carry, stats


STAT_KEYS = ("t", "trees", "burning", "ash", "empty", "ignitions",
             "embers", "rain")


@lru_cache(maxsize=16)
def _sim_fn(key: tuple, seed: int, n_steps: int, params: ModelParams):
    del key

    def run(carry):
        t0 = carry["t"]
        terrain = terrain_static(params, carry["elev"])
        carry, stats = jax.lax.scan(
            lambda c, k: step_device(c, t0 + k, params, seed, terrain),
            carry, jnp.arange(n_steps, dtype=jnp.int32),
            unroll=4)
        return carry, stats

    return jax.jit(run)


class ForestFireModel:
    """Host wrapper mirroring the reference API (model.py:49-271): step(),
    get_stats(), brush edits, render_rgb; steps run on device (singly or
    batched via simulate())."""

    def __init__(self, params: ModelParams, seed: int = 1):
        if params.w < 2 or params.h < 2:
            # terrain slope/wind boosts need a gradient (model.py:79-83);
            # fail clearly instead of np.gradient's obscure ValueError
            raise ValueError("forest-fire grid must be at least 2x2, got "
                             f"{params.w}x{params.h}")
        self.params = params
        self.seed = int(seed)
        self._state = init_state(params, seed)   # np arrays OR device arrays
        self._last = np.zeros(8, np.int64)

    # -- simulation --------------------------------------------------------

    @property
    def _np(self):
        """Writable host view of the state (brush edits, rgb, stats).
        After simulate() the state lives on DEVICE — pulling all six
        fields eagerly costs six device->host transfers per simulate;
        materialize lazily, and only copy (np.asarray of a device buffer
        is a read-only view that breaks brush edits)."""
        if any(not isinstance(v, np.ndarray) for v in self._state.values()
               if not np.isscalar(v)):
            import jax

            jax.block_until_ready(self._state)
            self._state = {k: np.array(v) for k, v in self._state.items()}
        return self._state

    def _carry(self):
        # device arrays pass straight back into the next simulate call (no
        # h2d); host NumPy transfers bundled with the jitted call
        return dict(self._state)

    def simulate(self, n_steps: int) -> np.ndarray:
        """Run n_steps on device (lax.scan); returns stats [n_steps, 8]
        (columns = STAT_KEYS).  The carry stays device-resident between
        calls; host access (stats/edits/rgb) materializes it lazily."""
        fn = _sim_fn(self.params.static_key(), self.seed, int(n_steps),
                     self.params)
        self._state, stats = fn(self._carry())
        stats = np.asarray(stats)
        if len(stats):
            self._last = stats[-1].astype(np.int64)
            # make cap-binding runs visible: the ember scatter compacts
            # emitters to EMBER_CAP slots per step (top_k by linear index);
            # if more cells emitted, low-index emitters were dropped that
            # step and the trajectory deviates from the uncapped semantics
            max_embers = int(stats[:, 6].max())
            if max_embers > EMBER_CAP:
                warnings.warn(
                    f"forestfire: {max_embers} emitting cells in one step "
                    f"exceeds EMBER_CAP={EMBER_CAP}; lowest-index emitters "
                    "were dropped for that step", RuntimeWarning)
        return stats

    def step(self):
        self.simulate(1)

    def reset(self):
        self._state = init_state(self.params, self.seed)
        self._last = np.zeros(8, np.int64)

    randomize = reset

    def get_stats(self) -> dict:
        s = self._np["state"]
        return {
            "t": int(self._np["t"]),
            "trees": int((s == TREE).sum()),
            "burning": int((s == FIRE).sum()),
            "ash": int((s == ASH).sum()),
            "empty": int((s == EMPTY).sum()),
            "ignitions": int(self._last[5]),
            "embers": int(self._last[6]),
            "rain": int(self._last[7]),
        }

    # -- interactive edits (model.py:224-258) -------------------------------

    def _brush(self, x, y, radius):
        H, W = self._np["state"].shape
        rr = max(0, int(radius))
        ys = np.arange(y - rr, y + rr + 1) % H
        xs = np.arange(x - rr, x + rr + 1) % W
        Y, X = np.meshgrid(ys, xs, indexing="ij")
        mask = (X - x) ** 2 + (Y - y) ** 2 <= rr * rr
        return Y[mask], X[mask]

    def ignite_at(self, x: int, y: int, radius: int = 2):
        yy, xx = self._brush(x, y, radius)
        can = self._np["state"][yy, xx] == TREE
        self._np["state"][yy[can], xx[can]] = FIRE

    def set_tree_at(self, x: int, y: int, radius: int = 2):
        yy, xx = self._brush(x, y, radius)
        self._np["state"][yy, xx] = TREE
        self._np["fuel"][yy, xx] = np.clip(
            self._np["fuel"][yy, xx] + 0.5, 0.0, 1.0)

    def clear_at(self, x: int, y: int, radius: int = 2):
        yy, xx = self._brush(x, y, radius)
        self._np["state"][yy, xx] = EMPTY
        self._np["fuel"][yy, xx] = 0.0

    # -- rendering (model.py:273-309) ---------------------------------------

    def render_rgb(self) -> np.ndarray:
        s = self._np["state"]
        m = self._np["moisture"]
        f = self._np["fuel"]
        e = self._np["elev"]
        H, W = s.shape
        rgb = np.zeros((H, W, 3), np.uint8)

        empty = s == EMPTY
        tree = s == TREE
        fire = s == FIRE
        ash = s == ASH

        rgb[empty] = (18, 16, 16)
        g = (70 + 120 * (0.6 * f + 0.4 * m)).astype(np.uint8)
        r = (20 + 40 * (0.6 * m)).astype(np.uint8)
        b = (18 + 30 * (0.35 * m)).astype(np.uint8)
        rgb[tree, 0] = r[tree]
        rgb[tree, 1] = g[tree]
        rgb[tree, 2] = b[tree]

        inten = np.clip(0.3 + 0.7 * f, 0.0, 1.0)
        rr = (180 + 75 * inten).astype(np.uint8)
        gg = (70 + 120 * inten).astype(np.uint8)
        bb = (15 + 30 * inten).astype(np.uint8)
        rgb[fire, 0] = rr[fire]
        rgb[fire, 1] = gg[fire]
        rgb[fire, 2] = bb[fire]

        a = (70 + 80 * e).astype(np.uint8)
        rgb[ash] = np.stack([a, a, a], axis=-1)[ash]

        if self.params.show_moisture_overlay:
            overlay = (m * 255).astype(np.uint8)
            rgb[..., 2] = np.maximum(rgb[..., 2], overlay // 2)
        return rgb


def stats_rows_to_dicts(stats: np.ndarray) -> list[dict]:
    """[n, 8] device stats -> list of reference-style stats dicts."""
    return [dict(zip(STAT_KEYS, (int(v) for v in row))) for row in stats]
