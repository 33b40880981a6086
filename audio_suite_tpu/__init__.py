"""audio_suite_tpu — a JAX (XLA / Pallas / shard_map) rebuild of the
capabilities of the maetyu-d/audio-suite experimental-audio suite.

Layout (see SURVEY.md for the blueprint):

- ``utils``    : config dataclasses, WAV + preset I/O, PRNG streams, breakpoints
- ``ops``      : JAX/Pallas kernels — fixed-point varispeed prefix sums, fractional
                 gather, FFT filters/warps, envelopes, grain generators, physical
                 models, FM/PSG voices, CA stencil, overlap-add
- ``models``   : one render engine per reference app (tape, scrub, microsound,
                 patternlab, grid, forestfire)
- ``events``   : event-field schedulers, note events, threshold rules, OSC emitter
- ``plugins``  : host-side user-script API (generate/event contracts)
- ``parallel`` : mesh construction, sharded batch renderers (pjit / shard_map)
- ``cli``      : per-app command-line entry points

Design invariants:

1. No float64 on device (f32 throughput, and one dtype on every backend).
   All stateful *position*
   arithmetic (tape heads, grid phase accumulators) is exact int32 fixed point
   (:mod:`audio_suite_tpu.ops.fixq`), bit-identical to the NumPy oracles in
   ``oracles/``. Audio math is float32.
2. Static shapes everywhere under jit; data-dependent counts are capped and
   masked (mirroring the reference's own caps, e.g. ``max_grains``).
3. Randomness that must match the oracle is precomputed host-side with NumPy
   Generators and fed to kernels as arrays.
"""

__version__ = "0.1.0"
