"""
mdproptools_tpu: a JAX (XLA + a Pallas pair kernel for the GPU)
molecular-dynamics trajectory-analysis engine with the capabilities of
molmd/mdproptools.

Layer map (bottom to top):
  io/         streaming LAMMPS dump / thermo-log / XYZ / PDB parsers
              (own code; optional C++ fast path in native/)
  common/     unit registries and the System topology dataclass
  ops/        device kernels: minimum-image PBC, pair histograms (the
              GPU pair kernel + the plain XLA path), segment-sum COM, batched
              Wiener-Khinchin FFT correlators, host-side fits (OLS,
              curve_fit wrappers)
  structural/ RDF, coordination numbers, clusters, hydration, number density
  dynamical/  MSD/diffusion, GK conductivity, GK viscosity, residence time
  utilities/  log concat, plot styling, fluctuation stats
  parallel/   jax.sharding mesh helpers; frame-sharded pjit wrappers

The public API mirrors the reference package (function/class names,
argument names and defaults, output DataFrame schemas and CSV artifact
names), so a user of mdproptools can switch imports and keep their
notebooks. Internals are array-first and jit-compiled, not pandas loops.

Precision policy: every device op takes ``precision={"fast","strict"}``.
``fast`` runs float32 (the speed path; the GPU pair kernel still bins
in float64); ``strict`` runs float64
(bit-parity with the reference's NumPy math; used by the test suite).
"""

from mdproptools_tpu.utilities.host import tune_malloc_for_streaming as _tune

_tune()  # heap-recycle block buffers (see utilities/host.py)
del _tune

from mdproptools_tpu import common, dynamical, io, ops, parallel, structural, utilities
from mdproptools_tpu.pipeline import analyze

__version__ = "0.5.0"
