"""PyTorch and CUDA port of the `repro` package, for an NVIDIA H100.

The JAX package `repro` stays the reference; this package keeps its
module names and array layouts and imports neither it nor JAX.  Entry
points (`core.predictor.Predictor.build`, `serving.engine.GBDTServer`)
run on the card unless the caller passes ``device="cpu"``.  The kernels
of the serving path are hand-written CUDA C++ in `kernels/csrc/`, built
with nvcc at first use.
"""
