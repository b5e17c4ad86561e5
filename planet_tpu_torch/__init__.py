"""PyTorch + hand-written CUDA port of planet_tpu.

Mirrors planet_tpu's sub-package layout module for module. Host-side
state (LOD refinement, the tile-cache index, uint64 quad ids) stays numpy
exactly as in planet_tpu; tiles, tessellation and the raster run on the
engine's torch device; the cube-sphere field (models/heightfield) runs
whole on the device. On a CUDA device every kernel of a path is a
hand-written CUDA C++ kernel (planet_tpu_torch/csrc, built by _cuda.py);
on a CPU device the same entry points run their plain PyTorch versions.
The package imports neither jax nor planet_tpu: the numpy-only modules
it needs are copied into it.
"""
