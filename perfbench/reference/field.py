"""The plain reference of the whole-cube field regen: the frozen plain
version of K5 (reference/frozen/ops/kernels/field_cuda.field_plain: each
texel's double-float position on the sphere, the noise core's ridged
octaves, the edge-replicated central-difference normal and the Lambert
shade), computed in bands of rows on the given device.

`f32_control=True` computes it with every double-float operation narrowed
to float32: the precision below the configuration's, the correctness
check's control."""

from __future__ import annotations

import torch

from perfbench.reference.frozen.ops.kernels import field_cuda
from perfbench.reference.lod import narrowed


def field(n: int, radius: float, settings: dict, device,
          f32_control: bool = False):
    """(heights, shade), each (6, n, n) f32, for the noise settings
    (kind, octaves, lacunarity, gain, coord_scale, amplitude)."""
    with narrowed(f32_control), torch.no_grad():
        return field_cuda.field_plain(n, radius, device=torch.device(device),
                                      **settings)
