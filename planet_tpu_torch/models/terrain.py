"""Terrain height generators, the reference's heightmap functors (planet_tpu
models/terrain.py, ported).

``RidgedTerrain`` is the production generator (reference main.cpp:823-833):

    octaves = 6 + 12 * depth / max_depth     (C integer division)
    p *= 0.00001
    height = PerlinRidged(p, lacunarity=2.0, gain=0.55f, octaves) * 8848.0f

``ConstantZeroTerrain`` is the smooth-sphere test generator
(main.cpp:836-841). Both have the f64 specification path (`height_f64`, on
float64 tensors, bit-identical to the oracle) and the double-float path
(`height_df`, through K4: ops/kernels/perlin_cuda.noise_df). The fields
carry across from planet_tpu with `dataclasses.asdict`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.ops import perlin


def octave_count(depth: int, max_depth: int) -> int:
    """6 + 12*depth/max_depth with C integer division (main.cpp:827)."""
    return 6 + (12 * int(depth)) // int(max_depth)


def _scale_df(p, scale: float):
    """(hi, lo) times the double-float constant `scale` (DF multiply)."""
    hi = np.float32(scale)
    lo = np.float32(np.float64(scale) - np.float64(hi))
    return dfm.mul(p, (dfm.const(hi, p[0]), dfm.const(lo, p[0])))


@dataclasses.dataclass(frozen=True)
class RidgedTerrain:
    lacunarity: float = 2.0
    gain: float = float(np.float32(0.55))
    coord_scale: float = 0.00001
    amplitude: float = 8848.0

    def height_f64(self, p, depth: int, max_depth: int,
                   device="cuda") -> torch.Tensor:
        """p: (..., 3) float64 world positions (a tensor stays on its
        device; an array goes to `device`). Returns f32 heights."""
        p = perlin.as_f64(p, device) * float(self.coord_scale)
        h = perlin.ridged_f64(p[..., 0], p[..., 1], p[..., 2],
                              lacunarity=self.lacunarity,
                              gain=np.float32(self.gain),
                              octaves=octave_count(depth, max_depth))
        return h * float(np.float32(self.amplitude))

    def height_df(self, px, py, pz, depth: int, max_depth: int):
        """px, py, pz: (hi, lo) f32 world positions of one shape. Returns
        f32 heights, through K4."""
        px, py, pz = (tuple(t.contiguous() for t in _scale_df(c,
                                                              self.coord_scale))
                      for c in (px, py, pz))
        h = perlin.ridged_df(px, py, pz, lacunarity=self.lacunarity,
                             gain=np.float32(self.gain),
                             octaves=octave_count(depth, max_depth))
        return h * float(np.float32(self.amplitude))


@dataclasses.dataclass(frozen=True)
class ConstantZeroTerrain:
    def height_f64(self, p, depth: int, max_depth: int,
                   device="cuda") -> torch.Tensor:
        p = perlin.as_f64(p, device)
        return torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)

    def height_df(self, px, py, pz, depth: int, max_depth: int):
        return torch.zeros_like(px[0], dtype=torch.float32)
