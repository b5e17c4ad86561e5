"""Heightmap tiles (reference GenerateHeightMap, main.cpp:123-151;
planet_tpu ops/heightmap.py, ported).

A tile is a dim x dim grid of heights over a quad, sampled by planar
bilinear interpolation of the quad's 4 corners (the points are not
re-projected onto the sphere) with a 1-texel overscan border: u = (x - 1)
/ (dim - 3), so x in {0, dim - 1} lands outside [0, 1]. Corner layout:
corners[0], corners[1] span the u axis, corners[2], corners[3] the second
row:

    a = p0 + (p1 - p0) * u,  b = p2 + (p3 - p2) * u,  p = a + (b - a) * v

The f64 path is the specification (float64 tensors, bit-identical to the
oracle's tiles); the double-float path is the tile kernel's coordinate
blend (ops/kernels/tile_cuda.tile_coords, the same ops as planet_tpu's
tile_points_df) followed by the terrain's height_df through K4. The
engines generate tiles through K1 (tile_cuda.generate_tiles), which fuses
both; these functions are the library surface beside it.
"""

from __future__ import annotations

import numpy as np
import torch

from planet_tpu_torch.ops import perlin
from planet_tpu_torch.ops.kernels import tile_cuda


def tile_uv(dim: int) -> np.ndarray:
    """The overscan sampling coordinates (x - 1)/(dim - 3) of one axis, f64."""
    return (np.arange(dim, dtype=np.float64) - 1.0) * (1.0 / (dim - 3))


def tile_points_f64(corners, dim: int, device="cuda") -> torch.Tensor:
    """corners: (4, 3) f64 quad corners (a tensor stays on its device; an
    array goes to `device`) -> (dim, dim, 3) f64 sample points, [y, x]."""
    corners = perlin.as_f64(corners, device)
    div = float(np.float64(1.0) / np.float64(dim - 3))
    x = torch.arange(dim, dtype=torch.float64, device=corners.device)
    u = (x - 1.0) * div
    p0, p1, p2, p3 = corners[0], corners[1], corners[2], corners[3]
    v0 = p1 - p0
    v1 = p3 - p2
    a = p0[None, :] + v0[None, :] * u[:, None]          # (dim, 3) along x
    b = p2[None, :] + v1[None, :] * u[:, None]
    v2 = b - a
    return a[None, :, :] + v2[None, :, :] * u[:, None, None]


def tile_points_df(corners_hi, corners_lo, dim: int):
    """Double-float sample points of one tile: corners_hi/lo (4, 3) f32
    pairs (the exact split of the f64 corners) -> three (hi, lo) pairs of
    (dim, dim) tensors, the x, y and z components, [y, x]."""
    c = tile_cuda.tile_coords(corners_hi[None], corners_lo[None], dim)
    return tuple((c[2 * k][0], c[2 * k + 1][0]) for k in range(3))


def generate_tile_f64(corners, dim: int, terrain, depth: int,
                      max_depth: int, device="cuda") -> torch.Tensor:
    """Specification path: one (dim, dim) f32 tile from f64 corners (on
    their device if a tensor, else on `device`)."""
    return terrain.height_f64(tile_points_f64(corners, dim, device), depth,
                              max_depth)


def generate_tile_df(corners_hi, corners_lo, dim: int, terrain, depth: int,
                     max_depth: int) -> torch.Tensor:
    """Double-float path: one (dim, dim) f32 tile, heights through K4."""
    px, py, pz = tile_points_df(corners_hi, corners_lo, dim)
    return terrain.height_df(px, py, pz, depth, max_depth)


def generate_tiles_df(corners_hi, corners_lo, dim: int, terrain, depth: int,
                      max_depth: int) -> torch.Tensor:
    """Batched tiles at one depth: (N, 4, 3) f32 corner pairs -> (N, dim,
    dim), one K4 launch for the batch."""
    c = tile_cuda.tile_coords(corners_hi, corners_lo, dim)
    return terrain.height_df((c[0], c[1]), (c[2], c[3]), (c[4], c[5]),
                             depth, max_depth)
