"""The vertex program and its shade, plain (V1's version):

* tessellate_shaded_plain(corners_rel, corner_normals, tiles, variant_x,
  variant_y, skirt_size, view_proj, grid=mesh.GRID) ->
  (vertex.PatchVertices, vertex_shade (Q, G, G)): vertex.tessellate_blend
  and `lambert`, raster/shade.lambert with its sums written out in a
  pinned order;
* tessellate_rows_plain(q_lo, q_hi, crop, depth, corners_hi, corners_lo,
  cam_hi, cam_lo, max_skirt, tiles, view_proj, grid=mesh.GRID) -> the
  same from the rows (the fused step's form): uniforms_plain, then
  tessellate_shaded_plain.

A row whose corner normals hold a NaN (the fused frame's padding rows
past its leaf count) comes out NaN in every output but the height.
"""

from __future__ import annotations

import torch

from perfbench.reference.frozen.nums.fp import sqrt_rn
from perfbench.reference.frozen.raster import shade as shade_mod
from perfbench.reference.frozen.tess import mesh
from perfbench.reference.frozen.tess import uniforms_cuda
from perfbench.reference.frozen.tess import vertex


def lambert(normal: torch.Tensor) -> torch.Tensor:
    """raster/shade.lambert with its dot products written x x + y y + z z
    (vertex._dot), the order V1 copies. normal: (..., 3). Returns (...,)."""
    n = vertex._norm(normal)
    light = shade_mod._light(str(normal.device))
    return sqrt_rn(0.001 + torch.clamp_min(vertex._dot(n, light), 0.0))


def tessellate_shaded_plain(corners_rel, corner_normals, tiles, variant_x,
                            variant_y, skirt_size, view_proj,
                            grid: int = mesh.GRID):
    """V1's plain version."""
    pv = vertex.tessellate_blend(corners_rel, corner_normals, tiles,
                                 variant_x, variant_y, skirt_size, view_proj,
                                 grid=grid)
    return pv, lambert(pv.normal)


def tessellate_rows_plain(q_lo, q_hi, crop, depth, corners_hi, corners_lo,
                          cam_hi, cam_lo, max_skirt: float, tiles,
                          view_proj, grid: int = mesh.GRID):
    """V1's rows mode's plain version: U1's, then V1's."""
    u = uniforms_cuda.uniforms_plain(q_lo, q_hi, crop, depth, corners_hi,
                                     corners_lo, cam_hi, cam_lo, max_skirt)
    return tessellate_shaded_plain(u.corners_rel, u.normals, tiles, u.vx,
                                   u.vy, u.skirt, view_proj, grid)


