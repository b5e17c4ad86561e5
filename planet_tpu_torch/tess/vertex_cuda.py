"""V1, the vertex program and its shade as one kernel (csrc/tess.cu): the
port's counterpart of the XLA fusion of planet_tpu's geometry step over
tess/vertex.tessellate_blend and raster/shade.lambert.

* tessellate_shaded(corners_rel, corner_normals, tiles, variant_x,
  variant_y, skirt_size, view_proj, grid=mesh.GRID) ->
  (vertex.PatchVertices, vertex_shade (Q, G, G)): corners_rel and
  corner_normals (Q, 4, 3) f32, tiles (Q, dim, dim) f32, variant_x/y (Q,)
  int in {0, 1, 2}, skirt_size (Q,) f32, view_proj (4, 4) f32. A variant
  is taken as a torch index takes it: -3..-1 count from the end, and any
  other value outside {0, 1, 2} makes both versions fail (the kernel
  traps).
* tessellate_rows(q_lo, q_hi, crop, depth, corners_hi, corners_lo,
  cam_hi, cam_lo, max_skirt, tiles, view_proj, grid=mesh.GRID) -> the
  same: the fused step's form, from U1's inputs (tess/uniforms_cuda:
  the rows' id words, crop flags and depths, their lane-major (12, Q) DF
  corners, the camera's DF position and the largest skirt) in place of
  the uniforms. On the card it is V1 in its rows mode, which computes the
  uniforms in its own staging with U1's arithmetic (csrc/uniforms.cuh),
  so no U1 runs and nothing is written between them; its plain version
  is uniforms_plain, then tessellate_shaded_plain, which it equals bit for
  bit. It takes a grid and tile side of at most MAX_GRID and MAX_DIM, or
  exactly WIDE_GRID and WIDE_DIM (64-vertex patches: V1's wide instance,
  a band of grid rows a block, counted under the launch key "tess_wide";
  the narrow instances count under "tess"); the uniforms mode takes the
  narrow sizes alone.

The dispatcher launches the kernel for CUDA tensors (or raises) and runs
the plain version, `tessellate_shaded_plain`, for CPU tensors. The plain
version is vertex.tessellate_blend, whose op order the kernel copies, and
`lambert`, raster/shade.lambert with its sums written out in the same
pinned order (shade.lambert itself is unchanged for its other callers).
A row whose corner normals hold a NaN (the fused frame's padding rows
past its leaf count, engine/device_step.py) comes out NaN in every
output but the height: the kernel computes its height alone and writes
the card's NaN word to the rest, and the plain version evaluates it,
NaN by itself. The kernel reads the two-tap table and the grid's
u values from lru-cached device tensors and the variants, skirt and
view-projection from the device, so it copies nothing from the host and
can be captured in a CUDA graph once it has run eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.nums.fp import sqrt_rn
from planet_tpu_torch.raster import shade as shade_mod
from planet_tpu_torch.tess import mesh
from planet_tpu_torch.tess import uniforms_cuda
from planet_tpu_torch.tess import vertex

# the narrow instances' largest grid and tile side (csrc/tess.cu kMaxGrid,
# kMaxDim), and the wide instance's (kWideGrid, kWideDim): its blocks a
# patch row (kWideParts) and the tile rows a block's band of grid rows may
# read (kBandTex)
MAX_GRID = 32
MAX_DIM = 32
WIDE_GRID = 66
WIDE_DIM = 66
WIDE_PARTS = 3
BAND_TEX = 24


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


def _check_grid(grid: int, dim: int, rows: bool = False) -> str:
    """The launch key of V1's instance for the grid and tile side (rows:
    the rows mode, which alone has the wide instance), or raise."""
    if 0 < grid <= MAX_GRID and 0 < dim <= MAX_DIM:
        return "tess"
    if rows and (grid, dim) == (WIDE_GRID, WIDE_DIM):
        return "tess_wide"
    wide = (f", or exactly {WIDE_GRID} and {WIDE_DIM} in the rows mode"
            if rows else " in the uniforms mode")
    raise ValueError(f"grid {grid}, tile side {dim}: the kernel takes at "
                     f"most {MAX_GRID} and {MAX_DIM}{wide}")


def _outputs(q: int, grid: int, dev):
    """V1's output buffers: (PatchVertices, shade)."""
    def out(*tail):
        return torch.empty((q, grid, grid) + tail, dtype=torch.float32,
                           device=dev)

    return vertex.PatchVertices(clip=out(4), world=out(3), normal=out(3),
                                height=out(), snormal=out(3)), out()


def _tables(grid: int, dim: int, dev):
    """The kernel's two-tap table, the grid's u values and the light."""
    idx, w = vertex.tap_table(dim, grid, str(dev))
    u = vertex._grid_tables(grid, str(dev))[0][0]
    light = [float(x) for x in shade_mod._LIGHT.astype(np.float32)]
    return (idx.data_ptr(), w.data_ptr(), u.data_ptr()), light


def tessellate_shaded_cuda(corners_rel, corner_normals, tiles, variant_x,
                           variant_y, skirt_size, view_proj,
                           grid: int = mesh.GRID):
    q, dim = tiles.shape[0], tiles.shape[-1]
    _check_grid(grid, dim)
    corners_rel, corner_normals, tiles, skirt_size, view_proj = (
        t.contiguous() for t in (corners_rel, corner_normals, tiles,
                                 skirt_size, view_proj))
    vx, vy = (v.to(torch.int32).contiguous() for v in (variant_x, variant_y))
    _cuda.check_cuda(corners_rel, "corners_rel", torch.float32, (q, 4, 3))
    _cuda.check_cuda(corner_normals, "corner_normals", torch.float32,
                     (q, 4, 3))
    _cuda.check_cuda(tiles, "tiles", torch.float32, (q, dim, dim))
    _cuda.check_cuda(vx, "variant_x", torch.int32, (q,))
    _cuda.check_cuda(vy, "variant_y", torch.int32, (q,))
    _cuda.check_cuda(skirt_size, "skirt_size", torch.float32, (q,))
    _cuda.check_cuda(view_proj, "view_proj", torch.float32, (4, 4))
    dev = tiles.device
    for t, name in ((corners_rel, "corners_rel"),
                    (corner_normals, "corner_normals"), (vx, "variant_x"),
                    (vy, "variant_y"), (skirt_size, "skirt_size"),
                    (view_proj, "view_proj")):
        if t.device != dev:
            raise ValueError(f"{name}: expected the tiles' device {dev}, "
                             f"got {t.device}")

    pv, shade = _outputs(q, grid, dev)
    if q:
        tables, light = _tables(grid, dim, dev)
        _cuda.launch("tess", "planet_tess", corners_rel.data_ptr(),
                     corner_normals.data_ptr(), tiles.data_ptr(),
                     vx.data_ptr(), vy.data_ptr(), skirt_size.data_ptr(),
                     view_proj.data_ptr(), *tables, q, grid, dim, *light,
                     *(t.data_ptr() for t in pv), shade.data_ptr())
    return pv, shade


def tessellate_shaded(corners_rel, corner_normals, tiles, variant_x,
                      variant_y, skirt_size, view_proj,
                      grid: int = mesh.GRID):
    if tiles.device.type == "cuda":
        return tessellate_shaded_cuda(corners_rel, corner_normals, tiles,
                                      variant_x, variant_y, skirt_size,
                                      view_proj, grid)
    if tiles.device.type != "cpu":
        raise ValueError(f"unsupported device {tiles.device}")
    return tessellate_shaded_plain(corners_rel, corner_normals, tiles,
                                   variant_x, variant_y, skirt_size,
                                   view_proj, grid)


def tessellate_rows_plain(q_lo, q_hi, crop, depth, corners_hi, corners_lo,
                          cam_hi, cam_lo, max_skirt: float, tiles,
                          view_proj, grid: int = mesh.GRID):
    """V1's rows mode's plain version: U1's, then V1's."""
    u = uniforms_cuda.uniforms_plain(q_lo, q_hi, crop, depth, corners_hi,
                                     corners_lo, cam_hi, cam_lo, max_skirt)
    return tessellate_shaded_plain(u.corners_rel, u.normals, tiles, u.vx,
                                   u.vy, u.skirt, view_proj, grid)


def tessellate_rows_cuda(q_lo, q_hi, crop, depth, corners_hi, corners_lo,
                         cam_hi, cam_lo, max_skirt: float, tiles, view_proj,
                         grid: int = mesh.GRID):
    """V1 in its rows mode. Checks its operands' metadata alone (no copy,
    no host read), so a CUDA graph can capture it."""
    q, dim = tiles.shape[0], tiles.shape[-1]
    key = _check_grid(grid, dim, rows=True)
    for t, name in ((q_lo, "q_lo"), (q_hi, "q_hi"), (depth, "depth")):
        _cuda.check_cuda(t, name, torch.int32, (q,))
    _cuda.check_cuda(crop, "crop", torch.bool, (q,))
    _cuda.check_cuda(corners_hi, "corners_hi", torch.float32, (12, q))
    _cuda.check_cuda(corners_lo, "corners_lo", torch.float32, (12, q))
    _cuda.check_cuda(cam_hi, "cam_hi", torch.float32, (3,))
    _cuda.check_cuda(cam_lo, "cam_lo", torch.float32, (3,))
    _cuda.check_cuda(tiles, "tiles", torch.float32, (q, dim, dim))
    _cuda.check_cuda(view_proj, "view_proj", torch.float32, (4, 4))
    dev = tiles.device
    for t, name in ((q_lo, "q_lo"), (q_hi, "q_hi"), (crop, "crop"),
                    (depth, "depth"), (corners_hi, "corners_hi"),
                    (corners_lo, "corners_lo"), (cam_hi, "cam_hi"),
                    (cam_lo, "cam_lo"), (view_proj, "view_proj")):
        if t.device != dev:
            raise ValueError(f"{name}: expected the tiles' device {dev}, "
                             f"got {t.device}")
    pv, shade = _outputs(q, grid, dev)
    if q:
        tables, light = _tables(grid, dim, dev)
        _cuda.launch(key, "planet_tess_rows", q_lo.data_ptr(),
                     q_hi.data_ptr(), crop.data_ptr(), depth.data_ptr(),
                     corners_hi.data_ptr(), corners_lo.data_ptr(),
                     cam_hi.data_ptr(), cam_lo.data_ptr(),
                     float(np.float32(max_skirt)), tiles.data_ptr(),
                     view_proj.data_ptr(), *tables, q, grid, dim, *light,
                     *(t.data_ptr() for t in pv), shade.data_ptr())
    return pv, shade


def tessellate_rows(q_lo, q_hi, crop, depth, corners_hi, corners_lo, cam_hi,
                    cam_lo, max_skirt: float, tiles, view_proj,
                    grid: int = mesh.GRID):
    args = (q_lo, q_hi, crop, depth, corners_hi, corners_lo, cam_hi, cam_lo,
            max_skirt, tiles, view_proj, grid)
    if tiles.device.type == "cuda":
        return tessellate_rows_cuda(*args)
    if tiles.device.type != "cpu":
        raise ValueError(f"unsupported device {tiles.device}")
    return tessellate_rows_plain(*args)
