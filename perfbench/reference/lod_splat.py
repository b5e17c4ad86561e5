"""The plain reference of one interactive LOD frame in the splat raster
mode (`raster_mode="splat"`): what DeviceInteractiveEngine.render computes
for a camera, from a pool's bookkeeping, with the frozen plain versions in
the program's order: refine, DFS order, cache stage, generation and
tessellation as reference/lod.py computes them (the vertex shade kept),
then the back-face cull, each cell upsampled k x k (k the configuration's
raster_supersample), the projection, packing and depth test, one 3x3
hole-fill round, the decode and the u8 fetch (frozen/raster/splat.py).
The pool's bookkeeping is taken as reference/lod.py takes it (`PoolBook`);
`f32_control=True` narrows every double-float operation to float32 as
reference/lod.py's does.

Where this departs from planet_tpu's splat (raster/splat.py and the
splat branch of engine/device_step.py):
* the back-face cull's dot product of the camera-relative position and
  the sphere normal is summed in one fixed order, (x + y) + z, where
  planet_tpu's jnp.sum leaves the order to XLA;
* every float -> int32 conversion (the pixel, the depth and shade
  quantizations) truncates, saturates and takes NaN to 0 as XLA's convert
  does (coverage.to_i32), where a bare torch conversion would not;
* the reciprocal of w is torch's IEEE division and the depth test torch's
  scatter_reduce "amin": a min of int32 keys, the same whatever the order
  of the fragments;
* it runs on the program's own card (or the CPU), not a TPU. The packing,
  the hole fill and the depth test take int32 keys only and are exact on
  any device; the float steps before them (the bilinear blend in
  separate, unfused multiplies and adds, the projection) are IEEE single
  precision operations that round the same on the card and the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from perfbench.reference import lod as ref_lod
from perfbench.reference.frozen.cache import device_pool as dp
from perfbench.reference.frozen.cache import device_pool_cuda
from perfbench.reference.frozen.geom import quadid
from perfbench.reference.frozen.lod import refine_device
from perfbench.reference.frozen.ops.kernels import tile_cuda
from perfbench.reference.frozen.raster import coverage, splat
from perfbench.reference.frozen.tess import mesh, vertex_cuda

PoolBook = ref_lod.PoolBook
engine_config = ref_lod.engine_config

_I32 = torch.int32
_KEY_PAD = 2**63 - 1


class Frame(NamedTuple):
    """reference/lod.Frame's fields, and what the splat worked on."""

    n_leaves: int
    overflowed: bool
    leaf_lo: torch.Tensor      # (render_cap,) DFS order, padding past n
    leaf_hi: torch.Tensor
    leaf_depth: torch.Tensor
    tiles: torch.Tensor        # (render_cap, dim, dim) sampled by each row
    clip: torch.Tensor         # (render_cap, G, G, 4)
    image: torch.Tensor        # (H, W) u8
    depth: torch.Tensor        # (H, W) f32 NDC z, +inf where empty
    book: PoolBook             # the bookkeeping after the frame
    cells: int                 # cells whose four corners pass the cull
    covered: int               # pixels a fragment landed on, before the fill
    filled: int                # pixels covered after the fill


def frame(cfg, width: int, height: int, caps: dict, position, angles,
          book: Optional[PoolBook], device, f32_control: bool = False
          ) -> Frame:
    """One splat frame of the interactive engine for the camera (f64
    position, f32 Euler angles) from the pool bookkeeping `book` (None:
    the empty pool), on `device`."""
    with ref_lod.narrowed(f32_control), torch.no_grad():
        return _frame(cfg, width, height, caps, position, angles, book,
                      torch.device(device))


def work(cfg, width: int, height: int, caps: dict, position, angles,
         device) -> tuple:
    """(cells, covered) of the camera's own splat frame: the frame from
    the empty pool with every leaf generated (gen_cap raised to
    render_cap), so that no row crops a parent's tile."""
    caps = {**caps, "gen_cap": caps["render_cap"]}
    f = frame(cfg, width, height, caps, position, angles, None, device)
    return f.cells, f.covered


def _geometry(cfg, width, height, caps, position, angles, book, dev):
    """Stages 1-5 as reference/lod.py computes them: (n, overflow, leaf
    words and depths, the gathered tiles, the vertices, their shade, the
    rows' validity, the pool). A copy of reference/lod.py's, whose frame
    drops the vertex shade and ends in the exact raster; that module is
    the other cells' yardstick and stays as it is."""
    cap, render_cap = int(caps["cap"]), int(caps["render_cap"])
    gen_cap = int(caps["gen_cap"])
    max_lod = cfg.max_lod
    ch, cl, vp = ref_lod.camera_inputs(cfg, width, height, position, angles)
    cam_hi, cam_lo, view_proj = (torch.as_tensor(a, device=dev)
                                 for a in (ch, cl, vp))
    pcap, dim = cfg.cache_capacity, cfg.tile_dim
    pool = dp.init(pcap, dim, dev)
    if book is not None:
        for name in PoolBook._fields:
            getattr(pool, name).copy_(getattr(book, name))
    pool.tiles.fill_(float("nan"))

    roots = ref_lod.face_roots(cfg.radius, dev)
    l_int, l_cor, n, overflow = refine_device.refine_plain(
        cam_hi, cam_lo, *roots[:4], max_lod=max_lod, cap=cap,
        radius=cfg.radius, probe="ridged6", root_depth=roots[4],
        quality=cfg.lod_quality, narrow=True)
    rows = torch.arange(cap, device=dev, dtype=_I32)
    key = quadid.words_dfs_key(l_int[0], l_int[1])
    key = torch.where(rows < n, key, torch.full_like(key, _KEY_PAD))
    perm = torch.argsort(key, stable=True)[:render_cap]
    q_lo, q_hi, depth = (l_int[k].index_select(0, perm) for k in range(3))
    c_hi_t, c_lo_t = (c.index_select(1, perm)
                      for c in (l_cor[:12], l_cor[12:]))
    overflow = overflow | (n > render_cap)
    n = torch.clamp(n, max=render_cap)
    coord_scale = (np.float32(cfg.coord_scale),
                   np.float32(np.float64(cfg.coord_scale)
                              - np.float64(np.float32(cfg.coord_scale))))
    cs = device_pool_cuda.cache_stage_plain(
        pool, q_lo, q_hi, depth, c_hi_t, c_lo_t, n,
        budget=cfg.generations_per_frame, gen_cap=gen_cap, max_lod=max_lod,
        coord_scale=coord_scale, touch=True)
    overflow = overflow | cs.failed
    tiles = tile_cuda.tiles_plain(cs.gen_hi, cs.gen_lo, cs.gen_oct,
                                  kind="ridged", lacunarity=cfg.lacunarity,
                                  gain=cfg.gain, amplitude=cfg.amplitude,
                                  dim=dim)
    dp.store(pool, cs.gen_slot, cs.gen_slot < pcap, tiles)
    live = rows[:render_cap] < n
    used = torch.unique(cs.slot[live].long())
    cached = used[torch.isnan(pool.tiles[used, 0, 0])]
    if cached.numel():
        pool.tiles[cached] = ref_lod.key_tiles(cfg, pool.keys_lo[cached],
                                               pool.keys_hi[cached])
    pool_tiles = dp.gather(pool, cs.slot)
    pv, vshade = vertex_cuda.tessellate_rows_plain(
        q_lo, q_hi, cs.crop, depth, c_hi_t, c_lo_t, cam_hi, cam_lo,
        cfg.max_skirt_size, pool_tiles, view_proj, grid=cfg.patch_verts + 2)
    grid_mask = torch.as_tensor(mesh.grid_uv_skirt(cfg.patch_verts)[3],
                                device=dev)
    valid = live[:, None, None] & grid_mask[None]
    dp.end_frame(pool)
    return (n, overflow, q_lo, q_hi, depth, pool_tiles, pv, vshade, valid,
            pool)


def _frame(cfg, width, height, caps, position, angles, book, dev):
    (n, overflow, q_lo, q_hi, depth, pool_tiles, pv, vshade, valid,
     pool) = _geometry(cfg, width, height, caps, position, angles, book, dev)
    # the splat raster on all render_cap rows (the padding rows invalid),
    # decoded, then the u8 fetch
    k = int(cfg.raster_supersample)
    facing = splat.splat_valid(pv, valid)
    keys = splat.splat_keys_plain(pv.clip, vshade, facing, width, height, k)
    filled = splat._fill_holes(keys)
    image, zbuf = coverage.decode_packed(filled)
    image = (torch.clamp(image, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    cells = (facing[:, :-1, :-1] & facing[:, :-1, 1:] & facing[:, 1:, :-1]
             & facing[:, 1:, 1:])
    empty = coverage._EMPTY
    return Frame(int(n), bool(overflow), q_lo, q_hi, depth, pool_tiles,
                 pv.clip, image, zbuf,
                 PoolBook(pool.keys_lo, pool.keys_hi, pool.tick, pool.now),
                 int(cells.sum()), int((keys != empty).sum()),
                 int((filled != empty).sum()))
