"""The forward step of the planet engine on one card (planet_tpu's
`__graft_entry__.entry`, ported).

entry() returns (forward, args): a forward step over a batch of quads —
tiles from the quads' double-float corners (ops/heightmap.generate_tiles_df:
the tile kernel's coordinate blend, then ridged noise at 6 octaves through
K4, ops/kernels/perlin_cuda.noise_df), tessellation with gathered bilinear
tile sampling (tess/vertex.tessellate) and Lambert shade — and its example
arguments: real leaves from a fixed camera, as tensors on `device` (the
card by default; the tests pass "cpu", where K4 runs its plain version).

planet_tpu's dryrun_multichip (the sharded field step and sharded LOD
over a device mesh) is the multi-card slice's and has no counterpart here
yet.

    forward, args = entry()
    clip, shade = forward(*args)    # (Q, 32, 32, 4) f32, (Q, 32, 32) f32
"""

from __future__ import annotations

import numpy as np
import torch

from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.lod import refine as lod_refine
from planet_tpu_torch.models.terrain import RidgedTerrain
from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.ops import heightmap
from planet_tpu_torch.raster import shade as shade_mod
from planet_tpu_torch.tess import vertex

# the forward step's noise: ridged, 6 octaves (octave_count(0, 1))
DEPTH, MAX_DEPTH = 0, 1


def entry(device="cuda"):
    cfg = EngineConfig()
    terrain = RidgedTerrain(lacunarity=cfg.lacunarity,
                            gain=float(np.float32(cfg.gain)),
                            coord_scale=cfg.coord_scale,
                            amplitude=cfg.amplitude)

    def forward(c_hi, c_lo, normals, rect_lo, rect_hi, pixel_size, skirt,
                view_proj, corners_rel):
        # 1. heightmap tiles from double-float quad corners (K4)
        tiles = heightmap.generate_tiles_df(c_hi, c_lo, cfg.tile_dim, terrain,
                                            DEPTH, MAX_DEPTH)
        # 2. tessellate + shade
        pv = vertex.tessellate(corners_rel, normals, tiles, rect_lo, rect_hi,
                               pixel_size, skirt, view_proj)
        return pv.clip, shade_mod.lambert(pv.normal)

    # example args: real leaves from a fixed camera
    cam_pos = np.array([0.0, 0.0, -3.0 * cfg.radius])
    res = lod_refine.refine(cam_pos, cfg.max_lod, cfg.radius)
    n = min(64, len(res.ids))
    corners = res.corners[:n]
    ch, cl = dfm.from_f64_np(corners)
    normals = (corners / np.linalg.norm(corners, axis=-1, keepdims=True)
               ).astype(np.float32)
    dim = cfg.tile_dim
    rect_lo = np.full((n, 2), 1.5 / dim, np.float32)
    rect_hi = np.full((n, 2), (dim - 1.5) / dim, np.float32)
    pix = np.full((n, 2), 1.0 / dim, np.float32)
    skirt = np.array([cfg.skirt_size_for_depth(d) for d in res.depths[:n]],
                     np.float32)
    cam = cam_mod.Camera(position=cam_pos)
    rot = cam_mod.camera_rotation(cam)
    pf = cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg))
    proj = cam_mod.perspective_lh(pf, cfg.window_w / cfg.window_h,
                                  cfg.near_plane, cfg.far_plane)
    view_proj = (proj @ cam_mod.view_from_rotation(rot)).astype(np.float32)
    corners_rel = (corners - cam_pos).astype(np.float32)

    args = tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (ch, cl, normals, rect_lo, rect_hi, pix, skirt,
                           view_proj, corners_rel))
    return forward, args
