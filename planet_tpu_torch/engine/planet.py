"""The planet engine: per-frame orchestration (reference RenderPlanet,
main.cpp:600-683; planet_tpu engine/planet.py, ported).

A frame, in planet_tpu's stage order:
  1. refine   host: LOD refinement against the camera (numpy f64, exact
              reference leaf sets in DFS order);
  2. resolve  host: tile-cache resolution with the generation budget and
              the parent-crop fallback (numpy index);
  3. generate device: ONE tile-kernel launch for every tile the frame
              generates, each tile with its own octave count (reference
              octave schedule, main.cpp:827), stored in place in the pool;
  4. tessellate device: the vertex program + per-vertex shade over all
              leaves, one V1 launch (tess/vertex_cuda.py);
  5. raster   device (render only): the exact-coverage raster, or with
              raster_mode="splat" the depth-tested splat raster
              (raster/splat.py) on the back-face-culled, k x k upsampled
              patch grids.

Host->device traffic per frame is the leaf corners and the per-leaf plan;
tiles live in the device pool between frames. On a CUDA device every
kernel of the path is a hand-written CUDA kernel; on a CPU device the same
code runs the kernels' plain PyTorch versions.

planet_tpu pads leaf and generation batches to power-of-two buckets to
bound jit recompiles; eager PyTorch has nothing to recompile, so batches
here are exactly the frame's leaves.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from planet_tpu_torch.cache.tile_pool import TilePool
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.lod import refine as lod_refine
from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.ops.kernels import tile_cuda
from planet_tpu_torch.ops.kernels.perlin_cuda import MAX_OCTAVES
from planet_tpu_torch.raster import coverage, coverage_cuda
from planet_tpu_torch.raster import splat
from planet_tpu_torch.tess import mesh
from planet_tpu_torch.tess import vertex
from planet_tpu_torch.tess import vertex_cuda

STAGES = ("refine", "resolve", "generate", "tessellate", "raster")


@dataclasses.dataclass
class FrameStats:
    """The reference's live metrics (main.cpp:1030-1037) + texels, and
    per-stage wall ms when the engine's `timing` is on."""

    frametime_ms: float
    fps: float
    tris: int
    quads: int
    tiles_generated: int
    texels_generated: int
    stage_ms: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FrameOutput:
    vertices: vertex.PatchVertices    # (L, G, G, ...) device tensors
    vertex_shade: torch.Tensor        # (L, G, G)
    leaf_ids: np.ndarray              # (L,) uint64
    leaf_depths: np.ndarray           # (L,) int32
    n_leaves: int
    stats: FrameStats


class PlanetEngine:
    """Stateful engine: tile pool + render tick (the only mutable state
    besides the camera, which the caller owns — reference Planet struct,
    main.cpp:161-181).

    device: where tiles, tessellation and the raster run ("cuda", the
    default, or "cpu"). pool: a TilePool to start from (TilePool.from_state
    carries a planet_tpu pool across); a fresh one otherwise. height_fn:
    the host refiner's probe heights (points (..., 3) f64 -> f32; tests
    pass zeros for a smooth sphere), the terrain's by default. timing:
    when True, each stage ends with a device synchronize and its host wall
    time lands in FrameStats.stage_ms. With config.check_finite, each
    frame that generates tiles reads one count back from the device and
    adds its non-finite tiles to `nonfinite_tiles`."""

    def __init__(self, config: EngineConfig = EngineConfig(),
                 device="cuda", *, pool: Optional[TilePool] = None,
                 height_fn=None):
        if config.raster_mode not in ("exact", "splat"):
            raise ValueError(f"raster_mode {config.raster_mode!r}")
        # the tile kernel's octave bound, checked once for every depth
        if config.octaves_for_depth(config.max_lod) > MAX_OCTAVES:
            raise ValueError(f"max_lod {config.max_lod} needs more than "
                             f"{MAX_OCTAVES} octaves")
        self.config = config
        self.device = torch.device(device)
        self.pool = pool if pool is not None else TilePool(
            capacity=config.cache_capacity, dim=config.tile_dim,
            device=self.device)
        if self.pool.tiles.device.type != self.device.type:
            raise ValueError(f"pool tiles on {self.pool.tiles.device}, "
                             f"engine on {self.device}")
        c = config
        pf = cam_mod.proj_factor_from_fovy(np.deg2rad(c.fovy_deg))
        self.proj = cam_mod.perspective_lh(
            pf, c.window_w / c.window_h, c.near_plane, c.far_plane)
        self._height_fn = height_fn
        # runtime toggles (reference keys P / K, main.cpp:980-994)
        self.wireframe = False
        self.skirts = True
        self.timing = False
        self.last_counters = None
        # failure detection: non-finite tiles seen (config.check_finite)
        self.nonfinite_tiles = 0
        # probe-height memo (pure function of quad id) — see lod.refine
        self._probe_cache: dict = {}

    def _lap(self, stage_ms: dict, name: str, t0: float) -> float:
        if self.timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            stage_ms[name] = (t1 - t0) * 1e3
            return t1
        return t0

    def _tensor(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ----------------------------------------------------------------- frame

    def frame(self, camera: cam_mod.Camera) -> FrameOutput:
        t0 = time.perf_counter()
        stage_ms: dict = {}
        lap = t0
        c = self.config

        rot = cam_mod.camera_rotation(camera)
        view_proj = (self.proj @ cam_mod.view_from_rotation(rot)).astype(
            np.float32)

        # 1. refinement (host, exact reference leaf sets in DFS order)
        if len(self._probe_cache) > 1_000_000:
            self._probe_cache.clear()
        res = lod_refine.refine(camera.position, c.max_lod, c.radius,
                                height_fn=self._height_fn,
                                probe_cache=self._probe_cache,
                                quality=c.lod_quality)
        n = len(res.ids)
        lap = self._lap(stage_ms, "refine", lap)

        # 2. cache policy
        resolved = self.pool.resolve(res.ids, c.generations_per_frame)
        lap = self._lap(stage_ms, "resolve", lap)

        # 3. generation: one launch, per-tile octave counts
        gen_idx = np.nonzero(resolved.generate_mask)[0]
        texels = 0
        if len(gen_idx):
            octs = np.array([c.octaves_for_depth(d)
                             for d in res.depths[gen_idx]], np.int32)
            # host f64 pre-scale into noise space (exact to DF precision)
            chn, cln = dfm.from_f64_np(res.corners[gen_idx] * c.coord_scale)
            tiles = tile_cuda.generate_tiles(
                self._tensor(chn), self._tensor(cln), self._tensor(octs),
                kind="ridged", lacunarity=c.lacunarity, gain=c.gain,
                amplitude=c.amplitude, dim=c.tile_dim)
            if c.check_finite:
                # step-level NaN/inf guard, one host read a frame (the
                # reference's closest analogue is its per-frame GL error
                # poll, main.cpp:1100-1115)
                bad = int((~torch.isfinite(tiles)).flatten(1).any(1).sum())
                if bad:
                    self.nonfinite_tiles += bad
                    logging.getLogger(__name__).error(
                        "%d non-finite tiles generated this frame", bad)
            self.pool.store(resolved.slot[gen_idx], tiles)
            texels = len(gen_idx) * c.tile_dim * c.tile_dim
        lap = self._lap(stage_ms, "generate", lap)

        # 4. tessellate + shade over all leaves
        corners_rel = (res.corners - camera.position[None, None, :]).astype(
            np.float32)
        normals = lod_refine._normalize_rows(res.corners).astype(np.float32)
        skirt_scale = 1.0 if self.skirts else 0.0   # key-K toggle analogue
        skirt = np.array([c.skirt_size_for_depth(d) * skirt_scale
                          for d in res.depths], np.float32)
        slots = self._tensor(resolved.slot.astype(np.int64))
        pv, vshade = vertex_cuda.tessellate_shaded(
            self._tensor(corners_rel), self._tensor(normals),
            self.pool.tiles.index_select(0, slots),
            self._tensor(resolved.variant_x.astype(np.int64)),
            self._tensor(resolved.variant_y.astype(np.int64)),
            self._tensor(skirt), self._tensor(view_proj))
        self._lap(stage_ms, "tessellate", lap)

        self.pool.end_frame()

        dt = time.perf_counter() - t0
        stats = FrameStats(
            frametime_ms=dt * 1e3,
            fps=1.0 / max(dt, 1e-9),
            tris=n * mesh.interior_triangle_count(c.patch_verts),
            quads=n,
            tiles_generated=int(resolved.generated),
            texels_generated=texels,
            stage_ms=stage_ms,
        )
        return FrameOutput(vertices=pv, vertex_shade=vshade,
                           leaf_ids=res.ids, leaf_depths=res.depths,
                           n_leaves=n, stats=stats)

    def render(self, camera: cam_mod.Camera,
               width: Optional[int] = None, height: Optional[int] = None):
        """Full frame: tessellate + raster. Returns (FrameOutput, image
        (H, W) f32, depth (H, W) f32 NDC z, +inf where empty), all on the
        engine's device; the exact raster's counters are on
        `self.last_counters` (None in splat mode)."""
        c = self.config
        width = width or c.window_w
        height = height or c.window_h
        out = self.frame(camera)
        t0 = time.perf_counter()
        grid_mask = mesh.grid_uv_skirt(c.patch_verts)[3]
        valid = self._tensor(np.broadcast_to(
            grid_mask[None], (out.n_leaves,) + grid_mask.shape))
        if c.raster_mode == "splat":
            image, depth = splat_raster(out.vertices, out.vertex_shade, valid,
                                        c, width, height, self.wireframe)
            self.last_counters = None
            self._lap(out.stats.stage_ms, "raster", t0)
            return out, image, depth
        image, depth, counters = coverage_cuda.raster_frame(
            out.vertices.clip, out.vertices.normal, valid, width, height,
            cell_mask=mesh.cell_triangle_mask(c.patch_verts),
            wireframe=self.wireframe, far_w=c.far_plane)
        self.last_counters = counters
        self._lap(out.stats.stage_ms, "raster", t0)
        return out, image, depth


def splat_valid(pv: vertex.PatchVertices, valid):
    """valid without the vertices whose outward sphere normal faces away
    from the camera (the reference's CW front-face cull, main.cpp:811-816),
    the dot product summed in one fixed order, so the cull is the same on
    every device."""
    w, n = pv.world, pv.snormal
    return valid & (((w[..., 0] * n[..., 0] + w[..., 1] * n[..., 1])
                     + w[..., 2] * n[..., 2]) < 0.0)


def splat_raster(pv: vertex.PatchVertices, vshade, valid, config: EngineConfig,
                 width: int, height: int, wireframe: bool = False):
    """The splat raster mode (planet_tpu engine/planet._raster_fn, "splat"):
    the back-face cull (splat_valid), each cell upsampled k x k (k =
    config.raster_supersample, at least 2 with wireframe, whose cell edges
    exist only from k = 2) and splatted (raster/splat.splat_keys, the splat
    kernel on the card), one hole-fill round. Returns (image, depth)."""
    k = config.raster_supersample
    if wireframe:
        k = max(k, 2)
    keys = splat.splat_keys(pv.clip, vshade, splat_valid(pv, valid), width,
                            height, k, wireframe)
    return coverage.decode_packed(splat._fill_holes(keys))
