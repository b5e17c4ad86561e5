"""The plain reference of one interactive LOD frame: what
DeviceInteractiveEngine.render computes for a camera, from a pool's
bookkeeping, with the frozen plain versions (reference/frozen) in the
program's order: refine, DFS order, cache stage, generation, tessellation,
the exact raster, the u8 fetch.

The pool's state is history: which tiles a frame finds cached depends on
every frame before it. The reference does not replay the window's
thousands of frames; it takes the program's pool keys, ticks and render
tick from just before the sampled frame (`PoolBook`) and nothing else of
the program's. Every tile the frame samples, cached or new, is computed
here from its quad id (`key_tiles`), so the heights are the reference's
own; the cache stage runs here on the bookkeeping and its result (the keys
and ticks after the frame) is compared with the program's. A frame from
the empty pool (the path's first) is the reference's alone.

`f32_control=True` computes the same frame with every double-float
operation narrowed to float32 (the precision below the configuration's):
the correctness check's control.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from perfbench.reference.frozen.cache import device_pool as dp
from perfbench.reference.frozen.cache import device_pool_cuda
from perfbench.reference.frozen.engine.config import EngineConfig
from perfbench.reference.frozen.geom import camera as cam_mod
from perfbench.reference.frozen.geom import cubesphere, quadid
from perfbench.reference.frozen.lod import refine_device
from perfbench.reference.frozen.nums import df as dfm
from perfbench.reference.frozen.nums.fp import sqrt_rn
from perfbench.reference.frozen.ops.kernels import tile_cuda
from perfbench.reference.frozen.raster import coverage_cuda
from perfbench.reference.frozen.tess import mesh, vertex_cuda

_I32 = torch.int32
_KEY_PAD = 2**63 - 1


class PoolBook(NamedTuple):
    """A pool's bookkeeping: keys and ticks (capacity + 1,) int32 and the
    render tick () int32."""

    keys_lo: torch.Tensor
    keys_hi: torch.Tensor
    tick: torch.Tensor
    now: torch.Tensor


def engine_config(settings: dict) -> EngineConfig:
    fields = set(EngineConfig.__dataclass_fields__)
    return EngineConfig(**{k: v for k, v in settings.items() if k in fields})


def camera_inputs(cfg: EngineConfig, width: int, height: int, position,
                  angles):
    """(cam_hi, cam_lo (3,) f32, view_proj (4, 4) f32) numpy, as the
    interactive engine derives them from a camera."""
    cam = cam_mod.Camera(np.asarray(position, np.float64),
                         np.asarray(angles, np.float32))
    pf = cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg))
    proj = cam_mod.perspective_lh(pf, width / height, cfg.near_plane,
                                  cfg.far_plane)
    vp = (proj @ cam_mod.view_from_rotation(cam_mod.camera_rotation(cam))
          ).astype(np.float32)
    ch, cl = dfm.from_f64_np(cam.position)
    return ch, cl, vp


def face_roots(radius: float, device):
    corners = cubesphere.root_corners(radius)
    ids = np.array([quadid.make_root(f) for f in range(6)], np.uint64)
    lo, hi = quadid.to_words(ids)
    ch, cl = dfm.from_f64_np(corners)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (lo, hi, ch, cl, np.zeros(6, np.int32)))


def key_corners(lo, hi, radius: float):
    """The DF corners ((W, 4, 3) hi, lo) of quads given by id words, by
    the refine's own subdivision from their root face, level by level."""
    dev = lo.device
    _, _, rch, rcl, _ = face_roots(radius, dev)
    face = quadid.words_root(hi).long()
    depth = quadid.words_depth(hi)
    w = lo.shape[0]
    c = [r[face].permute(1, 2, 0).contiguous() for r in (rch, rcl)]
    rad = refine_device._split_const(radius, c[0])
    top = int(depth.max()) if w else 0
    for level in range(1, top + 1):
        kids = refine_device._subdivide(tuple(c), rad)      # (4, 12, W)
        digit = quadid.words_path_digit(lo, hi, level).long()
        go = depth >= level
        for k in range(2):
            pick = kids[k].gather(0, digit[None, None, :].expand(1, 12, w))
            c[k] = torch.where(go, pick[0].view(4, 3, w), c[k])
    return tuple(t.permute(2, 0, 1).contiguous() for t in c)


def key_tiles(cfg: EngineConfig, lo, hi):
    """The tiles of quads given by id words: the noise over each quad's
    own corners at its depth's octave count."""
    c_hi, c_lo = key_corners(lo, hi, cfg.radius)
    scale = dfm.from_f64_np(np.float64(cfg.coord_scale))
    g_hi, g_lo = dfm.mul((c_hi, c_lo),
                         tuple(dfm.const(x, c_hi) for x in scale))
    octs = (6 + (12 * quadid.words_depth(hi)) // cfg.max_lod).to(_I32)
    return tile_cuda.tiles_plain(g_hi, g_lo, octs, kind="ridged",
                                 lacunarity=cfg.lacunarity, gain=cfg.gain,
                                 amplitude=cfg.amplitude, dim=cfg.tile_dim)


class Frame(NamedTuple):
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


@contextlib.contextmanager
def narrowed(enabled: bool):
    """Every double-float operation of the frozen copies narrowed to f32:
    the error-free transforms return no error."""
    if not enabled:
        yield
        return
    saved = (dfm.two_sum, dfm.quick_two_sum, dfm.two_prod, dfm.from_f64_np)

    def no_err(op):
        def f(a, b):
            r = op(a, b)
            return r, torch.zeros_like(r)
        return f

    def from_f64(x):
        hi, _ = saved[3](x)
        return hi, np.zeros_like(hi)

    dfm.two_sum = no_err(lambda a, b: a + b)
    dfm.quick_two_sum = no_err(lambda a, b: a + b)
    dfm.two_prod = no_err(lambda a, b: a * b)
    dfm.from_f64_np = from_f64
    try:
        yield
    finally:
        (dfm.two_sum, dfm.quick_two_sum, dfm.two_prod,
         dfm.from_f64_np) = saved


def frame(cfg: EngineConfig, width: int, height: int, caps: dict,
          position, angles, book: Optional[PoolBook], device,
          f32_control: bool = False) -> Frame:
    """One frame of the interactive engine for the camera (f64 position,
    f32 Euler angles) from the pool bookkeeping `book` (None: the empty
    pool), on `device`."""
    with narrowed(f32_control), torch.no_grad():
        return _frame(cfg, width, height, caps, position, angles, book,
                      torch.device(device))


def _frame(cfg, width, height, caps, position, angles, book, dev):
    cap, render_cap = int(caps["cap"]), int(caps["render_cap"])
    gen_cap = int(caps["gen_cap"])
    clip_cap = int(caps.get("clip_cap", coverage_cuda.CLIP_CAP))
    max_lod = cfg.max_lod
    ch, cl, vp = camera_inputs(cfg, width, height, position, angles)
    cam_hi, cam_lo, view_proj = (torch.as_tensor(a, device=dev)
                                 for a in (ch, cl, vp))
    pcap, dim = cfg.cache_capacity, cfg.tile_dim
    pool = dp.init(pcap, dim, dev)
    if book is not None:
        for name in PoolBook._fields:
            getattr(pool, name).copy_(getattr(book, name))
    pool.tiles.fill_(float("nan"))

    # 1. refine, narrowed to the live frontier (bit for bit the full
    # width's, by refine_plain's own contract)
    roots = face_roots(cfg.radius, dev)
    l_int, l_cor, n, overflow = refine_device.refine_plain(
        cam_hi, cam_lo, *roots[:4], max_lod=max_lod, cap=cap,
        radius=cfg.radius, probe="ridged6", root_depth=roots[4],
        quality=cfg.lod_quality, narrow=True)
    rows = torch.arange(cap, device=dev, dtype=_I32)
    # 2. DFS order, padding rows last
    key = quadid.words_dfs_key(l_int[0], l_int[1])
    key = torch.where(rows < n, key, torch.full_like(key, _KEY_PAD))
    perm = torch.argsort(key, stable=True)[:render_cap]
    q_lo, q_hi, depth = (l_int[k].index_select(0, perm) for k in range(3))
    c_hi_t, c_lo_t = (c.index_select(1, perm)
                      for c in (l_cor[:12], l_cor[12:]))
    overflow = overflow | (n > render_cap)
    n = torch.clamp(n, max=render_cap)
    # 3. cache stage on the bookkeeping
    coord_scale = (np.float32(cfg.coord_scale),
                   np.float32(np.float64(cfg.coord_scale)
                              - np.float64(np.float32(cfg.coord_scale))))
    cs = device_pool_cuda.cache_stage_plain(
        pool, q_lo, q_hi, depth, c_hi_t, c_lo_t, n,
        budget=cfg.generations_per_frame, gen_cap=gen_cap, max_lod=max_lod,
        coord_scale=coord_scale, touch=True)
    overflow = overflow | cs.failed
    # 4. generation, and the tiles of the cached slots the frame samples
    tiles = tile_cuda.tiles_plain(cs.gen_hi, cs.gen_lo, cs.gen_oct,
                                  kind="ridged", lacunarity=cfg.lacunarity,
                                  gain=cfg.gain, amplitude=cfg.amplitude,
                                  dim=dim)
    dp.store(pool, cs.gen_slot, cs.gen_slot < pcap, tiles)
    live = rows[:render_cap] < n
    used = torch.unique(cs.slot[live].long())
    cached = used[torch.isnan(pool.tiles[used, 0, 0])]
    if cached.numel():
        pool.tiles[cached] = key_tiles(cfg, pool.keys_lo[cached],
                                       pool.keys_hi[cached])
    pool_tiles = dp.gather(pool, cs.slot)
    # 5. tessellate
    grid = cfg.patch_verts + 2
    pv, _ = vertex_cuda.tessellate_rows_plain(
        q_lo, q_hi, cs.crop, depth, c_hi_t, c_lo_t, cam_hi, cam_lo,
        cfg.max_skirt_size, pool_tiles, view_proj, grid=grid)
    grid_mask = torch.as_tensor(mesh.grid_uv_skirt(cfg.patch_verts)[3],
                                device=dev)
    valid = live[:, None, None] & grid_mask[None]
    dp.end_frame(pool)
    # 6. the exact raster on all render_cap rows, decoded, then the u8
    # fetch
    image, zbuf, counters = coverage_cuda.raster_frame(
        pv.clip, pv.normal, valid, width, height,
        cell_mask=mesh.cell_triangle_mask(cfg.patch_verts), decode=True,
        far_w=cfg.far_plane, count=n.reshape(1).to(_I32),
        clip_cap=clip_cap)
    image = (torch.clamp(image, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    overflow = overflow | counters.overflowed
    return Frame(int(n), bool(overflow), q_lo, q_hi, depth, pool_tiles,
                 pv.clip, image, zbuf,
                 PoolBook(pool.keys_lo, pool.keys_hi, pool.tick, pool.now))


def frame_rows(cfg: EngineConfig, width: int, height: int, caps: dict,
               position, angles, device):
    """The frame's rows as V1's rows mode sees them, without a pool: (live
    row count, render_cap, the live rows' corner normals (n, 4, 3))."""
    with torch.no_grad():
        dev = torch.device(device)
        cap, render_cap = int(caps["cap"]), int(caps["render_cap"])
        ch, cl, _ = camera_inputs(cfg, width, height, position, angles)
        cam_hi, cam_lo = (torch.as_tensor(a, device=dev) for a in (ch, cl))
        roots = face_roots(cfg.radius, dev)
        l_int, l_cor, n, _ = refine_device.refine_plain(
            cam_hi, cam_lo, *roots[:4], max_lod=cfg.max_lod, cap=cap,
            radius=cfg.radius, probe="ridged6", root_depth=roots[4],
            quality=cfg.lod_quality, narrow=True)
        n = min(int(n), render_cap)
        c = (l_cor[:12] + l_cor[12:])[:, :n].reshape(4, 3, n).permute(2, 0, 1)
        x, y, z = c.unbind(-1)
        normals = c / sqrt_rn((x * x + y * y) + z * z)[..., None]
        return n, render_cap, normals
