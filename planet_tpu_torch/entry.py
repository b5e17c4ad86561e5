"""The planet engine's entry points (planet_tpu's `__graft_entry__`,
ported).

entry() returns (forward, args): a forward step over a batch of quads —
tiles from the quads' double-float corners (ops/heightmap.generate_tiles_df:
the tile kernel's coordinate blend, then ridged noise at 6 octaves through
K4, ops/kernels/perlin_cuda.noise_df), tessellation with gathered bilinear
tile sampling (tess/vertex.tessellate) and Lambert shade — and its example
arguments: real leaves from a fixed camera, as tensors on `device` (the
card by default; the tests pass "cpu", where K4 runs its plain version).

dryrun_multichip(n) runs the multi-card paths on n ranks at planet_tpu's
dry-run sizes and checks them (see its docstring).

    forward, args = entry()
    clip, shade = forward(*args)    # (Q, 32, 32, 4) f32, (Q, 32, 32) f32
    dryrun_multichip(4)             # raises if a check fails
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from planet_tpu_torch.cache import device_pool
from planet_tpu_torch.engine import device_step
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.geom import quadid
from planet_tpu_torch.lod import refine as lod_refine
from planet_tpu_torch.models.terrain import RidgedTerrain
from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.ops import heightmap
from planet_tpu_torch.parallel import facemesh, ranks, sharded, sharded_lod
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


# dryrun_multichip's sizes (planet_tpu's __graft_entry__.py:131-186)
FIELD_OCTAVES, FIELD_XYSCALE = 3, 1000.0
LOD_W, LOD_H = 64, 48
LOD_CFG = dict(cache_capacity=64)
LOD_RANK = dict(cap=256, render_cap=32, gen_cap=32, max_lod=3,
                probe="ridged6")
LOD_SINGLE = dict(cap=1024, render_cap=256, gen_cap=256, max_lod=3,
                  probe="ridged6")
LOD_SINGLE_POOL = 512


def _check(cond, msg: str):
    if not cond:
        raise AssertionError(f"dryrun_multichip: {msg}")


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """Bit-for-bit equality of two arrays (floats as their words)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return bool(np.array_equal(a, b))


def _field_points(n: int):
    """The (6, 4n, 4n) face grid's six DF components (px_hi, px_lo, ...)."""
    size = 4 * n
    pts = np.stack([facemesh.face_grid_points(f, size, 6371000.0)
                    for f in range(6)])
    return [a for k in range(3) for a in dfm.from_f64_np(pts[..., k])]


def dryrun_camera(cfg: EngineConfig):
    """planet_tpu's dry-run camera: 2.2 radii out on -z, pitched pi/2."""
    cam_pos = np.array([0.0, 0.0, -2.2 * cfg.radius])
    cam = cam_mod.Camera(position=cam_pos,
                         angles=np.array([np.pi / 2, 0, 0], np.float32))
    pf = cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg))
    vp = (cam_mod.perspective_lh(pf, LOD_W / LOD_H, cfg.near_plane,
                                 cfg.far_plane)
          @ cam_mod.view_from_rotation(cam_mod.camera_rotation(cam)))
    return (*dfm.from_f64_np(cam_pos), vp.astype(np.float32))


def _two_axis(n: int) -> bool:
    return n % 2 == 0 and n >= 4


def _dryrun_rank(rank, world, out_dir, spec):
    """One rank of dryrun_multichip: saves (a) its field strips, (a2) its
    strips on the 2-axis mesh, (b) and (b2) its composited LOD frames."""
    device_type = spec["device"]
    comps = _field_points(world)
    size = comps[0].shape[1]
    step_kw = dict(octaves=FIELD_OCTAVES, xyscale=FIELD_XYSCALE,
                   seam="exchange")
    mesh = sharded.make_mesh(world, device_type=device_type)
    dev = sharded.rank_device(mesh)
    rows = size // world
    local = [torch.from_numpy(np.ascontiguousarray(
        c[:, rank * rows:(rank + 1) * rows])).to(dev) for c in comps]
    h, sh, stats = sharded.sharded_field_step(mesh, **step_kw)(*local)
    ranks.save(out_dir, "a", rank, h=h, sh=sh, stats=stats)
    if _two_axis(world):
        mesh2 = sharded.make_mesh_2d(2, world // 2, device_type=device_type)
        s, r = mesh2.get_coordinate()
        rows2 = size // (world // 2)
        local2 = [torch.from_numpy(np.ascontiguousarray(
            c[3 * s:3 * s + 3, r * rows2:(r + 1) * rows2])).to(dev)
            for c in comps]
        h2, sh2, _ = sharded.sharded_field_step(mesh2, **step_kw)(*local2)
        ranks.save(out_dir, "a2", rank, h=h2, sh=sh2)
    if sharded_lod.N_SUBTREES % world:
        return
    cfg = EngineConfig(**LOD_CFG)
    meshes = [("b", sharded.make_mesh(world, axis="quads",
                                      device_type=device_type), "quads")]
    if _two_axis(world):
        meshes.append(("b2", sharded.make_mesh_2d(
            2, world // 2, axis="quads", device_type=device_type),
            ("slice", "quads")))
    for name, lod_mesh, axis in meshes:
        render = sharded_lod.build_sharded_render(
            cfg, lod_mesh, LOD_W, LOD_H, axis=axis, **LOD_RANK)
        pool = device_pool.init(cfg.cache_capacity, cfg.tile_dim, dev)
        frame, (q_lo, q_hi, n, n_gen) = render(pool, *dryrun_camera(cfg))
        counts = torch.stack([frame.n_leaves, frame.n_generated,
                              frame.overflowed.to(torch.int32), n, n_gen])
        n = int(n)
        ranks.save(out_dir, name, rank, image=frame.image, depth=frame.depth,
                   q_lo=q_lo[:n], q_hi=q_hi[:n], counts=counts,
                   tiles_max=pool.tiles.abs().max())


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """planet_tpu's __graft_entry__.dryrun_multichip(n) on the port: n
    ranks, one spawned process each, in a gloo process group
    (parallel/ranks.spawn), at planet_tpu's dry-run sizes. Raises
    (AssertionError for a failed check, RuntimeError for a rank that fails
    or outlives the spawner's deadline) when anything is wrong.

    device="cuda" (the default): every rank's tensors on the first card,
    so the n ranks share one card; NCCL cannot put two ranks on one card,
    hence gloo (collectives staged through the host). device="cpu": the
    ranks' tensors on the CPU.

    (a)  the row-sharded field step (parallel/sharded.sharded_field_step)
         over a 1-D mesh of n ranks on the (6, 4n, 4n) face grid, ridged
         3 octaves, seam "exchange": each rank's strips of shape
         (6, 4, 4n), the stats finite and equal on every rank;
    (a2) when n is even and >= 4, the same on make_mesh_2d(2, n // 2)
         (faces over the slice axis): bit for bit the 1-D mesh's heights
         and shade;
    (b)  when n divides 24, the sharded LOD render
         (parallel/sharded_lod.build_sharded_render) at 64x48, cap 256,
         render_cap 32, gen_cap 32, max_lod 3, ridged6 probes, a pool of
         64 tiles a rank, planet_tpu's camera: on every rank the composite
         (the decoded MIN of the packed framebuffers: image and depth, a
         one-to-one function of the packed keys) bit for bit the
         single-device step's over the same 24 roots, with its n_leaves
         and n_generated; the ranks' leaves partition the single device's,
         their generated tiles sum to its, terrain reached the pools;
    (b2) when n is also even and >= 4, the render over the ("slice",
         "quads") mesh: bit for bit (b)'s frame."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices {n_devices}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device (pass "
                               "device='cpu' to run on the CPU)")
        from planet_tpu_torch import _cuda
        _cuda.library()       # built once here, loaded by every rank
    elif device != "cpu":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as out:
        ranks.spawn(_dryrun_rank, n, out, dict(device=device))

        def load(name, key):
            return [ranks.load(out, name, key, r) for r in range(n)]

        # (a) the field step
        size, rows = 4 * n, 4
        hs, shs, stats = load("a", "h"), load("a", "sh"), load("a", "stats")
        for r in range(n):
            _check(hs[r].shape == shs[r].shape == (6, rows, size),
                   f"(a) rank {r}: strips {hs[r].shape}, {shs[r].shape}")
            _check(np.isfinite(stats[r]).all() and _same(stats[r], stats[0]),
                   f"(a) rank {r}: stats {stats[r]} (rank 0 {stats[0]})")
        _check(stats[0][0] == 6 * size * size, f"(a) texels {stats[0][0]}")
        h, sh = np.concatenate(hs, axis=1), np.concatenate(shs, axis=1)
        if _two_axis(n):
            inner = n // 2
            h2, sh2 = load("a2", "h"), load("a2", "sh")

            def assemble(parts):
                return np.concatenate([np.concatenate(
                    parts[s * inner:(s + 1) * inner], axis=1)
                    for s in range(2)], axis=0)
            _check(_same(assemble(h2), h) and _same(assemble(sh2), sh),
                   "(a2) the 2-axis mesh's field != the 1-axis mesh's")
        if sharded_lod.N_SUBTREES % n:
            return

        # (b) the sharded LOD render against the single-device step
        cfg = EngineConfig(**LOD_CFG)
        single = device_step.DeviceRenderer(
            cfg, LOD_W, LOD_H, device=device,
            roots=sharded_lod.subtree_roots(cfg.radius, device),
            **LOD_SINGLE)
        want = single.render(device_pool.init(LOD_SINGLE_POOL, cfg.tile_dim,
                                              device), *dryrun_camera(cfg))
        g = single.last_geometry
        w_n, w_gen, w_ovf = (int(v) for v in (want.n_leaves, want.n_generated,
                                              want.overflowed))
        want_ids = set(quadid.from_words(
            g.leaf_lo[:w_n].cpu().numpy(),
            g.leaf_hi[:w_n].cpu().numpy()).tolist())
        image, depth = want.image.cpu().numpy(), want.depth.cpu().numpy()
        _check(not w_ovf and w_n >= 24 and w_gen > 0,
               f"(b) single device: {(w_n, w_gen, w_ovf)}")
        counts = load("b", "counts")
        got_ids = set()
        for r in range(n):
            t_n, t_gen, ovf, _, _ = counts[r]
            _check((t_n, t_gen, ovf) == (w_n, w_gen, 0),
                   f"(b) rank {r}: leaves, generated, overflowed "
                   f"{(t_n, t_gen, ovf)} != the single device's "
                   f"{(w_n, w_gen, 0)}")
            _check(_same(ranks.load(out, "b", "image", r), image)
                   and _same(ranks.load(out, "b", "depth", r), depth),
                   f"(b) rank {r}: the composite != the single device's")
            ids = set(quadid.from_words(ranks.load(out, "b", "q_lo", r),
                                        ranks.load(out, "b", "q_hi", r))
                      .tolist())
            _check(not ids & got_ids, f"(b) rank {r}: leaves overlap")
            got_ids |= ids
            _check(float(ranks.load(out, "b", "tiles_max", r)) > 100.0,
                   f"(b) rank {r}: no terrain in the pool")
        _check(got_ids == want_ids, "(b) the ranks' leaves != the single "
               "device's")
        _check(sum(int(c[4]) for c in counts) == w_gen,
               "(b) the ranks' generated tiles do not sum to the single "
               "device's")
        _check(np.isfinite(image).all(), "(b) image not finite")
        if _two_axis(n):
            for r in range(n):
                _check(_same(ranks.load(out, "b2", "image", r), image)
                       and _same(ranks.load(out, "b2", "depth", r), depth)
                       and ranks.load(out, "b2", "counts", r)[0] == w_n,
                       f"(b2) rank {r}: the 2-axis mesh's frame != (b)'s")
