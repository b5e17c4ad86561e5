"""The port's sharded paths (planet_tpu_torch.parallel) as rank workers
for planet_tpu_torch.parallel.ranks.spawn (one process a rank, over
gloo), shared by tests/test_torch_sharded.py,
tests/test_torch_sharded_lod.py and tests/test_torch_kernels_gpu.py; `spawn`,
`save` and `load` are the package's.

This module imports neither jax nor planet_tpu: the ranks run the port
only (tests/test_torch_nojax.py checks it).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from planet_tpu_torch.parallel.ranks import load, save, spawn

__all__ = ["spawn", "save", "load", "lod_camera_args", "field_worker",
           "lod_worker"]


def lod_camera_args(cfg, width: int, height: int, distance: float = 1.15):
    """(cam_hi, cam_lo, view_proj) of tests/test_sharded_lod.py's camera
    moved to `distance` radii: at 1.15 the 24 subtrees refine to depth 4
    (planet_tpu's 1.8 leaves each subtree one leaf)."""
    from planet_tpu_torch.geom import camera as cam_mod
    from planet_tpu_torch.nums import df as dfm

    cdir = np.array([0.3, 0.4, -0.85])
    cdir /= np.linalg.norm(cdir)
    cam_pos = cdir * (cfg.radius * distance)
    cam = cam_mod.Camera(position=cam_pos,
                         angles=np.array([0.6, 0.2, 0.0], np.float32))
    pf = cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg))
    vp = (cam_mod.perspective_lh(pf, width / height, cfg.near_plane,
                                 cfg.far_plane)
          @ cam_mod.view_from_rotation(cam_mod.camera_rotation(cam)))
    return (*dfm.from_f64_np(cam_pos), vp.astype(np.float32))


# ---------------------------------------------------------------- field

def field_worker(rank, world, out_dir, spec):
    """spec["cases"]: name -> dict(mesh=(n,) or (slices, rows), octaves,
    xyscale, seam, points=the six (6, H, W) DF components) for
    sharded_field_step, or dict(mesh=(n,), fused=n_texels, octaves) for
    sharded_field_step_fused. Saves each rank's h, sh, stats."""
    from planet_tpu_torch.parallel import sharded

    for name, case in spec["cases"].items():
        shape = case["mesh"]
        if len(shape) == 1:
            mesh = sharded.make_mesh(shape[0], device_type="cpu")
        else:
            mesh = sharded.make_mesh_2d(*shape, device_type="cpu")
        if "fused" in case:
            fn = sharded.sharded_field_step_fused(
                mesh, case["fused"], 6.371e6, octaves=case["octaves"])
            h, sh, stats = fn()
        else:
            fn = sharded.sharded_field_step(
                mesh, octaves=case["octaves"], xyscale=case["xyscale"],
                seam=case["seam"])
            coord = mesh.get_coordinate()
            s, r = (0, coord[0]) if len(shape) == 1 else coord
            fl = 6 // (shape[0] if len(shape) == 2 else 1)
            hl = case["points"][0].shape[1] // shape[-1]
            local = [torch.from_numpy(np.ascontiguousarray(
                c[s * fl:(s + 1) * fl, r * hl:(r + 1) * hl]))
                for c in case["points"]]
            h, sh, stats = fn(*local)
        save(out_dir, name, rank, h=h, sh=sh, stats=stats)


# ------------------------------------------------------------------ LOD

def lod_worker(rank, world, out_dir, spec):
    """spec: cfg (EngineConfig keywords), width, height, caps (cap,
    render_cap, gen_cap), device, and cases: name -> dict(mesh=(n,) or
    (slices, quads), max_lod, probe, frames=[camera args (cam_hi, cam_lo,
    view_proj), one a frame]). Saves, per case and frame, the composited
    image and depth, the rank's leaf words, and the counts: the rank's
    leaves and generated tiles, the totals, the overflow flag, the rank's
    shard index and the frame's ms by the host clock."""
    from planet_tpu_torch.cache import device_pool
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.parallel import sharded, sharded_lod

    cfg = EngineConfig(**spec["cfg"])
    dev = spec.get("device", "cpu")
    for name, case in spec["cases"].items():
        shape = case["mesh"]
        if len(shape) == 1:
            mesh = sharded.make_mesh(shape[0], axis="quads", device_type=dev)
            axis = "quads"
        else:
            mesh = sharded.make_mesh_2d(*shape, axis="quads",
                                        device_type=dev)
            axis = ("slice", "quads")
        fn = sharded_lod.build_sharded_render(
            cfg, mesh, spec["width"], spec["height"], axis=axis,
            max_lod=case["max_lod"], probe=case["probe"], **spec["caps"])
        index, _ = sharded_lod.shard_index(mesh, axis)
        pool = device_pool.init(cfg.cache_capacity, cfg.tile_dim,
                                sharded.rank_device(mesh))
        for i, args in enumerate(case["frames"]):
            t0 = time.perf_counter()
            frame, (q_lo, q_hi, n, n_gen) = fn(pool, *args)
            ms = (time.perf_counter() - t0) * 1e3
            save(out_dir, f"{name}.f{i}", rank, image=frame.image,
                 depth=frame.depth, q_lo=q_lo[:n], q_hi=q_hi[:n],
                 counts=np.array([int(n), int(n_gen), int(frame.n_leaves),
                                  int(frame.n_generated),
                                  int(frame.overflowed), index]),
                 ms=np.array(ms))
