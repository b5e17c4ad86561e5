"""Queued device times of the main path's kernels, for comparing two trees
of the port on one card in one run.

    python planet_tpu_torch/tools/kernel_times.py [--root DIR] [--reps N]

Imports planet_tpu_torch from DIR (default: the checkout that holds this
file), so the same script times an older tree unpacked beside it, built
from that tree's own sources: run it as old, new, new, old and compare
within the run. Times (tools/common.time_ms: the median of REPS calls
queued behind a spin kernel) the calls of `calls` — the set that
chip_smoke.py phase 8 times for the kernels line: K1 at phase 3's shape
and at the fused frame's occupancy, K4, K5, and K2 on the span records
of the 1080p static scene — and t_noise's variants
(noise_stages.NOISE_VARIANTS, which phase 8 times through
noise_stages.bench) on DIR's tree. Prints the card's nvidia-smi name and
power limit, then one JSON line: {"root": DIR, "ms": {label: ms},
"build_s": s}. Needs a CUDA device.

chip_smoke.py cannot take this role with a --root argument: it drives and
checks the whole main path, and an older tree's phases and kernels line
differ from this one's; this script needs only the kernels' wrappers, the
host frame's record setup and noise_stages' inputs, which every tree
since the attribution tools has.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


# the 1080p static scene (bench.py:230-234): 20 km above the surface
SCENE_W, SCENE_H = 1920, 1080
# the fused frame's generation slots (engine/device_step.py gen_cap) and
# the live ones among them in an orbit frame (8-26 generated, PERF.md)
FUSED_SLOTS, FUSED_LIVE = 256, 24
# the first frames of tools/bench_moving.py's descending orbit (48 frames
# from 20 km to 3 km)
ORBIT_FRAMES = 8


def scene_camera(cfg):
    """bench.py's 1080p LOD camera, 20 km up (pitch 0.35, yaw 0.3)."""
    import numpy as np

    from planet_tpu_torch.geom import camera as cam_mod

    cdir = np.array([0.2, 0.5, -0.8])
    cdir /= np.linalg.norm(cdir)
    return cam_mod.Camera(position=cdir * (cfg.radius + 20000.0),
                          angles=np.array([0.35, 0.3, 0.0], np.float32))


def orbit_cameras(cfg):
    """[(altitude m, camera)] of the orbit's first ORBIT_FRAMES frames
    (tools/bench_moving.py:55-62, 92-94)."""
    import numpy as np

    from planet_tpu_torch.geom import camera as cam_mod

    out = []
    for i, alt in enumerate(np.linspace(20000.0, 3000.0, 48)[:ORBIT_FRAMES]):
        theta = i * 1e-3
        cdir = np.array([np.cos(theta) * 0.8, 0.6, np.sin(theta) * 0.8])
        cdir /= np.linalg.norm(cdir)
        out.append((float(alt), cam_mod.Camera(
            position=cdir * (cfg.radius + alt),
            angles=np.array([0.35, theta, 0.0], np.float32))))
    return out


def frame_records(engine, camera):
    """(M, 32) f32: the span-kernel records of one PlanetEngine frame, as
    its raster makes them (coverage.setup_t, coverage_cuda.route and
    gather_records on the frame's vertices)."""
    import numpy as np
    import torch

    from planet_tpu_torch.raster import coverage as cov
    from planet_tpu_torch.raster import coverage_cuda as cc
    from planet_tpu_torch.tess import mesh

    cfg, device = engine.config, engine.device
    out = engine.frame(camera)
    gm = mesh.grid_uv_skirt(cfg.patch_verts)[3]
    valid = torch.as_tensor(np.broadcast_to(
        gm[None], (out.n_leaves,) + gm.shape).copy(), device=device)
    tm, live, span = cov.setup_t(out.vertices.clip, out.vertices.normal,
                                 valid, cfg.window_w, cfg.window_h,
                                 mesh.cell_triangle_mask(cfg.patch_verts),
                                 far_w=cfg.far_plane)
    span_idx, _ = cc.route(tm, live, span)
    return cc.gather_records(tm, span_idx)


def scene_records(device):
    """(M, 32) f32: the span-kernel records of the 1080p static scene."""
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.engine.planet import PlanetEngine

    cfg = EngineConfig(window_w=SCENE_W, window_h=SCENE_H)
    return frame_records(PlanetEngine(cfg, device=device), scene_camera(cfg))


def fused_tile_inputs(device):
    """(corners_hi, corners_lo, octaves) of the fused frame's generation
    call at an orbit frame's occupancy: FUSED_SLOTS slots, the first
    FUSED_LIVE holding leaves of the 1080p scene with the depth-derived
    counts 6 + 12 depth // max_lod (device_step.py), the rest zero corners
    and count 0, as the step's index_copy leaves them."""
    import numpy as np
    import torch

    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.lod import refine as lod_refine
    from planet_tpu_torch.nums import df as dfm

    cfg = EngineConfig(window_w=SCENE_W, window_h=SCENE_H)
    leaves = lod_refine.refine(scene_camera(cfg).position, cfg.max_lod,
                               cfg.radius)
    sel = np.linspace(0, len(leaves.ids) - 1, FUSED_LIVE).astype(np.int64)
    corners = np.zeros((FUSED_SLOTS, 4, 3))
    corners[:FUSED_LIVE] = leaves.corners[sel] * cfg.coord_scale
    octs = np.zeros(FUSED_SLOTS, np.int32)
    octs[:FUSED_LIVE] = 6 + (12 * leaves.depths[sel]) // cfg.max_lod
    ch, cl = dfm.from_f64_np(corners)
    return (torch.as_tensor(ch, device=device),
            torch.as_tensor(cl, device=device),
            torch.as_tensor(octs, device=device))


def calls(device, records=None, fused=None) -> list:
    """[(key or None, label, call, setup)]: the main path's
    kernels at its shapes, each timed as call(*setup()) — K1 on 256 tiles
    of octaves 6-18 (noise_stages.tile_inputs) and at the fused frame's
    occupancy (`fused`, else fused_tile_inputs), K4 at the refine-probe
    shape (5 x 4096 points, ridged 6) and at 2^20 points x 18 octaves, K5
    at 6 x 2048^2, K2 on the 1080p scene's span records (`records`, else
    scene_records) into a fresh framebuffer each call. The key is the
    kernel's in chip_smoke.py's kernels line ("tile_fused": its tile
    entry's queued_fused_ms). Inputs come from numpy seeds and the scene's
    camera; the modules are imported here, so they come from whichever
    tree is first on sys.path."""
    import numpy as np
    import torch

    from planet_tpu_torch.ops.kernels import field_cuda, perlin_cuda, tile_cuda
    from planet_tpu_torch.raster import coverage as cov
    from planet_tpu_torch.raster import coverage_cuda as cc
    from planet_tpu_torch.tools import noise_stages

    corners = noise_stages.tile_inputs(256, device)
    octs = torch.as_tensor(6 + np.arange(256, dtype=np.int32) % 13,
                           device=device)
    fused = fused_tile_inputs(device) if fused is None else fused
    probe = noise_stages.noise_inputs(5 * 4096, device)
    sphere = noise_stages.noise_inputs(1 << 20, device)
    recs = scene_records(device) if records is None else records
    tile_kw = dict(kind="ridged", gain=0.55, amplitude=8848.0)

    def fresh_fb():
        return (torch.full((SCENE_H, SCENE_W), cov._EMPTY, dtype=torch.int32,
                           device=device),)

    return [
        ("tile", "K1 tile, 256 tiles x octaves 6-18",
         lambda: tile_cuda.tiles_cuda(*corners, octs, **tile_kw), tuple),
        ("tile_fused", f"K1 tile, fused occupancy, {FUSED_LIVE} of "
                       f"{FUSED_SLOTS} slots live",
         lambda: tile_cuda.tiles_cuda(*fused, **tile_kw), tuple),
        ("noise", "K4 noise, refine probes 5x4096, ridged 6",
         lambda: perlin_cuda.noise_cuda("ridged", *probe, octaves=6,
                                        gain=0.55), tuple),
        (None, "K4 noise, 2^20 points, ridged 18",
         lambda: perlin_cuda.noise_cuda("ridged", *sphere, octaves=18,
                                        gain=0.55), tuple),
        ("field", "K5 field 6x2048^2",
         lambda: field_cuda.field_kernel(2048, 6371000.0, device=device),
         tuple),
        ("span", f"K2 span, 1080p scene, {recs.shape[0]} records",
         lambda fb: cc.raster_span_cuda(recs, fb), fresh_fb),
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                         .parents[2]))
    p.add_argument("--reps", type=int, default=7)
    args = p.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch

    from planet_tpu_torch import _cuda
    from planet_tpu_torch.tools import common, noise_stages

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    _cuda.library()
    dev = torch.device("cuda")
    runs = {label: (fn, setup) for _, label, fn, setup in calls(dev)}
    points = noise_stages.noise_inputs(1 << 22, dev)
    for name in noise_stages.NOISE_VARIANTS:
        runs[f"t_noise {name}"] = (
            lambda name=name: noise_stages.noise_stage(name, points), tuple)
    ms = {}
    for name, (fn, setup) in runs.items():
        fn(*setup())
        ms[name] = common.time_ms(fn, setup, reps=args.reps)
    torch.cuda.synchronize()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"root": args.root, "ms": ms,
                      "build_s": _cuda.build_info.get("seconds")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
