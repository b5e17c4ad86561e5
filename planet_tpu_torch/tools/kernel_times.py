"""Queued device times of the main path's kernels, for comparing two trees
of the port on one card in one run.

    python planet_tpu_torch/tools/kernel_times.py [--root DIR] [--reps N]

Imports planet_tpu_torch from DIR (default: the checkout that holds this
file), so the same script times another tree unpacked beside it (a
change's parent), built from that tree's own sources: run it as old, new,
new, old and compare within the run. Times (tools/common.time_ms: the
median of REPS calls queued behind a spin kernel) the calls of `calls`:
K1 on 256 tiles and at the fused frame's occupancy, K4, R1, the DFS order
kernel beside its plain chain, C1 with C2, K3's clip pass and the whole
clip pass, V1 and its probes, A1, U1, U1 then V1 against V1's rows mode
on A1's and U1's frames, K5, K2 and K3 on the record sets of
`record_sets` (the 1080p static scene, the three goldens, the orbit
frames with huge records) and on a screen-filling triangle, S1 at
`splat_inputs`' two shapes with and without wireframe, and K6 on the
1080p scene and on config 3's flight (p64_route_inputs: 2,048 rows x
8,712 candidates) — and t_noise's variants (noise_stages.NOISE_VARIANTS);
then, by the host clock, the 1080p scene's route and gather
(`host_calls`).

Prints what the build reports when this run builds the library (ptxas'
registers, shared memory and spills a kernel) and, where the toolkit has
cuobjdump, a census of the noise, field, tile, setup and refine kernels'
conversions, f64, f32, shared-memory and shuffle instructions
(tools/common.sass_census); then the card's nvidia-smi name and power
limit, then one JSON line: {"root": DIR, "ms": {label: ms}, "bounds":
{K6's two labels: [least ms, by]}, "sectors": {K6's 1080p label: the
distinct 32-byte sectors its live records' reads touch}, "build_s": s}.
Needs a CUDA device. chip_smoke.py reads the same times (`measure`) and
each kernel's bound at the shape keyed to it (`bounds`).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


# the 1080p static scene (bench.py:230-234): 20 km above the surface
SCENE_W, SCENE_H = 1920, 1080
# the fused frame's generation slots (engine/device_step.py gen_cap) and
# the live ones among them in an orbit frame (8-26 generated, PERF.md)
FUSED_SLOTS, FUSED_LIVE = 256, 24
# the first frames of tools/bench_moving.py's descending orbit (48 frames
# from 20 km to 3 km)
ORBIT_FRAMES = 8
# the dense frontier: a camera this high above the ridged surface under
# the 1080p scene camera, at this LOD quality (EngineConfig.lod_quality):
# 3,177 leaves, frontiers of up to 384 slots a level, ~4,300 live slots in
# all (quality 24 overflows cap 4096)
DENSE_ALTITUDE = 300.0
DENSE_QUALITY = 16.0
# the frame of stage_inputs whose A1 and U1 times the kernels line keeps:
# one that generates a few tiles, as a moving frame does
STAGE_MAIN = "1080p orbit frame 1"
# and the one whose V1 rows-mode times it keeps: the static camera's
# second frame, the rows of tess_inputs' main set
ROWS_MAIN = "1080p static frame 1"
STAGE_ORBIT_FRAMES = 4
# the leaf counts the DFS order is timed at (order_calls): the flight's
# fewest and most over a lap, the look-around's, the dense camera's all
ORDER_LEAVES = (135, 210, 462, 3177)
# host seconds each queued call may take (tools/common.QUEUE_S): R1's
# wrapper takes ~0.5 ms of host a call
QUEUE_S = 2e-3
# BASELINE config 3 as the benchmark runs it (64-vertex patches, 66 x 66
# tiles, its quality, cache and caps), for K6 at its candidates
P64_CONFIG = (pathlib.Path(__file__).resolve().parents[2] / "perfbench"
              / "configs" / "lod-1080p-p64.json")
ROUTE_1080P = "K6 route + gather, 1080p"
ROUTE_P64 = "K6 route + gather, p64 flight"


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


def dense_camera(cfg):
    """The dense case's camera position (f64, metres): DENSE_ALTITUDE above
    the probes' ridged6 surface (6 ridged octaves at gain 0.55 of the unit
    point at 1e-5 per metre, times 8848) under the 1080p scene camera."""
    import numpy as np

    from planet_tpu_torch.ops import perlin

    pos = scene_camera(cfg).position
    unit = pos / np.linalg.norm(pos)
    p = unit * cfg.radius * 1e-5
    h = perlin.ridged_f64(*(np.array([c]) for c in p), gain=np.float32(0.55),
                          octaves=6, device="cpu")
    return unit * (cfg.radius + float(h[0]) * 8848.0 + DENSE_ALTITUDE)


def frame_set(engine, camera) -> dict:
    """One PlanetEngine frame's raster inputs, as its raster makes them:
    setup_t's route inputs `tm`, `live`, `span`; the span-kernel records
    `span_recs` and the huge kernel's `huge_recs` (the huge class, then the
    clipped near-plane straddlers' live triangles), built with the plain
    route and gather; `width`, `height`."""
    import numpy as np
    import torch

    from planet_tpu_torch.raster import coverage as cov
    from planet_tpu_torch.raster import coverage_cuda as cc
    from planet_tpu_torch.raster import nearclip
    from planet_tpu_torch.tess import mesh

    cfg, device = engine.config, engine.device
    out = engine.frame(camera)
    gm = mesh.grid_uv_skirt(cfg.patch_verts)[3]
    valid = torch.as_tensor(np.broadcast_to(
        gm[None], (out.n_leaves,) + gm.shape).copy(), device=device)
    clip, normal = out.vertices.clip, out.vertices.normal
    cell_mask = mesh.cell_triangle_mask(cfg.patch_verts)
    w, h = cfg.window_w, cfg.window_h
    tm, live, span = cov.setup_t(clip, normal, valid, w, h, cell_mask,
                                 far_w=cfg.far_plane)
    span_idx, huge_idx = cc.route(tm, live, span)
    smask = nearclip.straddle_mask_t(clip, valid, cell_mask)
    tcl = nearclip.clipped_tris(clip, normal, torch.nonzero(smask).squeeze(1),
                                w, h, far_w=cfg.far_plane)
    crecs = nearclip.records_from_tris(tcl)[tcl.live]
    return dict(tm=tm, live=live, span=span, span_idx=span_idx,
                huge_idx=huge_idx,
                span_recs=cc.gather_records_plain(tm, span_idx),
                huge_recs=torch.cat([cc.gather_records_plain(tm, huge_idx),
                                     crecs]).contiguous(), width=w, height=h)


def frame_records(engine, camera):
    """(M, 32) f32: the span-kernel records of one PlanetEngine frame."""
    return frame_set(engine, camera)["span_recs"]


def scene_records(device):
    """(M, 32) f32: the span-kernel records of the 1080p static scene."""
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.engine.planet import PlanetEngine

    cfg = EngineConfig(window_w=SCENE_W, window_h=SCENE_H)
    return frame_records(PlanetEngine(cfg, device=device), scene_camera(cfg))


def screen_triangle_records(width: int, height: int, device):
    """(2, 32) f32 records of one patch cell, both with the whole screen
    as their clamped bbox: the first triangle covers every pixel (NDC (-1,
    -1), (-1, 3), (3, -1), w = 1), the second lies above the screen and
    covers none."""
    import numpy as np
    import torch

    from planet_tpu_torch.raster import coverage as cov

    g = np.zeros((1, 2, 2, 4), np.float32)
    g[0, 0, 0] = (-1.0, -1.0, 0.2, 1.0)          # g00
    g[0, 1, 0] = (-1.0, 3.0, 0.6, 1.0)           # g10
    g[0, 0, 1] = (3.0, -1.0, -0.4, 1.0)          # g01
    g[0, 1, 1] = (3.0, 3.0, 0.1, 1.0)            # g11
    normal = np.zeros((1, 2, 2, 3), np.float32)
    normal[..., 1] = 0.6
    normal[..., 2] = -0.8
    normal[0, 1, 1] = (0.3, 0.2, -0.93)
    tm, live, _ = cov.setup_t(torch.as_tensor(g, device=device),
                              torch.as_tensor(normal, device=device),
                              torch.ones((1, 2, 2), dtype=torch.bool,
                                         device=device), width, height)
    return tm[:, live].T.contiguous()


def record_sets(device, orbit: bool = True) -> dict:
    """{name: frame_set} of the 1080p static scene, the three goldens
    (800x600) and, with orbit, each of the orbit's first frames (one
    PlanetEngine flying them in order) that has huge-kernel records."""
    import numpy as np

    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.engine.planet import PlanetEngine
    from planet_tpu_torch.geom import camera as cam_mod

    gold = pathlib.Path(__file__).resolve().parents[2] / "tests" / "goldens"
    cfg = EngineConfig(window_w=SCENE_W, window_h=SCENE_H)
    sets = {"1080p static": frame_set(PlanetEngine(cfg, device=device),
                                      scene_camera(cfg))}
    cfg800 = EngineConfig()
    for name in ("frame", "nearclip", "farclip"):
        cam = cam_mod.Camera(position=np.load(gold / f"{name}_cam.npy"),
                             angles=np.load(gold / f"{name}_angles.npy"))
        sets[f"golden {name}"] = frame_set(PlanetEngine(cfg800, device=device),
                                           cam)
    if orbit:
        eng = PlanetEngine(cfg, device=device)
        for i, (alt, cam) in enumerate(orbit_cameras(cfg)):
            fs = frame_set(eng, cam)
            if fs["huge_recs"].shape[0]:
                sets[f"orbit {i} ({alt:.0f} m)"] = fs
    return sets


def gather_sectors(idx, n: int) -> int:
    """The distinct 32-byte sectors that reading the 32 words of records
    `idx` from a (32, n) f32 column-major matrix touches."""
    import torch

    rows = torch.arange(32, device=idx.device, dtype=torch.int64)[:, None]
    words = rows * n + idx.to(torch.int64)[None]
    return int(torch.unique(words // 8).numel())


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


def p64_route_inputs(device, frames: int = ORBIT_FRAMES) -> dict:
    """K6's inputs on config 3's flight (P64_CONFIG's settings and caps at
    1920x1080): a DeviceRenderer flies the orbit's first `frames` frames
    (orbit_cameras) from an empty pool, and C1 on the last frame's
    render_cap rows, with the leaf count on the device as the raster
    graph reads it, gives setup's `tm`, `live` and `span`: 2,048 rows x
    8,712 candidates, 69,696 route blocks."""
    from planet_tpu_torch.engine import device_step
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.raster import coverage_cuda as cc
    from planet_tpu_torch.tess import mesh
    from planet_tpu_torch.tools import stage_times

    conf = json.loads(P64_CONFIG.read_text())
    fields = EngineConfig.__dataclass_fields__
    cfg = EngineConfig(**{k: v for k, v in conf["settings"].items()
                          if k in fields})
    w, h = cfg.window_w, cfg.window_h
    rend = device_step.DeviceRenderer(
        cfg, w, h, device=device,
        **{k: v for k, v in conf["engine"].items() if k != "preview"})
    pool = rend.init_pool()
    for _, cam in orbit_cameras(cfg)[:frames]:
        geom = rend.geometry(pool, *stage_times.camera_args(cfg, cam, w, h))
    tm, live, span = cc.setup_cuda(
        geom.vertices.clip, geom.vertices.normal, geom.valid, w, h,
        mesh.cell_triangle_mask(cfg.patch_verts), cfg.far_plane,
        geom.meta[0:1].clone())[:3]
    return dict(tm=tm, live=live, span=span)


def route_bound(fs: dict):
    """K6's (least ms, by) on one set of route inputs: its candidates and
    live ones through tools/common.route_work."""
    from planet_tpu_torch.tools import common

    return common.bound_ms(*common.route_work(fs["tm"].shape[1],
                                              int(fs["live"].sum())))


def host_ms(fn, reps: int = 7) -> float:
    """Median ms of `reps` calls of fn() by the host clock, each between
    two synchronizations: for calls that synchronize themselves."""
    import time

    import numpy as np
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def setup_inputs(device) -> dict:
    """{name: C1's arguments (clip, normal, valid, width, height,
    cell_mask, far_w, count)} at the main path's shapes: DeviceRenderer's
    render_cap rows at 1920x1080 with the leaf count on the device (the
    static camera's second frame, the orbit's first frame from an empty
    pool), and PlanetEngine's leaves with no count (the 1080p static
    scene; the near-clip golden at 800x600, whose straddlers reach the
    mask, and the far-clip golden). The tensors are copies: the renderer's
    next frame writes its own."""
    import numpy as np
    import torch

    from planet_tpu_torch.engine import device_step
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.engine.planet import PlanetEngine
    from planet_tpu_torch.geom import camera as cam_mod
    from planet_tpu_torch.tess import mesh
    from planet_tpu_torch.tools import stage_times

    cfg = EngineConfig(window_w=SCENE_W, window_h=SCENE_H)
    cm = mesh.cell_triangle_mask(cfg.patch_verts)
    rend = device_step.DeviceRenderer(cfg, SCENE_W, SCENE_H, device=device)
    out = {}
    for name, cams in (("1080p static", [scene_camera(cfg)] * 2),
                       ("orbit 0", [orbit_cameras(cfg)[0][1]])):
        pool = rend.init_pool()
        for cam in cams:
            geom = rend.geometry(pool, *stage_times.camera_args(
                cfg, cam, SCENE_W, SCENE_H))
        out[f"{name}, DeviceRenderer rows"] = (
            geom.vertices.clip.clone(), geom.vertices.normal.clone(),
            geom.valid.clone(), SCENE_W, SCENE_H, cm, cfg.far_plane,
            geom.meta[0:1].clone())
    gm = torch.as_tensor(mesh.grid_uv_skirt(cfg.patch_verts)[3],
                         device=device)
    gold = pathlib.Path(__file__).resolve().parents[2] / "tests" / "goldens"
    cfg800 = EngineConfig()
    scenes = [("1080p static", cfg, scene_camera(cfg))]
    for name in ("nearclip", "farclip"):
        scenes.append((f"golden {name}", cfg800, cam_mod.Camera(
            position=np.load(gold / f"{name}_cam.npy"),
            angles=np.load(gold / f"{name}_angles.npy"))))
    for name, c, cam in scenes:
        fr = PlanetEngine(c, device=device).frame(cam)
        out[f"{name}, PlanetEngine leaves"] = (
            fr.vertices.clip, fr.vertices.normal,
            gm[None].expand(fr.n_leaves, -1, -1).contiguous(), c.window_w,
            c.window_h, cm, c.far_plane, None)
    return out


def tess_inputs(device) -> dict:
    """{name: V1's arguments (corners_rel, corner_normals, tiles,
    variant_x, variant_y, skirt_size, view_proj, grid)} at the main
    path's shapes: DeviceRenderer's render_cap rows at 1920x1080 (the
    static camera's second frame, from the "uniforms" rung's outputs and
    the pool's tiles at its slots; the padding rows' corner normals NaN),
    and PlanetEngine's leaves on the three 800x600 goldens (frame,
    nearclip, farclip), recorded at its vertex_cuda.tessellate_shaded
    call. Copies, on `device`."""
    import numpy as np
    import torch

    from planet_tpu_torch.cache import device_pool as dp
    from planet_tpu_torch.engine import device_step
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.engine.planet import PlanetEngine
    from planet_tpu_torch.geom import camera as cam_mod
    from planet_tpu_torch.tess import mesh, vertex_cuda
    from planet_tpu_torch.tools import stage_times

    cfg = EngineConfig(window_w=SCENE_W, window_h=SCENE_H)
    rend = device_step.DeviceRenderer(cfg, SCENE_W, SCENE_H, device=device,
                                      stop_after="uniforms")
    pool = rend.init_pool()
    for _ in range(2):
        args = stage_times.camera_args(cfg, scene_camera(cfg), SCENE_W,
                                       SCENE_H)
        step = rend.geometry(pool, *args)
    o = step.outputs
    rows = tuple(t.clone() for t in (
        o["corners_rel"], o["normals"], dp.gather(pool, o["slot"]), o["vx"],
        o["vy"], o["skirt"])) + (torch.as_tensor(args[2], device=device),
                                 cfg.patch_verts + 2)
    out = {"1080p static, DeviceRenderer rows": rows}
    gold = pathlib.Path(__file__).resolve().parents[2] / "tests" / "goldens"
    shaded = vertex_cuda.tessellate_shaded
    seen = []

    def record(*a, **kw):
        seen.append(tuple(t.clone() for t in a)
                    + (kw.get("grid", mesh.GRID),))
        return shaded(*a, **kw)

    vertex_cuda.tessellate_shaded = record
    try:
        for name in ("frame", "nearclip", "farclip"):
            cam = cam_mod.Camera(position=np.load(gold / f"{name}_cam.npy"),
                                 angles=np.load(gold / f"{name}_angles.npy"))
            PlanetEngine(EngineConfig(), device=device).frame(cam)
            out[f"golden {name}, PlanetEngine leaves"] = seen.pop()
    finally:
        vertex_cuda.tessellate_shaded = shaded
    return out


def stage_inputs(device):
    """({name: A1's call (pool, args, keywords)}, {name: V1's rows-mode
    arguments, whose first nine are U1's}) at the main path's shapes:
    DeviceRenderer's step at 1920x1080 (cap 4096, render_cap 512, gen_cap
    256) run eagerly on `device`, each recorded at its cache_stage and
    vertex_cuda.tessellate_rows call (the pool cloned before the call):
    the static camera's first two frames from an
    empty pool (the first generating every leaf's tile, the second none)
    and the orbit's first STAGE_ORBIT_FRAMES frames from an empty pool
    (frames 1 on generating a few tiles each). Copies."""
    import torch

    from planet_tpu_torch.cache import device_pool as dp
    from planet_tpu_torch.cache import device_pool_cuda
    from planet_tpu_torch.engine import device_step
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.tess import mesh, vertex_cuda
    from planet_tpu_torch.tools import stage_times

    cfg = EngineConfig(window_w=SCENE_W, window_h=SCENE_H)
    seen_c, seen_v = [], []

    def clone(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    def recording(module, name, record):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            record(a, kw)
            return fn(*a, **kw)
        return module, name, fn, wrapped

    def grid(kw):
        return (kw.get("grid", mesh.GRID),)

    patches = [
        recording(device_pool_cuda, "cache_stage", lambda a, kw: (
            seen_c.append((dp.PoolState(*(t.clone() for t in a[0])),
                           tuple(map(clone, a[1:])), dict(kw))))),
        recording(vertex_cuda, "tessellate_rows", lambda a, kw: seen_v.append(
            tuple(map(clone, a)) + grid(kw)))]
    render = device_step.build_device_render(cfg, SCENE_W, SCENE_H,
                                             device=device)
    frames = [(f"1080p static frame {i}", scene_camera(cfg), i == 0)
              for i in range(2)]
    frames += [(f"1080p orbit frame {i}", cam, i == 0) for i, (_, cam)
               in enumerate(orbit_cameras(cfg)[:STAGE_ORBIT_FRAMES])]
    caches, rows = {}, {}
    for module, name, _, wrapped in patches:
        setattr(module, name, wrapped)
    try:
        for name, cam, fresh in frames:
            if fresh:
                pool = dp.init(cfg.cache_capacity, cfg.tile_dim, device)
            render(pool, *stage_times.camera_args(cfg, cam, SCENE_W,
                                                  SCENE_H))
            caches[name], rows[name] = seen_c.pop(), seen_v.pop()
    finally:
        for module, name, fn, _ in patches:
            setattr(module, name, fn)
    return caches, rows


def tess_probes(args) -> dict:
    """{label: V1's arguments}: the parts of V1's time on the fused
    frame's rows (`args`, tess_inputs' 512 rows, the first n live and the
    rest padding): every row a padding row (every corner normal NaN), the
    n live rows alone, and those rows with each row's four corner normals
    set to its first (every interpolation the linear fallback)."""
    import torch

    from planet_tpu_torch.tools import common

    n = int(common.tess_live(args[1]).sum())
    live = tuple(t[:n].clone() if torch.is_tensor(t) and t.dim()
                 and t.shape[0] == args[2].shape[0] else t for t in args)
    flat = list(live)
    flat[1] = live[1][:, :1].expand(-1, 4, -1).contiguous()
    pad = list(args)
    pad[1] = torch.full_like(args[1], float("nan"))
    return {"every row padding": tuple(pad),
            f"the {n} live rows alone": live,
            f"the {n} live rows alone, every interpolation linear":
                tuple(flat)}


def clip_inputs(setups: dict) -> dict:
    """{name: C2's arguments (clip, normal, straddle, blocks, width, height,
    far_w, CLIP_CAP)} on each C1 input set, as raster_frame hands them
    over: C1's straddler mask and block counts."""
    from planet_tpu_torch.raster import coverage_cuda as cc

    out = {}
    for name, (clip, normal, valid, w, h, cm, far, count) in setups.items():
        c1 = cc.setup(clip, normal, valid, w, h, cm, far, count)
        out[name] = (clip, normal, c1[3], c1[4], w, h, far, cc.CLIP_CAP)
    return out


def clip_pass_calls(clips: dict) -> list:
    """[(key or None, label, call, setup)]: on each set's C2 arguments in
    `clips` (clip_inputs), as raster_frame runs them: "C2 clip" (the clip
    pass's kernel, the compaction included), "K3 clip pass" (K3 on C2's
    records and their count) and "clip pass" (C2, then K3: the clip pass's
    whole cost), each K3 call into a fresh framebuffer. The key of the
    1080p static DeviceRenderer set's C2 call is "clip"."""
    import torch

    from planet_tpu_torch.raster import coverage as cov
    from planet_tpu_torch.raster import coverage_cuda as cc

    out = []
    for name, args in clips.items():
        w, h = args[4], args[5]

        def c2(args=args):
            return cc.clip_pass_cuda(*args)

        _, _, recs, count = c2()

        def k3(fb, recs=recs, count=count):
            return cc.raster_huge_cuda(recs, fb, count=count)

        def whole(fb, c2=c2):
            recs, count = c2()[2:]
            return cc.raster_huge_cuda(recs, fb, count=count)

        def fb(w=w, h=h):
            return (torch.full((h, w), cov._EMPTY, dtype=torch.int32,
                               device=recs.device),)

        main = name == "1080p static, DeviceRenderer rows"
        out += [("clip" if main else None, f"C2 clip, {name}", c2, tuple),
                (None, f"K3 clip pass, {name}", k3, fb),
                (None, f"clip pass, {name}", whole, fb)]
    return out


def refine_call(device):
    """R1 on the 1080p static scene's camera from the six faces, as the
    fused frame calls it (refine_device's CUDA route)."""
    import torch

    from planet_tpu_torch.engine import device_step
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.nums import df as dfm
    from planet_tpu_torch.ops.kernels import refine_cuda

    cfg = EngineConfig(window_w=SCENE_W, window_h=SCENE_H)
    cam = [torch.as_tensor(a, device=device)
           for a in dfm.from_f64_np(scene_camera(cfg).position)]
    roots = device_step.face_roots(cfg.radius, device)[:4]
    return lambda: refine_cuda.refine_cuda(
        *cam, *roots, max_lod=cfg.max_lod, cap=4096, radius=cfg.radius,
        probe="ridged6")


def order_calls(device) -> list:
    """[(key or None, label, call, tuple)]: the DFS order kernel
    (refine_cuda.dfs_order_cuda) and its plain chain on the card
    (refine_device.dfs_order_plain: the torch ops the fused step ran before
    the kernel) on R1's leaves of the dense camera (dense_camera) cut to
    their first n, for n in ORDER_LEAVES (the rows past n zeros, as R1
    leaves them), at the fused frame's render cap of 512 and, at n = 3,177,
    at the whole cap of 4,096 too. The key of the kernel's call at the
    flight's most leaves and the render cap is "order"."""
    import torch

    from planet_tpu_torch.engine import device_step
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.lod import refine_device
    from planet_tpu_torch.nums import df as dfm
    from planet_tpu_torch.ops.kernels import refine_cuda

    cfg = EngineConfig(window_w=SCENE_W, window_h=SCENE_H)
    cam = [torch.as_tensor(a, device=device) for a in
           dfm.from_f64_np(dense_camera(cfg))]
    roots = device_step.face_roots(cfg.radius, device)[:4]
    cap = 4096
    l_int, l_cor, n_all, _ = refine_cuda.refine_cuda(
        *cam, *roots, max_lod=cfg.max_lod, cap=cap, radius=cfg.radius,
        probe="ridged6", quality=DENSE_QUALITY)
    n_all = int(n_all)
    out = []
    for n in ORDER_LEAVES:
        n = min(n, n_all)
        li, lc = l_int.clone(), l_cor.clone()
        li[:, n:] = 0
        lc[:, n:] = 0
        args = (li[0], li[1], li[2], lc[:12], lc[12:],
                torch.tensor(n, dtype=torch.int32, device=device),
                torch.tensor(False, device=device))
        for render_cap in (512, cap) if n > 512 else (512,):
            tag = f"n {n}, render cap {render_cap}"
            main = n == ORDER_LEAVES[1] and render_cap == 512
            out += [("order" if main else None, f"DFS order kernel, {tag}",
                     lambda a=args, r=render_cap:
                     refine_cuda.dfs_order_cuda(*a, r), tuple),
                    (None, f"DFS order plain chain, {tag}",
                     lambda a=args, r=render_cap:
                     refine_device.dfs_order_plain(*a, r), tuple)]
    return out


def splat_inputs(device) -> dict:
    """{name: S1's arguments (clip, shade, valid, width, height, k,
    wireframe)} at the splat raster's 1080p shapes: the 1080p static
    scene in splat mode (supersample 8, the driver's rule for 1920 wide)
    through PlanetEngine's leaves ("PlanetEngine") and through
    DeviceRenderer's render_cap rows, padding rows invalid ("DeviceRenderer
    rows"), each also with wireframe (k 8, "..., wireframe")."""
    import numpy as np
    import torch

    from planet_tpu_torch.engine import device_step
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.engine.planet import PlanetEngine, splat_valid
    from planet_tpu_torch.geom import camera as cam_mod
    from planet_tpu_torch.nums import df as dfm
    from planet_tpu_torch.tess import mesh

    ss = max(4, round(SCENE_W / 240))
    cfg = EngineConfig(window_w=SCENE_W, window_h=SCENE_H,
                       raster_mode="splat", raster_supersample=ss)
    cam = scene_camera(cfg)
    out = PlanetEngine(cfg, device=device).frame(cam)
    grid = torch.as_tensor(mesh.grid_uv_skirt(cfg.patch_verts)[3],
                           device=device)
    valid = grid[None].expand(out.n_leaves, -1, -1)
    grids = {"PlanetEngine": (out.vertices.clip, out.vertex_shade,
                              splat_valid(out.vertices, valid))}
    rend = device_step.DeviceRenderer(cfg, SCENE_W, SCENE_H, device=device)
    vp = (cam_mod.perspective_lh(
        cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg)),
        SCENE_W / SCENE_H, cfg.near_plane, cfg.far_plane)
        @ cam_mod.view_from_rotation(cam_mod.camera_rotation(cam))) \
        .astype(np.float32)
    rend.render(rend.init_pool(), *dfm.from_f64_np(cam.position), vp)
    geom = rend.last_geometry
    grids["DeviceRenderer rows"] = (
        geom.vertices.clip, geom.vertex_shade,
        splat_valid(geom.vertices, geom.valid))
    out = {}
    for name, grid3 in grids.items():
        out[name] = (*grid3, SCENE_W, SCENE_H, ss, False)
        out[f"{name}, wireframe"] = (*grid3, SCENE_W, SCENE_H, ss, True)
    return out


def calls(device, sets=None, p64=None) -> list:
    """[(key or None, label, call, setup)]: the main path's kernels at its
    shapes, each timed as call(*setup()) — K1 on 256 tiles of octaves 6-18
    (noise_stages.tile_inputs) and at the fused frame's occupancy
    (fused_tile_inputs), K4 at the refine-probe shape (5 x 4096 points,
    ridged 6) and at 2^20 points x 18 octaves, R1 on the 1080p scene's
    camera from the six faces (max_lod 18, cap 4096, ridged probes), the
    DFS order kernel and its plain chain (order_calls), K5 at 6 x 2048^2;
    on each frame set of `sets` (else record_sets): K2 on K6's span buffer
    with the count on the device, as the main path draws it, K3 on its
    huge records (the huge class and the clipped straddlers), each into a
    fresh framebuffer a call; K3 on screen_triangle_records at 1080p; S1
    at splat_inputs' shapes; C1 on each set of setup_inputs, C2, K3's clip
    pass and the whole clip pass on their straddlers (clip_pass_calls); V1
    on each set of tess_inputs and on tess_probes' parts of its 512 rows;
    A1 and U1 on each frame of stage_inputs, A1 into a fresh copy of the
    frame's pool a call, and on the same frames the tessellate stage as U1
    then V1 on its outputs ("U1 + V1") and as V1's rows mode ("V1 rows");
    and K6 on the 1080p scene and on config 3's flight (`p64`, else
    p64_route_inputs). The key names the kernel ("tile_fused": K1 at the
    fused occupancy; "tess_pair" and "tess_rows": the tessellate stage's
    two forms). Inputs come from numpy seeds and the scenes' cameras; the
    modules are imported here, so they come from whichever tree is first
    on sys.path."""
    import numpy as np
    import torch

    from planet_tpu_torch.cache import device_pool_cuda
    from planet_tpu_torch.ops.kernels import field_cuda, perlin_cuda, tile_cuda
    from planet_tpu_torch.raster import coverage as cov
    from planet_tpu_torch.raster import coverage_cuda as cc
    from planet_tpu_torch.raster import splat
    from planet_tpu_torch.tess import uniforms_cuda, vertex_cuda
    from planet_tpu_torch.tools import noise_stages

    corners = noise_stages.tile_inputs(256, device)
    octs = torch.as_tensor(6 + np.arange(256, dtype=np.int32) % 13,
                           device=device)
    fused = fused_tile_inputs(device)
    probe = noise_stages.noise_inputs(5 * 4096, device)
    sphere = noise_stages.noise_inputs(1 << 20, device)
    sets = record_sets(device) if sets is None else sets
    tile_kw = dict(kind="ridged", gain=0.55, amplitude=8848.0)

    def fresh_fb(width, height):
        return lambda: (torch.full((height, width), cov._EMPTY,
                                   dtype=torch.int32, device=device),)

    out = [
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
        ("refine", "R1 refine, 1080p static camera, ridged6, cap 4096",
         refine_call(device), tuple),
        ("field", "K5 field 6x2048^2",
         lambda: field_cuda.field_kernel(2048, 6371000.0, device=device),
         tuple),
    ]
    out += order_calls(device)
    for name, fs in sets.items():
        span_buf, _, counts = cc.route_records(fs["tm"], fs["live"],
                                               fs["span"])
        out.append(("span" if name == "1080p static" else None,
                    f"K2 span, {name}, {fs['span_recs'].shape[0]} records",
                    lambda fb, b=span_buf, c=counts: cc.raster_span_cuda(
                        b, fb, count=c[0:1]),
                    fresh_fb(fs["width"], fs["height"])))
        if fs["huge_recs"].shape[0]:
            hrecs = fs["huge_recs"]
            out.append(("huge" if name == "golden nearclip" else None,
                        f"K3 huge, {name}, {hrecs.shape[0]} records",
                        lambda fb, h=hrecs: cc.raster_huge_cuda(h, fb),
                        fresh_fb(fs["width"], fs["height"])))
    tri = screen_triangle_records(SCENE_W, SCENE_H, device)
    out.append((None, "K3 huge, screen-filling triangle 1080p, 2 records",
                lambda fb: cc.raster_huge_cuda(tri, fb),
                fresh_fb(SCENE_W, SCENE_H)))
    for name, sargs in splat_inputs(device).items():
        out.append(("splat" if name == "DeviceRenderer rows" else None,
                    f"S1 splat, {name}",
                    lambda a=sargs: splat.splat_keys_cuda(*a), tuple))
    main = "1080p static, DeviceRenderer rows"
    setups = setup_inputs(device)
    for name, args in setups.items():
        out.append(("setup" if name == main else None, f"C1 setup, {name}",
                    lambda a=args: cc.setup_cuda(*a), tuple))
    out += clip_pass_calls(clip_inputs(setups))
    tess = tess_inputs(device)
    for name, args in tess.items():
        out.append(("tess" if name == main else None, f"V1 tess, {name}",
                    lambda a=args: vertex_cuda.tessellate_shaded_cuda(*a),
                    tuple))
    for label, args in tess_probes(tess[main]).items():
        out.append((None, f"V1 probe, {label}",
                    lambda a=args: vertex_cuda.tessellate_shaded_cuda(*a),
                    tuple))
    caches, rows = stage_inputs(device)
    for name, (pool, args, kw) in caches.items():
        out.append(("cache" if name == STAGE_MAIN else None,
                    f"A1 cache, {name}",
                    lambda p, a=args, k=kw: device_pool_cuda
                    .cache_stage_cuda(p, *a, **k),
                    lambda p=pool: (type(p)(*(t.clone() for t in p)),)))
    for name, args in rows.items():
        out.append(("uniforms" if name == STAGE_MAIN else None,
                    f"U1 uniforms, {name}",
                    lambda a=args[:9]: uniforms_cuda.uniforms_cuda(*a),
                    tuple))
    # the fused step's tessellate stage: U1, then V1 on its outputs,
    # against V1's rows mode
    for name, args in rows.items():
        out.append(("tess_pair" if name == ROWS_MAIN else None,
                    f"U1 + V1, {name}", lambda a=args: u1_then_v1(a), tuple))
        out.append(("tess_rows" if name == ROWS_MAIN else None,
                    f"V1 rows, {name}",
                    lambda a=args: vertex_cuda.tessellate_rows_cuda(*a),
                    tuple))
    # the staging's share: every row a padding row (zero DF corners),
    # beside V1's "every row padding" probe
    pad = list(rows[ROWS_MAIN])
    pad[4], pad[5] = (torch.zeros_like(t) for t in pad[4:6])
    out.append((None, "V1 rows probe, every row padding",
                lambda a=tuple(pad): vertex_cuda.tessellate_rows_cuda(*a),
                tuple))
    p64 = p64_route_inputs(device) if p64 is None else p64
    for key, label, r in (("gather", ROUTE_1080P, sets["1080p static"]),
                          (None, ROUTE_P64, p64)):
        out.append((key, label,
                    lambda r=r: cc.route_records_cuda(r["tm"], r["live"],
                                                      r["span"]), tuple))
    return out


def u1_then_v1(args):
    """The tessellate stage as two kernels: U1 on the first nine of V1's
    rows-mode arguments, then V1 on its outputs, the tiles, the
    view-projection and the grid."""
    from planet_tpu_torch.tess import uniforms_cuda, vertex_cuda

    u = uniforms_cuda.uniforms_cuda(*args[:9])
    return vertex_cuda.tessellate_shaded_cuda(
        u.corners_rel, u.normals, args[9], u.vx, u.vy, u.skirt, args[10],
        args[11])


def host_calls(sets: dict) -> list:
    """[(label, call)] timed by the host clock (host_ms): the 1080p scene's
    route and gather, one route_records."""
    from planet_tpu_torch.raster import coverage_cuda as cc

    fs = sets["1080p static"]
    return [("K6 route + gather, 1080p, host clock",
             lambda: cc.route_records_cuda(fs["tm"], fs["live"], fs["span"]))]


def build_report(cuda_module, common) -> list:
    """The lines that describe the kernel library as this run loaded it:
    ptxas' report of each kernel (registers, shared memory, spills) when
    the run built it, and a census of the compiled instructions of the
    noise, field, tile, setup and refine kernels (common.sass_census)
    where the toolkit has cuobjdump."""
    lines = [f"ptxas: {line.strip()}" for line in
             cuda_module.build_info.get("log", "").splitlines()
             if any(k in line for k in ("registers", "spill", "Compiling"))]
    for name, counts in common.sass_census(
            cuda_module.build_info["path"]).items():
        lines.append(f"sass {name[:70]}: " + " ".join(
            f"{op} {k}" for op, k in counts.items()))
    return lines


# f32 operations per element beyond the noise core's (tools/common's
# counts), from the kernel bodies in planet_tpu_torch/csrc, counted as
# tools/common counts them (integer hashing and conversions not counted,
# so each bound is a floor): K5's texel (field.cu: coordinates 84 with 5
# error-free products, the amplitude, normal and shade 16); K2/K3's
# function (raster.cu) per bbox row, its exact interval (per edge the
# line's boundary estimate 4 and the exact edge test on either side of it
# 2 x 5), per pixel inside the interval fragment()'s edge functions and
# tests, per accepted fragment the depth, normal, shade and packing; S1's
# fragment of a valid cell (splat.cu: the blend of 5 values 35, the w test
# and reciprocal 2, the NDC 3, the pixel 8, range and depth tests 2, the
# two clamped quantizations 10)
OPS_FIELD_TEXEL = 101
OPS_RASTER_ROW = 3 * (4 + 2 * 5)
OPS_RASTER_CANDIDATE = 15
OPS_RASTER_ACCEPTED = {"span": 41, "huge": 48}
OPS_SPLAT_FRAGMENT = 60


def raster_bound(kernel: str, recs, width: int, height: int, clock=None):
    """K2's or K3's (`kernel` "span" or "huge") (least ms, by) on records
    `recs`, a property of the function: each bbox row's exact interval
    found (coverage_cuda.row_intervals_plain counts the rows and the
    pixels inside them), each pixel inside tested, each covered pixel
    took at least one accepted fragment; the records read once and each
    covered pixel's key read and written once."""
    import torch

    from planet_tpu_torch.raster import coverage as cov
    from planet_tpu_torch.raster import coverage_cuda as cc
    from planet_tpu_torch.tools import common

    fb = torch.full((height, width), cov._EMPTY, dtype=torch.int32,
                    device=recs.device)
    (cc.raster_span_cuda if kernel == "span" else cc.raster_huge_cuda)(
        recs, fb)
    _, _, lo, hi = cc.row_intervals_plain(recs)
    inside = float((hi - lo + 1).clamp_min(0).sum())
    covered = int((fb != cov._EMPTY).sum())
    return common.bound_ms(
        lo.numel() * OPS_RASTER_ROW + inside * OPS_RASTER_CANDIDATE
        + covered * OPS_RASTER_ACCEPTED[kernel],
        recs.shape[0] * 128 + 2 * covered * 4, sm_clock_hz=clock)


def bounds(device, sets: dict, clock=None) -> dict:
    """{key: (least ms, by)} (tools/common.bound_ms at SM clock `clock`)
    of each kernel at the shape `calls` times it at under that key: K1 on
    its 256 tiles, K4 at the refine probes, R1 on the static camera (its
    leaves and their splits), D1 on the flight's most leaves, K5 at 6 x
    2048^2, K2 and K3 on the record sets of `sets` (record_sets) that
    `calls` keys, K6 on the 1080p scene (route_bound), C1 and C2 on the
    static camera's DeviceRenderer rows, V1 on tess_inputs' rows, A1 and
    U1 on STAGE_MAIN, V1's rows mode on ROWS_MAIN and S1 on splat_inputs'
    DeviceRenderer rows; each count of live work read from the kernel's
    own output."""
    import numpy as np
    import torch

    from planet_tpu_torch.cache import device_pool_cuda
    from planet_tpu_torch.raster import coverage_cuda as cc
    from planet_tpu_torch.raster import splat
    from planet_tpu_torch.tess import uniforms_cuda, vertex_cuda
    from planet_tpu_torch.tools import common

    def bound(ops, nbytes, f64_ops=0.0):
        return common.bound_ms(ops, nbytes, f64_ops=f64_ops,
                               sm_clock_hz=clock)

    out = {}
    octs = 6 + np.arange(256) % 13
    work = [common.noise_work(o) for o in octs]
    texel = common.OPS_TILE_UV + common.OPS_TILE_BLEND + 1
    out["tile"] = bound(1024 * sum(texel + w[0] for w in work),
                        len(octs) * (2 * 12 * 4 + 4 + 1024 * 4),
                        1024 * sum(w[1] for w in work))
    n4 = 5 * 4096
    ops4, f64_4 = common.noise_work(6)
    out["noise"] = bound(n4 * ops4, n4 * 28, n4 * f64_4)
    # D1: 224 B a live row (27 words read and written, an 8-byte key)
    out["order"] = bound(0.0, 224 * ORDER_LEAVES[1])
    n_r1 = int(refine_call(device)()[2])
    splits = (n_r1 - 6) // 3            # each split slot's 4 children
    ops_r1, f64_r1 = common.refine_work(n_r1 + splits, splits)
    # read once: the camera and the six roots; written once: the (27,
    # cap) leaf rows, n_leaves and the flag
    out["refine"] = bound(ops_r1,
                          24 + 6 * (3 * 4 + 2 * 48) + 4096 * 27 * 4 + 5,
                          f64_r1)
    texels = 6 * 2048 * 2048
    ops5, f64_5 = common.noise_work(6)
    out["field"] = bound(texels * (OPS_FIELD_TEXEL + ops5), texels * 8,
                         texels * f64_5)
    for key, name, recs in (("span", "1080p static", "span_recs"),
                            ("huge", "golden nearclip", "huge_recs")):
        fs = sets[name]
        out[key] = raster_bound(key, fs[recs], fs["width"], fs["height"],
                                clock)
    out["gather"] = route_bound(sets["1080p static"])
    main = "1080p static, DeviceRenderer rows"
    args = setup_inputs(device)[main]
    c1 = cc.setup_cuda(*args)
    out["setup"] = bound(*common.setup_work(
        int(args[7][0]), args[0].shape[1], c1[1].numel(), int(c1[1].sum())))
    cargs = clip_inputs({main: args})[main]
    c2 = cc.clip_pass_cuda(*cargs)
    blocks, slots = cargs[3], cargs[7]
    out["clip"] = bound(*common.clip_work(
        blocks.numel(), slots, min(int(c1[3].sum()), slots), int(c2[3][0]),
        int((blocks > 0).sum())))
    targs = tess_inputs(device)[main]
    grid = vertex_cuda.tessellate_shaded_cuda(*targs)[0].clip.shape[1]
    out["tess"] = bound(*common.tess_work(
        targs[2].shape[0], grid, common.tess_slerps(targs[1], grid),
        live=int(common.tess_live(targs[1]).sum())))
    caches, rows = stage_inputs(device)
    pool, aargs, kw = caches[STAGE_MAIN]
    generated = int(device_pool_cuda.cache_stage_cuda(
        type(pool)(*(t.clone() for t in pool)), *aargs, **kw).n_generated)
    out["cache"] = bound(*common.cache_work(
        aargs[0].shape[0], pool.capacity, int(aargs[5]), generated,
        kw["gen_cap"]))
    out["uniforms"] = bound(*common.uniforms_work(rows[STAGE_MAIN][0]
                                                  .shape[0]))
    rargs = rows[ROWS_MAIN]
    normals = uniforms_cuda.uniforms_cuda(*rargs[:9]).normals
    out["tess_rows"] = bound(*common.tess_rows_work(
        rargs[0].shape[0], rargs[11], common.tess_slerps(normals, rargs[11]),
        live=int(common.tess_live(normals).sum())))
    clip, _, sv, _, _, ss, _ = sargs = splat_inputs(device)[
        "DeviceRenderer rows"]
    cells = int((sv[:, :-1, :-1] & sv[:, :-1, 1:] & sv[:, 1:, :-1]
                 & sv[:, 1:, 1:]).sum())
    covered = int((splat.splat_keys_cuda(*sargs) != splat._EMPTY).sum())
    g = clip.shape[1]
    out["splat"] = bound(cells * ss * ss * OPS_SPLAT_FRAGMENT,
                         clip.shape[0] * g * g * 21 + covered * 4)
    torch.cuda.synchronize()
    return out


def measure(reps: int = 7) -> dict:
    """On the card: the queued ms of every call of `calls` and of t_noise's
    variants and the host-clock ms of `host_calls`: {"ms": {label: ms},
    "keys": {key: label}, "bounds": {K6's two labels: [least ms, by]},
    "sectors": {K6's 1080p label: the distinct 32-byte sectors its live
    records' reads touch}, "sets": the record sets}."""
    import torch

    from planet_tpu_torch.tools import common, noise_stages

    common.QUEUE_S = max(common.QUEUE_S, QUEUE_S)
    dev = torch.device("cuda")
    sets = record_sets(dev)
    p64 = p64_route_inputs(dev)
    runs, keys = {}, {}
    for key, label, fn, setup in calls(dev, sets, p64=p64):
        runs[label] = (fn, setup)
        if key:
            keys[key] = label
    points = noise_stages.noise_inputs(1 << 22, dev)
    for name in noise_stages.NOISE_VARIANTS:
        runs[f"t_noise {name}"] = (
            lambda name=name: noise_stages.noise_stage(name, points), tuple)
    ms = {}
    for name, (fn, setup) in runs.items():
        fn(*setup())
        ms[name] = common.time_ms(fn, setup, reps=reps)
    for name, fn in host_calls(sets):
        fn()
        ms[name] = host_ms(fn, reps=reps)
    torch.cuda.synchronize()
    fs = sets["1080p static"]
    return dict(
        ms=ms, keys=keys, sets=sets,
        bounds={ROUTE_1080P: route_bound(fs), ROUTE_P64: route_bound(p64)},
        sectors={ROUTE_1080P: gather_sectors(
            torch.cat([fs["span_idx"], fs["huge_idx"]]), fs["tm"].shape[1])})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                         .parents[2]))
    p.add_argument("--reps", type=int, default=7)
    args = p.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch

    from planet_tpu_torch import _cuda
    from planet_tpu_torch.tools import common

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    _cuda.library()
    for line in build_report(_cuda, common):
        print(line, flush=True)
    r = measure(args.reps)
    print(common.card_line())
    print(json.dumps({"root": args.root, "ms": r["ms"], "bounds": r["bounds"],
                      "sectors": r["sectors"],
                      "build_s": _cuda.build_info.get("seconds")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
