#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (planet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
result line is printed:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
   no CUDA device -> exit 2;
2. build the CUDA kernels from planet_tpu_torch/csrc (nvcc, ctypes);
3. every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with CUDA-event times (median of 7):
   K1 tiles (bitwise, lacunarity 2.0 and 1.7), K4 noise (bitwise, at the
   refine-probe shape 5 x 4096 x 6 octaves, at 2^20 points x 18 octaves,
   and fBm at lacunarity 1.7), K6 record gather (bitwise), K2 span and K3
   huge raster (coverage identical, packed depth/shade within 1 quantum);
4. the host-orchestrated path, PlanetEngine(...).render on the card,
   against the oracle's frame / nearclip / farclip golden images at their
   test bars;
5. that path at real size: the 1920x1080 static scene (3 frames,
   per-stage ms) and 8 frames of a descending orbit;
5a. the fused device frame's CUDA graph: two replays of the geometry step
   bitwise equal to the same step run eagerly on the card, the replay's
   CUDA-event time, and a torch.profiler trace of one replay whose device
   events include the K1 and K4 kernels;
5b. the fused device frame, DeviceRenderer(...).render through graph
   replays: the golden / nearclip / farclip scenes at their bars, the
   1920x1080 static scene (10 frames) and the 8-frame orbit, each orbit
   frame's leaf ids equal to phase 5's PlanetEngine on the same camera;
6. launch counts: each kernel of each path launched during that path's
   phases (4-5: tile, gather, span, huge; 5b: those and noise) > 0;
7. the cube-sphere field path (models/heightfield), counts reset before
   and read after: config 1 (flat 256x256 patch, fBm 4, through K4)
   bitwise equal to K4's plain version on the same noise coordinates and
   within 2e-5 of the host numpy fBm; config 2 (frame_cube(1024), ridged
   6, K5); the frame step frame_cube(2048) timed with CUDA events (median
   of REPS warm calls); config 5 on one card, the 6x8192^2 field as 8
   strips of 1024 rows, each bitwise equal to K5's plain version on the
   same rows and to the matching rows of one field_cube(8192); the field
   kernel launched > 0 times;
7b. K5 against its plain version bitwise at 6x1024^2 and 6x2048^2, the
   composed frame (fused=False) within 0.2 m in heights and 1e-3 in shade
   (tests/test_field_pallas.py's bars), and the kernel, plain and
   composed frame times at both sizes;
8. the kernel-attribution tools (planet_tpu_torch/tools, the T rows),
   counts reset before and read after: noise_stages (t_noise, t_tile),
   lut (t_lut) and span_parts (t_span) at the tools' own sizes, every
   variant against its plain version (bitwise; full span at K2's bar,
   the block-vectorized span also equal to full), full noise equal to K4
   and full tile equal to K1 on the same inputs, each variant's time, and
   each t_* kernel launched > 0 times; then K1-K6 (and K6's yardstick)
   again at their phase-3 (and K5 at its 7b) shapes with the tools' queued
   timer
   (tools/common.time_calls: calls queued behind a spin kernel, so a short
   kernel's time holds no host launch time).

The second-to-last lines are a JSON summary of the kernels (launches from
phase 5b, from phase 7 for the field kernel and from phase 8 for the t_*
kernels, which also carry each variant's ms; each kernel's time, its
plain version's, a library call's where one computes the same function,
and its bound: the larger of its bytes over the card's memory rate and
its f32 operations over the card's f32 rate) and the card's
`nvidia-smi --query-gpu=name,power.limit` line; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
GOLD = ROOT / "tests" / "goldens"
W_1080, H_1080 = 1920, 1080
REPS = 7
DEVICE = "cuda"
# the field path's sizes: config 1's patch, config 2's cube, the frame
# step's cube, config 5's cube and its strips of rows
FIELD_N = dict(config1=256, config2=1024, step=2048, config5=8192)
CONFIG5_STRIPS = 8


# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# f32 outside the tensor cores, and HBM.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

# f32 operations per element, counted from the kernel bodies in
# planet_tpu_torch/csrc: each add, subtract, multiply, divide, square root,
# compare and min/max is one operation (-fmad=false: no FMA). Integer
# hashing, conversions and the f64 fraction and fade are not counted, so
# the bound is a floor.
OPS_SPLIT = 96              # noise.cuh: int24_parts of a point, 3 axes
OPS_OCTAVE = {"ridged": 92, "fbm": 88}    # noise3 (85) + the octave update
OPS_OCTAVE_SPLIT = 153      # noise.cuh at lacunarity != 2: df_scale and
                            # floor_split_parts per octave, 3 axes
OPS_TILE_TEXEL = 565        # tile.cu: uv (2 df_scale) + 3 x (5 df_add +
                            # 3 df_mul) + the amplitude
OPS_FIELD_TEXEL = 176       # field.cu: coordinates, DF sqrt/div/products,
                            # the amplitude, the normal and the shade
OPS_CANDIDATE = 15          # raster.cu fragment(): 3 edge functions, tests
OPS_ACCEPTED = {"span": 41, "huge": 48}   # depth, normal, shade, packing


def bound_ms(ops, nbytes):
    """(least ms, "operations" or "bytes"): the larger of the f32
    operations over the f32 rate and the bytes over the memory rate."""
    t_ops = ops / PEAK_F32_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def same_bits(a, b) -> bool:
    """Bitwise equality that also holds for equal NaNs (the padding rows of
    the device frame's vertex arrays are NaN, as in planet_tpu)."""
    import torch
    if a.dtype == b.dtype and a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def ssim(a, b, window: int = 8) -> float:
    """Mean local SSIM over non-overlapping windows (tests/test_golden_frame)."""
    h = a.shape[0] // window * window
    w = a.shape[1] // window * window

    def blocks(x):
        return x[:h, :w].reshape(h // window, window, w // window, window) \
            .transpose(0, 2, 1, 3).reshape(-1, window * window)

    xa, xb = blocks(a.astype(np.float64)), blocks(b.astype(np.float64))
    mu_a, mu_b = xa.mean(1), xb.mean(1)
    va, vb = xa.var(1), xb.var(1)
    cov = ((xa - mu_a[:, None]) * (xb - mu_b[:, None])).mean(1)
    c1, c2 = 0.01**2, 0.03**2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2)))
    return float(s.mean())


def main() -> int:
    import torch

    # ------------------------------------------------------------ phase 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels need one", file=sys.stderr)
        return 2
    smi = gpu_line()
    print(f"[1] gpu: {smi}", flush=True)
    print(f"[1] torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)

    from planet_tpu_torch import _cuda
    from planet_tpu_torch.engine import device_step
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.engine.planet import STAGES, PlanetEngine
    from planet_tpu_torch.geom import camera as cam_mod
    from planet_tpu_torch.geom import quadid
    from planet_tpu_torch.lod import refine as lod_refine
    from planet_tpu_torch.models import heightfield
    from planet_tpu_torch.nums import df as dfm
    from planet_tpu_torch.ops import perlin_np
    from planet_tpu_torch.ops.kernels import field_cuda, perlin_cuda, tile_cuda
    from planet_tpu_torch.raster import coverage as cov
    from planet_tpu_torch.raster import coverage_cuda as cc
    from planet_tpu_torch.raster import nearclip
    from planet_tpu_torch.tess import mesh

    dev = torch.device(DEVICE)

    # ------------------------------------------------------------ phase 2
    _cuda.library()
    print(f"[2] built kernels in {_cuda.build_info['seconds']:.2f} s "
          f"({_cuda.build_info['path']})", flush=True)
    for line in _cuda.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[2]   {line.strip()}", flush=True)

    # ------------------------------------------------------------ phase 3
    def time_ms(fn, setup=lambda: ()):
        times = []
        for _ in range(REPS):
            args = setup()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    cfg800 = EngineConfig()
    cfg1080 = EngineConfig(window_w=W_1080, window_h=H_1080)
    report = {}

    def scene_cam(name):
        return cam_mod.Camera(position=np.load(GOLD / f"{name}_cam.npy"),
                              angles=np.load(GOLD / f"{name}_angles.npy"))

    def bench_cam():
        # bench.py's 1080p LOD scene: 20 km above the surface
        cdir = np.array([0.2, 0.5, -0.8])
        cdir /= np.linalg.norm(cdir)
        return cam_mod.Camera(position=cdir * (cfg1080.radius + 20000.0),
                              angles=np.array([0.35, 0.3, 0.0], np.float32))

    # tools/bench_moving.py's descending orbit, camera in numpy
    orbit_alts = np.linspace(20000.0, 3000.0, 48)[:8]

    def orbit_cams():
        for i, alt in enumerate(orbit_alts):
            theta = i * 1e-3
            cdir = np.array([np.cos(theta) * 0.8, 0.6, np.sin(theta) * 0.8])
            cdir /= np.linalg.norm(cdir)
            yield cam_mod.Camera(position=cdir * (cfg1080.radius + alt),
                                 angles=np.array([0.35, theta, 0.0],
                                                 np.float32))

    # K1: 256 tiles from the 1080p scene's leaves, octave counts 6..18
    leaves = lod_refine.refine(bench_cam().position, cfg1080.max_lod,
                               cfg1080.radius)
    sel = np.arange(256) % len(leaves.ids)
    ch, cl = dfm.from_f64_np(leaves.corners[sel] * cfg1080.coord_scale)
    ch, cl = torch.as_tensor(ch, device=dev), torch.as_tensor(cl, device=dev)
    octs = torch.as_tensor(6 + np.arange(256, dtype=np.int32) % 13,
                           device=dev)
    kw = dict(kind="ridged", gain=cfg1080.gain, amplitude=cfg1080.amplitude)
    k1_args = (ch, cl, octs)
    k1 = tile_cuda.tiles_cuda(ch, cl, octs, lacunarity=2.0, **kw)
    p1 = tile_cuda.tiles_plain(ch, cl, octs, lacunarity=2.0, **kw)
    torch.cuda.synchronize()
    err1 = float((k1 - p1).abs().max())
    check(torch.isfinite(k1).all(), "K1 produced non-finite heights")
    check(torch.equal(k1, p1), f"K1 != plain (max abs err {err1})")
    k17 = tile_cuda.tiles_cuda(ch, cl, octs, lacunarity=1.7, **kw)
    p17 = tile_cuda.tiles_plain(ch, cl, octs, lacunarity=1.7, **kw)
    check(torch.equal(k17, p17), "K1 (lacunarity 1.7) != plain (max abs "
          f"err {float((k17 - p17).abs().max())})")
    octs_np = octs.cpu().numpy().astype(np.int64)
    report["tile"] = dict(
        max_abs_err=max(err1, float((k17 - p17).abs().max())),
        ms=time_ms(lambda: tile_cuda.tiles_cuda(ch, cl, octs, **kw)),
        plain_ms=time_ms(lambda: tile_cuda.tiles_plain(ch, cl, octs, **kw)),
        bound=bound_ms(
            1024 * float((OPS_TILE_TEXEL + OPS_SPLIT
                          + OPS_OCTAVE["ridged"] * octs_np).sum()),
            len(octs_np) * (2 * 12 * 4 + 4 + 1024 * 4)))
    print(f"[3] K1 tiles: 256 tiles x octaves 6-18 bitwise equal "
          f"(lacunarity 2.0 and 1.7); kernel {report['tile']['ms']:.3f} ms, "
          f"plain {report['tile']['plain_ms']:.3f} ms", flush=True)

    # K4: the refine probes' shape (5 points x 4096 frontier slots, 6
    # ridged octaves) from the 1080p scene's leaf corners in noise space,
    # then 2^20 seeded points on the sphere x 18 octaves
    def noise_inputs(pts):
        out = []
        for a in range(3):
            out += [torch.as_tensor(np.ascontiguousarray(x), device=dev)
                    for x in dfm.from_f64_np(pts[..., a] * 1e-5)]
        return out

    rng = np.random.default_rng(0)
    probe_pts = leaves.corners.reshape(-1, 3)[np.arange(5 * 4096)
                                              % (4 * len(leaves.ids))]
    probe_pts = (probe_pts + rng.normal(0.0, 50.0, probe_pts.shape)) \
        .reshape(5, 4096, 3)
    big = rng.normal(size=(1 << 20, 3))
    big = big / np.linalg.norm(big, axis=1, keepdims=True) * cfg1080.radius
    err4 = 0.0
    for label, pts, kind, lac, octaves in (
            ("refine probes 5x4096, ridged 6", probe_pts, "ridged", 2.0, 6),
            ("2^20 points, ridged 18", big, "ridged", 2.0, 18),
            ("refine probes 5x4096, fbm 5, lacunarity 1.7", probe_pts, "fbm",
             1.7, 5)):
        c4 = noise_inputs(pts)
        kw4 = dict(lacunarity=lac, gain=cfg1080.gain, octaves=octaves)
        k4 = perlin_cuda.noise_cuda(kind, *c4, **kw4)
        p4 = perlin_cuda.noise_plain(kind, *c4, **kw4)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(k4).all()), f"K4 {label}: not finite")
        e = float((k4 - p4).abs().max())
        check(torch.equal(k4, p4), f"K4 {label}: != plain (max abs err {e})")
        err4 = max(err4, e)
        ms = time_ms(lambda: perlin_cuda.noise_cuda(kind, *c4, **kw4))
        plain_ms = time_ms(lambda: perlin_cuda.noise_plain(kind, *c4, **kw4))
        per_octave = OPS_OCTAVE[kind] + (0 if lac == 2.0 else OPS_OCTAVE_SPLIT)
        n4 = c4[0].numel()
        bound4 = bound_ms(n4 * ((OPS_SPLIT if lac == 2.0 else 0)
                                + octaves * per_octave), n4 * 28)
        print(f"[3] K4 noise, {label}: bitwise equal; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound4[0]:.5f} ms "
              f"({bound4[1]})", flush=True)
        if "noise" not in report:       # the main path's shape
            report["noise"] = dict(ms=ms, plain_ms=plain_ms, bound=bound4)
    report["noise"]["max_abs_err"] = err4

    def scene_setup(cfg, cam):
        eng = PlanetEngine(cfg, device=dev)
        out = eng.frame(cam)
        gm = mesh.grid_uv_skirt(cfg.patch_verts)[3]
        valid = torch.as_tensor(np.broadcast_to(
            gm[None], (out.n_leaves,) + gm.shape).copy(), device=dev)
        return out.vertices.clip, out.vertices.normal, valid

    def raster_compare(name, recs, width, height, kernel, plain, key):
        fbk = torch.full((height, width), cov._EMPTY, dtype=torch.int32,
                         device=dev)
        fbp = fbk.clone()
        kernel(recs, fbk)
        plain(recs, fbp)
        k, p = fbk.cpu().numpy(), fbp.cpu().numpy()
        ck, cp = k != cov._EMPTY, p != cov._EMPTY
        n_cov = int((ck != cp).sum())
        both = ck & cp
        dz = np.abs((k[both] >> 10) - (p[both] >> 10))
        ds = np.abs((k[both] & 1023) - (p[both] & 1023))
        err = int(max(dz.max(initial=0), ds.max(initial=0)))
        n_diff = int((k != p).sum())
        print(f"[3] {key} {name}: {recs.shape[0]} records, "
              f"{int(ck.sum())} px covered, coverage mismatches {n_cov}, "
              f"pixels differing {n_diff}, max packed-field diff {err}",
              flush=True)
        check(n_cov == 0, f"{key} coverage differs from plain on {name}")
        check(err <= 1, f"{key} depth/shade differ by {err} quanta on {name}")
        return err

    def fresh_fb(width, height):
        return lambda: (torch.full((height, width), cov._EMPTY,
                                   dtype=torch.int32, device=dev),)

    def raster_bound(key, recs, width, height):
        """K2/K3's bound on these records: every candidate pixel of a live
        record's bbox is tested, every covered pixel took at least one
        accepted fragment; the records are read and the framebuffer read
        and written once."""
        fb = fresh_fb(width, height)()[0]
        kernel = cc.raster_span_cuda if key == "span" else cc.raster_huge_cuda
        kernel(recs, fb)
        r = recs[recs[:, 28] != 0]
        cand = float(((r[:, 26] - r[:, 24] + 1)
                      * (r[:, 27] - r[:, 25] + 1)).sum())
        covered = int((fb != cov._EMPTY).sum())
        return bound_ms(cand * OPS_CANDIDATE + covered * OPS_ACCEPTED[key],
                        recs.shape[0] * 128 + 2 * width * height * 4)

    # K6 + K2 + K3 at the 1080p scene's shapes
    clip, normal, valid = scene_setup(cfg1080, bench_cam())
    cell_mask = mesh.cell_triangle_mask(cfg1080.patch_verts)
    tm, live, span = cov.setup_t(clip, normal, valid, W_1080, H_1080,
                                 cell_mask, far_w=cfg1080.far_plane)
    span_idx, huge_idx = cc.route(tm, live, span)
    tm1080 = tm
    g6 = cc.gather_records_cuda(tm, span_idx)
    p6 = cc.gather_records_plain(tm, span_idx)
    check(torch.equal(g6, p6), "K6 gather != plain")
    # an out-of-range index must give a dead (all-zero) record
    edge_idx = torch.tensor([0, tm.shape[1], -1], dtype=torch.int32,
                            device=dev)
    check(torch.equal(cc.gather_records_cuda(tm, edge_idx),
                      cc.gather_records_plain(tm, edge_idx)),
          "K6 gather != plain on out-of-range indices")
    # K6's yardstick: one library gather + transpose computes the same
    # records when every index is in range (the port never calls it)
    check(torch.equal(tm.index_select(1, span_idx).t().contiguous(), g6),
          "index_select yardstick != K6")
    report["gather"] = dict(
        max_abs_err=float((g6 - p6).abs().max()) if g6.numel() else 0.0,
        ms=time_ms(lambda: cc.gather_records_cuda(tm, span_idx)),
        plain_ms=time_ms(lambda: cc.gather_records_plain(tm, span_idx)),
        library_ms=time_ms(
            lambda: tm.index_select(1, span_idx).t().contiguous()),
        bound=bound_ms(0, span_idx.numel() * (4 + 128 + 128)))
    print(f"[3] K6 gather: {span_idx.numel()} of {tm.shape[1]} records "
          f"bitwise equal; kernel {report['gather']['ms']:.3f} ms, plain "
          f"{report['gather']['plain_ms']:.3f} ms, index_select + transpose "
          f"{report['gather']['library_ms']:.3f} ms", flush=True)

    area = ((g6[:, 26] - g6[:, 24] + 1) * (g6[:, 27] - g6[:, 25] + 1)).cpu()
    area = area.numpy()
    q = np.quantile(area, [0.5, 0.9, 0.99])
    print(f"[3] 1080p span bbox area (px): n={area.size} p50={q[0]:g} "
          f"p90={q[1]:g} p99={q[2]:g} max={area.max():g} "
          f"share<=4px={float((area <= 4).mean()):.4f} "
          f"share<=16px={float((area <= 16).mean()):.4f} "
          f"total={float(area.sum()):g}", flush=True)

    err2 = raster_compare("1080p scene", g6, W_1080, H_1080,
                          cc.raster_span_cuda, cc.raster_span_plain, "K2")
    report["span"] = dict(
        max_abs_err=err2,
        ms=time_ms(lambda fb: cc.raster_span_cuda(g6, fb),
                   fresh_fb(W_1080, H_1080)),
        plain_ms=time_ms(lambda fb: cc.raster_span_plain(g6, fb),
                         fresh_fb(W_1080, H_1080)),
        bound=raster_bound("span", g6, W_1080, H_1080))
    h6 = cc.gather_records_cuda(tm, huge_idx)
    print(f"[3] 1080p scene: {int(live.sum())} live triangles, "
          f"{span_idx.numel()} span, {huge_idx.numel()} huge", flush=True)

    # golden-frame records: K2 on the frame scene, K3 on the farclip scene
    # (far-straddlers) and on the nearclip scene's clipped triangles
    for name in ("frame", "farclip", "nearclip"):
        clip, normal, valid = scene_setup(cfg800, scene_cam(name))
        tm, live, span = cov.setup_t(clip, normal, valid, 800, 600,
                                     cell_mask, far_w=cfg800.far_plane)
        s_i, h_i = cc.route(tm, live, span)
        recs = cc.gather_records_cuda(tm, s_i)
        err2 = max(err2, raster_compare(name, recs, 800, 600,
                                        cc.raster_span_cuda,
                                        cc.raster_span_plain, "K2"))
        hrecs = cc.gather_records_cuda(tm, h_i)
        smask = nearclip.straddle_mask_t(clip, valid, cell_mask)
        tcl = nearclip.clipped_tris(clip, normal,
                                    torch.nonzero(smask).squeeze(1), 800,
                                    600, far_w=cfg800.far_plane)
        crecs = nearclip.records_from_tris(tcl)[tcl.live]
        hrecs = torch.cat([hrecs, crecs]).contiguous()
        if hrecs.shape[0]:
            err3 = raster_compare(name, hrecs, 800, 600,
                                  cc.raster_huge_cuda, cc.raster_huge_plain,
                                  "K3")
            report["huge"] = dict(
                max_abs_err=max(err3, report.get("huge", {}).get(
                    "max_abs_err", 0)),
                ms=time_ms(lambda fb: cc.raster_huge_cuda(hrecs, fb),
                           fresh_fb(800, 600)),
                plain_ms=time_ms(lambda fb: cc.raster_huge_plain(hrecs, fb),
                                 fresh_fb(800, 600)),
                bound=raster_bound("huge", hrecs, 800, 600),
                shape=f"{name} 800x600, {hrecs.shape[0]} records")
    report["span"]["max_abs_err"] = err2
    if h6.shape[0]:
        raster_compare("1080p scene", h6, W_1080, H_1080,
                       cc.raster_huge_cuda, cc.raster_huge_plain, "K3")
    check("huge" in report, "no huge-kernel records in any scene")
    print(f"[3] K2 span kernel {report['span']['ms']:.3f} ms, plain "
          f"{report['span']['plain_ms']:.3f} ms (1080p); K3 huge kernel "
          f"{report['huge']['ms']:.3f} ms, plain "
          f"{report['huge']['plain_ms']:.3f} ms "
          f"({report['huge']['shape']})", flush=True)

    # ------------------------------------------------------------ phase 4
    def check_golden(tag, name, n_leaves, image, depth, rc):
        """The golden-scene bars (tests/test_golden_*.py)."""
        image, depth = image.cpu().numpy(), depth.cpu().numpy()
        meta = np.load(GOLD / f"{name}_meta.npy")
        gold_img = np.load(GOLD / f"{name}_image.npy")
        gold_dep = np.load(GOLD / f"{name}_depth.npy")
        cm, gc = np.isfinite(depth), np.isfinite(gold_dep)
        agree = float((cm == gc).mean())
        both = cm & gc
        ds = np.abs(image[both] - gold_img[both])
        dd = np.abs(depth[both] - gold_dep[both])
        s = ssim(image, gold_img)
        print(f"[{tag}] {name}: leaves {n_leaves} (oracle {int(meta[0])}), "
              f"coverage agreement {agree:.6f}, shade p99 "
              f"{np.quantile(ds, 0.99) * 1023:.3f}/1023 mean "
              f"{ds.mean() * 1023:.4f}/1023, depth p99 "
              f"{np.quantile(dd, 0.99):.3g}, SSIM {s:.5f}, "
              f"n_tris {rc.n_tris}, n_huge {rc.n_huge}, "
              f"n_straddle {rc.n_straddle} (oracle {int(meta[3])})",
              flush=True)
        check(n_leaves == int(meta[0]), f"{tag} {name}: leaf count")
        check(agree > 0.999, f"{tag} {name}: coverage agreement {agree}")
        check(np.quantile(ds, 0.99) <= 2.5 / 1023, f"{tag} {name}: shade p99")
        check(ds.mean() < 1.0 / 1023, f"{tag} {name}: shade mean")
        check(s > 0.99, f"{tag} {name}: SSIM {s}")
        check(not rc.overflowed, f"{tag} {name}: raster overflow")
        if name == "frame":
            check(np.quantile(dd, 0.99) < 1e-5, f"{tag} frame: depth p99")
        if name == "nearclip":
            check(rc.n_straddle == int(meta[3]), f"{tag} nearclip: straddlers")
            check(0.5 < gc.mean() < 0.95, f"{tag} nearclip: golden coverage")
        if name == "farclip":
            check(int(meta[5]) > 1000, f"{tag} farclip: scene crosses far")

    _cuda.reset_launches()
    huge_by_scene = {}
    for name in ("frame", "nearclip", "farclip"):
        before = _cuda.launches["huge"]
        eng = PlanetEngine(cfg800, device=dev)
        out, image, depth = eng.render(scene_cam(name))
        huge_by_scene[name] = _cuda.launches["huge"] - before
        check_golden(4, name, out.n_leaves, image, depth, eng.last_counters)
    check(huge_by_scene["farclip"] > 0 and huge_by_scene["nearclip"] > 0,
          f"K3 not launched by the farclip/nearclip scenes: {huge_by_scene}")

    # ------------------------------------------------------------ phase 5
    eng = PlanetEngine(cfg1080, device=dev)
    eng.timing = True
    for i in range(3):
        out, image, depth = eng.render(bench_cam())
        st = out.stats
        check(bool(torch.isfinite(image).all()), "1080p image not finite")
        print(f"[5] 1080p static frame {i}: leaves {out.n_leaves}, live "
              f"triangles {eng.last_counters.n_tris}, tiles generated "
              f"{st.tiles_generated}; ms "
              + ", ".join(f"{k} {st.stage_ms[k]:.3f}" for k in STAGES)
              + f"; frame {sum(st.stage_ms.values()):.3f}", flush=True)
    # the same frames without per-stage synchronization: host clock around
    # render + synchronize, as phase 5b times the fused frame
    eng.timing = False
    host_static_ms = []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.render(bench_cam())
        torch.cuda.synchronize()
        host_static_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[5] 1080p static, unsynchronized stages: median of 10 warm "
          f"frames {float(np.median(host_static_ms)):.3f} ms (min "
          f"{min(host_static_ms):.3f}, max {max(host_static_ms):.3f})",
          flush=True)
    eng = PlanetEngine(cfg1080, device=dev)
    eng.timing = True
    orbit_ids = []
    for i, cam in enumerate(orbit_cams()):
        out, image, depth = eng.render(cam)
        orbit_ids.append(out.leaf_ids)
        st = out.stats
        check(bool(torch.isfinite(image).all()), f"orbit frame {i} not finite")
        print(f"[5] orbit frame {i} alt {orbit_alts[i]:.0f} m: leaves "
              f"{out.n_leaves}, tiles generated {st.tiles_generated}, live "
              f"triangles {eng.last_counters.n_tris}, huge "
              f"{eng.last_counters.n_huge}; frame "
              f"{sum(st.stage_ms.values()):.3f} ms", flush=True)
    launches_host = dict(_cuda.launches)

    # ----------------------------------------------------------- phase 5a
    def device_args(cfg, cam, width, height):
        rot = cam_mod.camera_rotation(cam)
        pf = cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg))
        vp = (cam_mod.perspective_lh(pf, width / height, cfg.near_plane,
                                     cfg.far_plane)
              @ cam_mod.view_from_rotation(rot)).astype(np.float32)
        return (*dfm.from_f64_np(cam.position), vp)

    # the graph against the same step run eagerly (launches not counted)
    gargs = device_args(cfg800, scene_cam("frame"), 800, 600)
    rend = device_step.DeviceRenderer(cfg800, 800, 600, device=dev)
    step = device_step.build_geometry_step(cfg800, device=dev)
    pool_g, pool_e = rend.init_pool(), rend.init_pool()
    t0 = time.perf_counter()
    for frame in range(2):
        got = rend.geometry(pool_g, *gargs)
        if frame == 0:
            torch.cuda.synchronize()
            print(f"[5a] first geometry call (warm-up + capture + replay): "
                  f"{time.perf_counter() - t0:.2f} s; graph kernels per "
                  f"replay {rend._tally}", flush=True)
        want = step(pool_e, *(torch.as_tensor(a, device=dev) for a in gargs))
        for field in ("leaf_lo", "leaf_hi", "leaf_depth", "slot", "tiles",
                      "valid", "vertex_shade", "meta"):
            check(same_bits(getattr(got, field), getattr(want, field)),
                  f"graph replay != eager step: {field} (frame {frame})")
        for a, b in zip(got.vertices, want.vertices):
            check(same_bits(a, b), f"graph replay != eager step: vertices "
                  f"(frame {frame})")
    print("[5a] two graph replays bitwise equal to the eager step (leaf "
          "ids, slots, tiles, vertices, shade, counters)", flush=True)
    replay_ms = time_ms(lambda: rend.geometry(pool_g, *gargs))
    print(f"[5a] geometry replay (refine -> tessellate, golden camera, "
          f"warm pool): {replay_ms:.3f} ms (CUDA events, median of "
          f"{REPS})", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        rend.geometry(pool_g, *gargs)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0]
    names = " ".join(e.key for e in events)
    busy_us = sum(e.device_time_total for e in events)
    print(f"[5a] profiler, one replay: {sum(e.count for e in events)} device "
          f"events, {len(events)} distinct, {busy_us / 1e3:.3f} ms device "
          f"time; K1 {'tiles_kernel' in names}, K4 "
          f"{'noise_kernel' in names}", flush=True)
    for e in sorted(events, key=lambda e: -e.device_time_total)[:6]:
        print(f"[5a]   {e.device_time_total / 1e3:8.3f} ms x{e.count:5d}  "
              f"{e.key[:90]}", flush=True)
    check("tiles_kernel" in names and "noise_kernel" in names,
          "the profiled replay shows no K1/K4 kernel")
    del rend, step, pool_g, pool_e, got, want

    # ----------------------------------------------------------- phase 5b
    _cuda.reset_launches()

    def converge(rend, pool, cam, width, height, tag):
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fr = rend.render(pool, *device_args(rend.cfg, cam, width, height))
            torch.cuda.synchronize()
            print(f"[5b] {tag} frame {i}: leaves {fr.n_leaves}, tiles "
                  f"generated {fr.n_generated}, overflowed {fr.overflowed}; "
                  f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
            if fr.n_generated == 0:
                return fr
        raise SmokeFailure(f"{tag}: still generating after 4 frames")

    rend = device_step.DeviceRenderer(cfg800, 800, 600, device=dev)
    for name in ("frame", "nearclip", "farclip"):
        fr = converge(rend, rend.init_pool(), scene_cam(name), 800, 600, name)
        check(not fr.overflowed, f"5b {name}: overflowed")
        check_golden("5b", name, fr.n_leaves, fr.image, fr.depth,
                     rend.last_counters)

    rend = device_step.DeviceRenderer(cfg1080, W_1080, H_1080, device=dev)
    pool = rend.init_pool()
    static_ms = []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = rend.render(pool, *device_args(cfg1080, bench_cam(), W_1080,
                                            H_1080))
        torch.cuda.synchronize()
        static_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(fr.image).all()), "5b 1080p not finite")
        check(not fr.overflowed, "5b 1080p static: overflowed")
        print(f"[5b] 1080p static frame {i}: leaves {fr.n_leaves}, tiles "
              f"generated {fr.n_generated}, live triangles "
              f"{rend.last_counters.n_tris}; frame {static_ms[-1]:.3f} ms",
              flush=True)
    print(f"[5b] 1080p static: median of frames 2-9 "
          f"{float(np.median(static_ms[2:])):.3f} ms", flush=True)
    # where a warm fused frame's time goes: the geometry graph replay
    # (inputs copied in, replay, synchronize), then the raster
    split = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        geom = rend.geometry(pool, *device_args(cfg1080, bench_cam(), W_1080,
                                                H_1080))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        device_step.raster(geom, cfg1080, W_1080, H_1080)
        torch.cuda.synchronize()
        split.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    print("[5b] 1080p static, geometry replay / raster ms: "
          + ", ".join(f"{g:.3f}/{r:.3f}" for g, r in split), flush=True)
    pool = rend.init_pool()
    for i, cam in enumerate(orbit_cams()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = rend.render(pool, *device_args(cfg1080, cam, W_1080, H_1080))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        geom = rend.last_geometry
        ids = quadid.from_words(geom.leaf_lo[:fr.n_leaves].cpu().numpy(),
                                geom.leaf_hi[:fr.n_leaves].cpu().numpy())
        same = np.array_equal(ids, orbit_ids[i])
        print(f"[5b] orbit frame {i} alt {orbit_alts[i]:.0f} m: leaves "
              f"{fr.n_leaves} (PlanetEngine {len(orbit_ids[i])}, ids "
              f"{'equal' if same else 'DIFFER'}), tiles generated "
              f"{fr.n_generated}, overflowed {fr.overflowed}; frame "
              f"{ms:.3f} ms", flush=True)
        check(bool(torch.isfinite(fr.image).all()), f"5b orbit {i}: finite")
        check(same, f"5b orbit frame {i}: leaf ids differ from PlanetEngine")
    launches_dev = dict(_cuda.launches)

    # ------------------------------------------------------------ phase 6
    check("jax" not in sys.modules, "jax was imported")
    print(f"[6] launches, host-orchestrated path (phases 4-5): "
          f"{launches_host}", flush=True)
    print(f"[6] launches, fused device path (phase 5b): {launches_dev}",
          flush=True)
    for k in ("tile", "gather", "span", "huge"):
        check(launches_host[k] > 0, f"kernel {k} was not launched by the "
              "host-orchestrated path")
    for k in ("tile", "noise", "gather", "span", "huge"):
        check(launches_dev[k] > 0, f"kernel {k} was not launched by the "
              "fused device path")

    # ------------------------------------------------------------ phase 7
    # the cube-sphere field path, its counts from 0 (BASELINE configs 1, 2
    # and 5; benchmarks/bench_configs.py)
    radius = cfg800.radius
    _cuda.reset_launches()
    # config 1: the flat 256x256 patch, fBm 4 octaves, through K4
    px, py, pz, xyscale = heightfield.flat_patch_points(
        FIELD_N["config1"], extent=256.0, device=dev)
    c1 = heightfield.field_from_padded_points(
        px, py, pz, xyscale, kind="fbm", octaves=4, gain=0.5, coord_scale=1.0,
        amplitude=1.0)
    # config 2: 6 x 1024^2, ridged 6, through K5
    h2, s2 = heightfield.frame_cube(FIELD_N["config2"], radius, fused=True,
                                    device=dev)
    # the frame step, bench.py's frame_step_2048_p50_ms on the port
    heightfield.frame_cube(FIELD_N["step"], radius, device=dev)
    step_ms = time_ms(lambda: heightfield.frame_cube(FIELD_N["step"], radius,
                                                     device=dev))
    # config 5 on one card: 6 x 8192^2 as 8 strips of 1024 rows, each
    # against the matching rows of one full cube
    n5 = FIELD_N["config5"]
    rows5 = n5 // CONFIG5_STRIPS
    # (the plain version launches no counted kernel, so holding each strip
    # against it inside the counted run leaves the counts as they are)
    full_h, full_s = field_cuda.field_cube(n5, radius, device=dev)
    strip_s, strips_equal, strips_plain = [], [], []
    field_err = 0.0
    for i in range(CONFIG5_STRIPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, s = field_cuda.field_cube_strip(n5, radius, i * rows5, rows5,
                                           device=dev)
        torch.cuda.synchronize()
        strip_s.append(time.perf_counter() - t0)
        rows = slice(i * rows5, (i + 1) * rows5)
        strips_equal.append(same_bits(h, full_h[:, rows])
                            and same_bits(s, full_s[:, rows]))
        hp, sp = field_cuda.field_plain(n5, radius, i * rows5, rows5,
                                        device=dev)
        strips_plain.append(same_bits(h, hp) and same_bits(s, sp))
        field_err = max(field_err, float((h - hp).abs().max()),
                        float((s - sp).abs().max()))
        del h, s, hp, sp
    finite5 = bool(torch.isfinite(full_h).all() and
                   torch.isfinite(full_s).all())
    del full_h, full_s
    launches_field = dict(_cuda.launches)

    print(f"[7] launches, field path (phase 7): {launches_field}",
          flush=True)
    check(launches_field["field"] > 0, "the field path launched no K5")
    check(launches_field["noise"] > 0, "config 1 launched no K4")
    pts = [(d[0].double() + d[1].double()).cpu().numpy() for d in (px, py, pz)]
    want1 = perlin_np.fbm(*pts, octaves=4, gain=np.float32(0.5))[1:-1, 1:-1]
    err1 = float(np.abs(c1.heights.cpu().numpy() - want1).max())
    print(f"[7] config 1, flat patch, fBm 4: heights "
          f"{tuple(c1.heights.shape)}, max |h - host fBm| {err1:.3g} (bar "
          f"2e-5), shade in [{float(c1.shade.min()):.4f}, "
          f"{float(c1.shade.max()):.4f}]", flush=True)
    n1 = FIELD_N["config1"]
    check(c1.heights.shape == (n1, n1) and c1.shade.shape == (n1, n1),
          "config 1: shapes")
    check(bool(torch.isfinite(c1.shade).all()), "config 1: shade finite")
    check(err1 <= 2e-5, f"config 1: heights off the host fBm by {err1}")
    # K4 at config 1's own shape against its plain version (not counted)
    plain1 = perlin_cuda.noise_plain(
        "fbm", *heightfield.noise_coords(px, py, pz, 1.0), lacunarity=2.0,
        gain=np.float32(0.5), octaves=4)[1:-1, 1:-1] * np.float32(1.0)
    e1k = float((c1.heights - plain1).abs().max())
    print(f"[7] config 1: K4 heights bitwise equal to K4's plain version "
          f"on the same {n1 + 2}x{n1 + 2} noise coordinates: "
          f"{same_bits(c1.heights, plain1)} (max abs err {e1k})", flush=True)
    check(same_bits(c1.heights, plain1),
          f"config 1: K4 != plain (max abs err {e1k})")
    report["noise"]["max_abs_err"] = max(report["noise"]["max_abs_err"], e1k)
    print(f"[7] frame step frame_cube({FIELD_N['step']}), ridged 6, K5: "
          f"{step_ms:.3f} ms "
          f"(CUDA events, median of {REPS} warm calls)", flush=True)
    print(f"[7] config 5, 6 x {n5}^2 as {CONFIG5_STRIPS} strips of "
          f"{rows5} rows: "
          f"{sum(strip_s):.4f} s in all (" + ", ".join(
              f"{t * 1e3:.2f}" for t in strip_s) + " ms); strips equal to "
          f"the full cube's rows: {strips_equal}; to the plain version's "
          f"rows: {strips_plain} (max abs err {field_err})", flush=True)
    check(all(strips_equal), "config 5: a strip differs from the full cube")
    check(all(strips_plain), f"config 5: a strip differs from the plain "
          f"version (max abs err {field_err})")
    check(finite5, "config 5: the 8192 field is not finite")

    # ----------------------------------------------------------- phase 7b
    # K5 against its plain version and the composed frame (not counted)
    for n in (FIELD_N["config2"], FIELD_N["step"]):
        if n == FIELD_N["config2"]:
            hk, sk = h2, s2
        else:
            hk, sk = field_cuda.field_kernel(n, radius, device=dev)
        hp, sp = field_cuda.field_plain(n, radius, device=dev)
        hc, sc = heightfield.frame_cube(n, radius, fused=False, device=dev)
        check(hk.shape == sk.shape == (6, n, n), f"K5 {n}: shapes")
        check(bool(torch.isfinite(hk).all() and torch.isfinite(sk).all()),
              f"K5 {n}: not finite")
        e = max(float((hk - hp).abs().max()), float((sk - sp).abs().max()))
        check(same_bits(hk, hp) and same_bits(sk, sp),
              f"K5 {n}: != plain (max abs err {e})")
        field_err = max(field_err, e)
        eh = float((hk - hc).abs().max())
        es = float((sk - sc).abs().max())
        check(eh <= 0.2 and es <= 1e-3, f"K5 {n}: off the composed frame "
              f"by {eh} m / {es} in shade")
        del hk, sk, hp, sp, hc, sc
        ms = time_ms(lambda: field_cuda.field_kernel(n, radius, device=dev))
        plain_ms = time_ms(lambda: field_cuda.field_plain(n, radius,
                                                          device=dev))
        comp_ms = time_ms(lambda: heightfield.frame_cube(
            n, radius, fused=False, device=dev))
        texels = 6 * n * n
        report["field"] = dict(ms=ms, plain_ms=plain_ms, bound=bound_ms(
            texels * (OPS_FIELD_TEXEL + OPS_SPLIT + 6 * OPS_OCTAVE["ridged"]),
            texels * 8))
        print(f"[7b] K5 field 6x{n}^2: bitwise equal to plain; composed "
              f"frame within {eh:.4g} m / {es:.3g}; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, composed frame {comp_ms:.3f} ms, "
              f"bound {report['field']['bound'][0]:.4f} ms "
              f"({report['field']['bound'][1]})", flush=True)
    report["field"]["max_abs_err"] = field_err
    del h2, s2

    # ------------------------------------------------------------ phase 8
    # the kernel-attribution tools, their counts from 0
    from planet_tpu_torch.tools import common as tool_common
    from planet_tpu_torch.tools import lut as t_lut
    from planet_tpu_torch.tools import noise_stages, span_parts
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res_noise = noise_stages.bench(DEVICE, reps=REPS)
    res_lut = t_lut.bench(DEVICE, reps=REPS)
    res_span = span_parts.bench(DEVICE, reps=REPS)
    launches_tools = dict(_cuda.launches)
    print(f"[8] tools ran in {time.perf_counter() - t0:.1f} s; launches "
          f"(phase 8): {launches_tools}", flush=True)
    tool_rows = {"t_noise": res_noise["t_noise"],
                 "t_tile": res_noise["t_tile"], "t_lut": res_lut["rows"],
                 "t_span": res_span["rows"]}
    for key, unit in (("t_noise", "Gpoint/s"), ("t_tile", "Gtexel/s"),
                      ("t_lut", "Glookup/s"), ("t_span", "ns/record")):
        for r in tool_rows[key]:
            plain = (f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r
                     else "")
            print(f"[8] {key} {r['name']:24s} {r['ms']:9.4f} ms  "
                  f"{r['rate']:9.3f} {unit}  bound {r['bound'][0]:.5f} ms "
                  f"({r['bound'][1]}){plain}  equal to plain {r['equal']} "
                  f"(max abs err {r['max_abs_err']:g})", flush=True)
            check(r["equal"], f"{key} {r['name']} != its plain version")
        check(launches_tools[key] > 0, f"phase 8 launched no {key} kernel")
    # full noise and full tile against K4 and K1 on the same inputs
    coords = res_noise["inputs"]["coords"]
    k4 = perlin_cuda.noise_cuda("ridged", *coords, octaves=6,
                                gain=np.float32(0.55))
    check(same_bits(noise_stages.noise_stage("full", coords), k4),
          "t_noise full != K4 on the same points")
    ch, cl = res_noise["inputs"]["corners"]
    k1 = tile_cuda.tiles_cuda(
        ch, cl, torch.full((ch.shape[0],), 6, dtype=torch.int32, device=dev),
        kind="ridged", gain=0.55, amplitude=8848.0)
    check(same_bits(noise_stages.tile_stage("full", ch, cl), k1),
          "t_tile full != K1 on the same corners")
    print(f"[8] t_noise full bitwise equal to K4 on {coords[0].numel()} "
          f"points; t_tile full bitwise equal to K1 on {ch.shape[0]} tiles; "
          f"torch.take {res_lut['library_ms']:.4f} ms; span full 14x8, "
          f"{res_span['headline']['records']} records: "
          f"{res_span['headline']['ms']:.4f} ms, plain "
          f"{res_span['headline']['plain_ms']:.4f} ms", flush=True)
    del coords, k4, ch, cl, k1
    # the main path's kernels at their phase-3 shapes again, queued behind
    # a spin kernel (tools/common.time_calls): phase 3 times one launch
    # between two events, which for a short kernel also holds the host's
    # launch time
    probe, sphere = noise_inputs(probe_pts), noise_inputs(big)
    radius8 = cfg800.radius
    for label, fn, setup in (
            ("K1 tile, 256 tiles x octaves 6-18",
             lambda: tile_cuda.tiles_cuda(*k1_args, **kw), tuple),
            ("K4 noise, refine probes 5x4096, ridged 6",
             lambda: perlin_cuda.noise_cuda("ridged", *probe, octaves=6,
                                            gain=cfg1080.gain), tuple),
            ("K4 noise, 2^20 points, ridged 18",
             lambda: perlin_cuda.noise_cuda("ridged", *sphere, octaves=18,
                                            gain=cfg1080.gain), tuple),
            ("K6 gather, 1080p", lambda: cc.gather_records_cuda(
                tm1080, span_idx), tuple),
            ("K6's yardstick, index_select + transpose, 1080p",
             lambda: tm1080.index_select(1, span_idx).t().contiguous(),
             tuple),
            ("K2 span, 1080p", lambda fb: cc.raster_span_cuda(g6, fb),
             fresh_fb(W_1080, H_1080)),
            (f"K3 huge, {report['huge']['shape']}",
             lambda fb: cc.raster_huge_cuda(hrecs, fb), fresh_fb(800, 600)),
            (f"K5 field 6x{FIELD_N['step']}^2",
             lambda: field_cuda.field_kernel(FIELD_N["step"], radius8,
                                             device=dev), tuple)):
        ms = tool_common.time_ms(fn, setup, reps=REPS)
        print(f"[8] queued timing, {label}: {ms:.4f} ms (median of {REPS}; "
              f"phase 3/7b's single-launch timing is in the kernels line)",
              flush=True)
    del probe, sphere
    for key, head in (("t_noise", "full"), ("t_tile", "full"),
                      ("t_lut", t_lut.HEADLINE)):
        row = next(r for r in tool_rows[key] if r["name"] == head)
        report[key] = dict(ms=row["ms"], plain_ms=row["plain_ms"],
                           bound=row["bound"])
    report["t_lut"]["library_ms"] = res_lut["library_ms"]
    report["t_span"] = dict(res_span["headline"])
    for key, rows in tool_rows.items():
        report[key]["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        report[key]["variants"] = {r["name"]: r["ms"] for r in rows}

    check(not any(m == "jax" or m.startswith(("jax.", "planet_tpu."))
                  or m == "planet_tpu" for m in sys.modules),
          "jax or planet_tpu was imported")
    launches = dict(launches_dev, field=launches_field["field"],
                    **{k: launches_tools[k] for k in tool_rows})
    replaces = {
        "tile": ("planet_tpu_torch/csrc/tile.cu",
                 "planet_tpu/ops/kernels/tile_pallas.py:66"),
        "noise": ("planet_tpu_torch/csrc/perlin.cu",
                  "planet_tpu/ops/kernels/perlin_pallas.py:351"),
        "span": ("planet_tpu_torch/csrc/raster.cu",
                 "planet_tpu/raster/coverage_pallas.py:67"),
        "huge": ("planet_tpu_torch/csrc/raster.cu",
                 "planet_tpu/raster/coverage_pallas.py:271"),
        "gather": ("planet_tpu_torch/csrc/raster.cu",
                   "planet_tpu/raster/coverage_pallas.py:471"),
        "field": ("planet_tpu_torch/csrc/field.cu",
                  "planet_tpu/ops/kernels/field_pallas.py:149"),
        "t_noise": ("planet_tpu_torch/csrc/bench_noise.cu",
                    noise_stages.REPLACES["t_noise"]),
        "t_tile": ("planet_tpu_torch/csrc/bench_noise.cu",
                   noise_stages.REPLACES["t_tile"]),
        "t_lut": ("planet_tpu_torch/csrc/bench_lut.cu",
                  t_lut.REPLACES["T3"]),
        "t_span": ("planet_tpu_torch/csrc/bench_span.cu",
                   span_parts.REPLACES["T9"]),
    }
    kernels = []
    for k, (src, rep) in replaces.items():
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=rep,
            launches=launches[k], max_abs_err=report[k]["max_abs_err"],
            ms=report[k]["ms"], plain_ms=report[k]["plain_ms"],
            bound_ms=report[k]["bound"][0], bound_by=report[k]["bound"][1],
            library_ms=report[k].get("library_ms")))
        if "variants" in report[k]:
            kernels[-1]["variants"] = report[k]["variants"]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
