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
   K1 tiles (bitwise), K6 record gather (bitwise), K2 span and K3 huge
   raster (coverage identical, packed depth/shade within 1 quantum);
4. the main path, PlanetEngine(...).render on the card, against the
   oracle's frame / nearclip / farclip golden images at their test bars;
5. the main path at real size: the 1920x1080 static scene (3 frames,
   per-stage ms) and 8 frames of a descending orbit;
6. every kernel's launch count during phases 4-5 must be > 0.

The second-to-last lines are a JSON summary of the kernels and the card's
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


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


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
    from planet_tpu_torch.engine.planet import (STAGES, EngineConfig,
                                                PlanetEngine, cam_mod, mesh)
    from planet_tpu_torch.lod import refine as lod_refine
    from planet_tpu_torch.nums import df as dfm
    from planet_tpu_torch.ops.kernels import tile_cuda
    from planet_tpu_torch.raster import coverage as cov
    from planet_tpu_torch.raster import coverage_cuda as cc
    from planet_tpu_torch.raster import nearclip

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

    # K1: 256 tiles from the 1080p scene's leaves, octave counts 6..18
    leaves = lod_refine.refine(bench_cam().position, cfg1080.max_lod,
                               cfg1080.radius)
    sel = np.arange(256) % len(leaves.ids)
    ch, cl = dfm.from_f64_np(leaves.corners[sel] * cfg1080.coord_scale)
    ch, cl = torch.as_tensor(ch, device=dev), torch.as_tensor(cl, device=dev)
    octs = torch.as_tensor(6 + np.arange(256, dtype=np.int32) % 13,
                           device=dev)
    kw = dict(kind="ridged", gain=cfg1080.gain, amplitude=cfg1080.amplitude)
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
    report["tile"] = dict(
        max_abs_err=max(err1, float((k17 - p17).abs().max())),
        ms=time_ms(lambda: tile_cuda.tiles_cuda(ch, cl, octs, **kw)),
        plain_ms=time_ms(lambda: tile_cuda.tiles_plain(ch, cl, octs, **kw)))
    print(f"[3] K1 tiles: 256 tiles x octaves 6-18 bitwise equal "
          f"(lacunarity 2.0 and 1.7); kernel {report['tile']['ms']:.3f} ms, "
          f"plain {report['tile']['plain_ms']:.3f} ms", flush=True)

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

    # K6 + K2 + K3 at the 1080p scene's shapes
    clip, normal, valid = scene_setup(cfg1080, bench_cam())
    cell_mask = mesh.cell_triangle_mask(cfg1080.patch_verts)
    tm, live, span = cov.setup_t(clip, normal, valid, W_1080, H_1080,
                                 cell_mask, far_w=cfg1080.far_plane)
    span_idx, huge_idx = cc.route(tm, live, span)
    g6 = cc.gather_records_cuda(tm, span_idx)
    p6 = cc.gather_records_plain(tm, span_idx)
    check(torch.equal(g6, p6), "K6 gather != plain")
    # an out-of-range index must give a dead (all-zero) record
    edge_idx = torch.tensor([0, tm.shape[1], -1], dtype=torch.int32,
                            device=dev)
    check(torch.equal(cc.gather_records_cuda(tm, edge_idx),
                      cc.gather_records_plain(tm, edge_idx)),
          "K6 gather != plain on out-of-range indices")
    report["gather"] = dict(
        max_abs_err=float((g6 - p6).abs().max()) if g6.numel() else 0.0,
        ms=time_ms(lambda: cc.gather_records_cuda(tm, span_idx)),
        plain_ms=time_ms(lambda: cc.gather_records_plain(tm, span_idx)))
    print(f"[3] K6 gather: {span_idx.numel()} of {tm.shape[1]} records "
          f"bitwise equal; kernel {report['gather']['ms']:.3f} ms, plain "
          f"{report['gather']['plain_ms']:.3f} ms", flush=True)

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
                         fresh_fb(W_1080, H_1080)))
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
    _cuda.reset_launches()
    huge_by_scene = {}
    for name in ("frame", "nearclip", "farclip"):
        before = _cuda.launches["huge"]
        eng = PlanetEngine(cfg800, device=dev)
        out, image, depth = eng.render(scene_cam(name))
        rc = eng.last_counters
        huge_by_scene[name] = _cuda.launches["huge"] - before
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
        print(f"[4] {name}: leaves {out.n_leaves} (oracle {int(meta[0])}), "
              f"coverage agreement {agree:.6f}, shade p99 "
              f"{np.quantile(ds, 0.99) * 1023:.3f}/1023 mean "
              f"{ds.mean() * 1023:.4f}/1023, depth p99 "
              f"{np.quantile(dd, 0.99):.3g}, SSIM {s:.5f}, "
              f"n_tris {rc.n_tris}, n_huge {rc.n_huge}, "
              f"n_straddle {rc.n_straddle} (oracle {int(meta[3])})",
              flush=True)
        check(out.n_leaves == int(meta[0]), f"{name}: leaf count")
        check(agree > 0.999, f"{name}: coverage agreement {agree}")
        check(np.quantile(ds, 0.99) <= 2.5 / 1023, f"{name}: shade p99")
        check(ds.mean() < 1.0 / 1023, f"{name}: shade mean")
        check(s > 0.99, f"{name}: SSIM {s}")
        check(not rc.overflowed, f"{name}: raster overflow")
        if name == "frame":
            check(np.quantile(dd, 0.99) < 1e-5, "frame: depth p99")
        if name == "nearclip":
            check(rc.n_straddle == int(meta[3]), "nearclip: straddlers")
            check(0.5 < gc.mean() < 0.95, "nearclip: golden coverage")
        if name == "farclip":
            check(int(meta[5]) > 1000, "farclip: scene crosses far")
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
    eng = PlanetEngine(cfg1080, device=dev)
    eng.timing = True
    alts = np.linspace(20000.0, 3000.0, 48)[:8]
    for i, alt in enumerate(alts):
        # tools/bench_moving.py's descending orbit, camera in numpy
        theta = i * 1e-3
        cdir = np.array([np.cos(theta) * 0.8, 0.6, np.sin(theta) * 0.8])
        cdir /= np.linalg.norm(cdir)
        cam = cam_mod.Camera(position=cdir * (cfg1080.radius + alt),
                             angles=np.array([0.35, theta, 0.0], np.float32))
        out, image, depth = eng.render(cam)
        st = out.stats
        check(bool(torch.isfinite(image).all()), f"orbit frame {i} not finite")
        print(f"[5] orbit frame {i} alt {alt:.0f} m: leaves {out.n_leaves}, "
              f"tiles generated {st.tiles_generated}, live triangles "
              f"{eng.last_counters.n_tris}, huge {eng.last_counters.n_huge}; "
              f"frame {sum(st.stage_ms.values()):.3f} ms", flush=True)

    # ------------------------------------------------------------ phase 6
    check("jax" not in sys.modules, "jax was imported")
    launches = dict(_cuda.launches)
    print(f"[6] main-path launches: {launches}", flush=True)
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")

    replaces = {
        "tile": ("planet_tpu_torch/csrc/tile.cu",
                 "planet_tpu/ops/kernels/tile_pallas.py:66"),
        "span": ("planet_tpu_torch/csrc/raster.cu",
                 "planet_tpu/raster/coverage_pallas.py:67"),
        "huge": ("planet_tpu_torch/csrc/raster.cu",
                 "planet_tpu/raster/coverage_pallas.py:271"),
        "gather": ("planet_tpu_torch/csrc/raster.cu",
                   "planet_tpu/raster/coverage_pallas.py:471"),
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches[k],
                    max_abs_err=report[k]["max_abs_err"],
                    ms=report[k]["ms"], plain_ms=report[k]["plain_ms"])
               for k, (src, rep) in replaces.items()]
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
