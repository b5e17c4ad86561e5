"""Headless driver (the reference's main loop, main.cpp:737-1142, without
SDL): step the camera, render frames on the port's engine, dump PNGs,
print the title-bar stats line, persist camera state.

Usage:
    python -m planet_tpu_torch.io.driver [--frames N] [--out DIR] [--orbit]
        [--altitude M] [--width W] [--height H] [--wireframe] [--no-skirts]
        [--save FILE] [--slot K] [--no-save] [--timing] [--backend cuda|cpu]

e.g. `python -m planet_tpu_torch.io.driver --frames 4 --orbit
--altitude 80000 --out frames`. --backend cuda (the default) runs every
kernel of the frame on the GPU and fails when there is none.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import STAGES, PlanetEngine
from planet_tpu_torch.io import checkpoint, png


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default="frames")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--save", default="save.npz")
    ap.add_argument("--slot", type=int, default=-1,
                    help="recall saved camera slot (F1-F12 analogue)")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--orbit", action="store_true",
                    help="orbit the planet instead of holding position")
    ap.add_argument("--altitude", type=float, default=None,
                    help="override camera altitude above the surface (m)")
    ap.add_argument("--timing", action="store_true",
                    help="per-stage timing prints (reference key T)")
    ap.add_argument("--wireframe", action="store_true",
                    help="grid-line rendering (reference key P)")
    ap.add_argument("--no-skirts", action="store_true",
                    help="disable skirt drop (reference key K)")
    ap.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                    help="device for tiles, tessellation and the raster")
    args = ap.parse_args(argv)

    if args.backend == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--backend cuda: no CUDA device is available")
    cfg = EngineConfig(window_w=args.width, window_h=args.height)
    engine = PlanetEngine(cfg, device=args.backend)
    engine.wireframe = args.wireframe
    engine.skirts = not args.no_skirts
    engine.timing = args.timing

    active, slots = checkpoint.load(args.save, cfg.radius)
    cam = slots[args.slot] if 0 <= args.slot < len(slots) else active
    cam = cam.copy()
    if args.altitude is not None:
        pos = cam.position
        r = np.linalg.norm(pos)
        if r == 0:
            pos, r = np.array([0.0, 0.0, -1.0]), 1.0
        cam.position = pos / r * (cfg.radius + args.altitude)

    os.makedirs(args.out, exist_ok=True)
    for i in range(args.frames):
        if args.orbit:
            theta = 2.0 * np.pi * i / max(args.frames, 1) * 0.05
            r = np.linalg.norm(cam.position)
            cam.position = r * np.array(
                [np.sin(theta), 0.0, -np.cos(theta)])

        out, image, _ = engine.render(cam, args.width, args.height)
        image = image.cpu().numpy()
        s = out.stats
        # the reference's window-title stats (main.cpp:1030-1037)
        print(f"frametime: {s.frametime_ms:.1f} ms, fps: {s.fps:.1f}, "
              f"tris: {s.tris}, quads: {s.quads}, "
              f"tiles: {s.tiles_generated}, texels: {s.texels_generated}",
              flush=True)
        if args.timing:
            print("[timing] " + ", ".join(
                f"{k}: {s.stage_ms[k]:.2f} ms" for k in STAGES
                if k in s.stage_ms), flush=True)
        png.write_png(os.path.join(args.out, f"frame_{i:04d}.png"), image)

    if not args.no_save:
        checkpoint.save(args.save, cam, slots)


if __name__ == "__main__":
    main()
