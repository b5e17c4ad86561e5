"""Headless app driver (the reference's main loop, main.cpp:737-1142,
without SDL; planet_tpu io/driver.py, ported): step the camera, render
frames, dump PNGs, print the title-bar stats line, persist camera state.

Usage:
    python -m planet_tpu_torch.io.driver [--frames N] [--out DIR] [--orbit]
        [--altitude M] [--width W] [--height H] [--wireframe] [--no-skirts]
        [--save FILE] [--slot K] [--save-slot K] [--no-save] [--timing]
        [--raster exact|splat] [--supersample K] [--check-finite]
        [--profile DIR]
        [--interactive [--device [--preview K]]] [--backend cuda|cpu]

Camera controls come three ways: scripted (an orbit or saved slots), the
slot flags (--slot recalls, --save-slot stores — the reference's F1-F12 /
shift+F1-F12, main.cpp:958-975), or `--interactive`, a line-oriented
terminal mode mapping the reference key set (main.cpp:947-1000) onto
`update_camera` and the engine toggles — see INTERACTIVE_HELP. With
`--interactive --device` the frames run on the fused device path
(DeviceRenderer: one CUDA-graph replay of the geometry step a frame, then
the raster) and each frame fetches only a k x k-subsampled u8 preview;
`--device` without `--interactive` is ignored, as in planet_tpu.

--raster picks the raster mode (EngineConfig.raster_mode, on both
engines): "exact" (the default), the exact-coverage triangle raster, or
"splat", the depth-tested splat raster, whose fragments per cell edge
--supersample sets (by default max(4, round(width / 240))). planet_tpu's
driver has no such switch.

--backend cuda (the default) runs every kernel on the GPU and fails when
there is none; --backend cpu runs their plain PyTorch versions.
--profile DIR writes a torch.profiler trace (Chrome JSON, CUDA activity
on the cuda backend) of the whole run to DIR/trace.json. Besides torch's
ops and the CUDA calls and device events, it holds the port's own host
spans (utils/timing.span), once a frame on the device path:
planet/render (the whole frame) holding planet/camera, planet/geometry
(planet/upload, then planet/replay), planet/raster (planet/replay) and
planet/readback (the preview's fetch and the two count reads), with
planet/capture inside geometry or raster where a graph is captured; and
planet/field around each models/heightfield.frame_cube.
`python -m planet_tpu_torch.tools.span_split DIR/trace.json` puts the
host's and the device's idle time down to them.

e.g. `python -m planet_tpu_torch.io.driver --frames 4 --orbit
--altitude 80000 --out frames`, or `python -m planet_tpu_torch.io.driver
--interactive --device --width 1920 --height 1080`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import STAGES, FrameStats, PlanetEngine
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.io import checkpoint, png
from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.tess import mesh as mesh_mod
from planet_tpu_torch.utils import timing

INTERACTIVE_HELP = """\
Interactive commands (one line = keys held for one 1/30 s step, then a
frame renders and its stats print; reference key map main.cpp:947-1000):
  w / s          move forward / back       a / d   strafe left / right
  up down left right   look (arrow keys)
  1..8           move speed 10^n m/s (number keys)
  f1..f12        recall camera slot K     sf1..sf12  save to slot K (shift+F)
  p              wireframe toggle          k       skirt toggle
  t              timing-print toggle       png     dump frame to --out
  help           this text                 q       quit (persists state)
"""


class _Out:
    """What run_interactive reads of a frame: its stats."""

    def __init__(self, stats: FrameStats):
        self.stats = stats


class DeviceInteractiveEngine:
    """run_interactive's engine over the fused device path (DeviceRenderer
    with fetch="u8" and a k x k-subsampled preview).

    PlanetEngine fetches the full image every frame. Here the per-frame
    display fetch is the preview alone (preview=2 at 1080p: 0.52 MB
    instead of 2.07 MB of u8), while the full u8 frame stays on the device;
    the `png` command fetches it, so a dump holds the full frame whatever
    the preview. The wireframe toggle is a raster option, read each frame;
    the skirt size is baked into the captured geometry step, as in
    planet_tpu's fused program, so the skirt toggle is reported and
    ignored here (PlanetEngine honours it). Keywords go to DeviceRenderer
    (cap, render_cap, gen_cap, max_lod, probe)."""

    def __init__(self, cfg: EngineConfig, width: int, height: int, *,
                 preview: int = 2, device="cuda", **kw):
        from planet_tpu_torch.engine.device_step import DeviceRenderer
        self.cfg = cfg
        self.width, self.height = int(width), int(height)
        self._r = DeviceRenderer(cfg, self.width, self.height, device=device,
                                 fetch="u8", preview=int(preview), **kw)
        self.pool = self._r.init_pool()
        c = cfg
        pf = cam_mod.proj_factor_from_fovy(np.deg2rad(c.fovy_deg))
        self._proj = cam_mod.perspective_lh(pf, self.width / self.height,
                                            c.near_plane, c.far_plane)

    @property
    def renderer(self):
        return self._r

    @property
    def skirts(self):
        return True

    @skirts.setter
    def skirts(self, v):
        if not bool(v):
            print("(skirt toggle is baked into the captured device step; "
                  "ignored here — use the host engine for key-K work)",
                  flush=True)

    @property
    def wireframe(self):
        return self._r.wireframe

    @wireframe.setter
    def wireframe(self, v):
        self._r.wireframe = bool(v)

    def render(self, cam, width=None, height=None):
        """One frame: (an object with .stats, the full u8 image and the
        depth, both left on the device)."""
        with timing.span("render"):
            t0 = time.perf_counter()
            c = self.cfg
            with timing.span("camera"):
                rot = cam_mod.camera_rotation(cam)
                vp = self._proj @ cam_mod.view_from_rotation(rot)
                ch, cl = dfm.from_f64_np(cam.position)
            frame = self._r.render(self.pool, ch, cl, vp)
            # the per-frame display fetch: the preview only
            shown = (frame.preview if frame.preview is not None
                     else frame.image)
            with timing.span("readback"):
                shown.cpu()
                n, gens = int(frame.n_leaves), int(frame.n_generated)
            dt = time.perf_counter() - t0
            stats = FrameStats(
                frametime_ms=dt * 1e3, fps=1.0 / max(dt, 1e-9),
                tris=n * mesh_mod.interior_triangle_count(c.patch_verts),
                quads=n, tiles_generated=gens,
                texels_generated=gens * c.tile_dim * c.tile_dim)
        return _Out(stats), frame.image, frame.depth


def _host_image(image) -> np.ndarray:
    if isinstance(image, torch.Tensor):
        return image.cpu().numpy()
    return np.asarray(image)


def run_interactive(engine, cam, slots, width: int, height: int,
                    out_dir: str, stream=None, echo=True):
    """Line-oriented interactive loop; `stream` defaults to stdin (tests
    feed a StringIO). Returns the final camera. dt is a fixed 1/30 s so
    command scripts are deterministic."""
    stream = stream if stream is not None else sys.stdin
    dt = 1.0 / 30.0
    look_speed = 1.5
    move_speed = cam_mod.speed_for_digit(3)
    frame_no = 0
    for line in stream:
        tokens = line.split()
        if "q" in tokens:
            break
        move = np.zeros(3, np.float32)
        look = np.zeros(3, np.float32)
        dump = False
        for tok in tokens:
            if tok == "w":
                move[2] += 1.0
            elif tok == "s":
                move[2] -= 1.0
            elif tok == "a":
                move[0] -= 1.0
            elif tok == "d":
                move[0] += 1.0
            elif tok == "up":
                look[0] -= 1.0            # pitch up (reference arrow look)
            elif tok == "down":
                look[0] += 1.0
            elif tok == "left":
                look[1] -= 1.0
            elif tok == "right":
                look[1] += 1.0
            elif tok.isdigit() and len(tok) == 1 and tok != "0":
                move_speed = cam_mod.speed_for_digit(int(tok))
            elif tok.startswith("sf") and tok[2:].isdigit():
                k = int(tok[2:]) - 1
                if 0 <= k < len(slots):
                    slots[k] = cam.copy()
            elif tok.startswith("f") and tok[1:].isdigit():
                k = int(tok[1:]) - 1
                if 0 <= k < len(slots):
                    cam = slots[k].copy()
            elif tok == "p":
                engine.wireframe = not engine.wireframe
            elif tok == "k":
                engine.skirts = not engine.skirts
            elif tok == "t":
                timing.toggle_timing()
            elif tok == "png":
                dump = True
            elif tok == "help":
                print(INTERACTIVE_HELP, flush=True)
            elif echo:
                print(f"? unknown key {tok!r} (try: help)", flush=True)
        cam_mod.update_camera(cam, move, look, move_speed, look_speed, dt)
        out, image, _ = engine.render(cam, width, height)
        s = out.stats
        print(f"frametime: {s.frametime_ms:.1f} ms, fps: {s.fps:.1f}, "
              f"tris: {s.tris}, quads: {s.quads}, "
              f"tiles: {s.tiles_generated}, speed: {move_speed:g} m/s",
              flush=True)
        if dump:
            png.write_png(
                os.path.join(out_dir, f"interactive_{frame_no:04d}.png"),
                _host_image(image))
        frame_no += 1
    return cam


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default="frames")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--save", default="save.npz")
    ap.add_argument("--slot", type=int, default=-1,
                    help="recall saved camera slot (F1-F12 analogue)")
    ap.add_argument("--save-slot", type=int, default=-1,
                    help="store the camera into this slot before exiting "
                         "(shift+F1-F12 analogue, main.cpp:958-975)")
    ap.add_argument("--interactive", action="store_true",
                    help="line-oriented terminal control mode (see "
                         "driver.INTERACTIVE_HELP)")
    ap.add_argument("--device", action="store_true",
                    help="interactive mode on the fused device path "
                         "(DeviceRenderer + u8 preview fetch)")
    ap.add_argument("--preview", type=int, default=2,
                    help="with --device: k x k preview subsampling of the "
                         "per-frame fetch (PNG dumps stay full-res; 1 "
                         "disables)")
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
    ap.add_argument("--raster", choices=("exact", "splat"),
                    default="exact",
                    help="raster mode: the exact triangle raster, or the "
                         "depth-tested splat raster (its fragments per "
                         "cell edge: --supersample)")
    ap.add_argument("--supersample", type=int, default=None,
                    help="splat fragments per cell edge, with --raster "
                         "splat (default: by width)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run to "
                         "DIR/trace.json, with the port's planet/ spans "
                         "(render, camera, geometry, upload, replay, "
                         "raster, readback, capture; field)")
    ap.add_argument("--check-finite", action="store_true",
                    help="per-frame NaN/inf tile guard")
    ap.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                    help="device for tiles, tessellation and the raster")
    args = ap.parse_args(argv)

    if args.backend == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--backend cuda: no CUDA device is available")
    ss = args.supersample or max(4, round(args.width / 240))
    cfg = EngineConfig(window_w=args.width, window_h=args.height,
                       raster_mode=args.raster, raster_supersample=ss,
                       check_finite=args.check_finite)
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

    if args.timing and not timing.timing_enabled():
        timing.toggle_timing()

    os.makedirs(args.out, exist_ok=True)

    profiler = None
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if args.backend == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.__enter__()

    def finish_profile():
        if profiler is not None:
            if args.backend == "cuda":
                torch.cuda.synchronize()
            profiler.__exit__(None, None, None)
            os.makedirs(args.profile, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(args.profile,
                                                      "trace.json"))

    if args.interactive:
        print(INTERACTIVE_HELP, flush=True)
        ieng = engine
        if args.device:
            ieng = DeviceInteractiveEngine(cfg, args.width, args.height,
                                           preview=args.preview,
                                           device=args.backend)
            ieng.wireframe = args.wireframe
        cam = run_interactive(ieng, cam, slots, args.width, args.height,
                              args.out)
        if 0 <= args.save_slot < len(slots):
            slots[args.save_slot] = cam.copy()
        finish_profile()
        if not args.no_save:
            checkpoint.save(args.save, cam, slots)
        return

    for i in range(args.frames):
        if args.orbit:
            theta = 2.0 * np.pi * i / max(args.frames, 1) * 0.05
            r = np.linalg.norm(cam.position)
            cam.position = r * np.array(
                [np.sin(theta), 0.0, -np.cos(theta)])

        with timing.timed("frame"):
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

    finish_profile()
    if 0 <= args.save_slot < len(slots):
        slots[args.save_slot] = cam.copy()
    if not args.no_save:
        checkpoint.save(args.save, cam, slots)


if __name__ == "__main__":
    main()
