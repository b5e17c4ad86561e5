"""The interactive LOD frame: io/driver.DeviceInteractiveEngine.render, the
frame a user flying by keyboard waits for (the driver's `--interactive
--device` path: the camera's arithmetic on the host, the uploads, the
geometry and raster graphs' replays, the preview fetch, the frame's two
counts read back).

Closed loop, one client: the next frame's call starts when the previous
has returned. The camera of frame k is the traffic's; the path's first
`warmup_frames` frames fill the pool and capture the graphs (set-up), then
frames run for the window's seconds. A frame counts in `failed` when it
raises or its overflow flags (the geometry step's and the raster's) are
set; the flags are summed on the device, outside the timed call, and
read after the window. The path's cameras are made before the window.

Correctness: the path's first frame (from the empty pool) and the frames
at the seed's sample points are kept (their leaf rows, sampled tiles,
clip-space vertices, image, depth and the pool's bookkeeping before and
after) and compared, once the window has closed and the program's state
is freed, with the plain reference's frame from the same bookkeeping
(reference/lod.py).
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from perfbench.drivers.common import (Result, RunError, max_gap,
                                      read_metrics, reduce_trace,
                                      sample_times)
from perfbench.harness import roofline
from perfbench.harness import trace as trace_mod
from perfbench.harness import traffic as traffic_mod
from perfbench.reference import lod as ref_lod

__all__ = ["Run", "RunError"]


class Run:
    def __init__(self, cell, *, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, control: bool = False):
        self.c = cell
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.control = control
        cfg = cell.config
        self.settings = cfg["settings"]
        self.engine_kw = dict(cfg["engine"])
        self.width = int(self.settings["window_w"])
        self.height = int(self.settings["window_h"])
        self.path = traffic_mod.make(cell.traffic, self.seed,
                                     self.settings["radius"])
        self.samples = []      # (frame k, kept outputs)
        self.red = None
        self.stretch_k0 = 0    # the frame k of the traced stretch's first

    # ------------------------------------------------------------ program
    def _engine(self):
        from planet_tpu_torch.engine.config import EngineConfig
        from planet_tpu_torch.io.driver import DeviceInteractiveEngine
        fields = EngineConfig.__dataclass_fields__
        ecfg = EngineConfig(**{k: v for k, v in self.settings.items()
                               if k in fields})
        return DeviceInteractiveEngine(ecfg, self.width, self.height,
                                       device=self.device, **self.engine_kw)

    def _book(self):
        p = self.eng.pool
        return ref_lod.PoolBook(*(t.clone() for t in (
            p.keys_lo, p.keys_hi, p.tick, p.now)))

    def _keep(self, k, book):
        g = self.eng.renderer.last_geometry
        _, image, depth = self._last
        self.samples.append((k, dict(
            book=book, n=g.meta[0].clone(), leaf_lo=g.leaf_lo.clone(),
            leaf_hi=g.leaf_hi.clone(), leaf_depth=g.leaf_depth.clone(),
            tiles=g.tiles.clone(), clip=g.vertices.clip.clone(),
            image=image.clone(), depth=depth.clone(), after=self._book())))

    def _flags(self, traced: bool):
        """Add this frame's overflow flags to the device's tallies: no host
        read, one launch each (annotated as the harness's in a trace)."""
        r = self.eng.renderer
        with trace_mod.harness() if traced else contextlib.nullcontext():
            self.fail_tally.add_(torch.logical_or(
                r.last_geometry.meta[2], r.last_counters.overflowed))

    def _frame(self, k, times, traced=False):
        cam = self._Camera(self._pos[k], self._ang[k])
        self._last = None
        t0 = time.perf_counter()
        try:
            self._last = self.eng.render(cam)
        except Exception as e:          # a frame that raises has failed
            self.raised += 1
            print(f"perfbench: frame {k} raised {e!r}", file=sys.stderr,
                  flush=True)
            return
        times.append(time.perf_counter() - t0)
        self._flags(traced)

    def measure(self) -> Result:
        from planet_tpu_torch.geom.camera import Camera
        self._Camera = Camera
        cuda = self.device.type == "cuda"
        cfg = self.c.config
        self.eng = self._engine()
        warm = int(self.c.traffic["warmup_frames"])
        n_max = (warm + int(cfg["trace_lead"]) + int(cfg["trace_frames"])
                 + int(self.seconds * float(cfg["max_frames_per_s"])) + 1)
        self._pos, self._ang = self.path.frames(0, n_max)
        # the frames whose geometry step or raster overflowed
        self.fail_tally = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        self.raised = 0
        warm_times = []
        for k in range(warm):
            self._frame(k, warm_times)
            if self.raised:
                raise RunError(f"set-up: frame {k} of the warm-up raised")
            if k == 0:
                self._keep(0, None)
        self.fail_tally.zero_()
        if cuda:
            torch.cuda.synchronize()
        trace_frames = int(cfg["trace_frames"]) if self.trace else 0
        marks = sample_times(self.seed, int(cfg["samples"]))
        times = []
        k = warm
        t_win = time.perf_counter()
        setup_s = t_win - self.t_start
        if trace_frames:
            with trace_mod.session(cuda) as holder:
                for _ in range(int(cfg["trace_lead"])):
                    self._frame(k, times, traced=True)
                    k += 1
                self.stretch_k0 = k
                with trace_mod.stretch():
                    for _ in range(trace_frames):
                        with trace_mod.step():
                            self._frame(k, times, traced=True)
                        k += 1
            # the profiler's export took its time: the window proper, with
            # its sample points, starts now
            t_win = time.perf_counter()
        k_win, n_traced = k, len(times)
        while True:
            el = time.perf_counter() - t_win
            if el >= self.seconds or k >= n_max:
                break
            take = marks and el >= marks[0] * self.seconds
            if take:
                marks.pop(0)
                book = self._book()
            self._frame(k, times)
            if take and self._last is not None:
                self._keep(k, book)
            k += 1
        window_s = time.perf_counter() - t_win
        if cuda:
            torch.cuda.synchronize()
        frames = k - warm
        if len(times) == n_traced:
            raise RunError("no frame returned in the window")
        a = np.asarray(times[n_traced:]) * 1e3
        print(f"perfbench: {frames} frames; the calls took "
              f"{a.sum() / 1e3 / window_s:.4f} of the window; call ms median "
              f"{np.median(a):.4f}, quartiles {np.percentile(a, 25):.4f} "
              f"{np.percentile(a, 75):.4f}, max {a.max():.3f}",
              file=sys.stderr)
        overflowed = int(self.fail_tally)
        if overflowed:
            print(f"perfbench: {overflowed} frames overflowed",
                  file=sys.stderr)
        res = Result(attempted=frames, failed=overflowed + self.raised)
        res.end_to_end = {
            "frame_ms": window_s * 1e3 / max(1, k - k_win),
            "frame_p99_ms": float(np.percentile(a, 99)),
            "setup_s": setup_s}
        if cuda:
            res.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        if trace_frames:
            # a frame of the untraced window, for the idle share
            step_s = res.end_to_end["frame_ms"] / 1e3
            try:
                self.red = reduce_trace(holder.events, self.c.layers,
                                        trace_frames, {"step_s": step_s})
            except trace_mod.TraceError as e:
                raise RunError(str(e)) from e
            res.busy_s, res.window_s = self.red.busy_s, self.red.window_s
            res.breakdown = self.red.breakdown()
        return res

    def release(self):
        self.eng = None
        self._last = None

    # ---------------------------------------------------------- reference
    def _ref_cfg(self):
        return ref_lod.engine_config(self.settings)

    def per_layer(self) -> dict:
        """The per-layer readers on the traced stretch, after V1's least
        time of the picked stretch frames (`v1_frames`, spread evenly over
        the complete ones) is worked out by the reference's refine (their
        live rows and slerps)."""
        rcfg = self._ref_cfg()
        grid = rcfg.patch_verts + 2
        done = self.red.complete
        n = min(int(self.c.config["v1_frames"]), len(done))
        picks = sorted({done[j] for j in np.linspace(
            0, len(done) - 1, n).astype(int)})
        bounds = {}
        for i in picks:
            k = self.stretch_k0 + i
            pos, ang = self._pos[k], self._ang[k]
            live, rows, normals = ref_lod.frame_rows(
                rcfg, self.width, self.height, self.engine_kw, pos, ang,
                self.device)
            bounds[i] = roofline.tess_rows_bound_ms(
                rows, grid, roofline.tess_slerps(normals, grid), live,
                rcfg.tile_dim)
        self.red.extras["v1_bound_ms"] = bounds
        return read_metrics(self.c.readers(), self.red)

    def check(self) -> dict:
        """Each compared number over the kept frames, with its limit."""
        rcfg = self._ref_cfg()
        limits = self.c.config["limits"]
        worst = {k: 0.0 for k in limits}
        for k, s in self.samples:
            pos, ang = self._pos[k], self._ang[k]
            ref = ref_lod.frame(rcfg, self.width, self.height,
                                self.engine_kw, pos, ang, s["book"],
                                self.device)
            if self.control:
                got = ref_lod.frame(rcfg, self.width, self.height,
                                    self.engine_kw, pos, ang, s["book"],
                                    self.device, f32_control=True)
                s = dict(n=torch.tensor(got.n_leaves), leaf_lo=got.leaf_lo,
                         leaf_hi=got.leaf_hi, leaf_depth=got.leaf_depth,
                         tiles=got.tiles, clip=got.clip, image=got.image,
                         depth=got.depth, after=got.book)
            for name, v in compare(s, ref).items():
                worst[name] = max(worst[name], v)
        return {name: {"value": worst[name], "limit": limits[name]}
                for name in limits}


def compare(s: dict, ref) -> dict:
    """The numbers compared between a kept frame and the reference's."""
    n_prog, n_ref = int(s["n"]), ref.n_leaves
    n = min(n_prog, n_ref)
    rows_off = abs(n_prog - n_ref) + int(
        ((s["leaf_lo"][:n] != ref.leaf_lo[:n])
         | (s["leaf_hi"][:n] != ref.leaf_hi[:n])
         | (s["leaf_depth"][:n] != ref.leaf_depth[:n])).sum())
    book_off = sum(int((getattr(s["after"], f)[:-1]
                        != getattr(ref.book, f)[:-1]).sum())
                   for f in ("keys_lo", "keys_hi", "tick"))
    book_off += int(s["after"].now != ref.book.now)
    img = s["image"].to(ref.image.device)
    dep = s["depth"].to(ref.depth.device)
    return {
        "leaf_rows_off": float(rows_off),
        "tile_gap_m": max_gap(s["tiles"][:n], ref.tiles[:n]),
        "clip_rel_gap": max_gap(s["clip"][:n], ref.clip[:n],
                                relative=True),
        "image_off_share": float((img != ref.image).double().mean()),
        "depth_off_share": float((dep != ref.depth).double().mean()),
        "pool_book_off": float(book_off),
    }
