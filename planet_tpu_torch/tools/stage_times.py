"""The fused frame's stage ladder: each stop_after rung of the geometry step
captured as its own CUDA graph and its replay timed, on two scenes.

    python -m planet_tpu_torch.tools.stage_times [--json FILE]
    python -m planet_tpu_torch.tools.stage_times --device cpu --small

The counterpart of planet_tpu's stage bisection (tools/bench_step_bisect.py
and the stop_after ladders of tools/bench_lod_stages.py,
bench_moving_stages.py and bench_raster_attrib.py). The rungs are
engine/device_step.RUNGS: refine, cache, generate, uniforms, tess and
geometry (DeviceRenderer(stop_after=...), one graph each), and full (the
geometry replay and the raster graph's replay, DeviceRenderer.render).
The scenes:

* static-1080p: bench.py:230-234's camera at 1920x1080. The full step
  renders a pool until a frame generates nothing; each rung then renders
  into its own copy of that pool, `reps` warm replays timed one by one
  (the median is kept).
* moving-1080p: the first ORBIT_FRAMES frames of tools/bench_moving.py's
  descending orbit (55-62). The full step renders the orbit's first frame
  into an empty pool; each rung then runs frames 1 on from its own copy of
  that pool (each frame generates 8-26 tiles), one replay a frame timed
  (the median over the frames is kept).

Each replay is timed with CUDA events and follows one untimed call that
captures the rung's graph. For each rung the tool prints the ms, the
marginal ms over its base rung (the rung before it, but "generate" for
"tess": the "uniforms" rung's U1 is in no later rung, see BASE), the SM
clock nvidia-smi reads while
the rung's calls run and, right after them, the card's µs a graph node
(a replay of a CHAIN_NODES-node graph of one-block adds: the card runs
back-to-back nodes at one of two speeds, a state that holds for seconds,
and a rung's replay moves with it), the host's ms inside the timed call (the host
clock from the start event to the call's return), the static rungs' ms
timed once more in reverse order after every graph exists, one replay's
device events (its kernels
and its copies and fills, from one torch.profiler session over all rungs,
each rung's replay in a window of its own, with the device's busy ms in
that window and the count of matrix-product kernels — cuBLAS's or
CUTLASS's GEMM and GEMV kernels, by name — among its kernels), the kernel launches a frame per kernel (the graphs' tally
from _cuda.captured, DeviceRenderer.graph_launches: on the full rung the
geometry graph's and the raster graph's) and the frame's n_leaves. With --json it also
writes the rows. Prints the card's nvidia-smi name and power limit first.

--device cpu runs the step eagerly with the kernels' plain versions and
times it by the host clock, with no device events (not measured); --small
runs at the CPU tests' size (96x54, cap 256, render_cap 128, gen_cap 128,
max_lod 4, three orbit frames).

Imports nothing of planet_tpu.
"""

from __future__ import annotations

import concurrent.futures
import json
import re
import time

import numpy as np
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.engine import device_step
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.tools import common, kernel_times

RUNGS = device_step.RUNGS
# a rung's marginal is taken over the rung before it, but the tess rung's
# over "generate": the "uniforms" rung returns U1's outputs, which the
# later rungs do not make (V1 computes them in its own staging), so it is
# a side rung whose marginal is U1 alone, and the other rungs' marginals
# add up to the full rung's ms
BASE = {"tess": "generate"}
SIDE_RUNGS = ("uniforms",)
SIZES = dict(width=1920, height=1080, caps={}, orbit_frames=8)
SMALL = dict(width=96, height=54, orbit_frames=3,
             caps=dict(cap=256, render_cap=128, gen_cap=128, max_lod=4))
WARM_FRAMES = 4
# the profiled windows: idle before and after the pool copies between them,
# and the widening of each window's host-clock range
GAP_S = 0.02
SLACK_MS = 5.0
# the probe of the card's cost a graph node: a chain of one-block adds
CHAIN_NODES = 2000
_COPY_PREFIXES = ("Memcpy", "Memset")
# the names of cuBLAS's and CUTLASS's matrix-product kernels (e.g.
# "ampere_sgemm_128x64_nn", "sm90_xmma_gemm_f32f32_...", "gemv2T_kernel",
# "cutlass::Kernel2<cutlass_80_simt_sgemm_...>")
_GEMM = re.compile(r"gemm|gemv|xmma|cutlass|cublas", re.IGNORECASE)


def camera_args(cfg: EngineConfig, cam, width: int, height: int):
    """(cam_hi, cam_lo (3,) f32 DF, view_proj (4, 4) f32) of a camera."""
    pf = cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg))
    vp = (cam_mod.perspective_lh(pf, width / height, cfg.near_plane,
                                 cfg.far_plane)
          @ cam_mod.view_from_rotation(cam_mod.camera_rotation(cam)))
    return (*dfm.from_f64_np(cam.position), vp.astype(np.float32))


def _copy_pool(dst, src):
    for a, b in zip(dst, src):
        a.copy_(b)


def _counts(out):
    """(n_leaves, n_generated) of a rung's output."""
    if isinstance(out, device_step.DeviceFrame):
        return int(out.n_leaves), int(out.n_generated)
    n, n_gen, _ = (int(v) for v in out.meta.cpu())
    return n, n_gen


class Ladder:
    """One DeviceRenderer and one pool a rung, all at one size; the pools'
    objects stay put, so each rung's graph is captured once and every
    scene copies its state into them."""

    def __init__(self, cfg: EngineConfig, width: int, height: int, device,
                 caps: dict):
        self.device = torch.device(device)
        self.renderers = {rung: device_step.DeviceRenderer(
            cfg, width, height, device=self.device, stop_after=rung, **caps)
            for rung in RUNGS}
        self.pools = {rung: r.init_pool()
                      for rung, r in self.renderers.items()}
        self._chain = None
        if self.device.type == "cuda":
            x = torch.zeros(4096, device=self.device)
            y = x + 1.0                    # loads the add kernel
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(CHAIN_NODES):
                    y = y + 1.0
            self._chain = (graph, y)

    def node_us(self):
        """µs a node of the CHAIN_NODES-node probe graph (median of 5
        replays): the card runs back-to-back graph nodes at one of two
        speeds, which holds for seconds (PERF.md §7); None on the CPU."""
        if self._chain is None:
            return None
        graph = self._chain[0]
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times)) * 1e3 / CHAIN_NODES

    def call(self, rung: str, args):
        """One frame of the rung into its pool: the full rung's
        DeviceFrame, else the step's Geometry or Truncated."""
        r, pool = self.renderers[rung], self.pools[rung]
        if rung == "full":
            return r.render(pool, *args)
        return r.geometry(pool, *args)

    def timed(self, rung: str, args):
        """(ms, host ms, output) of one call from an idle card: CUDA
        events, and the host clock from the start event's record to the return of
        the call (on the CPU, both the host clock)."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = self.call(rung, args)
            ms = (time.perf_counter() - t0) * 1e3
            return ms, ms, out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = self.call(rung, args)
        host = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        return start.elapsed_time(end), host, out

    def clock_during(self, fn):
        """(fn(), the SM clock in MHz that nvidia-smi reads while fn runs;
        None on the CPU)."""
        if self.device.type != "cuda":
            return fn(), None
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            clock = pool.submit(common.sm_clock_mhz)
            return fn(), clock.result()

    def launches(self, rung: str, args) -> dict:
        """Kernel launches of one call, by kernel (those that launched)."""
        before = dict(_cuda.launches)
        self.call(rung, args)
        return {k: n - before[k] for k, n in _cuda.launches.items()
                if n > before[k]}


def warm_static_pool(ladder: Ladder, args):
    """A copy of the full rung's pool after the full step has rendered the
    static camera until a frame generated nothing."""
    for _ in range(WARM_FRAMES):
        if ladder.call("full", args).n_generated == 0:
            return [t.clone() for t in ladder.pools["full"]]
    raise RuntimeError(f"static scene still generating after {WARM_FRAMES} "
                       "frames")


def start_moving_pool(ladder: Ladder, args0):
    """A copy of an empty pool after the full step has rendered the orbit's
    first frame into it."""
    pool = ladder.pools["full"]
    _copy_pool(pool, ladder.renderers["full"].init_pool())
    ladder.call("full", args0)
    return [t.clone() for t in pool]


def _marginals(rows):
    """Each row's marginal ms over its base rung (BASE; else the rung
    before it) and that rung's name."""
    ms = {}
    for i, row in enumerate(rows):
        base = BASE.get(row["rung"], rows[i - 1]["rung"] if i else None)
        row["base"] = base
        row["marginal_ms"] = row["ms"] - ms.get(base, 0.0)
        ms[row["rung"]] = row["ms"]
    return rows


def static_rows(ladder: Ladder, args, warm, reps: int) -> list:
    """Each rung's replay on its copy of the warm pool: the median ms of
    `reps` warm calls, the launches a call and the frame's n_leaves."""
    rows = []
    for rung in RUNGS:
        _copy_pool(ladder.pools[rung], warm)
        n_leaves, _ = _counts(ladder.call(rung, args))   # captures
        calls, clock = ladder.clock_during(
            lambda: [ladder.timed(rung, args)[:2] for _ in range(reps)])
        times, host = zip(*calls)
        rows.append(dict(rung=rung, ms=float(np.median(times)),
                         frames_ms=list(times), sm_mhz=clock,
                         node_us=ladder.node_us(),
                         host_ms=float(np.median(host)), n_leaves=n_leaves,
                         launches=ladder.launches(rung, args),
                         graph_launches=ladder.renderers[rung]
                         .graph_launches))
    return _marginals(rows)


def moving_rows(ladder: Ladder, frames, start) -> list:
    """Each rung from its copy of the start pool through frames[1:], one
    timed call a frame: the median ms, each frame's ms, n_leaves and
    tiles generated (0 before "geometry"), and the launches of frame 1."""
    rows = []
    for rung in RUNGS:
        pool = ladder.pools[rung]
        _copy_pool(pool, start)
        ladder.call(rung, frames[1])              # captures, if not yet
        _copy_pool(pool, start)
        launches = ladder.launches(rung, frames[1])
        _copy_pool(pool, start)
        # a graph's outputs are its static buffers: read each frame's
        # counts before the next replay
        calls, clock = ladder.clock_during(
            lambda: [(ms, host, *_counts(out)) for ms, host, out in
                     (ladder.timed(rung, args) for args in frames[1:])])
        times, host, leaves, generated = (list(c) for c in zip(*calls))
        rows.append(dict(rung=rung, ms=float(np.median(times)),
                         frames_ms=list(times), sm_mhz=clock,
                         node_us=ladder.node_us(),
                         host_ms=float(np.median(host)),
                         n_leaves=leaves,
                         n_generated=generated, launches=launches,
                         graph_launches=ladder.renderers[rung]
                         .graph_launches))
    return _marginals(rows)


def static_again(ladder: Ladder, args, warm, reps: int, rows: list):
    """Times the static rungs once more, from "full" down to "refine",
    after every graph exists: each row's `again_ms`, the median of `reps`
    warm calls (a rung's time that moves with the order of the runs is
    not its own)."""
    for row in reversed(rows):
        _copy_pool(ladder.pools[row["rung"]], warm)
        times, row["again_sm_mhz"] = ladder.clock_during(
            lambda: [ladder.timed(row["rung"], args)[0]
                     for _ in range(reps)])
        row["again_ms"] = float(np.median(times))
        row["again_node_us"] = ladder.node_us()


def device_events(ladder: Ladder, scenes: dict) -> dict:
    """{(scene, rung): (kernels, copies and fills, busy ms, matrix-product
    kernels)} of one call
    of each rung, from one torch.profiler session: each call runs from
    its scene's start pool inside a record_function window of its own,
    synchronized on both sides, with GAP_S of idle before and after the
    pool copies between windows; a device event belongs to the window
    whose range on the host's clock, widened by SLACK_MS on each side
    (the device's timestamps drift from the host's over a session by
    about a ms), holds its start. Also "unassigned": the device events
    outside every window (the pool copies). scenes: scene -> (start pool,
    camera args)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    labels = {}
    with torch.profiler.profile(activities=acts) as prof:
        for scene, (start, args) in scenes.items():
            for rung in RUNGS:
                time.sleep(GAP_S)
                _copy_pool(ladder.pools[rung], start)
                torch.cuda.synchronize()
                time.sleep(GAP_S)
                label = f"stage_times/{scene}/{rung}"
                labels[label] = (scene, rung)
                with torch.profiler.record_function(label):
                    ladder.call(rung, args)
                    torch.cuda.synchronize()
    events = prof.events()
    windows = {labels[e.name]: (e.time_range.start - SLACK_MS * 1e3,
                                e.time_range.end + SLACK_MS * 1e3)
               for e in events if e.name in labels
               and e.device_type == torch.autograd.DeviceType.CPU}
    out = {key: [0, 0, 0.0, 0] for key in windows}
    unassigned = 0
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name in labels):
            continue
        key = next((k for k, (lo, hi) in windows.items()
                    if lo <= e.time_range.start <= hi), None)
        if key is None:
            unassigned += 1
            continue
        out[key][1 if e.name.startswith(_COPY_PREFIXES) else 0] += 1
        out[key][2] += (e.time_range.end - e.time_range.start) / 1e3
        out[key][3] += bool(_GEMM.search(e.name))
    out["unassigned"] = unassigned
    return out


def ladders(device: str = "cuda", small: bool = False,
            reps: int = common.REPS) -> dict:
    """Both scenes' rows ({scene: [row by rung]}), the profiler's count of
    device events outside every window, and the card's line."""
    size = SMALL if small else SIZES
    width, height = size["width"], size["height"]
    cfg = EngineConfig(window_w=width, window_h=height)
    ladder = Ladder(cfg, width, height, device, size["caps"])
    static_args = camera_args(cfg, kernel_times.scene_camera(cfg), width,
                              height)
    frames = [camera_args(cfg, cam, width, height) for _, cam in
              kernel_times.orbit_cameras(cfg)[:size["orbit_frames"]]]
    warm = warm_static_pool(ladder, static_args)
    start = start_moving_pool(ladder, frames[0])
    res = {"static-1080p": static_rows(ladder, static_args, warm, reps),
           "moving-1080p": moving_rows(ladder, frames, start)}
    static_again(ladder, static_args, warm, reps, res["static-1080p"])
    report = {"scenes": res, "size": [width, height], "caps": size["caps"],
              "reps": reps, "orbit_frames": size["orbit_frames"],
              "card": None, "unassigned_events": None}
    if ladder.device.type == "cuda":
        report["card"] = common.card_line()
        ev = device_events(ladder, {"static-1080p": (warm, static_args),
                                    "moving-1080p": (start, frames[1])})
        report["unassigned_events"] = ev.pop("unassigned")
        for scene, rows in res.items():
            for row in rows:
                (row["kernels"], row["copies"], row["busy_ms"],
                 row["gemm_kernels"]) = ev[(scene, row["rung"])]
    return report


def _launch_text(launches: dict) -> str:
    return " ".join(f"{k} {n}" for k, n in launches.items() if n) or "-"


def table(report: dict) -> list:
    """The printed lines: a header and one line a rung, per scene."""
    clock = ("CUDA events" if report["card"] is not None
             else "host clock, CPU")
    w, h = report["size"]
    lines = []
    for scene, rows in report["scenes"].items():
        how = (f"median of {report['reps']} warm replays"
               if scene == "static-1080p" else
               f"median of orbit frames 1-{report['orbit_frames'] - 1}")
        lines.append(f"[{scene}] {w}x{h}, ms by {clock}, {how} (host: "
                     "the host's ms inside them; again: the static rungs "
                     "timed once more, full first); device events of one "
                     "call (kernels / copies and fills, busy ms); "
                     "launches a frame")
        for r in rows:
            ev = ("not measured" if "kernels" not in r else
                  f"{r['kernels']:6d} / {r['copies']:3d}, "
                  f"{r['busy_ms']:8.3f} busy")
            leaves = (r["n_leaves"] if isinstance(r["n_leaves"], int)
                      else ",".join(map(str, r["n_leaves"])))
            mhz = ("" if r["sm_mhz"] is None else
                   f" at {r['sm_mhz']:.0f} MHz, {r['node_us']:.3f} us/node")
            again = ("" if "again_ms" not in r else
                     f"  again {r['again_ms']:9.3f}" + (
                         "" if r["again_sm_mhz"] is None else
                         f" at {r['again_sm_mhz']:.0f} MHz, "
                         f"{r['again_node_us']:.3f} us/node"))
            lines.append(f"[{scene}] {r['rung']:9s} {r['ms']:9.3f} ms"
                         f"{mhz}  "
                         f"marginal {r['marginal_ms']:+9.3f} over "
                         f"{r['base'] or '-':8s}  host "
                         f"{r['host_ms']:8.3f}{again}  {ev}  "
                         f"launches {_launch_text(r['launches'])}  "
                         f"(graph {_launch_text(r['graph_launches'])})  "
                         f"leaves {leaves}")
    if report["unassigned_events"] is not None:
        lines.append(f"device events outside every window (the pool "
                     f"copies between them): {report['unassigned_events']}")
    return lines


def main(argv=None) -> int:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--json", help="also write the report to this file")
    args = common.parse_args(argv, p)
    report = ladders(args.device, args.small, args.reps)
    if report["card"] is not None:
        print(report["card"], flush=True)
    for line in table(report):
        print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
