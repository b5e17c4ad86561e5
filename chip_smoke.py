#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (planet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
result line is printed:

1. the card (nvidia-smi name and power limit, SM clock), torch and CUDA
   versions; no CUDA device -> exit 2;
2. build the CUDA kernels from planet_tpu_torch/csrc (nvcc, ctypes); print
   ptxas' registers and spills per kernel and a census of the noise,
   field and tile kernels' conversions, f64, f32 and shared-memory
   instructions (cuobjdump -sass); torch.sqrt on the card equal to the
   float64 root rounded to float32 (and nums.fp.sqrt_rn) on 2^20 inputs;
3. every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with CUDA-event times (median of 7):
   K1 tiles (bitwise, lacunarity 2.0 and 1.7, and at the fused frame's
   occupancy — most slots count 0 — with a positive and a negative
   amplitude), K4 noise (bitwise, at the refine-probe shape 5 x 4096 x 6
   octaves, at 2^20 points x 18 octaves and fBm at lacunarity 1.7), R1
   refine (bitwise in ids, depths, DF corners, n_leaves and the overflow
   flag, as the fused frame calls it: cap 4096, max_lod 18, ridged probes;
   on the 1080p static camera, the 8 orbit cameras, cap 64, which
   overflows, the 24 subtree roots and the dense camera of
   tools/r1_s1_parts, 300 m above the ridged surface at LOD quality 16;
   one launch, one kernel, a level), the DFS order kernel on R1's leaves
   of each of those cases at render cap 512 (bitwise in all seven
   outputs); on
   the record sets of tools/kernel_times.record_sets (the 1080p static
   scene, the three goldens, the orbit frames with huge records): K6
   route + gather (records and counts bitwise, also with every candidate
   dead, huge, span or live; the sectors its 1080p reads touch; and on
   config 3's flight, kernel_times.p64_route_inputs' 2,048 rows x 8,712
   candidates, also with every candidate dead or live, and its time
   against its bound), K2 on
   the span and K3 on the huge records and a screen-filling triangle
   (framebuffers bitwise equal, with and without wireframe; each K3 set
   timed under its own name), K2 and K3 on records whose every fragment
   has a NaN shade (tests/torch_scenes.nan_shade_records: bitwise, every
   shade packed as 0, as planet_tpu converts NaN to int32), the routed
   raster K6 -> K2 -> K3 with the counts on the device against the plain
   composition, and run under torch.cuda.set_sync_debug_mode("error") (no
   host read between setup and K3); C1, the triangle setup, against its
   plain version (live, span, straddler mask, its block counts and live
   record columns bitwise) on DeviceRenderer's render_cap rows with the
   leaf count on the device (the 1080p static camera, the orbit's first
   frame) and on PlanetEngine's leaves without one (1080p static, the
   near-clip and far-clip goldens), each timed beside its bound; C2, the
   clip pass (the straddlers compacted from C1's block counts into
   clip_cap slots, the used slots clipped), against its plain version on
   each of those sets (the slots' indices, n_straddle, the live records
   and their count bitwise); V1, the vertex program and its shade,
   against its plain version (clip, world, normal, height, snormal and
   shade bitwise, NaN by its bits) on DeviceRenderer's 512 rows at 1080p
   (the "uniforms" rung's inputs, 302 padding rows, which the kernel
   finds by their NaN corner normals), the plain version's padding rows
   holding the NaN word 0x7fffffff, and on PlanetEngine's leaves of the
   three goldens, each timed beside its bound; A1, the cache stage and
   generate's prologue, against its plain version (slot, target,
   generate, crop, the failure flag, the generations' corners, octaves,
   slots and count, and the pool's keys and ticks bitwise, with and
   without its touch) and U1, the uniforms, against its (variants,
   camera-relative corners, normals, skirt bitwise; the padding rows'
   normals 0x7fffffff), on the calls of DeviceRenderer's step at 1080p
   (kernel_times.stage_inputs: the static camera's first two frames, the
   orbit's first four), each timed beside its bound; V1 in its rows mode
   (the fused step's form: the uniforms computed in V1's own staging from
   the rows' words and DF corners, no U1) on the same frames' rows,
   bitwise equal to its plain version and to V1 on U1's outputs ("U1 +
   V1", the stage before it), its padding rows' five NaN outputs the word
   0x7fffffff, timed beside U1 + V1 and its bound;
4. the host-orchestrated path, PlanetEngine(...).render on the card,
   against the oracle's frame / nearclip / farclip golden images at their
   test bars;
5. that path at real size: the 1920x1080 static scene (3 frames,
   per-stage ms) and 8 frames of a descending orbit;
5a. the fused device frame's CUDA graph: two replays of the geometry step
   bitwise equal to the same step run eagerly on the card, the replay's
   CUDA-event time, and a torch.profiler trace of one replay whose device
   events include the K1 and R1 kernels and no K4 (R1 inlines its probe
   noise; the replay launches R1 once a level);
5b. the fused device frame, DeviceRenderer(...).render through two graph
   replays a frame (the geometry step, then the raster: C1, K6, K2, C2,
   K3 on all render_cap rows, no host read): the golden / nearclip / farclip
   scenes at their bars, the 1920x1080 static scene (10 frames; then one
   more whole render under torch.cuda.set_sync_debug_mode("error"),
   bitwise the last frame; then the geometry and raster replays timed
   apart) and the 8-frame orbit, each orbit frame's leaf ids equal to
   phase 5's PlanetEngine on the same camera; V1 (in its rows mode) and
   A1 launched once a geometry replay (and once by each capture's eager
   warm-up), U1 never; BASELINE config 3's frame (64-vertex patches over
   66 x 66 tiles, perfbench/configs/lod-1080p-p64.json) on four cameras of
   the flight (perfbench/traffic/flight.json), none overflowing, V1's
   wide instance ("tess_wide") once a geometry replay and capture and its
   narrow ones never;
6. launch counts: each kernel of each path launched during that path's
   phases (4-5: tile, tess, gather, span, huge; 5b: those, refine, cache,
   setup and clip) > 0, and K4 and U1 not launched by 5b;
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
   and full tile equal to K1 on the same inputs, each variant's time
   (t_noise's f64conv and single_lookups each put one part of the noise
   core back in the first port's form), and each t_* kernel launched > 0
   times; span_parts' bodies on the 1080p scene's span records
   (bench_given: K2's first-port body, its atomics alone, the record read
   alone, 8 records a warp);
   then K1-K6 again at their phase-3 (and K5 at its 7b) shapes with the
   tools' queued timer (tools/common.time_calls: calls queued behind a
   spin kernel, so a short kernel's time holds no host launch time):
   tools/kernel_times.calls on phase 3's record sets and fused
   occupancy (with R1 and S1 at phase 9a's shapes, C1 and C2 on phase
   3's setup inputs, V1 on phase 3's vertex inputs and on the parts of
   the 512 rows (kernel_times.tess_probes), A1, U1, V1's rows mode and U1
   + V1 on phase 3's calls, K6 on phase 3's config-3 flight too,
   and the clip pass on each setup set: C2, K3 on its records' count, and
   the two together), A1's and U1's plain versions (the composed torch
   ops they replace) queued the same way, and its host_calls
   (K6 by the host clock); R1's queued time over the static camera's
   live levels, beside its bound;
9. the single-card rest (`single_card_rest`), at 1920x1080 with the
   driver's supersample rule (8), each part's counts reset before and
   read after: (a) the splat kernel S1 against its plain version at the
   main path's two shapes (PlanetEngine's leaves, DeviceRenderer's
   render_cap rows) and the splat raster card against CPU bit for bit
   (run under set_sync_debug_mode("error")), then, counted alone,
   PlanetEngine and DeviceRenderer splat frames (ms; the orbit's leaf ids
   equal to phase 5's exact-mode ids; one S1 launch a frame); (b) the terrain and heightmap API
   on the card bitwise against the oracle goldens (f64) and within 1e-5
   (K4); (c) run_interactive on a 30-line script on PlanetEngine and on
   DeviceInteractiveEngine(preview=2), ms a frame, the PNG dumps equal to
   the full frames, and the driver's --profile trace holding K1; (d)
   entry()'s forward on the card against CPU tensors;
10. the multi-card slice (planet_tpu_torch.parallel, `sharded_paths`) on
   the one card, counts reset before and read after: (a) on an NCCL world
   of one rank, sharded_field_step (both seams) bitwise equal to
   unsharded_field_step at 6x1024^2 and within the field bars of the
   composed frame, and sharded_field_step_fused at config 5's 6x8192^2
   bitwise equal to field_cube (seconds); (b) build_sharded_render over the
   24 subtree roots at 1920x1080 (phase 5's camera) bitwise equal to the
   single-device frame from those roots, its leaves phase 5b's with the
   depth-0 ones split, warm frame ms; (c) four ranks' shares in turn in
   this process, their packed framebuffers folded by torch.minimum
   bitwise equal to (b)'s; (d) four processes on the card over gloo,
   bitwise equal to (b); K1, K2, K4, K5, K6 and R1 launched (K3
   printed);
11. the stage bisection and the dry run (`stage_ladder`), counts reset
   before and read after: (a) planet_tpu_torch.tools.stage_times in a
   process of its own, its rung table (ms by CUDA events, marginal ms,
   each rung's device events in one torch.profiler session, launches a
   frame) for static-1080p and moving-1080p, each rung's leaves phase
   5b's; (b) from phase 5b's pool before its last static frame, the
   "geometry" rung bitwise equal to DeviceRenderer.geometry, V1 on the
   "uniforms" rung's U1 outputs (a captured graph, U1 its one launch)
   bitwise equal to the geometry rung's V1 rows, and the "full" rung's
   frame bitwise equal to phase 5b's; (c)
   entry.dryrun_multichip(4), four gloo processes sharing the card; K1,
   K2, R1, V1, U1 and K6 launched in this process, every rung launching R1
   and no K4, every rung from "cache" on A1 once, the uniforms rung U1
   once and the others never, the tess, geometry and full rungs V1 once,
   and no
   matrix-product kernel (cuBLAS's or CUTLASS's, by name) in the tess
   rung's trace; the cache, generate and uniforms rungs together at most
   STAGE_EVENTS_MAX device events; static-1080p's full rung with fewer
   device events than FULL_EVENTS_MAX (RASTER_EVENTS_MAX beyond the
   geometry rung's).

The second-to-last lines are a JSON summary of the kernels (launches from
phase 5b, from phase 7 for the field and noise kernels (K4 is off the fused
frame since R1), from phase 11 for U1 (off the fused frame since V1's rows
mode: the uniforms rung's), from phase 9a's frames for
S1 and from phase 8 for the t_* kernels, which also carry each variant's ms; each kernel's time, single
launch and queued, its plain version's, a library call's where one
computes the same function — none routes and gathers, so K6 gives the
composed torch sequence's time as composed_ms instead, as A1 and U1 give
their plain versions' queued time; V1's entry holds its rows mode's times
and bound under "rows_mode", beside U1 + V1's — and its bound,
tools/common.bound_ms: the
larger of its bytes over the card's memory rate and its f32 and f64
operations over the card's instruction rates at its SM clock) and the card's
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

# f32 operations per element beyond the noise core's (whose counts are
# tools/common.noise_work), counted from the kernel bodies in
# planet_tpu_torch/csrc: each add, subtract, multiply, divide, square root,
# compare and min/max is one operation, an error-free product two (the
# multiply and its fmaf). Integer hashing and conversions are not counted,
# so each bound is a floor. K1's texel (tile.cu: the uv, the corner blend
# and the amplitude) is tools/common's OPS_TILE_UV + OPS_TILE_BLEND + 1.
OPS_FIELD_TEXEL = 101       # field.cu: coordinates 84 (5 error-free
                            # products), the amplitude, normal and shade 16
# K2/K3's function (raster.cu): per bbox row its exact interval — per edge
# the line's boundary estimate (4) and the exact edge test on either side
# of it (2 x 5) — then per pixel inside the interval fragment()'s edge
# functions and tests, per accepted fragment the depth, normal, shade and
# packing. Pixels outside the row intervals are no part of the least work.
# the static-1080p full rung's device events a replay: 368 before the
# clip pass sat behind its count (29 of them the raster's, 25 since), 364
# before A1 and U1 took the cache, generate and uniforms rungs' 230 to 9
# (140 since; U1 left the later rungs with V1's rows mode); and those
# three rungs' events together, a replay: A1, K1, the store's few ops and
# U1
FULL_EVENTS_MAX, RASTER_EVENTS_MAX = 145, 29
STAGE_EVENTS_MAX = 20
OPS_ROW = 3 * (4 + 2 * 5)
OPS_CANDIDATE = 15
OPS_ACCEPTED = {"span": 41, "huge": 48}


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


# phase 9c's scripted interactive session: moves, look keys, speed digits,
# a slot save and recall, the wireframe toggle, the timing toggle and two
# PNG dumps, one frame a line ("q" ends it)
INTERACTIVE_SCRIPT = (
    "w", "w w", "3 w", "d", "a", "s", "up", "down", "left", "right",
    "sf1", "4 w", "w", "f1", "p", "png", "p", "left up", "w", "sf2 d",
    "right", "5 s", "f2", "png", "2 w", "down", "a d", "t", "t", "w", "q")


def png_pixels(path) -> np.ndarray:
    """The (H, W) u8 pixels of a grayscale PNG written by io/png.py."""
    import zlib
    data = pathlib.Path(path).read_bytes()
    width, height = (int.from_bytes(data[16 + 4 * i:20 + 4 * i], "big")
                     for i in range(2))
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(height, -1)[:, 1:].reshape(height, width)


def single_card_rest(dev, width, height, *, camera, orbit, orbit_ids,
                     reps=10, log=print, event_ms=None, bound=None):
    """Phase 9: the single-card modules ported last, at the given size
    (1920x1080 on the card; a CPU rehearsal passes a small one), each part
    with the launch counts set to 0 before it and read after:

    (a) the splat raster (raster_mode="splat", supersample by the driver's
        rule max(4, round(width / 240))), with and without wireframe: S1
        against its plain version at both of the main path's shapes
        (PlanetEngine's leaves of the static scene, on the card and on CPU
        copies; DeviceRenderer's render_cap rows, padding invalid), each
        card call under set_sync_debug_mode("error"); the splat raster on
        the card equal to the CPU's, and DeviceRenderer's frame equal to
        the splat of its first n_leaves rows; S1's times at both shapes,
        with and without wireframe.
        Then the main path alone, the counts set to 0 before it and read
        after: PlanetEngine splat frames (median ms, host clock +
        synchronize), DeviceRenderer splat frames (static, then the orbit,
        leaf ids equal to the exact mode's `orbit_ids`), one S1 launch a
        frame;
    (b) the terrain and heightmap API on the device: height_f64 and the
        f64 octave sums bitwise equal to the oracle goldens,
        generate_tile_f64 equal to tiles32, generate_tiles_df within 1e-5
        relative (K4);
    (c) run_interactive on INTERACTIVE_SCRIPT on PlanetEngine and on
        DeviceInteractiveEngine(preview=2): ms a frame (render + the
        display fetch + synchronize, host clock; median), each PNG dump
        equal to its frame's full image; driver.main with --profile writes
        a trace whose device events include K1;
    (d) entry()'s forward on the device against the same forward on CPU
        tensors (clip within 1e-5 of max(|clip|, 1), shade within 1e-5).

    event_ms(fn) times a call with CUDA events and bound(ops, bytes) gives
    a least time (main's helpers; the card only). Returns {name: number}
    for the summary, and on the card S1's rows under "splat"
    (PlanetEngine's shape) and "splat_device_rows"."""
    import contextlib
    import io
    import json as json_mod
    import tempfile

    import torch

    from planet_tpu_torch import _cuda, entry
    from planet_tpu_torch.engine import device_step
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.engine.planet import (PlanetEngine, splat_raster,
                                                splat_valid)
    from planet_tpu_torch.geom import camera as cam_mod
    from planet_tpu_torch.geom import cubesphere
    from planet_tpu_torch.geom import quadid
    from planet_tpu_torch.io import checkpoint, driver
    from planet_tpu_torch.models.terrain import RidgedTerrain
    from planet_tpu_torch.nums import df as dfm
    from planet_tpu_torch.ops import heightmap, perlin
    from planet_tpu_torch.raster import splat
    from planet_tpu_torch.tess import mesh
    from planet_tpu_torch.tess.vertex import PatchVertices

    cuda = dev.type == "cuda"
    res = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def no_host_reads():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")

    def counted(tag, kernels):
        got = dict(_cuda.launches)
        log(f"[9{tag}] launches: {got}")
        for k in kernels:
            check(got[k] > 0, f"phase 9{tag} launched no {k} kernel")

    def vp_of(cfg, cam):
        rot = cam_mod.camera_rotation(cam)
        pf = cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg))
        return (cam_mod.perspective_lh(pf, width / height, cfg.near_plane,
                                       cfg.far_plane)
                @ cam_mod.view_from_rotation(rot)).astype(np.float32)

    def host_ms(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, out

    # ------------------------------------------------------- (a) splat
    # first the checks and the kernel's own timing, then the main path's
    # frames alone between a reset of the counts and their reading
    ss = max(4, round(width / 240))
    cfg = EngineConfig(window_w=width, window_h=height, raster_mode="splat",
                       raster_supersample=ss)
    eng = PlanetEngine(cfg, device=dev)
    out = eng.frame(camera)
    grid_mask = torch.as_tensor(mesh.grid_uv_skirt(cfg.patch_verts)[3],
                                device=dev)
    valid = grid_mask[None].expand(out.n_leaves, -1, -1)
    pv_cpu = PatchVertices(*(a.cpu() for a in out.vertices))
    sv = splat_valid(out.vertices, valid)
    for wf in (False, True):
        # the splat kernel (S1) against its plain version on the same
        # inputs, on the card and on CPU copies, then the whole raster
        kargs = (out.vertices.clip, out.vertex_shade, sv, width, height,
                 max(ss, 2) if wf else ss, wf)
        with no_host_reads():
            keys = splat.splat_keys(*kargs)
        keys_p = splat.splat_keys_plain(*kargs)
        keys_c = splat.splat_keys_plain(*(a.cpu() if torch.is_tensor(a)
                                          else a for a in kargs))
        same_k = same_bits(keys, keys_p) and same_bits(keys.cpu(), keys_c)
        img, dep = splat_raster(out.vertices, out.vertex_shade, valid, cfg,
                                width, height, wf)
        img_p, dep_p = splat_raster(pv_cpu, out.vertex_shade.cpu(),
                                    valid.cpu(), cfg, width, height, wf)
        cov = float(torch.isfinite(dep).float().mean())
        same = same_bits(img.cpu(), img_p) and same_bits(dep.cpu(), dep_p)
        log(f"[9a] splat, static scene, PlanetEngine's {out.n_leaves} "
            f"leaves, supersample {kargs[5]}{', wireframe' if wf else ''}: "
            f"{cov:.4f} of pixels covered; S1 keys equal to the plain "
            f"version's on {dev.type} and on the CPU: {same_k}; image and "
            f"depth {dev.type} == CPU bit for bit: {same}")
        check(same_k, f"9a S1 splat keys != plain (wireframe {wf})")
        check(same, f"9a splat on the device != on the CPU (wireframe {wf})")
        check(cov > (0.1 if wf else 0.5),
              "9a splat covers too little of the screen")
    g = out.vertices.clip.shape[1]

    def s1_row(clip, shade, sv):
        """S1's times at the main path's shape (PlanetEngine's leaves, or
        DeviceRenderer's render_cap rows, padding invalid) and its bound:
        per fragment of a valid cell the blend of 5 values (35), the w test
        and reciprocal (2), the NDC (3), the pixel (8), range and depth
        tests (2) and the two clamped quantizations (10); the inputs read
        once, each covered pixel's key written once."""
        from planet_tpu_torch.tools import common as tool_common
        kargs = (clip, shade, sv, width, height, ss)
        wargs = (clip, shade, sv, width, height, max(ss, 2), True)
        n_rows = clip.shape[0]
        cells = int((sv[:, :-1, :-1] & sv[:, :-1, 1:] & sv[:, 1:, :-1]
                     & sv[:, 1:, 1:]).sum())
        covered = int((splat.splat_keys_plain(*kargs) != splat._EMPTY).sum())
        return dict(
            ms=event_ms(lambda: splat.splat_keys_cuda(*kargs)),
            queued_ms=tool_common.time_ms(
                lambda: splat.splat_keys_cuda(*kargs)),
            queued_wireframe_ms=tool_common.time_ms(
                lambda: splat.splat_keys_cuda(*wargs)),
            plain_ms=event_ms(lambda: splat.splat_keys_plain(*kargs)),
            bound=bound(cells * ss * ss * 60,
                        n_rows * g * g * 21 + covered * 4),
            fragments=n_rows * (g - 1) ** 2 * ss * ss, cells=cells,
            max_abs_err=0.0)

    def log_s1(row, what):
        log(f"[9a] S1 splat kernel, {what}: {row['fragments']} fragments "
            f"({row['cells']} valid cells x {ss * ss}): {row['ms']:.4f} ms "
            f"(queued {row['queued_ms']:.4f}; with wireframe, queued "
            f"{row['queued_wireframe_ms']:.4f}), plain {row['plain_ms']:.3f} "
            f"ms, bound {row['bound'][0]:.5f} ms ({row['bound'][1]})")

    if cuda:
        res["splat"] = s1_row(out.vertices.clip, out.vertex_shade, sv)
        log_s1(res["splat"], f"PlanetEngine's {out.n_leaves} leaves")
    # DeviceRenderer: S1 on all its render_cap rows (padding rows invalid)
    # against the plain version on the same card tensors, its splat raster
    # with no host read, and its frame equal to the splat of its first
    # n_leaves rows
    rend = device_step.DeviceRenderer(cfg, width, height, device=dev)
    pool = rend.init_pool()
    args = (*dfm.from_f64_np(camera.position), vp_of(cfg, camera))
    for wf in (False, True):
        rend.wireframe = wf
        fr = rend.render(pool, *args)
        geom = rend.last_geometry
        n = int(fr.n_leaves)
        gsv = splat_valid(geom.vertices, geom.valid)
        kargs = (geom.vertices.clip, geom.vertex_shade, gsv, width, height,
                 max(ss, 2) if wf else ss, wf)
        with no_host_reads():
            keys = splat.splat_keys(*kargs)
            img_all, dep_all = splat_raster(geom.vertices, geom.vertex_shade,
                                            geom.valid, cfg, width, height,
                                            wf)
        same_k = same_bits(keys, splat.splat_keys_plain(*kargs))
        img_n, dep_n = splat_raster(
            PatchVertices(*(a[:n] for a in geom.vertices)),
            geom.vertex_shade[:n], geom.valid[:n], cfg, width, height, wf)
        same = (same_bits(img_all, fr.image) and same_bits(dep_all, fr.depth)
                and same_bits(img_n, fr.image) and same_bits(dep_n, fr.depth))
        log(f"[9a] DeviceRenderer splat{', wireframe' if wf else ''}: "
            f"{n} leaves on {geom.valid.shape[0]} rows; S1 keys on all rows "
            f"equal to the plain version's: {same_k}; its splat raster ran "
            f"under set_sync_debug_mode('error') and equals the frame and "
            f"the splat of the first {n} rows bit for bit: {same}")
        check(same_k, f"9a DeviceRenderer S1 keys != plain (wireframe {wf})")
        check(same, f"9a DeviceRenderer splat != the splat of its leaves' "
              f"rows (wireframe {wf})")
        check(bool(torch.isfinite(fr.image).all()), "9a device splat: finite")
        check(not fr.overflowed, "9a device splat: overflowed")
    rend.wireframe = False
    if cuda:
        res["splat_device_rows"] = s1_row(geom.vertices.clip,
                                          geom.vertex_shade, gsv)
        log_s1(res["splat_device_rows"],
               f"DeviceRenderer's {geom.valid.shape[0]} rows")

    # the main path: PlanetEngine frames, DeviceRenderer frames and the
    # orbit, counted alone
    _cuda.reset_launches()
    captures0 = rend.raster_captures
    frame_ms = []
    for i in range(reps + 2):
        ms, (_, image, depth) = host_ms(lambda: eng.render(camera))
        check(bool(torch.isfinite(image).all()), "9a splat image not finite")
        frame_ms.append(ms)
    static_ms = []
    for i in range(reps):
        ms, fr = host_ms(lambda: rend.render(pool, *args))
        static_ms.append(ms)
        static_leaves = int(fr.n_leaves)
        check(bool(torch.isfinite(fr.image).all()), "9a device splat: finite")
        check(not fr.overflowed, "9a device splat: overflowed")
    pool = rend.init_pool()
    orbit_ms = []
    for i, cam in enumerate(orbit):
        ms, fr = host_ms(lambda: rend.render(
            pool, *dfm.from_f64_np(cam.position), vp_of(cfg, cam)))
        orbit_ms.append(ms)
        g_o = rend.last_geometry
        ids = quadid.from_words(g_o.leaf_lo[:fr.n_leaves].cpu().numpy(),
                                g_o.leaf_hi[:fr.n_leaves].cpu().numpy())
        check(np.array_equal(ids, orbit_ids[i]),
              f"9a device splat orbit frame {i}: leaf ids differ from the "
              "exact mode's")
        check(bool(torch.isfinite(fr.image).all()), f"9a orbit {i}: finite")
    counted("a", ("tile", "refine", "tess", "splat"))
    check(_cuda.launches["noise"] == 0, "9a: the splat frames launched K4")
    # the orbit's new pool captures both graphs again, the raster after a
    # warm-up run that launches S1 once
    n_frames = reps + 2 + reps + len(orbit)
    warmups = rend.raster_captures - captures0
    check(_cuda.launches["splat"] == n_frames + warmups,
          f"9a {n_frames} splat frames and {warmups} raster warm-ups "
          f"launched S1 {_cuda.launches['splat']} times")
    res["splat_launches"] = _cuda.launches["splat"]
    res["planet_splat_static_ms"] = float(np.median(frame_ms[2:]))
    log(f"[9a] PlanetEngine splat frame {width}x{height}: median of "
        f"{reps} warm frames {res['planet_splat_static_ms']:.3f} ms (min "
        f"{min(frame_ms[2:]):.3f}, max {max(frame_ms[2:]):.3f}; host clock "
        f"+ synchronize)")
    res["device_splat_static_ms"] = float(np.median(static_ms[2:]))
    log(f"[9a] DeviceRenderer splat frame: {static_leaves} leaves; median of "
        f"frames 2-{reps - 1} {res['device_splat_static_ms']:.3f} ms (frames: "
        + ", ".join(f"{m:.2f}" for m in static_ms) + ")")
    res["device_splat_orbit_ms"] = orbit_ms
    log("[9a] DeviceRenderer splat orbit: leaf ids equal to the exact "
        "mode's on every frame; ms " + ", ".join(f"{m:.2f}" for m in orbit_ms))
    log(f"[9a] S1 launches in the main path's {n_frames} frames "
        f"({reps + 2} PlanetEngine, {reps} DeviceRenderer, {len(orbit)} "
        f"orbit): {res['splat_launches']}")

    # --------------------------------------------- (b) terrain, heightmap
    _cuda.reset_launches()
    gold = ROOT / "tests" / "goldens"
    ridged = RidgedTerrain()
    pts = torch.as_tensor(np.load(gold / "pts_sphere.npy"), device=dev)
    for name, depth, max_depth in (("terrain_d0_md1", 0, 1),
                                   ("terrain_d6_md18", 6, 18),
                                   ("terrain_d18_md18", 18, 18)):
        got = ridged.height_f64(pts, depth, max_depth).cpu().numpy()
        want = np.load(gold / f"{name}.npy")
        check(np.array_equal(got, want), f"9b height_f64 on {dev.type} != "
              f"{name} at {int((got != want).sum())} of {want.size} points "
              f"(max abs err {np.abs(got - want).max()}): torch's "
              f"{dev.type} float64 ops differ from the oracle's")
    pf = torch.as_tensor(np.load(gold / "pts_fbm.npy"), device=dev)
    for name, fn, kw in (
            ("fbm_o4_g05", perlin.fbm_f64, dict(gain=0.5, octaves=4)),
            ("ridged_o18_g055", perlin.ridged_f64,
             dict(gain=0.55, octaves=18)),
            ("fbm_lac17_o5", perlin.fbm_f64,
             dict(lacunarity=1.7, gain=0.5, octaves=5))):
        kw["gain"] = np.float32(kw["gain"])
        got = fn(pf[:, 0], pf[:, 1], pf[:, 2], **kw).cpu().numpy()
        want = np.load(gold / f"{name}.npy")
        check(np.array_equal(got, want), f"9b {fn.__name__} on {dev.type} "
              f"!= {name} (max abs err {np.abs(got - want).max()})")
    tiles32 = np.load(gold / "tiles32.npy")
    paths = [(int(r[0]), [int(c) for c in r[1:] if c >= 0])
             for r in np.load(gold / "tile_paths.npy")]
    corners = np.stack([cubesphere.corners_from_path(f, d, 6371000.0)
                        for f, d in paths])
    for i, (f, d) in enumerate(paths):
        got = heightmap.generate_tile_f64(
            torch.as_tensor(corners[i], device=dev), 32, ridged, len(d),
            18).cpu().numpy()
        check(np.array_equal(got, tiles32[i]), f"9b generate_tile_f64 on "
              f"{dev.type} != tiles32[{i}] (max abs err "
              f"{np.abs(got - tiles32[i]).max()})")
    ch, cl = (torch.as_tensor(a, device=dev)
              for a in dfm.from_f64_np(corners))
    depths = np.array([len(d) for _, d in paths])
    worst = 0.0
    for depth in np.unique(depths):
        sel = torch.as_tensor(np.nonzero(depths == depth)[0], device=dev)
        got = heightmap.generate_tiles_df(ch[sel], cl[sel], 32, ridged,
                                          int(depth), 18).cpu().numpy()
        want = tiles32[depths == depth]
        worst = max(worst, float((np.abs(got - want)
                                  / np.maximum(np.abs(want), 884.8)).max()))
    check(worst <= 1e-5, f"9b generate_tiles_df: {worst} relative > 1e-5")
    log(f"[9b] on {dev.type}: height_f64 bitwise equal to the 3 terrain "
        f"goldens, fbm_f64 / ridged_f64 to 3 octave goldens, "
        f"generate_tile_f64 to all {len(paths)} tiles32 tiles; "
        f"generate_tiles_df within {worst:.3g} relative (bar 1e-5)")
    counted("b", ("noise",))

    # ---------------------------------------------------- (c) interactive
    class Timed:
        """run_interactive's engine with each frame timed and kept."""

        def __init__(self, engine, fetch_full):
            self.engine, self.fetch_full = engine, fetch_full
            self.ms, self.images = [], []

        @property
        def wireframe(self):
            return self.engine.wireframe

        @wireframe.setter
        def wireframe(self, v):
            self.engine.wireframe = v

        @property
        def skirts(self):
            return self.engine.skirts

        @skirts.setter
        def skirts(self, v):
            self.engine.skirts = v

        def render(self, cam, w=None, h=None):
            def one():
                o = self.engine.render(cam, w, h)
                if self.fetch_full:     # PlanetEngine's display: the frame
                    o[1].cpu()
                return o
            ms, o = host_ms(one)
            self.ms.append(ms)
            # DeviceRenderer's image is its raster graph's output buffer,
            # which the next frame writes
            self.images.append(o[1].clone())
            return o

    cfgi = EngineConfig(window_w=width, window_h=height,
                        raster_supersample=ss)
    script = "\n".join(INTERACTIVE_SCRIPT) + "\n"
    with tempfile.TemporaryDirectory() as tmp:
        for label, make, key in (
                ("PlanetEngine", lambda: Timed(PlanetEngine(cfgi, device=dev),
                                               True), "planet"),
                ("DeviceInteractiveEngine(preview=2)", lambda: Timed(
                    driver.DeviceInteractiveEngine(cfgi, width, height,
                                                   preview=2, device=dev),
                    False), "device")):
            _cuda.reset_launches()
            teng = make()
            _, slots = checkpoint.default_state(cfgi.radius)
            outdir = pathlib.Path(tmp) / key
            outdir.mkdir()
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                driver.run_interactive(teng, camera.copy(), slots, width,
                                       height, str(outdir),
                                       stream=io.StringIO(script))
            n = len(INTERACTIVE_SCRIPT) - 1
            check(text.getvalue().count("frametime:") == n,
                  f"9c {label}: {n} frames expected")
            dumps = sorted(outdir.iterdir())
            check(len(dumps) == 2, f"9c {label}: two PNG dumps expected")
            for path in dumps:
                i = int(path.stem.split("_")[1])
                im = teng.images[i]
                if im.dtype != torch.uint8:
                    im = (torch.clamp(im, 0.0, 1.0) * 255.0 + 0.5).to(
                        torch.uint8)
                check(np.array_equal(png_pixels(path), im.cpu().numpy()),
                      f"9c {label}: {path.name} != its full frame")
            res[f"interactive_{key}_ms"] = float(np.median(teng.ms[2:]))
            log(f"[9c] run_interactive, {label}, {width}x{height}, {n} "
                f"frames: median {res[f'interactive_{key}_ms']:.3f} ms a "
                f"frame (frames 2-{n - 1}; min {min(teng.ms[2:]):.3f}, max "
                f"{max(teng.ms[2:]):.3f}); PNG dumps equal to the full "
                f"frames")
            counted("c", ("tile", "tess", "span", "gather", "huge")
                    + (("refine",) if key == "device" else ()))
            del teng
        # the driver as a user runs it, in a process of its own: in this
        # long-lived one, the profiler's later sessions recorded none of the
        # port's ctypes-launched kernels (PERF.md section 7)
        prof = pathlib.Path(tmp) / "profile"
        run = subprocess.run(
            [sys.executable, "-m", "planet_tpu_torch.io.driver", "--frames",
             "2", "--width", str(width), "--height", str(height),
             "--altitude", "20000", "--out", str(pathlib.Path(tmp) / "f"),
             "--save", str(pathlib.Path(tmp) / "none.npz"), "--no-save",
             "--profile", str(prof), "--backend", dev.type],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        check(run.returncode == 0, f"9c driver --profile failed: "
              f"{run.stderr[-2000:]}")
        events = json_mod.loads((prof / "trace.json").read_text()).get(
            "traceEvents", [])
        kernels = [e for e in events if e.get("cat") == "kernel"]
        tag = "(anonymous namespace)::"
        ours = sorted({e["name"][len(tag):].split("(")[0] for e in kernels
                       if e.get("name", "").startswith(tag)})
        k1 = sum("tiles_kernel" in e.get("name", "") for e in kernels)
        log(f"[9c] driver --profile (its own process): {len(events)} trace "
            f"events, {len(kernels)} device kernel events, {k1} of K1; the "
            f"port's kernels in the trace: {ours}")
        if cuda:
            check(k1 > 0, "9c the --profile trace shows no K1 kernel")

    # ------------------------------------------------------- (d) entry()
    _cuda.reset_launches()
    forward, args = entry.entry(device=dev)
    clip, shade = forward(*args)
    sync()
    counted("d", ("noise",))
    clip_p, shade_p = forward(*(a.cpu() for a in args))
    clip, shade = clip.cpu().numpy(), shade.cpu().numpy()
    clip_p, shade_p = clip_p.numpy(), shade_p.numpy()
    rel = float((np.abs(clip - clip_p) / np.maximum(np.abs(clip_p), 1.0))
                .max())
    ds = float(np.abs(shade - shade_p).max())
    log(f"[9d] entry() forward, {clip.shape[0]} leaves: {dev.type} against "
        f"CPU tensors: clip within {rel:.3g} of max(|clip|, 1) (bar 1e-5), "
        f"shade within {ds:.3g} (bar 1e-5)")
    check(np.isfinite(clip).all() and np.isfinite(shade).all(),
          "9d entry forward not finite")
    check(rel <= 1e-5 and ds <= 1e-5, "9d entry forward off its CPU run")
    return res


def sharded_paths(dev, width, height, *, camera_args, static_ids,
                  field_n, config5_n, ranks=4, reps=10, log=print):
    """Phase 10: the multi-card slice (planet_tpu_torch.parallel) on one
    card, at `width` x `height` and the given field sizes (1920x1080, 1024
    and config 5's 8192 on the card; a CPU rehearsal passes small ones and
    runs gloo where the card runs NCCL). The caller sets the launch counts
    to 0 before it and reads them after.

    (a) NCCL, a world of one rank: sharded_field_step (ridged 6, K4) with
        seam "exchange" and "clamp" bitwise equal to unsharded_field_step,
        stats at rtol 1e-6; heights within 0.2 m of the composed frame
        heightfield.frame_cube(field_n, fused=False), shade within 1e-3
        (with "exchange" off the face-edge texels, whose differences it
        changes by design); sharded_field_step_fused at config5_n (K5's
        strip form) bitwise equal to field_cuda.field_cube, in seconds;
    (b) NCCL, a world of one rank: build_sharded_render over all 24
        subtree roots, run until it generates nothing, bitwise equal
        (image and depth) to the single-device DeviceRenderer from the 24
        roots run as long; its leaf ids are phase 5b's `static_ids` with each
        depth-0 leaf (a face that does not split from 6 roots) replaced by
        its four children; the median ms of `reps` warm frames;
    (c) `ranks` ranks in turn in this process, each with its share of the
        roots, its own pool and its own graph: the torch.minimum fold of
        their packed framebuffers bitwise equal to (b)'s single-device
        one, the leaf sets disjoint with (b)'s set as their union; each
        rank's warm frame ms;
    (d) `ranks` processes on this one card over gloo (CUDA tensors):
        build_sharded_render with N = ranks, its last frame bitwise equal
        to (b)'s.

    Returns {name: number} for the [10] line."""
    import tempfile

    import torch
    import torch.distributed as dist

    import torch_ranks
    from planet_tpu_torch.cache import device_pool
    from planet_tpu_torch.engine import device_step
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.geom import quadid
    from planet_tpu_torch.models import heightfield
    from planet_tpu_torch.ops.kernels import field_cuda
    from planet_tpu_torch.parallel import facemesh, sharded, sharded_lod

    cuda = dev.type == "cuda"
    cfg = EngineConfig(window_w=width, window_h=height)
    radius = cfg.radius
    res = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def ids_of(q_lo, q_hi, n):
        return set(int(q) for q in quadid.from_words(
            q_lo[:n].cpu().numpy(), q_hi[:n].cpu().numpy()))

    def frame_counts(frame):
        return (int(frame.n_leaves), int(frame.n_generated),
                bool(frame.overflowed))

    def converge(render, tag, counts=frame_counts):
        """Frames until one generates nothing (at most 4); the last one's
        output. counts(output) -> (leaves, generated, overflowed)."""
        for i in range(4):
            sync()
            t0 = time.perf_counter()
            out = render()
            sync()
            n, n_gen, ovf = counts(out)
            log(f"[10{tag}] frame {i}: leaves {n}, tiles generated {n_gen},"
                f" overflowed {ovf}; {(time.perf_counter() - t0) * 1e3:.3f}"
                " ms")
            check(not ovf, f"10{tag}: overflowed")
            if n_gen == 0:
                return out
        raise SmokeFailure(f"10{tag}: still generating after 4 frames")

    def warm_ms(render):
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            render()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        kw = {"device_id": torch.device("cuda", 0)} if cuda else {}
        backend = "nccl" if cuda else "gloo"
        dist.init_process_group(backend,
                                init_method=f"file://{tmp}/store", rank=0,
                                world_size=1, **kw)
        try:
            # --------------------------------------------------- (a) field
            t_a = time.perf_counter()
            mesh = sharded.make_mesh(1, device_type=dev.type)
            px, py, pz = facemesh.face_grid_points_df(field_n, radius,
                                                      device=dev)
            comps = (*px, *py, *pz)
            xyscale = field_cuda.default_xyscale(field_n, radius)
            hc, sc = heightfield.frame_cube(field_n, radius, fused=False,
                                            device=dev)
            inner = (slice(None), slice(1, -1), slice(1, -1))
            for seam in sharded.SEAMS:
                h, sh, st = sharded.sharded_field_step(
                    mesh, octaves=6, xyscale=xyscale, seam=seam)(*comps)
                uh, ush, ust = sharded.unsharded_field_step(
                    octaves=6, xyscale=xyscale, seam=seam)(*comps)
                sync()
                check(same_bits(h, uh) and same_bits(sh, ush),
                      f"10a {seam}: sharded != unsharded")
                check(torch.allclose(st, ust, rtol=1e-6, atol=0.0),
                      f"10a {seam}: stats {st.tolist()} != {ust.tolist()}")
                eh = float((h - hc).abs().max())
                es = float((sh - sc)[inner if seam == "exchange" else ...]
                           .abs().max())
                check(eh <= 0.2 and es <= 1e-3, f"10a {seam}: off the "
                      f"composed frame by {eh} m / {es} in shade")
                check(bool(torch.isfinite(sh).all()),
                      f"10a {seam}: not finite")
                res[f"field_{seam}_vs_composed"] = [eh, es]
                log(f"[10a] sharded_field_step 6x{field_n}^2 ridged 6, seam "
                    f"{seam}: bitwise equal to unsharded_field_step, stats "
                    f"{st.tolist()}; within {eh:.3g} m / {es:.3g} of "
                    "frame_cube(fused=False)"
                    + (" off the face-edge texels" if seam == "exchange"
                       else ""))
            del px, py, pz, comps, hc, sc, h, sh, uh, ush
            fused = sharded.sharded_field_step_fused(mesh, config5_n, radius)
            sync()
            t0 = time.perf_counter()
            h5, s5, st5 = fused()
            sync()
            res["config5_s"] = time.perf_counter() - t0
            f5h, f5s = field_cuda.field_cube(config5_n, radius, device=dev)
            check(same_bits(h5, f5h) and same_bits(s5, f5s),
                  "10a config 5: the fused sharded step != field_cube")
            check(float(st5[0]) == 6 * config5_n ** 2, "10a config 5: texels")
            log(f"[10a] sharded_field_step_fused 6x{config5_n}^2 on one rank: "
                f"{res['config5_s']:.4f} s; bitwise equal to field_cube; "
                f"stats {st5.tolist()}; (a) in "
                f"{time.perf_counter() - t_a:.1f} s")
            del h5, s5, f5h, f5s

            # ------------------------------------------ (b) LOD, one rank
            t_b = time.perf_counter()
            roots = sharded_lod.subtree_roots(radius, dev)
            qmesh = sharded.make_mesh(1, axis="quads", device_type=dev.type)
            fn = sharded_lod.build_sharded_render(cfg, qmesh, width, height)
            pool = device_pool.init(cfg.cache_capacity, cfg.tile_dim, dev)
            frame, (q_lo, q_hi, n, _) = converge(
                lambda: fn(pool, *camera_args), "b",
                lambda out: frame_counts(out[0]))
            single = device_step.DeviceRenderer(cfg, width, height, device=dev,
                                                roots=roots)
            spool = single.init_pool()
            want = converge(lambda: single.render(spool, *camera_args),
                            "b single")
            want_packed = device_step.raster_packed(
                single.last_geometry, cfg, width, height)[0][0]
            g = single.last_geometry
            want_ids = ids_of(g.leaf_lo, g.leaf_hi, want.n_leaves)
            check(same_bits(frame.image, want.image)
                  and same_bits(frame.depth, want.depth),
                  "10b: the sharded frame != the single-device frame")
            got_ids = ids_of(q_lo, q_hi, n)
            check(got_ids == want_ids, "10b: leaf ids != the single device's")
            depth0 = {q for q in static_ids
                      if quadid.depth_of(np.uint64(q)) == 0}
            split = (static_ids - depth0) | {
                int(quadid.make_child(np.uint64(q), c))
                for q in depth0 for c in range(4)}
            check(got_ids == split, "10b: leaf ids != phase 5b's with its "
                  "depth-0 leaves split")
            res["lod_leaves"] = [len(got_ids), len(static_ids), len(depth0)]
            res["lod_world1_ms"] = warm_ms(lambda: fn(pool, *camera_args))
            res["lod_single_ms"] = warm_ms(lambda: single.render(
                spool, *camera_args))
            log(f"[10b] build_sharded_render, {backend} world of 1, {width}x"
                f"{height}, 24 roots: image and depth bitwise equal to the "
                f"single-device 24-root frame; {len(got_ids)} leaves = "
                f"phase 5b's {len(static_ids)} with its {len(depth0)} depth-0 "
                f"leaves split; warm frame {res['lod_world1_ms']:.3f} ms "
                f"(single device, 24 roots "
                f"{res['lod_single_ms']:.3f} ms; median of {reps}); (b) in "
                f"{time.perf_counter() - t_b:.1f} s")
        finally:
            dist.destroy_process_group()
        del fn, pool, single, spool

        # ---------------------------------------------- (c) ranks in turn
        t_c = time.perf_counter()
        fold, union, rank_ms = None, set(), []
        for rank in range(ranks):
            r = device_step.DeviceRenderer(
                cfg, width, height, device=dev,
                roots=sharded_lod.local_roots(roots, rank, ranks))
            rpool = r.init_pool()

            def rank_frame():
                geom = r.geometry(rpool, *camera_args)
                return device_step.raster_packed(geom, cfg, width, height)[0]

            packed, n, _, _, q_lo, q_hi = converge(
                rank_frame, f"c rank {rank}",
                lambda out: (int(out[1]), int(out[2]), bool(out[3])))
            part = ids_of(q_lo, q_hi, n)
            check(not union & part, f"10c: rank {rank}'s leaves overlap")
            union |= part
            fold = packed if fold is None else torch.minimum(fold, packed)
            rank_ms.append(warm_ms(rank_frame))
            del r, rpool
        check(union == want_ids, "10c: the ranks' leaves != (b)'s")
        check(same_bits(fold, want_packed), "10c: the folded framebuffer != "
              "the single-device framebuffer")
        res["rank_ms"] = rank_ms
        log(f"[10c] {ranks} ranks in turn, one card: the torch.minimum fold "
            f"bitwise equal to (b)'s packed frame, leaf sets disjoint with "
            f"(b)'s as their union; warm frame ms by rank "
            + ", ".join(f"{t:.3f}" for t in rank_ms)
            + f"; (c) in {time.perf_counter() - t_c:.1f} s")

        # ---------------------------------- (d) processes over gloo, one card
        t_d = time.perf_counter()
        case = dict(mesh=(ranks,), max_lod=None, probe="ridged6",
                    frames=[camera_args] * 4)
        spec = dict(cfg=dict(window_w=width, window_h=height), width=width,
                    height=height, caps={}, device=dev.type,
                    cases={"d": case})
        torch_ranks.spawn(torch_ranks.lod_worker, ranks, f"{tmp}/d", spec)
        union = set()
        for rank in range(ranks):
            def load(key, frame=3):
                return torch_ranks.load(f"{tmp}/d", f"d.f{frame}", key, rank)
            counts = load("counts")
            check(counts[3] == 0 and counts[4] == 0,
                  f"10d rank {rank}: generating or overflowed: {counts}")
            check(np.array_equal(load("image"), want.image.cpu().numpy())
                  and np.array_equal(load("depth"), want.depth.cpu().numpy()),
                  f"10d rank {rank}: the composite != (b)'s frame")
            union |= set(int(q) for q in quadid.from_words(load("q_lo"),
                                                           load("q_hi")))
        check(union == want_ids, "10d: the ranks' leaves != (b)'s")
        res["gloo_rank_ms"] = [
            float(torch_ranks.load(f"{tmp}/d", "d.f3", "ms", r))
            for r in range(ranks)]
        log(f"[10d] {ranks} processes on one card over gloo: build_sharded_"
            f"render's 4th frame bitwise equal to (b)'s on every rank, leaves "
            f"as (b)'s; its ms by rank (host clock, collectives included) "
            + ", ".join(f"{t:.3f}" for t in res["gloo_rank_ms"])
            + f"; (d) in {time.perf_counter() - t_d:.1f} s")
    return res


def stage_ladder(dev, width, height, *, camera_args, static_pool,
                 static_frame, orbit_leaves, tool_args=(), ranks=4,
                 log=print):
    """Phase 11: the stage bisection (stop_after) and dryrun_multichip.
    The caller sets the launch counts to 0 before it and reads them after.

    (a) planet_tpu_torch.tools.stage_times in a process of its own (a
        fresh process, so that torch.profiler sees the ctypes-launched
        kernels; `tool_args` passes --device cpu --small in a CPU
        rehearsal): its rung table for static-1080p and moving-1080p, then
        its report: every rung of both scenes present, each rung's
        n_leaves phase 5b's (`static_frame.n_leaves`; `orbit_leaves`,
        frames 1 on), and on the card each rung's replay holding device
        events, K4 launched by every rung, K1 once by every rung from
        "generate" on, K6 and K2 by "full";
    (b) from phase 5b's pool state before its last static frame
        (`static_pool`) and its camera, in this process: the "geometry"
        rung's Geometry and pool bit for bit those of phase 5b's renderer's
        geometry(), V1 (its uniforms mode) on the "uniforms" rung's U1
        outputs the geometry rung's vertices and shade (V1's rows mode)
        bit for bit, and the "full" rung's frame bit for bit phase 5b's
        last static frame (`static_frame`);
    (c) entry.dryrun_multichip(ranks) with the ranks' tensors on `dev`.

    Returns {name: number} for the [11] line."""
    import tempfile

    import torch

    from planet_tpu_torch import entry
    from planet_tpu_torch.cache import device_pool
    from planet_tpu_torch.engine import device_step
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.tess import vertex_cuda

    cuda = dev.type == "cuda"
    res = {}

    # ------------------------------------------ (a) the ladder, a process
    t_a = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stages_") as tmp:
        out = pathlib.Path(tmp) / "stage_times.json"
        proc = subprocess.run(
            [sys.executable, "-m", "planet_tpu_torch.tools.stage_times",
             "--json", str(out), *tool_args], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        for line in proc.stdout.splitlines():
            log(f"[11a] {line}")
        check(proc.returncode == 0, "11a: stage_times exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        report = json.loads(out.read_text())
    scenes = report["scenes"]
    check(list(scenes) == ["static-1080p", "moving-1080p"],
          f"11a: scenes {list(scenes)}")
    for scene, rows in scenes.items():
        check([r["rung"] for r in rows] == list(device_step.RUNGS),
              f"11a {scene}: rungs {[r['rung'] for r in rows]}")
        for r in rows:
            want = (int(static_frame.n_leaves) if scene == "static-1080p"
                    else orbit_leaves[1:len(r["n_leaves"]) + 1])
            check(r["n_leaves"] == want, f"11a {scene} {r['rung']}: "
                  f"leaves {r['n_leaves']} != phase 5b's {want}")
            if not cuda:
                continue
            check(r["kernels"] > 0, f"11a {scene} {r['rung']}: no device "
                  "events in its window")
            check(r["launches"].get("refine", 0) > 0
                  and r["launches"].get("noise", 0) == 0,
                  f"11a {scene} {r['rung']}: launches {r['launches']} (R1 "
                  "expected, K4 not)")
            if r["rung"] not in ("refine", "cache"):
                check(r["launches"].get("tile", 0) == 1,
                      f"11a {scene} {r['rung']}: K1 launches "
                      f"{r['launches']}")
            if r["rung"] == "full":
                check(r["launches"].get("gather", 0) > 0
                      and r["launches"].get("span", 0) > 0,
                      f"11a {scene} full: raster launches {r['launches']}")
            if r["rung"] != "refine":
                check(r["launches"].get("cache", 0) == 1,
                      f"11a {scene} {r['rung']}: A1 launches "
                      f"{r['launches']} (one expected)")
            check(r["launches"].get("uniforms", 0)
                  == (r["rung"] == "uniforms"),
                  f"11a {scene} {r['rung']}: U1 launches {r['launches']} "
                  "(one on the uniforms rung, none on the others)")
            if r["rung"] == "uniforms":
                first = next(x for x in rows if x["rung"] == "refine")
                check(r["kernels"] - first["kernels"] <= STAGE_EVENTS_MAX,
                      f"11a {scene}: the cache, generate and uniforms "
                      f"rungs hold {r['kernels'] - first['kernels']} device "
                      f"events (at most {STAGE_EVENTS_MAX} expected)")
            if r["rung"] in ("tess", "geometry", "full"):
                check(r["launches"].get("tess", 0) == 1,
                      f"11a {scene} {r['rung']}: V1 launches "
                      f"{r['launches']} (one expected)")
            if r["rung"] == "tess":
                check(r["gemm_kernels"] == 0, f"11a {scene} tess: "
                      f"{r['gemm_kernels']} matrix-product kernels in its "
                      "trace")
            if r["rung"] == "full" and scene == "static-1080p":
                geo = next(x for x in rows if x["rung"] == "geometry")
                check(r["kernels"] < FULL_EVENTS_MAX
                      and r["kernels"] - geo["kernels"] < RASTER_EVENTS_MAX,
                      f"11a {scene} full: {r['kernels']} device events, "
                      f"{r['kernels'] - geo['kernels']} beyond the geometry "
                      f"rung's (fewer than {FULL_EVENTS_MAX} and "
                      f"{RASTER_EVENTS_MAX} expected)")
    res["stage_ms"] = {scene: {r["rung"]: r["ms"] for r in rows}
                       for scene, rows in scenes.items()}
    res["stage_kernels"] = {scene: {r["rung"]: r.get("kernels")
                                    for r in rows}
                            for scene, rows in scenes.items()}
    res["stage_gemm_kernels"] = {scene: {r["rung"]: r.get("gemm_kernels")
                                         for r in rows}
                                 for scene, rows in scenes.items()}
    res["stage_card"] = report["card"]
    log(f"[11a] stage_times: every rung of both scenes draws phase 5b's "
        f"leaves; (a) in {time.perf_counter() - t_a:.1f} s")

    # ------------------------------ (b) the geometry and full rungs, here
    t_b = time.perf_counter()
    cfg = EngineConfig(window_w=width, window_h=height)

    def pool_at(state):
        pool = device_pool.init(cfg.cache_capacity, cfg.tile_dim, dev)
        for t, v in zip(pool, state):
            t.copy_(v)
        return pool

    base = device_step.DeviceRenderer(cfg, width, height, device=dev)
    rung = device_step.DeviceRenderer(cfg, width, height, device=dev,
                                      stop_after="geometry")
    pool_base, pool_rung = pool_at(static_pool), pool_at(static_pool)
    want = base.geometry(pool_base, *camera_args)
    got = rung.geometry(pool_rung, *camera_args)
    for name in ("leaf_lo", "leaf_hi", "leaf_depth", "slot", "tiles",
                 "valid", "vertex_shade", "meta"):
        check(same_bits(getattr(got, name), getattr(want, name)),
              f"11b: the geometry rung's {name} != DeviceRenderer.geometry's")
    for a, b in zip(got.vertices, want.vertices):
        check(same_bits(a, b), "11b: the geometry rung's vertices != "
              "DeviceRenderer.geometry's")
    cap = cfg.cache_capacity
    for a, b in zip(pool_rung, pool_base):
        check(same_bits(a[:cap] if a.dim() else a, b[:cap] if b.dim() else b),
              "11b: the geometry rung's pool != DeviceRenderer.geometry's")
    # the uniforms rung, the one graph that launches U1: its outputs, fed
    # to V1 with the pool's tiles at its slots, give the geometry rung's
    # vertices and shade (V1's rows mode) bit for bit
    uni = device_step.DeviceRenderer(cfg, width, height, device=dev,
                                     stop_after="uniforms")
    pool_uni = pool_at(static_pool)
    o = uni.geometry(pool_uni, *camera_args).outputs
    tiles = device_pool.gather(pool_uni, o["slot"])
    pv, shade = vertex_cuda.tessellate_shaded(
        o["corners_rel"], o["normals"], tiles, o["vx"], o["vy"], o["skirt"],
        torch.as_tensor(np.asarray(camera_args[2], np.float32), device=dev),
        grid=cfg.patch_verts + 2)
    check(same_bits(tiles, want.tiles)
          and all(same_bits(a, b) for a, b in zip(pv, want.vertices))
          and same_bits(shade, want.vertex_shade),
          "11b: V1 on the uniforms rung's U1 outputs != the geometry rung's "
          "V1 rows")
    check(not cuda or (uni.graph_launches.get("uniforms") == 1
                       and uni.graph_launches.get("tess", 0) == 0),
          f"11b: the uniforms rung's graph launches {uni.graph_launches}")
    full = device_step.DeviceRenderer(cfg, width, height, device=dev,
                                      stop_after="full")
    frame = full.render(pool_at(static_pool), *camera_args)
    check(same_bits(frame.image, static_frame.image)
          and same_bits(frame.depth, static_frame.depth)
          and int(frame.n_leaves) == int(static_frame.n_leaves),
          "11b: the full rung's frame != phase 5b's static frame")
    log(f"[11b] from phase 5b's pool before its last static frame: the "
        f"geometry rung bitwise equal to DeviceRenderer.geometry (leaves, "
        f"slots, tiles, vertices, shade, counters, pool), V1 on the "
        f"uniforms rung's U1 outputs bitwise equal to its V1 rows, the full "
        f"rung's frame bitwise equal to phase 5b's ({int(frame.n_leaves)} "
        f"leaves); (b) in {time.perf_counter() - t_b:.1f} s")
    del base, rung, uni, full, pool_base, pool_rung, pool_uni

    # -------------------------------------------- (c) dryrun_multichip
    t_c = time.perf_counter()
    entry.dryrun_multichip(ranks, device=dev.type)
    res["dryrun_s"] = time.perf_counter() - t_c
    log(f"[11c] dryrun_multichip({ranks}) on {dev.type}: (a) the field "
        f"step, (a2) the 2-axis mesh bitwise, (b) the LOD composite bitwise "
        f"equal to the single-device step over the 24 roots, (b2) the "
        f"2-axis LOD mesh bitwise; {res['dryrun_s']:.1f} s")
    return res


def main() -> int:
    import torch

    # ------------------------------------------------------------ phase 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels need one", file=sys.stderr)
        return 2
    smi = gpu_line()
    print(f"[1] gpu: {smi}", flush=True)
    from planet_tpu_torch.tools import common as tool_common
    clock = tool_common.sm_clock_hz()
    sm_rate = tool_common.SMS * clock
    print(f"[1] SM clock (clocks.max.sm) {clock / 1e6:.0f} MHz: bounds at "
          f"{sm_rate * tool_common.F32_PER_SM_CLOCK:.4g} f32 and "
          f"{sm_rate * tool_common.F64_PER_SM_CLOCK:.4g} f64 operations a "
          f"second", flush=True)

    def bound_ms(ops, nbytes, f64_ops=0.0):
        return tool_common.bound_ms(ops, nbytes, f64_ops=f64_ops,
                                    sm_clock_hz=clock)
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
    from planet_tpu_torch.nums.fp import sqrt_rn
    from planet_tpu_torch.ops import perlin_np
    from planet_tpu_torch.ops.kernels import field_cuda, perlin_cuda, tile_cuda
    from planet_tpu_torch.raster import coverage as cov
    from planet_tpu_torch.raster import coverage_cuda as cc
    from planet_tpu_torch.cache import device_pool, device_pool_cuda
    from planet_tpu_torch.tess import uniforms_cuda, vertex_cuda
    from planet_tpu_torch.tools import kernel_times, r1_s1_parts
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import EDGE, counter_values, nan_shade_records

    dev = torch.device(DEVICE)

    # ------------------------------------------------------------ phase 2
    _cuda.library()
    print(f"[2] built kernels in {_cuda.build_info['seconds']:.2f} s "
          f"({_cuda.build_info['path']})", flush=True)
    for line in _cuda.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[2]   {line.strip()}", flush=True)
    for name, counts in tool_common.sass_census(
            _cuda.build_info["path"]).items():
        print(f"[2] sass {name[:70]}: " + " ".join(
            f"{op} {k}" for op, k in counts.items()), flush=True)

    # the card's root is correctly rounded (the f64 root rounded to f32),
    # as the kernels' sqrtf is: nums.fp.sqrt_rn takes it there
    rng = np.random.default_rng(20)
    x = torch.as_tensor((rng.uniform(0.0, 1.0, 1 << 20) * 10.0 ** rng.integers(
        -6, 14, 1 << 20)).astype(np.float32), device=dev)
    root = torch.sqrt(x)
    check(same_bits(root, torch.sqrt(x.double()).float())
          and same_bits(sqrt_rn(x), root),
          "torch.sqrt on the card is not the correctly rounded root")
    print(f"[2] torch.sqrt on the card equals the float64 root rounded to "
          f"float32 (and sqrt_rn) on {x.numel()} inputs", flush=True)
    del x, root

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
        return kernel_times.scene_camera(cfg1080)

    # tools/bench_moving.py's descending orbit, camera in numpy
    orbit = kernel_times.orbit_cameras(cfg1080)
    orbit_alts = [alt for alt, _ in orbit]

    def orbit_cams():
        return (cam for _, cam in orbit)

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
    # the fused frame's occupancy: a few live slots, the rest count 0
    fused = kernel_times.fused_tile_inputs(dev)
    for amp in (cfg1080.amplitude, -cfg1080.amplitude):
        kwf = dict(kw, amplitude=amp)
        kf = tile_cuda.tiles_cuda(*fused, **kwf)
        pf = tile_cuda.tiles_plain(*fused, **kwf)
        check(same_bits(kf, pf), f"K1 at the fused occupancy, amplitude "
              f"{amp}: != plain (max abs err "
              f"{float((kf - pf).abs().max())})")
    dead = fused[2] == 0
    print(f"[3] K1 tiles at the fused occupancy ({int((~dead).sum())} of "
          f"{dead.numel()} slots live, the rest count 0): bitwise equal "
          f"with amplitude +-{cfg1080.amplitude}", flush=True)
    octs_np = octs.cpu().numpy().astype(np.int64)
    k1_work = [tool_common.noise_work(o) for o in octs_np]
    ops_tile_texel = tool_common.OPS_TILE_UV + tool_common.OPS_TILE_BLEND + 1
    report["tile"] = dict(
        max_abs_err=max(err1, float((k17 - p17).abs().max())),
        ms=time_ms(lambda: tile_cuda.tiles_cuda(ch, cl, octs, **kw)),
        plain_ms=time_ms(lambda: tile_cuda.tiles_plain(ch, cl, octs, **kw)),
        bound=bound_ms(
            1024 * float(sum(ops_tile_texel + w[0] for w in k1_work)),
            len(octs_np) * (2 * 12 * 4 + 4 + 1024 * 4),
            1024 * float(sum(w[1] for w in k1_work))))
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
        n4 = c4[0].numel()
        ops4, f64_4 = tool_common.noise_work(octaves, kind, lac)
        bound4 = bound_ms(n4 * ops4, n4 * 28, n4 * f64_4)
        print(f"[3] K4 noise, {label}: bitwise equal; "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound4[0]:.5f} ms ({bound4[1]})", flush=True)
        if "noise" not in report:       # the main path's shape
            report["noise"] = dict(ms=ms, plain_ms=plain_ms, bound=bound4)
    report["noise"]["max_abs_err"] = err4

    # R1: the fused frame's refine as the main path calls it (cap 4096,
    # max_lod 18, ridged probes, the six faces) against its plain version
    # (every level at full width, its probes through K4) bit for bit, on
    # the 1080p static camera, the orbit, an overflowing cap and the 24
    # subtree roots with their depths
    from planet_tpu_torch.lod import refine_device as lod_refine_device
    from planet_tpu_torch.ops.kernels import refine_cuda
    from planet_tpu_torch.parallel import sharded_lod
    faces = device_step.face_roots(cfg1080.radius, dev)[:4]
    subtrees = sharded_lod.subtree_roots(cfg1080.radius, dev)

    def refine_inputs(pos, roots=faces, **kw):
        c = [torch.as_tensor(a, device=dev) for a in dfm.from_f64_np(pos)]
        return (*c, *roots), dict(dict(
            max_lod=cfg1080.max_lod, cap=4096, radius=cfg1080.radius,
            probe="ridged6"), **kw)

    r1_cases = [("1080p static", refine_inputs(bench_cam().position)),
                *((f"orbit frame {i}", refine_inputs(cam.position))
                  for i, cam in enumerate(orbit_cams())),
                ("1080p static, cap 64 (overflows)",
                 refine_inputs(bench_cam().position, cap=64)),
                ("1080p static, the 24 subtree roots",
                 refine_inputs(bench_cam().position, roots=subtrees[:4],
                               root_depth=subtrees[4])),
                # the dense frontier: 300 m above the ridged surface at LOD
                # quality 16 (3,177 leaves, up to 384 slots a level)
                ("dense camera", refine_inputs(
                    r1_s1_parts.dense_camera(cfg1080),
                    quality=r1_s1_parts.DENSE_QUALITY))]
    err_r1, r1_leaves = 0.0, []
    for label, (args, kw) in r1_cases:
        got = refine_cuda.refine_cuda(*args, **kw)
        want = lod_refine_device.refine_plain(*args, **kw)
        torch.cuda.synchronize()
        err_r1 = max(err_r1, float((got[1] - want[1]).abs().max()))
        for name, a, b in zip(("ids and depths", "corners", "n_leaves",
                               "overflowed"), got, want):
            check(same_bits(a, b), f"R1 {label}: {name} != plain (max abs "
                  f"err {err_r1})")
        check(bool(got[3]) == ("overflows" in label),
              f"R1 {label}: overflowed {bool(got[3])}")
        # the DFS order kernel on R1's leaves, at the fused frame's render
        # cap (the dense camera's leaves overflow it)
        o_args = (*got[0], got[1][:12], got[1][12:], got[2], got[3])
        rc = min(512, kw["cap"])
        for name, a, b in zip(lod_refine_device.Ordered._fields,
                              refine_cuda.dfs_order_cuda(*o_args, rc),
                              lod_refine_device.dfs_order_plain(*o_args,
                                                                rc)):
            check(same_bits(a, b), f"DFS order {label}: {name} != plain")
        r1_leaves.append(int(got[2]))
        if len(r1_leaves) == 1:        # the static camera: its live levels
            r1_live = sum(1 for n in r1_s1_parts.frontier_sizes(
                got[0][2, :int(got[2])].cpu().numpy(), kw["max_lod"], 6)
                if n)
        print(f"[3] R1 refine, {label}: {int(got[2])} leaves, overflowed "
              f"{bool(got[3])}; bitwise equal to plain (ids, depths, DF "
              f"corners, counts)", flush=True)
    args, kw = r1_cases[0][1]
    n_r1 = r1_leaves[0]
    splits_r1 = (n_r1 - 6) // 3          # every split slot's 4 children
    ops_r1, f64_r1 = tool_common.refine_work(n_r1 + splits_r1, splits_r1)
    # read once: the camera and the six roots; written once: the (27, cap)
    # leaf rows, n_leaves and the flag
    bytes_r1 = 24 + 6 * (3 * 4 + 2 * 48) + 4096 * 27 * 4 + 5
    before = _cuda.launches["refine"]
    report["refine"] = dict(
        max_abs_err=err_r1,
        ms=time_ms(lambda: refine_cuda.refine_cuda(*args, **kw)),
        plain_ms=time_ms(lambda: lod_refine_device.refine_plain(*args,
                                                                **kw)),
        bound=bound_ms(ops_r1, bytes_r1, f64_r1))
    check(_cuda.launches["refine"] - before == REPS * (kw["max_lod"] + 1),
          "R1: not one launch a level")
    print(f"[3] R1 refine, 1080p static ({n_r1} leaves, {n_r1 + splits_r1} "
          f"live slots evaluated, {splits_r1} split, {kw['max_lod'] + 1} "
          f"launches a refine): kernel {report['refine']['ms']:.3f} ms, "
          f"plain {report['refine']['plain_ms']:.3f} ms, bound "
          f"{report['refine']['bound'][0]:.5f} ms "
          f"({report['refine']['bound'][1]})", flush=True)
    args_d, kw_d = r1_cases[-1][1]
    print(f"[3] R1 refine, dense camera ({r1_leaves[-1]} leaves): kernel "
          f"{time_ms(lambda: refine_cuda.refine_cuda(*args_d, **kw_d)):.3f} "
          f"ms", flush=True)

    def raster_compare(name, width, height, kernel, plain, key,
                       wireframe=False):
        """kernel(fb, wireframe) and plain(fb, wireframe) into two fresh
        framebuffers, held equal bit for bit."""
        fbk = torch.full((height, width), cov._EMPTY, dtype=torch.int32,
                         device=dev)
        fbp = fbk.clone()
        kernel(fbk, wireframe)
        plain(fbp, wireframe)
        name = f"{name}{', wireframe' if wireframe else ''}"
        k, p = fbk.cpu().numpy(), fbp.cpu().numpy()
        ck, cp = k != cov._EMPTY, p != cov._EMPTY
        n_cov = int((ck != cp).sum())
        both = ck & cp
        dz = np.abs((k[both] >> 10) - (p[both] >> 10))
        ds = np.abs((k[both] & 1023) - (p[both] & 1023))
        err = int(max(dz.max(initial=0), ds.max(initial=0)))
        n_diff = int((k != p).sum())
        print(f"[3] {key} {name}: {int(ck.sum())} px covered, coverage "
              f"mismatches {n_cov}, pixels differing {n_diff}, max "
              f"packed-field diff {err}", flush=True)
        check(torch.equal(fbk, fbp), f"{key} framebuffer != plain on {name} "
              f"({n_cov} coverage mismatches, {n_diff} pixels differ)")
        return err

    def records_compare(name, recs, width, height, key):
        """The kernel of `key` on the records against its plain version,
        with and without wireframe."""
        kernel = cc.raster_span_cuda if key == "K2" else cc.raster_huge_cuda
        plain = cc.raster_span_plain if key == "K2" else cc.raster_huge_plain
        return max(raster_compare(
            f"{name}, {recs.shape[0]} records", width, height,
            lambda fb, wf: kernel(recs, fb, wf),
            lambda fb, wf: plain(recs, fb, wf), key, wireframe=wf)
            for wf in (False, True))

    def fresh_fb(width, height):
        return lambda: (torch.full((height, width), cov._EMPTY,
                                   dtype=torch.int32, device=dev),)

    def raster_bound(key, recs, width, height):
        """K2/K3's bound on these records, a property of the function: each
        bbox row's exact interval is found (coverage_cuda.row_intervals_plain
        counts the rows and the pixels inside them), each pixel inside is
        tested, each covered pixel took at least one accepted fragment; the
        records are read once and each covered pixel's key read and
        written once (a pixel no fragment reaches is not touched)."""
        fb = fresh_fb(width, height)()[0]
        kernel = cc.raster_span_cuda if key == "span" else cc.raster_huge_cuda
        kernel(recs, fb)
        _, _, lo, hi = cc.row_intervals_plain(recs)
        inside = float((hi - lo + 1).clamp_min(0).sum())
        covered = int((fb != cov._EMPTY).sum())
        return bound_ms(lo.numel() * OPS_ROW + inside * OPS_CANDIDATE
                        + covered * OPS_ACCEPTED[key],
                        recs.shape[0] * 128 + 2 * covered * 4)

    # the record sets (tools/kernel_times.record_sets): the 1080p static
    # scene, the three goldens, the orbit frames with huge records; each
    # set's route inputs (setup_t) and its span and huge records
    sets = kernel_times.record_sets(dev)
    fs1080 = sets["1080p static"]
    tm1080, g6 = fs1080["tm"], fs1080["span_recs"]
    n1080 = tm1080.shape[1]
    print("[3] record sets: " + "; ".join(
        f"{name} {fs['tm'].shape[1]} candidates, "
        f"{fs['span_recs'].shape[0]} span, {fs['huge_recs'].shape[0]} huge"
        for name, fs in sets.items()), flush=True)

    # K6: route and gather against its plain version (records and counts)
    def route_compare(name, tm, live, span):
        sk, hk, ck = cc.route_records_cuda(tm, live, span)
        sp, hp, cp = cc.route_records_plain(tm, live, span)
        ns, nh = (int(v) for v in cp.tolist())
        ok = (torch.equal(ck, cp) and same_bits(sk[:ns], sp)
              and same_bits(hk[:nh], hp))
        print(f"[3] K6 route + gather, {name}: {tm.shape[1]} candidates, "
              f"{ns} span, {nh} huge, counts {ck.tolist()}; records and "
              f"counts equal to plain: {ok}", flush=True)
        check(ok, f"K6 != plain on {name}")

    for name, fs in sets.items():
        route_compare(name, fs["tm"], fs["live"], fs["span"])
    live1080, span1080 = fs1080["live"], fs1080["span"]
    alive = tm1080.clone()
    alive[28] = torch.where(live1080, -1.0, 0.0)
    for name, args in (
            ("1080p, all dead", (tm1080, torch.zeros_like(live1080),
                                 span1080)),
            ("1080p, all huge (every span 17)",
             (tm1080, live1080, torch.full_like(span1080, 17))),
            ("1080p, all span (span 1, no far-straddler)",
             (alive, live1080, torch.ones_like(span1080))),
            ("1080p, every candidate live", (tm1080,
                                             torch.ones_like(live1080),
                                             span1080))):
        route_compare(name, *args)
    s_idx, h_idx = fs1080["span_idx"], fs1080["huge_idx"]
    sectors = kernel_times.gather_sectors(torch.cat([s_idx, h_idx]), n1080)
    n_live = s_idx.numel() + h_idx.numel()
    print(f"[3] K6's reads at 1080p: {n_live} live records touch {sectors} "
          f"distinct 32-byte sectors of tm (32 a record if none shared: "
          f"{32 * n_live}; {sectors * 32 / 1e6:.3f} MB of sectors for "
          f"{n_live * 128 / 1e6:.3f} MB of words)", flush=True)

    def composed_torch():
        # route + index_select + transpose: the composed torch sequence
        # (a reference for K6; no single library call routes and gathers)
        si, hi = cc.route(tm1080, live1080, span1080)
        return (tm1080.index_select(1, si).t().contiguous(),
                tm1080.index_select(1, hi).t().contiguous())

    cs, ch = composed_torch()
    check(torch.equal(cs, g6) and cs.shape[0] + ch.shape[0] == n_live,
          "composed torch route + index_select != K6's records")
    report["gather"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: cc.route_records_cuda(tm1080, live1080,
                                                 span1080)),
        plain_ms=time_ms(lambda: cc.route_records_plain(tm1080, live1080,
                                                        span1080)),
        library_ms=None,
        composed_ms=kernel_times.host_ms(composed_torch, REPS),
        host_ms=kernel_times.host_ms(lambda: cc.route_records_cuda(
            tm1080, live1080, span1080), REPS),
        # the route words read once, each live record read and written
        # once, the two counts written
        bound=bound_ms(*tool_common.route_work(n1080, n_live)),
        sectors=sectors)
    print(f"[3] K6 route + gather, 1080p: kernel {report['gather']['ms']:.3f} "
          f"ms (host clock with a synchronize "
          f"{report['gather']['host_ms']:.3f}), plain "
          f"{report['gather']['plain_ms']:.3f} ms, composed torch route + "
          f"index_select + transpose {report['gather']['composed_ms']:.3f} "
          f"ms (host clock), bound {report['gather']['bound'][0]:.5f} ms",
          flush=True)
    # K6 at config 3's flight (kernel_times.p64_route_inputs: 2,048 rows x
    # 8,712 candidates, 69,696 blocks), also with every candidate dead and
    # every candidate live, and its queued time against its bound
    p64 = kernel_times.p64_route_inputs(dev)
    route_compare("p64 flight", p64["tm"], p64["live"], p64["span"])
    for name, args in (
            ("p64 flight, all dead", (p64["tm"],
                                      torch.zeros_like(p64["live"]),
                                      p64["span"])),
            ("p64 flight, every candidate live",
             (p64["tm"], torch.ones_like(p64["live"]), p64["span"]))):
        route_compare(name, *args)
    report["gather"]["p64"] = dict(
        candidates=p64["tm"].shape[1], live=int(p64["live"].sum()),
        ms=time_ms(lambda: cc.route_records_cuda(p64["tm"], p64["live"],
                                                 p64["span"])),
        bound=kernel_times.route_bound(p64))
    print(f"[3] K6 route + gather, p64 flight: "
          f"{report['gather']['p64']['candidates']} candidates, "
          f"{report['gather']['p64']['live']} live, kernel "
          f"{report['gather']['p64']['ms']:.3f} ms, bound "
          f"{report['gather']['p64']['bound'][0]:.5f} ms "
          f"({report['gather']['p64']['bound'][1]})", flush=True)

    area = ((g6[:, 26] - g6[:, 24] + 1) * (g6[:, 27] - g6[:, 25] + 1)).cpu()
    area = area.numpy()
    q = np.quantile(area, [0.5, 0.9, 0.99])
    print(f"[3] 1080p span bbox area (px): n={area.size} p50={q[0]:g} "
          f"p90={q[1]:g} p99={q[2]:g} max={area.max():g} "
          f"share<=4px={float((area <= 4).mean()):.4f} "
          f"share<=16px={float((area <= 16).mean()):.4f} "
          f"total={float(area.sum()):g}", flush=True)

    # K2 and K3 on each set's records, then the main path's form: K6's
    # buffers with the counts on the device (raster_routed) against the
    # plain span and huge records, and the routed part under
    # set_sync_debug_mode("error"): no host read between setup and K3
    err2 = err3 = 0
    tri = kernel_times.screen_triangle_records(W_1080, H_1080, dev)
    huge_sets = {name: (fs["huge_recs"], fs["width"], fs["height"])
                 for name, fs in sets.items() if fs["huge_recs"].shape[0]}
    huge_sets["screen-filling triangle 1080p"] = (tri, W_1080, H_1080)
    for name, fs in sets.items():
        err2 = max(err2, records_compare(name, fs["span_recs"], fs["width"],
                                         fs["height"], "K2"))
    for name, (recs, w, h) in huge_sets.items():
        err3 = max(err3, records_compare(name, recs, w, h, "K3"))
    # records whose every fragment has a NaN shade (tests/torch_scenes):
    # K2, K3 and their plain versions pack each such shade as 0, as
    # planet_tpu converts NaN to int32
    nan_recs = nan_shade_records(**EDGE, device=dev)
    for key, plain in (("K2", cc.raster_span_plain),
                       ("K3", cc.raster_huge_plain)):
        records_compare("NaN-shade records", nan_recs, EDGE["width"],
                        EDGE["height"], key)
        fb = fresh_fb(EDGE["width"], EDGE["height"])()[0]
        keys = plain(nan_recs, fb)
        keys = keys[keys != cov._EMPTY]
        check(keys.numel() > 0 and not bool((keys & 1023).any()),
              f"{key}: NaN shades do not pack as 0")
    for name, fs in sets.items():
        w, h = fs["width"], fs["height"]
        routed_recs = fs["huge_recs"][fs["huge_idx"].numel():]

        def routed_kernel(fb, wf, fs=fs, routed_recs=routed_recs):
            cc.raster_routed(fs["tm"], fs["live"], fs["span"], fb, wf)
            if routed_recs.shape[0]:
                cc.raster_huge_cuda(routed_recs, fb, wf)

        def routed_plain(fb, wf, fs=fs):
            cc.raster_span_plain(fs["span_recs"], fb, wf)
            cc.raster_huge_plain(fs["huge_recs"], fb, wf)

        raster_compare(f"{name}, routed (K6 -> K2 -> K3, device counts)",
                       w, h, routed_kernel, routed_plain, "K6+K2+K3",
                       wireframe=False)
        fb = fresh_fb(w, h)()[0]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            counts = cc.raster_routed(fs["tm"], fs["live"], fs["span"], fb)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(counts.tolist() == [fs["span_idx"].numel(),
                                  fs["huge_idx"].numel()],
              f"raster_routed counts on {name}")
    print("[3] raster_routed (K6 -> K2 -> K3) ran under "
          "torch.cuda.set_sync_debug_mode('error') on every set: no host "
          "read between setup_t and K3's launch", flush=True)

    report["span"] = dict(
        max_abs_err=err2,
        ms=time_ms(lambda fb: cc.raster_span_cuda(g6, fb),
                   fresh_fb(W_1080, H_1080)),
        plain_ms=time_ms(lambda fb: cc.raster_span_plain(g6, fb),
                         fresh_fb(W_1080, H_1080)),
        bound=raster_bound("span", g6, W_1080, H_1080))
    huge_report = {}
    for name, (recs, w, h) in huge_sets.items():
        huge_report[name] = dict(
            records=recs.shape[0],
            ms=time_ms(lambda fb: cc.raster_huge_cuda(recs, fb),
                       fresh_fb(w, h)),
            plain_ms=time_ms(lambda fb: cc.raster_huge_plain(recs, fb),
                             fresh_fb(w, h)),
            bound=raster_bound("huge", recs, w, h))
        print(f"[3] K3 huge, {name}, {recs.shape[0]} records: kernel "
              f"{huge_report[name]['ms']:.3f} ms, plain "
              f"{huge_report[name]['plain_ms']:.3f} ms, bound "
              f"{huge_report[name]['bound'][0]:.5f} ms "
              f"({huge_report[name]['bound'][1]})", flush=True)
    check("golden nearclip" in huge_report and "golden farclip" in
          huge_report, "no huge-kernel records in the near/far-clip scenes")
    report["huge"] = dict(huge_report["golden nearclip"], max_abs_err=err3,
                          shape="golden nearclip 800x600")
    print(f"[3] K2 span kernel {report['span']['ms']:.3f} ms, plain "
          f"{report['span']['plain_ms']:.3f} ms (1080p); K3 huge kernel "
          f"{report['huge']['ms']:.3f} ms, plain "
          f"{report['huge']['plain_ms']:.3f} ms "
          f"({report['huge']['shape']})", flush=True)

    # C1, the triangle setup: against its plain version (setup_t and
    # straddle_mask_t) at the main path's shapes (kernel_times.
    # setup_inputs: DeviceRenderer's render_cap rows with the leaf count
    # on the device, PlanetEngine's leaves without one); bitwise in live,
    # span, the straddler mask and its block counts, and in every live
    # record column
    setups = kernel_times.setup_inputs(dev)
    straddlers = {}
    for name, args in setups.items():
        got, want = cc.setup_cuda(*args), cc.setup_plain(*args)
        cols = torch.nonzero(want[1]).squeeze(1)
        ok = (all(torch.equal(a, b) for a, b in zip(got[1:4], want[1:4]))
              and torch.equal(got[4], cc.straddle_blocks(want[3]))
              and same_bits(got[0][:, cols], want[0][:, cols]))
        rows = (args[0].shape[0] if args[7] is None else int(args[7][0]))
        g = args[0].shape[1]
        row = dict(
            max_abs_err=0.0 if ok else float("nan"),
            ms=time_ms(lambda: cc.setup_cuda(*args)),
            plain_ms=time_ms(lambda: cc.setup_plain(*args)),
            library_ms=None, candidates=int(want[1].numel()),
            live=int(cols.numel()), straddlers=int(want[3].sum()),
            bound=bound_ms(*tool_common.setup_work(
                rows, g, want[1].numel(), cols.numel())))
        print(f"[3] C1 setup, {name}: {row['candidates']} candidates on "
              f"{args[0].shape[0]} rows ({rows} live), {row['live']} live, "
              f"{row['straddlers']} straddlers; live, span, straddlers, "
              f"their {got[4].numel()} block counts and live records equal "
              f"to plain: {ok}; kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound'][0]:.5f} ms "
              f"({row['bound'][1]})", flush=True)
        check(ok, f"C1 != plain on {name}")
        straddlers[name] = row["straddlers"]
        if name == "1080p static, DeviceRenderer rows":
            report["setup"] = row
    check(any(straddlers.values()), "no C1 input set reaches the straddler "
          f"mask: {straddlers}")
    # C2, the clip pass, on each set's C1 outputs (kernel_times.
    # clip_inputs: the straddler mask and its block counts, clip_cap 512):
    # the slots' candidate indices, n_straddle, the live records (slot, A,
    # B order) and their count bitwise; the clip_cap straddlers' compaction
    # and the used slots' clip, each timed beside its bound
    clip_bounds = {}
    for name, args in kernel_times.clip_inputs(setups).items():
        plain_args = args[:3] + args[4:]     # the plain pass takes no blocks
        got, want = cc.clip_pass_cuda(*args), cc.clip_pass_plain(*plain_args)
        m = int(want[3][0])
        ok = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
              and torch.equal(got[3], want[3])
              and same_bits(got[2][:m], want[2]))
        slots, blocks = args[7], args[3]
        used = min(straddlers[name], slots)
        check(int(want[1]) == straddlers[name], f"C2 n_straddle on {name}")
        row = dict(
            max_abs_err=0.0 if ok else float("nan"),
            ms=time_ms(lambda: cc.clip_pass_cuda(*args)),
            plain_ms=time_ms(lambda: cc.clip_pass_plain(*plain_args)),
            library_ms=None, slots=slots, straddlers=used, live_records=m,
            bound=bound_ms(*tool_common.clip_work(
                blocks.numel(), slots, used, m, int((blocks > 0).sum()))))
        print(f"[3] C2 clip pass, {name}: {blocks.numel()} block counts, "
              f"{slots} slots, {used} straddlers, {m} live records; "
              f"indices, n_straddle, records and count equal to plain: "
              f"{ok}; kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound'][0]:.5f} ms "
              f"({row['bound'][1]})", flush=True)
        check(ok, f"C2 != plain on {name}")
        clip_bounds[name] = row["bound"]
        if name == "1080p static, DeviceRenderer rows":
            report["clip"] = row
    # V1, the vertex program and its shade: against its plain version
    # (vertex.tessellate_blend and the pinned lambert) at the main path's
    # shapes (kernel_times.tess_inputs: DeviceRenderer's 512 rows at 1080p
    # from the "uniforms" rung, as the fused step passes them; PlanetEngine's
    # leaves on the three goldens), every output bitwise (NaNs by their
    # bits: the padding rows)
    tess_sets = kernel_times.tess_inputs(dev)
    for name, args in tess_sets.items():
        got, got_shade = vertex_cuda.tessellate_shaded_cuda(*args)
        want, want_shade = vertex_cuda.tessellate_shaded_plain(*args)
        diff = [f for f in got._fields
                if not same_bits(getattr(got, f), getattr(want, f))]
        if not same_bits(got_shade, want_shade):
            diff.append("vertex_shade")
        rows, grid = args[2].shape[0], got.clip.shape[1]
        live_rows = tool_common.tess_live(args[1])
        live = int(live_rows.sum())
        slerps = tool_common.tess_slerps(args[1], grid)
        row = dict(
            max_abs_err=0.0 if not diff else float("nan"),
            ms=time_ms(lambda: vertex_cuda.tessellate_shaded_cuda(*args)),
            plain_ms=time_ms(
                lambda: vertex_cuda.tessellate_shaded_plain(*args)),
            library_ms=None, rows=rows, live_rows=live, slerps=slerps,
            bound=bound_ms(*tool_common.tess_work(rows, grid, slerps,
                                                  live=live)))
        equal = "True" if not diff else f"False ({', '.join(diff)} differ)"
        print(f"[3] V1 tess, {name}: {rows} rows x {grid}x{grid} "
              f"vertices, {live} evaluated, {slerps} slerp interpolations; "
              f"clip, world, normal, height, snormal and shade bitwise "
              f"equal to plain: {equal}; kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound'][0]:.5f} ms "
              f"({row['bound'][1]})", flush=True)
        check(not diff, f"V1 != plain on {name}: {diff}")
        if name == "1080p static, DeviceRenderer rows":
            report["tess"] = row
            words = [t[~live_rows].reshape(-1).view(torch.int32) for t in (
                want.clip, want.world, want.normal, want.snormal,
                want_shade)]
            check(live < rows and all(bool((w == 0x7FFFFFFF).all())
                                      for w in words),
                  "V1's padding rows: torch's NaN word on the card is not "
                  "0x7fffffff")
            print(f"[3] V1: the plain version's padding rows ({rows - live}) "
                  "hold the NaN word 0x7fffffff that the kernel writes from "
                  "a constant", flush=True)

    # A1, the cache stage and generate's prologue, and U1, the uniforms:
    # against their plain versions at the main path's shapes
    # (kernel_times.stage_inputs: DeviceRenderer's step at 1080p run
    # eagerly, each call recorded with its pool: the static camera's first
    # two frames, the orbit's first four), every output and the pool's
    # keys and ticks bitwise, A1 with and without its touch; a padding
    # row's normals hold the NaN word 0x7fffffff in both
    stage_sets = kernel_times.stage_inputs(dev)

    def fresh(pool):
        return (device_pool.PoolState(*(t.clone() for t in pool)),)

    for name, (pool, args, kw) in stage_sets[0].items():
        diff = []
        for touch in (False, True):
            k_pool, p_pool = fresh(pool)[0], fresh(pool)[0]
            got = device_pool_cuda.cache_stage_cuda(
                k_pool, *args, **dict(kw, touch=touch))
            want = device_pool_cuda.cache_stage_plain(
                p_pool, *args, **dict(kw, touch=touch))
            diff += [f"{f} (touch {touch})" for f in got._fields
                     if not same_bits(getattr(got, f), getattr(want, f))]
            diff += [f"pool {f} (touch {touch})"
                     for f in ("keys_lo", "keys_hi", "tick")
                     if not same_bits(getattr(k_pool, f)[:pool.capacity],
                                      getattr(p_pool, f)[:pool.capacity])]
        rows, live = args[0].shape[0], int(args[5])
        generated = int(want.n_generated)
        row = dict(
            max_abs_err=0.0 if not diff else float("nan"),
            ms=time_ms(lambda p: device_pool_cuda.cache_stage_cuda(
                p, *args, **kw), lambda: fresh(pool)),
            plain_ms=time_ms(lambda p: device_pool_cuda.cache_stage_plain(
                p, *args, **kw), lambda: fresh(pool)),
            library_ms=None, rows=rows, live=live, generated=generated,
            bound=bound_ms(*tool_common.cache_work(
                rows, pool.capacity, live, generated, kw["gen_cap"])))
        print(f"[3] A1 cache, {name}: {rows} rows ({live} live), capacity "
              f"{pool.capacity}, {generated} generated, crops "
              f"{int(want.crop.sum())}; every output and the pool's keys "
              f"and ticks bitwise equal to plain (with and without the "
              f"touch): {not diff}; kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound'][0]:.6f} ms "
              f"({row['bound'][1]})", flush=True)
        check(not diff, f"A1 != plain on {name}: {diff}")
        if name == kernel_times.STAGE_MAIN:
            report["cache"] = row
    for name, rargs in stage_sets[1].items():
        args = rargs[:9]
        got = uniforms_cuda.uniforms_cuda(*args)
        want = uniforms_cuda.uniforms_plain(*args)
        diff = [f for f in got._fields
                if not same_bits(getattr(got, f), getattr(want, f))]
        rows = args[0].shape[0]
        live = int(torch.isfinite(want.normals).all(dim=(1, 2)).sum())
        pad = got.normals[live:].reshape(-1).view(torch.int32)
        row = dict(
            max_abs_err=0.0 if not diff else float("nan"),
            ms=time_ms(lambda: uniforms_cuda.uniforms_cuda(*args)),
            plain_ms=time_ms(lambda: uniforms_cuda.uniforms_plain(*args)),
            library_ms=None, rows=rows,
            bound=bound_ms(*tool_common.uniforms_work(rows)))
        print(f"[3] U1 uniforms, {name}: {rows} rows ({live} live); vx, vy, "
              f"corners_rel, normals and skirt bitwise equal to plain: "
              f"{not diff}, the padding rows' normals 0x7fffffff: "
              f"{bool((pad == 0x7FFFFFFF).all())}; kernel {row['ms']:.4f} "
              f"ms, plain {row['plain_ms']:.3f} ms, bound "
              f"{row['bound'][0]:.6f} ms ({row['bound'][1]})", flush=True)
        check(not diff, f"U1 != plain on {name}: {diff}")
        check(bool((pad == 0x7FFFFFFF).all()),
              f"U1 on {name}: a padding row's normal is not 0x7fffffff")
        if name == kernel_times.STAGE_MAIN:
            report["uniforms"] = row
    # V1 in its rows mode, the fused step's tessellate stage: the uniforms
    # computed in V1's own staging from the rows' words and DF corners, on
    # the same frames' rows (the step's tessellate_rows calls), every
    # output bitwise equal to its plain version (U1's, then V1's) and to
    # V1 on U1's outputs on the card ("U1 + V1", the stage before the
    # rows mode); the padding rows' five NaN outputs the word 0x7fffffff
    for name, args in stage_sets[1].items():
        got, got_shade = vertex_cuda.tessellate_rows_cuda(*args)
        diff = []
        for tag, (want, want_shade) in (
                ("plain", vertex_cuda.tessellate_rows_plain(*args)),
                ("U1 + V1", kernel_times.u1_then_v1(args))):
            diff += [f"{f} ({tag})" for f in got._fields
                     if not same_bits(getattr(got, f), getattr(want, f))]
            if not same_bits(got_shade, want_shade):
                diff.append(f"vertex_shade ({tag})")
        rows, grid = args[0].shape[0], args[11]
        normals = uniforms_cuda.uniforms_cuda(*args[:9]).normals
        live_rows = tool_common.tess_live(normals)
        live = int(live_rows.sum())
        slerps = tool_common.tess_slerps(normals, grid)
        pad_nan = all(bool((t[~live_rows].reshape(-1).view(torch.int32)
                            == 0x7FFFFFFF).all()) for t in (
            got.clip, got.world, got.normal, got.snormal, got_shade))
        row = dict(
            max_abs_err=0.0 if not diff else float("nan"),
            ms=time_ms(lambda: vertex_cuda.tessellate_rows_cuda(*args)),
            pair_ms=time_ms(lambda: kernel_times.u1_then_v1(args)),
            plain_ms=time_ms(lambda: vertex_cuda.tessellate_rows_plain(
                *args)),
            rows=rows, live_rows=live, slerps=slerps,
            bound=bound_ms(*tool_common.tess_rows_work(rows, grid, slerps,
                                                       live=live)))
        print(f"[3] V1 rows, {name}: {rows} rows x {grid}x{grid} vertices, "
              f"{live} evaluated, {slerps} slerp interpolations; every "
              f"output bitwise equal to plain and to V1 on U1's outputs: "
              f"{not diff}, the padding rows' NaN words 0x7fffffff: "
              f"{pad_nan}; kernel {row['ms']:.4f} ms, U1 + V1 "
              f"{row['pair_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound'][0]:.5f} ms ({row['bound'][1]})",
              flush=True)
        check(not diff, f"V1 rows on {name}: {diff} differ")
        check(live < rows and pad_nan, f"V1 rows on {name}: a padding "
              "row's output is not the NaN word 0x7fffffff")
        if name == kernel_times.ROWS_MAIN:
            report["tess"]["rows_mode"] = dict(row, frame=name)

    # ------------------------------------------------------------ phase 4
    def check_golden(tag, name, n_leaves, image, depth, rc):
        """The golden-scene bars (tests/test_golden_*.py)."""
        image, depth = image.cpu().numpy(), depth.cpu().numpy()
        n_leaves, rc = int(n_leaves), counter_values(rc)
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
              f"triangles {int(eng.last_counters.n_tris)}, tiles generated "
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
              f"triangles {int(eng.last_counters.n_tris)}, huge "
              f"{int(eng.last_counters.n_huge)}; frame "
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
        want = step(pool_e, *(torch.as_tensor(a, device=dev) for a in gargs),
                    *device_step.face_roots(cfg800.radius, dev))
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
    r1_events = sum(e.count for e in events if "level_kernel" in e.key)
    print(f"[5a] profiler, one replay: {sum(e.count for e in events)} device "
          f"events, {len(events)} distinct, {busy_us / 1e3:.3f} ms device "
          f"time; K1 {'tiles_kernel' in names}, R1 {r1_events} kernels "
          f"(level_kernel), K4 {'noise_kernel' in names}", flush=True)
    for e in sorted(events, key=lambda e: -e.device_time_total)[:6]:
        print(f"[5a]   {e.device_time_total / 1e3:8.3f} ms x{e.count:5d}  "
              f"{e.key[:90]}", flush=True)
    check("tiles_kernel" in names and r1_events == cfg800.max_lod + 1,
          f"the profiled replay shows no K1, or R1 not one kernel a level "
          f"({r1_events})")
    check("noise_kernel" not in names, "the profiled replay launched K4")
    check(rend._tally["refine"] == cfg800.max_lod + 1
          and rend._tally["noise"] == 0,
          f"the replay's launches {rend._tally}: R1 not one a level, or K4")
    del rend, step, pool_g, pool_e, got, want

    # ----------------------------------------------------------- phase 5b
    _cuda.reset_launches()

    def converge(rend, pool, cam, width, height, tag):
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fr = rend.render(pool, *device_args(rend.cfg, cam, width, height))
            torch.cuda.synchronize()
            print(f"[5b] {tag} frame {i}: leaves {int(fr.n_leaves)}, tiles "
                  f"generated {int(fr.n_generated)}, overflowed "
                  f"{bool(fr.overflowed)}; "
                  f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
            if int(fr.n_generated) == 0:
                return fr
        raise SmokeFailure(f"{tag}: still generating after 4 frames")

    rend = device_step.DeviceRenderer(cfg800, 800, 600, device=dev)
    for name in ("frame", "nearclip", "farclip"):
        fr = converge(rend, rend.init_pool(), scene_cam(name), 800, 600, name)
        check(not fr.overflowed, f"5b {name}: overflowed")
        check_golden("5b", name, fr.n_leaves, fr.image, fr.depth,
                     rend.last_counters)
    renderers = [rend]

    rend = device_step.DeviceRenderer(cfg1080, W_1080, H_1080, device=dev)
    renderers.append(rend)
    pool = rend.init_pool()
    static_args = device_args(cfg1080, bench_cam(), W_1080, H_1080)
    static_ms = []
    for i in range(10):
        if i == 9:      # phase 11 renders this frame again from this state
            static_pool = [t.clone() for t in pool]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = rend.render(pool, *static_args)
        torch.cuda.synchronize()
        static_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(fr.image).all()), "5b 1080p not finite")
        check(not fr.overflowed, "5b 1080p static: overflowed")
        print(f"[5b] 1080p static frame {i}: leaves {int(fr.n_leaves)}, "
              f"tiles generated {int(fr.n_generated)}, live triangles "
              f"{int(rend.last_counters.n_tris)}; frame "
              f"{static_ms[-1]:.3f} ms", flush=True)
    print(f"[5b] 1080p static: median of frames 2-9 "
          f"{float(np.median(static_ms[2:])):.3f} ms", flush=True)
    # the frame's buffers are the raster graph's: the next render writes
    # them, so phase 11 gets a copy
    static_frame = fr._replace(**{k: v.clone() for k, v in
                                  fr._asdict().items() if v is not None})
    static_ids = set(int(q) for q in quadid.from_words(
        rend.last_geometry.leaf_lo[:fr.n_leaves].cpu().numpy(),
        rend.last_geometry.leaf_hi[:fr.n_leaves].cpu().numpy()))
    # a whole warm frame (both graphs, the camera's upload, the launch
    # tallies) with no host synchronisation: torch raises on one
    pool_sync = [t.clone() for t in pool]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fr = rend.render(pool, *static_args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(same_bits(fr.image, static_frame.image)
          and same_bits(fr.depth, static_frame.depth),
          "5b: the frame under set_sync_debug_mode('error') != the last "
          "static frame")
    for t, v in zip(pool, pool_sync):
        t.copy_(v)
    print("[5b] 1080p static: a warm render() (geometry graph, raster graph "
          f"{rend.graph_launches}) ran under "
          "torch.cuda.set_sync_debug_mode('error') and equals the last "
          "static frame bit for bit", flush=True)
    # where a warm fused frame's time goes: the geometry graph replay
    # (inputs copied in, replay, synchronize), then the raster graph's
    split = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rend.geometry(pool, *static_args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rend.rasterize()
        torch.cuda.synchronize()
        split.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    print("[5b] 1080p static, geometry replay / raster replay ms: "
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
              f"{int(fr.n_leaves)} (PlanetEngine {len(orbit_ids[i])}, ids "
              f"{'equal' if same else 'DIFFER'}), tiles generated "
              f"{int(fr.n_generated)}, overflowed {bool(fr.overflowed)}; "
              "frame "
              f"{ms:.3f} ms", flush=True)
        check(bool(torch.isfinite(fr.image).all()), f"5b orbit {i}: finite")
        check(same, f"5b orbit frame {i}: leaf ids differ from PlanetEngine")
    launches_dev = dict(_cuda.launches)
    # V1 (in its rows mode) and A1 once a geometry replay, U1 never (V1
    # computes the uniforms in its own staging): each capture's eager
    # warm-up launches V1 and A1 once more
    replays = sum(r.geometry_replays for r in renderers)
    captures = sum(r.geometry_captures for r in renderers)
    print(f"[5b] V1 launches {launches_dev['tess']}: {replays} geometry "
          f"replays, {captures} captures (each with one eager warm-up); "
          f"a replay's graph launches "
          f"{[r._tally['tess'] for r in renderers]}", flush=True)
    for k, tag in (("tess", "V1"), ("cache", "A1")):
        check(all(r._tally[k] == 1 for r in renderers)
              and launches_dev[k] == replays + captures,
              f"5b: {tag} not launched once a geometry replay")
    check(all(r._tally["uniforms"] == 0 for r in renderers)
          and launches_dev["uniforms"] == 0,
          f"5b: U1 launched {launches_dev['uniforms']} times by the fused "
          "frame (none expected: V1's rows mode computes the uniforms)")
    print(f"[5b] A1 launches {launches_dev['cache']}: once a geometry "
          f"replay and capture; U1 launches {launches_dev['uniforms']}",
          flush=True)
    # BASELINE config 3: 64-vertex patches over 66 x 66 tiles, the
    # benchmark's configuration, on the flight's cameras
    conf64 = json.loads((ROOT / "perfbench/configs/lod-1080p-p64.json")
                        .read_text())
    cfg64 = EngineConfig(**{k: v for k, v in conf64["settings"].items()
                            if k in EngineConfig.__dataclass_fields__})
    from perfbench.harness import traffic as traffic_mod
    flight = traffic_mod.make(json.loads(
        (ROOT / "perfbench/traffic/flight.json").read_text()), 0, cfg64.radius)
    before = dict(_cuda.launches)
    rend64 = device_step.DeviceRenderer(
        cfg64, W_1080, H_1080, device=dev,
        **{k: v for k, v in conf64["engine"].items() if k != "preview"})
    pool64 = rend64.init_pool()
    for k in (0, 24, 48, 72):
        pos, ang = flight.at(k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = rend64.render(pool64, *device_args(
            cfg64, cam_mod.Camera(position=pos, angles=ang), W_1080, H_1080))
        torch.cuda.synchronize()
        print(f"[5b] config 3 (64-vertex patches) flight frame {k}: leaves "
              f"{int(fr.n_leaves)}, tiles generated {int(fr.n_generated)}, "
              f"live triangles {int(rend64.last_counters.n_tris)}, "
              f"overflowed {bool(fr.overflowed)}; "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
        check(not fr.overflowed, f"5b config 3 frame {k}: overflowed")
        check(bool(torch.isfinite(fr.image).all()),
              f"5b config 3 frame {k}: not finite")
    wide = {k: _cuda.launches[k] - before[k] for k in ("tess", "tess_wide")}
    check(rend64._tally["tess_wide"] == 1 and rend64._tally["tess"] == 0
          and wide["tess"] == 0 and wide["tess_wide"]
          == rend64.geometry_replays + rend64.geometry_captures,
          f"5b: config 3's V1 launches {wide}, not V1's wide instance once "
          "a geometry replay")
    print(f"[5b] config 3: V1's wide instance launched {wide['tess_wide']} "
          f"times ({rend64.geometry_replays} replays, "
          f"{rend64.geometry_captures} captures), its narrow ones "
          f"{wide['tess']}", flush=True)
    # V1's wide instance queued, on the rows the last camera's step passes
    # it (the step run eagerly from a copy of the pool), beside its bound
    rows64 = []
    real_rows = vertex_cuda.tessellate_rows

    def record_rows(*a, **kw):
        rows64.append(a + (kw["grid"],))
        return real_rows(*a, **kw)

    vertex_cuda.tessellate_rows = record_rows
    try:
        device_step.build_geometry_step(
            cfg64, device=dev,
            **{k: v for k, v in conf64["engine"].items() if k != "preview"})(
            device_step.dp.PoolState(*(t.clone() for t in pool64)),
            *(torch.as_tensor(a, device=dev) for a in device_args(
                cfg64, cam_mod.Camera(position=pos, angles=ang), W_1080,
                H_1080)), *device_step.face_roots(cfg64.radius, dev))
    finally:
        vertex_cuda.tessellate_rows = real_rows
    args64 = rows64[0]
    normals64 = uniforms_cuda.uniforms_cuda(*args64[:9]).normals
    live64 = int(tool_common.tess_live(normals64).sum())
    bound64, by64 = tool_common.bound_ms(*tool_common.tess_rows_work(
        args64[0].shape[0], 66, tool_common.tess_slerps(normals64, 66), 66,
        live64))
    ms64 = tool_common.time_calls(
        lambda: vertex_cuda.tessellate_rows_cuda(*args64))
    pv64, shade64 = vertex_cuda.tessellate_rows_cuda(*args64)
    want64 = vertex_cuda.tessellate_rows_plain(*args64)
    check(all(same_bits(a, b) for a, b in zip(pv64, want64[0]))
          and same_bits(shade64, want64[1]),
          "5b config 3: V1's wide instance != its plain version")
    print(f"[5b] config 3: V1's wide instance queued ms "
          f"{', '.join(f'{t:.4f}' for t in ms64)} (median "
          f"{float(np.median(ms64)):.4f}) on {args64[0].shape[0]} rows, "
          f"{live64} live; bound {bound64:.4f} ms ({by64}); bitwise its "
          "plain version", flush=True)
    del rend64, pool64

    # ------------------------------------------------------------ phase 6
    check("jax" not in sys.modules, "jax was imported")
    print(f"[6] launches, host-orchestrated path (phases 4-5): "
          f"{launches_host}", flush=True)
    print(f"[6] launches, fused device path (phase 5b): {launches_dev}",
          flush=True)
    for k in ("tile", "tess", "gather", "span", "huge"):
        check(launches_host[k] > 0, f"kernel {k} was not launched by the "
              "host-orchestrated path")
    for k in ("tile", "refine", "cache", "tess", "setup", "gather", "span",
              "clip", "huge"):
        check(launches_dev[k] > 0, f"kernel {k} was not launched by the "
              "fused device path")
    check(launches_dev["noise"] == 0, "the fused device path launched K4 "
          "(its probes run inside R1)")

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
        ops5, f64_5 = tool_common.noise_work(6)
        report["field"] = dict(ms=ms, plain_ms=plain_ms, bound=bound_ms(
            texels * (OPS_FIELD_TEXEL + ops5), texels * 8, texels * f64_5))
        print(f"[7b] K5 field 6x{n}^2: bitwise equal to plain; composed "
              f"frame within {eh:.4g} m / {es:.3g}; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, composed frame {comp_ms:.3f} ms, "
              f"bound {report['field']['bound'][0]:.4f} ms "
              f"({report['field']['bound'][1]})", flush=True)
    report["field"]["max_abs_err"] = field_err
    del h2, s2

    # ------------------------------------------------------------ phase 8
    # the kernel-attribution tools, their counts from 0
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
          "torch.take " + ", ".join(
              f"{r['library_ms']:.4f} ms ({r['name']})"
              for r in res_lut["rows"] if "library_ms" in r)
          + "; span full 14x8, "
          f"{res_span['headline']['records']} records: "
          f"{res_span['headline']['ms']:.4f} ms, plain "
          f"{res_span['headline']['plain_ms']:.4f} ms", flush=True)
    del coords, k4, ch, cl, k1
    # K2's first-port body and its parts on the scene's own span records
    for r in span_parts.bench_given(g6, W_1080, H_1080, reps=REPS):
        print(f"[8] t_span {r['name']:24s} {r['ms']:9.4f} ms  "
              f"{r['rate']:9.3f} ns/record  bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]})  equal to plain {r['equal']}", flush=True)
        check(r["equal"], f"t_span {r['name']} != its plain version")
    # the main path's kernels at their phase-3 shapes again, queued behind
    # a spin kernel (tools/common.time_calls): phase 3 times one launch
    # between two events, which for a short kernel also holds the host's
    # launch time. The calls are tools/kernel_times', which times the same
    # set on any tree of the port; here on the record sets and fused
    # inputs phase 3 compared (K2 and K3 as the main path draws them: K2
    # on K6's buffer with the count on the device).
    queued, huge_queued, by_label = {}, {}, {}
    for key, label, fn, setup in kernel_times.calls(dev, sets=sets,
                                                    fused=fused,
                                                    setups=setups,
                                                    tess=tess_sets,
                                                    stages=stage_sets,
                                                    p64=p64):
        ms = tool_common.time_ms(fn, setup, reps=REPS)
        by_label[label] = ms
        if key:
            queued[key] = ms
        if label.startswith("K3 huge, "):
            huge_queued[label[len("K3 huge, "):].rsplit(", ", 1)[0]] = ms
        print(f"[8] queued timing, {label}: {ms:.4f} ms (median of {REPS}; "
              f"phase 3/7b's single-launch timing is in the kernels line)",
              flush=True)
    # R1's bound counts its work; its time is the chain of live levels
    report["refine"]["ms_per_live_level"] = queued["refine"] / r1_live
    print(f"[8] R1 refine, 1080p static: {queued['refine']:.4f} ms queued "
          f"over {r1_live} live levels of {cfg1080.max_lod + 1}: "
          f"{report['refine']['ms_per_live_level'] * 1e3:.2f} us a live "
          f"level (bound {report['refine']['bound'][0]:.5f} ms for the "
          "whole refine)", flush=True)
    # the clip pass (C2 with its compaction, then K3 on its count) on each
    # C1 set, queued, beside C2's bound; at 0 straddlers K3 leaves at once
    for name in setups:
        c2, k3, whole = (by_label[f"{part}, {name}"] for part in (
            "C2 clip", "K3 clip pass", "clip pass"))
        print(f"[8] clip pass, {name}: {straddlers[name]} straddlers; C2 "
              f"{c2:.4f} ms + K3 {k3:.4f} ms queued, the pass {whole:.4f} "
              f"ms queued; C2's bound {clip_bounds[name][0]:.5f} ms "
              f"({clip_bounds[name][1]})", flush=True)
    main_set = "1080p static, DeviceRenderer rows"
    report["clip"].update(
        queued_k3_ms=by_label[f"K3 clip pass, {main_set}"],
        queued_pass_ms=by_label[f"clip pass, {main_set}"])
    n_live = report["tess"]["live_rows"]
    print(f"[8] V1 tess, {main_set}: {queued['tess']:.4f} ms queued "
          f"({n_live} of {report['tess']['rows']} rows evaluated, the rest "
          f"padding: NaN corner normals); every row padding "
          f"{by_label['V1 probe, every row padding']:.4f} ms, the {n_live} "
          f"live rows alone "
          f"{by_label[f'V1 probe, the {n_live} live rows alone']:.4f} ms; "
          f"bound {report['tess']['bound'][0]:.5f} ms "
          f"({report['tess']['bound'][1]})", flush=True)
    # A1's and U1's plain versions (the composed torch ops the stages were
    # before them) queued the same way: their "library" yardstick, as no
    # single PyTorch call computes either
    pool, args, kw = stage_sets[0][kernel_times.STAGE_MAIN]
    uargs = stage_sets[1][kernel_times.STAGE_MAIN][:9]
    report["cache"]["composed_ms"] = tool_common.time_ms(
        lambda p: device_pool_cuda.cache_stage_plain(p, *args, **kw),
        lambda: fresh(pool), reps=REPS)
    report["uniforms"]["composed_ms"] = tool_common.time_ms(
        lambda: uniforms_cuda.uniforms_plain(*uargs), reps=REPS)
    for k, tag in (("cache", "A1"), ("uniforms", "U1")):
        print(f"[8] {tag} {k}, {kernel_times.STAGE_MAIN}: {queued[k]:.4f} ms "
              f"queued, its composed torch ops {report[k]['composed_ms']:.4f}"
              f" ms queued; bound {report[k]['bound'][0]:.6f} ms "
              f"({report[k]['bound'][1]})", flush=True)
    # the tessellate stage on each stage frame: V1's rows mode against U1
    # then V1 on its outputs, queued
    rows_main = report["tess"]["rows_mode"]
    rows_main.update(queued_ms=queued["tess_rows"],
                     pair_queued_ms=queued["tess_pair"])
    for name in stage_sets[1]:
        print(f"[8] tessellate stage, {name}: V1 rows "
              f"{by_label[f'V1 rows, {name}']:.4f} ms queued, U1 + V1 "
              f"{by_label[f'U1 + V1, {name}']:.4f} ms queued", flush=True)
    for label, fn in kernel_times.host_calls(sets):
        print(f"[8] host clock, {label}: "
              f"{kernel_times.host_ms(fn, REPS):.4f} ms", flush=True)
    for name, row in report["huge"].setdefault("sets", huge_report).items():
        row["queued_ms"] = huge_queued[name]
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

    # ------------------------------------------------------------ phase 9
    t9 = time.perf_counter()
    rest = single_card_rest(dev, W_1080, H_1080, camera=bench_cam(),
                            orbit=list(orbit_cams()), orbit_ids=orbit_ids,
                            log=lambda m: print(m, flush=True),
                            event_ms=time_ms, bound=bound_ms)
    report["splat"] = rest.pop("splat")
    report["splat"]["device_rows"] = {
        k: v for k, v in rest.pop("splat_device_rows").items()
        if k != "max_abs_err"}
    print(f"[9] the single-card rest in {time.perf_counter() - t9:.1f} s: "
          + json.dumps(rest), flush=True)

    # ----------------------------------------------------------- phase 10
    t10 = time.perf_counter()
    _cuda.reset_launches()
    shard = sharded_paths(
        dev, W_1080, H_1080,
        camera_args=device_args(cfg1080, bench_cam(), W_1080, H_1080),
        static_ids=static_ids, field_n=FIELD_N["config2"],
        config5_n=FIELD_N["config5"], log=lambda m: print(m, flush=True))
    launches_sharded = dict(_cuda.launches)
    print(f"[10] launches, sharded paths (phase 10, this process): "
          f"{launches_sharded}", flush=True)
    for k in ("tile", "span", "gather", "noise", "field", "refine", "tess"):
        check(launches_sharded[k] > 0, f"phase 10 launched no {k} kernel")
    shard["huge_launches"] = launches_sharded["huge"]
    print(f"[10] the multi-card slice on one card in "
          f"{time.perf_counter() - t10:.1f} s: " + json.dumps(shard),
          flush=True)

    # ----------------------------------------------------------- phase 11
    t11 = time.perf_counter()
    _cuda.reset_launches()
    ladder = stage_ladder(
        dev, W_1080, H_1080,
        camera_args=device_args(cfg1080, bench_cam(), W_1080, H_1080),
        static_pool=static_pool, static_frame=static_frame,
        orbit_leaves=[len(ids) for ids in orbit_ids],
        log=lambda m: print(m, flush=True))
    launches_ladder = dict(_cuda.launches)
    print(f"[11] launches, stage rungs and the dryrun's reference (phase "
          f"11, this process): {launches_ladder}", flush=True)
    for k in ("tile", "refine", "tess", "uniforms", "gather", "span"):
        check(launches_ladder[k] > 0, f"phase 11 launched no {k} kernel")
    print(f"[11] the stage ladder and dryrun_multichip in "
          f"{time.perf_counter() - t11:.1f} s: " + json.dumps(ladder),
          flush=True)

    check(not any(m == "jax" or m.startswith(("jax.", "planet_tpu."))
                  or m == "planet_tpu" for m in sys.modules),
          "jax or planet_tpu was imported")
    launches = dict(launches_dev, field=launches_field["field"],
                    noise=launches_field["noise"],
                    uniforms=launches_ladder["uniforms"],
                    splat=rest["splat_launches"],
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
        # no Pallas kernel: planet_tpu's jitted device refine, with K4 at
        # its probes
        "refine": ("planet_tpu_torch/csrc/refine.cu",
                   "planet_tpu/lod/refine_device.py:153, "
                   "planet_tpu/ops/kernels/perlin_pallas.py:370"),
        # no Pallas kernel: planet_tpu's XLA splat (upsample, pack, scatter)
        "splat": ("planet_tpu_torch/csrc/splat.cu",
                  "planet_tpu/raster/splat.py:30"),
        # no Pallas kernel: planet_tpu's XLA triangle setup and straddler
        # mask
        "setup": ("planet_tpu_torch/csrc/setup.cu",
                  "planet_tpu/raster/coverage.py:428, "
                  "planet_tpu/raster/nearclip.py:94"),
        # no Pallas kernel: planet_tpu's XLA clip pass
        "clip": ("planet_tpu_torch/csrc/setup.cu",
                 "planet_tpu/raster/coverage.py:840, "
                 "planet_tpu/raster/nearclip.py:292"),
        # no Pallas kernel: planet_tpu's vertex program and shade, fused by
        # XLA in its geometry step
        "tess": ("planet_tpu_torch/csrc/tess.cu",
                 "planet_tpu/tess/vertex.py:148, "
                 "planet_tpu/tess/vertex.py:232, "
                 "planet_tpu/raster/shade.py:18"),
        # no Pallas kernel: planet_tpu's cache stage and the prologue of
        # its generation, XLA fusions of its geometry step
        "cache": ("planet_tpu_torch/csrc/cache.cu",
                  "planet_tpu/engine/device_step.py:164, "
                  "planet_tpu/cache/device_pool.py:52"),
        # no Pallas kernel: planet_tpu's uniforms, an XLA fusion of its
        # geometry step
        "uniforms": ("planet_tpu_torch/csrc/uniforms.cu",
                     "planet_tpu/engine/device_step.py:242"),
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
            bound_ms=report[k]["bound"][0],
            bound_by=("bytes" if report[k]["bound"][1] == "bytes"
                      else "operations"),
            library_ms=report[k].get("library_ms")))
        if k in queued:
            kernels[-1]["queued_ms"] = queued[k]
        if k == "splat":
            kernels[-1].update(queued_ms=report[k]["queued_ms"],
                               fragments=report[k]["fragments"],
                               device_rows=report[k]["device_rows"])
        if k == "tile":
            kernels[-1]["queued_fused_ms"] = queued["tile_fused"]
        if k == "refine":
            kernels[-1]["ms_per_live_level"] = report[k]["ms_per_live_level"]
        if k == "clip":
            kernels[-1].update(queued_k3_ms=report[k]["queued_k3_ms"],
                               queued_pass_ms=report[k]["queued_pass_ms"])
        if k in ("cache", "uniforms"):
            kernels[-1]["composed_ms"] = report[k]["composed_ms"]
        if k == "tess":
            r = report[k]["rows_mode"]
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                             r["max_abs_err"])
            kernels[-1]["rows_mode"] = dict(
                frame=r["frame"], max_abs_err=r["max_abs_err"], ms=r["ms"],
                queued_ms=r["queued_ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound"][0], bound_by=r["bound"][1],
                pair_ms=r["pair_ms"], pair_queued_ms=r["pair_queued_ms"])
        if k == "gather":
            p64 = report[k]["p64"]
            kernels[-1].update(composed_ms=report[k]["composed_ms"],
                               host_ms=report[k]["host_ms"],
                               sectors=report[k]["sectors"],
                               p64=dict(candidates=p64["candidates"],
                                        live=p64["live"], ms=p64["ms"],
                                        queued_ms=by_label[
                                            kernel_times.ROUTE_P64],
                                        bound_ms=p64["bound"][0]))
        if k == "huge":
            kernels[-1]["sets"] = {
                name: dict(records=r["records"], ms=r["ms"],
                           queued_ms=r["queued_ms"],
                           plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                           bound_by=r["bound"][1])
                for name, r in report["huge"]["sets"].items()}
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
