"""K2's per-record cost, split (T8-T11).

    python -m planet_tpu_torch.tools.span_parts               # on the card
    python -m planet_tpu_torch.tools.span_parts --device cpu --small
    python -m planet_tpu_torch.tools.span_parts --scene      # given records
    python -m planet_tpu_torch.tools.span_parts --sweep      # K2's grid cap

The port's counterpart of planet_tpu's span microbenchmarks in tools/:
microbench_span2.py and microbench_span3.py (T8, T9: record bodies and
TRI_BLOCK, timed by slope; microbench_span4.py and microbench_span5.py
drive the same kernel) and proto_bv.py / proto_bv2.py (T10, T11: the
block-vectorized span kernel). Each variant is a kernel of
csrc/bench_span.cu with a plain PyTorch version here that it equals bit for
bit:

* per-record bodies, the first port's K2 (one warp per record, every bbox
  pixel a candidate; K2 now visits only each row's exact interval,
  csrc/raster.cu): full (K2's
  fragment; its plain version is coverage_cuda.raster_span_plain),
  noshade, fewscalar, rmw_only, empty, static_rmw, and full with 2, 4 or 8
  records a warp (TRI_BLOCK's counterpart);
* block-vectorized (bv_*): R = 8 or 32 records a block, one thread per
  (record, pixel) of each record's aligned (winh, 128) window, the window
  origin from the record, from a side (m, 2) int32 array or static, with
  or without the bbox test (`noin`).

Records are the port's own (coverage.setup_t's layout, absolute bbox),
made by `make_records` with the port's record math (nearclip.setup_tris:
projection, 1/16 snap, bbox; nearclip.records_from_tris: edge constants,
inv_area-folded coefficients) from live, front-facing triangles in the
tools' geometry (proto_bv.make_live_records: a bw x winh triangle inside
one aligned 8-row, 128-column window, seeded). Times are slopes, as
microbench_span3 took them: the marginal ns per record between 4096 and
32768 records, median of 3, each call on a fresh framebuffer. With
`--scene`, `bench_given` runs the bodies of GIVEN_BODIES on given records
instead — the 1080p static scene's span records
(tools/kernel_times.scene_records), whose bboxes are larger and more
varied than make_records' — and times each call queued. With
`--sweep`, `sweep` times the shipped K2 at each grid cap of SWEEP_BLOCKS
(blocks an SM before its warps stride over the records; 0 is one warp a
record) on the span records of the 1080p static scene, the three goldens'
scenes and the orbit's first frames (`sweep_sets`), each cap bit for bit
against the plain version. `raster`
launches the kernel for CUDA tensors (counted in
_cuda.launches["t_span"]) and runs the plain version for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import pathlib
import subprocess

import numpy as np
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.nums.fp import sqrt_rn
from planet_tpu_torch.raster import coverage as cov
from planet_tpu_torch.raster import coverage_cuda, nearclip
from planet_tpu_torch.tools import common

BODIES = ("full", "noshade", "fewscalar", "rmw_only", "empty", "static_rmw")
# K2's grid caps for --sweep, blocks an SM (0: one warp a record)
SWEEP_BLOCKS = (0, 16, 24, 28, 32, 40, 56)
GOLD = pathlib.Path(__file__).resolve().parents[2] / "tests" / "goldens"
BV_MODES = ("record", "side", "static")


@dataclasses.dataclass(frozen=True)
class Variant:
    body: str = "full"
    per_warp: int = 1        # records a warp, one after another
    bv: str | None = None    # block-vectorized: the window origin's source
    group: int = 1           # bv: R records a block
    noin: bool = False       # bv: no bbox test

    @property
    def code(self) -> int:
        return 6 + BV_MODES.index(self.bv) if self.bv else \
            BODIES.index(self.body)


VARIANTS = {
    **{b: Variant(b) for b in BODIES},
    **{f"full_w{k}": Variant(per_warp=k) for k in (2, 4, 8)},
    "bv_r8": Variant(bv="record", group=8),
    "bv_r32": Variant(bv="record", group=32),
    "bv_r32_side": Variant(bv="side", group=32),
    "bv_r32_side_noin": Variant(bv="side", group=32, noin=True),
    "bv_r32_static": Variant(bv="static", group=32),
}
HEADLINE = "full"
# the bodies bench_given runs on given records: the first port's K2 body
# (the bbox scan), its bbox loop and atomics alone, the record read alone,
# and that body 8 records a warp
GIVEN_BODIES = ("full", "rmw_only", "empty", "full_w8")
# block-vectorized variants whose plain version is timed too, at the big
# record count, once (proto_bv's and proto_bv2's timed kernels)
PLAIN_TIMED = (("bv_r8", (14, 8)), ("bv_r32_side_noin", (14, 8)))
# (bbox width, window height) -> the variants timed there (the tools'
# matrix: every body at 14x8, the bodies the tools reran at 14x16, full at
# 24x24)
CASES = {(14, 8): tuple(VARIANTS),
         (14, 16): ("full", "noshade", "bv_r8", "bv_r32", "bv_r32_side",
                    "bv_r32_side_noin"),
         (24, 24): ("full",)}
REPLACES = {"T8": "tools/microbench_span2.py:86",
            "T9": "tools/microbench_span3.py:116",
            "T10": "tools/proto_bv.py:94", "T11": "tools/proto_bv2.py:92"}
SIZES = {"width": 1920, "height": 1080, "small": 4096, "big": 32768}
SMALL = {"width": 384, "height": 128, "small": 64, "big": 256}

# f32 operations of each body, counted from csrc/bench_span.cu: per
# candidate pixel (the edge functions and their tests) and per accepted
# fragment (depth, normal, shade, packing).
OPS_CANDIDATE = {"full": 15, "noshade": 15, "fewscalar": 5, "rmw_only": 0,
                 "empty": 0, "static_rmw": 15}
OPS_ACCEPTED = {"full": 41, "noshade": 12, "fewscalar": 31, "rmw_only": 0,
                "empty": 0, "static_rmw": 41}


# ----------------------------------------------------------------- records

def make_records(k: int, winh: int, bw: int = 14, seed: int = 0,
                 width: int = 1920, height: int = 1080, device="cuda"):
    """(records (k, 32) f32, addr (k, 2) int32): k live front-facing
    triangles, each bw wide and ~winh - 1.2 tall inside its own aligned
    window of winh rows (8-row blocks) and 128 columns, set up by the
    port's record math; addr holds each window's (row block, column
    block), the tools' side array."""
    if bw >= 128 or winh % 8 or height <= winh or width < 256:
        raise ValueError("need bw < 128, winh a multiple of 8, "
                         "height > winh and width >= 256")
    rng = np.random.default_rng(seed)
    pyblk = rng.integers(0, (height - winh) // 8 + 1, k)
    blk0 = rng.integers(0, width // 128 - 1, k)
    x0 = rng.integers(0, (128 - bw) * 16, k) / 16.0
    y0 = rng.integers(0, 16, k) / 16.0
    h = winh - 1.2
    # apex on top, base below, ordered to face the camera (area2 > 0
    # under coverage.FRONT_SIGN)
    xs = np.stack([x0 + bw * 0.5, x0 + bw, x0], 1) + blk0[:, None] * 128.0
    ys = np.stack([y0, y0 + h, y0 + h], 1) + pyblk[:, None] * 8.0
    if cov.FRONT_SIGN < 0:
        xs, ys = xs[:, [0, 2, 1]], ys[:, [0, 2, 1]]
    xs = np.round(xs * 16.0) / 16.0
    ys = np.round(ys * 16.0) / 16.0
    vc = np.zeros((k, 3, 4))
    vc[..., 0] = xs / width * 2.0 - 1.0          # clip x, y at w = 1
    vc[..., 1] = 1.0 - ys / height * 2.0
    vc[..., 2] = rng.uniform(0.05, 0.25, (k, 3))
    vc[..., 3] = 1.0
    vn = rng.normal(0.0, 1.0, (k, 3, 3))
    t = nearclip.setup_tris(
        torch.as_tensor(vc, dtype=torch.float32, device=device),
        torch.as_tensor(vn, dtype=torch.float32, device=device),
        torch.ones(k, dtype=torch.bool, device=device), width, height)
    if not bool(t.live.all()):
        raise RuntimeError("make_records: a triangle is not live")
    addr = np.stack([pyblk, blk0], 1).astype(np.int32)
    return (nearclip.records_from_tris(t),
            torch.as_tensor(addr, device=device))


# ---------------------------------------------------------- plain versions

def _pairs(recs, chunk: int = 1 << 20):
    """Chunks of (record rows, bbox px0, py0, rx, ry) over every pixel of
    every live record's bbox (coverage.fragments' expansion)."""
    recs = recs[recs[:, 28] != 0.0]
    if recs.shape[0] == 0:
        return
    px0 = recs[:, 24].long()
    py0 = recs[:, 25].long()
    bw = recs[:, 26].long() - px0 + 1
    area = (bw * (recs[:, 27].long() - py0 + 1)).cpu()
    ends = torch.cumsum(area, 0)
    start, m = 0, recs.shape[0]
    while start < m:
        base = int(ends[start - 1]) if start else 0
        stop = int(torch.searchsorted(
            ends, torch.tensor([base + chunk]), right=True)[0])
        stop = max(stop, start + 1)
        sel = torch.arange(start, stop, device=recs.device)
        cnt = area[start:stop].to(recs.device)
        rep = torch.repeat_interleave(sel, cnt)
        first = torch.cumsum(cnt, 0) - cnt
        local = torch.arange(rep.shape[0], device=recs.device) \
            - torch.repeat_interleave(first, cnt)
        ry = local // bw[rep]
        yield recs[rep], px0[rep], py0[rep], local - ry * bw[rep], ry
        start = stop


def _pack_min(flat, z, shade, idx):
    zq = torch.clamp_max((z * 0.5 + 0.5) * 2097151.0, 2097150.0) \
        .to(torch.int32)
    sq = torch.clamp_max(shade * 1023.0, 1023.0).to(torch.int32)
    flat.scatter_reduce_(0, idx, (zq << 10) | sq, reduce="amin")


def _merge_noshade(flat, r, px, py, rx, ry, width):
    def edge(k):
        return (r[:, 3 * k] * ry - r[:, 3 * k + 1] * rx) + r[:, 3 * k + 2]

    e0, e1, e2 = edge(0), edge(1), edge(2)
    z = (e0 * r[:, 9] + e1 * r[:, 10]) + e2 * r[:, 11]
    ok = ((e0 > r[:, 29]) & (e1 > r[:, 30]) & (e2 > r[:, 31])
          & (z >= -1.0))
    keep = torch.nonzero(ok).squeeze(1)
    _pack_min(flat, z[keep], z[keep], py[keep] * width + px[keep])


def _merge_few(flat, r, px, py, rx, ry, width):
    e = (r[:, 0] * ry - r[:, 1] * rx) + r[:, 2]
    z = (e * r[:, 9] + e * r[:, 9]) + e * r[:, 9]
    keep = torch.nonzero((e > r[:, 29]) & (z >= -1.0)).squeeze(1)
    e, r, z = e[keep], r[keep], z[keep]
    nv = (e * r[:, 15] + e * r[:, 15]) + e * r[:, 15]
    nlen = sqrt_rn((nv * nv + nv * nv) + nv * nv)
    ndl = (nv * cov.LIGHT_Y + nv * cov.LIGHT_Z) / torch.where(
        nlen > 0.0, nlen, torch.ones_like(nlen))
    shade = sqrt_rn(0.001 + torch.where(ndl < 0.0, torch.zeros_like(ndl),
                                      ndl))
    _pack_min(flat, z, shade, py[keep] * width + px[keep])


def _bv_plain(v: Variant, recs, addr, fb, winh: int):
    height, width = fb.shape
    flat = fb.view(-1)
    rows = torch.arange(recs.shape[0], device=recs.device)
    live = recs[:, 28] != 0.0
    recs, rows = recs[live], rows[live]
    if v.bv == "side":
        yb, xb = addr[live, 0].long(), addr[live, 1].long()
    else:
        yb, xb = recs[:, 25].long() >> 3, recs[:, 24].long() >> 7
    yb = yb.clamp(0, (height - winh) // 8)
    xb = xb.clamp(0, (width - 128) // 128)
    pix = torch.arange(winh * 128, device=recs.device)
    row, col = pix >> 7, pix & 127
    step = max(1, (1 << 20) // (winh * 128))
    for s in range(0, recs.shape[0], step):
        r, sl = recs[s:s + step], slice(s, s + step)
        px = xb[sl, None] * 128 + col
        py = yb[sl, None] * 8 + row
        px0, py0 = r[:, 24, None].long(), r[:, 25, None].long()
        ok = torch.ones_like(px, dtype=torch.bool)
        if not v.noin:
            ok = ((px >= px0) & (px <= r[:, 26, None].long())
                  & (py >= py0) & (py <= r[:, 27, None].long()))
        wx, wy = px, py
        if v.bv == "static":
            k = (rows[sl] % v.group)[:, None]
            wy = (k * winh) % (height - winh) + row
            wx = 128 * (k % (width // 128)) + col
        rec_i, pix_i = torch.nonzero(ok, as_tuple=True)
        cov._merge(flat, r[rec_i], wx[rec_i, pix_i], wy[rec_i, pix_i],
                   (px - px0)[rec_i, pix_i].to(torch.float32),
                   (py - py0)[rec_i, pix_i].to(torch.float32), width,
                   False, False)
    return fb


def raster_plain(name: str, recs, fb, *, winh: int = 8, addr=None):
    """Plain PyTorch version of variant `name`: min-merges into fb (H, W)
    int32 in place and returns it."""
    v = VARIANTS[name]
    if v.bv:
        return _bv_plain(v, recs, addr, fb, winh)
    if v.body == "full":
        return coverage_cuda.raster_span_plain(recs, fb)
    width = fb.shape[1]
    flat = fb.view(-1)
    for r, px0, py0, rx, ry in _pairs(recs):
        rxf, ryf = rx.to(torch.float32), ry.to(torch.float32)
        if v.body == "noshade":
            _merge_noshade(flat, r, px0 + rx, py0 + ry, rxf, ryf, width)
        elif v.body == "fewscalar":
            _merge_few(flat, r, px0 + rx, py0 + ry, rxf, ryf, width)
        elif v.body == "rmw_only":
            idx = (py0 + ry) * width + px0 + rx
            flat.scatter_reduce_(0, idx, torch.full_like(idx, 7).to(
                torch.int32), reduce="amin")
        elif v.body == "static_rmw":
            cov._merge(flat, r, rx, ry, rxf, ryf, width, False, False)
    return fb


# ------------------------------------------------------------- the kernel

def raster_kernel(name: str, recs, fb, *, winh: int = 8, addr=None):
    """Variant `name` on the card (csrc/bench_span.cu), into fb in place."""
    v = VARIANTS[name]
    m = recs.shape[0]
    _cuda.check_cuda(recs, "records", torch.float32, (m, 32))
    _cuda.check_cuda(fb, "fb", torch.int32)
    if fb.dim() != 2 or fb.shape[1] < 128 or fb.shape[0] <= winh:
        raise ValueError(f"fb must be (H > winh, W >= 128), got "
                         f"{tuple(fb.shape)}")
    if v.bv and winh not in (8, 16, 24):
        raise ValueError("block-vectorized windows are 8, 16 or 24 rows")
    if v.bv == "side":
        if addr is None:
            raise ValueError(f"{name} reads the side array addr")
        _cuda.check_cuda(addr, "addr", torch.int32, (m, 2))
    if m:
        height, width = fb.shape
        _cuda.launch("t_span", "planet_t_span", v.code, recs.data_ptr(),
                     addr.data_ptr() if v.bv == "side" else None, m,
                     fb.data_ptr(), width, height,
                     v.group if v.bv else v.per_warp, winh, int(v.noin))
    return fb


def raster(name: str, recs, fb, **kw):
    """Variant `name`: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if name not in VARIANTS:
        raise ValueError(f"unknown span variant {name!r}")
    if common.device_of(recs) == "cuda":
        return raster_kernel(name, recs, fb, **kw)
    return raster_plain(name, recs, fb, **kw)


# ------------------------------------------------------------------- runs

def fb_diff(got, want):
    """(pixels whose coverage differs, the largest difference of the packed
    depth or shade fields, in quanta, where both are covered)."""
    cg, cw = got != cov._EMPTY, want != cov._EMPTY
    both = cg & cw
    d = 0
    if bool(both.any()):
        d = int(max(((got[both] >> 10) - (want[both] >> 10)).abs().max(),
                    ((got[both] & 1023) - (want[both] & 1023)).abs().max()))
    return int((cg != cw).sum()), d


def fresh_fb(width: int, height: int, device):
    return torch.full((height, width), cov._EMPTY, dtype=torch.int32,
                      device=device)


def bound(name: str, recs, fb_after, sm_clock_hz=None):
    """(least ms, by) of variant `name` on these records: its f32
    operations (every bbox pixel of a live record a candidate, every
    covered pixel at least one accepted fragment) and its bytes (records
    read once, each covered pixel's key read and written once)."""
    body = VARIANTS[name].body
    live = recs[recs[:, 28] != 0.0]
    cand = float(((live[:, 26] - live[:, 24] + 1)
                  * (live[:, 27] - live[:, 25] + 1)).sum())
    covered = int((fb_after != cov._EMPTY).sum())
    nbytes = recs.shape[0] * 128
    if body != "empty":
        nbytes += 2 * covered * 4
    return common.bound_ms(cand * OPS_CANDIDATE[body]
                           + covered * OPS_ACCEPTED[body], nbytes,
                           sm_clock_hz=sm_clock_hz)


def bench(device: str = "cuda", small: bool = False,
          reps: int = common.REPS) -> dict:
    """Every variant of CASES once against its plain version (at the
    small record count; full also at the big one), then timed by slope.
    Returns {"rows": [...], "headline": {...}}: a row holds name, case
    (bw, winh), rate (ns a record by slope, median of 3), ms at the big
    count, bound, equal (bit for bit; bv_* with the record's or the side
    array's window also equal to full) and
    max_abs_err (quanta), and plain_ms for PLAIN_TIMED; the headline
    (full, 14x8, big count) has ms (median of reps), plain_ms, bound."""
    sz = SMALL if small else SIZES
    w, h = sz["width"], sz["height"]
    clock = common.sm_clock_hz() if device == "cuda" else None
    rows, headline = [], {}
    for (bw, winh), names in CASES.items():
        recs = {c: make_records(sz[c], winh, bw, 0, w, h, device)
                for c in ("small", "big")}
        full = raster_plain(HEADLINE, recs["small"][0],
                            fresh_fb(w, h, device))
        for name in names:
            v = VARIANTS[name]
            equal, err = True, 0
            for c in ("small", "big") if name == HEADLINE else ("small",):
                r, a = recs[c]
                got = raster(name, r, fresh_fb(w, h, device), winh=winh,
                             addr=a)
                want = raster_plain(name, r, fresh_fb(w, h, device),
                                    winh=winh, addr=a)
                d = fb_diff(got, want)[1]
                equal = equal and common.same(got, want)
                if v.bv in ("record", "side"):   # its window holds the bbox
                    equal = equal and common.same(got, full)
                err = max(err, d)
            t = {c: common.time_calls(
                lambda fb: raster(name, recs[c][0], fb, winh=winh,
                                  addr=recs[c][1]),
                lambda: (fresh_fb(w, h, device),), reps=3, device=device)
                for c in ("small", "big")}
            slopes = [(b - s) * 1e6 / (sz["big"] - sz["small"])
                      for s, b in zip(t["small"], t["big"])]
            big_ms = t["big"]
            r_big, a_big = recs["big"]
            fb = raster(name, r_big, fresh_fb(w, h, device), winh=winh,
                        addr=a_big)
            rows.append(dict(
                name=f"{name} {bw}x{winh}", variant=name, case=(bw, winh),
                rate=float(np.median(slopes)), ms=float(np.median(big_ms)),
                bound=bound(name, r_big, fb, clock), equal=equal,
                max_abs_err=err))
            if (name, (bw, winh)) in PLAIN_TIMED:
                rows[-1]["plain_ms"] = common.time_ms(
                    lambda fb: raster_plain(name, r_big, fb, winh=winh,
                                            addr=a_big),
                    lambda: (fresh_fb(w, h, device),), reps=1,
                    device=device)
            if name == HEADLINE and (bw, winh) == (14, 8):
                setup = lambda: (fresh_fb(w, h, device),)   # noqa: E731
                headline = dict(
                    ms=common.time_ms(lambda fb: raster(name, r_big, fb),
                                      setup, reps=reps, device=device),
                    plain_ms=common.time_ms(
                        lambda fb: raster_plain(name, r_big, fb), setup,
                        reps=min(reps, 3), device=device),
                    bound=rows[-1]["bound"], records=r_big.shape[0])
    return {"rows": rows, "headline": headline}


def bench_given(recs, width: int, height: int, names=GIVEN_BODIES,
                reps: int = common.REPS) -> list:
    """Each per-record body of `names` on the given (M, 32) records: rows
    of name, ms (median of reps, queued behind a spin kernel on the card),
    rate (ns a record), bound, equal (bit for bit against its plain
    version) and max_abs_err (packed-field quanta)."""
    device = common.device_of(recs)
    clock = common.sm_clock_hz() if device == "cuda" else None
    rows = []
    for name in names:
        if VARIANTS[name].bv:
            raise ValueError(f"{name} is block-vectorized, not a body")
        got = raster(name, recs, fresh_fb(width, height, device))
        want = raster_plain(name, recs, fresh_fb(width, height, device))
        ms = common.time_ms(lambda fb: raster(name, recs, fb),
                            lambda: (fresh_fb(width, height, device),),
                            reps=reps, device=device)
        rows.append(dict(
            name=f"{name} given", variant=name, ms=ms,
            rate=ms * 1e6 / max(recs.shape[0], 1),
            bound=bound(name, recs, got, clock),
            equal=common.same(got, want), max_abs_err=fb_diff(got, want)[1]))
    return rows


def sweep_sets(device) -> dict:
    """{name: (records, width, height)}: the span records K2 draws in the
    1080p static scene, in the three goldens' scenes (800x600) and in each
    of the orbit's first frames (one PlanetEngine flying them in order)."""
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.engine.planet import PlanetEngine
    from planet_tpu_torch.geom import camera as cam_mod
    from planet_tpu_torch.tools import kernel_times

    w, h = kernel_times.SCENE_W, kernel_times.SCENE_H
    sets = {"1080p static": (kernel_times.scene_records(device), w, h)}
    cfg = EngineConfig()
    for name in ("frame", "nearclip", "farclip"):
        cam = cam_mod.Camera(position=np.load(GOLD / f"{name}_cam.npy"),
                             angles=np.load(GOLD / f"{name}_angles.npy"))
        sets[f"golden {name}"] = (kernel_times.frame_records(
            PlanetEngine(cfg, device=device), cam), cfg.window_w,
            cfg.window_h)
    cfg = EngineConfig(window_w=w, window_h=h)
    eng = PlanetEngine(cfg, device=device)
    for i, (alt, cam) in enumerate(kernel_times.orbit_cameras(cfg)):
        sets[f"orbit {i} ({alt:.0f} m)"] = (
            kernel_times.frame_records(eng, cam), w, h)
    return sets


def sweep(sets: dict, blocks=SWEEP_BLOCKS, reps: int = common.REPS) -> list:
    """K2 (coverage_cuda.raster_span_cuda) on each record set at each grid
    cap of `blocks` (blocks an SM; 0 = one warp a record), timed queued
    twice, the caps in order and then in reverse: rows of name, records,
    ms {cap: [first, second]} and equal (every cap's framebuffer bit for
    bit the plain version's)."""
    rows = []
    for name, (recs, width, height) in sets.items():
        device = common.device_of(recs)
        want = coverage_cuda.raster_span_plain(
            recs, fresh_fb(width, height, device))
        equal = all(torch.equal(coverage_cuda.raster_span_cuda(
            recs, fresh_fb(width, height, device), blocks_per_sm=b), want)
            for b in blocks)
        ms = {b: [] for b in blocks}
        for b in (*blocks, *blocks[::-1]):
            ms[b].append(common.time_ms(
                lambda fb: coverage_cuda.raster_span_cuda(
                    recs, fb, blocks_per_sm=b),
                lambda: (fresh_fb(width, height, device),), reps=reps))
        rows.append(dict(name=name, records=recs.shape[0], ms=ms,
                         equal=equal))
    return rows


def main(argv=None) -> int:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--scene", action="store_true",
                   help="run GIVEN_BODIES on the 1080p scene's span records")
    p.add_argument("--sweep", action="store_true",
                   help="time K2 at each grid cap of SWEEP_BLOCKS on the "
                        "1080p scene's, the goldens' and the orbit's span "
                        "records (needs a card)")
    args = common.parse_args(argv, p)
    if args.sweep:
        if args.device != "cuda":
            p.error("--sweep times the kernel: it needs --device cuda")
        rows = sweep(sweep_sets(args.device), reps=args.reps)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        for r in rows:
            print(f"{r['name']:22s} {r['records']:6d} records  " + "  ".join(
                f"{b}: {a:.4f}/{c:.4f}" for b, (a, c) in r["ms"].items())
                + f"  equal {r['equal']}", flush=True)
        return 0 if all(r["equal"] for r in rows) else 1
    if args.scene:
        from planet_tpu_torch.tools import kernel_times
        recs = kernel_times.scene_records(args.device)
        rows = bench_given(recs, kernel_times.SCENE_W, kernel_times.SCENE_H,
                           reps=args.reps)
        for r in rows:
            print(common.line("", r, "ns/record", args.device), flush=True)
        return 0 if all(r["equal"] for r in rows) else 1
    res = bench(args.device, args.small, args.reps)
    for r in res["rows"]:
        print(common.line("", r, "ns/record (slope)", args.device),
              flush=True)
    hl = res["headline"]
    print(f"headline full 14x8, {hl['records']} records: {hl['ms']:.4f} ms, "
          f"plain {hl['plain_ms']:.4f} ms", flush=True)
    return 0 if all(r["equal"] for r in res["rows"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
