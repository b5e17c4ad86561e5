"""The exact raster on CUDA: the triangle setup (C1), the record route
(K6), span kernel (K2), huge kernel (K3), and the `raster_frame` driver
that queues them (planet_tpu raster/coverage_pallas.py's
raster_frame_pallas, without its TPU-only machinery).

Each kernel wrapper takes a CUDA tensor and launches its kernel
(csrc/setup.cu, csrc/raster.cu) or raises. The clip pass's and the
raster's wrappers, given a CPU tensor, run the plain PyTorch version
beside them, which has the same signature but for the clip pass's
`blocks`; C1 and K6 hand each other the route on the card and live and
span in their plain versions:

* setup_plain(clip, normal, valid, width, height, cell_mask, far_w,
  count) -> (tm (32, N) f32, live (N,) bool, span (N,) int32, straddle
  (N,) bool, None): coverage.setup_t's outputs and
  nearclip.straddle_mask_t's mask; with `count` (a (1,) int32 tensor:
  the leaf count, read on the device) the patch rows at or past it come
  out dead (live, span and straddle 0);
* setup_cuda(the same arguments) -> (tm, route, straddle, blocks): C1,
  the same in one pass, tm's columns written for live candidates only,
  with K6's route (`route`, the (route_scratch_ints(N),) int32 scratch:
  each 32 candidates' span-class and huge-class masks, then each
  ROUTE_TILE candidates' two class counts) in place of live and span,
  and `blocks`, each SETUP_BLOCK candidates' straddler count
  ((ceil(N / SETUP_BLOCK),) int32) for its clip pass. Their plain
  counterparts: route_masks_plain on setup_plain's tm, live and span
  (route's class test), and straddle_blocks;
* clip_pass(clip, normal, straddle, blocks, width, height, far_w,
  clip_cap) -> (s_idx (clip_cap,) int32, n_straddle () int32, records,
  count (1,) int32): the near-plane clip pass (C2) — the first clip_cap
  straddlers' candidate indices (N in the empty slots; planet_tpu's
  _compact_indices), all the straddlers' count, and their live clipped
  triangles' row records in (slot, A, B) order, the first count[0] rows
  of `records` (the kernel's buffer holds 2 clip_cap rows, the plain
  version's exactly count[0]). The kernel reads C1's `blocks`; the plain
  version, clip_pass_plain (compact_indices, nearclip.clipped_tris and
  records_from_tris: clip_records_plain), takes no `blocks` and
  compacts the mask itself;
* route_records_plain(tm (32, N) f32, live (N,) bool, span (N,) int32)
  -> (span-class records, huge-class records, counts (2,) int32): each
  class's live records as rows in candidate order (route, then
  gather_records_plain); route_records_cuda(tm, route) -> the same on
  C1's route (K6: the scan of its block counts, then the scatter), the
  first counts[c] rows of each N-row buffer written and the counts left
  on the device;
* raster_span(records (M, 32), fb (H, W) int32, count=None) — fragments
  without the interpolated-1/w test (vacuous inside the exact coverage
  domain);
* raster_huge(records (M, 32), fb, count=None) — the same fragment math
  plus iw > 0 and iw > row 28 (the view-space far clip).

Both raster wrappers draw the first `count` records (a (1,) int32 tensor
on the records' device, read by the kernel; None: all M), min-merge into
`fb` in place and return it.

Both kernels visit only the pixels inside each bbox row's exact interval
(csrc/raster.cu): along a row each edge function is a monotone function
of the column, so the pixels passing all three edge tests form one
interval, and every pixel outside it fails fragment()'s edge test.
`row_intervals_plain` is the interval search in plain PyTorch, the same
predicate in the same op order; the CPU tests hold it to a scan of every
pixel, and nothing on the main path calls it. The span kernel takes each
warp's strided records 32 at a time as one batch, its rows and their
inside pixels flattened over the lanes; `span_batch_stats` counts, from
the records alone, how full that keeps the lanes (tools/kernel_times
prints it beside K2's time).

Routing (coverage_pallas.raster_frame_pallas): a live record whose bbox
touches at most 16 aligned 8-row blocks and that is not a far-straddler
goes to the span kernel, with no bound on width; every other live record
goes to the huge kernel; near-plane straddlers are clipped
(raster/nearclip.py) and their live parts go to the huge kernel too.
Records are compacted to exactly the live ones, so there are no class
caps. The clip pass (C2) compacts the straddlers on the device into
clip_cap slots in candidate order from C1's per-block counts (planet_tpu's
_compact_indices: index N marks an empty slot), clips the used slots
alone and writes their live records with the records' count, which K3
reads: a frame with no straddler clips nothing and K3 leaves at once, as
planet_tpu's lax.cond skips its pass. More straddlers than clip_cap set
`overflowed`, as in planet_tpu. planet_tpu's clip_run_cap (a second
compaction of the clipped triangles, a TPU cost cap like its class caps)
has no counterpart. So raster_frame's shapes follow from its inputs' and
it reads nothing back to the host: C1, K6, K2, C2 and K3 and the few
torch ops between them are queued with no host read, and a CUDA graph
can capture the whole raster (engine/device_step.DeviceRenderer). On the
card C1 classifies the candidates for K6 as it sets them up, and K6's
scan is C1's programmatic dependent: nothing is queued between them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.raster import coverage as cov
from planet_tpu_torch.raster import nearclip

MAX_SPAN_BLOCKS = 16     # aligned 8-row blocks a span-kernel bbox may touch
# the span kernel's grid stops at this many 128-thread blocks an SM (4
# waves of the 8 that fit), its warps then striding over the records; 0
# gives one warp a record however many there are. Swept on the 1080p
# scene's, the goldens' and an orbit's records by
# `python -m planet_tpu_torch.tools.span_parts --sweep` (PERF.md).
SPAN_BLOCKS_PER_SM = 32
# candidates a route block takes (csrc/raster.cu kRouteTile), C1's block
# (SETUP_BLOCK); each block keeps 16 mask words and 2 counts in the scratch
ROUTE_TILE = 256
# an edge word at or above this magnitude (or not finite) sends its record
# to the whole-bbox scan: below it, no product or sum of the edge function
# over a bbox of fewer than 2^24 rows and columns overflows, so rounding
# keeps each edge monotone along a row (csrc/raster.cu kEdgeLimit)
EDGE_LIMIT = 2.0**100
# near-plane straddler slots (planet_tpu coverage.raster_frame's clip_cap)
CLIP_CAP = 512
# candidates a C1 block takes, and so each straddler count's span
# (csrc/setup.cu kSetupThreads)
SETUP_BLOCK = 256


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _far(far_w):
    """The C entry points' (far_w, 1 / far_w) as f32, (0, 0) for none."""
    if far_w is None:
        return 0.0, 0.0
    if not far_w > 0:
        raise ValueError(f"far_w {far_w}: expected a positive far plane")
    return float(np.float32(far_w)), float(np.float32(1.0 / far_w))


# ------------------------------------------------------------------- C1

def _count_rows(x, q: int, g: int, count):
    """(N,) bool: candidates whose patch row is below `count` ((1,) int32
    on x's device), in setup_t's candidate order."""
    rows = torch.arange(q, dtype=torch.int32, device=x.device) < count
    return rows[None, :, None].expand(2, q, g * g).reshape(-1)


def straddle_blocks(straddle):
    """(ceil(N / SETUP_BLOCK),) int32: the straddlers among each
    SETUP_BLOCK candidates of the (N,) mask, as C1 counts them: the plain
    version of C1's `blocks`, which only the kernel's clip pass reads."""
    n = straddle.shape[0]
    pad = -n % SETUP_BLOCK
    full = torch.cat([straddle, straddle.new_zeros(pad)]) if pad else straddle
    return full.view(-1, SETUP_BLOCK).sum(1, dtype=torch.int32)


def setup_plain(clip, normal, valid, width: int, height: int,
                cell_mask=None, far_w=None, count=None):
    tm, live, span = cov.setup_t(clip, normal, valid, width, height,
                                 cell_mask, far_w=far_w)
    straddle = nearclip.straddle_mask_t(clip, valid, cell_mask)
    if count is not None:
        ok = _count_rows(live, clip.shape[0], clip.shape[1], count)
        live, straddle = live & ok, straddle & ok
        span = torch.where(ok, span, torch.zeros_like(span))
    return tm, live, span, straddle, None


def setup_cuda(clip, normal, valid, width: int, height: int,
               cell_mask=None, far_w=None, count=None):
    q, g = clip.shape[0], clip.shape[1]
    clip, normal, valid = (t.contiguous() for t in (clip, normal, valid))
    _cuda.check_cuda(clip, "clip", torch.float32, (q, g, g, 4))
    _cuda.check_cuda(normal, "normal", torch.float32, (q, g, g, 3))
    _cuda.check_cuda(valid, "valid", torch.bool, (q, g, g))
    if clip.data_ptr() % 16:
        raise ValueError("clip: the setup kernel reads 16-byte aligned "
                         "vertices")
    if count is not None:
        _cuda.check_cuda(count, "count", torch.int32, (1,))
        if count.device != clip.device:
            raise ValueError("count: expected the vertices' device")
    far = _far(far_w)
    n = 2 * q * g * g
    dev = clip.device
    tm = torch.empty((32, n), dtype=torch.float32, device=dev)
    straddle = torch.empty(n, dtype=torch.bool, device=dev)
    blocks = torch.empty(-(-n // SETUP_BLOCK), dtype=torch.int32, device=dev)
    words = route_scratch_ints(n)
    route = torch.empty(words, dtype=torch.int32, device=dev)
    if n:
        table = cov.cell_table(g, cell_mask, dev)
        _cuda.launch("setup", "planet_setup", clip.data_ptr(),
                     normal.data_ptr(), valid.data_ptr(), table.data_ptr(),
                     None if count is None else count.data_ptr(), q, g,
                     int(width), int(height), *far, MAX_SPAN_BLOCKS,
                     tm.data_ptr(), straddle.data_ptr(), blocks.data_ptr(),
                     route.data_ptr(), words)
    return tm, route, straddle, blocks


def compact_indices(mask, cap: int):
    """planet_tpu coverage._compact_indices on the device: (idx (cap,)
    int32, the indices of the first `cap` set lanes in order, N (the
    mask's length) in the slots past the last; count () int32, all the
    set lanes). The k-th set lane is the first whose running count
    reaches k: a cumsum and one searchsorted, no host read."""
    run = torch.cumsum(mask, 0, dtype=torch.int32)
    idx = torch.searchsorted(run, _ranks(cap, str(mask.device)),
                             out_int32=True)
    return idx, run[-1]


@functools.lru_cache(maxsize=None)
def _ranks(cap: int, device: str) -> torch.Tensor:
    return torch.arange(1, cap + 1, dtype=torch.int32, device=device)


# ------------------------------------------------------------------- K6

def route_classes(tm, live, span):
    """(span class, huge class), (N,) bool: span-class records are live,
    touch at most MAX_SPAN_BLOCKS aligned 8-row blocks and are not
    far-straddlers (row 28 > 0); the huge class holds the other live
    ones."""
    eligible = live & (span <= MAX_SPAN_BLOCKS) & ~(tm[28] > 0.0)
    return eligible, live & ~eligible


def route(tm, live, span):
    """(span-kernel indices, huge-kernel indices), int32, in candidate
    order (route_classes)."""
    return tuple(torch.nonzero(c).squeeze(1).to(torch.int32)
                 for c in route_classes(tm, live, span))


def route_masks_plain(tm, live, span):
    """The route C1 writes, from setup_t's outputs on any device: the
    (route_scratch_ints(N),) int32 words of K6's scratch — for each 32
    candidates (the last block's padded with dead ones) the span-class and
    the huge-class mask, bit k candidate k, then for each ROUTE_TILE
    candidates the two class counts. No host read."""
    n = live.shape[0]
    blocks = -(-n // ROUTE_TILE)
    cls = torch.stack(route_classes(tm, live, span), 1)
    cls = torch.cat([cls, cls.new_zeros(blocks * ROUTE_TILE - n, 2)])
    bits = torch.arange(32, dtype=torch.int64, device=live.device)
    words = (cls.view(-1, 32, 2).to(torch.int64) << bits[:, None]).sum(1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    pairs = cls.view(blocks, ROUTE_TILE, 2).sum(1, dtype=torch.int32)
    return torch.cat([words.to(torch.int32).reshape(-1), pairs.reshape(-1)])


def gather_records_plain(tm, idx):
    """(M, 32) row records tm[:, idx].T; an index outside [0, N) gives an
    all-zero (dead) record."""
    n = tm.shape[1]
    ok = (idx >= 0) & (idx < n)
    safe = torch.where(ok, idx, torch.zeros_like(idx)).long()
    out = tm[:, safe].T
    return torch.where(ok[:, None], out, torch.zeros_like(out)).contiguous()


def route_records_plain(tm, live, span):
    span_idx, huge_idx = route(tm, live, span)
    counts = torch.stack([span_idx.new_full((), span_idx.numel()),
                          huge_idx.new_full((), huge_idx.numel())])
    return (gather_records_plain(tm, span_idx),
            gather_records_plain(tm, huge_idx), counts)


def route_scratch_ints(n: int) -> int:
    """int32 words of the route kernel's scratch for n candidates."""
    return -(-n // ROUTE_TILE) * (2 * ROUTE_TILE // 32 + 2)


def route_records_cuda(tm, route):
    """K6 on the route C1 wrote (setup_cuda) or route_masks_plain formed;
    the scan overwrites its block counts with the blocks' offsets."""
    n = tm.shape[1]
    words = route_scratch_ints(n)
    _cuda.check_cuda(tm, "tm", torch.float32, (32, n))
    _cuda.check_cuda(route, "route", torch.int32, (words,))
    if route.device != tm.device or route.data_ptr() % 16:
        raise ValueError("route: expected a 16-byte aligned scratch on the "
                         "records' device")
    span_recs = torch.empty((n, 32), dtype=torch.float32, device=tm.device)
    huge_recs = torch.empty_like(span_recs)
    # the kernel writes the counts (no fill to queue), unless there is
    # nothing to route
    counts = (torch.empty if n else torch.zeros)(2, dtype=torch.int32,
                                                 device=tm.device)
    if n:
        _cuda.launch("gather", "planet_route_records", tm.data_ptr(), n,
                     route.data_ptr(), words, span_recs.data_ptr(),
                     huge_recs.data_ptr(), counts.data_ptr())
    return span_recs, huge_recs, counts


# ---------------------------------------------------------------- K2, K3

def _first(records, count):
    """The records a raster call draws: the first `count` of them."""
    return records if count is None else records[:int(count[0])]


def raster_span_plain(records, fb, wireframe: bool = False, count=None):
    return cov.fragments(_first(records, count), fb, iw_test=False,
                         wireframe=wireframe)


def raster_huge_plain(records, fb, wireframe: bool = False, count=None):
    return cov.fragments(_first(records, count), fb, iw_test=True,
                         wireframe=wireframe)


def _edge_passes(A, B, c, bias, ry, x):
    """fragment()'s edge test of edge (A, B, c, bias) at integer columns x
    of rows ry (f32): ((A ry - B x) + c) > bias, op for op."""
    return ((A * ry - B * x.to(torch.float32)) + c) > bias


def _boundary(A, B, c, bias, ry, bw):
    """The first column b in [0, bw] where an edge whose coefficient B is
    non-zero flips along its row: for B > 0 the edge passes exactly at the
    columns below b, for B < 0 exactly at b and above. From the line's
    estimate, settled by probing around it and bisecting with the exact
    test (csrc/raster.cu row_boundary)."""
    pos = B > 0.0
    ryf = ry.to(torch.float32)

    def before(x):              # True at the columns before the boundary
        p = _edge_passes(A, B, c, bias, ryf, x)
        return torch.where(pos, p, ~p)

    t = torch.nan_to_num(((A * ryf + c) - bias) / B, nan=0.0,
                         posinf=2.0**30, neginf=-2.0**30)
    t = torch.clamp(t, -2.0**30, 2.0**30)
    g = torch.where(pos, torch.ceil(t), torch.floor(t) + 1.0)
    g = torch.minimum(torch.clamp_min(g, 0.0).to(torch.int64), bw)
    lo, hi = torch.zeros_like(bw), bw.clone()
    probe = g > 0
    v = before(torch.where(probe, g - 1, 0))
    lo = torch.where(probe & v, g, lo)
    hi = torch.where(probe & ~v, g - 1, hi)
    probe = (g < bw) & (lo == g)
    v = before(torch.where(probe, g, 0))
    lo = torch.where(probe & v, g + 1, lo)
    hi = torch.where(probe & ~v, g, hi)
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi) // 2
        v = before(torch.where(active, mid, 0))
        lo = torch.where(active & v, mid + 1, lo)
        hi = torch.where(active & ~v, mid, hi)
    return lo


def row_intervals_plain(records):
    """The span kernel's row intervals: for every bbox row of every live
    (M, 32) record, (rec, ry, lo, hi), each (R,) int64 — the record's
    index, the row's offset from the bbox-min row, and the inclusive range
    of column offsets whose pixels pass all three edge tests (lo > hi when
    none does). A record with an edge word that is not finite or is at
    least EDGE_LIMIT in magnitude gets its whole bbox (0, bw - 1) in every
    row, as the kernel scans it whole."""
    dev = records.device
    live = torch.nonzero(records[:, 28] != 0.0).squeeze(1)
    r = records[live]
    bw = (r[:, 26] - r[:, 24]).to(torch.int64) + 1
    bh = (r[:, 27] - r[:, 25]).to(torch.int64) + 1
    rows = torch.repeat_interleave(torch.arange(r.shape[0], device=dev), bh)
    first = torch.cumsum(bh, 0) - bh
    ry = torch.arange(rows.shape[0], device=dev) \
        - torch.repeat_interleave(first, bh)
    rr, width = r[rows], bw[rows]
    words = torch.cat([rr[:, :9], rr[:, 29:32]], dim=1)
    scan = ~(torch.isfinite(words) & (words.abs() < EDGE_LIMIT)).all(dim=1)
    lo, hi = torch.zeros_like(width), width - 1
    ryf = ry.to(torch.float32)
    for k in range(3):
        A, B, c = rr[:, 3 * k], rr[:, 3 * k + 1], rr[:, 3 * k + 2]
        bias = rr[:, 29 + k]
        b = _boundary(A, B, c, bias, ry, width)
        flat = _edge_passes(A, B, c, bias, ryf, torch.zeros_like(width))
        lo_k = torch.where(B < 0.0, b, torch.zeros_like(b))
        hi_k = torch.where(B > 0.0, b - 1, torch.where(
            B < 0.0, width - 1, torch.where(flat, width - 1, -1)))
        lo, hi = torch.maximum(lo, lo_k), torch.minimum(hi, hi_k)
    lo = torch.where(scan, torch.zeros_like(lo), lo)
    hi = torch.where(scan, width - 1, hi)
    return live[rows], ry, lo, hi


def span_grid_warps(m: int, sms: int,
                    blocks_per_sm: int = SPAN_BLOCKS_PER_SM) -> int:
    """The span kernel's warps for a buffer of m records on a card of
    `sms` SMs (csrc/raster.cu planet_raster_span): a warp a record, in
    128-thread blocks, up to blocks_per_sm blocks an SM (0: no cap)."""
    one_a_record = -(-m * 32 // 128)
    cap = blocks_per_sm * sms
    blocks = one_a_record if blocks_per_sm == 0 or one_a_record < cap \
        else cap
    return 4 * blocks


def _chunk_slots(key, length, per_pass: int):
    """Over the groups of equal `key`: (the groups, the lane slots their
    lengths take at per_pass items a pass, each group's last pass
    rounded up)."""
    groups, inv = torch.unique(key, return_inverse=True)
    items = torch.zeros(groups.numel(), dtype=torch.int64,
                        device=key.device).index_add_(0, inv, length)
    return groups.numel(), int((-(-items // per_pass)).sum()) * per_pass


def span_batch_stats(records, warps: int) -> dict:
    """How the span kernel spreads its lanes over (M, 32) records drawn by
    a grid of `warps` warps (span_grid_warps), from the records alone.
    Warp w takes records w, w + warps, ... up to 32 at a time, a batch;
    a pass of the row phase takes 32 rows (a lane a row) and an iteration
    of the pixel phase 64 inside pixels of those rows (two a lane).
    Returns {"batches", "records_mean", "records_most": records a batch,
    dead ones too; "rows_mean", "pixels_mean": the live records' bbox rows
    and inside pixels (row_intervals_plain) a batch; "row_busy",
    "pixel_busy": {"record": ..., "batch": ...}, the share of lane slots
    holding a row or a pixel when a warp takes one record at a time (its
    rows 32 a pass) and when it takes a batch at a time (the batch's rows
    flattened, 32 a pass)}. A record scanned whole counts its whole rows,
    as the kernel scans them."""
    m = records.shape[0]
    dev = records.device
    idx = torch.arange(m, device=dev)
    batch = (idx // warps // 32) * warps + idx % warps
    sizes = torch.unique(batch, return_counts=True)[1]
    rec, ry, lo, hi = row_intervals_plain(records)
    length = (hi - lo + 1).clamp_min(0)
    # a warp a record: each record's rows 32 a pass
    rows_key = rec * 2**20 + ry // 32
    passes, pix_record = _chunk_slots(rows_key, length, 64)
    row_record = 32 * passes
    # a batch: its rows in slot order, 32 a pass
    b = batch[rec]
    order = torch.sort(b, stable=True)[1]
    b, length_b = b[order], length[order]
    first = torch.searchsorted(b, b)
    passes, pix_batch = _chunk_slots(
        b * 2**20 + (torch.arange(b.numel(), device=dev) - first) // 32,
        length_b, 64)
    row_batch = 32 * passes
    n_rows, n_pix = rec.numel(), int(length.sum())
    n = sizes.numel()

    def share(busy, slots):
        return busy / slots if slots else 0.0

    return dict(batches=n, records_mean=m / n if n else 0.0,
                records_most=int(sizes.max()) if n else 0,
                rows_mean=n_rows / n if n else 0.0,
                pixels_mean=n_pix / n if n else 0.0,
                row_busy=dict(record=share(n_rows, row_record),
                              batch=share(n_rows, row_batch)),
                pixel_busy=dict(record=share(n_pix, pix_record),
                                batch=share(n_pix, pix_batch)))


def _raster_cuda(kernel, symbol, records, fb, wireframe, count, *extra):
    m = records.shape[0]
    _cuda.check_cuda(records, "records", torch.float32, (m, 32))
    _cuda.check_cuda(fb, "fb", torch.int32)
    if fb.dim() != 2:
        raise ValueError(f"fb must be (H, W), got {tuple(fb.shape)}")
    if count is not None:
        _cuda.check_cuda(count, "count", torch.int32, (1,))
        if count.device != records.device:
            raise ValueError("count: expected the records' device")
    if m:
        height, width = fb.shape
        _cuda.launch(kernel, symbol, records.data_ptr(),
                     None if count is None else count.data_ptr(), m,
                     fb.data_ptr(), width, height, int(bool(wireframe)),
                     *extra)
    return fb


def _check_aligned(records):
    if records.data_ptr() % 16:
        raise ValueError("records: the raster kernels read 16-byte aligned "
                         "rows")


def raster_span_cuda(records, fb, wireframe: bool = False,
                     blocks_per_sm: int = SPAN_BLOCKS_PER_SM, count=None):
    _check_aligned(records)
    if blocks_per_sm < 0:
        raise ValueError(f"blocks_per_sm {blocks_per_sm} < 0")
    return _raster_cuda("span", "planet_raster_span", records, fb, wireframe,
                        count, int(blocks_per_sm))


def raster_huge_cuda(records, fb, wireframe: bool = False, count=None):
    _check_aligned(records)
    return _raster_cuda("huge", "planet_raster_huge", records, fb, wireframe,
                        count)


def raster_span(records, fb, wireframe: bool = False, count=None):
    if _device_kind(records) == "cuda":
        return raster_span_cuda(records, fb, wireframe, count=count)
    return raster_span_plain(records, fb, wireframe, count)


def raster_huge(records, fb, wireframe: bool = False, count=None):
    if _device_kind(records) == "cuda":
        return raster_huge_cuda(records, fb, wireframe, count=count)
    return raster_huge_plain(records, fb, wireframe, count)


# ---------------------------------------------------------------- driver

def raster_classes(span_recs, huge_recs, counts, fb, wireframe=False):
    """The routed part of raster_frame on K6's outputs: K2 on the span
    class and K3 on the huge class, min-merged into fb. On the card they
    are queued with no host read: the kernels read the class counts on
    the device. Returns the counts."""
    raster_span(span_recs, fb, wireframe, count=counts[0:1])
    raster_huge(huge_recs, fb, wireframe, count=counts[1:2])
    return counts


def clip_records_plain(clip, normal, s_idx, width: int, height: int,
                       far_w=None):
    """The live clipped triangles of the slots' candidates s_idx (K,) (N
    for an empty slot) as (M, 32) row records in (slot, A, B) order, and M
    as a (1,) int32 tensor."""
    tclip = nearclip.clipped_tris(clip, normal, s_idx.long(), width, height,
                                  far_w=far_w)
    k = s_idx.shape[0]
    order = torch.arange(2 * k, device=clip.device).view(2, k).T.reshape(-1)
    live = tclip.live[order]
    recs = nearclip.records_from_tris(tclip)[order][live]
    return recs, live.sum(dtype=torch.int32).reshape(1)


def clip_pass_plain(clip, normal, straddle, width: int, height: int,
                    far_w=None, clip_cap: int = CLIP_CAP):
    """C2's plain version: compact_indices on the mask (no block counts),
    then clip_records_plain."""
    s_idx, n_straddle = compact_indices(straddle, clip_cap)
    recs, count = clip_records_plain(clip, normal, s_idx, width, height,
                                     far_w)
    return s_idx, n_straddle, recs, count


def clip_pass_cuda(clip, normal, straddle, blocks, width: int, height: int,
                   far_w=None, clip_cap: int = CLIP_CAP):
    q, g = clip.shape[0], clip.shape[1]
    n = 2 * q * g * g
    clip, normal = clip.contiguous(), normal.contiguous()
    _cuda.check_cuda(clip, "clip", torch.float32, (q, g, g, 4))
    _cuda.check_cuda(normal, "normal", torch.float32, (q, g, g, 3))
    _cuda.check_cuda(straddle, "straddle", torch.bool, (n,))
    _cuda.check_cuda(blocks, "blocks", torch.int32, (-(-n // SETUP_BLOCK),))
    if not q or straddle.device != clip.device or \
            blocks.device != clip.device:
        raise ValueError("clip pass: at least one patch, and the straddler "
                         "mask and counts on the vertices' device")
    if clip.data_ptr() % 16 or straddle.data_ptr() % 16:
        raise ValueError("clip pass: the kernel reads 16-byte aligned "
                         "vertices and straddler mask")
    if not 0 <= clip_cap or n >= 2**31:
        raise ValueError(f"clip_cap {clip_cap}, {n} candidates: expected a "
                         f"cap >= 0 and fewer than 2^31 candidates")
    far = _far(far_w)
    dev = clip.device
    s_idx = torch.empty(clip_cap, dtype=torch.int32, device=dev)
    n_straddle = torch.empty(1, dtype=torch.int32, device=dev)
    recs = torch.empty((2 * clip_cap, 32), dtype=torch.float32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    _cuda.launch("clip", "planet_clip_records", clip.data_ptr(),
                 normal.data_ptr(), straddle.data_ptr(), blocks.data_ptr(),
                 clip_cap, q, g, int(width), int(height), *far,
                 s_idx.data_ptr(), n_straddle.data_ptr(), recs.data_ptr(),
                 count.data_ptr())
    return s_idx, n_straddle[0], recs, count


def clip_pass(clip, normal, straddle, blocks, width: int, height: int,
              far_w=None, clip_cap: int = CLIP_CAP):
    """The near-plane clip pass at a fixed size: the first clip_cap
    straddlers of the mask in candidate order (N in the empty slots), the
    number of all the straddlers, and the live parts of the used slots'
    clipped triangles as row records in (slot, A, B) order, the first
    count[0] rows of the records (an empty slot clips nothing). `blocks`
    is C1's output: the kernel's block counts on the card, None on the
    CPU."""
    if _device_kind(clip) == "cuda":
        return clip_pass_cuda(clip, normal, straddle, blocks, width, height,
                              far_w, clip_cap)
    return clip_pass_plain(clip, normal, straddle, width, height, far_w,
                           clip_cap)


def raster_frame(clip, normal, valid, width: int, height: int, *,
                 cell_mask=None, background: float = 0.0,
                 decode: bool = True, wireframe: bool = False, far_w=None,
                 clip_cap: int = CLIP_CAP, count=None):
    """Rasterize tessellated patches with exact triangle coverage.

    clip (Q, G, G, 4) f32, normal (Q, G, G, 3) f32, valid (Q, G, G) bool,
    all on one device; count: None, or a (1,) int32 tensor on that device
    holding the live patch rows (the rows past it are padding, invalid;
    the setup skips them on the card). Returns (image (H, W) f32, depth
    (H, W) f32 NDC z with +inf empties, RasterCounters), or (packed (H, W)
    int32, counters) with decode=False. Reads nothing back to the host;
    the counters stay on the device."""
    if _device_kind(clip) == "cuda":
        # C1 writes K6's route: the scan follows it with nothing between
        tm, route, straddle, blocks = setup_cuda(
            clip, normal, valid, width, height, cell_mask, far_w, count)
        classes = route_records_cuda(tm, route)
    else:
        tm, live, span, straddle, blocks = setup_plain(
            clip, normal, valid, width, height, cell_mask, far_w, count)
        classes = route_records_plain(tm, live, span)
    fb = torch.full((height, width), cov._EMPTY, dtype=torch.int32,
                    device=clip.device)
    counts = raster_classes(*classes, fb, wireframe)

    if straddle.numel():
        _, n_straddle, recs, n_recs = clip_pass(
            clip, normal, straddle, blocks, width, height, far_w, clip_cap)
        raster_huge(recs, fb, wireframe, count=n_recs)
    else:
        n_straddle = torch.zeros((), dtype=torch.int32, device=fb.device)

    counters = cov.RasterCounters(
        n_tris=counts.sum(dtype=torch.int32), n_per_class=counts,
        n_huge=counts[1], overflowed=n_straddle > clip_cap,
        n_straddle=n_straddle)
    if not decode:
        return fb, counters
    image, depth = cov.decode_packed(fb, background)
    return image, depth, counters
