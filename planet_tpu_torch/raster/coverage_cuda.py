"""The exact raster's fragment path on CUDA: record gather (K6), span
kernel (K2), huge kernel (K3), and the `raster_frame` driver that routes
triangle records to them (planet_tpu raster/coverage_pallas.py's
raster_frame_pallas, without its TPU-only machinery).

Each kernel wrapper takes a CUDA tensor and launches its kernel
(csrc/raster.cu) or raises; given a CPU tensor it runs the plain PyTorch
version beside it, which has the same signature:

* gather_records(tm (32, N) f32, idx (M,) int32) -> (M, 32) row records;
  an index outside [0, N) gives an all-zero (dead) record;
* raster_span(records (M, 32), fb (H, W) int32) — fragments without the
  interpolated-1/w test (vacuous inside the exact coverage domain);
* raster_huge(records (M, 32), fb) — the same fragment math plus
  iw > 0 and iw > row 28 (the view-space far clip).

Both raster wrappers min-merge into `fb` in place and return it.

Routing (coverage_pallas.raster_frame_pallas): a live record whose bbox
touches at most 16 aligned 8-row blocks and that is not a far-straddler
goes to the span kernel, with no bound on width; every other live record
goes to the huge kernel; near-plane straddlers are clipped
(raster/nearclip.py) and their live parts go to the huge kernel too.
Records are compacted to exactly the live ones, so there are no class
caps and nothing can overflow.
"""

from __future__ import annotations

import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.raster import coverage as cov
from planet_tpu_torch.raster import nearclip

MAX_SPAN_BLOCKS = 16     # aligned 8-row blocks a span-kernel bbox may touch


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


# ------------------------------------------------------------------- K6

def gather_records_plain(tm, idx):
    n = tm.shape[1]
    ok = (idx >= 0) & (idx < n)
    safe = torch.where(ok, idx, torch.zeros_like(idx)).long()
    out = tm[:, safe].T
    return torch.where(ok[:, None], out, torch.zeros_like(out)).contiguous()


def gather_records_cuda(tm, idx):
    m, n = idx.shape[0], tm.shape[1]
    _cuda.check_cuda(tm, "tm", torch.float32, (32, n))
    _cuda.check_cuda(idx, "idx", torch.int32, (m,))
    out = torch.empty((m, 32), dtype=torch.float32, device=tm.device)
    if m:
        _cuda.launch("gather", "planet_gather_records", tm.data_ptr(),
                     idx.data_ptr(), out.data_ptr(), m, n)
    return out


def gather_records(tm, idx):
    if _device_kind(tm) == "cuda":
        return gather_records_cuda(tm, idx)
    return gather_records_plain(tm, idx)


# ---------------------------------------------------------------- K2, K3

def raster_span_plain(records, fb, wireframe: bool = False):
    return cov.fragments(records, fb, iw_test=False, wireframe=wireframe)


def raster_huge_plain(records, fb, wireframe: bool = False):
    return cov.fragments(records, fb, iw_test=True, wireframe=wireframe)


def _raster_cuda(kernel, symbol, records, fb, wireframe):
    m = records.shape[0]
    _cuda.check_cuda(records, "records", torch.float32, (m, 32))
    _cuda.check_cuda(fb, "fb", torch.int32)
    if fb.dim() != 2:
        raise ValueError(f"fb must be (H, W), got {tuple(fb.shape)}")
    if m:
        height, width = fb.shape
        _cuda.launch(kernel, symbol, records.data_ptr(), m, fb.data_ptr(),
                     width, height, int(bool(wireframe)))
    return fb


def raster_span_cuda(records, fb, wireframe: bool = False):
    return _raster_cuda("span", "planet_raster_span", records, fb, wireframe)


def raster_huge_cuda(records, fb, wireframe: bool = False):
    return _raster_cuda("huge", "planet_raster_huge", records, fb, wireframe)


def raster_span(records, fb, wireframe: bool = False):
    if _device_kind(records) == "cuda":
        return raster_span_cuda(records, fb, wireframe)
    return raster_span_plain(records, fb, wireframe)


def raster_huge(records, fb, wireframe: bool = False):
    if _device_kind(records) == "cuda":
        return raster_huge_cuda(records, fb, wireframe)
    return raster_huge_plain(records, fb, wireframe)


# ---------------------------------------------------------------- driver

def route(tm, live, span):
    """(span-kernel indices, huge-kernel indices), int32, in candidate
    order: span-class records are live, touch at most MAX_SPAN_BLOCKS
    aligned 8-row blocks and are not far-straddlers (row 28 > 0)."""
    eligible = live & (span <= MAX_SPAN_BLOCKS) & ~(tm[28] > 0.0)
    span_idx = torch.nonzero(eligible).squeeze(1).to(torch.int32)
    huge_idx = torch.nonzero(live & ~eligible).squeeze(1).to(torch.int32)
    return span_idx, huge_idx


def raster_frame(clip, normal, valid, width: int, height: int, *,
                 cell_mask=None, background: float = 0.0,
                 decode: bool = True, wireframe: bool = False, far_w=None):
    """Rasterize tessellated patches with exact triangle coverage.

    clip (Q, G, G, 4) f32, normal (Q, G, G, 3) f32, valid (Q, G, G) bool,
    all on one device. Returns (image (H, W) f32, depth (H, W) f32 NDC z
    with +inf empties, RasterCounters), or (packed (H, W) int32, counters)
    with decode=False."""
    tm, live, span = cov.setup_t(clip, normal, valid, width, height,
                                 cell_mask, far_w=far_w)
    span_idx, huge_idx = route(tm, live, span)
    fb = torch.full((height, width), cov._EMPTY, dtype=torch.int32,
                    device=clip.device)
    if span_idx.numel():
        raster_span(gather_records(tm, span_idx), fb, wireframe)
    if huge_idx.numel():
        raster_huge(gather_records(tm, huge_idx), fb, wireframe)

    smask = nearclip.straddle_mask_t(clip, valid, cell_mask)
    s_idx = torch.nonzero(smask).squeeze(1)
    if s_idx.numel():
        tclip = nearclip.clipped_tris(clip, normal, s_idx, width, height,
                                      far_w=far_w)
        recs = nearclip.records_from_tris(tclip)
        recs = recs[tclip.live].contiguous()
        if recs.shape[0]:
            raster_huge(recs, fb, wireframe)

    n_span, n_huge = int(span_idx.numel()), int(huge_idx.numel())
    counters = cov.RasterCounters(
        n_tris=n_span + n_huge, n_per_class=(n_span, n_huge), n_huge=n_huge,
        overflowed=False, n_straddle=int(s_idx.numel()))
    if not decode:
        return fb, counters
    image, depth = cov.decode_packed(fb, background)
    return image, depth, counters
