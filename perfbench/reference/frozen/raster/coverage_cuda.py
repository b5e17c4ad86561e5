"""The exact raster's plain versions, in the order the port's kernels
run them: the triangle setup (C1: coverage.setup_t and
nearclip.straddle_mask_t), the route and gather (K6), the span and huge
fragments (K2, K3: coverage.fragments), the near-plane clip pass (C2),
and `raster_frame`, which composes them as planet_tpu's
raster_frame_pallas does.

Routing: a live record whose bbox touches at most MAX_SPAN_BLOCKS aligned
8-row blocks and that is not a far-straddler goes to the span class,
every other live record to the huge class; near-plane straddlers are
clipped (raster/nearclip.py) and their live parts drawn with the huge
class's test. More straddlers than clip_cap set `overflowed`. With
`count` (the live patch rows, a (1,) int32 tensor) the rows past it are
dead.
"""

from __future__ import annotations

import functools

import torch

from perfbench.reference.frozen.raster import coverage as cov
from perfbench.reference.frozen.raster import nearclip

MAX_SPAN_BLOCKS = 16     # aligned 8-row blocks a span-kernel bbox may touch
# near-plane straddler slots (planet_tpu coverage.raster_frame's clip_cap)
CLIP_CAP = 512


# ------------------------------------------------------------------- C1

def _count_rows(x, q: int, g: int, count):
    """(N,) bool: candidates whose patch row is below `count` ((1,) int32
    on x's device), in setup_t's candidate order."""
    rows = torch.arange(q, dtype=torch.int32, device=x.device) < count
    return rows[None, :, None].expand(2, q, g * g).reshape(-1)


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

def route(tm, live, span):
    """(span-kernel indices, huge-kernel indices), int32, in candidate
    order: span-class records are live, touch at most MAX_SPAN_BLOCKS
    aligned 8-row blocks and are not far-straddlers (row 28 > 0)."""
    eligible = live & (span <= MAX_SPAN_BLOCKS) & ~(tm[28] > 0.0)
    span_idx = torch.nonzero(eligible).squeeze(1).to(torch.int32)
    huge_idx = torch.nonzero(live & ~eligible).squeeze(1).to(torch.int32)
    return span_idx, huge_idx


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


# ---------------------------------------------------------------- driver

def raster_routed(tm, live, span, fb, wireframe: bool = False):
    """The routed part of raster_frame on setup_t's outputs: K6 (route and
    gather), K2 on the span class, K3 on the huge class, min-merged into
    fb. Returns the counts, (2,) int32 on fb's device."""
    span_recs, huge_recs, counts = route_records_plain(tm, live, span)
    raster_span_plain(span_recs, fb, wireframe, count=counts[0:1])
    raster_huge_plain(huge_recs, fb, wireframe, count=counts[1:2])
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
    tm, live, span, straddle, _ = setup_plain(
        clip, normal, valid, width, height, cell_mask, far_w, count)
    fb = torch.full((height, width), cov._EMPTY, dtype=torch.int32,
                    device=clip.device)
    counts = raster_routed(tm, live, span, fb, wireframe)

    if straddle.numel():
        _, n_straddle, recs, n_recs = clip_pass_plain(
            clip, normal, straddle, width, height, far_w, clip_cap)
        raster_huge_plain(recs, fb, wireframe, count=n_recs)
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
