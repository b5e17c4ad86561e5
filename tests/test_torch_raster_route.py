"""The raster's route on the CPU: K6's plain version, the huge class's row
intervals, and raster_frame with the class counts kept as a tensor.

K6 (csrc/raster.cu route_offsets_kernel and route_scatter_kernel, on the
class masks and counts that C1, csrc/setup.cu setup_kernel, writes)
routes and gathers and leaves the counts on the device, so that K2 and K3
read them there. Its plain version, coverage_cuda.route_records_plain, is
today's route and gather_records_plain with the counts as a tensor; these
tests hold it

* to route + gather_records_plain and to a numpy statement of the route
  (span class: live, at most MAX_SPAN_BLOCKS aligned 8-row blocks, not a
  far-straddler; huge class: the other live records; candidate order), on
  synthetic candidates (dead, far-straddler, tall and span-class ones,
  all dead, all huge, all span, every one live, none) and on the test
  scenes' and the three goldens' setup_t;
* the route's words as C1 writes them, coverage_cuda.route_masks_plain:
  its mask words hold route()'s span and huge indices, and its counts
  each block's, on the same candidates and scenes;
* K3 (the huge kernel) visits only each bbox row's exact interval, as K2
  does: row_intervals_plain equals a scan of every pixel on the huge
  class's records, far-straddlers and clipped near-plane triangles apart;
* raster_frame, which now queues route -> K2 -> K3 with the counts as a
  tensor and reads them once after, draws the packed framebuffer and the
  counters of the composition it replaces (route, two gathers sized on the
  host, K2 and K3 on exact record sets) bit for bit, on the test scenes
  and the three goldens.
"""

import pathlib

import numpy as np
import pytest
import torch

from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import PlanetEngine
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.raster import coverage as cov
from planet_tpu_torch.raster import coverage_cuda as cc
from planet_tpu_torch.raster import nearclip
from planet_tpu_torch.tess import mesh
from torch_scenes import (SCREEN, VIEW, counter_values, screen_scene,
                                view_scene)

torch.set_num_threads(1)
GOLD = pathlib.Path(__file__).parent / "goldens"
GOLDENS = ("frame", "nearclip", "farclip")
SYNTHETIC = ("mixed", "all dead", "all huge", "all span", "every live",
             "none", "one candidate")


def _synthetic(case, n=3000, seed=5):
    """(tm (32, n), live, span): random records among which dead
    candidates (some with NaN words), far-straddlers (row 28 = 1/far),
    tall ones (span > MAX_SPAN_BLOCKS) and span-class ones."""
    n = {"none": 0, "one candidate": 1}.get(case, n)
    rng = np.random.default_rng(seed)
    tm = rng.normal(size=(32, n)).astype(np.float32)
    live = rng.uniform(size=n) < 0.3
    far = rng.uniform(size=n) < 0.1
    tm[28] = np.where(live, np.where(far, 1.0 / 40.0, -1.0), 0.0)
    tm[:, ~live & (rng.uniform(size=n) < 0.2)] = np.nan
    span = rng.integers(1, 24, n).astype(np.int32)
    if case == "all dead":
        live[:] = False
    elif case == "all huge":
        span[:] = cc.MAX_SPAN_BLOCKS + 1
    elif case == "all span":
        tm[28] = np.where(live, -1.0, 0.0)
        span[:] = 1
    elif case in ("every live", "one candidate"):
        live[:] = True
    return torch.from_numpy(tm), torch.from_numpy(live), torch.from_numpy(span)


def _route_np(tm, live, span):
    """The route stated in numpy: (span-class columns, huge-class columns)
    in candidate order."""
    tm, live, span = tm.numpy(), live.numpy(), span.numpy()
    far = tm[28] > 0.0
    is_span = live & (span <= cc.MAX_SPAN_BLOCKS) & ~far
    is_huge = live & ~is_span
    return np.flatnonzero(is_span), np.flatnonzero(is_huge)


def _assert_route(tm, live, span):
    got_s, got_h, counts = cc.route_records_plain(tm, live, span)
    s_idx, h_idx = cc.route(tm, live, span)
    want_s, want_h = _route_np(tm, live, span)
    assert counts.dtype == torch.int32 and counts.shape == (2,)
    assert counts.tolist() == [len(want_s), len(want_h)]
    assert torch.equal(got_s.view(torch.int32),
                       cc.gather_records_plain(tm, s_idx).view(torch.int32))
    assert torch.equal(got_h.view(torch.int32),
                       cc.gather_records_plain(tm, h_idx).view(torch.int32))
    tm_np = tm.numpy().view(np.int32)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  tm_np[:, want_s].T)
    np.testing.assert_array_equal(got_h.numpy().view(np.int32),
                                  tm_np[:, want_h].T)
    return counts


@pytest.mark.parametrize("case", SYNTHETIC)
def test_route_records_plain_is_route_and_gather(case):
    counts = _assert_route(*_synthetic(case))
    if case == "mixed":
        assert min(counts.tolist()) > 0
    if case == "all dead":
        assert counts.tolist() == [0, 0]
    if case == "all huge":
        assert counts[0] == 0 and counts[1] > 0
    if case == "all span":
        assert counts[0] > 0 and counts[1] == 0


def _mask_indices(route, n):
    """(span-class, huge-class) candidate indices, int64, and the (blocks,
    2) count pairs read from the route's words (route_masks_plain's
    layout: two mask words a 32 candidates, then two counts a block)."""
    blocks = -(-n // cc.ROUTE_TILE)
    words = route[:blocks * cc.ROUTE_TILE // 16].view(-1, 2).to(torch.int64)
    bits = (words[:, None, :] >> torch.arange(32)[None, :, None]) & 1
    flat = bits.reshape(-1, 2).bool()
    pairs = route[blocks * cc.ROUTE_TILE // 16:].view(blocks, 2)
    return (torch.nonzero(flat[:, 0]).squeeze(1),
            torch.nonzero(flat[:, 1]).squeeze(1), pairs)


def _assert_route_masks(tm, live, span):
    """route_masks_plain's words: route()'s indices in the masks (none past
    the candidates), each block's class counts in its pair."""
    n = live.shape[0]
    route = cc.route_masks_plain(tm, live, span)
    assert route.dtype == torch.int32
    assert route.shape == (cc.route_scratch_ints(n),)
    got_s, got_h, pairs = _mask_indices(route, n)
    s_idx, h_idx = cc.route(tm, live, span)
    assert torch.equal(got_s, s_idx.long()) and torch.equal(got_h,
                                                              h_idx.long())
    for c, idx in enumerate((s_idx, h_idx)):
        want = torch.bincount(idx.long() // cc.ROUTE_TILE,
                              minlength=pairs.shape[0])
        assert pairs[:, c].tolist() == want.tolist()
    return pairs


@pytest.mark.parametrize("case", SYNTHETIC)
def test_route_masks_plain_hold_the_route(case):
    """The route as C1 writes it for K6 (route_masks_plain) on the
    synthetic candidates: 3,000 of them (a partial last block), one, none,
    and every class mix."""
    pairs = _assert_route_masks(*_synthetic(case))
    assert pairs.shape[0] == -(-{"none": 0, "one candidate": 1}.get(
        case, 3000) // cc.ROUTE_TILE)


def _golden_frame(name):
    """(clip, normal, valid, cfg, cell_mask) of a golden scene's
    PlanetEngine frame on the CPU."""
    cfg = EngineConfig()
    cam = cam_mod.Camera(position=np.load(GOLD / f"{name}_cam.npy"),
                         angles=np.load(GOLD / f"{name}_angles.npy"))
    fr = PlanetEngine(cfg, device="cpu").frame(cam)
    gm = mesh.grid_uv_skirt(cfg.patch_verts)[3]
    valid = torch.as_tensor(np.broadcast_to(
        gm[None], (fr.n_leaves,) + gm.shape).copy())
    return (fr.vertices.clip, fr.vertices.normal, valid, cfg,
            mesh.cell_triangle_mask(cfg.patch_verts))


@pytest.fixture(scope="module")
def scenes():
    """name -> (clip, normal, valid, width, height, far_w, cell_mask)."""
    out = {}
    w, h = SCREEN["width"], SCREEN["height"]
    out["screen"] = tuple(torch.as_tensor(a) for a in screen_scene(
        11, w, h, SCREEN["sizes"])) + (w, h, None, None)
    w, h = VIEW["width"], VIEW["height"]
    out["view"] = tuple(torch.as_tensor(a) for a in view_scene(
        VIEW["seed"], w, h, VIEW["far"])) + (w, h, VIEW["far"], None)
    for name in GOLDENS:
        clip, normal, valid, cfg, cell_mask = _golden_frame(name)
        out[name] = (clip, normal, valid, cfg.window_w, cfg.window_h,
                     cfg.far_plane, cell_mask)
    return out


def _setup(scene):
    clip, normal, valid, w, h, far, cell_mask = scene
    return cov.setup_t(clip, normal, valid, w, h, cell_mask, far_w=far)


@pytest.mark.parametrize("name", ("screen", "view") + GOLDENS)
def test_route_records_plain_on_the_scenes(scenes, name):
    tm, live, span = _setup(scenes[name])
    counts = _assert_route(tm, live, span)
    assert int(counts.sum()) == int(live.sum())
    if name in ("view", "farclip"):
        far = (tm[28] > 0.0) & live
        assert int(far.sum()) > 0 and int(counts[1]) >= int(far.sum())


@pytest.mark.parametrize("name", ("screen", "view") + GOLDENS)
def test_route_masks_plain_on_the_scenes(scenes, name):
    """route_masks_plain on the test scenes' and the goldens' setup_t
    (the screen scene's 976 candidates end in a partial block): route()'s
    span and huge indices, and every block's counts."""
    tm, live, span = _setup(scenes[name])
    pairs = _assert_route_masks(tm, live, span)
    assert int(pairs.sum()) == int(live.sum()) > 0


def _huge_sets(scene):
    """{kind: (M, 32) huge-kernel records} of a scene: the huge class's
    far-straddlers, its tall records, and the clipped near-plane
    straddlers' live triangles."""
    clip, normal, valid, w, h, far, cell_mask = scene
    tm, live, span = cov.setup_t(clip, normal, valid, w, h, cell_mask,
                                 far_w=far)
    huge = cc.route_records_plain(tm, live, span)[1]
    smask = nearclip.straddle_mask_t(clip, valid, cell_mask)
    tcl = nearclip.clipped_tris(clip, normal, torch.nonzero(smask).squeeze(1),
                                w, h, far_w=far)
    return {"far-straddlers": huge[huge[:, 28] > 0.0],
            "tall": huge[huge[:, 28] < 0.0],
            "clipped near": nearclip.records_from_tris(tcl)[tcl.live]}


def _scan_intervals(records):
    """Per bbox row of every live record: (record, row offset, first and
    last column passing all three edge tests — lo > hi where none does),
    from fragment()'s edge test at every pixel of the row."""
    live = torch.nonzero(records[:, 28] != 0.0).squeeze(1)
    r = records[live]
    bw = (r[:, 26] - r[:, 24]).long() + 1
    bh = (r[:, 27] - r[:, 25]).long() + 1
    rec = torch.repeat_interleave(torch.arange(len(r)), bh)
    ry = torch.arange(len(rec)) - torch.repeat_interleave(
        torch.cumsum(bh, 0) - bh, bh)
    rbw = bw[rec]
    row = torch.repeat_interleave(torch.arange(len(rec)), rbw)
    rx = torch.arange(len(row)) - torch.repeat_interleave(
        torch.cumsum(rbw, 0) - rbw, rbw)
    rr = r[rec[row]]
    ok = torch.ones_like(rx, dtype=torch.bool)
    for k in range(3):
        e = (rr[:, 3 * k] * ry[row].float() - rr[:, 3 * k + 1] * rx.float()) \
            + rr[:, 3 * k + 2]
        ok &= e > rr[:, 29 + k]
    n_rows = len(rec)
    first = torch.full((n_rows,), 1 << 40, dtype=torch.int64).scatter_reduce(
        0, row[ok], rx[ok], "amin")
    last = torch.full((n_rows,), -1, dtype=torch.int64).scatter_reduce(
        0, row[ok], rx[ok], "amax")
    cnt = torch.zeros(n_rows, dtype=torch.int64).index_add_(0, row,
                                                            ok.long())
    return live[rec], ry, first, last, cnt


# the scenes' huge-kernel record sets (the frame golden has none)
HUGE_SETS = [("screen", "tall"), ("view", "far-straddlers"),
             ("view", "clipped near"), ("nearclip", "tall"),
             ("nearclip", "clipped near"), ("farclip", "far-straddlers")]


@pytest.mark.parametrize("name,kind", HUGE_SETS)
def test_huge_row_intervals_are_a_scan_of_every_pixel(scenes, name, kind):
    """K3's row intervals on the huge class's records equal the passing
    columns of each row found by testing every pixel; the pixels inside
    them give the bbox scan's framebuffer bit for bit with the huge
    kernel's 1/w tests."""
    records = _huge_sets(scenes[name])[kind]
    assert len(records) > 0
    rec, ry, lo, hi = cc.row_intervals_plain(records)
    rec_s, ry_s, first, last, cnt = _scan_intervals(records)
    assert torch.equal(rec, rec_s) and torch.equal(ry, ry_s)
    some = cnt > 0
    assert torch.equal(lo[some], first[some])
    assert torch.equal(hi[some], last[some])
    assert torch.equal((hi - lo + 1)[some], cnt[some])
    assert bool((lo > hi)[~some].all())
    width, height = scenes[name][3], scenes[name][4]
    want = cc.raster_huge_plain(records, torch.full(
        (height, width), cov._EMPTY, dtype=torch.int32))
    n = (hi - lo + 1).clamp_min(0)
    row = torch.repeat_interleave(torch.arange(len(rec)), n)
    rx = lo[row] + torch.arange(len(row)) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    r, y = records[rec[row]], ry[row]
    got = torch.full((height, width), cov._EMPTY, dtype=torch.int32)
    cov._merge(got.view(-1), r, r[:, 24].long() + rx, r[:, 25].long() + y,
               rx.float(), y.float(), width, True, False)
    assert torch.equal(got, want)


def _old_raster_frame(clip, normal, valid, width, height, cell_mask, far_w,
                      wireframe):
    """raster_frame before the route kept its counts on the device: the
    route's index sets sized on the host, a gather each, K2 and K3 on the
    exact record sets, then the clipped straddlers."""
    tm, live, span = cov.setup_t(clip, normal, valid, width, height,
                                 cell_mask, far_w=far_w)
    span_idx, huge_idx = cc.route(tm, live, span)
    fb = torch.full((height, width), cov._EMPTY, dtype=torch.int32)
    if span_idx.numel():
        cc.raster_span_plain(cc.gather_records_plain(tm, span_idx), fb,
                             wireframe)
    if huge_idx.numel():
        cc.raster_huge_plain(cc.gather_records_plain(tm, huge_idx), fb,
                             wireframe)
    smask = nearclip.straddle_mask_t(clip, valid, cell_mask)
    s_idx = torch.nonzero(smask).squeeze(1)
    if s_idx.numel():
        tclip = nearclip.clipped_tris(clip, normal, s_idx, width, height,
                                      far_w=far_w)
        recs = nearclip.records_from_tris(tclip)[tclip.live].contiguous()
        if recs.shape[0]:
            cc.raster_huge_plain(recs, fb, wireframe)
    n_span, n_huge = int(span_idx.numel()), int(huge_idx.numel())
    return fb, cov.RasterCounters(
        n_tris=n_span + n_huge, n_per_class=(n_span, n_huge), n_huge=n_huge,
        overflowed=False, n_straddle=int(s_idx.numel()))


@pytest.mark.parametrize("wireframe", [False, True])
@pytest.mark.parametrize("name", ("screen", "view") + GOLDENS)
def test_raster_frame_with_tensor_counts_equals_the_old_composition(
        scenes, name, wireframe):
    clip, normal, valid, w, h, far, cell_mask = scenes[name]
    got, counters = cc.raster_frame(clip, normal, valid, w, h,
                                    cell_mask=cell_mask, decode=False,
                                    wireframe=wireframe, far_w=far)
    want, want_counters = _old_raster_frame(clip, normal, valid, w, h,
                                            cell_mask, far, wireframe)
    assert torch.equal(got, want)
    assert counter_values(counters) == want_counters
    assert int((want != cov._EMPTY).sum()) > 0
    if name in ("nearclip", "farclip", "view"):
        assert counters.n_huge > 0 or counters.n_straddle > 0
