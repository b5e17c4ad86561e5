"""The span kernel's exact row intervals and K1's dead tiles, on the CPU.

The span kernel (csrc/raster.cu) visits only the pixels of each bbox row
that pass all three edge tests, found as one interval a row. That is exact
only because each edge's test is monotone along a row in f32; these tests
hold it on every row of the port's test scenes (tests/torch_scenes: the
screen and view scenes, the adversarial records, the pixel-sized records
with dead and scanned-whole ones among them) and of the three
goldens' records (span, huge and clipped near-plane straddlers):

* each edge's passing columns in a row are contiguous, a prefix of the row
  where DY > 0, a suffix where DY < 0, all or none where DY = 0;
* coverage_cuda.row_intervals_plain, the kernel's interval search in plain
  PyTorch, gives exactly the first and last column passing all three
  tests (lo > hi where none does), and the plain fragment math run only
  inside the intervals gives coverage.fragments' framebuffer bit for bit,
  with and without wireframe, for the span and the huge kernel's tests;
* tiles_plain writes exactly 0.0 * amplitude on tiles whose octave count
  is 0, whatever their corners hold, and the live tiles as alone;
* torch_scenes.nan_shade_records (records whose every fragment has a NaN
  shade, which the GPU tests hold K2 and K3 to bit for bit) pack every
  shade as 0, as planet_tpu converts NaN to int32, and are scanned whole;
* coverage_cuda.span_batch_stats, the span kernel's lane figure, counts
  the batches, rows, pixels and busy lane slots of hand-built records
  (each its whole bbox inside) as the kernel lays them out, and
  span_grid_warps gives the kernel's grid.
"""

import pathlib

import numpy as np
import pytest
import torch

from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import PlanetEngine
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.ops.kernels import tile_cuda
from planet_tpu_torch.raster import coverage as cov
from planet_tpu_torch.raster import coverage_cuda as cc
from planet_tpu_torch.raster import nearclip
from planet_tpu_torch.tess import mesh
from torch_scenes import (EDGE, PIXELS, SCREEN, VIEW, adversarial_records,
                          nan_shade_records, pixel_records, screen_scene,
                          view_scene)

torch.set_num_threads(1)
GOLD = pathlib.Path(__file__).parent / "goldens"
SCENES = ("screen", "view", "adversarial", "pixels", "frame", "nearclip",
          "farclip")


def _setup_records(clip, normal, valid, width, height, far_w=None,
                   cell_mask=None):
    """(span records, huge records) of a patch batch, as raster_frame
    routes them; the huge set includes the clipped near-plane straddlers."""
    clip, normal, valid = (torch.as_tensor(a) for a in (clip, normal, valid))
    tm, live, span = cov.setup_t(clip, normal, valid, width, height,
                                 cell_mask, far_w=far_w)
    s_idx, h_idx = cc.route(tm, live, span)
    smask = nearclip.straddle_mask_t(clip, valid, cell_mask)
    tcl = nearclip.clipped_tris(clip, normal, torch.nonzero(smask).squeeze(1),
                                width, height, far_w=far_w)
    crecs = nearclip.records_from_tris(tcl)[tcl.live]
    return (cc.gather_records_plain(tm, s_idx),
            torch.cat([cc.gather_records_plain(tm, h_idx),
                       crecs]).contiguous())


@pytest.fixture(scope="module")
def scenes():
    """name -> (span records, huge records, width, height)."""
    out = {}
    w, h = SCREEN["width"], SCREEN["height"]
    out["screen"] = _setup_records(*screen_scene(11, w, h, SCREEN["sizes"]),
                                   w, h) + (w, h)
    w, h = VIEW["width"], VIEW["height"]
    out["view"] = _setup_records(*view_scene(VIEW["seed"], w, h, VIEW["far"]),
                                 w, h, far_w=VIEW["far"]) + (w, h)
    recs = adversarial_records(**EDGE)
    out["adversarial"] = (recs, recs[:0], EDGE["width"], EDGE["height"])
    recs = pixel_records(**PIXELS)
    out["pixels"] = (recs, recs[:0], PIXELS["width"], PIXELS["height"])
    cfg = EngineConfig()
    cell_mask = mesh.cell_triangle_mask(cfg.patch_verts)
    gm = mesh.grid_uv_skirt(cfg.patch_verts)[3]
    for name in ("frame", "nearclip", "farclip"):
        cam = cam_mod.Camera(position=np.load(GOLD / f"{name}_cam.npy"),
                             angles=np.load(GOLD / f"{name}_angles.npy"))
        fr = PlanetEngine(cfg, device="cpu").frame(cam)
        valid = np.broadcast_to(gm[None], (fr.n_leaves,) + gm.shape).copy()
        out[name] = _setup_records(
            fr.vertices.clip, fr.vertices.normal, valid, cfg.window_w,
            cfg.window_h, far_w=cfg.far_plane, cell_mask=cell_mask) \
            + (cfg.window_w, cfg.window_h)
    return out


def _all_records(scene):
    span, huge, _, _ = scene
    return torch.cat([span, huge]).contiguous()


def _finite(records):
    """The records whose edge words keep each edge monotone along a row
    (the rest are scanned whole)."""
    words = torch.cat([records[:, :9], records[:, 29:32]], dim=1)
    ok = (torch.isfinite(words) & (words.abs() < cc.EDGE_LIMIT)).all(dim=1)
    return records[ok]


def _rows_and_pixels(records):
    """Every bbox row of every live record, (rec, ry, bw) each (R,), and
    every bbox pixel, (row index into those rows, rx) each (P,)."""
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
    return live[rec], ry, rbw, row, rx


def _edge_passes(records, rec, ry, rx, k):
    """fragment()'s test of edge k at the pixels (rec, ry, rx)."""
    r = records[rec]
    e = (r[:, 3 * k] * ry.float() - r[:, 3 * k + 1] * rx.float()) \
        + r[:, 3 * k + 2]
    return e > r[:, 29 + k]


def _row_stats(n_rows, row, rx, mask):
    """Per row: (passing count, first passing column, last passing column),
    first = a big number and last = -1 where none passes."""
    cnt = torch.zeros(n_rows, dtype=torch.int64).index_add_(
        0, row, mask.long())
    big = torch.full((n_rows,), 1 << 40, dtype=torch.int64)
    first = big.scatter_reduce(0, row[mask], rx[mask], "amin")
    last = torch.full((n_rows,), -1, dtype=torch.int64).scatter_reduce(
        0, row[mask], rx[mask], "amax")
    return cnt, first, last


@pytest.mark.parametrize("name", SCENES)
def test_each_edge_passes_a_prefix_or_suffix_of_every_row(scenes, name):
    records = _finite(_all_records(scenes[name]))
    rec, ry, bw, row, rx = _rows_and_pixels(records)
    assert len(rec) > 0
    for k in range(3):
        mask = _edge_passes(records, rec[row], ry[row], rx, k)
        cnt, first, last = _row_stats(len(rec), row, rx, mask)
        some = cnt > 0
        assert torch.equal((last - first + 1)[some], cnt[some]), \
            f"edge {k}: a row's passing columns are not contiguous"
        dy = records[rec, 3 * k + 1]
        assert bool((first[some & (dy > 0)] == 0).all()), k
        assert bool((last[some & (dy < 0)] == bw[some & (dy < 0)] - 1).all())
        flat = dy == 0.0
        assert bool(((cnt[flat] == 0) | (cnt[flat] == bw[flat])).all()), k


@pytest.mark.parametrize("name", SCENES)
def test_row_intervals_are_the_rows_passing_columns(scenes, name):
    records = _all_records(scenes[name])
    rec, ry, lo, hi = cc.row_intervals_plain(records)
    rec_b, ry_b, bw, row, rx = _rows_and_pixels(records)
    assert torch.equal(rec, rec_b) and torch.equal(ry, ry_b)
    mask = torch.ones_like(rx, dtype=torch.bool)
    for k in range(3):
        mask &= _edge_passes(records, rec[row], ry[row], rx, k)
    cnt, first, last = _row_stats(len(rec), row, rx, mask)
    words = torch.cat([records[rec, :9], records[rec, 29:32]], dim=1)
    scan = ~(torch.isfinite(words) & (words.abs() < cc.EDGE_LIMIT)).all(1)
    some, ok = cnt > 0, ~scan
    assert torch.equal(lo[ok & some], first[ok & some])
    assert torch.equal(hi[ok & some], last[ok & some])
    assert bool(((hi - lo + 1) == cnt)[ok & some].all())
    assert bool((lo > hi)[ok & ~some].all())
    assert bool(((lo == 0) & (hi == bw - 1))[scan].all())
    if name in ("adversarial", "pixels"):
        assert int(scan.sum()) > 0 and int((~some).sum()) > 0


def _fragments_in_rows(records, fb, iw_test, wireframe):
    """The plain fragment math (coverage._merge) on the pixels inside
    row_intervals_plain's intervals only, min-merged into fb."""
    rec, ry, lo, hi = cc.row_intervals_plain(records)
    n = (hi - lo + 1).clamp_min(0)
    row = torch.repeat_interleave(torch.arange(len(rec)), n)
    rx = lo[row] + torch.arange(len(row)) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    r, y = records[rec[row]], ry[row]
    cov._merge(fb.view(-1), r, r[:, 24].long() + rx, r[:, 25].long() + y,
               rx.float(), y.float(), fb.shape[1], iw_test, wireframe)
    return fb


@pytest.mark.parametrize("wireframe", [False, True])
@pytest.mark.parametrize("name", SCENES)
def test_fragments_inside_the_intervals_give_the_bbox_scans_image(
        scenes, name, wireframe):
    span, huge, width, height = scenes[name]
    for records, iw_test in ((span, False), (huge, True)):
        if not len(records):
            continue
        want = cov.fragments(records, torch.full(
            (height, width), cov._EMPTY, dtype=torch.int32), iw_test=iw_test,
            wireframe=wireframe)
        got = _fragments_in_rows(records, torch.full(
            (height, width), cov._EMPTY, dtype=torch.int32), iw_test,
            wireframe)
        assert torch.equal(got, want), int((got != want).sum())
        assert int((want != cov._EMPTY).sum()) > 0


def test_nan_shade_records_shade_every_fragment_nan():
    """Every covered pixel of the plain version holds the key of a NaN
    shade, (zq << 10) | 0 (XLA converts NaN to int32 as 0, and so does
    coverage.to_i32), and every row of these records is its whole bbox
    (the kernel's scan path)."""
    recs = nan_shade_records(**EDGE)
    fb = cc.raster_span_plain(recs, torch.full(
        (EDGE["height"], EDGE["width"]), cov._EMPTY, dtype=torch.int32))
    keys = fb[fb != cov._EMPTY]
    assert int(cov.to_i32(torch.tensor([float("nan")]))[0]) == 0
    assert len(keys) > 0
    assert torch.equal(keys, keys & 0x7FFFFC00)
    rec, _, lo, hi = cc.row_intervals_plain(recs)
    bw = (recs[:, 26] - recs[:, 24]).long() + 1
    assert torch.equal(lo, torch.zeros_like(lo))
    assert torch.equal(hi, bw[rec] - 1)


def _box_record(bw, bh, live=True):
    """A record whose every bbox pixel passes its three edges (DX = DY =
    0, c = 1 over biases of 0): a bw x bh bbox at the origin."""
    r = torch.zeros(32)
    r[0:9] = torch.tensor([0.0, 0.0, 1.0] * 3)
    r[26], r[27] = bw - 1, bh - 1
    r[28] = -1.0 if live else 0.0
    return r


# (boxes (bw, bh, live), warps, the figure): warp 0 takes records 0, 2, 4
# and warp 1 records 1 and 3, one batch each; by the record, r1's 40 rows
# take two passes and r3's 70 pixels two iterations; by the batch, warp
# 1's rows (r1's 40, then r3's one) take two passes, the second holding
# 8 + 70 pixels. Then 70 one-pixel records on one warp: batches of 32,
# 32 and 6.
BATCH_CASES = {
    "two warps": ([(3, 2, True), (1, 40, True), (2, 2, False),
                   (70, 1, True), (2, 2, True)], 2,
                  dict(batches=2, records_mean=2.5, records_most=3,
                       rows_mean=22.5, pixels_mean=60.0,
                       row_busy=dict(record=45 / 160, batch=45 / 96),
                       pixel_busy=dict(record=120 / 384, batch=120 / 256))),
    "one warp": ([(1, 1, True)] * 70, 1,
                 dict(batches=3, records_mean=70 / 3, records_most=32,
                      rows_mean=70 / 3, pixels_mean=70 / 3,
                      row_busy=dict(record=70 / (70 * 32), batch=70 / 96),
                      pixel_busy=dict(record=70 / (70 * 64),
                                      batch=70 / 192))),
    "none": ([], 4, dict(batches=0, records_mean=0.0, records_most=0,
                         rows_mean=0.0, pixels_mean=0.0,
                         row_busy=dict(record=0.0, batch=0.0),
                         pixel_busy=dict(record=0.0, batch=0.0))),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_span_batch_stats_of_hand_built_records(case):
    boxes, warps, want = BATCH_CASES[case]
    recs = torch.stack([_box_record(*b) for b in boxes]) if boxes \
        else torch.zeros((0, 32))
    got = cc.span_batch_stats(recs, warps)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key] == pytest.approx(value), key


def test_span_grid_warps_is_the_kernels_grid():
    """A warp a record in 128-thread blocks, up to the cap's blocks an SM
    (planet_raster_span): 10 records on 3 blocks; a million on 32 x 132
    blocks; with no cap, a warp a record."""
    assert cc.span_grid_warps(10, 132) == 12
    assert cc.span_grid_warps(10**6, 132) == 4 * 32 * 132
    assert cc.span_grid_warps(10**6, 132, 1) == 4 * 132
    assert cc.span_grid_warps(10**6, 132, 0) == 10**6
    assert cc.span_grid_warps(16896, 132) == 16896


@pytest.mark.parametrize("amplitude", [8848.0, -8848.0])
@pytest.mark.parametrize("kind", ["ridged", "fbm"])
def test_tiles_with_no_octaves_are_zero_times_the_amplitude(kind, amplitude):
    corners = np.load(GOLD / "tile_corners.npy")[:6] * 1e-5
    ch, cl = (torch.as_tensor(a) for a in tdf.from_f64_np(corners))
    octs = torch.tensor([0, 7, 0, 0, 12, 0], dtype=torch.int32)
    dead = octs == 0
    ch[2] = float("nan")                     # what a dead slot holds
    cl[3] = float("inf")
    kw = dict(kind=kind, gain=0.55, amplitude=amplitude, dim=8)
    got = tile_cuda.tiles_plain(ch, cl, octs, **kw)
    zero = torch.full_like(got[dead], 0.0 * np.float32(amplitude))
    assert torch.equal(got[dead].view(torch.int32), zero.view(torch.int32))
    alone = tile_cuda.tiles_plain(ch[~dead], cl[~dead], octs[~dead], **kw)
    assert torch.equal(got[~dead].view(torch.int32), alone.view(torch.int32))
    assert bool(torch.isfinite(alone).all()) and float(alone.abs().max()) > 0
