"""The port's CUDA kernels (planet_tpu_torch/csrc) against their plain
PyTorch versions on the card. Marked `gpu`; each test skips when there is
no CUDA device. On a machine with one:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

Bars: K1 tiles (also with count-0 tiles among live ones, and a negative
amplitude), K4 noise (at the refine-probe shape and at sizes that are no
multiple of its block), K5 field (full cube and strips, at n = 128 and
256) and K6 route and gather (records in candidate order and counts,
with dead, far-straddler, tall and span-class candidates, all dead, all
huge, all span; and at config 3's 2,048 x 8,712 candidates and 77 more,
on runs of each class, all dead and every one live) bitwise; K2 span and K3 huge raster framebuffers bitwise
equal to their plain versions (built with -fmad=false and IEEE
division/sqrt), K2 also on adversarial records (near-horizontal and
near-vertical edges, slivers, one-pixel and full-width bboxes, bboxes
clamped at the screen edge, -0.0 edge words, edges it scans whole) and on
pixel-sized records with a few large, dead and scanned-whole ones among
them, at the shipped grid and at one block an SM (batches of 32 records
a warp), K3 on the adversarial records too and on a screen-filling
triangle, both
drawing the first `count` records where the count is on the device, with
and without wireframe, and on records whose every shade is NaN (packed as
0, planet_tpu's conversion) for both; the splat kernel's keys bitwise
equal to its plain version (k = 1-8, wireframe); the routed raster (K6 -> K2 -> K3) with no host
synchronisation; K5's row strips equal to the full cube's rows; one
CUDA-graph replay of the fused frame's geometry step bitwise equal to the
same step run eagerly on the card, from the six faces and from the 24
subtree roots, and each stop_after rung's graph bitwise equal to that cut
step run eagerly; dryrun_multichip on two gloo ranks sharing the card;
the sharded LOD render on an NCCL world of one rank, and
four ranks' shares run in turn and folded by torch.minimum, each bitwise
equal to the single-device frame from the 24 roots; every variant of the
attribution tools
(planet_tpu_torch/tools: t_noise, t_tile, t_lut, t_span) bitwise equal to
its plain version, full noise equal to K4, full tile equal to K1; V1,
the vertex program and its shade, equal to its plain version in all six
outputs on the vertex batches of torch_scenes (rows with a NaN among
their corner normals, which it takes as padding rows, among them), at
grids of one and two 8-row groups a warp and at the main path's shapes,
launched once a geometry replay; C1's route for K6 (its class masks and
block counts) equal to the plain route's word for word, and K6 on it and
the frame equal to the plain composition, on the goldens, the 1080p rows
under the leaf count, the test scenes (a device count that cuts blocks,
and 0) and the two frames of pixel-sized triangles; a raster replay
running K6 as two kernels right after C1 and no first pass; C1's
straddler block counts and C2, the clip pass, equal to their plain
versions (indices, n_straddle, records and their count), and
the raster's framebuffer and counters equal to the plain path's at no
straddler, a few and past clip_cap; A1, the cache stage, equal to its
plain version in every output and in the pool's keys and ticks, on
torch_scenes' cache cases (capacity up to 4096, with and without the
touch) and on the 1080p static and orbit frames' calls, and refusing a
size it does not take from the sizes alone; U1, the uniforms, equal to
its plain version on the same rows and on every depth 0-29; torch's
square root on the card correctly rounded (the f64 root rounded to f32)
on 2^20 inputs; A1 launched once a geometry replay; V1's rows mode
(the uniforms computed in its own staging from the rows' words) equal to
its plain version and to V1 on U1's outputs in all six outputs, on
torch_scenes' rows cases and the 1080p static and orbit frames' rows, its
padding rows' five NaN outputs the word 0x7fffffff; a geometry replay
launching V1 once and U1 never, and U1 on the "uniforms" rung alone; a
geometry replay's refine layer at most two fills, R1's 19 levels and the
DFS order kernel, with A1 right after it; V1's wide instance (grid 66
and 66 x 66 tiles, BASELINE config 3's 64-vertex patches) equal to its
plain version on live, padding, cropped and every-depth rows, under its
own launch key, and config 3's 1080p frame (the benchmark's
configuration) on three flight cameras: each geometry replay equal to
the eager step bit for bit and launching the wide instance once, and the
wide instance on the step's own rows equal to its plain version;
five profiled interactive frames: the graphs' captures in the first
alone, each later frame's kernels starting after its geometry replay's
span has started, the readback's copies ending inside its span; the
camera inputs in one copy a frame from pinned memory, the driver's path
never waiting for its staging buffer, and PipelinedRenderer, the host
ahead of the card, waiting for it and equal to the sequential frames.

At the main path's shapes and on the paths around the kernels: K1, K4,
K6, K2, K3, C1 and C2 bitwise on the inputs tools/kernel_times builds
(the 1080p scene's leaves and records, the goldens', the orbit's,
config 3's flight); both frame paths at the golden bars, and the fused
1080p frame against PlanetEngine on the orbit and under
set_sync_debug_mode("error"); config 3's frame on the flight; the
dense mountain-valley view (3,177 leaves at LOD quality 16) through
the driver against the benchmark's plain reference; BASELINE
configs 1, 2 and 5 (K4's flat patch, K5 at 1024 and 2048 against the
composed frame, the 6x8192^2 strips); the attribution tools at their own
sizes; the splat raster at 1080p, and its flight (the benchmark's
lod-1080p-splat) through the driver against the benchmark's plain
reference, one S1 launch a frame and no exact-raster kernel; terrain
and heightmap against the goldens; run_interactive on both engines and the driver's --profile;
entry()'s forward against the CPU; the sharded field and LOD paths on
one card (an NCCL world of one rank, ranks in turn, four gloo
processes); the stage ladder (tools/stage_times in a process of its
own, its launches and device-event bounds) and the rungs from a warm
pool against the renderer."""

import contextlib
import io
import json
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from planet_tpu_torch import _cuda
from planet_tpu_torch.cache import device_pool
from planet_tpu_torch.cache import device_pool_cuda
from planet_tpu_torch.engine import device_step
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import PlanetEngine, splat_raster
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.geom import quadid
from planet_tpu_torch.lod import refine as lod_refine
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.nums.fp import sqrt_rn
from planet_tpu_torch.models import heightfield
from planet_tpu_torch.ops import perlin_np
from planet_tpu_torch.ops.kernels import field_cuda, perlin_cuda, tile_cuda
from planet_tpu_torch.parallel import sharded, sharded_lod
from planet_tpu_torch.raster import coverage as tcov
from planet_tpu_torch.raster import coverage_cuda as tcc
from planet_tpu_torch.raster import splat
from planet_tpu_torch.tess import mesh
from planet_tpu_torch.tess import uniforms_cuda
from planet_tpu_torch.tess import vertex_cuda
from planet_tpu_torch.tess.vertex import PatchVertices
from planet_tpu_torch.tools import (kernel_times, lut, noise_stages,
                                    span_parts, stage_times)
from planet_tpu_torch.tools import common as tools_common
import torch_ranks
from torch_scenes import (CACHE_CASES, EDGE, PIXELS, SCREEN, STRADDLE,
                          TESS_BATCHES, TESS_ROWS_CASES, VIEW,
                          adversarial_records, assert_golden_counts,
                          assert_golden_image, cache_case, counter_values,
                          nan_shade_records, pixel_records, screen_scene,
                          straddle_scene,
                          tess_batch, tess_padded, tess_rows, view_scene)

pytestmark = pytest.mark.gpu
GOLD = "tests/goldens/"
EMPTY = 2**31 - 1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_fb_bars(got, want):
    """The kernel's framebuffer equals the plain version's bit for bit."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(got == EMPTY, want == EMPTY)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,lacunarity", [("ridged", 2.0), ("fbm", 2.0),
                                             ("ridged", 1.7)])
def test_tile_kernel_bitwise(dev, kind, lacunarity):
    ch, cl = tdf.from_f64_np(np.load(GOLD + "tile_corners.npy") * 1e-5)
    n = len(ch)
    octs = torch.as_tensor((np.arange(n) % 19).astype(np.int32), device=dev)
    args = (torch.as_tensor(ch, device=dev), torch.as_tensor(cl, device=dev),
            octs)
    kw = dict(kind=kind, lacunarity=lacunarity, gain=0.55, amplitude=8848.0)
    before = _cuda.launches["tile"]
    got = tile_cuda.generate_tiles(*args, **kw)
    assert _cuda.launches["tile"] == before + 1
    want = tile_cuda.tiles_plain(*args, **kw)
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("amplitude", [8848.0, -8848.0])
def test_tile_kernel_dead_tiles_bitwise(dev, amplitude):
    """Count-0 tiles mixed with live ones, as the fused frame's generation
    slots: each writes 0 * amplitude whatever its corners hold."""
    ch, cl = tdf.from_f64_np(np.load(GOLD + "tile_corners.npy") * 1e-5)
    n = len(ch)
    ch, cl = torch.as_tensor(ch), torch.as_tensor(cl)
    octs = torch.as_tensor(np.where(np.arange(n) % 3 == 0, 0,
                                    6 + np.arange(n) % 13).astype(np.int32))
    ch[octs == 0] = float("nan")
    kw = dict(kind="ridged", gain=0.55, amplitude=amplitude)
    before = _cuda.launches["tile"]
    got = tile_cuda.generate_tiles(ch.to(dev), cl.to(dev), octs.to(dev), **kw)
    assert _cuda.launches["tile"] == before + 1
    want = tile_cuda.tiles_plain(ch, cl, octs, **kw)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def _route_inputs(n, seed):
    """(tm (32, n), live, span) on the CPU: random records among which dead
    candidates, far-straddlers (row 28 > 0), tall ones (span > 16) and
    live span-class ones; dead candidates carry NaN words."""
    rng = np.random.default_rng(seed)
    tm = rng.normal(size=(32, n)).astype(np.float32)
    live = rng.uniform(size=n) < 0.3
    far = rng.uniform(size=n) < 0.1
    tm[28] = np.where(live, np.where(far, 1.0 / 40.0, -1.0), 0.0)
    tm[:, ~live & (rng.uniform(size=n) < 0.2)] = np.nan
    span = rng.integers(1, 24, n).astype(np.int32)
    return (torch.from_numpy(tm), torch.from_numpy(live),
            torch.from_numpy(span))


def _assert_route_equal(got, want):
    sk, hk, ck = (t.cpu() for t in got)
    sp, hp, cp = want
    assert torch.equal(ck, cp), (ck, cp)
    ns, nh = (int(v) for v in cp)
    assert torch.equal(sk[:ns].view(torch.int32), sp.view(torch.int32))
    assert torch.equal(hk[:nh].view(torch.int32), hp.view(torch.int32))


@pytest.mark.parametrize("case", ["mixed", "all dead", "all huge",
                                  "all span", "one block", "every live"])
def test_gather_kernel_bitwise(dev, case):
    """K6, the route and the gather, against route + gather_records_plain:
    records (in candidate order) and counts bit for bit. The route's
    record classes replace the old gather's out-of-range indices: dead
    candidates give no record, far-straddlers and tall records go to the
    huge class."""
    tm, live, span = _route_inputs(1000 if case == "one block" else 5000, 7)
    if case == "all dead":
        live = torch.zeros_like(live)
    elif case == "all huge":
        span = torch.full_like(span, 17)
    elif case == "all span":
        tm[28] = torch.where(live, -1.0, 0.0)
        span = torch.ones_like(span)
    elif case == "every live":
        live = torch.ones_like(live)
    route = tcc.route_masks_plain(tm, live, span).to(dev)
    before = _cuda.launches["gather"]
    got = tcc.route_records_cuda(tm.to(dev), route)
    assert _cuda.launches["gather"] == before + 1
    want = tcc.route_records_plain(tm, live, span)
    _assert_route_equal(got, want)
    if case == "mixed":
        assert int(want[2][0]) > 0 and int(want[2][1]) > 0
    with pytest.raises(ValueError):            # the route's words as int64
        tcc.route_records_cuda(tm.to(dev), tcc.route_masks_plain(
            tm, live, span).to(dev).long())


# config 3's route at render_cap 2,048: 2,048 rows x 8,712 candidates, and
# 77 more, so the last of its 69,697 blocks is partial
CONFIG3_CANDIDATES = 2048 * 8712 + 77


def _route_runs(n, seed, dev):
    """(tm (32, n), live, span) on the card: runs of 1-2,047 candidates,
    each run dead (NaN words in some), span-class, tall (huge class),
    far-straddlers (huge class) or mixed at random as _route_inputs."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 2048, n // 256 + 16)    # ~4n candidates
    kind = np.repeat(rng.integers(0, 5, lengths.size).astype(np.int8),
                     lengths)[:n]
    mixed = kind == 4
    live = (kind == 1) | (kind == 2) | (kind == 3) | (
        mixed & (rng.uniform(size=n) < 0.3))
    far = (kind == 3) | (mixed & (rng.uniform(size=n) < 0.1))
    span = np.where(kind == 2, rng.integers(17, 24, n),
                    np.where(mixed, rng.integers(1, 24, n),
                             rng.integers(1, 17, n))).astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tm = torch.randn((32, n), generator=gen, device=dev)
    live_t = torch.as_tensor(live, device=dev)
    tm[28] = torch.where(live_t, torch.where(
        torch.as_tensor(far, device=dev), 1.0 / 40.0, -1.0), 0.0)
    nan = torch.as_tensor(~live & (rng.uniform(size=n) < 0.2), device=dev)
    tm[:, nan] = float("nan")
    return tm, live_t, torch.as_tensor(span, device=dev)


@pytest.mark.parametrize("case", ["runs", "all dead", "every live"])
def test_gather_kernel_bitwise_at_config3_scale(dev, case):
    """K6 at config 3's candidate count (more than 65,536 blocks, the last
    one partial) against route + gather_records_plain on the card: records
    in candidate order and counts bit for bit, on runs of dead, span-class
    and huge-class candidates and at both extremes."""
    tm, live, span = _route_runs(CONFIG3_CANDIDATES, 23, dev)
    if case == "all dead":
        live = torch.zeros_like(live)
    elif case == "every live":
        live = torch.ones_like(live)
    route = tcc.route_masks_plain(tm, live, span)
    before = _cuda.launches["gather"]
    sk, hk, ck = tcc.route_records_cuda(tm, route)
    assert _cuda.launches["gather"] == before + 1
    sp, hp, cp = tcc.route_records_plain(tm, live, span)
    assert torch.equal(ck, cp), (ck, cp)
    ns, nh = (int(v) for v in cp)
    if case == "runs":
        assert ns > 0 and nh > 0 and ns + nh < CONFIG3_CANDIDATES
    assert torch.equal(sk[:ns].view(torch.int32), sp.view(torch.int32))
    assert torch.equal(hk[:nh].view(torch.int32), hp.view(torch.int32))


def _scene_setups(dev):
    for clip, normal, valid, w, h, far in (
            screen_scene(11, SCREEN["width"], SCREEN["height"],
                         SCREEN["sizes"]) + (SCREEN["width"],
                                             SCREEN["height"], None),
            view_scene(VIEW["seed"], VIEW["width"], VIEW["height"],
                       VIEW["far"]) + (VIEW["width"], VIEW["height"],
                                       VIEW["far"])):
        yield tcov.setup_t(
            *(torch.as_tensor(a, device=dev) for a in (clip, normal, valid)),
            w, h, far_w=far) + (w, h)


@pytest.mark.parametrize("wireframe", [False, True])
def test_raster_kernels_match_plain(dev, wireframe):
    for tm, live, span, w, h in _scene_setups(dev):
        span_recs, huge_recs, _ = tcc.route_records_plain(tm, live, span)
        for recs, kernel, plain in ((span_recs, tcc.raster_span_cuda,
                                     tcc.raster_span_plain),
                                    (huge_recs, tcc.raster_huge_cuda,
                                     tcc.raster_huge_plain)):
            assert recs.shape[0] > 0
            fbk = torch.full((h, w), EMPTY, dtype=torch.int32, device=dev)
            fbp = fbk.clone()
            kernel(recs, fbk, wireframe)
            plain(recs, fbp, wireframe)
            _assert_fb_bars(fbk, fbp)


@pytest.mark.parametrize("wireframe", [False, True])
def test_huge_kernel_adversarial_records_bitwise(dev, wireframe):
    """K3 on the view scene's huge records and on the adversarial records
    (which it treats like any other, with its 1/w tests): bitwise equal to
    its plain version."""
    tm, live, span, w, h = list(_scene_setups(dev))[1]     # view scene
    for recs, width, height in (
            (tcc.route_records_plain(tm, live, span)[1], w, h),
            (adversarial_records(**EDGE).to(dev), EDGE["width"],
             EDGE["height"])):
        fbk = torch.full((height, width), EMPTY, dtype=torch.int32,
                         device=dev)
        fbp = fbk.clone()
        tcc.raster_huge_cuda(recs, fbk, wireframe)
        tcc.raster_huge_plain(recs, fbp, wireframe)
        _assert_fb_bars(fbk, fbp)


def test_huge_kernel_screen_filling_triangle_bitwise(dev):
    """K3 on a triangle covering every pixel of a 1920x1080 screen and one
    whose bbox is the screen but covers none."""
    recs = kernel_times.screen_triangle_records(1920, 1080, dev)
    for wf in (False, True):
        fbk = torch.full((1080, 1920), EMPTY, dtype=torch.int32, device=dev)
        fbp = fbk.clone()
        tcc.raster_huge_cuda(recs, fbk, wf)
        tcc.raster_huge_plain(recs, fbp, wf)
        _assert_fb_bars(fbk, fbp)
    assert bool((fbp != EMPTY).any())


@pytest.mark.parametrize("kernel", ["span", "huge"])
def test_raster_kernels_draw_the_device_count(dev, kernel):
    """K2 and K3 with the record count on the device draw exactly the
    first `count` records of a larger buffer (0, some, all, and more than
    the buffer holds)."""
    recs = adversarial_records(**EDGE).to(dev)
    cuda = tcc.raster_span_cuda if kernel == "span" else tcc.raster_huge_cuda
    plain = (tcc.raster_span_plain if kernel == "span"
             else tcc.raster_huge_plain)
    for n in (0, 5, recs.shape[0], recs.shape[0] + 7):
        count = torch.tensor([n], dtype=torch.int32, device=dev)
        fbk = torch.full((EDGE["height"], EDGE["width"]), EMPTY,
                         dtype=torch.int32, device=dev)
        fbp = fbk.clone()
        cuda(recs, fbk, count=count)
        plain(recs[:n], fbp)
        _assert_fb_bars(fbk, fbp)


def test_routed_raster_reads_no_host_between_setup_and_k3(dev):
    """raster_frame's routed part (K6 -> K2 -> K3 on the route of
    setup_t's outputs, route_masks_plain's words) under
    torch.cuda.set_sync_debug_mode("error"): nothing in it synchronizes
    with the host, and it draws what the plain composition draws."""
    for tm, live, span, w, h in _scene_setups(dev):
        fb = torch.full((h, w), EMPTY, dtype=torch.int32, device=dev)
        route = tcc.route_masks_plain(tm, live, span)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            counts = tcc.raster_classes(*tcc.route_records_cuda(tm, route),
                                        fb)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        span_recs, huge_recs, want_counts = tcc.route_records_plain(
            tm, live, span)
        assert torch.equal(counts, want_counts)
        fbp = torch.full_like(fb, EMPTY)
        tcc.raster_span_plain(span_recs, fbp)
        tcc.raster_huge_plain(huge_recs, fbp)
        _assert_fb_bars(fb, fbp)


@pytest.mark.parametrize("wireframe", [False, True])
def test_span_kernel_adversarial_records_bitwise(dev, wireframe):
    """K2 on records that stress its row intervals, against its plain
    version on the CPU: the framebuffers are equal bit for bit."""
    recs = adversarial_records(**EDGE)
    fb = torch.full((EDGE["height"], EDGE["width"]), EMPTY, dtype=torch.int32)
    before = _cuda.launches["span"]
    got = tcc.raster_span(recs.to(dev), fb.to(dev), wireframe)
    assert _cuda.launches["span"] == before + 1
    want = tcc.raster_span_plain(recs, fb.clone(), wireframe)
    _assert_fb_bars(got, want)
    assert int((want != EMPTY).sum()) > 0


@pytest.mark.parametrize("blocks_per_sm", [1, tcc.SPAN_BLOCKS_PER_SM])
@pytest.mark.parametrize("wireframe", [False, True])
def test_span_kernel_batches_bitwise(dev, wireframe, blocks_per_sm):
    """K2 on torch_scenes.pixel_records (pixel-sized records with a few
    of ~2,000 px, every 7th dead and every 97th scanned whole, in a seeded
    order), at the shipped grid (a batch of one or two records a warp) and
    at one block an SM (two batches a warp, the first of 32 records), one
    launch: the framebuffer equals the plain version's bit for bit."""
    recs = pixel_records(**PIXELS)
    warps = tcc.span_grid_warps(
        recs.shape[0], torch.cuda.get_device_properties(dev)
        .multi_processor_count, blocks_per_sm)
    assert recs.shape[0] > (32 if blocks_per_sm == 1 else 1) * warps
    fb = _fb(PIXELS["width"], PIXELS["height"], "cpu")
    before = _cuda.launches["span"]
    got = tcc.raster_span_cuda(recs.to(dev), fb.to(dev), wireframe,
                               blocks_per_sm=blocks_per_sm)
    assert _cuda.launches["span"] == before + 1
    want = tcc.raster_span_plain(recs, fb.clone(), wireframe)
    _assert_fb_bars(got, want)
    assert int((want != EMPTY).sum()) > 1000


@pytest.mark.parametrize("blocks_per_sm", [1, tcc.SPAN_BLOCKS_PER_SM])
@pytest.mark.parametrize("wireframe", [False, True])
def test_span_kernel_batches_draw_the_device_count(dev, wireframe,
                                                   blocks_per_sm):
    """K2's batches with the record count on the device: 0, 1, a count
    that is no multiple of the grid's warps (so warps end on batches of
    different sizes) and the whole buffer draw exactly the first `count`
    records of pixel_records."""
    recs = pixel_records(**PIXELS)
    m = recs.shape[0]
    warps = tcc.span_grid_warps(
        m, torch.cuda.get_device_properties(dev).multi_processor_count,
        blocks_per_sm)
    for n in (0, 1, 17 * warps + 5 if 17 * warps + 5 < m else m - 3, m):
        count = torch.tensor([n], dtype=torch.int32, device=dev)
        fbk = _fb(PIXELS["width"], PIXELS["height"], dev)
        fbp = _fb(PIXELS["width"], PIXELS["height"], "cpu")
        tcc.raster_span_cuda(recs.to(dev), fbk, wireframe, count=count,
                             blocks_per_sm=blocks_per_sm)
        tcc.raster_span_plain(recs[:n], fbp, wireframe)
        _assert_fb_bars(fbk, fbp)


@pytest.mark.parametrize("k", [1, 2, 3, 6, 8])
@pytest.mark.parametrize("wireframe", [False, True])
def test_splat_kernel_bitwise(dev, k, wireframe):
    """The splat kernel (csrc/splat.cu) against splat_keys_plain: seeded
    patch grids with fragments behind the camera, at w <= 1e-9, off
    screen, at coordinates outside int32, with NaN coordinates, depths and
    shades; keys equal bit for bit, one launch."""
    rng = np.random.default_rng(k + 10 * wireframe)
    q, g = 5, 9
    clip = rng.normal(0.0, 0.7, (q, g, g, 4)).astype(np.float32)
    clip[..., 3] = rng.uniform(-0.2, 2.0, (q, g, g))
    clip[0, 0, :6] = [[np.nan, 0.1, 0.2, 1.0], [1e12, -1e12, 0.0, 1.0],
                      [-1e12, 1e12, 0.0, 1.0], [0.1, 0.1, 0.1, 1e-10],
                      [0.1, 0.1, np.nan, 1.0], [0.1, 0.1, 0.1, 1e-9]]
    shade = rng.uniform(-0.1, 1.1, (q, g, g)).astype(np.float32)
    shade[1, 2, 2:5] = [np.nan, np.inf, -np.inf]
    valid = rng.uniform(size=(q, g, g)) < 0.9
    args = [torch.as_tensor(a) for a in (clip, shade, valid)]
    want = splat.splat_keys_plain(*args, 61, 47, k, wireframe)
    before = _cuda.launches["splat"]
    got = splat.splat_keys(*(a.to(dev) for a in args), 61, 47, k, wireframe)
    assert _cuda.launches["splat"] == before + 1
    _assert_fb_bars(got, want)
    assert int((want != EMPTY).sum()) > 20


def _assert_nan_shades_bitwise(dev, cuda, plain, key):
    recs = nan_shade_records(**EDGE)
    fb = torch.full((EDGE["height"], EDGE["width"]), EMPTY, dtype=torch.int32)
    for wireframe in (False, True):
        before = _cuda.launches[key]
        got = cuda(recs.to(dev), fb.to(dev), wireframe)
        assert _cuda.launches[key] == before + 1
        want = plain(recs, fb.clone(), wireframe)
        _assert_fb_bars(got, want)
        covered = want != EMPTY
        assert int(covered.sum()) > 0
        assert torch.equal(want[covered] & 1023,
                           torch.zeros_like(want[covered]))


def test_span_kernel_nan_shades_bitwise(dev):
    """K2 on records whose every fragment has a NaN shade, against its
    plain version, with and without wireframe: equal bit for bit, every
    shade packed as 0 (planet_tpu
    converts NaN to int32 as 0; the kernel tests the NaN before its
    fminf clamp, which would return the number)."""
    _assert_nan_shades_bitwise(dev, tcc.raster_span, tcc.raster_span_plain,
                               "span")


def test_huge_kernel_nan_shades_bitwise(dev):
    """The same for K3 (fragment() is shared): the records' fragments that
    pass the 1/w tests have NaN shades, packed as 0 by both."""
    _assert_nan_shades_bitwise(dev, tcc.raster_huge, tcc.raster_huge_plain,
                               "huge")


def test_frame_on_card_matches_cpu(dev):
    cam = cam_mod.Camera(position=np.load(GOLD + "nearclip_cam.npy"),
                         angles=np.load(GOLD + "nearclip_angles.npy"))
    cfg = EngineConfig()
    _cuda.reset_launches()
    out_g, img_g, dep_g = PlanetEngine(cfg, device=dev).render(cam)
    # the host-orchestrated path's kernels (K4 belongs to the fused path)
    assert all(_cuda.launches[k] > 0 for k in ("tile", "tess", "gather",
                                               "span", "huge")), \
        _cuda.launches
    out_c, img_c, dep_c = PlanetEngine(cfg, device="cpu").render(cam)
    np.testing.assert_array_equal(out_g.leaf_ids, out_c.leaf_ids)
    cov_g = torch.isfinite(dep_g).cpu().numpy()
    cov_c = torch.isfinite(dep_c).numpy()
    assert (cov_g == cov_c).mean() > 0.999


@pytest.mark.parametrize("kind,lacunarity,octaves", [
    ("ridged", 2.0, 6), ("fbm", 2.0, 18), ("fbm", 1.7, 5),
    ("ridged", 1.7, 18)])
def test_noise_kernel_bitwise(dev, kind, lacunarity, octaves):
    pts = np.load(GOLD + "pts_fbm.npy")
    sphere = np.load(GOLD + "pts_sphere.npy") * 1e-5      # terrain scale
    coords = []
    for i in range(3):
        for a in tdf.from_f64_np(np.concatenate([pts[:, i], sphere[:, i]])):
            coords.append(torch.as_tensor(a, device=dev))
    kw = dict(lacunarity=lacunarity, gain=0.55, octaves=octaves)
    before = _cuda.launches["noise"]
    got = perlin_cuda.noise_df(kind, *coords, **kw)
    assert _cuda.launches["noise"] == before + 1
    want = perlin_cuda.noise_plain(kind, *coords, **kw)
    assert torch.equal(got, want), float((got - want).abs().max())


def _sphere_coords(n, dev, seed=11):
    """Six (n,) f32 tensors: n seeded points on the terrain-scale sphere
    (radius 6.371e6 x 1e-5), split into double-float."""
    p = np.random.default_rng(seed).normal(size=(n, 3))
    p = p / np.linalg.norm(p, axis=1, keepdims=True) * 63.71
    return [torch.as_tensor(a, device=dev) for k in range(3)
            for a in tdf.from_f64_np(p[:, k])]


@pytest.mark.parametrize("octaves", [0, 1, 6, 8, 18, 24])
@pytest.mark.parametrize("n", [5 * 4096, 1001, 1])
def test_noise_kernel_sizes_bitwise(dev, n, octaves):
    """K4 at the refine-probe shape (5 x 4096) and at n that are no
    multiple of its 256-thread block, ridged and fBm at lacunarity 2 and
    fBm at 1.7."""
    coords = _sphere_coords(n, dev)
    for kind, lacunarity in (("ridged", 2.0), ("fbm", 2.0), ("fbm", 1.7)):
        kw = dict(lacunarity=lacunarity, gain=0.55, octaves=octaves)
        before = _cuda.launches["noise"]
        got = perlin_cuda.noise_df(kind, *coords, **kw)
        assert _cuda.launches["noise"] == before + 1
        want = perlin_cuda.noise_plain(kind, *coords, **kw)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            (kind, lacunarity, float((got - want).abs().max()))


@pytest.mark.parametrize("caps", ["small", "default"])
def test_graph_replay_equals_eager_step(dev, caps):
    """Three frames of the golden camera: the captured geometry step,
    replayed, gives the eager step's leaf ids, slots, tiles and vertices bit
    for bit, and each replay counts the graph's kernels; at caps 1024 /
    512 / 128 and at DeviceRenderer's default caps."""
    cfg = EngineConfig()
    cam = cam_mod.Camera(position=np.load(GOLD + "frame_cam.npy"),
                         angles=np.load(GOLD + "frame_angles.npy"))
    rot = cam_mod.camera_rotation(cam)
    pf = cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg))
    vp = (cam_mod.perspective_lh(pf, 4 / 3, cfg.near_plane, cfg.far_plane)
          @ cam_mod.view_from_rotation(rot)).astype(np.float32)
    cam_hi, cam_lo = tdf.from_f64_np(cam.position)
    kw = dict(cap=1024, render_cap=512, gen_cap=128) if caps == "small" else {}
    r = device_step.DeviceRenderer(cfg, 800, 600, device=dev, **kw)
    step = device_step.build_geometry_step(cfg, device=dev, **kw)
    pool_g, pool_e = r.init_pool(), r.init_pool()
    args = [torch.as_tensor(a, device=dev) for a in (cam_hi, cam_lo, vp)]
    for frame in range(3):
        before = dict(_cuda.launches)
        got = r.geometry(pool_g, cam_hi, cam_lo, vp)
        if frame:     # the first call also ran the warm-up
            assert all(_cuda.launches[k] - before[k] == n
                       for k, n in r._tally.items()), r._tally
        assert r._tally["tile"] == 1 and r._tally["refine"] == 19
        assert r._tally["noise"] == 0
        want = step(pool_e, *args, *device_step.face_roots(cfg.radius, dev))
        for name in ("leaf_lo", "leaf_hi", "leaf_depth", "slot", "tiles",
                     "valid", "vertex_shade", "meta"):
            assert _same_bits(getattr(got, name), getattr(want, name)), name
        for a, b in zip(got.vertices, want.vertices):
            assert _same_bits(a, b)
        for a, b in zip(pool_g, pool_e):
            assert torch.equal(a, b)


def test_graph_replay_equals_eager_step_dynamic_roots(dev):
    """The step from the 24 subtree roots: two replays equal the eager step
    bit for bit, the roots (given on the host) copied into the graph's
    static inputs once."""
    cfg = EngineConfig(cache_capacity=256)
    args = torch_ranks.lod_camera_args(cfg, 160, 120)
    roots = sharded_lod.subtree_roots(cfg.radius, dev)
    kw = dict(cap=1024, render_cap=512, gen_cap=512, max_lod=4)
    r = device_step.DeviceRenderer(cfg, 160, 120, device=dev,
                                   roots=[t.cpu() for t in roots], **kw)
    step = device_step.build_geometry_step(cfg, device=dev, **kw)
    pool_g, pool_e = r.init_pool(), r.init_pool()
    targs = [torch.as_tensor(a, device=dev) for a in args]
    for _ in range(2):
        got = r.geometry(pool_g, *args)
        want = step(pool_e, *targs, *roots)
        for name in ("leaf_lo", "leaf_hi", "leaf_depth", "slot", "tiles",
                     "valid", "vertex_shade", "meta"):
            assert _same_bits(getattr(got, name), getattr(want, name)), name
        for a, b in zip(got.vertices, want.vertices):
            assert _same_bits(a, b)
    assert int(want.meta[0]) > 24


def _flat(out):
    """The tensors of a Geometry or a Truncated, nested tuples opened."""
    if isinstance(out, device_step.Truncated):
        out = (out.meta, *out.outputs.values())
    for x in out:
        if isinstance(x, tuple):
            yield from x
        else:
            yield x


@pytest.mark.parametrize("rung", device_step.STAGES)
def test_stop_after_rungs_captured_equal_eager(dev, rung):
    """Each stop_after rung captured as a graph of its own: replays from
    two cameras (the golden one, then one 10 % nearer) equal the cut step
    run eagerly on the card, outputs and pool bit for bit; a replay
    launches R1 19 times (a launch a level), the DFS order kernel once,
    K4 never, K1 once from "generate" on, A1 once from "cache" on, U1 on the "uniforms" rung
    alone (V1 computes the uniforms itself past it) and V1 once from
    "tess" on."""
    cfg = EngineConfig()
    pos = np.load(GOLD + "frame_cam.npy")
    angles = np.load(GOLD + "frame_angles.npy")
    kw = dict(cap=1024, render_cap=512, gen_cap=128, stop_after=rung)
    r = device_step.DeviceRenderer(cfg, 800, 600, device=dev, **kw)
    step = device_step.build_geometry_step(cfg, device=dev, **kw)
    pool_g, pool_e = r.init_pool(), r.init_pool()
    roots = device_step.face_roots(cfg.radius, dev)
    cap = cfg.cache_capacity
    for scale in (1.0, 0.9):
        cam = cam_mod.Camera(position=pos * scale, angles=angles)
        rot = cam_mod.camera_rotation(cam)
        pf = cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg))
        vp = (cam_mod.perspective_lh(pf, 4 / 3, cfg.near_plane,
                                     cfg.far_plane)
              @ cam_mod.view_from_rotation(rot)).astype(np.float32)
        args = (*tdf.from_f64_np(cam.position), vp)
        got = r.geometry(pool_g, *args)
        want = step(pool_e, *(torch.as_tensor(a, device=dev) for a in args),
                    *roots)
        assert type(got) is type(want)
        pairs = list(zip(_flat(got), _flat(want)))
        assert len(pairs) == len(list(_flat(want))) > 2
        for i, (a, b) in enumerate(pairs):
            assert _same_bits(a, b), (rung, scale, i)
        for a, b in zip(pool_g, pool_e):
            assert torch.equal(a[:cap] if a.dim() else a,
                               b[:cap] if b.dim() else b)
    assert int(got.meta[0]) > 0
    tally = r.graph_launches
    assert tally["refine"] == 19 and tally["noise"] == 0, tally
    assert tally["order"] == 1, tally
    assert tally["tile"] == (0 if rung in ("refine", "cache") else 1), tally
    assert tally["cache"] == (0 if rung == "refine" else 1), tally
    assert tally["uniforms"] == (1 if rung == "uniforms" else 0), tally
    assert tally["tess"] == (1 if rung in ("tess", "geometry") else 0), tally


@pytest.mark.parametrize("ranks", [2, 4])
def test_dryrun_multichip_on_the_card(dev, ranks):
    """entry.dryrun_multichip: gloo ranks sharing the card, every check of
    (a) and (b); with four ranks the 2-axis meshes' checks too."""
    from planet_tpu_torch import entry
    entry.dryrun_multichip(ranks)


def _sharded_scene(dev):
    cfg = EngineConfig(cache_capacity=256)
    kw = dict(cap=1024, render_cap=512, gen_cap=512, max_lod=4,
              probe="ridged6")
    args = torch_ranks.lod_camera_args(cfg, 160, 120)
    roots = sharded_lod.subtree_roots(cfg.radius, dev)
    r = device_step.DeviceRenderer(cfg, 160, 120, device=dev, roots=roots,
                                   **kw)
    frame = r.render(r.init_pool(), *args)
    (packed, n, *_), _ = device_step.raster_packed(r.last_geometry, cfg,
                                                   160, 120)
    g = r.last_geometry
    ids = set(int(q) for q in quadid.from_words(
        g.leaf_lo[:n].cpu().numpy(), g.leaf_hi[:n].cpu().numpy()))
    assert not frame.overflowed and n > 24
    return cfg, kw, args, roots, frame, packed, ids


def test_sharded_render_world_of_one_equals_single_device(dev, tmp_path):
    """build_sharded_render on an NCCL world of one rank over all 24 roots
    at 160x120 and small caps, bitwise the single-device frame."""
    cfg, kw, args, _, want, _, want_ids = _sharded_scene(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        fn = sharded_lod.build_sharded_render(
            cfg, sharded.make_mesh(1, axis="quads"), 160, 120, **kw)
        pool = device_pool.init(cfg.cache_capacity, cfg.tile_dim, dev)
        frame, (q_lo, q_hi, n, n_gen) = fn(pool, *args)
    finally:
        dist.destroy_process_group()
    assert torch.equal(frame.image, want.image)
    assert torch.equal(frame.depth, want.depth)
    assert (frame.n_leaves, frame.n_generated, frame.overflowed) == (
        want.n_leaves, want.n_generated, False)
    assert set(int(q) for q in quadid.from_words(
        q_lo[:n].cpu().numpy(), q_hi[:n].cpu().numpy())) == want_ids


def test_sharded_ranks_in_turn_fold_to_single_device(dev):
    """Four ranks' shares at 160x120 and small caps, each with its own
    pool and graph, folded by torch.minimum: the single-device frame."""
    cfg, kw, args, roots, want, packed, want_ids = _sharded_scene(dev)
    fold, got = None, set()
    for rank in range(4):
        r = device_step.DeviceRenderer(
            cfg, 160, 120, device=dev,
            roots=sharded_lod.local_roots(roots, rank, 4), **kw)
        geom = r.geometry(r.init_pool(), *args)
        (pk, n, _, ovf, q_lo, q_hi), _ = device_step.raster_packed(
            geom, cfg, 160, 120)
        assert not ovf
        part = set(int(q) for q in quadid.from_words(
            q_lo[:n].cpu().numpy(), q_hi[:n].cpu().numpy()))
        assert not got & part
        got |= part
        fold = pk if fold is None else torch.minimum(fold, pk)
    assert got == want_ids
    assert torch.equal(fold, packed)


def _same_bits(a, b):
    """Bitwise equality that holds for equal NaNs too (the padding rows of
    the vertex arrays are NaN, as in planet_tpu)."""
    if a.dtype == b.dtype and a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("kind,lacunarity,octaves", [
    ("ridged", 2.0, 6), ("fbm", 1.7, 5)])
def test_field_kernel_bitwise(dev, kind, lacunarity, octaves):
    kw = dict(kind=kind, lacunarity=lacunarity, octaves=octaves)
    before = _cuda.launches["field"]
    got = field_cuda.field_cube(256, 6.371e6, device=dev, **kw)
    assert _cuda.launches["field"] == before + 1
    want = field_cuda.field_plain(256, 6.371e6, device=dev, **kw)
    for g, w in zip(got, want):
        assert g.shape == (6, 256, 256)
        assert torch.equal(g, w), float((g - w).abs().max())


def test_field_strips_match_full_cube_on_card(dev):
    h_full, s_full = heightfield.frame_cube(256, 6.371e6, device=dev)
    for row0, rows in ((0, 64), (64, 64), (192, 64), (100, 37)):
        before = _cuda.launches["field"]
        h, s = field_cuda.field_cube_strip(256, 6.371e6, row0, rows,
                                           device=dev)
        assert _cuda.launches["field"] == before + 1
        assert torch.equal(h, h_full[:, row0:row0 + rows])
        assert torch.equal(s, s_full[:, row0:row0 + rows])
        hp, sp = field_cuda.field_plain(256, 6.371e6, row0, rows, device=dev)
        assert torch.equal(h, hp) and torch.equal(s, sp)


@pytest.mark.parametrize("n", [128, 256])
def test_field_kernel_sizes_bitwise(dev, n):
    """K5's 64-row tiles at the smallest sizes: the full cube and strips
    (one tile, a tile and a half, a strip ending inside a tile, the last
    rows) equal to the plain version bit for bit."""
    before = _cuda.launches["field"]
    h_full, s_full = field_cuda.field_cube(n, 6.371e6, device=dev)
    assert _cuda.launches["field"] == before + 1
    hp, sp = field_cuda.field_plain(n, 6.371e6, device=dev)
    assert torch.equal(h_full, hp) and torch.equal(s_full, sp)
    for row0, rows in ((0, 64), (0, 96), (37, 50), (n - 1, 1),
                       (n // 2, n // 2)):
        h, s = field_cuda.field_cube_strip(n, 6.371e6, row0, rows, device=dev)
        assert torch.equal(h, h_full[:, row0:row0 + rows])
        assert torch.equal(s, s_full[:, row0:row0 + rows])
        hp, sp = field_cuda.field_plain(n, 6.371e6, row0, rows, device=dev)
        assert torch.equal(h, hp) and torch.equal(s, sp), (row0, rows)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("variant", noise_stages.NOISE_VARIANTS)
def test_t_noise_kernel_bitwise(dev, variant):
    coords = noise_stages.noise_inputs(1 << 14, dev)
    before = _cuda.launches["t_noise"]
    got = noise_stages.noise_stage(variant, coords)
    assert _cuda.launches["t_noise"] == before + 1
    want = noise_stages.noise_plain(variant, coords)
    assert torch.equal(_bits(got), _bits(want)), \
        float((got - want).abs().max())
    if variant == "full":
        k4 = perlin_cuda.noise_cuda("ridged", *coords, octaves=6, gain=0.55)
        assert torch.equal(_bits(got), _bits(k4))


@pytest.mark.parametrize("variant", noise_stages.TILE_VARIANTS)
def test_t_tile_kernel_bitwise(dev, variant):
    ch, cl = noise_stages.tile_inputs(64, dev)
    before = _cuda.launches["t_tile"]
    got = noise_stages.tile_stage(variant, ch, cl)
    assert _cuda.launches["t_tile"] == before + 1
    want = noise_stages.tile_plain(variant, ch, cl)
    assert torch.equal(_bits(got), _bits(want)), \
        float((got - want).abs().max())
    if variant == "full":
        octs = torch.full((64,), 6, dtype=torch.int32, device=dev)
        k1 = tile_cuda.tiles_cuda(ch, cl, octs, kind="ridged", gain=0.55,
                                  amplitude=8848.0)
        assert torch.equal(_bits(got), _bits(k1))


@pytest.mark.parametrize("name", list(lut.VARIANTS))
def test_t_lut_kernel_bitwise(dev, name):
    v = lut.VARIANTS[name]
    idx, table = lut.operands(name, lut.make_inputs(v.inputs, 5000, dev))
    before = _cuda.launches["t_lut"]
    got = lut.lookup(name, idx, table)
    assert _cuda.launches["t_lut"] == before + 1
    assert torch.equal(_bits(got), _bits(lut.lookup_plain(name, idx, table)))


@pytest.mark.parametrize("name", list(span_parts.VARIANTS))
@pytest.mark.parametrize("winh", [8, 16])
def test_t_span_kernel_bitwise(dev, name, winh):
    recs, addr = span_parts.make_records(700, winh, 14, 3, 1920, 1080, dev)
    fb = span_parts.fresh_fb(1920, 1080, dev)
    before = _cuda.launches["t_span"]
    got = span_parts.raster(name, recs, fb.clone(), winh=winh, addr=addr)
    assert _cuda.launches["t_span"] == before + 1
    want = span_parts.raster_plain(name, recs, fb.clone(), winh=winh,
                                   addr=addr)
    assert torch.equal(got, want), span_parts.fb_diff(got, want)
    if span_parts.VARIANTS[name].bv in ("record", "side"):
        assert torch.equal(got, tcc.raster_span_plain(recs, fb.clone()))


# ------------------------------------------------------------------ C1

def _assert_setup_equal(got, want):
    """C1's (tm, route, straddle, blocks) equal the plain version's bit
    for bit: the route's words those of route_masks_plain on its tm, live
    and span, the straddler mask and its block counts everywhere, tm on
    every live column (the kernel writes no other)."""
    tm_k, route_k, st_k, blocks_k = got
    tm_p, live_p, span_p, st_p, blocks_p = want
    assert torch.equal(route_k, tcc.route_masks_plain(tm_p, live_p, span_p))
    assert torch.equal(st_k, st_p)
    assert blocks_p is None
    assert torch.equal(blocks_k, tcc.straddle_blocks(st_p))
    cols = torch.nonzero(live_p).squeeze(1)
    assert _same_bits(tm_k[:, cols], tm_p[:, cols])
    return int(cols.numel()), int(st_p.sum())


def _setup_both(clip, normal, valid, w, h, cfg, count=None):
    kw = dict(cell_mask=mesh.cell_triangle_mask(cfg.patch_verts),
              far_w=cfg.far_plane, count=count)
    return (tcc.setup_cuda(clip, normal, valid, w, h, **kw),
            tcc.setup_plain(clip, normal, valid, w, h, **kw))


def test_setup_kernel_bitwise_with_the_leaf_count(dev):
    """C1 with the count pointer on DeviceRenderer's render_cap rows (the
    padding rows NaN and invalid) at 1920x1080: the static camera and the
    orbit's first frames, each equal to the plain version with the same
    count bit for bit."""
    cfg = EngineConfig(window_w=1920, window_h=1080)
    r = device_step.DeviceRenderer(cfg, 1920, 1080, device=dev)
    cams = [kernel_times.scene_camera(cfg)] + [
        c for _, c in kernel_times.orbit_cameras(cfg)]
    pool = r.init_pool()
    for cam in cams:
        geom = r.geometry(pool, *stage_times.camera_args(cfg, cam, 1920, 1080))
        pv = geom.vertices
        count = geom.meta[0:1]
        n_live, _ = _assert_setup_equal(*_setup_both(
            pv.clip, pv.normal, geom.valid, 1920, 1080, cfg, count))
        assert n_live > 10000 and int(count[0]) < pv.clip.shape[0]


def test_setup_kernel_bitwise_without_a_count(dev):
    """C1 with no count (PlanetEngine's rows: every one evaluated) on the
    1080p static scene and the near-clip golden, and on the random screen
    and view scenes (near- and far-straddlers)."""
    cfg = EngineConfig(window_w=1920, window_h=1080)
    cam = kernel_times.scene_camera(cfg)
    out = PlanetEngine(cfg, device=dev).frame(cam)
    gm = torch.as_tensor(mesh.grid_uv_skirt(cfg.patch_verts)[3], device=dev)
    valid = gm[None].expand(out.n_leaves, -1, -1)
    n_live, _ = _assert_setup_equal(*_setup_both(
        out.vertices.clip, out.vertices.normal, valid, 1920, 1080, cfg))
    assert n_live > 10000
    cfg800 = EngineConfig()
    near = cam_mod.Camera(position=np.load(GOLD + "nearclip_cam.npy"),
                          angles=np.load(GOLD + "nearclip_angles.npy"))
    out = PlanetEngine(cfg800, device=dev).frame(near)
    valid = gm[None].expand(out.n_leaves, -1, -1)
    _, n_straddle = _assert_setup_equal(*_setup_both(
        out.vertices.clip, out.vertices.normal, valid, 800, 600, cfg800))
    assert n_straddle > 0
    for clip, normal, valid, w, h, far in (
            screen_scene(11, SCREEN["width"], SCREEN["height"],
                         SCREEN["sizes"]) + (SCREEN["width"],
                                             SCREEN["height"], None),
            view_scene(VIEW["seed"], VIEW["width"], VIEW["height"],
                       VIEW["far"]) + (VIEW["width"], VIEW["height"],
                                       VIEW["far"])):
        args = [torch.as_tensor(a, device=dev) for a in (clip, normal, valid)]
        got = tcc.setup_cuda(*args, w, h, far_w=far)
        _assert_setup_equal(got, tcc.setup_plain(*args, w, h, far_w=far))


def _assert_clip_pass_equal(got, want):
    """C2's (s_idx, n_straddle, records, count) equal the plain version's
    bit for bit: the slots' indices, n_straddle and the count, and the
    first count records (the live ones, in slot, A, B order)."""
    for k in (0, 1, 3):
        assert torch.equal(got[k], want[k]), k
    m = int(want[3][0])
    assert want[2].shape[0] == m and got[2].shape[0] >= m
    assert _same_bits(got[2][:m], want[2])
    return m


def _clip_cases(dev):
    """(clip, normal, valid, width, height, cell_mask, far_w, count): the
    view scene (one straddler, near- and far-clipped), the near-clip
    golden's PlanetEngine leaves (2 straddlers), DeviceRenderer's
    render_cap rows at 1080p with its leaf count (no straddler; padding
    rows NaN) and the straddle scene (888 straddlers in 20 blocks)."""
    cfg800 = EngineConfig()
    near = cam_mod.Camera(position=np.load(GOLD + "nearclip_cam.npy"),
                          angles=np.load(GOLD + "nearclip_angles.npy"))
    out = PlanetEngine(cfg800, device=dev).frame(near)
    gm = torch.as_tensor(mesh.grid_uv_skirt(cfg800.patch_verts)[3],
                         device=dev)
    clip, normal, valid = view_scene(VIEW["seed"], VIEW["width"],
                                     VIEW["height"], VIEW["far"])
    cases = [(*(torch.as_tensor(a, device=dev) for a in (clip, normal,
                                                        valid)),
              VIEW["width"], VIEW["height"], None, VIEW["far"], None),
             (out.vertices.clip, out.vertices.normal,
              gm[None].expand(out.n_leaves, -1, -1), 800, 600,
              mesh.cell_triangle_mask(cfg800.patch_verts),
              cfg800.far_plane, None)]
    cfg = EngineConfig(window_w=1920, window_h=1080)
    r = device_step.DeviceRenderer(cfg, 1920, 1080, device=dev)
    geom = r.geometry(r.init_pool(), *stage_times.camera_args(
        cfg, kernel_times.scene_camera(cfg), 1920, 1080))
    cases.append((geom.vertices.clip, geom.vertices.normal, geom.valid,
                  1920, 1080, mesh.cell_triangle_mask(cfg.patch_verts),
                  cfg.far_plane, geom.meta[0:1]))
    cases.append((*(torch.as_tensor(a, device=dev)
                    for a in straddle_scene(**STRADDLE)),
                  STRADDLE["width"], STRADDLE["height"], None,
                  STRADDLE["far"], None))
    return cases


@pytest.mark.parametrize("clip_cap", [512, 3])
def test_clip_kernel_bitwise(dev, clip_cap):
    """C2, the clip pass, on C1's straddler mask and block counts of the
    view scene (near- and far-clipped), of the near-clip golden's
    PlanetEngine leaves, of DeviceRenderer's padded rows at 1080p (no
    straddler: no slot used, no record) and of the straddle scene (past
    the cap), at the main path's 512 slots and at 3."""
    lives, counts = [], []
    for clip, normal, valid, w, h, cm, far, count in _clip_cases(dev):
        c1 = tcc.setup_cuda(clip, normal, valid, w, h, cm, far, count)
        before = _cuda.launches["clip"]
        got = tcc.clip_pass_cuda(clip, normal, c1[2], c1[3], w, h, far,
                                 clip_cap)
        assert _cuda.launches["clip"] == before + 1
        lives.append(_assert_clip_pass_equal(got, tcc.clip_pass_plain(
            clip, normal, c1[2], w, h, far, clip_cap)))
        counts.append(int(got[1]))
    # the straddle scene's first three straddlers clip to culled parts
    assert lives[0] > 0 and lives[1] > 0 and lives[2] == 0
    assert (lives[3] > 0) == (clip_cap == 512)
    assert counts == [1, 2, 0, 888]


def _raster_plain_on_card(clip, normal, valid, w, h, cm, far, count,
                          clip_cap):
    """raster_frame's steps through the plain versions, on the card's
    tensors: setup, route, span and huge rasters, the clip pass."""
    tm, live, span, straddle, _ = tcc.setup_plain(
        clip, normal, valid, w, h, cm, far, count)
    fb = torch.full((h, w), tcov._EMPTY, dtype=torch.int32,
                    device=clip.device)
    span_recs, huge_recs, counts = tcc.route_records_plain(tm, live, span)
    tcc.raster_span_plain(span_recs, fb)
    tcc.raster_huge_plain(huge_recs, fb)
    _, n_straddle, recs, n_recs = tcc.clip_pass_plain(
        clip, normal, straddle, w, h, far, clip_cap)
    tcc.raster_huge_plain(recs, fb, count=n_recs)
    return fb, counts, n_straddle


@pytest.mark.parametrize("clip_cap", [512, 1])
def test_clip_pass_frame_and_counters_equal_plain(dev, clip_cap):
    """raster_frame on the card (C1, K6, K2, K3, the clip pass C2 and K3
    on its count) against the same steps through the plain versions on
    the same tensors: the framebuffer, n_straddle, overflowed and the
    class counts bit for bit, at no straddler (1080p), 1 (the view
    scene), 2 (the near-clip golden; past clip_cap at 1 slot) and 888
    (the straddle scene, past clip_cap)."""
    for case in _clip_cases(dev):
        clip, normal, valid, w, h, cm, far, count = case
        fb, rc = tcc.raster_frame(clip, normal, valid, w, h, cell_mask=cm,
                                  far_w=far, count=count, decode=False,
                                  clip_cap=clip_cap)
        want_fb, want_counts, want_n = _raster_plain_on_card(
            *case, clip_cap)
        assert torch.equal(fb, want_fb)
        assert torch.equal(rc.n_per_class, want_counts)
        assert torch.equal(rc.n_straddle, want_n)
        assert bool(rc.overflowed) == (int(want_n) > clip_cap)


def _frame_bits(frame):
    return [frame.image.view(torch.int32) if frame.image.dtype
            == torch.float32 else frame.image, frame.depth.view(torch.int32),
            frame.n_leaves, frame.n_generated, frame.overflowed]


@pytest.mark.parametrize("name", ["nearclip", "frame"])
def test_captured_render_equals_eager_and_toggles_wireframe(dev, name):
    """DeviceRenderer.render (the geometry graph, then the raster graph)
    over three frames equals the eager build_device_render bit for bit in
    image, depth and counts; the launches of a frame include C1, K6, K2
    and K3; with wireframe toggled between frames each value's raster
    graph equals the eager raster on the same geometry."""
    cfg = EngineConfig()
    cam = cam_mod.Camera(position=np.load(GOLD + f"{name}_cam.npy"),
                         angles=np.load(GOLD + f"{name}_angles.npy"))
    args = stage_times.camera_args(cfg, cam, 800, 600)
    kw = dict(cap=1024, render_cap=512, gen_cap=512)
    r = device_step.DeviceRenderer(cfg, 800, 600, device=dev, **kw)
    eager = device_step.build_device_render(cfg, 800, 600, device=dev, **kw)
    pool_g, pool_e = r.init_pool(), r.init_pool()
    for _ in range(3):
        got = r.render(pool_g, *args)
        want = eager(pool_e, *args)
        for a, b in zip(_frame_bits(got), _frame_bits(want)):
            assert torch.equal(a, b)
    assert all(r.graph_launches.get(k, 0) > 0
               for k in ("setup", "gather", "span", "clip", "huge")), \
        r.graph_launches
    for wireframe in (True, False, True):
        r.wireframe = wireframe
        got = r.render(pool_g, *args)
        want, _ = device_step.raster(r.last_geometry, cfg, 800, 600,
                                     wireframe)
        for a, b in zip(_frame_bits(got), _frame_bits(want)):
            assert torch.equal(a, b)
    assert set(r._rasters) == {False, True}


def test_render_after_capture_syncs_nothing(dev):
    """After the captures, a whole render (numpy camera inputs, u8 fetch
    and preview) runs under set_sync_debug_mode("error"); its counts stay
    device tensors."""
    cfg = EngineConfig(window_w=1920, window_h=1080)
    args = stage_times.camera_args(cfg, kernel_times.scene_camera(cfg),
                                   1920, 1080)
    r = device_step.DeviceRenderer(cfg, 1920, 1080, device=dev, fetch="u8",
                                   preview=4)
    pool = r.init_pool()
    r.render(pool, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frame = r.render(pool, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert frame.n_leaves.is_cuda and frame.overflowed.dtype == torch.bool
    assert int(frame.n_leaves) > 100 and not bool(frame.overflowed)
    assert frame.preview.shape == (270, 480)


def test_staged_upload_one_copy_a_frame(dev):
    """The camera inputs reach the card in one queued copy a frame from
    the renderer's pinned staging buffer: over the orbit's 8 frames
    through io/driver.DeviceInteractiveEngine at 1080p (after a warm-up
    frame) one `Memcpy HtoD` from pinned memory a frame and no staging
    wait, the frame's readback having run each copy. PipelinedRenderer
    over 16 orbit frames, each submitted behind a 10-ms spin so that the
    host runs ahead of the card and finds the last staged copy still
    queued, waits for it (`staging_waits` > 0) and returns frames equal
    to the sequential renderer's. Each returned frame is copied out and
    let go, so that its pinned block goes back to the host allocator: a
    fresh 2-MB block a frame can take long enough to pin for the card to
    run the spin and the copy in the meantime, and the host would never
    be ahead. So the host writes the staging buffer while its last copy
    is queued in most frames, and the frames' equality sees the guard:
    with it taken out, the frames come out wrong."""
    from planet_tpu_torch.io.driver import DeviceInteractiveEngine
    cfg = EngineConfig(window_w=1920, window_h=1080)
    eng = DeviceInteractiveEngine(cfg, 1920, 1080, preview=2, device=dev)
    cams = [cam for _, cam in kernel_times.orbit_cameras(cfg)]
    eng.render(cams[0])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for cam in cams:
            eng.render(cam)
        torch.cuda.synchronize()
    uploads = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "Memcpy HtoD" in e.name]
    assert len(uploads) == len(cams) == 8, uploads
    assert all("Pinned" in n for n in uploads), uploads
    assert eng.renderer.staging_waits == 0

    args = [stage_times.camera_args(cfg, cam, 1920, 1080)
            for _, cam in kernel_times.orbit_cameras(cfg, frames=16)]
    seq_r = device_step.DeviceRenderer(cfg, 1920, 1080, device=dev,
                                       fetch="u8")
    pool = seq_r.init_pool()
    seq = []
    for a in args:
        f = seq_r.render(pool, *a)
        seq.append((f.image.cpu().numpy(), int(f.n_leaves),
                    int(f.n_generated)))
    assert seq_r.staging_waits == 0
    r = device_step.DeviceRenderer(cfg, 1920, 1080, device=dev, fetch="u8")
    pipe = device_step.PipelinedRenderer(r, r.init_pool())
    spin = int(10e-3 * tools_common.sm_clock_hz())
    got = []

    def keep(out):
        image, frame = out
        got.append((image.copy(), int(frame.n_leaves),
                    int(frame.n_generated)))

    for a in args:
        torch.cuda._sleep(spin)
        out = pipe.submit(*a)
        if out is not None:
            keep(out)
        del out
    keep(pipe.flush())
    assert len(got) == len(seq) == 16
    for (image, n, n_gen), (want, n_want, n_gen_want) in zip(got, seq):
        np.testing.assert_array_equal(image, want)
        assert (n, n_gen) == (n_want, n_gen_want)
    assert r.staging_waits > 0


def test_interactive_frame_spans_share_the_device_clock(dev, tmp_path):
    """Five profiled frames of io/driver.DeviceInteractiveEngine at 1080p
    from a new engine: the graphs' captures (planet/capture, the geometry
    step's and the raster's) in the first frame alone. Over the four later
    frames, with the device's events put on the host's clock by their own
    direct launches (tools/span_split: the profiler's two clocks can drift
    apart by hundreds of us), every kernel and fill a frame launches
    starts on the card after the start of that frame's geometry
    planet/replay, and its three device-to-host copies (the preview, the
    two counts), launched in its planet/readback, end before it ends."""
    from planet_tpu_torch.io.driver import DeviceInteractiveEngine
    from planet_tpu_torch.tools import span_split
    cfg = EngineConfig(window_w=1920, window_h=1080)
    eng = DeviceInteractiveEngine(cfg, 1920, 1080, preview=2, device=dev)
    cam = kernel_times.scene_camera(cfg)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            eng.render(cam)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ev = span_split.load(path)
    spans = span_split.spans(ev)
    renders = [s for s in spans if s[2] == "planet/render"]
    assert len(renders) == 5

    def within(name, outer):
        return [s for s in spans if s[2] == name
                and outer[0] <= s[0] and s[1] <= outer[1]]

    assert [len(within("planet/capture", r)) for r in renders] == [
        2, 0, 0, 0, 0]
    fit = span_split.clock_fit(ev, renders[1:])
    move = span_split.shift(fit, renders[1][0], renders[-1][1])
    calls = {e["args"]["correlation"]: float(e["ts"]) for e in ev
             if e.get("ph") == "X"
             and e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}

    def launched_in(e, span):
        call = calls.get(e.get("args", {}).get("correlation"))
        return call is not None and span[0] <= call <= span[1]

    def on_host(e):
        a = float(e["ts"])
        return a - move(a), a + float(e["dur"]) - move(a)

    device = [e for e in ev if e.get("ph") == "X"]
    for render in renders[1:]:
        (geometry,) = within("planet/geometry", render)
        (replay,) = within("planet/replay", geometry)
        work = [on_host(e)[0] for e in device
                if e.get("cat") in ("kernel", "gpu_memset")
                and launched_in(e, render)]
        assert len(work) > 50 and min(work) >= replay[0]
        (readback,) = within("planet/readback", render)
        fetched = [on_host(e)[1] for e in device
                   if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]
                   and launched_in(e, readback)]
        assert len(fetched) == 3 and max(fetched) <= readback[1]


# ------------------------------------------------------------------ V1

def _assert_tess_equal(args):
    """V1's six outputs equal the plain version's bit for bit (NaNs by
    their bit patterns), one launch."""
    before = _cuda.launches["tess"]
    pv, shade = vertex_cuda.tessellate_shaded_cuda(*args)
    assert _cuda.launches["tess"] == before + 1
    want, want_shade = vertex_cuda.tessellate_shaded_plain(*args)
    for f in pv._fields:
        assert _same_bits(getattr(pv, f), getattr(want, f)), f
    assert _same_bits(shade, want_shade)


@pytest.mark.parametrize("name", ["slerp", "skirt", "linear", "padded"])
def test_tess_kernel_bitwise(dev, name):
    """V1 against its plain version on torch_scenes' vertex batches: every
    (variant_x, variant_y) pair, slerp and linear interpolations, skirts,
    and padding rows whose corner normals are NaN."""
    args = (tess_padded() if name == "padded"
            else tess_batch(*TESS_BATCHES[name]))
    _assert_tess_equal([torch.as_tensor(a, device=dev) for a in args])


@pytest.mark.parametrize("row,corner,axis", [(0, None, None),
                                              (1, 0, None), (1, 3, None),
                                              (2, 2, 1)])
def test_tess_kernel_nan_normal_rows_bitwise(dev, row, corner, axis):
    """V1 takes a row whose corner normals hold a NaN as a padding row
    (its height computed, the NaN word written to the rest) wherever the
    row lies and whichever of its twelve words is NaN, word for word the
    plain version's, which evaluates it: tess_padded's 6 rows (3-5
    padding) with row `row`'s corner `corner`, component `axis` also NaN
    (None: all of them)."""
    args = list(tess_padded())
    cn = args[1].copy()
    cn[row, slice(None) if corner is None else corner,
       slice(None) if axis is None else axis] = np.nan
    args[1] = cn
    _assert_tess_equal([torch.as_tensor(a, device=dev) for a in args])


@pytest.mark.parametrize("grid", [4, 9, 17, 32])
def test_tess_kernel_layouts_bitwise(dev, grid):
    """V1's two blocks a patch row at grids whose halves take one 8-row
    group a warp (4, 9: the second half a row shorter) or two (17, 32;
    at 17 some warps' second group empty), on tess_padded (rows 3-5
    padding) and on a skirt batch."""
    for arrays in (tess_padded(), tess_batch(*TESS_BATCHES["skirt"])):
        _assert_tess_equal([torch.as_tensor(a, device=dev) for a in arrays]
                           + [grid])


def test_tess_kernel_bitwise_on_the_main_path(dev):
    """V1 against its plain version at the main path's shapes
    (kernel_times.tess_inputs: DeviceRenderer's 512 rows at 1080p, 302 of
    them padding rows, as the fused step passes them; PlanetEngine's
    leaves on the three goldens); the plain version's padding rows hold
    the NaN word 0x7fffffff in its five NaN outputs."""
    sets = kernel_times.tess_inputs(dev)
    assert len(sets["1080p static, DeviceRenderer rows"]) == 8
    for args in sets.values():
        _assert_tess_equal(args)
    # the plain version's padding rows hold the NaN word torch's CUDA
    # arithmetic gives, 0x7fffffff, which the kernel writes from a constant
    args = sets["1080p static, DeviceRenderer rows"]
    want, want_shade = vertex_cuda.tessellate_shaded_plain(*args)
    live = tools_common.tess_live(args[1])
    assert 0 < int(live.sum()) < live.numel()
    for t in (want.clip, want.world, want.normal, want.snormal, want_shade):
        words = t[~live].reshape(-1).view(torch.int32)
        assert bool((words == 0x7FFFFFFF).all())


def test_geometry_replay_launches_v1_once(dev):
    """The fused frame's geometry graph launches V1 (in its rows mode) and
    A1 once a replay and U1 never: V1 computes the uniforms in its own
    staging."""
    cfg = EngineConfig(window_w=1920, window_h=1080)
    args = stage_times.camera_args(cfg, kernel_times.scene_camera(cfg),
                                   1920, 1080)
    r = device_step.DeviceRenderer(cfg, 1920, 1080, device=dev)
    pool = r.init_pool()
    r.geometry(pool, *args)     # the warm-up and the capture
    for _ in range(2):
        before = dict(_cuda.launches)
        geom = r.geometry(pool, *args)
        for k, n in (("tess", 1), ("cache", 1), ("uniforms", 0)):
            assert _cuda.launches[k] - before[k] == r._tally[k] == n, k
    assert int(geom.meta[0]) > 100


def test_geometry_replay_refine_layer_nodes(dev):
    """One profiled replay of the fused frame's geometry graph at 1080p:
    after the camera's uploads, the refine layer is at most two fills, R1's
    19 level launches and the DFS order kernel, which A1 follows at once
    (no torch op between R1's last level and A1); the graph's tally counts
    one order launch; K1's kernel is in the replay and K4's is not."""
    cfg = EngineConfig(window_w=1920, window_h=1080)
    args = stage_times.camera_args(cfg, kernel_times.scene_camera(cfg),
                                   1920, 1080)
    r = device_step.DeviceRenderer(cfg, 1920, 1080, device=dev)
    pool = r.init_pool()
    r.geometry(pool, *args)     # the warm-up and the capture
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        r.geometry(pool, *args)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    uploads = [i for i, n in enumerate(names) if "Memcpy HtoD" in n]
    cache = next(i for i, n in enumerate(names) if "cache_kernel" in n)
    assert len(uploads) == 1 and uploads[-1] < cache, names
    refine = names[uploads[-1] + 1:cache]
    levels = [i for i, n in enumerate(refine) if "level_kernel" in n]
    assert len(levels) == 19, refine
    assert len(refine) == levels[-1] + 2 and "order_kernel" in refine[-1], \
        refine
    assert len(refine) <= 24, refine
    assert all("level_kernel" in n for n in refine[levels[0]:-1]), refine
    assert len(refine[:levels[0]]) <= 2, refine
    assert all("FillFunctor" in n or "emset" in n
               for n in refine[:levels[0]]), refine
    assert r._tally["order"] == 1 and r._tally["refine"] == 19
    # K1 runs in the replay; K4 does not (R1 computes its probes' noise)
    assert any("tiles_kernel" in n for n in names), names
    assert not any("noise_kernel" in n for n in names), names


def test_cuda_sqrt_is_correctly_rounded(dev):
    """torch.sqrt on the card is the correctly rounded root, as the
    kernels' sqrtf is, and nums.fp.sqrt_rn takes it there."""
    rng = np.random.default_rng(20)
    x = (rng.uniform(0.0, 1.0, 1 << 20)
         * 10.0 ** rng.integers(-6, 14, 1 << 20)).astype(np.float32)
    t = torch.as_tensor(x, device=dev)
    want = torch.sqrt(t.double()).float()
    assert _same_bits(torch.sqrt(t), want)
    assert _same_bits(sqrt_rn(t), want)
    assert _same_bits(torch.sqrt(t).cpu(), torch.from_numpy(np.sqrt(x)))


def _clone_pool(pool):
    return device_pool.PoolState(*(t.clone() for t in pool))


def _assert_cache_equal(pool, args, kw):
    """A1's outputs and the pool's keys and ticks equal the plain
    version's bit for bit, one launch."""
    got_pool, want_pool = _clone_pool(pool), _clone_pool(pool)
    before = _cuda.launches["cache"]
    got = device_pool_cuda.cache_stage(got_pool, *args, **kw)
    assert _cuda.launches["cache"] == before + 1
    want = device_pool_cuda.cache_stage_plain(want_pool, *args, **kw)
    for f in got._fields:
        assert _same_bits(getattr(got, f), getattr(want, f)), f
    cap = pool.capacity
    for f in ("keys_lo", "keys_hi", "tick"):
        assert torch.equal(getattr(got_pool, f)[:cap],
                           getattr(want_pool, f)[:cap]), f
    assert torch.equal(got_pool.tiles, pool.tiles)
    assert torch.equal(got_pool.now, pool.now)
    return got


def _case_args(c, dev):
    args = [torch.as_tensor(np.ascontiguousarray(c[k]), device=dev)
            for k in ("q_lo", "q_hi", "depth", "corners_hi", "corners_lo")]
    n = torch.tensor(c["n"], dtype=torch.int32, device=dev)
    kw = {k: c[k] for k in ("budget", "gen_cap", "max_lod", "coord_scale")}
    return args, n, kw


@pytest.mark.parametrize("touch", [False, True])
@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_cache_kernel_bitwise(dev, case, touch):
    c = cache_case(case)
    pool = device_pool.PoolState.from_state(c["state"], dev)
    args, n, kw = _case_args(c, dev)
    got = _assert_cache_equal(pool, (*args, n), dict(kw, touch=touch))
    assert int(got.n_generated) == int(got.generate.sum())
    assert (int(got.n_generated) == 0) == (case == "padding")


def test_cache_kernel_refuses_sizes(dev):
    c = cache_case("tie")
    args, n, kw = _case_args(c, dev)
    for cap, rows in ((4097, 8), (64, 4097)):
        pool = device_pool.init(cap, 1, dev)
        a = [t[:1].expand(rows).contiguous() if t.dim() == 1
             else t[:, :1].expand(12, rows).contiguous() for t in args]
        with pytest.raises(ValueError, match="at most 4096"):
            device_pool_cuda.cache_stage(pool, *a, n, **kw)


def _assert_uniforms_equal(args):
    before = _cuda.launches["uniforms"]
    got = uniforms_cuda.uniforms(*args)
    assert _cuda.launches["uniforms"] == before + 1
    want = uniforms_cuda.uniforms_plain(*args)
    for f in got._fields:
        assert _same_bits(getattr(got, f), getattr(want, f)), f
    return got


@pytest.mark.parametrize("case", list(CACHE_CASES) + ["depths"])
def test_uniforms_kernel_bitwise(dev, case):
    """U1 on the cache cases' rows with their crops; "depths" sets every
    depth 0-29 (the skirt's exp2f and division against torch's). A
    padding row's normals hold the NaN word 0x7fffffff in both."""
    c = cache_case("budget" if case == "depths" else case)
    if case == "depths":
        c["depth"] = (np.arange(len(c["depth"])) % 30).astype(np.int32)
    args, n, kw = _case_args(c, dev)
    crop = device_pool_cuda.cache_stage_plain(
        device_pool.PoolState.from_state(c["state"], dev), *args, n,
        **kw).crop
    q_lo, q_hi, depth, c_hi, c_lo = args
    got = _assert_uniforms_equal((
        q_lo, q_hi, crop, depth, c_hi, c_lo,
        torch.as_tensor(c["cam_hi"], device=dev),
        torch.as_tensor(c["cam_lo"], device=dev), c["max_skirt"]))
    pad = got.normals[c["n"]:].reshape(-1).view(torch.int32)
    assert bool((pad == 0x7FFFFFFF).all())


def test_cache_and_uniforms_kernels_bitwise_on_the_main_path(dev):
    """A1 (with and without the touch) and U1 against their plain
    versions on the calls of DeviceRenderer's step at 1080p
    (kernel_times.stage_inputs: the static camera's first two frames and
    the orbit's first four); U1's padding rows' normals the NaN word
    0x7fffffff."""
    caches, rows = kernel_times.stage_inputs(dev)
    generated = []
    for name, (pool, args, kw) in caches.items():
        for touch in (False, True):
            got = _assert_cache_equal(pool, args, dict(kw, touch=touch))
        generated.append(int(got.n_generated))
    assert generated[0] > 100 and max(generated[3:]) > 0, generated
    for args in rows.values():
        got = _assert_uniforms_equal(args[:9])
        live = int(torch.isfinite(got.normals).all(dim=(1, 2)).sum())
        pad = got.normals[live:].reshape(-1).view(torch.int32)
        assert live < args[0].shape[0] and bool((pad == 0x7FFFFFFF).all())


# ------------------------------------------------------ V1's rows mode

def _assert_tess_rows_equal(args, key="tess"):
    """V1's rows mode equals its plain version and (at the narrow grids) V1
    on U1's outputs in all six outputs bit for bit, one V1 launch under
    `key` and no other V1 or U1 launch; returns the outputs."""
    before = dict(_cuda.launches)
    pv, shade = vertex_cuda.tessellate_rows_cuda(*args)
    for k in ("tess", "tess_wide", "uniforms"):
        assert _cuda.launches[k] == before[k] + (k == key), k
    want = vertex_cuda.tessellate_rows_plain(*args)
    pair = (kernel_times.u1_then_v1(args) if key == "tess" else want)
    for other in (want, pair):
        for f in pv._fields:
            assert _same_bits(getattr(pv, f), getattr(other[0], f)), f
        assert _same_bits(shade, other[1])
    return pv, shade


def _assert_padding_words(pv, shade, live):
    """Rows past `live` hold the NaN word in every output but the
    height."""
    for t in (pv.clip, pv.world, pv.normal, pv.snormal, shade):
        words = t[live:].reshape(-1).view(torch.int32)
        assert bool((words == 0x7FFFFFFF).all())
    assert bool(torch.isfinite(pv.height).all())


@pytest.mark.parametrize("case", TESS_ROWS_CASES)
def test_tess_rows_kernel_bitwise(dev, case):
    """V1's rows mode on the cache cases' rows (their crops, every child
    index among them, padding rows of stale and zero words; "depths":
    depths 0-29; "crops": every row cropped)."""
    args, live = tess_rows(case, dev)
    pv, shade = _assert_tess_rows_equal(args)
    _assert_padding_words(pv, shade, live)


@pytest.mark.parametrize("grid", [4, 9, 17])
def test_tess_rows_kernel_layouts_bitwise(dev, grid):
    """V1's rows mode at grids of one and two 8-row groups a warp."""
    args, live = tess_rows("pressure", dev)
    pv, shade = _assert_tess_rows_equal(args[:-1] + (grid,))
    _assert_padding_words(pv, shade, live)


def test_tess_rows_kernel_bitwise_on_the_main_path(dev):
    """V1's rows mode on the calls of DeviceRenderer's step at 1080p
    (kernel_times.stage_inputs: the static camera's first two frames and
    the orbit's first four, 512 rows each)."""
    _, rows = kernel_times.stage_inputs(dev)
    assert len(rows) == 6
    for args in rows.values():
        live = int(tools_common.tess_live(
            uniforms_cuda.uniforms_cuda(*args[:9]).normals).sum())
        assert 100 < live < args[0].shape[0]
        pv, shade = _assert_tess_rows_equal(args)
        _assert_padding_words(pv, shade, live)


def test_tess_rows_kernel_refuses_bad_metadata(dev):
    args, _ = tess_rows("budget", dev)
    bad = list(args)
    bad[4] = args[4].t().contiguous()       # (Q, 12), not (12, Q)
    with pytest.raises(ValueError, match="corners_hi"):
        vertex_cuda.tessellate_rows_cuda(*bad)
    bad = list(args)
    bad[2] = args[2].to(torch.uint8)
    with pytest.raises(ValueError, match="crop"):
        vertex_cuda.tessellate_rows_cuda(*bad)
    bad = list(args)
    bad[9] = args[9].cpu()
    with pytest.raises(ValueError):
        vertex_cuda.tessellate_rows_cuda(*bad)


@pytest.mark.parametrize("case", ["pressure", "crops", "depths", "spill_parent"])
def test_tess_rows_wide_kernel_bitwise(dev, case):
    """V1's wide instance (grid 66, 66 x 66 tiles: 64-vertex patches) equal
    to its plain version in all six outputs bit for bit, counted under its
    own launch key: on live rows, padding rows ("pressure", "spill_parent":
    stale and zero words), every row cropped ("crops") and depths 0-29
    ("depths")."""
    args, live = tess_rows(case, dev, grid=66)
    assert args[-1] == 66 and args[9].shape[1:] == (66, 66)
    pv, shade = _assert_tess_rows_equal(args, key="tess_wide")
    _assert_padding_words(pv, shade, live)
    assert pv.clip.shape == (args[0].shape[0], 66, 66, 4)


def test_p64_frame_captured_equals_eager_and_v1_wide_plain(dev):
    """BASELINE config 3's frame (perfbench/configs/lod-1080p-p64.json: 64-
    vertex patches, 66 x 66 tiles, its quality, cache and caps) at 1920 x
    1080 on three cameras of the flight (perfbench/traffic/flight.json):
    each geometry replay equals the eager step on the card bit for bit
    (leaf rows, slots, tiles, vertices, counts, the pool), launches V1's
    wide instance once and its narrow ones never, the frame does not
    overflow, and V1's wide instance on the eager step's own rows equals
    its plain version bit for bit."""
    cfg, kw, path = _p64(7)
    r = device_step.DeviceRenderer(cfg, 1920, 1080, device=dev, **kw)
    step = device_step.build_geometry_step(cfg, device=dev, **kw)
    pool_g, pool_e = r.init_pool(), r.init_pool()
    roots = device_step.face_roots(cfg.radius, dev)
    calls = []
    real = vertex_cuda.tessellate_rows

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    for k in (0, 24, 48):
        pos, ang = path.at(k)
        args = stage_times.camera_args(cfg, cam_mod.Camera(pos, ang), 1920,
                                       1080)
        before = dict(_cuda.launches)
        got = r.geometry(pool_g, *args)
        if k:     # the first call also ran the warm-up
            assert _cuda.launches["tess_wide"] - before["tess_wide"] == 1
            assert _cuda.launches["tess"] == before["tess"]
        assert r._tally["tess_wide"] == 1 and r._tally["tess"] == 0
        vertex_cuda.tessellate_rows = record
        try:
            want = step(pool_e, *(torch.as_tensor(a, device=dev)
                                  for a in args), *roots)
        finally:
            vertex_cuda.tessellate_rows = real
        for name in ("leaf_lo", "leaf_hi", "leaf_depth", "slot", "tiles",
                     "valid", "vertex_shade", "meta"):
            assert _same_bits(getattr(got, name), getattr(want, name)), name
        for a, b in zip(got.vertices, want.vertices):
            assert _same_bits(a, b)
        for a, b in zip(pool_g, pool_e):
            assert torch.equal(a, b)
        assert int(want.meta[0]) > 300 and not int(want.meta[2])
    assert len(calls) == 3
    for args, kwargs in calls:
        assert kwargs.get("grid", args[-1] if len(args) > 11 else None) == 66
        full = args + (kwargs["grid"],) if "grid" in kwargs else args
        pv, shade = _assert_tess_rows_equal(full, key="tess_wide")



# ---------------------------------- the main path's shapes and paths

W1080, H1080 = 1920, 1080
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _cfg1080(**kw):
    return EngineConfig(window_w=W1080, window_h=H1080, **kw)


def _golden_cam(name):
    return cam_mod.Camera(position=np.load(GOLD + f"{name}_cam.npy"),
                          angles=np.load(GOLD + f"{name}_angles.npy"))


def _fb(width, height, dev):
    return torch.full((height, width), EMPTY, dtype=torch.int32, device=dev)


@contextlib.contextmanager
def _no_host_reads():
    """A block in which torch raises on any host synchronisation."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _ids(q_lo, q_hi, n):
    return set(int(q) for q in quadid.from_words(
        q_lo[:int(n)].cpu().numpy(), q_hi[:int(n)].cpu().numpy()))


def _frame_counts(frame):
    return (int(frame.n_leaves), int(frame.n_generated),
            bool(frame.overflowed))


def _converge(render, counts=_frame_counts, first_overflow=False):
    """Frames until one generates nothing (at most four), none
    overflowing (but the first, with first_overflow: a scene whose leaves
    outnumber the generation slots overflows them once); the last one's
    output."""
    for i in range(4):
        out = render()
        _, n_gen, overflowed = counts(out)
        assert not overflowed or (first_overflow and i == 0)
        if n_gen == 0:
            return out
    raise AssertionError("still generating after four frames")


@pytest.mark.parametrize("case", ["scene, lacunarity 2.0",
                                  "scene, lacunarity 1.7",
                                  "fused, amplitude +", "fused, amplitude -"])
def test_tile_kernel_bitwise_at_the_main_path_shapes(dev, case):
    """K1 on 256 tiles of the 1080p static scene's leaves with octave
    counts 6-18 at lacunarity 2.0 and 1.7, and at the fused frame's
    occupancy (kernel_times.fused_tile_inputs: 24 of 256 slots live, the
    rest count 0) with a positive and a negative amplitude: bitwise."""
    cfg = _cfg1080()
    kw = dict(kind="ridged", gain=cfg.gain, amplitude=cfg.amplitude)
    if case.startswith("scene"):
        leaves = lod_refine.refine(kernel_times.scene_camera(cfg).position,
                                   cfg.max_lod, cfg.radius)
        sel = np.arange(256) % len(leaves.ids)
        ch, cl = tdf.from_f64_np(leaves.corners[sel] * cfg.coord_scale)
        args = (torch.as_tensor(ch, device=dev),
                torch.as_tensor(cl, device=dev),
                torch.as_tensor(6 + np.arange(256, dtype=np.int32) % 13,
                                device=dev))
        kw["lacunarity"] = float(case.rsplit(" ", 1)[1])
    else:
        args = kernel_times.fused_tile_inputs(dev)
        if case.endswith("-"):
            kw["amplitude"] = -cfg.amplitude
    got = tile_cuda.tiles_cuda(*args, **kw)
    assert bool(torch.isfinite(got).all())
    assert _same_bits(got, tile_cuda.tiles_plain(*args, **kw))


def test_noise_kernel_bitwise_at_the_main_path_shapes(dev):
    """K4 at the refine probes' shape (5 x 4096 points around the 1080p
    static scene's leaf corners; ridged 6, and fBm 5 at lacunarity 1.7)
    and at 2^20 seeded points on the sphere x 18 ridged octaves: bitwise,
    finite."""
    cfg = _cfg1080()
    leaves = lod_refine.refine(kernel_times.scene_camera(cfg).position,
                               cfg.max_lod, cfg.radius)
    rng = np.random.default_rng(0)
    probe = leaves.corners.reshape(-1, 3)[np.arange(5 * 4096)
                                          % (4 * len(leaves.ids))]
    probe = (probe + rng.normal(0.0, 50.0, probe.shape)).reshape(5, 4096, 3)
    big = rng.normal(size=(1 << 20, 3))
    big = big / np.linalg.norm(big, axis=1, keepdims=True) * cfg.radius
    for pts, kind, lacunarity, octaves in ((probe, "ridged", 2.0, 6),
                                           (big, "ridged", 2.0, 18),
                                           (probe, "fbm", 1.7, 5)):
        coords = [torch.as_tensor(np.ascontiguousarray(x), device=dev)
                  for a in range(3) for x in tdf.from_f64_np(pts[..., a] * 1e-5)]
        kw = dict(lacunarity=lacunarity, gain=cfg.gain, octaves=octaves)
        got = perlin_cuda.noise_cuda(kind, *coords, **kw)
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, perlin_cuda.noise_plain(kind, *coords, **kw)), \
            (kind, octaves)


@pytest.fixture(scope="module")
def record_sets():
    """kernel_times.record_sets on the card: PlanetEngine's raster inputs
    of the 1080p static scene, the three goldens and the orbit frames with
    huge records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return kernel_times.record_sets(torch.device("cuda"))


def _assert_route_equal_on_card(got, want):
    """K6's class buffers and counts against the plain version's, on the
    card: the counts, and the first count records of each class."""
    sk, hk, ck = got
    sp, hp, cp = want
    assert torch.equal(ck, cp), (ck, cp)
    ns, nh = (int(v) for v in cp)
    assert _same_bits(sk[:ns], sp) and _same_bits(hk[:nh], hp)


def test_route_and_raster_kernels_bitwise_on_the_record_sets(dev,
                                                             record_sets):
    """On kernel_times.record_sets: K6 against its plain version (records
    and counts), its records those of the plain route's gather; K2 on the
    span records and K3 on the huge records (the huge class, then the
    clipped straddlers' triangles), with and without wireframe; the routed
    raster (K6 -> K2 -> K3, the counts on the device) against the plain
    composition, and run again under set_sync_debug_mode("error") with the
    plain route's counts; and K6 on the 1080p scene with every candidate
    dead, huge, span-class or live."""
    assert {"golden nearclip", "golden farclip"} <= {
        name for name, fs in record_sets.items() if fs["huge_recs"].shape[0]}
    for name, fs in record_sets.items():
        w, h = fs["width"], fs["height"]
        tm, live, span = fs["tm"], fs["live"], fs["span"]
        want = tcc.route_records_plain(tm, live, span)
        route = tcc.route_masks_plain(tm, live, span)
        _assert_route_equal_on_card(tcc.route_records_cuda(
            tm, route.clone()), want)
        n_span, n_huge = fs["span_idx"].numel(), fs["huge_idx"].numel()
        assert want[2].tolist() == [n_span, n_huge], name
        assert _same_bits(want[0], fs["span_recs"])
        assert _same_bits(want[1], fs["huge_recs"][:n_huge])
        for wireframe in (False, True):
            for recs, cuda, plain in (
                    (fs["span_recs"], tcc.raster_span_cuda,
                     tcc.raster_span_plain),
                    (fs["huge_recs"], tcc.raster_huge_cuda,
                     tcc.raster_huge_plain)):
                if recs.shape[0]:
                    fbk, fbp = _fb(w, h, dev), _fb(w, h, dev)
                    cuda(recs, fbk, wireframe)
                    plain(recs, fbp, wireframe)
                    _assert_fb_bars(fbk, fbp)
        fbk, fbp = _fb(w, h, dev), _fb(w, h, dev)
        tcc.raster_classes(*tcc.route_records_cuda(tm, route.clone()), fbk)
        if fs["huge_recs"].shape[0] > n_huge:       # the clipped triangles
            tcc.raster_huge_cuda(fs["huge_recs"][n_huge:], fbk)
        tcc.raster_span_plain(fs["span_recs"], fbp)
        tcc.raster_huge_plain(fs["huge_recs"], fbp)
        _assert_fb_bars(fbk, fbp)
        fb = _fb(w, h, dev)
        with _no_host_reads():
            counts = tcc.raster_classes(*tcc.route_records_cuda(tm, route),
                                        fb)
        assert counts.tolist() == [n_span, n_huge], name
    fs = record_sets["1080p static"]
    tm, live, span = fs["tm"], fs["live"], fs["span"]
    alive = tm.clone()
    alive[28] = torch.where(live, -1.0, 0.0)
    for args in ((tm, torch.zeros_like(live), span),
                 (tm, live, torch.full_like(span, 17)),
                 (alive, live, torch.ones_like(span)),
                 (tm, torch.ones_like(live), span)):
        _assert_route_equal_on_card(
            tcc.route_records_cuda(args[0], tcc.route_masks_plain(*args)),
            tcc.route_records_plain(*args))


def test_gather_kernel_bitwise_on_the_config3_flight(dev):
    """K6 on config 3's flight (kernel_times.p64_route_inputs: C1 on the
    2,048 rows of the orbit's eighth frame, 8,712 candidates a row), on
    C1's route, and on route_masks_plain's words with live and span from
    the plain setup as they are, with every candidate dead and with every
    candidate live."""
    p64 = kernel_times.p64_route_inputs(dev)
    tm = p64["tm"]
    assert tm.shape[1] == 2048 * 8712
    _, live, span, _, _ = tcc.setup_plain(*p64["setup"])
    _assert_route_equal_on_card(tcc.route_records_cuda(tm, p64["route"]),
                                tcc.route_records_plain(tm, live, span))
    for lv in (live, torch.zeros_like(live), torch.ones_like(live)):
        _assert_route_equal_on_card(
            tcc.route_records_cuda(tm, tcc.route_masks_plain(tm, lv, span)),
            tcc.route_records_plain(tm, lv, span))


@pytest.mark.parametrize("frame", ["dense", "p64"])
def test_span_kernel_bitwise_on_the_pixel_sized_frames(dev, frame):
    """K2 on the span records of the two frames of pixel-sized triangles
    (kernel_times.dense_route_inputs: the dense cell's 3,177 leaves at
    quality 16; p64_route_inputs: config 3's flight), drawn from K6's
    buffer with the count on the device as the main path draws them, with
    and without wireframe: equal to the plain version bit for bit."""
    inputs = (kernel_times.dense_route_inputs if frame == "dense"
              else kernel_times.p64_route_inputs)(dev)
    ss = kernel_times.span_set(inputs)
    assert ss["span_recs"].shape[0] > 300_000
    for wireframe in (False, True):
        fbk = _fb(ss["width"], ss["height"], dev)
        fbp = _fb(ss["width"], ss["height"], dev)
        tcc.raster_span_cuda(ss["span_buf"], fbk, wireframe,
                             count=ss["counts"][0:1])
        tcc.raster_span_plain(ss["span_recs"], fbp, wireframe)
        _assert_fb_bars(fbk, fbp)


def test_setup_and_clip_kernels_bitwise_on_the_main_path(dev):
    """C1 on kernel_times.setup_inputs (DeviceRenderer's 512 rows at 1080p
    with the leaf count on the device: the static camera's second frame
    and the orbit's first; PlanetEngine's leaves with none: the 1080p
    static scene and the near-clip and far-clip goldens) against its plain
    version; C2, the clip pass, on its straddler mask and block counts
    (kernel_times.clip_inputs, 512 slots): the slots' indices, n_straddle
    (C1's straddler count), the live records and their count bitwise."""
    setups = kernel_times.setup_inputs(dev)
    straddlers = {}
    for name, args in setups.items():
        _, straddlers[name] = _assert_setup_equal(tcc.setup_cuda(*args),
                                                  tcc.setup_plain(*args))
    assert any(straddlers.values()), straddlers
    for name, args in kernel_times.clip_inputs(setups).items():
        want = tcc.clip_pass_plain(*args[:3], *args[4:])
        _assert_clip_pass_equal(tcc.clip_pass_cuda(*args), want)
        assert int(want[1]) == straddlers[name], name


ROUTE_CASES = ("golden frame", "golden nearclip", "golden farclip",
               "1080p rows, leaf count", "view scene", "straddle scene",
               "screen scene, count 10", "screen scene, count 0",
               "dense frame", "p64 flight")


def _route_case(name, dev):
    """C1's arguments (clip, normal, valid, width, height, cell_mask,
    far_w, count) on the route's scenes: the three
    goldens' PlanetEngine leaves (the near-clip golden's straddlers, the
    far-clip golden's far-straddlers, row 28 > 0), DeviceRenderer's 512
    rows at 1080p cut by the leaf count on the device, the view scene
    (near- and far-straddlers), the straddle scene (888 straddlers), the
    screen scene's 976 candidates (no multiple of 256) cut by a device
    count of 10 rows (a block across the parities, whole padding blocks)
    and of 0, and the two frames of pixel-sized triangles
    (kernel_times.dense_route_inputs, p64_route_inputs: 4,096 rows x
    1,800 and 2,048 x 8,712 candidates)."""
    if name in ("dense frame", "p64 flight"):
        r = (kernel_times.dense_route_inputs if name == "dense frame"
             else kernel_times.p64_route_inputs)(dev)
        return r["setup"]
    if name.startswith("golden"):
        cfg = EngineConfig()
        gold = name.split()[1]
        cam = cam_mod.Camera(position=np.load(GOLD + f"{gold}_cam.npy"),
                             angles=np.load(GOLD + f"{gold}_angles.npy"))
        out = PlanetEngine(cfg, device=dev).frame(cam)
        gm = torch.as_tensor(mesh.grid_uv_skirt(cfg.patch_verts)[3],
                             device=dev)
        return (out.vertices.clip, out.vertices.normal,
                gm[None].expand(out.n_leaves, -1, -1), 800, 600,
                mesh.cell_triangle_mask(cfg.patch_verts), cfg.far_plane,
                None)
    if name.startswith("screen"):
        w, h = SCREEN["width"], SCREEN["height"]
        scene = screen_scene(11, w, h, SCREEN["sizes"])
        count = torch.tensor([int(name.split()[-1])], dtype=torch.int32,
                             device=dev)
        return (*(torch.as_tensor(a, device=dev) for a in scene), w, h,
                None, None, count)
    cases = {"view scene": 0, "straddle scene": 3,
             "1080p rows, leaf count": 2}
    return _clip_cases(dev)[cases[name]]


@pytest.mark.parametrize("name", ROUTE_CASES)
def test_setup_kernel_writes_the_route_bitwise(dev, name):
    """C1 (one launch): its mask words and block counts equal
    route_masks_plain's on setup_t's outputs (the plain route's class
    test) word for word, its straddler mask, block counts and live record
    columns equal C1's plain version's; K6 on that route (one launch, its
    scan and scatter) gives the plain route and gather's records in
    candidate order and counts bit for bit; and raster_frame, which runs
    the two, draws the plain composition's framebuffer and counters."""
    args = _route_case(name, dev)
    before = dict(_cuda.launches)
    got = tcc.setup_cuda(*args)
    assert _cuda.launches["setup"] == before["setup"] + 1
    plain = tcc.setup_plain(*args)
    n_live, _ = _assert_setup_equal(got, plain)
    tm, route, straddle, _ = got
    tm_p, live, span = plain[:3]
    want = tcc.route_records_plain(tm_p, live, span)
    _assert_route_equal_on_card(tcc.route_records_cuda(tm, route), want)
    assert _cuda.launches["gather"] == before["gather"] + 1
    assert int(want[2].sum()) == n_live
    if name != "screen scene, count 0":
        assert n_live > 0
    clip, normal, _, w, h, _, far, _ = args
    fb, rc = tcc.raster_frame(*args[:5], cell_mask=args[5], far_w=far,
                              count=args[7], decode=False)
    want_fb = _fb(w, h, dev)
    tcc.raster_span_plain(want[0], want_fb)
    tcc.raster_huge_plain(want[1], want_fb)
    _, n_straddle, recs, n_recs = tcc.clip_pass_plain(
        clip, normal, straddle, w, h, far)
    tcc.raster_huge_plain(recs, want_fb, count=n_recs)
    assert torch.equal(fb, want_fb)
    assert torch.equal(rc.n_per_class, want[2])
    assert torch.equal(rc.n_straddle, n_straddle)


def test_raster_replay_runs_k6_as_two_kernels_after_c1(dev):
    """Two raster-graph replays of DeviceRenderer at 1080p (the static
    camera, after the captures) under the profiler: each runs C1
    (setup_kernel) once and K6 as two kernels, its scan
    (route_offsets_kernel) right after C1 with nothing between, then its
    scatter (route_scatter_kernel), and no first pass
    (route_count_kernel): C1 writes the route. The graph's recorded
    launches count C1 and K6's call once a frame, and the replays add
    them to _cuda.launches."""
    cfg = EngineConfig(window_w=1920, window_h=1080)
    r = device_step.DeviceRenderer(cfg, 1920, 1080, device=dev)
    args = stage_times.camera_args(cfg, kernel_times.scene_camera(cfg),
                                   1920, 1080)
    pool = r.init_pool()
    r.render(pool, *args)
    torch.cuda.synchronize()
    before = dict(_cuda.launches)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            r.render(pool, *args)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    names = [e.name for e in kernels]

    def count(k):
        return sum(k in n for n in names)

    assert count("route_count_kernel") == 0, names
    assert [count(k) for k in ("setup_kernel", "route_offsets_kernel",
                               "route_scatter_kernel")] == [2, 2, 2], names
    for i, n in enumerate(names):
        if "setup_kernel" in n:
            assert "route_offsets_kernel" in names[i + 1], names[i:i + 3]
            assert "route_scatter_kernel" in names[i + 2], names[i:i + 3]
    tally = r.graph_launches
    assert (tally["setup"], tally["gather"]) == (1, 1), tally
    for k in ("setup", "gather"):
        assert _cuda.launches[k] - before[k] == 2, k


def _assert_golden_bars(name, n_leaves, image, depth, counters):
    """A frame of golden scene `name` at tests/test_torch_golden.py's bars
    (torch_scenes.assert_golden_counts and assert_golden_image)."""
    assert_golden_counts(name, n_leaves, counter_values(counters))
    assert_golden_image(name, image.cpu().numpy(), depth.cpu().numpy())


@pytest.mark.parametrize("engine", ["PlanetEngine", "DeviceRenderer"])
@pytest.mark.parametrize("name", ["frame", "nearclip", "farclip"])
def test_golden_scenes_on_the_card(dev, engine, name):
    """The oracle's golden scenes on the card at the golden bars:
    PlanetEngine.render, whose near- and far-clip frames launch K3, and
    DeviceRenderer.render at its default caps (the geometry graph, then
    the raster graph), run until a frame generates nothing (the near-clip
    scene's 354 leaves overflow the 256 generation slots in its first
    frame)."""
    cfg = EngineConfig()
    cam = _golden_cam(name)
    if engine == "PlanetEngine":
        before = _cuda.launches["huge"]
        eng = PlanetEngine(cfg, device=dev)
        out, image, depth = eng.render(cam)
        _assert_golden_bars(name, out.n_leaves, image, depth,
                            eng.last_counters)
        assert (_cuda.launches["huge"] > before) or name == "frame"
    else:
        r = device_step.DeviceRenderer(cfg, 800, 600, device=dev)
        pool = r.init_pool()
        args = stage_times.camera_args(cfg, cam, 800, 600)
        fr = _converge(lambda: r.render(pool, *args), first_overflow=True)
        _assert_golden_bars(name, fr.n_leaves, fr.image, fr.depth,
                            r.last_counters)


def test_fused_frame_at_1080p_matches_planet_engine_on_the_orbit(dev):
    """At 1920x1080: PlanetEngine's static and orbit frames finite, with
    K1, V1, K6 and K2 launched; DeviceRenderer's ten static frames finite
    and not overflowing, one more whole render under
    set_sync_debug_mode("error") bitwise the tenth; on the orbit's first
    eight frames from an empty pool each DeviceRenderer frame's leaf ids
    PlanetEngine's on the same camera; the fused path launching K1, R1,
    A1, V1, C1, K6, K2, C2 and K3 and neither K4 nor U1, and V1 (its rows
    mode) and A1 once a geometry replay and once a capture's warm-up."""
    cfg = _cfg1080()
    cam = kernel_times.scene_camera(cfg)
    orbit = [c for _, c in kernel_times.orbit_cameras(cfg)]
    _cuda.reset_launches()
    eng = PlanetEngine(cfg, device=dev)
    for _ in range(3):
        _, image, _ = eng.render(cam)
        assert bool(torch.isfinite(image).all())
    eng = PlanetEngine(cfg, device=dev)
    orbit_ids = []
    for c in orbit:
        out, image, _ = eng.render(c)
        assert bool(torch.isfinite(image).all())
        orbit_ids.append(out.leaf_ids)
    host = dict(_cuda.launches)
    assert all(host[k] > 0 for k in ("tile", "tess", "gather", "span")), host
    _cuda.reset_launches()
    r = device_step.DeviceRenderer(cfg, W1080, H1080, device=dev)
    pool = r.init_pool()
    args = stage_times.camera_args(cfg, cam, W1080, H1080)
    for _ in range(10):
        fr = r.render(pool, *args)
        assert bool(torch.isfinite(fr.image).all()) and not bool(fr.overflowed)
    image, depth = fr.image.clone(), fr.depth.clone()
    with _no_host_reads():
        fr = r.render(pool, *args)
    assert _same_bits(fr.image, image) and _same_bits(fr.depth, depth)
    pool = r.init_pool()
    for c, want in zip(orbit, orbit_ids):
        fr = r.render(pool, *stage_times.camera_args(cfg, c, W1080, H1080))
        assert bool(torch.isfinite(fr.image).all())
        g, n = r.last_geometry, int(fr.n_leaves)
        np.testing.assert_array_equal(quadid.from_words(
            g.leaf_lo[:n].cpu().numpy(), g.leaf_hi[:n].cpu().numpy()), want)
    fused = dict(_cuda.launches)
    assert all(fused[k] > 0 for k in ("tile", "refine", "cache", "tess",
                                      "setup", "gather", "span", "clip",
                                      "huge")), fused
    assert fused["noise"] == 0 and fused["uniforms"] == 0, fused
    assert r._tally["tess"] == r._tally["cache"] == 1
    assert r._tally["uniforms"] == 0
    for k in ("tess", "cache"):
        assert fused[k] == r.geometry_replays + r.geometry_captures, k


def _bench_config(name):
    """A benchmark configuration (perfbench/configs/<name>.json): its
    EngineConfig and the file's contents."""
    conf = json.loads((ROOT / f"perfbench/configs/{name}.json").read_text())
    fields = EngineConfig.__dataclass_fields__
    return EngineConfig(**{k: v for k, v in conf["settings"].items()
                           if k in fields}), conf


def _p64(seed):
    """BASELINE config 3 as the benchmark runs it
    (perfbench/configs/lod-1080p-p64.json: 64-vertex patches, 66 x 66
    tiles, its quality, cache and caps): its EngineConfig, the renderer's
    keywords and the flight (perfbench/traffic/flight.json) from `seed`."""
    from perfbench.harness import traffic

    cfg, conf = _bench_config("lod-1080p-p64")
    kw = {k: v for k, v in conf["engine"].items() if k != "preview"}
    path = traffic.make(json.loads((ROOT / "perfbench/traffic/flight.json")
                                   .read_text()), seed, cfg.radius)
    return cfg, kw, path


def test_p64_frames_render_on_the_flight(dev):
    """Config 3's frame rendered whole (the geometry graph, then the
    raster graph) at 1920 x 1080 on four cameras of the flight from seed
    0 (frames 0, 24, 48, 72): no overflow, finite images, V1's wide
    instance launched once a geometry replay and once a capture's warm-up
    and its narrow instances never."""
    cfg, kw, path = _p64(0)
    before = dict(_cuda.launches)
    r = device_step.DeviceRenderer(cfg, W1080, H1080, device=dev, **kw)
    pool = r.init_pool()
    for k in (0, 24, 48, 72):
        pos, ang = path.at(k)
        fr = r.render(pool, *stage_times.camera_args(
            cfg, cam_mod.Camera(pos, ang), W1080, H1080))
        assert not bool(fr.overflowed), k
        assert bool(torch.isfinite(fr.image).all()), k
    assert r._tally["tess_wide"] == 1 and r._tally["tess"] == 0
    assert {k: _cuda.launches[k] - before[k] for k in ("tess", "tess_wide")} \
        == {"tess": 0, "tess_wide": r.geometry_replays + r.geometry_captures}


def _driver_engine(name, dev):
    """io/driver.DeviceInteractiveEngine at a benchmark configuration
    (perfbench/configs/<name>.json: its settings and engine keywords)
    and the configuration."""
    from planet_tpu_torch.io.driver import DeviceInteractiveEngine

    cfg, conf = _bench_config(name)
    return DeviceInteractiveEngine(cfg, W1080, H1080, device=dev,
                                   **conf["engine"]), conf


def _frame_events(eng, cam):
    """The device events (kernels, copies, fills) of one driver frame."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eng.render(cam)
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def test_dense_frame_through_the_driver_equals_the_reference(dev):
    """The dense mountain-valley view (perfbench/configs/lod-1080p-q16.json:
    LOD quality 16, cap, render_cap and cache 4,096; the dense traffic's
    camera, tools/kernel_times.dense_camera) at 1920 x 1080 through
    io/driver.DeviceInteractiveEngine: frames 0 (from the empty pool, all
    3,177 tiles generated), 1 and 121 (half a turn on, the cache hitting)
    each draw 3,177 leaves with no overflow flag (geometry or raster) and
    no straddler; frames 0 and 121 equal the benchmark's plain reference
    on the card (perfbench/reference/lod.frame from the pool's
    bookkeeping before the frame) within the configuration's limits
    (perfbench/drivers/lod.compare: leaf rows, tiles, clip-space vertices,
    image, depth, the pool's bookkeeping); a replayed frame runs as many
    device events as a lod-1080p frame through the same driver (the
    look-around's camera)."""
    from perfbench.drivers import lod as drv
    from perfbench.harness import traffic
    from perfbench.reference import lod as ref_lod

    eng, conf = _driver_engine("lod-1080p-q16", dev)
    rcfg = ref_lod.engine_config(conf["settings"])
    path = traffic.make(json.loads((ROOT / "perfbench/traffic/dense.json")
                                   .read_text()), 7, rcfg.radius)
    for k in (0, 1, 121):
        pos, ang = path.at(k)
        p = eng.pool
        book = None if k == 0 else ref_lod.PoolBook(*(t.clone() for t in (
            p.keys_lo, p.keys_hi, p.tick, p.now)))
        out, image, depth = eng.render(cam_mod.Camera(pos, ang))
        r = eng.renderer
        g = r.last_geometry
        assert out.stats.quads == 3177, k
        assert out.stats.tiles_generated == (3177 if k == 0 else 0), k
        assert not bool(g.meta[2]) and not bool(r.last_counters.overflowed)
        assert int(r.last_counters.n_straddle) == 0, k
        if k == 1:
            continue
        kept = dict(n=g.meta[0], leaf_lo=g.leaf_lo, leaf_hi=g.leaf_hi,
                    leaf_depth=g.leaf_depth, tiles=g.tiles,
                    clip=g.vertices.clip, image=image, depth=depth,
                    after=ref_lod.PoolBook(p.keys_lo, p.keys_hi, p.tick,
                                           p.now))
        ref = ref_lod.frame(rcfg, W1080, H1080, conf["engine"], pos, ang,
                            book, dev)
        assert ref.n_leaves == 3177 and not ref.overflowed
        for name, value in drv.compare(kept, ref).items():
            assert value <= conf["limits"][name], (k, name, value)
    dense = _frame_events(eng, cam_mod.Camera(*path.at(122)))
    eng, _ = _driver_engine("lod-1080p", dev)
    look = traffic.make(json.loads((ROOT / "perfbench/traffic/lookaround"
                                    ".json").read_text()), 7, rcfg.radius)
    for k in range(2):
        eng.render(cam_mod.Camera(*look.at(k)))
    base = _frame_events(eng, cam_mod.Camera(*look.at(2)))
    assert len(dense) == len(base), (len(dense), len(base))


def test_config1_flat_patch_through_k4(dev):
    """BASELINE config 1: the flat 256 x 256 patch, fBm 4, through K4: its
    heights within 2e-5 of the host's numpy fBm and bitwise K4's plain
    version on the same noise coordinates; the shade finite."""
    n = 256
    px, py, pz, xyscale = heightfield.flat_patch_points(n, extent=256.0,
                                                        device=dev)
    before = _cuda.launches["noise"]
    c1 = heightfield.field_from_padded_points(
        px, py, pz, xyscale, kind="fbm", octaves=4, gain=0.5, coord_scale=1.0,
        amplitude=1.0)
    assert _cuda.launches["noise"] > before
    assert c1.heights.shape == (n, n) and c1.shade.shape == (n, n)
    assert bool(torch.isfinite(c1.shade).all())
    pts = [(d[0].double() + d[1].double()).cpu().numpy() for d in (px, py, pz)]
    want = perlin_np.fbm(*pts, octaves=4, gain=np.float32(0.5))[1:-1, 1:-1]
    assert float(np.abs(c1.heights.cpu().numpy() - want).max()) <= 2e-5
    plain = perlin_cuda.noise_plain(
        "fbm", *heightfield.noise_coords(px, py, pz, 1.0), lacunarity=2.0,
        gain=np.float32(0.5), octaves=4)[1:-1, 1:-1] * np.float32(1.0)
    assert _same_bits(c1.heights, plain)


@pytest.mark.parametrize("n", [1024, 2048])
def test_field_kernel_bitwise_at_the_configs_sizes(dev, n):
    """K5 at BASELINE config 2's 6 x 1024^2 (through frame_cube, fused) and
    the regen's 6 x 2048^2: bitwise its plain version, finite, and within
    0.2 m in heights and 1e-3 in shade of the composed frame
    (frame_cube(fused=False); tests/test_field_pallas.py's bars)."""
    radius = EngineConfig().radius
    before = _cuda.launches["field"]
    if n == 1024:
        hk, sk = heightfield.frame_cube(n, radius, fused=True, device=dev)
    else:
        hk, sk = field_cuda.field_kernel(n, radius, device=dev)
    assert _cuda.launches["field"] == before + 1
    assert hk.shape == sk.shape == (6, n, n)
    assert bool(torch.isfinite(hk).all() and torch.isfinite(sk).all())
    hp, sp = field_cuda.field_plain(n, radius, device=dev)
    assert _same_bits(hk, hp) and _same_bits(sk, sp)
    del hp, sp
    hc, sc = heightfield.frame_cube(n, radius, fused=False, device=dev)
    assert float((hk - hc).abs().max()) <= 0.2
    assert float((sk - sc).abs().max()) <= 1e-3


def test_config5_strips_match_the_full_cube_and_plain(dev):
    """BASELINE config 5 on one card: the 6 x 8192^2 field as 8 strips of
    1,024 rows, each bitwise equal to the matching rows of one
    field_cube(8192) and to K5's plain version on the same rows; the cube
    finite."""
    n, rows = 8192, 1024
    radius = EngineConfig().radius
    full_h, full_s = field_cuda.field_cube(n, radius, device=dev)
    assert bool(torch.isfinite(full_h).all() and torch.isfinite(full_s).all())
    for row0 in range(0, n, rows):
        h, s = field_cuda.field_cube_strip(n, radius, row0, rows, device=dev)
        strip = slice(row0, row0 + rows)
        assert _same_bits(h, full_h[:, strip]), row0
        assert _same_bits(s, full_s[:, strip]), row0
        hp, sp = field_cuda.field_plain(n, radius, row0, rows, device=dev)
        assert _same_bits(h, hp) and _same_bits(s, sp), row0
        del h, s, hp, sp


def test_attribution_tools_equal_plain_at_their_sizes(dev, record_sets):
    """The attribution tools at their own sizes (noise_stages: 2^22 points
    and 4,096 tiles; lut: 2^22-2^23 lookups; span_parts: 4,096 and 32,768
    records at 1920x1080): every variant equal to its plain version, each
    t_* kernel launched, t_noise's full body equal to K4 and t_tile's to
    K1 on the same inputs; span_parts' per-record bodies on the 1080p
    static scene's span records equal to their plain versions."""
    before = dict(_cuda.launches)
    res_noise = noise_stages.bench("cuda", reps=1)
    res_lut = lut.bench("cuda", reps=1)
    res_span = span_parts.bench("cuda", reps=1)
    for key, rows in (("t_noise", res_noise["t_noise"]),
                      ("t_tile", res_noise["t_tile"]),
                      ("t_lut", res_lut["rows"]),
                      ("t_span", res_span["rows"])):
        assert _cuda.launches[key] > before[key], key
        assert rows and all(r["equal"] for r in rows), \
            [r["name"] for r in rows if not r["equal"]]
    coords = res_noise["inputs"]["coords"]
    k4 = perlin_cuda.noise_cuda("ridged", *coords, octaves=6,
                                gain=np.float32(0.55))
    assert _same_bits(noise_stages.noise_stage("full", coords), k4)
    ch, cl = res_noise["inputs"]["corners"]
    k1 = tile_cuda.tiles_cuda(
        ch, cl, torch.full((ch.shape[0],), 6, dtype=torch.int32, device=dev),
        kind="ridged", gain=0.55, amplitude=8848.0)
    assert _same_bits(noise_stages.tile_stage("full", ch, cl), k1)
    rows = span_parts.bench_given(record_sets["1080p static"]["span_recs"],
                                  W1080, H1080, reps=1)
    assert rows and all(r["equal"] for r in rows), rows


def test_splat_raster_on_the_card_at_1080p(dev):
    """The splat raster at 1920 x 1080, supersample 8 (the driver's rule
    for 1920 wide): S1 at both of the main path's shapes
    (kernel_times.splat_inputs: PlanetEngine's leaves of the static scene
    and DeviceRenderer's 512 rows, padding rows invalid; with and without
    wireframe) under set_sync_debug_mode("error"), bitwise its plain
    version on the same card tensors and, on PlanetEngine's leaves, on CPU
    copies; PlanetEngine's splat raster on the card bitwise the CPU's,
    covering over half the screen (a tenth with wireframe);
    DeviceRenderer's splat frame bitwise the splat of all its rows, drawn
    with no host read, and of its first n_leaves rows; then PlanetEngine's
    and DeviceRenderer's static frames and DeviceRenderer's orbit (its
    first eight frames, from an empty pool) finite, the orbit's leaf ids
    the exact raster's, one S1 launch a frame and a raster capture's
    warm-up, and no K4."""
    ss = max(4, round(W1080 / 240))
    cfg = _cfg1080(raster_mode="splat", raster_supersample=ss)
    cam = kernel_times.scene_camera(cfg)
    for name, sargs in kernel_times.splat_inputs(dev).items():
        with _no_host_reads():
            keys = splat.splat_keys(*sargs)
        assert _same_bits(keys, splat.splat_keys_plain(*sargs)), name
        if name.startswith("PlanetEngine"):
            cpu = [a.cpu() if torch.is_tensor(a) else a for a in sargs]
            assert _same_bits(keys.cpu(), splat.splat_keys_plain(*cpu)), name
    eng = PlanetEngine(cfg, device=dev)
    out = eng.frame(cam)
    grid = torch.as_tensor(mesh.grid_uv_skirt(cfg.patch_verts)[3], device=dev)
    valid = grid[None].expand(out.n_leaves, -1, -1)
    pv_cpu = PatchVertices(*(a.cpu() for a in out.vertices))
    for wireframe in (False, True):
        image, depth = splat_raster(out.vertices, out.vertex_shade, valid,
                                    cfg, W1080, H1080, wireframe)
        image_c, depth_c = splat_raster(pv_cpu, out.vertex_shade.cpu(),
                                        valid.cpu(), cfg, W1080, H1080,
                                        wireframe)
        assert _same_bits(image.cpu(), image_c)
        assert _same_bits(depth.cpu(), depth_c)
        covered = float(torch.isfinite(depth).float().mean())
        assert covered > (0.1 if wireframe else 0.5)
    r = device_step.DeviceRenderer(cfg, W1080, H1080, device=dev)
    pool = r.init_pool()
    args = stage_times.camera_args(cfg, cam, W1080, H1080)
    for wireframe in (False, True):
        r.wireframe = wireframe
        fr = r.render(pool, *args)
        assert bool(torch.isfinite(fr.image).all()) and not bool(fr.overflowed)
        g, n = r.last_geometry, int(fr.n_leaves)
        with _no_host_reads():
            image, depth = splat_raster(g.vertices, g.vertex_shade, g.valid,
                                        cfg, W1080, H1080, wireframe)
        image_n, depth_n = splat_raster(
            PatchVertices(*(a[:n] for a in g.vertices)), g.vertex_shade[:n],
            g.valid[:n], cfg, W1080, H1080, wireframe)
        for a, b in ((image, fr.image), (depth, fr.depth),
                     (image_n, fr.image), (depth_n, fr.depth)):
            assert _same_bits(a, b), wireframe
    r.wireframe = False
    exact = PlanetEngine(_cfg1080(), device=dev)
    orbit = [c for _, c in kernel_times.orbit_cameras(cfg)]
    orbit_ids = [exact.render(c)[0].leaf_ids for c in orbit]
    _cuda.reset_launches()
    captures = r.raster_captures
    for _ in range(3):
        _, image, _ = eng.render(cam)
        assert bool(torch.isfinite(image).all())
        fr = r.render(pool, *args)
        assert bool(torch.isfinite(fr.image).all()) and not bool(fr.overflowed)
    pool = r.init_pool()
    for c, want in zip(orbit, orbit_ids):
        fr = r.render(pool, *stage_times.camera_args(cfg, c, W1080, H1080))
        assert bool(torch.isfinite(fr.image).all())
        g, n = r.last_geometry, int(fr.n_leaves)
        np.testing.assert_array_equal(quadid.from_words(
            g.leaf_lo[:n].cpu().numpy(), g.leaf_hi[:n].cpu().numpy()), want)
    launched = dict(_cuda.launches)
    assert all(launched[k] > 0 for k in ("tile", "refine", "tess")), launched
    assert launched["noise"] == 0, launched
    frames = 3 + 3 + len(orbit)
    assert launched["splat"] == frames + r.raster_captures - captures


def test_splat_flight_through_the_driver_equals_the_reference(dev):
    """The splat flight (perfbench/configs/lod-1080p-splat.json: the
    splat raster at supersample 8, lod-1080p's caps; the flight traffic,
    seed 7) at 1920 x 1080 through io/driver.DeviceInteractiveEngine: its
    first frame (from the empty pool, 14.3 km up) and the first after the
    traffic's 96-frame warm-up (at the same height) equal the benchmark's
    plain reference on the card (perfbench/reference/lod_splat.frame from
    the pool's bookkeeping before the frame) within the configuration's
    limits (perfbench/drivers/lod.compare), each drawing over a quarter of
    the screen; no frame after the first sets the geometry's overflow
    flag; the raster graph launches S1 once a frame and no exact
    raster kernel (C1, K6, K2, C2, K3), the geometry and raster graphs
    replay with no host read, and the u8 preview is every 2nd pixel."""
    from perfbench.drivers import lod as drv
    from perfbench.harness import traffic
    from perfbench.reference import lod_splat as ref_splat

    eng, conf = _driver_engine("lod-1080p-splat", dev)
    cfg, r = eng.cfg, eng.renderer
    assert (cfg.raster_mode, cfg.raster_supersample) == ("splat", 8)
    rcfg = ref_splat.engine_config(conf["settings"])
    path = traffic.make(json.loads((ROOT / "perfbench/traffic/flight.json")
                                   .read_text()), 7, rcfg.radius)
    warm = 96
    exact = ("setup", "gather", "span", "clip", "huge")
    before = dict(_cuda.launches)
    for k in range(warm + 1):
        pos, ang = path.at(k)
        p = eng.pool
        book = None if k == 0 else ref_splat.PoolBook(*(t.clone() for t in (
            p.keys_lo, p.keys_hi, p.tick, p.now)))
        _, image, depth = eng.render(cam_mod.Camera(pos, ang))
        g = r.last_geometry
        assert r.last_counters is None
        # the first frame may spill past gen_cap: an empty pool has no
        # parent tile to crop
        assert k == 0 or not bool(g.meta[2]), k
        if k not in (0, warm):
            continue
        kept = dict(n=g.meta[0], leaf_lo=g.leaf_lo, leaf_hi=g.leaf_hi,
                    leaf_depth=g.leaf_depth, tiles=g.tiles,
                    clip=g.vertices.clip, image=image, depth=depth,
                    after=ref_splat.PoolBook(p.keys_lo, p.keys_hi, p.tick,
                                             p.now))
        ref = ref_splat.frame(rcfg, W1080, H1080, conf["engine"], pos, ang,
                              book, dev)
        assert ref.n_leaves > 100 and ref.overflowed == bool(g.meta[2]), k
        assert ref.filled > W1080 * H1080 // 4, k
        for name, value in drv.compare(kept, ref).items():
            assert value <= conf["limits"][name], (k, name, value)
    launched = {k: _cuda.launches[k] - before[k] for k in _cuda.launches}
    frames = warm + 1
    assert r.raster_captures == 1 and r.geometry_captures == 1
    assert launched["splat"] == frames + r.raster_captures, launched
    assert all(launched[k] == 0 for k in exact), launched
    assert r.graph_launches["splat"] == 1
    assert all(r.graph_launches.get(k, 0) == 0 for k in exact)
    args = stage_times.camera_args(cfg, cam_mod.Camera(*path.at(warm + 1)),
                                   W1080, H1080)
    with _no_host_reads():
        fr = r.render(eng.pool, *args)
    assert fr.preview.dtype == torch.uint8
    assert fr.preview.shape == (H1080 // 2, W1080 // 2)
    assert torch.equal(fr.preview, fr.image[::2, ::2])


def test_terrain_and_heightmap_on_the_card_match_the_goldens(dev):
    """The terrain and heightmap API on the card: RidgedTerrain.height_f64
    and the f64 octave sums bitwise the oracle's goldens,
    generate_tile_f64 bitwise its tiles32 tiles, and generate_tiles_df
    (K4) within 1e-5 of them relative (to at least 884.8 m)."""
    from planet_tpu_torch.geom import cubesphere
    from planet_tpu_torch.models.terrain import RidgedTerrain
    from planet_tpu_torch.ops import heightmap, perlin

    ridged = RidgedTerrain()
    pts = torch.as_tensor(np.load(GOLD + "pts_sphere.npy"), device=dev)
    for name, depth, max_depth in (("terrain_d0_md1", 0, 1),
                                   ("terrain_d6_md18", 6, 18),
                                   ("terrain_d18_md18", 18, 18)):
        np.testing.assert_array_equal(
            ridged.height_f64(pts, depth, max_depth).cpu().numpy(),
            np.load(GOLD + f"{name}.npy"))
    pf = torch.as_tensor(np.load(GOLD + "pts_fbm.npy"), device=dev)
    for name, fn, kw in (
            ("fbm_o4_g05", perlin.fbm_f64, dict(gain=0.5, octaves=4)),
            ("ridged_o18_g055", perlin.ridged_f64,
             dict(gain=0.55, octaves=18)),
            ("fbm_lac17_o5", perlin.fbm_f64,
             dict(lacunarity=1.7, gain=0.5, octaves=5))):
        kw["gain"] = np.float32(kw["gain"])
        np.testing.assert_array_equal(
            fn(pf[:, 0], pf[:, 1], pf[:, 2], **kw).cpu().numpy(),
            np.load(GOLD + f"{name}.npy"))
    tiles32 = np.load(GOLD + "tiles32.npy")
    paths = [(int(r[0]), [int(c) for c in r[1:] if c >= 0])
             for r in np.load(GOLD + "tile_paths.npy")]
    corners = np.stack([cubesphere.corners_from_path(f, d, 6371000.0)
                        for f, d in paths])
    for i, (_, d) in enumerate(paths):
        np.testing.assert_array_equal(heightmap.generate_tile_f64(
            torch.as_tensor(corners[i], device=dev), 32, ridged, len(d),
            18).cpu().numpy(), tiles32[i])
    ch, cl = (torch.as_tensor(a, device=dev)
              for a in tdf.from_f64_np(corners))
    depths = np.array([len(d) for _, d in paths])
    before = _cuda.launches["noise"]
    for depth in np.unique(depths):
        sel = torch.as_tensor(np.nonzero(depths == depth)[0], device=dev)
        got = heightmap.generate_tiles_df(ch[sel], cl[sel], 32, ridged,
                                          int(depth), 18).cpu().numpy()
        want = tiles32[depths == depth]
        assert float((np.abs(got - want)
                      / np.maximum(np.abs(want), 884.8)).max()) <= 1e-5
    assert _cuda.launches["noise"] > before


# the scripted interactive session: moves, look keys, speed digits, a slot
# save and recall, the wireframe toggle, the timing toggle and two PNG
# dumps, one frame a line ("q" ends it)
INTERACTIVE_SCRIPT = (
    "w", "w w", "3 w", "d", "a", "s", "up", "down", "left", "right",
    "sf1", "4 w", "w", "f1", "p", "png", "p", "left up", "w", "sf2 d",
    "right", "5 s", "f2", "png", "2 w", "down", "a d", "t", "t", "w", "q")


class _KeepFrames:
    """run_interactive's engine with each frame's image kept (the device
    engine's image is its raster graph's buffer, which the next frame
    writes)."""

    def __init__(self, engine):
        object.__setattr__(self, "engine", engine)
        object.__setattr__(self, "images", [])

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def __setattr__(self, name, value):
        setattr(self.engine, name, value)

    def render(self, cam, width=None, height=None):
        out = self.engine.render(cam, width, height)
        self.images.append(out[1].clone())
        return out


def _png_pixels(path) -> np.ndarray:
    """The (H, W) u8 pixels of a grayscale PNG written by io/png.py."""
    data = pathlib.Path(path).read_bytes()
    width, height = (int.from_bytes(data[16 + 4 * i:20 + 4 * i], "big")
                     for i in range(2))
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(height, -1)[:, 1:].reshape(height, width)


@pytest.mark.parametrize("engine", ["PlanetEngine", "DeviceInteractiveEngine"])
def test_run_interactive_on_the_card(dev, tmp_path, engine):
    """driver.run_interactive on a 30-frame script at 1920 x 1080 on
    PlanetEngine and on DeviceInteractiveEngine(preview=2): a frametime
    line a frame, each of the two PNG dumps equal to its frame's full
    image, the path's kernels launched (R1 on the device path)."""
    from planet_tpu_torch.io import checkpoint, driver

    cfg = _cfg1080(raster_supersample=8)
    _cuda.reset_launches()
    eng = _KeepFrames(
        PlanetEngine(cfg, device=dev) if engine == "PlanetEngine" else
        driver.DeviceInteractiveEngine(cfg, W1080, H1080, preview=2,
                                       device=dev))
    _, slots = checkpoint.default_state(cfg.radius)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        driver.run_interactive(eng, kernel_times.scene_camera(cfg), slots,
                               W1080, H1080, str(tmp_path),
                               stream=io.StringIO(
                                   "\n".join(INTERACTIVE_SCRIPT) + "\n"))
    assert text.getvalue().count("frametime:") == len(INTERACTIVE_SCRIPT) - 1
    dumps = sorted(tmp_path.iterdir())
    assert len(dumps) == 2
    for path in dumps:
        image = eng.images[int(path.stem.split("_")[1])]
        if image.dtype != torch.uint8:
            image = (torch.clamp(image, 0.0, 1.0) * 255.0 + 0.5).to(
                torch.uint8)
        np.testing.assert_array_equal(_png_pixels(path), image.cpu().numpy())
    kernels = ("tile", "tess", "span", "gather", "huge") + (
        () if engine == "PlanetEngine" else ("refine",))
    assert all(_cuda.launches[k] > 0 for k in kernels), dict(_cuda.launches)


def test_driver_profile_trace_holds_k1(dev, tmp_path):
    """`python -m planet_tpu_torch.io.driver --profile DIR` at 1920 x 1080
    in a process of its own (a long-lived process's later profiler
    sessions can miss the port's ctypes-launched kernels): its trace holds
    K1's kernels."""
    run = subprocess.run(
        [sys.executable, "-m", "planet_tpu_torch.io.driver", "--frames", "2",
         "--width", str(W1080), "--height", str(H1080), "--altitude",
         "20000", "--out", str(tmp_path / "frames"), "--save",
         str(tmp_path / "none.npz"), "--no-save", "--profile",
         str(tmp_path / "profile"), "--backend", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    events = json.loads((tmp_path / "profile" / "trace.json").read_text())
    assert sum("tiles_kernel" in e.get("name", "")
               for e in events.get("traceEvents", [])
               if e.get("cat") == "kernel") > 0


def test_entry_forward_on_the_card_matches_cpu(dev):
    """entry()'s forward on the card (K4's tiles, then the vertex program
    and the shade) against the same forward on CPU tensors: finite, clip
    within 1e-5 of max(|clip|, 1) and shade within 1e-5."""
    from planet_tpu_torch import entry

    forward, args = entry.entry(device=dev)
    before = _cuda.launches["noise"]
    clip, shade = (t.cpu().numpy() for t in forward(*args))
    assert _cuda.launches["noise"] > before
    clip_p, shade_p = (t.numpy() for t in forward(*(a.cpu() for a in args)))
    assert np.isfinite(clip).all() and np.isfinite(shade).all()
    assert float((np.abs(clip - clip_p)
                  / np.maximum(np.abs(clip_p), 1.0)).max()) <= 1e-5
    assert float(np.abs(shade - shade_p).max()) <= 1e-5


def test_sharded_field_steps_on_an_nccl_world_of_one(dev, tmp_path):
    """On an NCCL world of one rank: sharded_field_step (ridged 6, K4) at
    6 x 1024^2 with seam "exchange" and "clamp" bitwise
    unsharded_field_step, its stats within rtol 1e-6, its heights within
    0.2 m and shade within 1e-3 of the composed frame (with "exchange"
    off the face-edge texels, whose differences it changes by design),
    finite; and sharded_field_step_fused at BASELINE config 5's 6 x
    8192^2 bitwise field_cube, its texel count 6 x 8192^2; K4 and K5
    launched."""
    from planet_tpu_torch.parallel import facemesh

    radius = EngineConfig().radius
    n, n5 = 1024, 8192
    before = dict(_cuda.launches)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh1 = sharded.make_mesh(1, device_type="cuda")
        px, py, pz = facemesh.face_grid_points_df(n, radius, device=dev)
        comps = (*px, *py, *pz)
        xyscale = field_cuda.default_xyscale(n, radius)
        hc, sc = heightfield.frame_cube(n, radius, fused=False, device=dev)
        inner = (slice(None), slice(1, -1), slice(1, -1))
        for seam in sharded.SEAMS:
            h, sh, st = sharded.sharded_field_step(
                mesh1, octaves=6, xyscale=xyscale, seam=seam)(*comps)
            uh, ush, ust = sharded.unsharded_field_step(
                octaves=6, xyscale=xyscale, seam=seam)(*comps)
            assert _same_bits(h, uh) and _same_bits(sh, ush), seam
            assert torch.allclose(st, ust, rtol=1e-6, atol=0.0), seam
            assert float((h - hc).abs().max()) <= 0.2, seam
            off = (sh - sc)[inner if seam == "exchange" else ...]
            assert float(off.abs().max()) <= 1e-3, seam
            assert bool(torch.isfinite(sh).all()), seam
        del px, py, pz, comps, hc, sc, h, sh, uh, ush
        h5, s5, st5 = sharded.sharded_field_step_fused(mesh1, n5, radius)()
        f5h, f5s = field_cuda.field_cube(n5, radius, device=dev)
        assert _same_bits(h5, f5h) and _same_bits(s5, f5s)
        assert float(st5[0]) == 6 * n5 ** 2
    finally:
        dist.destroy_process_group()
    assert all(_cuda.launches[k] > before[k] for k in ("noise", "field"))


def test_sharded_lod_at_1080p_on_one_card(dev, tmp_path):
    """The 24 subtree roots at 1920 x 1080 from the static scene's camera
    at DeviceRenderer's default caps, each path run until a frame
    generates nothing: the single-device renderer's leaves from the 24
    roots are its leaves from the six faces with each depth-0 leaf
    replaced by its four children; build_sharded_render on an NCCL world
    of one rank bitwise its frame (image, depth) and leaves; four ranks'
    shares in turn, each with its own pool and graph, disjoint leaf sets
    whose union is its leaves and whose packed framebuffers fold by
    torch.minimum to its; and four processes on the card over gloo, each
    rank's fourth frame bitwise its, the ranks' leaves its leaves; K1,
    R1, V1, K6 and K2 launched in this process."""
    cfg = _cfg1080()
    before = dict(_cuda.launches)
    args = stage_times.camera_args(cfg, kernel_times.scene_camera(cfg),
                                   W1080, H1080)
    faces = device_step.DeviceRenderer(cfg, W1080, H1080, device=dev)
    fpool = faces.init_pool()
    fr = _converge(lambda: faces.render(fpool, *args))
    face_ids = _ids(faces.last_geometry.leaf_lo, faces.last_geometry.leaf_hi,
                    fr.n_leaves)
    roots = sharded_lod.subtree_roots(cfg.radius, dev)
    single = device_step.DeviceRenderer(cfg, W1080, H1080, device=dev,
                                        roots=roots)
    spool = single.init_pool()
    want = _converge(lambda: single.render(spool, *args))
    g = single.last_geometry
    want_packed = device_step.raster_packed(g, cfg, W1080, H1080)[0][0]
    want_ids = _ids(g.leaf_lo, g.leaf_hi, want.n_leaves)
    depth0 = {q for q in face_ids if quadid.depth_of(np.uint64(q)) == 0}
    assert want_ids == (face_ids - depth0) | {
        int(quadid.make_child(np.uint64(q), c)) for q in depth0
        for c in range(4)}

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        fn = sharded_lod.build_sharded_render(
            cfg, sharded.make_mesh(1, axis="quads", device_type="cuda"),
            W1080, H1080)
        pool = device_pool.init(cfg.cache_capacity, cfg.tile_dim, dev)
        frame, (q_lo, q_hi, n, _) = _converge(
            lambda: fn(pool, *args), lambda out: _frame_counts(out[0]))
    finally:
        dist.destroy_process_group()
    assert _same_bits(frame.image, want.image)
    assert _same_bits(frame.depth, want.depth)
    assert _ids(q_lo, q_hi, n) == want_ids

    fold, union = None, set()
    for rank in range(4):
        r = device_step.DeviceRenderer(
            cfg, W1080, H1080, device=dev,
            roots=sharded_lod.local_roots(roots, rank, 4))
        rpool = r.init_pool()
        packed, n, _, _, q_lo, q_hi = _converge(
            lambda: device_step.raster_packed(
                r.geometry(rpool, *args), cfg, W1080, H1080)[0],
            lambda out: (int(out[1]), int(out[2]), bool(out[3])))
        part = _ids(q_lo, q_hi, n)
        assert not union & part, rank
        union |= part
        fold = packed if fold is None else torch.minimum(fold, packed)
    assert union == want_ids
    assert torch.equal(fold, want_packed)
    assert all(_cuda.launches[k] > before[k]
               for k in ("tile", "refine", "tess", "gather", "span"))

    out = str(tmp_path / "ranks")
    spec = dict(cfg=dict(window_w=W1080, window_h=H1080), width=W1080,
                height=H1080, caps={}, device="cuda",
                cases={"d": dict(mesh=(4,), max_lod=None, probe="ridged6",
                                 frames=[args] * 4)})
    torch_ranks.spawn(torch_ranks.lod_worker, 4, out, spec)
    union = set()
    for rank in range(4):
        counts = torch_ranks.load(out, "d.f3", "counts", rank)
        assert counts[3] == 0 and counts[4] == 0, (rank, counts)
        np.testing.assert_array_equal(
            torch_ranks.load(out, "d.f3", "image", rank),
            want.image.cpu().numpy())
        np.testing.assert_array_equal(
            torch_ranks.load(out, "d.f3", "depth", rank),
            want.depth.cpu().numpy())
        union |= set(int(q) for q in quadid.from_words(
            torch_ranks.load(out, "d.f3", "q_lo", rank),
            torch_ranks.load(out, "d.f3", "q_hi", rank)))
    assert union == want_ids


# the static-1080p full rung's device events a replay, all and beyond the
# geometry rung's (145 and 29 since the clip pass sat behind its count
# and A1 and U1 took the cache, generate and uniforms rungs), and those
# three rungs' device events beyond the refine rung's: A1, K1, the
# store's few ops and U1
FULL_EVENTS_MAX, RASTER_EVENTS_MAX, STAGE_EVENTS_MAX = 145, 29, 20


def test_stage_ladder_in_a_process_of_its_own(dev, tmp_path):
    """tools/stage_times (one timed replay a rung) in a fresh process, so
    that its profiler sees the ctypes-launched kernels: both scenes, every
    rung; each rung's leaves DeviceRenderer's at 1080p (the static
    scene's converged frame; the orbit's frames 1-7 from an empty pool);
    each replay holding device events; R1 launched by every rung and K4 by
    none, K1 once from "generate" on, A1 once from "cache" on, U1 on the
    uniforms rung alone, V1 once on the tess, geometry and full rungs, K6
    and K2 on the full rung; no matrix-product kernel in the tess rung's
    trace; the cache, generate and uniforms rungs at most STAGE_EVENTS_MAX
    device events beyond the refine rung's; static-1080p's full rung fewer
    than FULL_EVENTS_MAX device events, fewer than RASTER_EVENTS_MAX beyond
    the geometry rung's."""
    path = tmp_path / "stage_times.json"
    proc = subprocess.run(
        [sys.executable, "-m", "planet_tpu_torch.tools.stage_times", "--reps",
         "1", "--json", str(path)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    scenes = json.loads(path.read_text())["scenes"]
    cfg = _cfg1080()
    r = device_step.DeviceRenderer(cfg, W1080, H1080, device=dev)
    pool = r.init_pool()
    args = stage_times.camera_args(cfg, kernel_times.scene_camera(cfg),
                                   W1080, H1080)
    static_leaves = int(_converge(lambda: r.render(pool, *args)).n_leaves)
    pool = r.init_pool()
    orbit_leaves = [int(r.render(pool, *stage_times.camera_args(
        cfg, c, W1080, H1080)).n_leaves)
        for _, c in kernel_times.orbit_cameras(cfg)]
    assert list(scenes) == ["static-1080p", "moving-1080p"]
    for scene, rows in scenes.items():
        assert [x["rung"] for x in rows] == list(device_step.RUNGS)
        by = {x["rung"]: x for x in rows}
        for x in rows:
            rung, launched = x["rung"], x["launches"]
            want = (static_leaves if scene == "static-1080p"
                    else orbit_leaves[1:len(x["n_leaves"]) + 1])
            assert x["n_leaves"] == want, (scene, rung)
            assert x["kernels"] > 0, (scene, rung)
            assert launched.get("refine", 0) > 0, (scene, rung, launched)
            assert launched.get("noise", 0) == 0, (scene, rung, launched)
            if rung not in ("refine", "cache"):
                assert launched.get("tile", 0) == 1, (scene, rung, launched)
            if rung != "refine":
                assert launched.get("cache", 0) == 1, (scene, rung, launched)
            assert launched.get("uniforms", 0) == (rung == "uniforms"), \
                (scene, rung, launched)
            if rung in ("tess", "geometry", "full"):
                assert launched.get("tess", 0) == 1, (scene, rung, launched)
            if rung == "full":
                assert launched.get("gather", 0) > 0, (scene, launched)
                assert launched.get("span", 0) > 0, (scene, launched)
        assert by["tess"]["gemm_kernels"] == 0, scene
        assert (by["uniforms"]["kernels"] - by["refine"]["kernels"]
                <= STAGE_EVENTS_MAX), scene
    full, geometry = (scenes["static-1080p"][-1],
                      scenes["static-1080p"][-2])
    assert (full["rung"], geometry["rung"]) == ("full", "geometry")
    assert full["kernels"] < FULL_EVENTS_MAX
    assert full["kernels"] - geometry["kernels"] < RASTER_EVENTS_MAX


def test_rungs_from_a_warm_pool_equal_the_renderer(dev):
    """From the pool of a DeviceRenderer that has rendered the 1080p static
    scene until a frame generates nothing: the "geometry" rung's Geometry
    and pool bit for bit DeviceRenderer.geometry's; V1 (its uniforms mode)
    on the "uniforms" rung's U1 outputs, a graph whose one launch is U1,
    the geometry rung's vertices and shade (V1's rows mode) bit for bit;
    the "full" rung's frame bit for bit the renderer's next frame from
    that pool."""
    cfg = _cfg1080()
    args = stage_times.camera_args(cfg, kernel_times.scene_camera(cfg),
                                   W1080, H1080)
    r = device_step.DeviceRenderer(cfg, W1080, H1080, device=dev)
    pool = r.init_pool()
    _converge(lambda: r.render(pool, *args))
    state = [t.clone() for t in pool]
    frame = r.render(pool, *args)
    frame = (frame.image.clone(), frame.depth.clone(), int(frame.n_leaves))

    def pool_at():
        p = device_pool.init(cfg.cache_capacity, cfg.tile_dim, dev)
        for t, v in zip(p, state):
            t.copy_(v)
        return p

    base = device_step.DeviceRenderer(cfg, W1080, H1080, device=dev)
    rung = device_step.DeviceRenderer(cfg, W1080, H1080, device=dev,
                                      stop_after="geometry")
    pool_base, pool_rung = pool_at(), pool_at()
    want = base.geometry(pool_base, *args)
    got = rung.geometry(pool_rung, *args)
    for name in ("leaf_lo", "leaf_hi", "leaf_depth", "slot", "tiles",
                 "valid", "vertex_shade", "meta"):
        assert _same_bits(getattr(got, name), getattr(want, name)), name
    for a, b in zip(got.vertices, want.vertices):
        assert _same_bits(a, b)
    cap = cfg.cache_capacity
    for a, b in zip(pool_rung, pool_base):
        assert _same_bits(a[:cap] if a.dim() else a, b[:cap] if b.dim() else b)
    uni = device_step.DeviceRenderer(cfg, W1080, H1080, device=dev,
                                     stop_after="uniforms")
    pool_uni = pool_at()
    o = uni.geometry(pool_uni, *args).outputs
    tiles = device_pool.gather(pool_uni, o["slot"])
    pv, shade = vertex_cuda.tessellate_shaded(
        o["corners_rel"], o["normals"], tiles, o["vx"], o["vy"], o["skirt"],
        torch.as_tensor(np.asarray(args[2], np.float32), device=dev),
        grid=cfg.patch_verts + 2)
    assert _same_bits(tiles, want.tiles)
    assert all(_same_bits(a, b) for a, b in zip(pv, want.vertices))
    assert _same_bits(shade, want.vertex_shade)
    assert uni.graph_launches.get("uniforms") == 1
    assert uni.graph_launches.get("tess", 0) == 0
    full = device_step.DeviceRenderer(cfg, W1080, H1080, device=dev,
                                      stop_after="full")
    got = full.render(pool_at(), *args)
    assert _same_bits(got.image, frame[0]) and _same_bits(got.depth, frame[1])
    assert int(got.n_leaves) == frame[2]
