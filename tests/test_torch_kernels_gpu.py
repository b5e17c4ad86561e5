"""The port's CUDA kernels (planet_tpu_torch/csrc) against their plain
PyTorch versions on the card. Marked `gpu`; each test skips when there is
no CUDA device. On a machine with one:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

Bars: K1 tiles (also with count-0 tiles among live ones, and a negative
amplitude), K4 noise (at the refine-probe shape and at sizes that are no
multiple of its block), K5 field (full cube and strips, at n = 128 and
256) and K6 route and gather (records in candidate order and counts,
with dead, far-straddler, tall and span-class candidates, all dead, all
huge, all span) bitwise; K2 span and K3 huge raster framebuffers bitwise
equal to their plain versions (built with -fmad=false and IEEE
division/sqrt), K2 also on adversarial records (near-horizontal and
near-vertical edges, slivers, one-pixel and full-width bboxes, bboxes
clamped at the screen edge, -0.0 edge words, edges it scans whole), K3 on
them too and on a screen-filling triangle, both
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
launched once a geometry replay; C1's straddler block counts and C2, the clip pass, equal to
their plain versions (indices, n_straddle, records and their count), and
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
launching V1 once and U1 never, and U1 on the "uniforms" rung alone;
five profiled interactive frames: the graphs' captures in the first
alone, each later frame's kernels starting after its geometry replay's
span has started, the readback's copies ending inside its span."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from planet_tpu_torch import _cuda
from planet_tpu_torch.cache import device_pool
from planet_tpu_torch.cache import device_pool_cuda
from planet_tpu_torch.engine import device_step
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import PlanetEngine
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.geom import quadid
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.models import heightfield
from planet_tpu_torch.ops.kernels import field_cuda, perlin_cuda, tile_cuda
from planet_tpu_torch.parallel import sharded, sharded_lod
from planet_tpu_torch.raster import coverage as tcov
from planet_tpu_torch.raster import coverage_cuda as tcc
from planet_tpu_torch.raster import splat
from planet_tpu_torch.tess import mesh
from planet_tpu_torch.tess import uniforms_cuda
from planet_tpu_torch.tess import vertex_cuda
from planet_tpu_torch.tools import (kernel_times, lut, noise_stages,
                                    span_parts, stage_times)
from planet_tpu_torch.tools import common as tools_common
import torch_ranks
from torch_scenes import (CACHE_CASES, EDGE, SCREEN, STRADDLE,
                          TESS_BATCHES, TESS_ROWS_CASES, VIEW,
                          adversarial_records, cache_case,
                          nan_shade_records, screen_scene, straddle_scene,
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
    before = _cuda.launches["gather"]
    got = tcc.route_records(tm.to(dev), live.to(dev), span.to(dev))
    assert _cuda.launches["gather"] == before + 1
    want = tcc.route_records_plain(tm, live, span)
    _assert_route_equal(got, want)
    if case == "mixed":
        assert int(want[2][0]) > 0 and int(want[2][1]) > 0
    with pytest.raises(ValueError):
        tcc.route_records_cuda(tm.to(dev), live.to(dev), span.to(dev).long())


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
    """raster_frame's routed part (K6 -> K2 -> K3 on setup_t's outputs)
    under torch.cuda.set_sync_debug_mode("error"): nothing in it
    synchronizes with the host, and it draws what the plain composition
    draws."""
    for tm, live, span, w, h in _scene_setups(dev):
        fb = torch.full((h, w), EMPTY, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            counts = tcc.raster_routed(tm, live, span, fb)
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
    before = _cuda.launches[key]
    got = cuda(recs.to(dev), fb.to(dev))
    assert _cuda.launches[key] == before + 1
    want = plain(recs, fb.clone())
    _assert_fb_bars(got, want)
    covered = want != EMPTY
    assert int(covered.sum()) > 0
    assert torch.equal(want[covered] & 1023,
                       torch.zeros_like(want[covered]))


def test_span_kernel_nan_shades_bitwise(dev):
    """K2 on records whose every fragment has a NaN shade, against its
    plain version: equal bit for bit, every shade packed as 0 (planet_tpu
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
    assert all(_cuda.launches[k] > 0 for k in ("tile", "gather", "span",
                                               "huge")), _cuda.launches
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


def test_graph_replay_equals_eager_step(dev):
    """Two frames of the golden camera: the captured geometry step, replayed,
    gives the eager step's leaf ids, slots, tiles and vertices bit for bit,
    and each replay counts the graph's kernels."""
    cfg = EngineConfig()
    cam = cam_mod.Camera(position=np.load(GOLD + "frame_cam.npy"),
                         angles=np.load(GOLD + "frame_angles.npy"))
    rot = cam_mod.camera_rotation(cam)
    pf = cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg))
    vp = (cam_mod.perspective_lh(pf, 4 / 3, cfg.near_plane, cfg.far_plane)
          @ cam_mod.view_from_rotation(rot)).astype(np.float32)
    cam_hi, cam_lo = tdf.from_f64_np(cam.position)
    kw = dict(cap=1024, render_cap=512, gen_cap=128)
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
    launches R1 19 times (a launch a level), K4 never, K1 once from
    "generate" on, A1 once from "cache" on, U1 on the "uniforms" rung
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
    assert tally["tile"] == (0 if rung in ("refine", "cache") else 1), tally
    assert tally["cache"] == (0 if rung == "refine" else 1), tally
    assert tally["uniforms"] == (1 if rung == "uniforms" else 0), tally
    assert tally["tess"] == (1 if rung in ("tess", "geometry") else 0), tally


def test_dryrun_multichip_on_the_card(dev):
    """entry.dryrun_multichip(2): two gloo ranks sharing the card, every
    check of (a) and (b) (2 is below the 2-axis meshes' 4)."""
    from planet_tpu_torch import entry
    entry.dryrun_multichip(2)


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
    """chip_smoke.py phase 10(b) at 160x120: build_sharded_render on an
    NCCL world of one rank over all 24 roots."""
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
    """chip_smoke.py phase 10(c) at 160x120: four ranks' shares, each with
    its own pool and graph, folded by torch.minimum."""
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
    """C1's (tm, live, span, straddle, blocks) equal the plain version's
    bit for bit: live, span, the straddler mask and its block counts
    everywhere, tm on every live column (the kernel writes no other)."""
    tm_k, live_k, span_k, st_k, blocks_k = got
    tm_p, live_p, span_p, st_p, blocks_p = want
    assert torch.equal(live_k, live_p)
    assert torch.equal(span_k, span_p)
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
        got = tcc.clip_pass_cuda(clip, normal, c1[3], c1[4], w, h, far,
                                 clip_cap)
        assert _cuda.launches["clip"] == before + 1
        lives.append(_assert_clip_pass_equal(got, tcc.clip_pass_plain(
            clip, normal, c1[3], w, h, far, clip_cap)))
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
    leaves on the three goldens)."""
    sets = kernel_times.tess_inputs(dev)
    assert len(sets["1080p static, DeviceRenderer rows"]) == 8
    for args in sets.values():
        _assert_tess_equal(args)


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


def test_cuda_sqrt_is_correctly_rounded(dev):
    """torch.sqrt on the card is the correctly rounded root, as the
    kernels' sqrtf is (nums.fp.sqrt_rn takes it there)."""
    rng = np.random.default_rng(20)
    x = (rng.uniform(0.0, 1.0, 1 << 20)
         * 10.0 ** rng.integers(-6, 14, 1 << 20)).astype(np.float32)
    t = torch.as_tensor(x, device=dev)
    want = torch.sqrt(t.double()).float()
    assert _same_bits(torch.sqrt(t), want)
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
    the orbit's first four)."""
    caches, rows = kernel_times.stage_inputs(dev)
    generated = []
    for name, (pool, args, kw) in caches.items():
        for touch in (False, True):
            got = _assert_cache_equal(pool, args, dict(kw, touch=touch))
        generated.append(int(got.n_generated))
    assert generated[0] > 100 and max(generated[3:]) > 0, generated
    for args in rows.values():
        _assert_uniforms_equal(args[:9])


# ------------------------------------------------------ V1's rows mode

def _assert_tess_rows_equal(args):
    """V1's rows mode equals its plain version and V1 on U1's outputs in
    all six outputs bit for bit, one V1 launch and no U1 launch; returns
    the outputs."""
    before = dict(_cuda.launches)
    pv, shade = vertex_cuda.tessellate_rows_cuda(*args)
    assert _cuda.launches["tess"] == before["tess"] + 1
    assert _cuda.launches["uniforms"] == before["uniforms"]
    want = vertex_cuda.tessellate_rows_plain(*args)
    pair = kernel_times.u1_then_v1(args)
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
