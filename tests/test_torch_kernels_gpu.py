"""The port's CUDA kernels (planet_tpu_torch/csrc) against their plain
PyTorch versions on the card. Marked `gpu`; each test skips when there is
no CUDA device. On a machine with one:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

Bars: K1 tiles, K4 noise, K5 field and K6 record gather bitwise; K2 span
and K3 huge raster with identical coverage and packed depth/shade within
1 quantum (they are built with -fmad=false and IEEE division/sqrt, so
equality is expected); K5's row strips equal to the full cube's rows; one
CUDA-graph replay of the fused frame's geometry step bitwise equal to the
same step run eagerly on the card; every variant of the attribution tools
(planet_tpu_torch/tools: t_noise, t_tile, t_lut, t_span) bitwise equal to
its plain version, full noise equal to K4, full tile equal to K1."""

import numpy as np
import pytest
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.engine import device_step
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import PlanetEngine
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.models import heightfield
from planet_tpu_torch.ops.kernels import field_cuda, perlin_cuda, tile_cuda
from planet_tpu_torch.raster import coverage as tcov
from planet_tpu_torch.raster import coverage_cuda as tcc
from planet_tpu_torch.tools import lut, noise_stages, span_parts
from torch_scenes import SCREEN, VIEW, screen_scene, view_scene

pytestmark = pytest.mark.gpu
GOLD = "tests/goldens/"
EMPTY = 2**31 - 1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_fb_bars(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(got == EMPTY, want == EMPTY)
    both = got != EMPTY
    assert np.abs((got[both] >> 10) - (want[both] >> 10)).max(initial=0) <= 1
    assert np.abs((got[both] & 1023) - (want[both] & 1023)).max(initial=0) <= 1


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


def test_gather_kernel_bitwise(dev):
    rng = np.random.default_rng(7)
    tm = torch.as_tensor(rng.normal(size=(32, 1000)).astype(np.float32),
                         device=dev)
    idx = np.concatenate([rng.integers(0, 1000, 777), [1000, -1, 999, 0]])
    idx = torch.as_tensor(idx.astype(np.int32), device=dev)
    got = tcc.gather_records(tm, idx)
    assert torch.equal(got, tcc.gather_records_plain(tm, idx))
    with pytest.raises(ValueError):
        tcc.gather_records_cuda(tm, idx.long())


@pytest.mark.parametrize("wireframe", [False, True])
def test_raster_kernels_match_plain(dev, wireframe):
    for clip, normal, valid, w, h, far in (
            screen_scene(11, SCREEN["width"], SCREEN["height"],
                         SCREEN["sizes"]) + (SCREEN["width"],
                                             SCREEN["height"], None),
            view_scene(VIEW["seed"], VIEW["width"], VIEW["height"],
                       VIEW["far"]) + (VIEW["width"], VIEW["height"],
                                       VIEW["far"])):
        tm, live, span = tcov.setup_t(
            *(torch.as_tensor(a, device=dev) for a in (clip, normal, valid)),
            w, h, far_w=far)
        span_idx, huge_idx = tcc.route(tm, live, span)
        for idx, kernel, plain in ((span_idx, tcc.raster_span_cuda,
                                    tcc.raster_span_plain),
                                   (huge_idx, tcc.raster_huge_cuda,
                                    tcc.raster_huge_plain)):
            assert idx.numel() > 0
            recs = tcc.gather_records(tm, idx)
            fbk = torch.full((h, w), EMPTY, dtype=torch.int32, device=dev)
            fbp = fbk.clone()
            kernel(recs, fbk, wireframe)
            plain(recs, fbp, wireframe)
            _assert_fb_bars(fbk, fbp)


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
        assert r._tally["tile"] == 1 and r._tally["noise"] == 19
        want = step(pool_e, *args)
        for name in ("leaf_lo", "leaf_hi", "leaf_depth", "slot", "tiles",
                     "valid", "vertex_shade", "meta"):
            assert _same_bits(getattr(got, name), getattr(want, name)), name
        for a, b in zip(got.vertices, want.vertices):
            assert _same_bits(a, b)
        for a, b in zip(pool_g, pool_e):
            assert torch.equal(a, b)


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
