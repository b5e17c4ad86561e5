"""The port's CUDA kernels (planet_tpu_torch/csrc) against their plain
PyTorch versions on the card. Marked `gpu`; each test skips when there is
no CUDA device. On a machine with one:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

Bars: K1 tiles and K6 record gather bitwise; K2 span and K3 huge raster
with identical coverage and packed depth/shade within 1 quantum (they are
built with -fmad=false and IEEE division/sqrt, so equality is expected)."""

import numpy as np
import pytest
import torch

from planet_tpu.engine.config import EngineConfig
from planet_tpu.geom import camera as cam_mod
from planet_tpu_torch import _cuda
from planet_tpu_torch.engine.planet import PlanetEngine
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.ops.kernels import tile_cuda
from planet_tpu_torch.raster import coverage as tcov
from planet_tpu_torch.raster import coverage_cuda as tcc
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
    assert all(n > 0 for n in _cuda.launches.values()), _cuda.launches
    out_c, img_c, dep_c = PlanetEngine(cfg, device="cpu").render(cam)
    np.testing.assert_array_equal(out_g.leaf_ids, out_c.leaf_ids)
    cov_g = torch.isfinite(dep_g).cpu().numpy()
    cov_c = torch.isfinite(dep_c).numpy()
    assert (cov_g == cov_c).mean() > 0.999
