"""The port's main path (PlanetEngine.render, plain versions on the CPU)
against the C oracle's golden frames: the altitude frame, the near-surface
frame whose ground cells straddle the near plane, and the high-orbit frame
whose limb crosses the far plane — at the bars of
tests/test_golden_frame.py:71-97, tests/test_golden_nearclip.py:59-87 and
tests/test_golden_farclip.py:56-87. planet_tpu's own golden tests run its
XLA path; these need no XLA compile, so they stay in the fast tier."""

import pathlib

import numpy as np
import pytest
import torch

from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import PlanetEngine
from planet_tpu_torch.geom import camera as cam_mod
from tests.test_golden_frame import _ssim

torch.set_num_threads(1)
GOLD = pathlib.Path(__file__).parent / "goldens"


@pytest.fixture(scope="module", params=["frame", "nearclip", "farclip"])
def scene(request):
    name = request.param
    cam = cam_mod.Camera(position=np.load(GOLD / f"{name}_cam.npy"),
                         angles=np.load(GOLD / f"{name}_angles.npy"))
    eng = PlanetEngine(EngineConfig(), device="cpu")
    out, image, depth = eng.render(cam)
    return (name, out, image.numpy(), depth.numpy(), eng.last_counters,
            np.load(GOLD / f"{name}_meta.npy"))


def test_leaf_count_and_counters(scene):
    name, out, _, _, rc, meta = scene
    assert out.n_leaves == int(meta[0])
    assert not rc.overflowed
    if name == "nearclip":
        assert rc.n_straddle == int(meta[3])
        assert rc.n_huge > 0
    if name == "farclip":
        assert int(meta[5]) > 1000          # the scene really crosses far
        assert rc.n_huge > 0                # far-straddlers take the huge path


def test_image_matches_golden(scene):
    name, _, image, depth, _, _ = scene
    gold_img = np.load(GOLD / f"{name}_image.npy")
    gold_dep = np.load(GOLD / f"{name}_depth.npy")
    cov, gcov = np.isfinite(depth), np.isfinite(gold_dep)
    if name == "nearclip":
        assert 0.5 < gcov.mean() < 0.95, gcov.mean()
    agree = (cov == gcov).mean()
    assert agree > 0.999, f"coverage agreement {agree}"
    both = cov & gcov
    ds = np.abs(image[both] - gold_img[both])
    assert np.quantile(ds, 0.99) <= 2.5 / 1023, np.quantile(ds, 0.99)
    assert ds.mean() < 1.0 / 1023, ds.mean()
    if name == "frame":
        dd = np.abs(depth[both] - gold_dep[both])
        assert np.quantile(dd, 0.99) < 1e-5, np.quantile(dd, 0.99)
    assert _ssim(image, gold_img) > 0.99
