"""The port's main path (PlanetEngine.render, plain versions on the CPU)
against the C oracle's golden frames: the altitude frame, the near-surface
frame whose ground cells straddle the near plane, and the high-orbit frame
whose limb crosses the far plane — at the bars of
tests/test_golden_frame.py:71-97, tests/test_golden_nearclip.py:59-87 and
tests/test_golden_farclip.py:56-87. planet_tpu's own golden tests run its
XLA path; these need no XLA compile, so they stay in the fast tier."""

import numpy as np
import pytest
import torch

from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import PlanetEngine
from planet_tpu_torch.geom import camera as cam_mod
from torch_scenes import GOLD, assert_golden_counts, assert_golden_image

torch.set_num_threads(1)


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
    name, out, _, _, rc, _ = scene
    assert_golden_counts(name, out.n_leaves, rc)


def test_image_matches_golden(scene):
    name, _, image, depth, _, _ = scene
    assert_golden_image(name, image, depth)
