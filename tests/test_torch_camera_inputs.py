"""The frame's camera inputs bit for bit against the numpy formula they
replace: geom/camera.camera_rotation (np.cross's products and differences
written out, the rotations built without per-scalar conversions) and what
io/driver.DeviceInteractiveEngine.render stages for the device (the
view-projection product and the DF split, written into the renderer's
staging buffer and copied to its static inputs), over 21,000 seeded
cameras 6.3-6.5 Mm from the centre with Euler angles in +-3 rad, a
seventh of them within 1e-3 of the +y pole, where the tangent frame takes
its cross product with z. Compared as uint32 words, so that signed zeros
and NaN payloads count."""

import types

import numpy as np
import pytest
import torch

from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.io.driver import DeviceInteractiveEngine

N_CAMERAS = 21000


def _normalize(v):
    return v / np.linalg.norm(v)


def _rot(rad, rows):
    s, c = np.sin(np.float32(rad)), np.cos(np.float32(rad))
    return np.array(rows(s, c), np.float32)


def _oracle_rotation(cam):
    """camera_rotation as numpy wrote it before: np.cross, np.stack and
    the rotations from lists of float32 scalars. Returns (rotation, True
    where the +y branch took the cross product with z)."""
    up = _normalize(cam.position.astype(np.float32))
    pole = 1.0 - np.dot(up, np.array([0, 1, 0], np.float32)) < 0.1
    axis = [0, 0, 1] if pole else [0, 1, 0]
    right = _normalize(np.cross(up, np.array(axis, np.float32)))
    forward = _normalize(np.cross(right, up))
    base = np.stack([right, up, forward], axis=1)
    ax, ay, az = (float(a) for a in cam.angles)
    rx = _rot(ax, lambda s, c: [[1, 0, 0], [0, c, -s], [0, s, c]])
    ry = _rot(ay, lambda s, c: [[c, 0, s], [0, 1, 0], [-s, 0, c]])
    rz = _rot(az, lambda s, c: [[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return (base @ ry @ rx @ rz).astype(np.float32), bool(pole)


def _cameras():
    rng = np.random.default_rng(25)
    for i in range(N_CAMERAS):
        if i % 7 == 0:
            d = np.array([0.0, 1.0, 0.0]) + rng.uniform(-1e-3, 1e-3, 3)
        else:
            d = rng.normal(size=3)
        pos = d / np.linalg.norm(d) * rng.uniform(6.3e6, 6.5e6)
        yield cam_mod.Camera(pos, rng.uniform(-3.0, 3.0, 3).astype(
            np.float32))


def _words(a):
    a = np.ascontiguousarray(a)
    assert a.dtype == np.float32
    return a.view(np.uint32)


def _staging_engine():
    """A CPU DeviceInteractiveEngine whose renderer stages each frame's
    camera inputs (DeviceRenderer._upload_inputs, as on the card) and
    returns an empty frame instead of running the step and the raster."""
    cfg = EngineConfig(window_w=64, window_h=36)
    eng = DeviceInteractiveEngine(cfg, 64, 36, device="cpu")
    r = eng.renderer
    empty = types.SimpleNamespace(preview=torch.zeros(1), image=None,
                                  depth=None, n_leaves=0, n_generated=0)
    r.render = lambda pool, *args: r._upload_inputs(args) or empty
    return eng


@pytest.mark.parametrize("case", ["rotation", "staged"])
def test_camera_inputs_bitwise_equal_to_the_numpy_formula(case):
    eng = _staging_engine()
    r = eng.renderer
    poles = 0
    for cam in _cameras():
        want, pole = _oracle_rotation(cam)
        poles += pole
        if case == "rotation":
            got = cam_mod.camera_rotation(cam)
            assert got.shape == (3, 3)
            np.testing.assert_array_equal(_words(got), _words(want))
            continue
        pos = np.asarray(cam.position, np.float64)
        hi = pos.astype(np.float32)
        lo = (pos - hi.astype(np.float64)).astype(np.float32)
        vp = (eng._proj @ cam_mod.view_from_rotation(want)).astype(
            np.float32)
        eng.render(cam)
        # the static inputs the graphs read, copied from the staging buffer
        for g, w in zip((r._cam_hi, r._cam_lo, r._vp), (hi, lo, vp)):
            assert g.shape == w.shape
            np.testing.assert_array_equal(_words(g.numpy()), _words(w))
    assert N_CAMERAS // 7 <= poles < 2 * (N_CAMERAS // 7)
