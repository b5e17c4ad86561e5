"""The port's copies of planet_tpu's numpy-only modules (the port imports
nothing of planet_tpu) against the originals, one case per copied module:
tables, cube-sphere roots and subdivision (corners_from_path on the tile
goldens' paths), mesh index arrays and the reference vertex list,
EngineConfig fields and octave schedule, camera matrices and camera motion
(update_camera, speed_for_digit, ortho_lh) on seeded inputs, the host
noise chain on the oracle's point goldens, and PNG and checkpoint round
trips."""

import dataclasses
import zlib

import numpy as np
import pytest

from planet_tpu.engine import config as j_config
from planet_tpu.geom import camera as j_camera
from planet_tpu.geom import cubesphere as j_cubesphere
from planet_tpu.io import checkpoint as j_checkpoint
from planet_tpu.io import png as j_png
from planet_tpu.ops import perlin_np as j_perlin_np
from planet_tpu.ops import tables as j_tables
from planet_tpu.tess import mesh as j_mesh
from planet_tpu_torch.engine import config as t_config
from planet_tpu_torch.geom import camera as t_camera
from planet_tpu_torch.geom import cubesphere as t_cubesphere
from planet_tpu_torch.io import checkpoint as t_checkpoint
from planet_tpu_torch.io import png as t_png
from planet_tpu_torch.ops import perlin_np as t_perlin_np
from planet_tpu_torch.ops import tables as t_tables
from planet_tpu_torch.tess import mesh as t_mesh

GOLD = "tests/goldens/"


def _tables(tmp_path):
    for name in ("PERLIN_TABLE", "PERLIN_VECTORS"):
        a, b = getattr(t_tables, name), getattr(j_tables, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t_tables.fused_gradient_tables(),
                    j_tables.fused_gradient_tables()):
        np.testing.assert_array_equal(a, b)


def _cubesphere(tmp_path):
    for r in (1.0, 6371000.0):
        np.testing.assert_array_equal(t_cubesphere.root_corners(r),
                                      j_cubesphere.root_corners(r))
    v = np.random.default_rng(0).normal(size=(50, 3))
    np.testing.assert_array_equal(t_cubesphere.normalize(v),
                                  j_cubesphere.normalize(v))


def _mesh(tmp_path):
    for name in ("PATCH_VERTS", "PATCH_QUADS", "GRID"):
        assert getattr(t_mesh, name) == getattr(j_mesh, name)
    for n in (4, t_mesh.PATCH_VERTS):
        for fn in ("strip_indices", "grid_triangles", "cell_triangle_mask"):
            np.testing.assert_array_equal(getattr(t_mesh, fn)(n),
                                          getattr(j_mesh, fn)(n))
        for a, b in zip(t_mesh.flat_to_grid(n), j_mesh.flat_to_grid(n)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t_mesh.grid_uv_skirt(n), j_mesh.grid_uv_skirt(n)):
            np.testing.assert_array_equal(a, b)
        assert (t_mesh.interior_triangle_count(n)
                == j_mesh.interior_triangle_count(n))


def _config(tmp_path):
    jfields = {f.name: f.default for f in
               dataclasses.fields(j_config.EngineConfig)}
    tfields = dataclasses.fields(t_config.EngineConfig)
    assert len(tfields) >= 16
    for f in tfields:
        assert f.default == jfields[f.name], f.name
    for radius in (6371000.0, 1000.0, 6.0e7):
        t = t_config.EngineConfig(radius=radius)
        j = j_config.EngineConfig(radius=radius)
        for prop in ("patch_quads", "max_lod", "max_skirt_size"):
            assert getattr(t, prop) == getattr(j, prop), prop
        for d in range(t.max_lod + 2):
            assert t.octaves_for_depth(d) == j.octaves_for_depth(d)
            assert t.skirt_size_for_depth(d) == j.skirt_size_for_depth(d)


def _camera(tmp_path):
    rng = np.random.default_rng(3)
    for _ in range(20):
        pos = rng.normal(size=3) * 7e6
        ang = rng.uniform(-3, 3, 3).astype(np.float32)
        np.testing.assert_array_equal(
            t_camera.camera_rotation(t_camera.Camera(pos, ang)),
            j_camera.camera_rotation(j_camera.Camera(pos, ang)))
        pf, aspect = rng.uniform(0.5, 3.0), rng.uniform(0.5, 2.5)
        np.testing.assert_array_equal(
            t_camera.perspective_lh(pf, aspect, 1.0, 2e7),
            j_camera.perspective_lh(pf, aspect, 1.0, 2e7))
        fovy = rng.uniform(0.2, 2.5)
        assert (t_camera.proj_factor_from_fovy(fovy)
                == j_camera.proj_factor_from_fovy(fovy))
        rot = rng.normal(size=(3, 3)).astype(np.float32)
        np.testing.assert_array_equal(t_camera.view_from_rotation(rot),
                                      j_camera.view_from_rotation(rot))
        for fn in ("rot_x", "rot_y", "rot_z"):
            np.testing.assert_array_equal(getattr(t_camera, fn)(ang[0]),
                                          getattr(j_camera, fn)(ang[0]))
    cam = t_camera.Camera(np.array([1.0, 2.0, 3.0]))
    assert cam.copy() is not cam
    np.testing.assert_array_equal(cam.copy().position, cam.position)


def _camera_motion(tmp_path):
    """update_camera, speed_for_digit and ortho_lh (the cases of
    tests/test_models_camera.py:45-79) against the originals."""
    rng = np.random.default_rng(4)
    for _ in range(10):
        pos = rng.normal(size=3) * 7e6
        ang = rng.uniform(-3, 3, 3).astype(np.float32)
        move = rng.normal(size=3).astype(np.float32)
        look = rng.normal(size=3).astype(np.float32)
        tc, jc = t_camera.Camera(pos, ang), j_camera.Camera(pos, ang)
        np.testing.assert_array_equal(
            t_camera.update_camera(tc, move, look, 1000.0, 2.0, 0.5),
            j_camera.update_camera(jc, move, look, 1000.0, 2.0, 0.5))
        np.testing.assert_array_equal(tc.position, jc.position)
        np.testing.assert_array_equal(tc.angles, jc.angles)
    for d in range(1, 9):
        assert t_camera.speed_for_digit(d) == j_camera.speed_for_digit(d)
    assert t_camera.speed_for_digit(8) == 1e8
    for box in ((-2, 2, -1, 1, 5, 15), (0, 800, 600, 0, 1, 2e7)):
        np.testing.assert_array_equal(t_camera.ortho_lh(*box),
                                      j_camera.ortho_lh(*box))
    m = t_camera.ortho_lh(-2, 2, -1, 1, 5, 15)
    assert abs((m @ np.array([0, 0, 5, 1], np.float32))[2] + 1.0) < 1e-6
    assert abs((m @ np.array([0, 0, 15, 1], np.float32))[2] - 1.0) < 1e-6
    cam = t_camera.Camera(position=np.array([0.0, 0.0, -7e6]))
    fwd = t_camera.camera_rotation(cam)[:, 2].astype(np.float64)
    cam2 = cam.copy()
    t_camera.update_camera(cam2, np.array([0.0, 0.0, 1.0]), np.zeros(3),
                           1000.0, 2.0, 0.5)
    np.testing.assert_allclose(cam2.position - cam.position, fwd * 500.0,
                               rtol=1e-6)


def _subdivision(tmp_path):
    """subdivision_grid, child_corners and corners_from_path on the tile
    goldens' paths."""
    radius = 6371000.0
    roots = t_cubesphere.root_corners(radius)
    np.testing.assert_array_equal(
        t_cubesphere.subdivision_grid(roots, radius),
        j_cubesphere.subdivision_grid(roots, radius))
    np.testing.assert_array_equal(t_cubesphere.child_corners(roots, radius),
                                  j_cubesphere.child_corners(roots, radius))
    for row in np.load(GOLD + "tile_paths.npy"):
        face, digits = int(row[0]), [int(c) for c in row[1:] if c >= 0]
        np.testing.assert_array_equal(
            t_cubesphere.corners_from_path(face, digits, radius),
            j_cubesphere.corners_from_path(face, digits, radius))


def _vertex_list(tmp_path):
    for n in (4, 7, t_mesh.PATCH_VERTS):
        got = t_mesh.vertex_list(n)
        assert got.dtype == np.float32 and got.shape == (n * n + 4 * n, 3)
        np.testing.assert_array_equal(got, j_mesh.vertex_list(n))


def _perlin_np(tmp_path):
    pts = np.concatenate([np.load(GOLD + "pts_fbm.npy"),
                          np.load(GOLD + "pts_sphere.npy") * 1e-5])
    x, y, z = pts.T
    np.testing.assert_array_equal(t_perlin_np.perlin3(x, y, z),
                                  j_perlin_np.perlin3(x, y, z))
    for fn, kw in (("fbm", dict(octaves=5, lacunarity=1.7)),
                   ("ridged", dict(octaves=6, gain=np.float32(0.55)))):
        np.testing.assert_array_equal(getattr(t_perlin_np, fn)(x, y, z, **kw),
                                      getattr(j_perlin_np, fn)(x, y, z, **kw))
    sphere = np.load(GOLD + "pts_sphere.npy")
    np.testing.assert_array_equal(t_perlin_np.terrain_height(sphere, 9, 18),
                                  j_perlin_np.terrain_height(sphere, 9, 18))


def _png(tmp_path):
    rng = np.random.default_rng(5)
    for img in (rng.uniform(-0.2, 1.2, (13, 17)).astype(np.float32),
                rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)):
        t_png.write_png(str(tmp_path / "t.png"), img)
        j_png.write_png(str(tmp_path / "j.png"), img)
        data = (tmp_path / "t.png").read_bytes()
        assert data == (tmp_path / "j.png").read_bytes()
        # the round trip: the IDAT payload decodes to the quantized image
        idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
        rows = raw.reshape(img.shape[0], -1)[:, 1:]
        want = img if img.dtype == np.uint8 else \
            (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(rows, want.reshape(img.shape[0], -1))


def _checkpoint(tmp_path):
    rng = np.random.default_rng(9)
    active = t_camera.Camera(rng.normal(size=3) * 7e6,
                             rng.normal(size=3).astype(np.float32))
    slots = [t_camera.Camera(rng.normal(size=3),
                             rng.normal(size=3).astype(np.float32))
             for _ in range(t_checkpoint.N_SLOTS)]
    path = str(tmp_path / "save.npz")
    t_checkpoint.save(path, active, slots)
    for mod in (t_checkpoint, j_checkpoint):     # either reads the other's
        a, s = mod.load(path)
        np.testing.assert_array_equal(a.position, active.position)
        np.testing.assert_array_equal(a.angles, active.angles)
        for got, want in zip(s, slots):
            np.testing.assert_array_equal(got.position, want.position)
            np.testing.assert_array_equal(got.angles, want.angles)
    a, s = t_checkpoint.load(str(tmp_path / "missing.npz"), radius=10.0)
    ja, js = j_checkpoint.default_state(10.0)
    np.testing.assert_array_equal(a.position, ja.position)
    assert isinstance(a, t_camera.Camera) and len(s) == len(js)


@pytest.mark.parametrize("check", [_tables, _cubesphere, _mesh, _config,
                                   _camera, _camera_motion, _subdivision,
                                   _vertex_list, _perlin_np, _png,
                                   _checkpoint],
                         ids=lambda f: f.__name__.strip("_"))
def test_copy_matches_original(check, tmp_path):
    check(tmp_path)
