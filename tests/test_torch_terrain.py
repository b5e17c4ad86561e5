"""The port's terrain and heightmap API (planet_tpu_torch.models.terrain,
ops.heightmap and the f64 / double-float functions of ops.perlin) against
the oracle goldens and planet_tpu, on the CPU.

* the f64 specification path bit for bit: perlin3_f64 on the unit and
  special points, fbm_f64 / ridged_f64 on the octave goldens,
  RidgedTerrain.height_f64 on terrain_d0_md1, terrain_d6_md18 and
  terrain_d18_md18, and generate_tile_f64 of corners_from_path on tiles32
  (tests/test_perlin_parity.py, tests/test_geom.py:135-152);
* the double-float path (K4's plain version on the CPU) at
  test_perlin_parity.py's and test_geom.py's bars: perlin3_df atol 5e-6,
  the octave sums atol 2e-5 (5e-5 at 18 octaves), terrain and tiles within
  1e-5 relative (heights over max(|h|, 0.1 amplitude));
* tile_points_df and tile_points_f64 bitwise equal to planet_tpu's, called
  eagerly; generate_tiles_df equal to generate_tile_df tile by tile;
* the DF functions reach K4's dispatcher (perlin_cuda.noise_df);
  RidgedTerrain's fields carry across with dataclasses.asdict.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from planet_tpu.models import terrain as jterrain
from planet_tpu.nums import df as jdf
from planet_tpu.ops import heightmap as jheightmap
from planet_tpu_torch.geom import cubesphere as cs
from planet_tpu_torch.models import terrain
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.ops import heightmap, perlin
from planet_tpu_torch.ops.kernels import perlin_cuda

torch.set_num_threads(1)
GOLD = pathlib.Path(__file__).parent / "goldens"
RADIUS = 6371000.0
MAX_LOD = 18


def g(name):
    return np.load(GOLD / f"{name}.npy")


def _paths():
    out = []
    for row in g("tile_paths"):
        out.append((int(row[0]), [int(c) for c in row[1:] if c >= 0]))
    return out


def _df3(pts):
    return tuple(tuple(torch.as_tensor(a) for a in tdf.from_f64_np(pts[:, k]))
                 for k in range(3))


def _split(corners):
    return tuple(torch.as_tensor(a) for a in tdf.from_f64_np(corners))


# ------------------------------------------------------------ f64 spec path


@pytest.mark.parametrize("name", ["unit", "special"])
def test_perlin3_f64_bitexact(name):
    pts = g(f"pts_{name}")
    got = perlin.perlin3_f64(pts[:, 0], pts[:, 1], pts[:, 2], device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), g(f"perlin3_{name}"))


OCTAVE_CASES = [
    ("fbm_o4_g05", "fbm", dict(lacunarity=2.0, gain=0.5, octaves=4)),
    ("fbm_o6_g055", "fbm", dict(lacunarity=2.0, gain=0.55, octaves=6)),
    ("ridged_o6_g055", "ridged", dict(lacunarity=2.0, gain=0.55, octaves=6)),
    ("ridged_o18_g055", "ridged",
     dict(lacunarity=2.0, gain=0.55, octaves=18)),
    ("fbm_lac17_o5", "fbm", dict(lacunarity=1.7, gain=0.5, octaves=5)),
]


@pytest.mark.parametrize("name,kind,kw", OCTAVE_CASES,
                         ids=[c[0] for c in OCTAVE_CASES])
def test_octaves_f64_bitexact(name, kind, kw):
    pts = torch.as_tensor(g("pts_fbm"))
    fn = perlin.fbm_f64 if kind == "fbm" else perlin.ridged_f64
    kw = dict(kw, gain=np.float32(kw["gain"]))
    got = fn(pts[:, 0], pts[:, 1], pts[:, 2], **kw)
    np.testing.assert_array_equal(got.numpy(), g(name))


TERRAIN = [("terrain_d0_md1", 0, 1), ("terrain_d6_md18", 6, 18),
           ("terrain_d18_md18", 18, 18)]


@pytest.mark.parametrize("name,depth,max_depth", TERRAIN)
def test_terrain_f64_bitexact(name, depth, max_depth):
    got = terrain.RidgedTerrain().height_f64(g("pts_sphere"), depth,
                                             max_depth, device="cpu")
    np.testing.assert_array_equal(got.numpy(), g(name))


def test_tiles32_f64_bitexact():
    """path -> corners_from_path -> generate_tile_f64, bit for bit."""
    want = g("tiles32")
    ridged = terrain.RidgedTerrain()
    for i, (face, digits) in enumerate(_paths()):
        corners = cs.corners_from_path(face, digits, RADIUS)
        got = heightmap.generate_tile_f64(torch.as_tensor(corners), 32,
                                          ridged, len(digits), MAX_LOD)
        np.testing.assert_array_equal(got.numpy(), want[i],
                                      err_msg=f"tile {i}")


# ------------------------------------------------------ double-float path


def test_perlin3_df_close():
    got = perlin.perlin3_df(*_df3(g("pts_unit")))
    np.testing.assert_allclose(got.numpy(), g("perlin3_unit"), atol=5e-6)


DF_CASES = [("fbm_o4_g05", "fbm", dict(gain=0.5, octaves=4), 2e-5),
            ("ridged_o6_g055", "ridged", dict(gain=0.55, octaves=6), 2e-5),
            ("ridged_o18_g055", "ridged", dict(gain=0.55, octaves=18), 5e-5),
            ("fbm_lac17_o5", "fbm", dict(lacunarity=1.7, gain=0.5,
                                         octaves=5), 2e-5)]


@pytest.mark.parametrize("name,kind,kw,atol", DF_CASES,
                         ids=[c[0] for c in DF_CASES])
def test_octaves_df_close(name, kind, kw, atol, monkeypatch):
    calls = []
    real = perlin_cuda.noise_df
    monkeypatch.setattr(perlin_cuda, "noise_df",
                        lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    fn = perlin.fbm_df if kind == "fbm" else perlin.ridged_df
    kw = dict(kw, gain=np.float32(kw["gain"]))
    got = fn(*_df3(g("pts_fbm")), **kw)
    assert calls == [kind]              # one dispatch to K4
    np.testing.assert_allclose(got.numpy(), g(name), atol=atol)


@pytest.mark.parametrize("name,depth,max_depth", TERRAIN)
def test_terrain_df_fidelity_bar(name, depth, max_depth):
    want = g(name)
    got = terrain.RidgedTerrain().height_df(*_df3(g("pts_sphere")), depth,
                                            max_depth).numpy()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 8848.0 * 0.1)
    assert float(rel.max()) <= 1e-5, float(rel.max())


def test_tiles32_df_fidelity():
    want = g("tiles32")
    ridged = terrain.RidgedTerrain()
    for i, (face, digits) in enumerate(_paths()):
        ch, cl = _split(cs.corners_from_path(face, digits, RADIUS))
        got = heightmap.generate_tile_df(ch, cl, 32, ridged, len(digits),
                                         MAX_LOD).numpy()
        rel = np.abs(got - want[i]) / np.maximum(np.abs(want[i]), 884.8)
        assert float(rel.max()) <= 1e-5, (i, len(digits), float(rel.max()))


def test_generate_tiles_df_batches_tile_by_tile():
    """One batch at a shared depth equals generate_tile_df on each tile bit
    for bit, and the tiles32 bar holds."""
    paths = _paths()
    depth = len(paths[-1][1])
    corners = np.stack([cs.corners_from_path(f, d, RADIUS)
                        for f, d in paths])
    ch, cl = _split(corners)
    ridged = terrain.RidgedTerrain()
    batch = heightmap.generate_tiles_df(ch, cl, 32, ridged, depth, MAX_LOD)
    assert batch.shape == (len(paths), 32, 32)
    for i in range(len(paths)):
        one = heightmap.generate_tile_df(ch[i], cl[i], 32, ridged, depth,
                                         MAX_LOD)
        assert torch.equal(batch[i], one), i
    want = g("tiles32")[-1]
    rel = np.abs(batch[-1].numpy() - want) / np.maximum(np.abs(want), 884.8)
    assert float(rel.max()) <= 1e-5


def test_tile_points_bitwise_equal_planet_tpu():
    """tile_points_df (the tile kernel's coordinate blend) and
    tile_points_f64 against planet_tpu's, called eagerly, on the tiles32
    corners and the same corners scaled into noise space."""
    assert np.array_equal(heightmap.tile_uv(32), jheightmap.tile_uv(32))
    for face, digits in _paths()[::3]:
        corners = cs.corners_from_path(face, digits, RADIUS)
        for c in (corners, corners * 1e-5):
            ch, cl = _split(c)
            got = heightmap.tile_points_df(ch, cl, 32)
            want = jheightmap.tile_points_df(ch.numpy(), cl.numpy(), 32)
            for (h, lo), w in zip(got, want):
                np.testing.assert_array_equal(h.numpy(), np.asarray(w.hi))
                np.testing.assert_array_equal(lo.numpy(), np.asarray(w.lo))
            np.testing.assert_array_equal(
                heightmap.tile_points_f64(c, 32, device="cpu").numpy(),
                np.asarray(jheightmap.tile_points_f64(c, 32)))


def test_terrain_fields_and_zero_terrain():
    jr = jterrain.RidgedTerrain()
    tr = terrain.RidgedTerrain(**dataclasses.asdict(jr))
    assert tr == terrain.RidgedTerrain()
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    for d in range(19):
        assert (terrain.octave_count(d, MAX_LOD)
                == jterrain.octave_count(d, MAX_LOD))
    pts = g("pts_sphere")[:40]
    zero = terrain.ConstantZeroTerrain()
    h = zero.height_f64(pts, 3, MAX_LOD, device="cpu")
    assert h.dtype == torch.float32 and h.shape == (40,)
    assert not bool(h.any())
    hd = zero.height_df(*_df3(pts), 3, MAX_LOD)
    assert hd.shape == (40,) and not bool(hd.any())
    x = jdf.from_f64(pts[:, 0])
    assert np.asarray(jterrain.ConstantZeroTerrain().height_df(
        x, x, x, 3, MAX_LOD)).shape == tuple(hd.shape)


def test_f64_api_runs_on_the_card_unless_asked():
    """The f64 functions keep a tensor on its device and put an array on
    `device`, which is the card by default."""
    pts = g("pts_sphere")[:8]
    ridged = terrain.RidgedTerrain()
    corners = cs.corners_from_path(2, [1, 3], RADIUS)
    calls = (
        lambda **kw: perlin.perlin3_f64(pts[:, 0], pts[:, 1], pts[:, 2],
                                        **kw),
        lambda **kw: perlin.fbm_f64(pts[:, 0], pts[:, 1], pts[:, 2],
                                    octaves=2, **kw),
        lambda **kw: perlin.ridged_f64(pts[:, 0], pts[:, 1], pts[:, 2],
                                       octaves=2, **kw),
        lambda **kw: ridged.height_f64(pts, 6, MAX_LOD, **kw),
        lambda **kw: terrain.ConstantZeroTerrain().height_f64(pts, 6,
                                                             MAX_LOD, **kw),
        lambda **kw: heightmap.tile_points_f64(corners, 8, **kw),
        lambda **kw: heightmap.generate_tile_f64(corners, 8, ridged, 2,
                                                 MAX_LOD, **kw),
    )
    for call in calls:
        assert call(device="meta").device.type == "meta"
        assert call(device="cpu").device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                call()
    # a tensor stays where it is, whatever `device` says
    t = torch.as_tensor(pts)
    assert perlin.perlin3_f64(t[:, 0], t[:, 1], t[:, 2]).device.type == "cpu"
    assert ridged.height_f64(t, 6, MAX_LOD).device.type == "cpu"
    assert heightmap.tile_points_f64(torch.as_tensor(corners),
                                     8).device.type == "cpu"
