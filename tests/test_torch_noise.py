"""The port's flat noise (planet_tpu_torch.ops.kernels.perlin_cuda.noise_df,
K4's plain version on the CPU) against planet_tpu's Pallas noise kernel in
interpret mode and the oracle's goldens, at the bars of
tests/test_perlin_pallas.py: 2e-6 against planet_tpu (its kernel vs its
XLA path), 2e-5 absolute against the oracle (5e-5 at 18 octaves), 1e-5
relative on planet-scale terrain. The port takes each octave's fraction
and fade at the reference's f64 precision (ops/perlin.py), so it sits
closer to the oracle than planet_tpu's f32 fade and is not bitwise equal
to planet_tpu."""

import numpy as np
import pytest
import torch

from planet_tpu.nums import df as jdf
from planet_tpu.ops import perlin as jperlin
from planet_tpu.ops.kernels import perlin_pallas as pk
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.ops.kernels import perlin_cuda

torch.set_num_threads(1)
GOLD = "tests/goldens/"


def _split(pts):
    """(..., 3) f64 points -> six f32 DF tensors (x, y, z as hi/lo)."""
    out = []
    for i in range(3):
        out += [torch.from_numpy(np.ascontiguousarray(a))
                for a in tdf.from_f64_np(pts[..., i])]
    return out


@pytest.mark.parametrize("kind,octaves,gain", [
    ("fbm", 4, 0.5), ("fbm", 6, 0.55), ("ridged", 6, 0.55),
    ("ridged", 18, 0.55)])
def test_matches_pallas_interpret(kind, octaves, gain):
    pts = np.load(GOLD + "pts_fbm.npy")[:512]
    x, y, z = (jdf.from_f64(pts[:, i]) for i in range(3))
    want = pk.noise_df(kind, x.hi, x.lo, y.hi, y.lo, z.hi, z.lo,
                       octaves=octaves, gain=np.float32(gain), interpret=True)
    got = perlin_cuda.noise_df(kind, *_split(pts), octaves=octaves,
                               gain=gain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize("name,kind,octaves,gain,lac,atol", [
    ("fbm_o4_g05.npy", "fbm", 4, 0.5, 2.0, 2e-5),
    ("fbm_o6_g055.npy", "fbm", 6, 0.55, 2.0, 2e-5),
    ("ridged_o6_g055.npy", "ridged", 6, 0.55, 2.0, 2e-5),
    ("ridged_o18_g055.npy", "ridged", 18, 0.55, 2.0, 5e-5),
    ("fbm_lac17_o5.npy", "fbm", 5, 0.5, 1.7, 2e-5),
])
def test_matches_oracle(name, kind, octaves, gain, lac, atol):
    pts = np.load(GOLD + "pts_fbm.npy")
    want = np.load(GOLD + name)
    got = perlin_cuda.noise_df(kind, *_split(pts), octaves=octaves,
                               gain=gain, lacunarity=lac)
    assert np.max(np.abs(got.numpy().astype(np.float64) - want)) < atol


def test_terrain_scale():
    """Planet-scale points, DF-scaled by 1e-5, through 18 ridged octaves
    (tests/test_perlin_pallas.py:51-63): within 1e-5 relative."""
    pts = np.load(GOLD + "pts_sphere.npy")
    want = np.load(GOLD + "terrain_d18_md18.npy")
    scale = tuple(torch.tensor(v) for v in tdf.from_f64_np(1e-5))
    coords = _split(pts)
    scaled = []
    for i in range(3):
        scaled += tdf.mul((coords[2 * i], coords[2 * i + 1]), scale)
    x, y, z = ((scaled[2 * i], scaled[2 * i + 1]) for i in range(3))
    got = perlin_cuda.ridged_df(x, y, z, octaves=18, gain=0.55).numpy()
    got = got * np.float32(8848.0)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 8848.0 * 0.1)
    assert float(rel.max()) <= 1e-5, float(rel.max())


def test_odd_2d_shape_keeps_shape():
    """A (7, 33) input comes back (7, 33), equal to planet_tpu's XLA fBm
    within 2e-6 (tests/test_perlin_pallas.py:66-77)."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-50, 50, (7, 33, 3))
    x, y, z = (jdf.from_f64(pts[..., i]) for i in range(3))
    want = jperlin.fbm_df(x, y, z, octaves=2, gain=np.float32(0.5))
    c = _split(pts)
    got = perlin_cuda.fbm_df((c[0], c[1]), (c[2], c[3]), (c[4], c[5]),
                             octaves=2, gain=0.5)
    assert got.shape == (7, 33)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)


def test_checks_arguments():
    c = _split(np.zeros((4, 3)))
    with pytest.raises(ValueError):
        perlin_cuda.noise_df("perlin", *c)
    with pytest.raises(ValueError):
        perlin_cuda.noise_df("fbm", *c, octaves=perlin_cuda.MAX_OCTAVES + 1)
    with pytest.raises(ValueError):
        perlin_cuda.noise_df("fbm", *c[:5], c[5][:3])
    with pytest.raises(ValueError):
        perlin_cuda.noise_df("fbm", *c[:5], c[5].double())
