"""The port's tile generator (planet_tpu_torch.ops.kernels.tile_cuda, plain
PyTorch version on the CPU) against planet_tpu's Pallas tile kernel in
interpret mode, planet_tpu's XLA noise path, and the oracle's goldens.

The port evaluates each octave's fraction and fade at the reference's
precision (f64, narrowed to f32; see planet_tpu_torch/ops/perlin.py), so
it is held to planet_tpu at the noise-level bar of
tests/test_perlin_pallas.py:38 (rtol = atol = 2e-6 on heights divided by
the amplitude), and to the oracle's f64 tiles at the tiles32 bar
(tests/test_tile_pallas.py:35-37) — which it meets bit for bit on almost
every texel.
"""

import numpy as np
import pytest
import torch

from planet_tpu.geom import quadid
from planet_tpu.ops.kernels import tile_pallas
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.ops import perlin as tperlin
from planet_tpu_torch.ops.kernels import tile_cuda

torch.set_num_threads(1)
GOLD = "tests/goldens/"
AMP = np.float32(8848.0)
MAX_DEPTH = 18


def g(name):
    return np.load(GOLD + name + ".npy")


def _golden_corners(n=None):
    corners = g("tile_corners")[:n] * 1e-5        # host f64 pre-scale
    return tdf.from_f64_np(corners)


def _plain(ch, cl, octaves, **kw):
    octs = torch.as_tensor(np.broadcast_to(
        np.asarray(octaves, np.int32), (len(ch),)).copy())
    return tile_cuda.tiles_plain(torch.from_numpy(ch), torch.from_numpy(cl),
                                 octs, gain=0.55, amplitude=8848.0,
                                 **kw).numpy()


@pytest.mark.parametrize("octaves,lacunarity", [(6, 2.0), (18, 2.0),
                                                (6, 1.7)])
def test_plain_matches_pallas_interpret(octaves, lacunarity):
    ch, cl = _golden_corners(8)
    want = np.asarray(tile_pallas.generate_tiles(
        ch, cl, kind="ridged", octaves=octaves, lacunarity=lacunarity,
        gain=np.float32(0.55), amplitude=8848.0, tiles_per_block=8,
        interpret=True))
    got = _plain(ch, cl, octaves, lacunarity=lacunarity)
    np.testing.assert_allclose(got / AMP, want / AMP, rtol=2e-6, atol=2e-6)


def test_plain_matches_oracle_tiles32():
    ch, cl = _golden_corners()
    want = g("tiles32")
    depths = np.array([int(quadid.depth_of(np.uint64(q)))
                       for q in g("tile_ids")])
    octs = 6 + (12 * depths) // MAX_DEPTH
    got = _plain(ch, cl, octs)
    scale = np.maximum(np.abs(want), 8848.0 * 0.1)
    assert float((np.abs(got - want) / scale).max()) <= 1e-5
    # reference-precision fractions and fades: bit-identical almost
    # everywhere (planet_tpu's f32-fade path matches ~25% of texels)
    assert (got == want).mean() > 0.999, (got == want).mean()


def test_mixed_octaves_equal_per_group():
    ch, cl = _golden_corners(12)
    octs = np.array([6, 18, 7, 0, 12, 6, 9, 18, 13, 6, 10, 11], np.int32)
    mixed = _plain(ch, cl, octs)
    for o in np.unique(octs):
        sel = octs == o
        np.testing.assert_array_equal(mixed[sel], _plain(ch[sel], cl[sel], o))
    np.testing.assert_array_equal(mixed[octs == 0], 0.0)


@pytest.mark.parametrize("name,kind,octaves,gain,lac,atol", [
    ("ridged_o18_g055", "ridged", 18, 0.55, 2.0, 5e-5),
    ("fbm_lac17_o5", "fbm", 5, 0.5, 1.7, 2e-5),
])
def test_noise_core_matches_oracle(name, kind, octaves, gain, lac, atol):
    """The noise core alone on the oracle's point set, at the bars of
    tests/test_perlin_pallas.py (int24 and general-lacunarity paths)."""
    pts = g("pts_fbm")
    coords = []
    for i in range(3):
        hi, lo = tdf.from_f64_np(pts[:, i])
        coords += [torch.from_numpy(hi), torch.from_numpy(lo)]
    got = tperlin.accumulate_octaves(kind, octaves, lac, gain, *coords)
    assert np.max(np.abs(got.numpy().astype(np.float64) - g(name))) < atol


def test_generate_tiles_dispatches_plain_on_cpu_and_checks_shapes():
    ch, cl = _golden_corners(2)
    octs = torch.tensor([6, 7], dtype=torch.int32)
    th, tl = torch.from_numpy(ch), torch.from_numpy(cl)
    np.testing.assert_array_equal(
        tile_cuda.generate_tiles(th, tl, octs).numpy(),
        tile_cuda.tiles_plain(th, tl, octs).numpy())
    with pytest.raises(ValueError):
        tile_cuda.generate_tiles(th[:, :3], tl[:, :3], octs)
    with pytest.raises(ValueError):
        tile_cuda.tiles_cuda(th, tl, octs)       # CPU tensor: no kernel


def test_wrapper_checks_metadata():
    """generate_tiles (the K1 wrapper) refuses a wrong shape or dtype from
    metadata alone — the checks the kernel path keeps, which read no tensor
    values, so they hold inside a CUDA-graph capture; the plain version
    also refuses octave counts above MAX_OCTAVES."""
    ch, cl = (torch.from_numpy(a) for a in _golden_corners(2))
    octs = torch.full((2,), 6, dtype=torch.int32)
    for bad in ((ch[:, :3], cl[:, :3], octs), (ch, cl[:1], octs),
                (ch.double(), cl.double(), octs), (ch, cl, octs.long()),
                (ch, cl, octs[:1])):
        with pytest.raises(ValueError):
            tile_cuda.generate_tiles(*bad)
    with pytest.raises(ValueError):
        tile_cuda.generate_tiles(ch, cl, octs, kind="perlin")
    with pytest.raises(ValueError):
        tile_cuda.generate_tiles(ch, cl, octs + tile_cuda.MAX_OCTAVES)
