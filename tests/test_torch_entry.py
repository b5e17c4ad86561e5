"""The port's forward step (planet_tpu_torch.entry) against planet_tpu's
(__graft_entry__.entry), on the CPU: the same example arguments bit for
bit, and the forward on the first 4 leaves against planet_tpu's forward
called eagerly (its K4 in Pallas interpret mode):

* tiles within the noise bar of tests/test_torch_tiles.py, 2e-6 x the
  amplitude (the port's fraction and fade are the reference's f64 ones,
  planet_tpu's kernel's are f32);
* clip positions within 1e-5 of max(|clip|, 1) (a height 2e-6 x amplitude
  off moves a vertex by ~2 cm at a clip w of ~1.3e7 m) and shade within
  1e-5 (the normals come from central differences of those heights)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as jentry
from planet_tpu.nums import df as jdf
from planet_tpu.ops import heightmap as jheightmap
from planet_tpu.ops.kernels import perlin_pallas
from planet_tpu_torch import entry
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.models.terrain import RidgedTerrain
from planet_tpu_torch.ops import heightmap

torch.set_num_threads(1)
N = 4
AMP = np.float32(EngineConfig().amplitude)


def _first(args):
    # every argument but the view-projection (index 7) is per quad
    return [a if i == 7 else a[:N] for i, a in enumerate(args)]


@pytest.fixture(scope="module")
def both():
    jf, jargs = jentry.entry()
    tf, targs = entry.entry(device="cpu")
    return jf, jargs, tf, targs


def test_example_args_equal_planet_tpu(both):
    _, jargs, _, targs = both
    assert len(jargs) == len(targs) == 9
    for a, b in zip(jargs, targs):
        assert b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert targs[0].shape[0] > N


def test_tiles_within_the_noise_bar(both):
    """The forward's tiles (generate_tiles_df at 6 octaves) against
    planet_tpu forward's first step: tile_points_df, the DF coord scale,
    perlin_pallas.noise_df (ridged, 6 octaves), the amplitude."""
    _, jargs, _, targs = both
    ch, cl = jnp.asarray(jargs[0][:N]), jnp.asarray(jargs[1][:N])
    pts = [jheightmap.tile_points_df(ch[i], cl[i], 32) for i in range(N)]
    scale = jdf.from_f64(np.float64(1e-5))
    comps = []
    for k in range(3):
        p = jdf.mul(jdf.DF(jnp.stack([q[k].hi for q in pts]),
                           jnp.stack([q[k].lo for q in pts])), scale)
        comps += [p.hi, p.lo]
    want = np.asarray(perlin_pallas.noise_df(
        "ridged", *comps, lacunarity=2.0, gain=np.float32(0.55),
        octaves=6)) * AMP
    got = heightmap.generate_tiles_df(targs[0][:N], targs[1][:N], 32,
                                      RidgedTerrain(), entry.DEPTH,
                                      entry.MAX_DEPTH).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * AMP)


def test_forward_matches_planet_tpu_forward(both):
    jf, jargs, tf, targs = both
    jclip, jshade = (np.asarray(a) for a in jf(*_first(jargs)))
    clip, shade = tf(*_first(targs))
    assert clip.shape == (N, 32, 32, 4) and shade.shape == (N, 32, 32)
    clip, shade = clip.numpy(), shade.numpy()
    assert np.isfinite(clip).all() and np.isfinite(shade).all()
    rel = np.abs(clip - jclip) / np.maximum(np.abs(jclip), 1.0)
    assert float(rel.max()) <= 1e-5, float(rel.max())
    np.testing.assert_allclose(shade, jshade, rtol=0, atol=1e-5)
