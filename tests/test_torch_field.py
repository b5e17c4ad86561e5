"""The port's cube-sphere field path (planet_tpu_torch.models.heightfield,
ops/kernels/field_cuda — K5's plain version on the CPU) against
planet_tpu's (tests/test_field_pallas.py and tests/test_models_camera.py,
ported to the port's CPU path).

Bars, from those tests: heights within 0.2 m and shade within 1e-3 of
planet_tpu's fused field kernel (Pallas, interpret mode) and of its
composed XLA frame; strips equal to the full cube bit for bit; config 1
within 2e-5 of the host numpy fBm. The port takes each octave's fraction
and fade in f64 and seeds the DF square root with the correctly rounded
1/sqrt, so it is not bitwise equal to planet_tpu (measured at n=128:
0.0215 m / 1.2e-7 against the fused kernel, 0.0391 m / 1.2e-7 against the
composed frame).
"""

import numpy as np
import pytest
import torch

from planet_tpu.models import heightfield as jhf
from planet_tpu.ops import perlin_np as jperlin_np
from planet_tpu.ops.kernels import field_pallas
from planet_tpu_torch import _cuda
from planet_tpu_torch.models import heightfield as thf
from planet_tpu_torch.ops.kernels import field_cuda

torch.set_num_threads(1)
N = 128
RADIUS = 6.371e6


@pytest.fixture(scope="module")
def jax_fused():
    h, s = field_pallas.field_cube(N, RADIUS, interpret=True, block_rows=32)
    return np.asarray(h), np.asarray(s)


@pytest.fixture(scope="module")
def jax_composed():
    h, s = jhf.frame_cube(N, RADIUS, use_pallas=False)
    return np.asarray(h), np.asarray(s)


@pytest.fixture(scope="module")
def plain():
    return field_cuda.field_plain(N, RADIUS, device="cpu")


@pytest.fixture(scope="module")
def composed():
    return thf.frame_cube(N, RADIUS, fused=False, device="cpu")


def _assert_bars(got, want):
    h, s = (t.numpy() if isinstance(t, torch.Tensor) else t for t in got)
    wh, ws = (t.numpy() if isinstance(t, torch.Tensor) else t for t in want)
    assert h.shape == s.shape == wh.shape == ws.shape == (6, N, N)
    assert np.abs(h - wh).max() <= 0.2, np.abs(h - wh).max()
    assert np.abs(s - ws).max() <= 1e-3, np.abs(s - ws).max()


def test_plain_matches_planet_tpu_field_kernel(plain, jax_fused):
    _assert_bars(plain, jax_fused)


def test_composed_matches_planet_tpu_composed(composed, jax_composed):
    _assert_bars(composed, jax_composed)


def test_fused_matches_composed(plain, composed):
    _assert_bars(plain, composed)


def test_frame_cube_fused_on_cpu_is_the_plain_version(plain):
    before = dict(_cuda.launches)
    h, s = thf.frame_cube(N, RADIUS, fused=True, device="cpu")
    assert _cuda.launches == before
    assert torch.equal(h, plain[0]) and torch.equal(s, plain[1])


@pytest.mark.parametrize("row0", [0, 32, 96])
def test_strip_matches_full_cube(plain, row0):
    h, s = field_cuda.field_cube_strip(N, RADIUS, row0, 32, device="cpu")
    assert h.shape == s.shape == (6, 32, N)
    assert torch.equal(h, plain[0][:, row0:row0 + 32])
    assert torch.equal(s, plain[1][:, row0:row0 + 32])


def test_plain_bands_tile_the_cube(plain, monkeypatch):
    """Evaluating in bands of rows (as at large n) changes no bit."""
    monkeypatch.setattr(field_cuda, "PLAIN_BAND_TEXELS", 24 * N)
    h, s = field_cuda.field_plain(N, RADIUS, device="cpu")
    assert torch.equal(h, plain[0]) and torch.equal(s, plain[1])


def test_shade_is_finite_and_in_lambert_range(plain):
    h, s = plain
    assert bool(torch.isfinite(h).all()) and bool(torch.isfinite(s).all())
    assert float(s.min()) >= np.sqrt(0.001) - 1e-6
    assert float(s.max()) <= np.sqrt(1.001) + 1e-6


@pytest.mark.parametrize("n", [192, 64])
def test_bad_n_rejected(n):
    with pytest.raises(ValueError):
        field_pallas.field_cube(n, RADIUS)
    with pytest.raises(ValueError):
        field_cuda.field_cube(n, RADIUS, device="cpu")
    with pytest.raises(ValueError):
        thf.frame_cube(n, RADIUS, device="cpu")


@pytest.mark.parametrize("row0,rows", [(-1, 8), (120, 16), (0, 0)])
def test_bad_strip_rejected(row0, rows):
    with pytest.raises(ValueError):
        field_cuda.field_cube_strip(N, RADIUS, row0, rows, device="cpu")


def test_unknown_keyword_rejected():
    with pytest.raises(TypeError):
        field_cuda.field_cube(N, RADIUS, octave=6, device="cpu")


def test_kernel_needs_a_cuda_device():
    with pytest.raises(ValueError):
        field_cuda.field_kernel(N, RADIUS, device="cpu")


def test_config1_flat_patch_matches_host_fbm():
    """BASELINE config 1 (benchmarks/bench_configs.py:72-93) at n=32: the
    flat patch through field_from_padded_points (K4's plain version)."""
    n = 32
    px, py, pz, xyscale = thf.flat_patch_points(n, extent=64.0, device="cpu")
    out = thf.field_from_padded_points(px, py, pz, xyscale, kind="fbm",
                                       octaves=4, gain=0.5, coord_scale=1.0,
                                       amplitude=1.0)
    assert out.heights.shape == (n, n)
    assert out.normal.shape == (n, n, 3)
    assert out.shade.shape == (n, n)
    pts = [(p[0].double() + p[1].double()).numpy() for p in (px, py, pz)]
    want = jperlin_np.fbm(*pts, octaves=4, gain=np.float32(0.5))[1:-1, 1:-1]
    np.testing.assert_allclose(out.heights.numpy(), want, atol=2e-5)
    nrm = np.linalg.norm(out.normal.numpy(), axis=-1)
    np.testing.assert_allclose(nrm, 1.0, atol=1e-5)
