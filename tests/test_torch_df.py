"""The port's double-float helpers (planet_tpu_torch.nums.df) against
planet_tpu.nums.df: bitwise equal on 4096 seeded inputs (both run op by op,
unfused, so neither contracts to FMA)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from planet_tpu.nums import df as jdf
from planet_tpu_torch.nums import df as tdf

torch.set_num_threads(1)
N = 4096


def _coords(seed=0):
    """Planet-scale and small double-float coordinates of both signs,
    including exact negative integers (the FLOOR-macro edge case)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-100.0, 100.0, N) * 10.0 ** rng.integers(-3, 5, N)
    x[:64] = -np.arange(1, 65, dtype=np.float64)
    return x


def _eq(jax_out, torch_out):
    for a, b in zip(jax_out, torch_out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_two_sum_and_quick_two_sum_bitwise():
    rng = np.random.default_rng(1)
    a = (rng.normal(size=N) * 10.0 ** rng.integers(-8, 8, N)).astype(np.float32)
    b = (rng.normal(size=N) * 10.0 ** rng.integers(-8, 8, N)).astype(np.float32)
    big, small = np.where(np.abs(a) >= np.abs(b), a, b), \
        np.where(np.abs(a) >= np.abs(b), b, a)
    _eq(jdf.two_sum(jnp.asarray(a), jnp.asarray(b)),
        tdf.two_sum(torch.from_numpy(a), torch.from_numpy(b)))
    _eq(jdf.quick_two_sum(jnp.asarray(big), jnp.asarray(small)),
        tdf.quick_two_sum(torch.from_numpy(big), torch.from_numpy(small)))


def test_from_f64_np_bitwise():
    x = _coords()
    for a, b in zip(jdf.from_f64_np(x), tdf.from_f64_np(x)):
        np.testing.assert_array_equal(a, b)


def test_floor_split_and_int24_parts_bitwise():
    hi, lo = jdf.from_f64_np(_coords(2))
    d = jdf.DF(jnp.asarray(hi), jnp.asarray(lo))
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    _eq(jdf.floor_split_parts(d), tdf.floor_split_parts(th, tl))
    _eq(jdf.int24_parts(d), tdf.int24_parts(th, tl))


@pytest.mark.parametrize("o", [0, 1, 7, 17, 23])
def test_shift_split24_bitwise(o):
    hi, lo = jdf.from_f64_np(_coords(3))
    parts = jdf.int24_parts(jdf.DF(jnp.asarray(hi), jnp.asarray(lo)))
    tparts = tdf.int24_parts(torch.from_numpy(hi), torch.from_numpy(lo))
    _eq(jdf.shift_split24(*parts, o), tdf.shift_split24(*tparts, o))


@pytest.mark.parametrize("o", [0, 5, 17])
def test_shift_frac48_is_the_exact_fraction(o):
    """shift_frac48 carries the octave's full 48-bit fraction: the same
    cell as planet_tpu's split, and a float64 fraction within 2^-48 of
    2^o * (hi + lo) - cell (computed exactly in f64 for |x| < 2^4)."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-16.0, 16.0, N)
    hi, lo = jdf.from_f64_np(x)
    tparts = tdf.int24_parts(torch.from_numpy(hi), torch.from_numpy(lo))
    cell, frac = tdf.shift_frac48(*tparts, o)
    cell24, fh, _ = tdf.shift_split24(*tparts, o)
    np.testing.assert_array_equal(cell.numpy(), cell24.numpy())
    exact = (hi.astype(np.float64) + lo.astype(np.float64)) * 2.0**o \
        - cell.numpy().astype(np.float64)
    assert np.all(np.abs(frac.numpy() - exact) <= 2.0**-48)
    assert np.all((frac.numpy() >= 0.0) & (frac.numpy() < 1.0))
    # planet_tpu's f32 fraction is the 24-bit truncation of the same value
    assert np.all(np.abs(frac.numpy() - fh.numpy()) < 2.0**-24)
