"""The port's double-float helpers (planet_tpu_torch.nums.df) against
planet_tpu.nums.df: bitwise equal on 4096 seeded inputs at planet and unit
scales (both run op by op, unfused, so neither contracts to FMA), except
sqrt, whose Newton seed differs (see its test)."""

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


def _df_inputs(seed, positive=False):
    """Seeded DF pairs at planet scale (|x| ~ 6.4e6, the quad corners) and
    unit scale, both signs unless `positive`, as (jax DF, torch pair)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.5, 1.0, N) * np.where(np.arange(N) % 2, 6.4e6, 1.0)
    if not positive:
        x = x * rng.choice([-1.0, 1.0], N)
    hi, lo = jdf.from_f64_np(x)
    return (jdf.DF(jnp.asarray(hi), jnp.asarray(lo)),
            (torch.from_numpy(hi), torch.from_numpy(lo)))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "dot3"])
def test_df_arithmetic_bitwise(op):
    """Against planet_tpu's functions called eagerly (op by op, so XLA
    cannot contract to FMA): bitwise."""
    (ja, ta), (jb, tb), (jc, tc) = (_df_inputs(s) for s in (5, 6, 7))
    if op == "dot3":
        want = jdf.dot3(ja, jb, jc, jc, ja, jb)
        got = tdf.dot3(ta, tb, tc, tc, ta, tb)
    else:
        want = getattr(jdf, op)(ja, jb)
        got = getattr(tdf, op)(ta, tb)
    _eq(want, got)


def test_two_prod_mul_pow2_from_f32_bitwise():
    (ja, ta), (jb, tb) = _df_inputs(8), _df_inputs(9)
    _eq(jdf.two_prod(ja.hi, jb.hi), tdf.two_prod(ta[0], tb[0]))
    for s in (2.0, 0.5, 1024.0):
        _eq(jdf.mul_pow2(ja, np.float32(s)),
            tdf.mul_pow2(ta, tdf.const(s, ta[0])))
    _eq(jdf.from_f32(ja.hi), tdf.from_f32(ta[0]))


def test_sqrt_matches_to_df_precision():
    """Not bitwise: planet_tpu seeds the Newton step with lax.rsqrt, the
    port with the correctly rounded 1/sqrt (identical on the CPU and the
    card); XLA:CPU's rsqrt differs from it in ~29 % of these inputs. One
    Newton step (Karp) is accurate to ~2e-14 relative from either seed —
    planet_tpu's own result is 1.6e-14 from the f64 root here — so the
    seeds move only the lo word: hi words are equal, lo words within 8 DF
    ulps (ulp(hi) * 2^-24; measured 5), and the port is within 2^-45
    relative of the exact root, as planet_tpu is."""
    ja, ta = _df_inputs(10, positive=True)
    want = jdf.sqrt(ja)
    got = tdf.sqrt(ta)
    np.testing.assert_array_equal(np.asarray(want.hi), got[0].numpy())
    w = np.asarray(want.hi, np.float64) + np.asarray(want.lo, np.float64)
    g = got[0].numpy().astype(np.float64) + got[1].numpy().astype(np.float64)
    df_ulp = np.spacing(np.asarray(want.hi)).astype(np.float64) * 2.0**-24
    assert np.max(np.abs(g - w) / df_ulp) <= 8
    exact = np.sqrt(np.asarray(ja.hi, np.float64)
                    + np.asarray(ja.lo, np.float64))
    for v in (g, w):
        assert np.max(np.abs(v - exact) / exact) <= 2.0**-45
