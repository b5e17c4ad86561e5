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


def _karp_sqrt_np(hi, lo):
    """nums.df.sqrt's formula in numpy float32, op by op (no FMA), with
    the correctly rounded seed 1 / np.sqrt(hi)."""
    f32 = np.float32

    def two_sum(a, b):
        s = a + b
        bb = s - a
        return s, (a - (s - bb)) + (b - bb)

    def two_prod(a, b):
        p = a * b
        ca, cb = f32(4097.0) * a, f32(4097.0) * b
        ahi, bhi = ca - (ca - a), cb - (cb - b)
        alo, blo = a - ahi, b - bhi
        return p, ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo

    x = f32(1.0) / np.sqrt(hi)
    ax = hi * x
    p, e = two_prod(ax, ax)
    d_hi, d_e = two_sum(hi, -p)
    corr = (d_hi + (d_e + lo - e)) * (x * f32(0.5))
    s = ax + corr
    return s, corr - (s - ax)


def _karp_bound(delta):
    """A bound on the relative error of one Karp step (nums.df.sqrt) from
    a seed x = (1 + d) / sqrt(hi), |d| <= delta, for a DF input with
    |lo| <= ulp(hi) / 2. With u = 2^-24, ax = a * x is sqrt(hi + lo)
    (1 + e) with |e| <= eps = delta + u + r + its products, where r =
    2^-25 bounds sqrt((hi + lo) / hi) - 1; the step leaves
    -e (d + r + d r) - (1 + d)(1 + r) e^2 / 2 relative, and its roundings
    add at most 2 u eps (the correction's: the residual's last sum and the
    product by x / 2) and 2^-47 (the residual's absolute terms over the
    root)."""
    u, r = 2.0**-24, 2.0**-25
    eps = (1 + delta) * (1 + u) * (1 + r) - 1
    return (eps * (delta + r + delta * r)
            + (1 + delta) * (1 + r) * eps * eps / 2 + 2 * u * eps
            + 2.0**-47)


def test_sqrt_matches_to_df_precision():
    """The port's DF root is nums.df.sqrt's Karp formula with the
    correctly rounded seed 1 / sqrt(hi) (nums.fp.sqrt_rn): bitwise equal
    to the same formula in numpy float32, where np.sqrt is correctly
    rounded and nothing contracts to FMA, and within 2^-45 relative of the
    exact root (0.69 x 2^-45 at worst here). planet_tpu seeds the step with
    lax.rsqrt, whose XLA:CPU lowering depends on the host (1.4 ulps off at
    worst on one host, where planet_tpu's result came to 1.26 x 2^-45
    of the exact root): its hi words equal the port's, and its error is
    held to the analytic bound of one Karp step from a seed within 2 ulps
    (2^-22 relative; XLA states no accuracy for rsqrt, 2 ulps is what CUDA
    states for rsqrtf), 6.6 x 2^-45."""
    ja, ta = _df_inputs(10, positive=True)
    want = jdf.sqrt(ja)
    got = tdf.sqrt(ta)
    hi, lo = (t.numpy() for t in ta)
    for a, b in zip(_karp_sqrt_np(hi, lo), got):
        np.testing.assert_array_equal(a.view(np.int32), b.numpy().view(
            np.int32))
    np.testing.assert_array_equal(np.asarray(want.hi), got[0].numpy())
    exact = np.sqrt(hi.astype(np.float64) + lo.astype(np.float64))
    g = got[0].numpy().astype(np.float64) + got[1].numpy().astype(np.float64)
    w = np.asarray(want.hi, np.float64) + np.asarray(want.lo, np.float64)
    assert np.max(np.abs(g - exact) / exact) <= 2.0**-45
    bound = _karp_bound(2.0**-22)
    assert 6 * 2.0**-45 < bound < 7 * 2.0**-45
    assert np.max(np.abs(w - exact) / exact) <= bound
