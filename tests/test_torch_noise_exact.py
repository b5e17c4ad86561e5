"""The exact identities under the H100 noise core (csrc/noise.cuh),
checked on the CPU with numpy and torch. The kernels equal their plain
versions bit for bit only because each of these holds:

* the octave fraction t = hi_o 2^-24 + lo_o 2^-48 (two 24-bit words) is
  the point's 48-bit fraction word shifted by the octave and scaled by
  2^-48 (the kernels' form), and its cell the shifted cell; (float)t and
  (float)(t - 1) are also f32 sums of two exact terms, and the exact
  double t comes from its bits, 1.0 | hi_o lo_o in the mantissa, minus 1
  (a form measured on the card and not kept, PERF.md);
* an f32 product's rounding error, fmaf(a, b, -p) in the kernels, is what
  the plain versions' Dekker split computes (nums/df.two_prod);
* the pair tables of perlin_cuda.kernel_tables hold each entry with its
  neighbour, and their sign codes expanded to f32 halves (the kernels'
  shared table) decode to (float)(s & 3) - 1 of both codes;
* the gradient-sign decode by bits (the single_lookups form) equals
  (float)(s & 3) - 1 with its signed zero, through the products it feeds;
* octave values computed apart and folded in the sequential order equal
  ops/perlin.accumulate_octaves: the identity an octave-parallel layout
  of the flat noise kernel rests on (measured and dropped, PERF.md).

Inputs come from numpy's default_rng with fixed seeds.
"""

import numpy as np
import pytest
import torch

from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.ops import perlin
from planet_tpu_torch.ops.kernels import perlin_cuda
from planet_tpu_torch.ops.tables import PERLIN_TABLE

torch.set_num_threads(1)
EDGES = np.array([0, 1, 1 << 23, (1 << 24) - 1], np.int64)


def _words(case):
    """(hi_o, lo_o) int64 pairs: the 24-bit edge values crossed, or 10^5
    random pairs."""
    if case == "edges":
        hi, lo = np.meshgrid(EDGES, EDGES, indexing="ij")
        return hi.ravel(), lo.ravel()
    rng = np.random.default_rng(5)
    return (rng.integers(0, 1 << 24, 100_000),
            rng.integers(0, 1 << 24, 100_000))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x.view(np.int64)


@pytest.mark.parametrize("octave", [0, 1, 12, 23])
def test_fraction_word_shift_equals_shift_parts(octave):
    """noise.cuh octave_split: with v48 = hi24 << 24 | lo24, the octave's
    ((v48 << o) mod 2^48) * 2^-48 as a double is nums/df.shift_frac48's
    fraction and (cell << o) + (hi24 >> (24 - o)) its cell, for random
    int24 splits and the edge words."""
    rng = np.random.default_rng(octave)
    hi = np.concatenate([EDGES, rng.integers(0, 1 << 24, 50_000)])
    lo = np.concatenate([EDGES[::-1], rng.integers(0, 1 << 24, 50_000)])
    cell = rng.integers(-(1 << 20), 1 << 20, hi.size)
    want_cell, want = dfm.shift_frac48(
        *(torch.as_tensor(a.astype(np.int32)) for a in (cell, hi, lo)), octave)
    v = ((hi.astype(np.uint64) << 24 | lo.astype(np.uint64)) << octave
         & np.uint64((1 << 48) - 1))
    got = v.astype(np.float64) * 2.0**-48
    np.testing.assert_array_equal(_bits(got), _bits(want.numpy()))
    got_cell = ((cell.astype(np.int64) << octave) + (hi >> (24 - octave)))
    got_cell = ((got_cell + 2**31) % 2**32 - 2**31).astype(np.int32)
    np.testing.assert_array_equal(got_cell, want_cell.numpy())


@pytest.mark.parametrize("case", ["edges", "random"])
def test_fraction_two_term_sums_round_once(case):
    """The f32 two-term form: h = hi_o 2^-24 and l = lo_o 2^-48 are exact
    in f32, h - 1 is exact, and h + l, (h - 1) + l are (float)t and
    (float)(t - 1) of the exact t."""
    hi, lo = _words(case)
    h = hi.astype(np.float32) * np.float32(2.0**-24)
    l = lo.astype(np.float32) * np.float32(2.0**-48)
    np.testing.assert_array_equal(h.astype(np.float64), hi * 2.0**-24)
    np.testing.assert_array_equal(l.astype(np.float64), lo * 2.0**-48)
    hm1 = h - np.float32(1.0)
    np.testing.assert_array_equal(hm1.astype(np.float64), hi * 2.0**-24 - 1)
    t = hi * 2.0**-24 + lo * 2.0**-48                  # exact in f64
    np.testing.assert_array_equal(_bits(h + l), _bits(t.astype(np.float32)))
    np.testing.assert_array_equal(_bits(hm1 + l),
                                  _bits((t - 1.0).astype(np.float32)))


@pytest.mark.parametrize("case", ["edges", "random"])
def test_fraction_double_built_from_its_bits(case):
    """The exact double t = (1.0 with hi_o lo_o as the top 48 mantissa
    bits) - 1.0 equals hi_o 2^-24 + lo_o 2^-48 (ops/perlin's f64 sum), so
    the fade sees the same t."""
    hi, lo = _words(case)
    bits = (np.uint64(0x3FF0000000000000) | (hi.astype(np.uint64) << 28)
            | (lo.astype(np.uint64) << 4))
    t = bits.view(np.float64) - 1.0
    want = (torch.as_tensor(hi).to(torch.float64) * 2.0**-24
            + torch.as_tensor(lo).to(torch.float64) * 2.0**-48).numpy()
    np.testing.assert_array_equal(_bits(t), _bits(want))
    np.testing.assert_array_equal(
        _bits(perlin.fade64(torch.as_tensor(t)).to(torch.float32).numpy()),
        _bits(perlin.fade64(torch.as_tensor(want)).to(torch.float32)
              .numpy()))


def _magnitudes(name, rng, n=200_000):
    """f32 (a, b) over what K5's products see (field.cu): the coordinate
    products ih * q (ih = K / sqrt(1 + a^2 + b^2) for K = 63.71, q = +-1
    or an odd multiple of 1/n), df_sqrt's ax * ax and df_div's q1 * bh;
    zeros of both signs included."""
    sign = rng.choice([-1.0, 1.0], (2, n))
    if name == "coordinates":
        a = rng.uniform(36.7, 63.72, n)
        b = (2 * rng.integers(0, 4096, n) + 1) / 8192.0
    elif name == "sqrt":
        a = b = rng.uniform(1.0, 1.7321, n)
    else:
        a, b = rng.uniform(36.7, 63.72, n), rng.uniform(1.0, 1.7321, n)
    a, b = (sign * np.stack([a, b])).astype(np.float32)
    a[:4], b[:4] = [0.0, -0.0, 1.5, -2.5], [3.0, 0.0, -0.0, -0.0]
    return a, b


@pytest.mark.parametrize("name", ["coordinates", "sqrt", "div"])
def test_dekker_error_is_the_exact_product_error(name):
    """nums/df.two_prod's err (field_plain's products) equals the exact
    a*b - p rounded to f32, which is what fmaf(a, b, -p) returns; a zero
    error is +0.0 either way."""
    a, b = _magnitudes(name, np.random.default_rng(9))
    p, err = dfm.two_prod(torch.as_tensor(a), torch.as_tensor(b))
    p, err = p.numpy(), err.numpy()
    np.testing.assert_array_equal(_bits(p), _bits(a * b))
    exact = (a.astype(np.float64) * b.astype(np.float64)
             - p.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(_bits(err), _bits(exact))
    assert (_bits(err[:4]) == 0).all()


@pytest.mark.parametrize("which", ["perm", "sign"])
def test_pair_tables_decode_to_the_tables(which):
    perm2, sign2, _ = perlin_cuda.kernel_tables(2.0, "cpu")
    pairs, table = ((perm2, PERLIN_TABLE) if which == "perm"
                    else (sign2, perlin.packed_sign_table()))
    pairs = pairs.numpy()
    assert pairs.dtype == np.int32 and pairs.shape == (256,)
    assert (pairs >= 0).all()
    i = np.arange(256)
    np.testing.assert_array_equal(pairs & 0xFFFF, table[i])
    np.testing.assert_array_equal(pairs >> 16, table[(i + 1) & 255])


@pytest.mark.parametrize("code", ["low", "high"])
def test_sign_halves_decode_to_the_codes(code):
    """noise.cuh load_tables / halves_dots: each sign pair's six signs
    stored as the top 16 bits of their f32 values, three words, and read
    back by masking or shifting each word, equal (float)field - 1 of the
    pair's low (entry i) and high (entry i + 1) code bit for bit."""
    _, sign2, _ = perlin_cuda.kernel_tables(2.0, "cpu")
    pairs = sign2.numpy().astype(np.int64)

    def top(c, field):
        x = ((c >> (2 * field)) & 3).astype(np.float32) - np.float32(1.0)
        return x.view(np.int32).astype(np.int64) >> 16 & 0xFFFF

    a, b = pairs & 0xFFFF, pairs >> 16
    w = [top(a, 0) << 16 | top(a, 1), top(a, 2) << 16 | top(b, 0),
         top(b, 1) << 16 | top(b, 2)]

    def f32(x):
        return (x & 0xFFFFFFFF).astype(np.uint32).view(np.float32)

    hi = [f32(x & 0xFFFF0000) for x in w]
    lo = [f32(x << 16) for x in w]
    got = [hi[0], lo[0], hi[1]] if code == "low" else [lo[1], hi[2], lo[2]]
    codes = torch.as_tensor(a if code == "low" else b)
    for field in range(3):
        want = (((codes >> (2 * field)) & 3).to(torch.float32) - 1.0).numpy()
        np.testing.assert_array_equal(_bits(got[field]), _bits(want))


@pytest.mark.parametrize("shift", [0, 2, 4])
def test_sign_decode_by_bits(shift):
    """unit_sign: the f32 with bits 0x4B000000 | x, minus 2^23 + 1, equals
    ops/perlin's (s >> shift & 3).float() - 1.0 bit for bit for all 64
    codes, and so does each product with a gradient component (signed
    zeros included)."""
    s = torch.arange(64, dtype=torch.int64)
    x = ((s >> shift) & 3).numpy().astype(np.int32)
    got = (np.int32(0x4B000000) | x).view(np.float32) - np.float32(8388609.0)
    want = (((s >> shift) & 3).to(torch.float32) - 1.0).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    g = np.array([0.0, -0.0, 1e-30, -1e-30, 0.3, -0.7, 1.0, -1.0],
                 np.float32)
    np.testing.assert_array_equal(_bits(g[:, None] * got[None]),
                                  _bits(g[:, None] * want[None]))


def _points(n=256, seed=3):
    """Six (n,) f32 tensors, the double-float split of points on the
    terrain-scale sphere (radius 63.71, as the refine probes see)."""
    p = np.random.default_rng(seed).normal(size=(n, 3))
    p = p / np.linalg.norm(p, axis=1, keepdims=True) * 63.71
    out = []
    for k in range(3):
        out += [torch.as_tensor(a) for a in dfm.from_f64_np(p[:, k])]
    return out


def _octave_noise(coords, o, lacunarity, parts):
    """noise3 of octave o alone (noise.cuh octave_noise, plain version)."""
    perm, signs = perlin._tables("cpu")
    if lacunarity == 2.0:
        splits = [dfm.shift_frac48(*p, o) for p in parts]
    else:
        chi, clo = perlin.freq_consts(lacunarity, o + 1)[o]
        splits = [perlin._floor_frac64(*perlin._df_scale(h, l, chi, clo))
                  for h, l in zip(coords[::2], coords[1::2])]
    args = []
    for cell, frac64 in splits:
        args += [cell.long(), *perlin.frac_parts(frac64)]
    return perlin.noise3_core(perm, signs, *args)


def _folded(kind, octaves, lacunarity, gain, coords):
    """Each octave's noise computed apart from the others (each from its
    own int24 split, as a lane of an octave group would), then folded in
    octave order (noise.cuh add_octave)."""
    vals = [_octave_noise(coords, o, lacunarity,
                          [dfm.int24_parts(h, l)
                           for h, l in zip(coords[::2], coords[1::2])])
            for o in range(octaves)]
    value = torch.zeros_like(coords[0])
    weight = torch.ones_like(coords[0])
    amp = np.float32(1.0)
    for v in vals:
        if kind == "ridged":
            v = 1.0 - torch.abs(v)
            v = v * v
            value = value + (v * float(amp)) * weight
            weight = v
        else:
            value = value + v * float(amp)
        amp = np.float32(amp * np.float32(gain))
    return value


@pytest.mark.parametrize("lacunarity", [2.0, 1.7])
@pytest.mark.parametrize("octaves", [0, 1, 6, 7, 8, 18, 24])
@pytest.mark.parametrize("kind", ["ridged", "fbm"])
def test_octave_parallel_fold_equals_accumulate_octaves(kind, octaves,
                                                        lacunarity):
    coords = _points()
    want = perlin.accumulate_octaves(kind, octaves, lacunarity,
                                     np.float32(0.55), *coords)
    got = _folded(kind, octaves, lacunarity, 0.55, coords)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
