"""The port's splat raster (planet_tpu_torch.raster.splat) against
planet_tpu's, on the CPU (the engines' splat mode:
tests/test_torch_splat_engine.py).

* the cases of tests/test_raster_io.py:13-60 and
  tests/test_models_camera.py:81-91 on the port;
* coverage.to_i32 against XLA's float -> int32 convert on +-1e12, +-inf,
  NaN and values at the int32 edges (NaN -> 0, saturation);
* upsample_cells (k = 1-4, wireframe on and off), splat_frame and its hole
  fill (fill_rounds 0-3) bitwise equal to planet_tpu's, called eagerly
  (XLA:CPU's fusion under jit contracts the weighted sums to FMA), on
  seeded inputs with off-screen, behind-camera, NaN, w <= 1e-9 and
  out-of-int32-range fragments and NaN shades that land on screen;
* splat_keys (the splat kernel's dispatcher) runs its plain version on
  CPU tensors, upsample_cells' weight table is the weights the kernel
  forms, and the kernel's fragment loop, walked in Python through the
  table as its blocks form it, gives `weights`' order for k = 2-32, with
  and without wireframe.

Marked `gpu` (skipped without a card): S1 bit for bit against the plain
version at k = 1, 2, 8, 32, with and without wireframe, on grids with
invalid padding rows, NaN shades and cells that straddle the screen's
edges; and its bench-only variants that store keys.
"""

import numpy as np
import pytest
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.raster import coverage as tcov
from planet_tpu_torch.raster import splat
from planet_tpu_torch.tools import r1_s1_parts

torch.set_num_threads(1)


def _jax():
    """jax.numpy and planet_tpu's splat, imported by the tests that compare
    with them (the GPU tests below run where jax is not installed)."""
    import jax.numpy as jnp
    from planet_tpu.raster import splat as jsplat
    return jnp, jsplat


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want):
    """Equal bit for bit, NaN for NaN (a NaN's sign and payload are the
    producing library's: x86 and XLA make NaNs of either sign for 0 * inf)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.float32:
        nan = np.isnan(got)
        np.testing.assert_array_equal(nan, np.isnan(want))
        got, want = np.where(nan, 0, _bits(got)), np.where(nan, 0, _bits(want))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------- tests/test_raster_io.py cases


def test_splat_depth_test():
    """Two fragments on the same pixel: the nearer one wins."""
    clip = _t(np.array([[0.0, 0.0, 0.5, 1.0], [0.0, 0.0, -0.5, 1.0]],
                       np.float32))
    img, depth = splat.splat_frame(clip, _t(np.array([0.25, 0.75], np.float32)),
                                   _t(np.array([True, True])), 8, 8,
                                   fill_rounds=0)
    img = img.numpy()
    assert abs(img[4, 4] - 0.75) < 2e-3
    assert abs(depth.numpy()[4, 4] + 0.5) < 1e-4
    mask = np.ones((8, 8), bool)
    mask[4, 4] = False
    assert (img[mask] == 0.0).all()


def test_splat_culls_invalid_and_behind():
    clip = _t(np.array([[0.0, 0.0, 0.0, -1.0],      # behind the camera
                        [0.0, 0.0, 0.0, 1.0],       # valid=False
                        [5.0, 0.0, 0.0, 1.0]],      # off-screen
                       np.float32))
    img, _ = splat.splat_frame(clip, _t(np.full(3, 0.5, np.float32)),
                               _t(np.array([True, False, True])), 8, 8,
                               fill_rounds=0)
    assert (img.numpy() == 0.0).all()


def test_hole_fill():
    img, _ = splat.splat_frame(_t(np.array([[0.0, 0.0, 0.0, 1.0]],
                                           np.float32)),
                               _t(np.array([1.0], np.float32)),
                               _t(np.array([True])), 8, 8, fill_rounds=1)
    img = img.numpy()
    assert (img[3:6, 3:6] > 0.9).all()      # 3x3 filled
    assert img[0, 0] == 0.0


def test_upsample_cells_counts():
    q, g = 2, 4
    c, s, v = splat.upsample_cells(torch.zeros((q, g, g, 4)),
                                   torch.zeros((q, g, g)),
                                   torch.ones((q, g, g), dtype=torch.bool), 3)
    assert c.shape == (q, g - 1, g - 1, 9, 4)
    assert s.shape == (q, g - 1, g - 1, 9)
    assert v.shape == s.shape


def test_wireframe_upsample_keeps_edges_only():
    clip, shade = torch.zeros((1, 4, 4, 4)), torch.zeros((1, 4, 4))
    valid = torch.ones((1, 4, 4), dtype=torch.bool)
    c_full, _, _ = splat.upsample_cells(clip, shade, valid, 4)
    c_wire, _, _ = splat.upsample_cells(clip, shade, valid, 4,
                                        wireframe=True)
    assert c_full.shape[-2] == 16
    assert c_wire.shape[-2] == 7       # i == 0 row + j == 0 col of 4x4


# ------------------------------------------------ float -> int32 as XLA


def test_to_i32_converts_as_xla():
    x = np.array([np.nan, -np.nan, np.inf, -np.inf, 1e12, -1e12, 2.0**31,
                  -(2.0**31), 2.0**31 - 128, -2.5, 2.5, -0.0, 0.99,
                  -0.99, 1023.7, 2097150.9], np.float32)
    jnp, _ = _jax()
    got = tcov.to_i32(_t(x)).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[1] == 0


# ------------------------------------------- bitwise against planet_tpu


def _fragments(seed, q=3, g=6):
    """(Q, G, G) patch grids with every kind of fragment the splat culls
    or keeps: behind the camera, w <= 1e-9, off screen, coordinates far
    outside int32, NaN coordinates, NaN depth, NaN and out-of-range shades
    on screen, invalid vertices."""
    rng = np.random.default_rng(seed)
    clip = rng.normal(0.0, 0.7, (q, g, g, 4)).astype(np.float32)
    clip[..., 3] = rng.uniform(-0.2, 2.0, (q, g, g))
    clip[0, 0, 0] = [np.nan, 0.1, 0.2, 1.0]
    clip[0, 0, 1] = [1e12, -1e12, 0.0, 1.0]
    clip[0, 0, 2] = [-1e12, 1e12, 0.0, 1.0]
    clip[0, 0, 3, 3] = 1e-10
    clip[0, 0, 4, 3] = 1e-9
    clip[0, 1, 0, 2] = np.nan
    clip[0, 1, 1, 3] = -1.0
    clip[1, 2, 2] = [0.05, 0.05, 0.1, 1.0]
    clip[1, 2, 3] = [0.3, -0.2, 0.5, 1.0]
    shade = rng.uniform(-0.1, 1.1, (q, g, g)).astype(np.float32)
    shade[1, 2, 2] = np.nan
    shade[1, 2, 3] = np.inf
    shade[2, 0, 0] = -np.inf
    valid = rng.uniform(size=(q, g, g)) < 0.9
    valid[1, 1:4, 1:4] = True
    return clip, shade, valid


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("wireframe", [False, True])
def test_upsample_and_splat_bitwise_equal_planet_tpu(k, wireframe):
    jnp, jsplat = _jax()
    clip, shade, valid = _fragments(k + 10 * wireframe)
    got = splat.upsample_cells(_t(clip), _t(shade), _t(valid), k,
                               wireframe=wireframe)
    want = jsplat.upsample_cells(jnp.asarray(clip), jnp.asarray(shade),
                                 jnp.asarray(valid), k, wireframe=wireframe)
    for a, b in zip(got, want):
        _assert_same(a.numpy(), b)
    image, depth = splat.splat_frame(*got, 17, 13)
    jimage, jdepth = jsplat.splat_frame(*want, 17, 13)
    np.testing.assert_array_equal(_bits(image.numpy()), _bits(jimage))
    np.testing.assert_array_equal(_bits(depth.numpy()), _bits(jdepth))
    assert np.isfinite(depth.numpy()).any()


@pytest.mark.parametrize("fill_rounds", [0, 1, 2, 3])
def test_hole_fill_rounds_bitwise_equal_planet_tpu(fill_rounds):
    jnp, jsplat = _jax()
    clip, shade, valid = _fragments(20 + fill_rounds, q=4, g=8)
    # sparse fragments: most pixels start empty, the fills close them
    args = splat.upsample_cells(_t(clip), _t(shade), _t(valid), 2)
    jargs = jsplat.upsample_cells(jnp.asarray(clip), jnp.asarray(shade),
                                  jnp.asarray(valid), 2)
    image, depth = splat.splat_frame(*args, 40, 30, background=0.25,
                                     fill_rounds=fill_rounds)
    jimage, jdepth = jsplat.splat_frame(*jargs, 40, 30, background=0.25,
                                        fill_rounds=fill_rounds)
    np.testing.assert_array_equal(_bits(image.numpy()), _bits(jimage))
    np.testing.assert_array_equal(_bits(depth.numpy()), _bits(jdepth))
    packed = torch.full((30, 40), tcov._EMPTY, dtype=torch.int32)
    packed[::4, ::3] = torch.arange(100, 100 + 8 * 14,
                                    dtype=torch.int32).reshape(8, 14)
    for _ in range(fill_rounds):
        packed = splat._fill_holes(packed)
    jp = np.full((30, 40), tcov._EMPTY, np.int32)
    jp[::4, ::3] = np.arange(100, 100 + 8 * 14, dtype=np.int32).reshape(8, 14)
    jp = jnp.asarray(jp)
    for _ in range(fill_rounds):
        jp = jsplat._fill_holes(jp)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))


# ------------------------------------------ the splat kernel's wrapper


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("wireframe", [False, True])
def test_splat_keys_dispatch_plain_on_cpu(k, wireframe):
    """splat_keys (the splat kernel's dispatcher) runs its plain version on
    CPU tensors: upsample_cells, then pack_keys, whose splat_frame the
    tests above hold to planet_tpu's; the kernel's wrapper refuses CPU
    tensors and the dispatcher malformed grids."""
    clip, shade, valid = (_t(a) for a in _fragments(40 + k, q=3, g=7))
    keys = splat.splat_keys(clip, shade, valid, 23, 19, k, wireframe)
    assert torch.equal(keys, splat.splat_keys_plain(
        clip, shade, valid, 23, 19, k, wireframe))
    up = splat.upsample_cells(clip, shade, valid, k, wireframe)
    assert torch.equal(keys, splat.pack_keys(*up, 23, 19))
    image, depth = splat.splat_frame(*up, 23, 19, fill_rounds=0)
    dimage, ddepth = tcov.decode_packed(keys)
    assert torch.equal(image, dimage) and torch.equal(depth, ddepth)
    assert int((keys != tcov._EMPTY).sum()) > 0
    with pytest.raises(ValueError):
        splat.splat_keys_cuda(clip, shade, valid, 23, 19, k)
    with pytest.raises(ValueError):
        splat.splat_keys(clip[..., :3], shade, valid, 23, 19, k)


def test_weight_table_is_upsample_cells_weights():
    """splat.weights, the plain version's table, equals the weights of
    fragment f's point (i, j) (rows i and columns j, with wireframe row 0
    then column 0; fu the double j / (k - 1) rounded to f32; f32
    products), the formula of the splat kernel's table
    (csrc/splat.cu:form_table)."""
    one = np.float32(1.0)
    for k in (2, 3, 6, 8, 32):
        for wf in (False, True):
            w = splat.weights(k, wf)
            assert len(w) == (2 * k - 1 if wf else k * k)
            for f, row in enumerate(w):
                if wf:
                    i, j = (0, f) if f < k else (f - k + 1, 0)
                else:
                    i, j = divmod(f, k)
                fu = np.float32(np.float64(j) / np.float64(k - 1))
                fv = np.float32(np.float64(i) / np.float64(k - 1))
                want = ((one - fu) * (one - fv), fu * (one - fv),
                        (one - fu) * fv, fu * fv)
                assert all(isinstance(x, np.float32) for x in want)
                assert list(row) == [float(x) for x in want]
    # a one-hot grid recovers each weight through upsample_cells
    clip = torch.zeros((1, 2, 2, 4))
    clip[0, 1, 0, 0] = 1.0                       # corner c10
    c, _, _ = splat.upsample_cells(clip, torch.zeros((1, 2, 2)),
                                   torch.ones((1, 2, 2), dtype=torch.bool), 4)
    assert c[0, 0, 0, :, 0].tolist() == [w[2] for w in splat.weights(4)]


@pytest.mark.parametrize("k", range(2, 33))
@pytest.mark.parametrize("wireframe", [False, True])
def test_kernel_table_walk_is_weights_order(k, wireframe):
    """The splat kernel's fragment loop, walked in Python: each block forms
    its table as csrc/splat.cu:form_table does (lane j < k forms column j,
    warp w of 8 the rows w, w + 8, ..., each point (i, j) at
    splat.table_slot, the kernel's table_slot, with no division; each slot
    written once), then a cell's thread walks f = 0, 1, ... frags - 1
    through it. The walk yields splat.weights(k, wireframe) exactly, in
    order, wireframe's row-then-column order included."""
    one = np.float32(1.0)
    frags = 2 * k - 1 if wireframe else k * k
    table = [None] * frags
    for lane in range(32):
        if lane >= k:
            continue
        fu = np.float32(np.float64(lane) / np.float64(k - 1))
        for warp in range(8):
            for i in range(warp, k, 8):
                f = splat.table_slot(i, lane, k, wireframe)
                if f < 0:
                    assert wireframe and i and lane
                    continue
                assert table[f] is None
                fv = np.float32(np.float64(i) / np.float64(k - 1))
                table[f] = tuple(float(x) for x in (
                    (one - fu) * (one - fv), fu * (one - fv), (one - fu) * fv,
                    fu * fv))
    walk = tuple(table[f] for f in range(frags))
    assert walk == splat.weights(k, wireframe)


# ------------------------------------------------------------- the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _screen_grids(seed, q=6, g=12):
    """(Q, G, G) grids for a 61 x 47 screen: _fragments' culled and kept
    fragments in patches 0-2; patch 3 a regular grid from NDC -1.3 to 1.3
    whose cells straddle all four screen edges, with NaN shades on screen;
    patches 4-5 invalid, as DeviceRenderer's padding rows are."""
    clip, shade, valid = _fragments(seed, q=q, g=g)
    lin = np.linspace(-1.3, 1.3, g, dtype=np.float32)
    clip[3, ..., 0] = lin[None, :]
    clip[3, ..., 1] = lin[:, None]
    clip[3, ..., 2] = np.linspace(-0.5, 0.5, g, dtype=np.float32)[:, None]
    clip[3, ..., 3] = 1.0
    valid[3] = True
    shade[3, 2::3, 2::3] = np.nan
    valid[4:] = False
    return [_t(a) for a in (clip, shade, valid)]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 8, 32])
@pytest.mark.parametrize("wireframe", [False, True])
def test_s1_equals_plain(dev, k, wireframe):
    """S1 (csrc/splat.cu) against splat_keys_plain on the CPU, bit for
    bit, one launch: every kind of culled fragment, NaN shades, cells that
    straddle the screen's edges and invalid padding rows."""
    args = _screen_grids(k + 40 * wireframe)
    want = splat.splat_keys_plain(*args, 61, 47, k, wireframe)
    before = _cuda.launches["splat"]
    got = splat.splat_keys(*(a.to(dev) for a in args), 61, 47, k, wireframe)
    assert _cuda.launches["splat"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert int((want != tcov._EMPTY).sum()) > 40


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [v for v, (_, stores) in
                                     r1_s1_parts.SPLAT_VARIANTS.items()
                                     if stores])
@pytest.mark.parametrize("wireframe", [False, True])
def test_s1_bench_variants_equal_plain(dev, variant, wireframe):
    """S1's bench-only variants that store keys (the first design by
    division and by multiply-high, the cell kernel with its read skip and
    with 4 lanes a cell) equal the plain version bit for bit."""
    args = _screen_grids(7 + wireframe)
    want = splat.splat_keys_plain(*args, 61, 47, 8, wireframe)
    got = r1_s1_parts.t_splat(variant, *(a.to(dev) for a in args), 61, 47,
                              8, wireframe)
    assert torch.equal(got.cpu(), want)
