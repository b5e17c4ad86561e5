"""The port's kernel-attribution tools (planet_tpu_torch/tools: noise_stages,
lut, span_parts), plain PyTorch versions on the CPU, against planet_tpu on
the same numpy-made inputs.

planet_tpu's own tools cannot run here (they pass no `interpret`, and some
run at import), so each test calls the planet_tpu functions that the tool's
kernel bodies call, eagerly:

* noise full against perlin_pallas.accumulate_octaves with the packed pair
  tables, within 2e-6 (the P2 bar; not bitwise, because the port takes the
  fraction and fade in f64, ROADMAP section 3); splits against
  _int24_parts / _shift_split24 (cells bitwise, fractions within 2^-24);
  splits + gathers against the pair-table hash (sign codes bitwise);
  hoisted against microbench_stages.nosplit_full's sequence (2e-6);
* tile full against tile_pallas in interpret mode (1e-5 relative), tile
  bilinear against tile_pallas._df_* in the kernel's order (bitwise), tile
  noise against accumulate_octaves on the uv (2e-6);
* every lookup variant against numpy chains and, where the tool has one,
  jnp.take / jnp.take_along_axis / jnp.repeat (bitwise);
* span full against coverage_pallas._run_class in interpret mode on the
  same triangles in planet_tpu's record layout (_class_fixup), at K2's bar
  (coverage identical, packed depth and shade within 1 quantum); every
  other span variant against its definition, transcribed in numpy
  (bitwise).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from planet_tpu.ops.kernels import perlin_pallas as pk
from planet_tpu.ops.kernels import tile_pallas as tp
from planet_tpu.raster import coverage_pallas as cp
from planet_tpu_torch.raster import coverage_cuda
from planet_tpu_torch.tools import lut, noise_stages as ns, span_parts as sp

torch.set_num_threads(1)
EMPTY = 2**31 - 1
N_POINTS = 1 << 12


def _coords():
    return ns.noise_inputs(N_POINTS, "cpu")


def _jnp_rows(coords):
    """The six coordinate tensors as (rows, 128) jnp arrays (the Pallas
    helpers' lane layout)."""
    return [jnp.asarray(c.numpy().reshape(-1, 128)) for c in coords]


# ------------------------------------------------------------------ T1, T2

def test_noise_full_matches_accumulate_octaves():
    coords = _coords()
    ct, pt = pk._tables_for_kernel()
    want = pk.accumulate_octaves("ridged", ns.OCTAVES, 2.0,
                                 np.float32(ns.GAIN), ct, pt,
                                 *_jnp_rows(coords))
    got = ns.noise_stage("full", coords).numpy().reshape(-1, 128)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-6, atol=2e-6)


def test_noise_splits_match_int24_shift_split():
    coords = _coords()
    rows = _jnp_rows(coords)
    parts = [pk._int24_parts(rows[2 * k], rows[2 * k + 1]) for k in range(3)]
    for o, axes in enumerate(ns.octave_splits(coords)):
        for p, (cell, f, fm1, _) in zip(parts, axes):
            c_tpu, f_tpu, fm1_tpu = (np.asarray(a).reshape(-1)
                                     for a in pk._shift_split24(*p, o))
            np.testing.assert_array_equal(cell.numpy(), c_tpu)
            assert np.abs(f.numpy() - f_tpu).max() <= 2.0**-24
            assert np.abs(fm1.numpy() - fm1_tpu).max() <= 2.0**-24
    # the variant is the sum of exactly these pieces, in the kernel's order
    acc = np.zeros(N_POINTS, np.float32)
    for axes in ns.octave_splits(coords):
        s = axes[0][1].numpy() + axes[0][2].numpy()
        s = s + axes[0][3].numpy()
        for _, f, fm1, fade in axes[1:]:
            s = (s + f.numpy()) + fm1.numpy()
            s = s + fade.numpy()
        cells = sum(a[0].numpy() for a in axes)
        acc = acc + (s + cells.astype(np.float32))
    np.testing.assert_array_equal(ns.noise_stage("splits", coords).numpy(),
                                  acc)


def test_noise_gathers_match_pair_table_hash():
    """noise3's 8 gradient-sign codes from planet_tpu's packed pair tables
    (microbench_stages.gathers_only's chain, fields re-masked) equal the
    port's hash, octave by octave."""
    coords = _coords()
    rows = _jnp_rows(coords)
    ct, pt = pk._tables_for_kernel()
    parts = [pk._int24_parts(rows[2 * k], rows[2 * k + 1]) for k in range(3)]
    perm, signs = (torch.as_tensor(t, dtype=torch.int64)
                   for t in (ns.perlin._tables("cpu")))
    want_total = np.zeros(N_POINTS, np.float32)
    for o, axes in enumerate(ns.octave_splits(coords)):
        cx, cy, cz = (pk._shift_split24(*p, o)[0] for p in parts)
        pa = pk._lookup_pair(ct, cx)
        a0, a1 = pa & 255, (pa >> 8) & 255
        codes = 0
        for a in (a0, a1):
            pb = pk._lookup_pair(ct, a + cy)
            for b in (pb & 255, (pb >> 8) & 255):
                s = pk._lookup_pair(pt, b + cz)
                codes = codes + (s & 63) + ((s >> 6) & 63)
        codes = np.asarray(codes).reshape(-1)
        got = ns.sign_sum(perm, signs, *(a[0].long() for a in axes))
        np.testing.assert_array_equal(got.numpy(), codes)
        want_total = want_total + ns.split_sum(axes).numpy()
        want_total = want_total + codes.astype(np.float32)
    np.testing.assert_array_equal(
        ns.noise_stage("splits_gathers", coords).numpy(), want_total)


def test_noise_hoisted_matches_nosplit_full():
    """microbench_stages.nosplit_full: octave 0's split reused every octave
    with the x cell moved by i (planet_tpu fades in f32, the port in f64:
    the P2 bar)."""
    coords = _coords()
    ct, pt = pk._tables_for_kernel()
    rows = _jnp_rows(coords)
    splits = [pk._floor_split_df(rows[2 * k], rows[2 * k + 1])
              for k in range(3)]
    (cx, fx, flx), (cy, fy, fly), (cz, fz, flz) = splits
    fm1 = [pk._fm1(f, fl) for _, f, fl in splits]
    acc = jnp.zeros_like(rows[0])
    w = jnp.ones_like(rows[0])
    amp = np.float32(1.0)
    for i in range(ns.OCTAVES):
        n = pk._noise3_core(ct, pt, cx + i, fx, fm1[0], cy, fy, fm1[1],
                            cz, fz, fm1[2])
        v = np.float32(1.0) - jnp.abs(n)
        v = v * v
        acc = acc + v * amp * w
        w = v
        amp = amp * np.float32(ns.GAIN)
    got = ns.noise_stage("hoisted", coords).numpy().reshape(-1, 128)
    np.testing.assert_allclose(got, np.asarray(acc), rtol=2e-6, atol=2e-6)


def _tiles():
    return ns.tile_inputs(16, "cpu")


def test_tile_full_matches_tile_pallas_interpret():
    ch, cl = _tiles()
    want = np.asarray(tp.generate_tiles(
        ch.numpy(), cl.numpy(), kind="ridged", octaves=ns.OCTAVES,
        lacunarity=2.0, gain=np.float32(ns.GAIN), amplitude=ns.AMPLITUDE,
        tiles_per_block=8, interpret=True))
    got = ns.tile_stage("full", ch, cl).numpy()
    amp = np.float32(ns.AMPLITUDE)
    np.testing.assert_allclose(got / amp, want / amp, rtol=1e-5, atol=1e-5)


def _tpu_uv():
    div = np.float64(1.0) / np.float64(ns.DIM - 3)
    dh = np.float32(div)
    dl = np.float32(div - np.float64(dh))
    xm1 = jnp.asarray(np.arange(ns.DIM, dtype=np.float32) - 1.0)
    return pk._df_scale(xm1, jnp.zeros_like(xm1), dh, dl)


def test_tile_bilinear_matches_tile_pallas_df_sequence():
    """bench_tiles2's bilinear_only: tile_pallas's _df_sub/_df_mul/_df_add
    blend of the four corners at the overscan uv, six words summed."""
    ch, cl = _tiles()
    uh, ul = _tpu_uv()
    u = (uh[None, None, :], ul[None, None, :])
    v = (uh[None, :, None], ul[None, :, None])
    words = []
    for k in range(3):
        def c(j):
            return (jnp.asarray(ch.numpy()[:, j, k])[:, None, None],
                    jnp.asarray(cl.numpy()[:, j, k])[:, None, None])
        p0, p1, p2, p3 = c(0), c(1), c(2), c(3)
        a = tp._df_add(*p0, *tp._df_mul(*tp._df_sub(*p1, *p0), *u))
        b = tp._df_add(*p2, *tp._df_mul(*tp._df_sub(*p3, *p2), *u))
        words += tp._df_add(*a, *tp._df_mul(*tp._df_sub(*b, *a), *v))
    want = words[0] + words[2] + words[4] + words[1] + words[3] + words[5]
    got = ns.tile_stage("bilinear", ch, cl).numpy()
    np.testing.assert_array_equal(got, np.broadcast_to(np.asarray(want),
                                                       got.shape))


def test_tile_noise_matches_accumulate_octaves_on_uv():
    ch, cl = _tiles()
    uh, ul = _tpu_uv()
    shape = (ns.DIM, ns.DIM)
    coords = [jnp.broadcast_to(t, shape) for t in (
        uh[None, :], ul[None, :], uh[:, None], ul[:, None],
        uh[None, :] * np.float32(0.5), ul[None, :] * np.float32(0.5))]
    ct, pt = pk._tables_for_kernel()
    want = pk.accumulate_octaves("ridged", ns.OCTAVES, 2.0,
                                 np.float32(ns.GAIN), ct, pt,
                                 *(c.reshape(-1, 128) for c in coords))
    got = ns.tile_stage("noise", ch, cl).numpy()
    amp = np.float32(ns.AMPLITUDE)
    for tile in got:
        np.testing.assert_allclose(tile.reshape(-1, 128) / amp,
                                   np.asarray(want), rtol=2e-6, atol=2e-6)


def test_stage_wrappers_refuse_bad_arguments():
    coords = _coords()
    with pytest.raises(ValueError):
        ns.noise_stage("fade_only", coords)
    with pytest.raises(ValueError):
        ns.tile_stage("blend", *_tiles())
    with pytest.raises(ValueError):
        ns.noise_kernel("full", coords)          # CPU tensors: no kernel


# --------------------------------------------------------------- T3 - T7

def _np_lookup(name, idx, table):
    """The tool's definition of variant `name`, in numpy."""
    v = lut.VARIANTS[name]
    if v.code == 8:
        return np.repeat(idx, 16, axis=1)
    if v.code == 11:
        out = idx.copy()
        for _ in range(64):
            out = (out * 3 + 1) & 127
        return out
    if v.code == 12:
        return idx.copy()
    if v.code in (9, 10):
        out = idx
        for _ in range(v.depth):
            out = table[out]
        return out
    if v.code in (13, 14, 15):
        off = 0
        if v.code == 15:
            off = np.arange(idx.size).reshape(idx.shape) % lut.WIDE & ~127
        acc, val = np.zeros_like(idx), idx.copy()
        for _ in range(20):
            g = table[(val & 127) + off]
            acc, val = acc + g, val + g
        return acc
    if v.code in (16, 17):
        return sum(table[(idx ^ k) & 127] for k in range(24))
    return table[idx]


def _jax_lookup(name, idx, table):
    """The tool's own check, where it has one: jnp.take, take_along_axis
    over (rows, 128) lanes, or jnp.repeat."""
    v = lut.VARIANTS[name]
    if v.code == 8:
        return jnp.repeat(jnp.asarray(idx), 16, axis=1)
    if v.code in (0, 1, 2, 3, 4, 5, 6, 7):
        return jnp.take(jnp.asarray(table), jnp.asarray(idx))
    if v.code in (9, 10):
        tab = jnp.broadcast_to(jnp.asarray(table)[None, :],
                               (idx.size // 128, 128))
        out = jnp.asarray(idx.reshape(-1, 128))
        for _ in range(v.depth):
            out = jnp.take_along_axis(tab, out, axis=1)
        return out.reshape(idx.shape)
    return None


@pytest.mark.parametrize("name", list(lut.VARIANTS))
def test_lookup_variant_matches_numpy_and_jax(name):
    v = lut.VARIANTS[name]
    idx, table = lut.operands(name, lut.make_inputs(
        v.inputs, lut.SMALL[v.inputs], "cpu"))
    got = lut.lookup(name, idx, table).numpy()
    want = _np_lookup(name, idx.numpy(), table.numpy())
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    tool = _jax_lookup(name, idx.numpy(), table.numpy())
    if tool is not None:
        np.testing.assert_array_equal(got, np.asarray(tool))


def test_lookup_inputs_follow_the_tools_seeds():
    wide = lut.make_inputs("wide", 256, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(wide["idx"].numpy(),
                                  rng.integers(0, 1 << 20, 256,
                                               dtype=np.int32))
    np.testing.assert_array_equal(wide["t2048"].numpy()[1920:],
                                  wide["t128"].numpy())
    with pytest.raises(ValueError):
        lut.lookup("nope", wide["idx"], wide["t128"])


# -------------------------------------------------------------- T8 - T11

W, H = sp.SMALL["width"], sp.SMALL["height"]


def _records(winh, bw=14, k=96, seed=5):
    return sp.make_records(k, winh, bw, seed, W, H, "cpu")


def _fb():
    return sp.fresh_fb(W, H, "cpu")


def test_span_full_matches_run_class_interpret():
    """14x8 and 14x16 records together through planet_tpu's 16-row span
    class (one interpret-mode compile); a 16-row window holds both."""
    recs = torch.cat([_records(8, k=16)[0], _records(16, k=16)[0]])
    got = coverage_cuda.raster_span_plain(recs, _fb()).numpy()
    np.testing.assert_array_equal(sp.raster("full", recs, _fb()).numpy(), got)
    rows = cp._class_fixup(jnp.asarray(recs.numpy().T), 16, W, H)
    want = np.asarray(cp._run_class(
        rows.T, jnp.full((H, W), EMPTY, jnp.int32), winh=16,
        cap=recs.shape[0], width_pad=W, height_pad=H, interpret=True))
    assert (got != EMPTY).sum() > 1000
    np.testing.assert_array_equal(got == EMPTY, want == EMPTY)
    both = got != EMPTY
    assert np.abs((got[both] >> 10) - (want[both] >> 10)).max() <= 1
    assert np.abs((got[both] & 1023) - (want[both] & 1023)).max() <= 1


def _np_pack(z, shade):
    f32 = np.float32
    zq = np.minimum((z * f32(0.5) + f32(0.5)) * f32(2097151.0),
                    f32(2097150.0)).astype(np.int32)
    sq = np.minimum(shade * f32(1023.0), f32(1023.0)).astype(np.int32)
    return (zq << 10) | sq


def _np_fragments(r, rx, ry, body):
    """(accept mask, packed keys) of one record over pixel offsets rx, ry
    (f32 arrays): the tools' _one_triangle body with K2's light."""
    f32 = np.float32
    if body == "fewscalar":        # edge 0, z coefficient 9, normal 15
        r = r.copy()
        r[3:6] = r[6:9] = r[0:3]
        r[30] = r[31] = r[29]
        r[10] = r[11] = r[9]
        r[16:24] = r[15]
    e = [(r[3 * k] * ry - r[3 * k + 1] * rx) + r[3 * k + 2] for k in range(3)]
    ok = (e[0] > r[29]) & (e[1] > r[30]) & (e[2] > r[31])
    z = (e[0] * r[9] + e[1] * r[10]) + e[2] * r[11]
    ok &= z >= f32(-1.0)
    if body == "noshade":
        return ok, _np_pack(z, z)
    n = [(e[0] * r[c] + e[1] * r[c + 3]) + e[2] * r[c + 6]
         for c in (15, 16, 17)]
    nlen = np.sqrt((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2])
    ly = f32(np.float32(1.0 / np.sqrt(2.0)))
    ndl = (n[1] * ly + n[2] * -ly) / np.where(nlen > 0, nlen, f32(1.0))
    shade = np.sqrt(f32(0.001) + np.maximum(f32(0.0), ndl))
    return ok, _np_pack(z, shade)


def _np_span(name, recs, addr, winh):
    """Variant `name` transcribed in numpy, one record at a time."""
    v = sp.VARIANTS[name]
    fb = np.full((H, W), EMPTY, np.int32)
    for i, r in enumerate(recs):
        if r[28] == 0:
            continue
        px0, py0, px1, py1 = (int(x) for x in r[24:28])
        if v.bv:
            yb, xb = ((addr[i, 0], addr[i, 1]) if v.bv == "side"
                      else (py0 // 8, px0 // 128))
            yb, xb = min(max(yb, 0), (H - winh) // 8), \
                min(max(xb, 0), (W - 128) // 128)
            py, px = np.mgrid[yb * 8:yb * 8 + winh, xb * 128:xb * 128 + 128]
            sel = np.ones(py.shape, bool) if v.noin else (
                (px >= px0) & (px <= px1) & (py >= py0) & (py <= py1))
        else:
            py, px = np.mgrid[py0:py1 + 1, px0:px1 + 1]
            sel = np.ones(py.shape, bool)
        if v.body == "empty":
            continue
        if v.body == "rmw_only":
            fb[py, px] = np.minimum(fb[py, px], 7)
            continue
        ok, key = _np_fragments(r, (px - px0).astype(np.float32),
                                (py - py0).astype(np.float32), v.body)
        ok &= sel
        wy, wx = py, px
        if v.body == "static_rmw":
            wy, wx = py - py0, px - px0
        if v.bv == "static":
            k = i % v.group
            wy = (k * winh) % (H - winh) + (py - yb * 8)
            wx = 128 * (k % (W // 128)) + (px - xb * 128)
        np.minimum.at(fb, (wy[ok], wx[ok]), key[ok])
    return fb


@pytest.mark.parametrize("name", [n for n in sp.VARIANTS if n != "full"])
@pytest.mark.parametrize("winh", [8, 16])
def test_span_variant_matches_its_definition(name, winh):
    recs, addr = _records(winh, seed=7)
    before = recs.clone()
    got = sp.raster(name, recs, _fb(), winh=winh, addr=addr).numpy()
    want = _np_span(name, recs.numpy(), addr.numpy(), winh)
    np.testing.assert_array_equal(got, want)
    assert torch.equal(recs, before)
    if sp.VARIANTS[name].bv in ("record", "side"):
        np.testing.assert_array_equal(
            got, coverage_cuda.raster_span_plain(recs, _fb()).numpy())


def test_span_records_are_the_tools_triangles():
    """make_records: live, front-facing, each bbox inside its aligned
    window (the side array's blocks), 24x24 included."""
    for bw, winh in sp.CASES:
        recs, addr = _records(winh, bw)
        r = recs.numpy()
        assert (r[:, 28] == -1).all()
        a = addr.numpy()
        assert (r[:, 25] // 8 == a[:, 0]).all()
        assert (r[:, 27] < a[:, 0] * 8 + winh).all()
        assert (r[:, 24] // 128 == a[:, 1]).all()
        assert (r[:, 26] < a[:, 1] * 128 + 128).all()
        assert (r[:, 26] - r[:, 24] + 1 >= bw - 1).all()


def test_tools_run_on_the_cpu(capsys):
    """Each entry point's --device cpu --small run prints one line a
    variant, each equal to its plain version."""
    for mod, n in ((ns, len(ns.NOISE_VARIANTS) + len(ns.TILE_VARIANTS)),
                   (lut, len(lut.VARIANTS)),
                   (sp, sum(map(len, sp.CASES.values())))):
        assert mod.main(["--device", "cpu", "--small", "--reps", "1"]) == 0
        rows = [x for x in capsys.readouterr().out.splitlines()
                if "equal to plain" in x]
        assert len(rows) == n and all(x.endswith("True") for x in rows)
