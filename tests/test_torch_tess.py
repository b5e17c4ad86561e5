"""The vertex program as V1 computes it (planet_tpu_torch/tess/vertex_cuda.py,
plain version on the CPU) against planet_tpu's tess.vertex.tessellate_blend
and raster.shade.lambert on the XLA path.

Inputs are made with numpy from seeds: Q = 9 quads on the planet's sphere
within 0.2 rad of the point below the camera, one for each (variant_x,
variant_y) pair, 32x32 tiles of heights with sigma 3000 m, the camera's
view-projection. Three batches: quads 0.1 rad wide (the LOD's depth-4
quads, 640 km) seen from 3,000 km up, where the LOD draws quads that
wide, with no skirt (every interpolation takes the slerp), the same with
skirts of 0-500 m, and quads 5e-4 rad wide (3 km) from 20 km up (1 -
dot(n0, n1) < 0.001: every interpolation takes the linear fallback).
Each pair is held at the tess bars of tests/test_tess.py:116-146 (height
rtol 1e-5 atol 1e-2, world relative 1e-5, normal atol 5e-4, clip relative
2e-4, shade atol 5e-4). The two-tap table rebuilds blend_matrices bit for
bit (the port's and planet_tpu's), and the fused frame's padding rows (NaN
corner normals) come out NaN at the same places as planet_tpu's dense form
and the port's einsum form before the table. A variant is taken as a
torch index takes it, the rule V1 copies. V1's padding rows: a row with
any NaN among its twelve corner-normal words comes out NaN in every
output but the height (the fact V1's skip of such a row rests on); on
the fused step's own inputs (a small render_cap on the CPU) the rows at
or past n_leaves, and only those, have zero DF corners and NaN corner
normals; and the dispatcher on the CPU is the plain version bit for bit
on those rows.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planet_tpu.raster.shade import lambert as jlambert
from planet_tpu.tess import vertex as jvertex
from planet_tpu_torch.raster import shade as shade_mod
from planet_tpu_torch.tess import mesh
from planet_tpu_torch.tess import vertex
from planet_tpu_torch.tess import vertex_cuda
from torch_scenes import TESS_BATCHES, TESS_PAIRS, tess_batch, tess_padded

torch.set_num_threads(1)
PAIRS = TESS_PAIRS
BATCHES = TESS_BATCHES
FIELDS = ("clip", "world", "normal", "height", "snormal")


def run_port(args):
    pv, shade = vertex_cuda.tessellate_shaded(
        *(torch.as_tensor(a) for a in args))
    return {**{k: getattr(pv, k).numpy() for k in FIELDS},
            "shade": shade.numpy()}


def run_planet_tpu(args):
    pv = jvertex.tessellate_blend(*(jnp.asarray(a) for a in args))
    out = {k: np.asarray(getattr(pv, k)) for k in FIELDS}
    out["shade"] = np.asarray(jlambert(pv.normal))
    return out


@functools.lru_cache(maxsize=None)
def batch(name):
    args = tess_batch(*BATCHES[name])
    return args, run_port(args), run_planet_tpu(args)


def assert_tess_bars(got, want):
    """tests/test_tess.py:116-146's bars on one set of vertices."""
    np.testing.assert_allclose(got["height"], want["height"], rtol=1e-5,
                               atol=1e-2)
    scale = max(np.abs(want["world"]).max(), 1.0)
    assert np.abs(got["world"] - want["world"]).max() / scale < 1e-5
    np.testing.assert_allclose(got["normal"], want["normal"], rtol=0,
                               atol=5e-4)
    cscale = np.maximum(np.abs(want["clip"]),
                        np.abs(want["clip"]).max() * 1e-3)
    assert np.max(np.abs(got["clip"] - want["clip"]) / cscale) < 2e-4
    np.testing.assert_allclose(got["shade"], want["shade"], rtol=0,
                               atol=5e-4)


@pytest.mark.parametrize("name", sorted(BATCHES))
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"vx{p[0]}-vy{p[1]}")
def test_plain_at_tess_bars_against_planet_tpu(name, pair):
    args, got, want = batch(name)
    k = PAIRS.index(pair)
    assert (int(args[3][k]), int(args[4][k])) == pair
    assert_tess_bars({f: v[k] for f, v in got.items()},
                     {f: v[k] for f, v in want.items()})
    for f, v in got.items():
        assert np.isfinite(v[k]).all(), f


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_plain_at_64_vertex_patches_against_planet_tpu(name, monkeypatch):
    """BASELINE config 3's 64-vertex patches (grid 66, 66 x 66 tiles) on
    every pair of the batch, at the tess bars, with planet_tpu's one
    number fixed at the 30-vertex patch, its vertex program's divisor
    mesh.PATCH_QUADS (the reference shader's 29), set to the patch's 63
    quads, as the port's takes it from the grid."""
    from planet_tpu.tess import mesh as jmesh
    monkeypatch.setattr(jmesh, "PATCH_QUADS", 63)
    args = tess_batch(*BATCHES[name], dim=66)
    pv, shade = vertex_cuda.tessellate_shaded(
        *(torch.as_tensor(a) for a in args), grid=66)
    got = {**{k: getattr(pv, k).numpy() for k in FIELDS},
           "shade": shade.numpy()}
    jpv = jvertex.tessellate_blend(*(jnp.asarray(a) for a in args), grid=66)
    want = {k: np.asarray(getattr(jpv, k)) for k in FIELDS}
    want["shade"] = np.asarray(jlambert(jpv.normal))
    assert got["clip"].shape == want["clip"].shape == (len(PAIRS), 66, 66, 4)
    for k in range(len(PAIRS)):
        assert_tess_bars({f: v[k] for f, v in got.items()},
                         {f: v[k] for f, v in want.items()})


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batches_take_the_interpolation_branch_they_name(name):
    """Every corner pair of the slerp batches takes the slerp, of the
    linear batch the fallback (1 - dot(n0, n1) < 0.001 in f32)."""
    args, _, _ = batch(name)
    n = torch.as_tensor(args[1])
    d = vertex._dot(n[:, [0, 2, 0, 1]], n[:, [1, 3, 2, 3]])
    lin = (1.0 - d) < 0.001
    assert bool(lin.all()) if name == "linear" else not bool(lin.any())


def test_dispatcher_on_cpu_runs_the_plain_version():
    args = [torch.as_tensor(a) for a in tess_batch(*BATCHES["skirt"], q=3)]
    pv, shade = vertex_cuda.tessellate_shaded(*args)
    want, want_shade = vertex_cuda.tessellate_shaded_plain(*args)
    for f in FIELDS:
        assert torch.equal(getattr(pv, f), getattr(want, f)), f
    assert torch.equal(shade, want_shade)
    assert torch.equal(shade, vertex_cuda.lambert(pv.normal))


def test_pinned_lambert_at_the_shade_bar():
    """The pinned lambert (dots written out) against shade.lambert, which
    its other callers keep, on the batch's normals."""
    _, got, _ = batch("skirt")
    n = torch.as_tensor(got["normal"])
    np.testing.assert_allclose(vertex_cuda.lambert(n).numpy(),
                               shade_mod.lambert(n).numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dim", [32, 16, 64])
def test_two_tap_table_rebuilds_the_blend_matrices(dim):
    idx, w = vertex.blend_taps(dim, mesh.PATCH_VERTS)
    dense = np.zeros((3, 3, mesh.GRID, dim), np.float32)
    for pos in np.ndindex(*idx.shape[:3]):
        dense[pos][idx[pos][0]] += w[pos][0]
        if idx[pos][1] != idx[pos][0]:
            dense[pos][idx[pos][1]] += w[pos][1]
        else:
            assert w[pos][1] == 0.0
    want = vertex.blend_matrices(dim, mesh.PATCH_VERTS)
    assert dense.tobytes() == want.tobytes()
    assert want.tobytes() == np.asarray(
        jvertex.blend_matrices(dim, mesh.PATCH_VERTS)).tobytes()
    assert (idx[..., 0] <= idx[..., 1]).all()


def _einsum_form(args):
    """The port's vertex program before the two-tap table: the dense blend
    matrices as batched products (torch.einsum), then the pinned tail."""
    c, n, tiles, vx, vy, skirt, vp = (torch.as_tensor(a) for a in args)
    w = torch.as_tensor(vertex.blend_matrices(32, mesh.PATCH_VERTS))
    wx, wy = w[vx.long()], w[vy.long()]

    def xb(tap):
        return torch.einsum('qyi,qoi->qyo', tiles, wx[:, tap])

    def yb(t1, tap):
        return torch.einsum('qai,qib->qab', wy[:, tap], t1)

    tc = xb(1)
    pv = vertex._assemble(c, n, yb(tc, 1), yb(xb(0), 1), yb(xb(2), 1),
                          yb(tc, 0), yb(tc, 2), skirt, vp, c.shape[0],
                          mesh.GRID)
    return {**{k: getattr(pv, k).numpy() for k in FIELDS},
            "shade": shade_mod.lambert(pv.normal).numpy()}


def test_padding_rows_nan_where_the_dense_forms_are():
    """The fused frame's padding rows: zero DF corners, so the corner
    normals are 0 / 0 = NaN and the camera-relative corners finite. Their
    NaNs fall where planet_tpu's and the einsum form's do (every output but
    the height), and the live rows stay finite."""
    args = tess_padded(6, 3)
    got = run_port(args)
    for want in (run_planet_tpu(args), _einsum_form(args)):
        for f in got:
            np.testing.assert_array_equal(np.isnan(got[f]),
                                          np.isnan(want[f]), err_msg=f)
    for f in got:
        assert np.isfinite(got[f][:3]).all(), f
        assert np.isnan(got[f][3:]).all() == (f != "height"), f


def test_variants_taken_as_a_torch_index():
    """A variant indexes the two-tap table as a torch index does, the rule
    V1 copies: -3..-1 count from the end of the table, and any other value
    outside {0, 1, 2} fails."""
    args = tess_batch(*BATCHES["skirt"], q=3)
    want = run_port(args)
    for k in (3, 4):
        wrapped = list(args)
        wrapped[k] = args[k] - 3
        got = run_port(wrapped)
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for bad in (3, -4):
        wrong = list(args)
        wrong[3] = np.full_like(args[3], bad)
        with pytest.raises(IndexError):
            run_port(wrong)


def _fused_uniforms():
    """The fused step's leaf count, DF corners (the refine rung's) and V1's
    arguments (the uniforms rung's outputs, the pool's tiles at their
    slots) on the CPU at a small render_cap, from one pool state."""
    from planet_tpu_torch.cache import device_pool as dp
    from planet_tpu_torch.engine import device_step
    from planet_tpu_torch.engine.config import EngineConfig
    from torch_ranks import lod_camera_args

    cfg = EngineConfig(cache_capacity=256, generations_per_frame=6)
    caps = dict(cap=512, render_cap=96, gen_cap=16, max_lod=4)
    roots = device_step.face_roots(cfg.radius, "cpu")
    args = [torch.as_tensor(a) for a in lod_camera_args(cfg, 96, 72, 1.6)]
    out = {}
    for rung in ("refine", "uniforms"):
        pool = dp.init(cfg.cache_capacity, cfg.tile_dim, "cpu")
        step = device_step.build_geometry_step(cfg, device="cpu",
                                               stop_after=rung, **caps)
        out[rung] = step(pool, *args, *roots)
    o = out["uniforms"].outputs
    n = int(out["uniforms"].meta[0])
    v1 = (o["corners_rel"], o["normals"], dp.gather(pool, o["slot"]),
          o["vx"], o["vy"], o["skirt"], args[2], cfg.patch_verts + 2)
    return n, out["refine"].outputs, v1


@pytest.mark.parametrize("corner", range(4))
def test_one_nan_normal_word_makes_a_padding_row(corner):
    """V1 takes a row with a NaN among its corner normals as a padding
    row and computes its height alone: in the plain version one NaN word
    at any corner makes every output of that row but the height NaN, and
    leaves the height and the other rows as they were."""
    args = tess_batch(*BATCHES["skirt"], q=3)
    want = run_port(args)
    nan = list(args)
    nan[1] = args[1].copy()
    nan[1][1, corner, corner % 3] = np.nan
    got = run_port(nan)
    for f in got:
        assert np.isnan(got[f][1]).all() == (f != "height"), f
        np.testing.assert_array_equal(got[f][0::2], want[f][0::2],
                                      err_msg=f)
    np.testing.assert_array_equal(got["height"], want["height"])


def test_fused_step_padding_rows_meet_the_counts_contract():
    """The leaf count's contract on the fused step's own inputs: every
    row at or past n_leaves has zero DF corners and NaN corner normals
    (0 / 0), so V1 takes it as a padding row, and no row before it has a
    NaN normal."""
    n, ref, v1 = _fused_uniforms()
    rows = v1[0].shape[0]
    assert 0 < n < rows
    for part in ("corners_hi", "corners_lo"):
        assert not bool(ref[part][n:].any()), part
    assert bool(torch.isnan(v1[1][n:]).all())
    assert bool(torch.isfinite(v1[1][:n]).all())


def test_dispatcher_is_the_plain_version_on_the_fused_rows_on_the_cpu():
    """On CPU tensors the dispatcher runs the plain version: it evaluates
    every row, the padding rows coming out NaN by themselves (every
    output but the height), bit for bit; the kernel's wrapper refuses
    CPU tensors."""
    n, _, v1 = _fused_uniforms()
    pv, shade = vertex_cuda.tessellate_shaded(*v1)
    want, want_shade = vertex_cuda.tessellate_shaded_plain(*v1)
    for f in FIELDS:
        got_f, want_f = getattr(pv, f), getattr(want, f)
        assert torch.equal(got_f.view(torch.int32),
                           want_f.view(torch.int32)), f
        assert bool(torch.isnan(got_f[n:]).all()) == (f != "height"), f
        assert bool(torch.isfinite(got_f[:n]).all()), f
    assert torch.equal(shade.view(torch.int32), want_shade.view(torch.int32))
    with pytest.raises(ValueError):
        vertex_cuda.tessellate_shaded_cuda(*v1)
