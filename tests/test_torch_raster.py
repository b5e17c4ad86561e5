"""The port's exact raster (planet_tpu_torch.raster, plain versions on the
CPU) against planet_tpu's: triangle records vs coverage._setup_t, the record
gather vs coverage._gather_packed_t, the near-clip helpers, and whole frames
vs the XLA raster (coverage.raster_frame) on seeded random scenes with span,
huge, near-clipped and far-clipped triangles, wireframe included (the
Pallas raster in interpret mode: tests/test_torch_raster_pallas.py).

Bars are tests/test_raster_exact.py:243-288's: coverage agreement > 0.999,
packed depth and shade within 1 quantum where both cover a pixel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from planet_tpu.raster import coverage as jcov
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.raster import coverage as tcov
from planet_tpu_torch.raster import coverage_cuda as tcc
from planet_tpu_torch.raster import nearclip as tnc
from planet_tpu_torch.tess import mesh
from torch_scenes import SCREEN, VIEW, screen_scene, view_scene

torch.set_num_threads(1)
F = np.float32
EMPTY = 2**31 - 1


# small row-job caps keep the XLA raster quick; overflow is asserted off
LADDER = ((4, 1024), (8, 1024), (16, 1024), (32, 1024), (64, 1024),
          (128, 512))


def _packed_jax(clip, normal, valid, width, height, **kw):
    packed, counters = jcov.raster_frame(jnp.asarray(clip), jnp.asarray(normal),
                                  jnp.asarray(valid), width, height,
                                  decode=False, ladder=LADDER, tri_cap=1024,
                                  huge_cap=64, clip_cap=64,
                                  clip_run_cap=64, **kw)
    assert not bool(counters.overflowed)
    return np.asarray(packed)


def _packed_port(clip, normal, valid, width, height, **kw):
    packed, counters = tcc.raster_frame(
        torch.from_numpy(clip), torch.from_numpy(normal),
        torch.from_numpy(valid), width, height, decode=False, **kw)
    assert not counters.overflowed
    return packed.numpy(), counters


def _assert_raster_bars(got, want):
    cov_eq = (got == EMPTY) == (want == EMPTY)
    assert cov_eq.mean() > 0.999, cov_eq.mean()
    both = (got != EMPTY) & (want != EMPTY)
    dz = np.abs((got[both] >> 10) - (want[both] >> 10))
    ds = np.abs((got[both] & 1023) - (want[both] & 1023))
    assert dz.max(initial=0) <= 1
    assert ds.max(initial=0) <= 1


def test_setup_records_match_jax():
    for clip, normal, valid, w, h, cm, far in (
            screen_scene(5, SCREEN["width"], SCREEN["height"],
                         SCREEN["sizes"]) + (200, 160, None, None),
            view_scene(6, 160, 120, 40.0) + (160, 120, None, 40.0)):
        tm_j, live_j, _, _, span_j = jcov._setup_t(
            jnp.asarray(clip), jnp.asarray(normal), jnp.asarray(valid), w, h,
            cm, far_w=far)
        tm_t, live_t, span_t = tcov.setup_t(
            torch.from_numpy(clip), torch.from_numpy(normal),
            torch.from_numpy(valid), w, h, cm, far_w=far)
        np.testing.assert_array_equal(live_t.numpy(), np.asarray(live_j))
        lv = np.asarray(live_j)
        np.testing.assert_array_equal(span_t.numpy()[lv],
                                      np.asarray(span_j)[lv])
        np.testing.assert_allclose(tm_t.numpy(), np.asarray(tm_j),
                                   rtol=1e-6, atol=0)


def test_setup_records_match_jax_on_patch_grids():
    """Full 32x32 patch grids with the strip's cell mask."""
    rng = np.random.default_rng(9)
    q, g = 3, mesh.GRID
    clip = np.concatenate([rng.uniform(-1.0, 1.0, (q, g, g, 3)),
                           rng.uniform(0.5, 2.0, (q, g, g, 1))], -1)
    clip[..., :2] *= clip[..., 3:]
    clip = clip.astype(F)
    normal = rng.normal(size=(q, g, g, 3)).astype(F)
    valid = np.broadcast_to(mesh.grid_uv_skirt()[3], (q, g, g)).copy()
    cm = mesh.cell_triangle_mask()
    tm_j = np.asarray(jcov._setup_t(jnp.asarray(clip), jnp.asarray(normal),
                                    jnp.asarray(valid), 64, 48, cm)[0])
    tm_t = tcov.setup_t(torch.from_numpy(clip), torch.from_numpy(normal),
                        torch.from_numpy(valid), 64, 48, cm)[0].numpy()
    np.testing.assert_allclose(tm_t, tm_j, rtol=1e-6, atol=0)


def test_gather_matches_jax_bitwise():
    rng = np.random.default_rng(7)
    tm = rng.normal(size=(32, 300)).astype(F)
    idx = np.concatenate([rng.integers(0, 300, 200), [300, 301, 299, 0]])
    idx = idx.astype(np.int32)
    want = np.asarray(jcov._gather_packed_t(jnp.asarray(tm),
                                            jnp.asarray(idx))).T
    got = tcc.gather_records_plain(torch.from_numpy(tm),
                                   torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[-4:-2] == 0).all()        # out of range -> dead


@pytest.mark.parametrize("wireframe", [False, True])
def test_screen_scene_matches_xla(wireframe):
    clip, normal, valid = screen_scene(11, SCREEN["width"], SCREEN["height"],
                                       SCREEN["sizes"])
    args = (clip, normal, valid, SCREEN["width"], SCREEN["height"])
    got, counters = _packed_port(*args, wireframe=wireframe)
    assert counters.n_per_class[0] > 0 and counters.n_huge > 0
    _assert_raster_bars(got, _packed_jax(*args, wireframe=wireframe))


def test_view_scene_with_near_and_far_clipping_matches_xla():
    far, w, h = VIEW["far"], VIEW["width"], VIEW["height"]
    clip, normal, valid = view_scene(VIEW["seed"], w, h, far)
    args = (clip, normal, valid, w, h)
    got, counters = _packed_port(*args, far_w=far)
    assert counters.n_straddle > 0, "scene must exercise the near clip"
    tm = tcov.setup_t(*(torch.from_numpy(a) for a in args[:3]), w, h,
                      far_w=far)[0]
    assert int((tm[28] > 0).sum()) > 0, "scene must exercise the far clip"
    assert (got != EMPTY).mean() > 0.05
    _assert_raster_bars(got, _packed_jax(*args, far_w=far))


def test_front_face_is_visible_back_face_culled():
    """A hand-derived case that does not go through the oracle: a triangle
    at view depth 5 whose window-space (y up) winding A=(0,0), B=(0,3),
    C=(3,0) is clockwise — GL's front face with glFrontFace(GL_CW)
    (reference main.cpp:811-816) — is drawn; the reversed winding is
    culled."""
    proj = cam_mod.perspective_lh(
        cam_mod.proj_factor_from_fovy(np.deg2rad(50.0)), 1.0, 1.0, 100.0)

    def cell(a, b, c):
        pts = np.array([[a, c], [b, b]], np.float64)      # g00 g01 / g10 g11
        hom = np.concatenate([pts, np.ones((2, 2, 1))], -1)
        clip = np.einsum("ij,abj->abi", proj.astype(np.float64), hom)
        normal = np.zeros((1, 2, 2, 3), F)
        normal[..., 1] = 1.0
        return (torch.from_numpy(clip[None].astype(F)),
                torch.from_numpy(normal), torch.ones((1, 2, 2), dtype=bool))

    a, b, c = (0.0, 0.0, 5.0), (0.0, 3.0, 5.0), (3.0, 0.0, 5.0)
    image, depth, counters = tcc.raster_frame(*cell(a, b, c), 64, 64)
    assert counters.n_tris == 1 and np.isfinite(depth.numpy()).sum() > 100
    image, depth, counters = tcc.raster_frame(*cell(a, c, b), 64, 64)
    assert counters.n_tris == 0 and not np.isfinite(depth.numpy()).any()


def test_nearclip_helpers_match_jax():
    from planet_tpu.raster import nearclip as jnc

    clip, normal, valid = view_scene(17, 160, 120, 40.0)
    mask_j = np.asarray(jnc.straddle_mask_t(jnp.asarray(clip),
                                            jnp.asarray(valid)))
    mask_t = tnc.straddle_mask_t(torch.from_numpy(clip),
                                 torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(mask_t, mask_j)
    idx = np.nonzero(mask_t)[0]
    assert len(idx) > 0
    tj = jnc.clipped_tris(jnp.asarray(clip), jnp.asarray(normal),
                          jnp.asarray(idx.astype(np.int32)), 160, 120,
                          far_w=40.0)
    tt = tnc.clipped_tris(torch.from_numpy(clip), torch.from_numpy(normal),
                          torch.from_numpy(idx), 160, 120, far_w=40.0)
    np.testing.assert_array_equal(tt.live.numpy(), np.asarray(tj.live))
    np.testing.assert_allclose(
        tnc.records_from_tris(tt).numpy(),
        np.asarray(jnc.records_from_tris(tj)), rtol=1e-6, atol=0)


def test_wrappers_dispatch_plain_on_cpu():
    rng = np.random.default_rng(3)
    tm = torch.from_numpy(rng.normal(size=(32, 10)).astype(F))
    live = torch.from_numpy(rng.uniform(size=10) < 0.7)
    span = torch.from_numpy(rng.integers(1, 30, 10).astype(np.int32))
    with pytest.raises(ValueError):             # CPU tensor: no kernel
        tcc.route_records_cuda(tm, tcc.route_masks_plain(tm, live, span))
    fb = torch.full((4, 4), EMPTY, dtype=torch.int32)
    with pytest.raises(ValueError):
        tcc.raster_span_cuda(torch.zeros((1, 32)), fb)
    # the routed rasters on CPU records are the plain ones
    w, h = SCREEN["width"], SCREEN["height"]
    scene = [torch.as_tensor(a)
             for a in screen_scene(11, w, h, SCREEN["sizes"])]
    classes = tcc.route_records_plain(*tcc.setup_plain(*scene, w, h)[:3])
    assert classes[0].shape[0] > 0 and classes[1].shape[0] > 0
    fb = torch.full((h, w), EMPTY, dtype=torch.int32)
    assert tcc.raster_classes(*classes, fb) is classes[2]
    want = torch.full_like(fb, EMPTY)
    tcc.raster_span_plain(classes[0], want)
    tcc.raster_huge_plain(classes[1], want)
    assert torch.equal(fb, want)


def test_nan_shades_pack_as_planet_tpu_packs_them():
    """Fragments whose shade is NaN (here every other patch's normals are
    NaN, the other patches finite) against planet_tpu's coverage.raster_frame
    called eagerly (jax.disable_jit: no fusion, so no FMA contraction):
    the packed framebuffers are equal bit for bit, and the NaN shades pack
    as 0, as XLA converts NaN to int32 (coverage.to_i32 and the kernels'
    fragment() do the same; the GPU tests hold K2 and K3 to the plain
    version on torch_scenes.nan_shade_records). One row-job class and a
    huge cap of 2 keep the eager XLA raster short."""
    import jax

    w, h = 96, 72
    clip, normal, valid = screen_scene(
        11, w, h, ((40, 1.5), (12, 8.0), (4, 30.0), (2, 90.0)))
    normal = normal.copy()
    normal[::2] = np.nan
    got, _ = _packed_port(clip, normal, valid, w, h)
    with jax.disable_jit():
        want, counters = jcov.raster_frame(
            jnp.asarray(clip), jnp.asarray(normal), jnp.asarray(valid), w, h,
            decode=False, ladder=((128, 256),), tri_cap=256, huge_cap=2,
            clip_cap=8, clip_run_cap=8)
    assert not bool(counters.overflowed) and int(counters.n_huge) > 0
    np.testing.assert_array_equal(got, np.asarray(want))
    nan_q = int(tcov.to_i32(torch.tensor([float("nan")]))[0])
    assert nan_q == 0
    shades = got[got != EMPTY] & 1023
    assert (shades == 0).sum() > 100 and (shades > 0).sum() > 100
