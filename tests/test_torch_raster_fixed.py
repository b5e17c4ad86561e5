"""The fused frame's raster at fixed shapes, with no host read
(planet_tpu_torch.raster.coverage_cuda.raster_frame with a leaf count,
engine/device_step's raster and DeviceRenderer), on the CPU with the plain
versions:

* raster_frame on a patch batch padded to a render_cap with invalid NaN
  rows equals the frame of the live rows alone bit for bit, packed keys and
  counters, on the frame, near-clip and far-clip golden scenes (the
  PlanetEngine's vertices of each golden camera), with and without the
  leaf count;
* the near-clip overflow flag (more straddlers than clip_cap) equals
  planet_tpu's XLA coverage.raster_frame at clip_cap 2 and 1 on the
  near-clip scene, whose two straddlers fit the first and not the second,
  the packed frames at the golden tests' raster bars;
* C1's plain version with the count equals setup_t and straddle_mask_t on
  the sliced rows, and zero past the count, its straddler block counts
  the mask's;
* C2's plain version, the clip pass, leaves the dead records out and
  orders the live ones (slot, A, B);
* DeviceRenderer.render gives the frame of the live rows alone, its counts
  and counters 0-dim tensors, with wireframe toggled between frames;
* after a warm-up frame the render builds no tensor from host data
  (torch.tensor and torch.as_tensor raise).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from planet_tpu.raster import coverage as jcov
from planet_tpu_torch.engine import device_step
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import PlanetEngine
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.raster import coverage as cov
from planet_tpu_torch.raster import coverage_cuda as cc
from planet_tpu_torch.raster import nearclip
from planet_tpu_torch.tess import mesh
from torch_ranks import lod_camera_args
from torch_scenes import counter_values

torch.set_num_threads(1)
GOLD = "tests/goldens/"
GOLDENS = ("frame", "nearclip", "farclip")
RENDER_CAP = 512
CFG = EngineConfig()
CELL_MASK = mesh.cell_triangle_mask(CFG.patch_verts)


@pytest.fixture(scope="module")
def goldens():
    """{name: (clip, normal, valid) of PlanetEngine's leaves (n rows),
    padded (clip, normal, valid) at RENDER_CAP rows (NaN vertices, invalid)
    and n}."""
    gm = torch.as_tensor(mesh.grid_uv_skirt(CFG.patch_verts)[3])
    out = {}
    for name in GOLDENS:
        cam = cam_mod.Camera(position=np.load(GOLD + f"{name}_cam.npy"),
                             angles=np.load(GOLD + f"{name}_angles.npy"))
        fr = PlanetEngine(CFG, device="cpu").frame(cam)
        n = fr.n_leaves
        live = (fr.vertices.clip, fr.vertices.normal,
                gm[None].expand(n, -1, -1).clone())
        padded = []
        for t in live:
            fill = False if t.dtype == torch.bool else float("nan")
            pad = torch.full((RENDER_CAP - n,) + t.shape[1:], fill,
                             dtype=t.dtype)
            padded.append(torch.cat([t, pad]))
        out[name] = (live, tuple(padded), n)
    return out


def _raster(verts, **kw):
    return cc.raster_frame(*verts, CFG.window_w, CFG.window_h,
                           cell_mask=CELL_MASK, decode=False,
                           far_w=CFG.far_plane, **kw)


@pytest.mark.parametrize("name", GOLDENS)
def test_padded_frame_equals_the_live_rows_frame(goldens, name):
    live, padded, n = goldens[name]
    want, want_rc = _raster(live)
    for count in (torch.tensor([n], dtype=torch.int32), None):
        got, rc = _raster(padded, count=count)
        assert torch.equal(got, want)
        assert counter_values(rc) == counter_values(want_rc)
        assert all(isinstance(v, torch.Tensor) for v in rc)
    assert int((want != cov._EMPTY).sum()) > 10000
    if name == "nearclip":
        assert int(want_rc.n_straddle) > 0
    if name == "farclip":               # far-straddlers take K3
        assert int(want_rc.n_huge) > 0


@pytest.mark.parametrize("clip_cap", [2, 1])
def test_nearclip_overflow_flag_matches_planet_tpu(goldens, clip_cap):
    """The near-clip scene has two straddlers: clip_cap 2 draws both,
    clip_cap 1 the first in candidate order and flags the overflow, in
    both rasters. planet_tpu's row-job and huge caps are set above the
    scene's counts, so only clip_cap can overflow there."""
    live, padded, n = goldens["nearclip"]
    got, rc = _raster(padded, count=torch.tensor([n], dtype=torch.int32),
                      clip_cap=clip_cap)
    want, jrc = jcov.raster_frame(
        *(jnp.asarray(t.numpy()) for t in live), CFG.window_w, CFG.window_h,
        decode=False, cell_mask=CELL_MASK, far_w=CFG.far_plane,
        clip_cap=clip_cap, huge_cap=64, tri_cap=200000,
        ladder=((4, 200000), (8, 200000), (16, 100000), (32, 50000),
                (64, 20000), (128, 5000)))
    assert int(jrc.n_straddle) == int(rc.n_straddle) == 2
    assert bool(rc.overflowed) == bool(jrc.overflowed) == (clip_cap < 2)
    got, want = got.numpy(), np.asarray(want)
    cov_eq = (got == cov._EMPTY) == (want == cov._EMPTY)
    assert cov_eq.mean() > 0.999, cov_eq.mean()
    both = (got != cov._EMPTY) & (want != cov._EMPTY)
    assert np.abs((got[both] >> 10) - (want[both] >> 10)).max() <= 1
    assert np.abs((got[both] & 1023) - (want[both] & 1023)).max() <= 1


def test_setup_plain_with_a_count_equals_setup_t_on_the_sliced_rows(goldens):
    live, padded, n = goldens["nearclip"]
    g = CFG.patch_verts + 2
    w, h = CFG.window_w, CFG.window_h
    count = torch.tensor([n], dtype=torch.int32)
    got = cc.setup(*padded, w, h, CELL_MASK, CFG.far_plane, count)
    tm, lv, span = cov.setup_t(*live, w, h, CELL_MASK, far_w=CFG.far_plane)
    st = nearclip.straddle_mask_t(live[0], live[2], CELL_MASK)

    def rows(a, q):       # (..., 2 Q G G) -> (..., 2, Q, G G)
        return a.reshape(a.shape[:-1] + (2, q, g * g))

    for k, want in zip(got, (tm.view(torch.int32), lv, span, st)):
        if k.dtype == torch.float32:
            k = k.view(torch.int32)
        assert torch.equal(rows(k, RENDER_CAP)[..., :n, :], rows(want, n))
    for k in got[1:4]:
        assert not rows(k, RENDER_CAP)[:, n:].any()
    assert got[4] is None      # the block counts are the kernel's
    assert int(cc.straddle_blocks(got[3]).sum()) == int(st.sum()) == 2
    assert int(lv.sum()) > 1000
    with pytest.raises(ValueError):
        cc.setup_cuda(*padded, w, h, CELL_MASK, CFG.far_plane, count)


def test_clip_records_plain_marks_the_dead_records(goldens):
    """C2's plain version on the near-clip scene's padded rows with 4 slots:
    the dead records (the empty slots', and the parts a clip culls) are
    left out, and the records are the two straddlers' live clipped
    triangles (nearclip.clipped_tris on their indices) in (slot, A, B)
    order, their count on the records' device."""
    live_v, padded, n = goldens["nearclip"]
    w, h = CFG.window_w, CFG.window_h
    c1 = cc.setup(*padded, w, h, CELL_MASK, CFG.far_plane)
    s_idx, n_straddle, recs, count = cc.clip_pass(
        *padded[:2], c1[3], c1[4], w, h, CFG.far_plane, 4)
    assert int(n_straddle) == 2 and s_idx.tolist()[2:] == [c1[3].numel()] * 2
    assert recs.shape == (int(count[0]), 32) and count.dtype == torch.int32
    assert bool((recs[:, 28] != 0.0).all()) and count.shape == (1,)
    t = nearclip.clipped_tris(*padded[:2], s_idx[:2].long(), w, h,
                              far_w=CFG.far_plane)
    full = nearclip.records_from_tris(t)
    want = [full[k + 2 * part] for k in range(2) for part in range(2)
            if t.live[k + 2 * part]]
    assert torch.equal(recs.view(torch.int32),
                       torch.stack(want).view(torch.int32))
    assert int(count[0]) == int(t.live.sum()) > 0
    with pytest.raises(ValueError):
        cc.clip_pass_cuda(*padded[:2], c1[3], c1[4], w, h, CFG.far_plane, 4)


def test_compact_indices_is_planet_tpus():
    rng = np.random.default_rng(5)
    for n, cap in ((1000, 64), (1000, 600), (37, 37), (5, 0)):
        mask = rng.uniform(size=n) < 0.3
        idx, count = cc.compact_indices(torch.from_numpy(mask), cap)
        want, want_n = jcov._compact_indices(jnp.asarray(mask), cap)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
        assert int(count) == int(want_n) == mask.sum()
        assert idx.dtype == torch.int32 and count.shape == ()


# ------------------------------------------------------------- renderer

W, H = 160, 120
KW = dict(device="cpu", cap=1024, render_cap=512, gen_cap=512, max_lod=4)
LOD_CFG = EngineConfig(cache_capacity=512)


def _live_rows_frame(geom, wireframe=False):
    """The frame of the geometry's live rows alone, as the raster drew it
    before it took all render_cap rows."""
    n = int(geom.meta[0])
    pv = geom.vertices
    image, depth, rc = cc.raster_frame(
        pv.clip[:n], pv.normal[:n], geom.valid[:n], W, H,
        cell_mask=CELL_MASK, wireframe=wireframe, far_w=LOD_CFG.far_plane)
    return image, depth, rc


def test_device_renderer_frame_and_wireframe_toggle():
    r = device_step.DeviceRenderer(LOD_CFG, W, H, **KW)
    pool = r.init_pool()
    args = lod_camera_args(LOD_CFG, W, H)
    for wireframe in (False, True, False):
        r.wireframe = wireframe
        frame = r.render(pool, *args)
        image, depth, rc = _live_rows_frame(r.last_geometry, wireframe)
        assert torch.equal(frame.image, image)
        assert torch.equal(frame.depth, depth)
        assert counter_values(r.last_counters) == counter_values(rc)
        for v in (frame.n_leaves, frame.n_generated, frame.overflowed,
                  *r.last_counters[:1], r.last_counters.overflowed):
            assert isinstance(v, torch.Tensor) and v.shape == ()
        assert int(frame.n_leaves) > 24 and not bool(frame.overflowed)
        assert int((depth < np.inf).sum()) > 1000


def test_render_builds_no_tensor_from_host_data(monkeypatch):
    """After a warm-up frame (which builds the cached constants), a frame
    whose camera comes as tensors calls neither torch.tensor nor
    torch.as_tensor on the way from the geometry to the framebuffer."""
    r = device_step.DeviceRenderer(LOD_CFG, W, H, fetch="u8", preview=2,
                                   **KW)
    pool = r.init_pool()
    args = [torch.as_tensor(a) for a in lod_camera_args(LOD_CFG, W, H)]
    want = r.render(pool, *args)

    def refuse(*a, **k):
        raise AssertionError("a tensor built from host data in a frame")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    frame = r.render(pool, *args)
    monkeypatch.undo()
    assert torch.equal(frame.image, want.image)
    assert frame.preview.shape == (H // 2, W // 2)
