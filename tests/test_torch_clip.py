"""The clip pass as the port runs it (coverage_cuda.clip_pass; on the CPU
C2's plain version) against planet_tpu's clip pass on the XLA path
(raster/coverage.py's _clipped: _compact_indices over
nearclip.straddle_mask_t, then nearclip.clipped_tris and
records_from_tris):

* the compaction equals planet_tpu's _compact_indices on the straddler
  mask: the first clip_cap straddlers in candidate order, N in the empty
  slots, and n_straddle counting all of them;
* the records are planet_tpu's live clipped triangles in (slot, A, B)
  order, at the bar of tests/test_torch_raster.py's nearclip comparison
  (relative 1e-6: planet_tpu's XLA ops against torch's), and their count
  is the live triangles';
* C1's straddler block counts (coverage_cuda.straddle_blocks) sum the
  mask SETUP_BLOCK candidates at a time, the counts C2 scans on the card;
* raster_frame's framebuffer is bit for bit the one the clip pass drew
  before its records were compacted: all 2 clip_cap records, dead ones
  included (row 28 = 0, skipped);

at 0 straddlers (the frame golden), a few (the near-clip golden's 2, the
view scene's 1) and past clip_cap (the near-clip golden at 1 slot and the
straddle scene's 888 at 512 and at 3, `overflowed` set).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planet_tpu.raster import coverage as jcov
from planet_tpu.raster import nearclip as jnc
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import PlanetEngine
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.raster import coverage as cov
from planet_tpu_torch.raster import coverage_cuda as cc
from planet_tpu_torch.raster import nearclip
from planet_tpu_torch.tess import mesh
from torch_scenes import (STRADDLE, VIEW, straddle_scene,
                                view_scene)

torch.set_num_threads(1)
GOLD = "tests/goldens/"
CFG = EngineConfig()
# (scene, clip_cap, straddlers, whether any clipped part is live: the
# straddle scene's first three straddlers all clip to culled parts)
CASES = [("frame", 512, 0, False), ("nearclip", 512, 2, True),
         ("nearclip", 1, 2, True), ("view", 512, 1, True),
         ("straddle", 512, 888, True), ("straddle", 3, 888, False)]


@functools.lru_cache(maxsize=None)
def scene(name):
    """(clip, normal, valid, width, height, cell_mask, far_w) on the CPU:
    a golden camera's PlanetEngine leaves, or a torch_scenes scene."""
    if name == "view":
        arrays = view_scene(VIEW["seed"], VIEW["width"], VIEW["height"],
                            VIEW["far"])
        return (*map(torch.from_numpy, arrays), VIEW["width"],
                VIEW["height"], None, VIEW["far"])
    if name == "straddle":
        return (*map(torch.from_numpy, straddle_scene(**STRADDLE)),
                STRADDLE["width"], STRADDLE["height"], None, STRADDLE["far"])
    cam = cam_mod.Camera(position=np.load(GOLD + f"{name}_cam.npy"),
                         angles=np.load(GOLD + f"{name}_angles.npy"))
    fr = PlanetEngine(CFG, device="cpu").frame(cam)
    gm = torch.as_tensor(mesh.grid_uv_skirt(CFG.patch_verts)[3])
    return (fr.vertices.clip, fr.vertices.normal,
            gm[None].expand(fr.n_leaves, -1, -1).clone(), CFG.window_w,
            CFG.window_h, mesh.cell_triangle_mask(CFG.patch_verts),
            CFG.far_plane)


def planet_tpu_clip_pass(clip, normal, valid, w, h, cm, far, cap):
    """planet_tpu's _clipped on numpy copies: (s_idx, n_straddle, the
    records of its live clipped triangles in (slot, A, B) order)."""
    j = [jnp.asarray(t.numpy()) for t in (clip, normal, valid)]
    smask = jnc.straddle_mask_t(j[0], j[2], cm)
    s_idx, n = jcov._compact_indices(smask, cap)
    t = jnc.clipped_tris(j[0], j[1], s_idx, w, h, far_w=far)
    recs, live = np.asarray(jnc.records_from_tris(t)), np.asarray(t.live)
    order = np.arange(2 * cap).reshape(2, cap).T.reshape(-1)
    return np.asarray(s_idx), int(n), recs[order][live[order]]


@pytest.mark.parametrize("name,cap,straddlers,drawn", CASES)
def test_clip_pass_is_planet_tpus(name, cap, straddlers, drawn):
    clip, normal, valid, w, h, cm, far = scene(name)
    _, _, _, straddle, blocks = cc.setup_plain(clip, normal, valid, w, h, cm,
                                               far)
    s_idx, n, recs, count = cc.clip_pass(clip, normal, straddle, blocks, w,
                                         h, far, cap)
    want_idx, want_n, want_recs = planet_tpu_clip_pass(
        clip, normal, valid, w, h, cm, far, cap)
    np.testing.assert_array_equal(s_idx.numpy(), want_idx)
    assert int(n) == want_n == straddlers
    assert s_idx.dtype == count.dtype == torch.int32
    assert n.shape == () and count.shape == (1,)
    assert int(count[0]) == recs.shape[0] == want_recs.shape[0]
    assert drawn == (recs.shape[0] > 0)
    np.testing.assert_allclose(recs.numpy(), want_recs, rtol=1e-6, atol=0)
    assert blocks is None      # the block counts are the kernel's
    assert int(cc.straddle_blocks(straddle).sum()) == straddlers


def test_straddle_blocks_count_each_block_of_the_mask():
    rng = np.random.default_rng(7)
    for n in (1, 255, 256, 257, 1000, 4096):
        mask = torch.from_numpy(rng.uniform(size=n) < 0.1)
        got = cc.straddle_blocks(mask)
        want = [int(mask[k:k + cc.SETUP_BLOCK].sum())
                for k in range(0, n, cc.SETUP_BLOCK)]
        assert got.dtype == torch.int32 and got.tolist() == want


def _old_clip_frame(clip, normal, valid, w, h, cm, far, cap):
    """The frame with the clip pass as it drew before its records were
    compacted: the routed classes, then all 2 cap clipped records, the
    dead ones (row 28 = 0) among them."""
    tm, live, span, straddle, _ = cc.setup_plain(clip, normal, valid, w, h,
                                                 cm, far)
    fb = torch.full((h, w), cov._EMPTY, dtype=torch.int32)
    cc.raster_classes(*cc.route_records_plain(tm, live, span), fb)
    s_idx, _ = cc.compact_indices(straddle, cap)
    t = nearclip.clipped_tris(clip, normal, s_idx.long(), w, h, far_w=far)
    recs = nearclip.records_from_tris(t)
    assert int((recs[:, 28] != 0.0).sum()) == int(t.live.sum())
    return cc.raster_huge_plain(recs, fb)


@pytest.mark.parametrize("name,cap", [("nearclip", 512), ("nearclip", 1),
                                      ("straddle", 512)])
def test_frame_unchanged_by_the_compacted_records(name, cap):
    """raster_frame's packed frame and counters with the compacted clip
    records equal the frame drawn from all 2 clip_cap records."""
    clip, normal, valid, w, h, cm, far = scene(name)
    fb, rc = cc.raster_frame(clip, normal, valid, w, h, cell_mask=cm,
                             far_w=far, decode=False, clip_cap=cap)
    want = _old_clip_frame(clip, normal, valid, w, h, cm, far, cap)
    assert torch.equal(fb, want)
    assert bool(rc.overflowed) == (int(rc.n_straddle) > cap)
    assert int(rc.n_straddle) == {"nearclip": 2, "straddle": 888}[name]
