"""The port's fused device frame (DeviceRenderer, run eagerly on the CPU
with the kernels' plain versions) on the near-clip and far-clip goldens,
at the bars of tests/test_torch_golden.py, and its live triangles against
PlanetEngine's on the same cameras.

The near-clip scene draws one live triangle fewer on the device path: a
sliver (area under 3 px^2 over a 42 x 82 px bbox) whose winding flips when
a vertex moves by a 1/16 px snap. The cause is the device step's corner
normals, (c_hi + c_lo) normalized in f32 — planet_tpu's own device step
computes them so (planet_tpu/engine/device_step.py:254-258), and
jax.numpy's result on the same words is the port's bit for bit — where
PlanetEngine normalizes the f64 corners. The camera-relative corners are
bitwise equal on both paths, and the tiles do not decide it: the last test
re-tessellates PlanetEngine's leaves with each path's inputs to show it.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planet_tpu_torch.engine import device_step
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import PlanetEngine
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.geom import quadid as tq
from planet_tpu_torch.lod import refine as lod_refine
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.raster import coverage as cov
from planet_tpu_torch.tess import mesh, vertex
from torch_scenes import assert_golden_counts, assert_golden_image

torch.set_num_threads(1)
GOLD = pathlib.Path(__file__).parent / "goldens"
CFG = EngineConfig()


def _camera(name):
    return cam_mod.Camera(position=np.load(GOLD / f"{name}_cam.npy"),
                          angles=np.load(GOLD / f"{name}_angles.npy"))


def _view_proj(cam):
    rot = cam_mod.camera_rotation(cam)
    pf = cam_mod.proj_factor_from_fovy(np.deg2rad(CFG.fovy_deg))
    proj = cam_mod.perspective_lh(pf, CFG.window_w / CFG.window_h,
                                  CFG.near_plane, CFG.far_plane)
    return (proj @ cam_mod.view_from_rotation(rot)).astype(np.float32)


@pytest.fixture(scope="module", params=["nearclip", "farclip"])
def scene(request):
    """The camera rendered to convergence by DeviceRenderer (every leaf
    generated in the first frame: gen_cap above the near-clip scene's 354
    leaves, so no leaf samples a wrong tile), and by PlanetEngine."""
    name = request.param
    cam = _camera(name)
    r = device_step.DeviceRenderer(CFG, CFG.window_w, CFG.window_h,
                                   device="cpu", cap=1024, render_cap=512,
                                   gen_cap=512)
    pool = r.init_pool()
    args = (*tdf.from_f64_np(cam.position), _view_proj(cam))
    frames, counters = [], []
    for _ in range(4):
        frames.append(r.render(pool, *args))
        counters.append(r.last_counters)
        if frames[-1].n_generated == 0:
            break
    eng = PlanetEngine(CFG, device="cpu")
    out, _, _ = eng.render(cam)
    return (name, frames, counters[-1], r.last_geometry, out,
            eng.last_counters, np.load(GOLD / f"{name}_meta.npy"))


def test_device_frame_meets_the_golden_bars(scene):
    name, frames, rc, _, _, _, _ = scene
    frame = frames[-1]
    assert frame.n_generated == 0 and len(frames) <= 4
    assert not frame.overflowed
    assert_golden_counts(name, frame.n_leaves, rc)
    assert_golden_image(name, frame.image.numpy(), frame.depth.numpy())


def test_live_triangles_against_planet_engine(scene):
    name, frames, rc, geom, out, host_rc, _ = scene
    n = frames[-1].n_leaves
    ids = tq.from_words(geom.leaf_lo[:n].numpy(), geom.leaf_hi[:n].numpy())
    np.testing.assert_array_equal(ids, out.leaf_ids)
    assert rc.n_huge == host_rc.n_huge
    assert rc.n_straddle == host_rc.n_straddle
    # the near-clip sliver (module docstring); nothing else differs
    assert int(rc.n_tris) == int(host_rc.n_tris) - (name == "nearclip")


def test_nearclip_sliver_follows_the_f32_corner_normals():
    """PlanetEngine's near-clip leaves and tiles, tessellated with its own
    camera-relative corners and each path's corner normals: the f64
    normals give PlanetEngine's live count, the device step's f32 normals
    (the same bits as planet_tpu's jax.numpy formula) one fewer."""
    cam = _camera("nearclip")
    eng = PlanetEngine(CFG, device="cpu")
    eng.render(cam)
    host_tris = eng.last_counters.n_tris
    res = lod_refine.refine(cam.position, CFG.max_lod, CFG.radius,
                            quality=CFG.lod_quality)
    rel = torch.as_tensor((res.corners - cam.position[None, None, :])
                          .astype(np.float32))
    ch, cl = (torch.as_tensor(a) for a in tdf.from_f64_np(res.corners))
    cam_hi, cam_lo = (torch.as_tensor(a)
                      for a in tdf.from_f64_np(cam.position))
    assert torch.equal(tdf.sub((ch, cl), (cam_hi, cam_lo))[0], rel)
    host_nrm = torch.as_tensor(
        lod_refine._normalize_rows(res.corners).astype(np.float32))
    s = ch + cl                               # device_step.py's normals
    dev_nrm = s / torch.linalg.vector_norm(s, dim=-1, keepdim=True)
    s_j = jnp.asarray(ch.numpy()) + jnp.asarray(cl.numpy())
    tpu_nrm = np.asarray(s_j / jnp.linalg.norm(s_j, axis=-1, keepdims=True))
    np.testing.assert_array_equal(dev_nrm.numpy(), tpu_nrm)
    tiles = eng.pool.tiles[[eng.pool.slot_of[int(q)] for q in res.ids]]
    n = len(res.ids)
    zero = torch.zeros(n, dtype=torch.int64)
    skirt = torch.as_tensor(np.array(
        [CFG.skirt_size_for_depth(d) for d in res.depths], np.float32))
    gm = mesh.grid_uv_skirt(CFG.patch_verts)[3]
    valid = torch.as_tensor(np.broadcast_to(gm[None], (n,) + gm.shape).copy())
    live = {}
    for tag, nrm in (("host", host_nrm), ("device", dev_nrm)):
        pv = vertex.tessellate_blend(rel, nrm, tiles, zero, zero, skirt,
                                     torch.as_tensor(_view_proj(cam)))
        _, ok, _ = cov.setup_t(pv.clip, pv.normal, valid, CFG.window_w,
                               CFG.window_h,
                               mesh.cell_triangle_mask(CFG.patch_verts),
                               far_w=CFG.far_plane)
        live[tag] = ok
    assert int(live["host"].sum()) == host_tris
    assert int(live["device"].sum()) == host_tris - 1
    assert int((live["host"] != live["device"]).sum()) == 1
