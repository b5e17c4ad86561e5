"""The port's fused device frame (planet_tpu_torch.engine.device_step, run
eagerly on the CPU with the kernels' plain versions) against the oracle's
golden frame, the port's PR-1 engine (PlanetEngine) and the port's host
tile pool (tests/test_golden_frame_device.py and tests/test_device_step.py,
ported). None of these needs an XLA compile, so they stay in the fast
tier.

* golden frame: DeviceRenderer converges in <= 4 frames and meets the bars
  of tests/test_golden_frame_device.py:60-80, leaf count == the oracle's;
* the same converged camera through PlanetEngine: identical leaf ids,
  tiles within 1e-5 relative (heights over max(|h|, 0.1 * amplitude), the
  tiles32 bar: the engine scales corners in f64 on the host, the device
  step in double-float), coverage agreement > 0.999;
* budget audit over a 5-camera orbit: per-frame generated counts equal
  the host TilePool's;
* pipelined output equals sequential output; fetch="u8" equals
  io/png.write_png's quantization bit for bit;
* the uniforms (U1's plain version, uniforms_cuda.uniforms_plain) against
  planet_tpu's (engine/device_step.py:245-263) on the rows of
  torch_scenes.CACHE_CASES, with the crops of their cache stage, and on
  one with every depth 0-29: the variants and the camera-relative corners
  bitwise; the skirt bitwise max_skirt / 2^depth below depth 2 (an exact
  division), and so planet_tpu's where its exp2 is exact (XLA:CPU's exp2
  of the integers 13, 15, 17, ... is off by up to 15 ulps on one host:
  within 2^-19 there); the normals NaN in the same places (the padding
  rows' 0 / 0) and elsewhere within 2^-22 of planet_tpu's. The sum under
  the root is planet_tpu's, (x x + y y) + z z; the root is not: the port
  rounds it correctly (nums.fp.sqrt_rn), and XLA:CPU's root inside
  jnp.linalg.norm's fusion is off by an ulp or more on some hosts (3 ulps
  of the normal at worst on 2.4 M seeded components on one).
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenes
from planet_tpu.geom import quadid as jq
from planet_tpu.nums import df as jdfm
from planet_tpu_torch.cache import device_pool as tdp
from planet_tpu_torch.cache import device_pool_cuda as dpc
from planet_tpu_torch.cache.tile_pool import TilePool
from planet_tpu_torch.engine import device_step
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import PlanetEngine
from planet_tpu_torch.geom import camera as cam_mod
from planet_tpu_torch.geom import quadid as tq
from planet_tpu_torch.lod import refine as lod_refine
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.tess import uniforms_cuda
from tests.test_golden_frame import _ssim

torch.set_num_threads(1)
GOLD = pathlib.Path(__file__).parent / "goldens"
W, H = 128, 96
SMOOTH = EngineConfig(window_w=W, window_h=H, amplitude=0.0,
                      cache_capacity=512)


def _view_proj(cfg, cam, width, height):
    rot = cam_mod.camera_rotation(cam)
    pf = cam_mod.proj_factor_from_fovy(np.deg2rad(cfg.fovy_deg))
    proj = cam_mod.perspective_lh(pf, width / height, cfg.near_plane,
                                  cfg.far_plane)
    return (proj @ cam_mod.view_from_rotation(rot)).astype(np.float32)


def _args(cfg, cam, width, height):
    cam_hi, cam_lo = tdf.from_f64_np(cam.position)
    return cam_hi, cam_lo, _view_proj(cfg, cam, width, height)


@pytest.fixture(scope="module")
def golden():
    """The golden camera rendered to convergence by DeviceRenderer, and by
    PlanetEngine."""
    cfg = EngineConfig()
    cam = cam_mod.Camera(position=np.load(GOLD / "frame_cam.npy"),
                         angles=np.load(GOLD / "frame_angles.npy"))
    r = device_step.DeviceRenderer(cfg, cfg.window_w, cfg.window_h,
                                   device="cpu", cap=1024, render_cap=512,
                                   gen_cap=128)
    pool = r.init_pool()
    frames = []
    for _ in range(4):
        frames.append(r.render(pool, *_args(cfg, cam, cfg.window_w,
                                            cfg.window_h)))
        if frames[-1].n_generated == 0:
            break
    eng = PlanetEngine(cfg, device="cpu")
    out, image, depth = eng.render(cam)
    return frames, r.last_geometry, (eng, out, image.numpy(), depth.numpy())


def test_golden_frame_converges_at_the_bars(golden):
    frames, _, _ = golden
    frame = frames[-1]
    meta = np.load(GOLD / "frame_meta.npy")
    assert frame.n_generated == 0 and len(frames) <= 4
    assert not frame.overflowed
    assert frame.n_leaves == int(meta[0])
    image, depth = frame.image.numpy(), frame.depth.numpy()
    gold_img = np.load(GOLD / "frame_image.npy")
    gold_dep = np.load(GOLD / "frame_depth.npy")
    cov, gcov = np.isfinite(depth), np.isfinite(gold_dep)
    assert (cov == gcov).mean() > 0.999, (cov == gcov).mean()
    both = cov & gcov
    ds = np.abs(image[both] - gold_img[both])
    assert np.quantile(ds, 0.99) <= 2.5 / 1023, np.quantile(ds, 0.99)
    assert ds.mean() < 1.0 / 1023, ds.mean()
    dd = np.abs(depth[both] - gold_dep[both])
    assert np.quantile(dd, 0.99) < 1e-5, np.quantile(dd, 0.99)
    assert _ssim(image, gold_img) > 0.99


def test_matches_host_engine_on_the_converged_camera(golden):
    frames, geom, (eng, out, image, depth) = golden
    n = frames[-1].n_leaves
    ids = tq.from_words(geom.leaf_lo[:n].numpy(), geom.leaf_hi[:n].numpy())
    np.testing.assert_array_equal(ids, out.leaf_ids)
    np.testing.assert_array_equal(geom.leaf_depth[:n].numpy(),
                                  out.leaf_depths)
    want = eng.pool.tiles[[eng.pool.slot_of[int(q)] for q in ids]].numpy()
    got = geom.tiles[:n].numpy()
    amp = EngineConfig().amplitude
    rel = np.abs(got - want) / np.maximum(np.abs(want), 0.1 * amp)
    assert float(rel.max()) <= 1e-5, float(rel.max())
    agree = (np.isfinite(frames[-1].depth.numpy())
             == np.isfinite(depth)).mean()
    assert agree > 0.999, agree


def test_generation_budget_matches_host_pool_over_orbit():
    """tests/test_device_step.py:85-129: with a budget below the per-frame
    miss count, the device pool's closed-form first-K-misses policy
    regenerates exactly as many tiles per frame as the host pool's
    sequential policy (main.cpp:191-278)."""
    budget, max_lod = 16, 6
    cfg = dataclasses.replace(SMOOTH, generations_per_frame=budget)
    render = device_step.build_device_render(
        cfg, W, H, device="cpu", cap=1024, gen_cap=256, render_cap=256,
        max_lod=max_lod, probe="zero")
    pool = tdp.init(cfg.cache_capacity, cfg.tile_dim, "cpu")
    host = TilePool(capacity=cfg.cache_capacity, dim=cfg.tile_dim,
                    device="cpu")
    zero = lambda p: np.zeros(p.shape[:-1], np.float32)  # noqa: E731
    host_counts, dev_counts = [], []
    for t in np.linspace(0.0, 0.10, 5):
        cam = cam_mod.Camera(
            position=1.05 * cfg.radius * np.array([np.sin(t), 0.0,
                                                   -np.cos(t)]),
            angles=np.array([np.pi / 2, 0.0, 0.0], np.float32))
        leaves = lod_refine.refine(cam.position, max_lod, cfg.radius,
                                   height_fn=zero)
        host_counts.append(int(host.resolve(leaves.ids, budget).generated))
        host.end_frame()
        frame = render(pool, *_args(cfg, cam, W, H))
        assert frame.n_leaves == len(leaves.ids)
        dev_counts.append(frame.n_generated)
    assert host_counts == dev_counts, (host_counts, dev_counts)
    assert dev_counts[0] > budget
    assert 0 < min(dev_counts[1:]) and max(dev_counts[1:]) <= budget


def _smooth_cams(ts, dist=2.2):
    return [cam_mod.Camera(
        position=dist * SMOOTH.radius * np.array([np.sin(t), 0.0,
                                                  -np.cos(t)]),
        angles=np.array([np.pi / 2, 0.0, 0.0], np.float32)) for t in ts]


KW = dict(device="cpu", cap=1024, gen_cap=128, render_cap=128, max_lod=4,
          probe="zero")


def test_pipelined_renderer_matches_sequential():
    args = [_args(SMOOTH, c, W, H) for c in _smooth_cams((0.0, 0.01, 0.02))]
    r = device_step.DeviceRenderer(SMOOTH, W, H, **KW)
    pool = r.init_pool()
    seq = [r.render(pool, *a).image.numpy().copy() for a in args]

    pipe = device_step.PipelinedRenderer(r, r.init_pool())
    got = [out[0] for out in (pipe.submit(*a) for a in args)
           if out is not None]
    got.append(pipe.flush()[0])
    assert pipe.flush() is None
    assert len(got) == len(seq)
    for a, b in zip(got, seq):
        np.testing.assert_array_equal(a, b)
    # the smooth sphere from 2.2 R: a lit disc on a black background
    assert (seq[0] > 0).mean() > 0.3 and (seq[0] == 0).mean() > 0.1


def test_u8_fetch_matches_png_quantization():
    cam = _smooth_cams((0.1,))[0]
    a = _args(SMOOTH, cam, W, H)
    f32 = device_step.DeviceRenderer(SMOOTH, W, H, **KW)
    u8 = device_step.DeviceRenderer(SMOOTH, W, H, fetch="u8", preview=2,
                                    **KW)
    img = f32.render(f32.init_pool(), *a).image.numpy()
    frame = u8.render(u8.init_pool(), *a)
    want = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    assert frame.image.dtype == torch.uint8
    np.testing.assert_array_equal(frame.image.numpy(), want)
    np.testing.assert_array_equal(frame.preview.numpy(), want[::2, ::2])


def _tp_uniforms(c, crop):
    """planet_tpu's uniforms (engine/device_step.py:245-263)."""
    q_lo, q_hi, depth = (jnp.asarray(c[k]) for k in ("q_lo", "q_hi",
                                                       "depth"))
    rows = q_lo.shape[0]
    c_hi, c_lo = (jnp.transpose(jnp.asarray(c[k]).reshape(4, 3, rows),
                                (2, 0, 1))
                  for k in ("corners_hi", "corners_lo"))
    child = jq.words_child_index(q_lo, q_hi)
    vx = jnp.where(crop, 1 + (child & 1), 0).astype(jnp.int32)
    vy = jnp.where(crop, 1 + ((child >> 1) & 1), 0).astype(jnp.int32)
    rel = jdfm.sub(jdfm.DF(c_hi, c_lo),
                   jdfm.DF(jnp.broadcast_to(c["cam_hi"], c_hi.shape),
                           jnp.broadcast_to(c["cam_lo"], c_lo.shape)))
    nrm = c_hi + c_lo
    normals = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    d1 = depth - 1
    skirt = jnp.where(d1 > 0, np.float32(c["max_skirt"])
                      / jnp.exp2(d1.astype(jnp.float32) + 1.0),
                      np.float32(c["max_skirt"]))
    return dict(corners_rel=rel.hi, normals=normals, vx=vx, vy=vy,
                skirt=skirt)


@pytest.mark.parametrize("case", list(torch_scenes.CACHE_CASES)
                         + ["depths"])
def test_uniforms_equal_planet_tpu(case):
    c = torch_scenes.cache_case("budget" if case == "depths" else case)
    if case == "depths":
        c["depth"] = (np.arange(len(c["depth"])) % 30).astype(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(c[k]))
            for k in ("q_lo", "q_hi", "depth", "corners_hi", "corners_lo")]
    crop = dpc.cache_stage_plain(
        tdp.PoolState.from_state(c["state"], "cpu"), *args,
        torch.tensor(c["n"], dtype=torch.int32),
        **{k: c[k] for k in ("budget", "gen_cap", "max_lod",
                             "coord_scale")}).crop
    q_lo, q_hi, depth, c_hi, c_lo = args
    got = uniforms_cuda.uniforms_plain(
        q_lo, q_hi, crop, depth, c_hi, c_lo, torch.from_numpy(c["cam_hi"]),
        torch.from_numpy(c["cam_lo"]), c["max_skirt"])
    want = _tp_uniforms(c, jnp.asarray(crop.numpy()))
    for k in ("vx", "vy", "corners_rel"):
        np.testing.assert_array_equal(
            getattr(got, k).numpy().view(np.int32),
            np.asarray(want[k]).view(np.int32), err_msg=k)
    d1 = c["depth"].astype(np.float64) - 1
    top = np.float32(c["max_skirt"])
    exact = np.where(d1 > 0, top / 2.0 ** (d1 + 1), top).astype(np.float32)
    np.testing.assert_array_equal(got.skirt.numpy().view(np.int32),
                                  exact.view(np.int32))
    w = np.asarray(want["skirt"])
    xla_exact = np.asarray(jnp.exp2(jnp.asarray(d1 + 1, jnp.float32))) \
        == 2.0 ** (d1 + 1)
    np.testing.assert_array_equal(w[xla_exact], exact[xla_exact])
    assert np.all(np.abs(w - exact) <= exact * 2.0**-19)
    g, w = got.normals.numpy(), np.asarray(want["normals"])
    padding = np.arange(len(g)) >= c["n"]
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    assert np.isnan(g[padding]).all() and np.isfinite(g[~padding]).all()
    assert np.abs(g[~padding] - w[~padding]).max(initial=0.0) <= 2.0**-22
    assert bool(crop.any()) == (case in ("budget", "pressure",
                                         "spill_parent", "spill_orphan",
                                         "depths"))
