"""The port's stage bisection: build_geometry_step(stop_after=...) and the
renderers' stop_after, run eagerly on the CPU with the kernels' plain
versions, against the port's whole step and against planet_tpu's
build_device_render(stop_after=...).

* Each rung's outputs, counts and pool equal the whole step's
  intermediates and pool bit for bit, from one pool state, on two frames:
  "calm" (hits, generations, parent crops, nothing overflows) and "spill"
  (more generations than gen_cap: the leaves without a cached parent fail,
  which the whole step flags and a truncated step does not, as
  planet_tpu's early() does not).
* At the refine, cache, uniforms, tess and geometry rungs the port's
  truncated step agrees with planet_tpu's (use_pallas=False,
  interpret=True) at dryrun_multichip's sizes, from planet_tpu's dry-run
  camera and from one at 1.15 radii that overflows render_cap: n_leaves,
  the overflow flag, the zero image, and the pool's keys, ticks and
  render tick (after "cache" the ticks of the allocation alone: A1 skips
  its touch there, as planet_tpu's cache rung stops before it).
  planet_tpu's uniforms and tess rungs add their outputs' sums times 0.0
  to the zero image to keep those stages in the program; a padding row's
  normals and shade are NaN, so when the frame has padding rows its image
  is NaN where the port's is 0.
* The renderers: each rung's frame has a zero image and depth and the
  truncated counts; "full" is the default frame; a bad name raises.
* stage_times' ladder at its CPU size: every rung of both scenes, the same
  leaves on every rung, marginals that add up to the full rung (the
  "uniforms" rung's aside: its U1 is in no later rung, so the tess rung's
  marginal is taken over "generate").

The captured rungs against the eager step are a GPU test
(tests/test_torch_kernels_gpu.py::test_stop_after_rungs_captured_equal_eager).
"""

import numpy as np
import pytest
import torch

import torch_ranks
from planet_tpu.cache import device_pool as jdp
from planet_tpu.engine import device_step as jds
from planet_tpu.engine.config import EngineConfig as JConfig
from planet_tpu_torch import entry
from planet_tpu_torch.cache import device_pool as dp
from planet_tpu_torch.engine import device_step
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.tess import vertex
from planet_tpu_torch.raster import shade as shade_mod
from planet_tpu_torch.tools import stage_times

torch.set_num_threads(1)
W, H = 96, 72
CFG = EngineConfig(cache_capacity=256, generations_per_frame=6)
CAPS = dict(cap=512, render_cap=256, gen_cap=16, max_lod=5)
# camera distances in radii: frames rendered before the tested one
SCENES = {"calm": ((1.6, 1.3), 1.15), "spill": ((1.6,), 1.15)}


def _args(distance):
    return [torch.as_tensor(a)
            for a in torch_ranks.lod_camera_args(CFG, W, H, distance)]


def _clone(pool):
    return dp.PoolState(*(t.clone() for t in pool))


def _rows(pool):
    """The pool's state without its dump row."""
    cap = pool.capacity
    return dict(keys_lo=pool.keys_lo[:cap], keys_hi=pool.keys_hi[:cap],
                tick=pool.tick[:cap], tiles=pool.tiles[:cap], now=pool.now)


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _assert_pool(got, want, keys):
    got, want = _rows(got), _rows(want)
    for k in keys:
        assert _same(got[k], want[k]), k


@pytest.fixture(scope="module")
def scenes():
    """scene -> (pool before the tested frame, its camera, the whole step's
    Geometry and pool after it)."""
    roots = device_step.face_roots(CFG.radius, "cpu")
    step = device_step.build_geometry_step(CFG, device="cpu", **CAPS)
    out = {}
    for name, (before, at) in SCENES.items():
        pool = dp.init(CFG.cache_capacity, CFG.tile_dim, "cpu")
        for d in before:
            step(pool, *_args(d), *roots)
        start = _clone(pool)
        geom = step(pool, *_args(at), *roots)
        out[name] = (start, _args(at), geom, pool)
    return out


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("rung", device_step.STAGES)
def test_rung_equals_the_whole_steps_intermediates(scenes, scene, rung):
    start, args, full, full_pool = scenes[scene]
    step = device_step.build_geometry_step(CFG, device="cpu",
                                           stop_after=rung, **CAPS)
    pool = _clone(start)
    got = step(pool, *args, *device_step.face_roots(CFG.radius, "cpu"))
    n, n_gen, ovf = full.meta.tolist()
    assert n > 24 and n_gen > 0
    assert ovf == (scene == "spill")
    if rung == "geometry":
        assert isinstance(got, device_step.Geometry)
        for a, b in zip(got, full):
            for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
                assert _same(x, y)
        _assert_pool(pool, full_pool, _rows(pool))
        return
    assert isinstance(got, device_step.Truncated)
    # planet_tpu's early(): no generation counted, and the generation
    # spill's failure is not in the overflow flag
    assert got.meta.tolist() == [n, 0, 0]
    o = got.outputs
    if rung == "refine":
        for k in ("leaf_lo", "leaf_hi", "leaf_depth"):
            assert torch.equal(o[k], getattr(full, k)), k
        _assert_pool(pool, start, _rows(pool))
        return
    assert torch.equal(o["slot"], full.slot)
    if rung == "cache":
        gen, crop = o["generate"], o["crop"]
        assert int(gen.sum()) == n_gen and bool(crop.any())
        assert not bool((gen & crop).any())
        assert torch.equal(o["slot"][gen], o["target"][gen])
        _assert_pool(pool, full_pool, ("keys_lo", "keys_hi"))
        _assert_pool(pool, start, ("tiles", "now"))
        return
    # generate, uniforms, tess: stored and touched, no end of frame
    _assert_pool(pool, full_pool, ("keys_lo", "keys_hi", "tick", "tiles"))
    assert int(pool.now) == int(full_pool.now) - 1 == int(start.now)
    if rung == "generate":
        live = o["gen_slot"] < CFG.cache_capacity
        assert int(live.sum()) == n_gen
        assert _same(pool.tiles[o["gen_slot"][live].long()],
                     o["tiles"][live])
        return
    if rung == "uniforms":
        pv = vertex.tessellate_blend(
            o["corners_rel"], o["normals"], dp.gather(pool, o["slot"]),
            o["vx"], o["vy"], o["skirt"], args[2],
            grid=CFG.patch_verts + 2)
        shade = shade_mod.lambert(pv.normal)
    else:
        pv, shade = o["vertices"], o["vertex_shade"]
        assert _same(o["tiles"], full.tiles)
    for a, b in zip(pv, full.vertices):
        assert _same(a, b)
    assert _same(shade, full.vertex_shade)


# ------------------------------------------------------ against planet_tpu

TP_RUNGS = ("refine", "cache", "uniforms", "tess", "geometry")
TP_CAMERAS = {"dryrun": None, "near": 1.15}


def _tp_args(cfg, distance):
    if distance is None:
        return entry.dryrun_camera(cfg)
    return torch_ranks.lod_camera_args(cfg, entry.LOD_W, entry.LOD_H,
                                       distance)


@pytest.mark.parametrize("rung", TP_RUNGS)
def test_rung_agrees_with_planet_tpu(rung):
    cfg = EngineConfig(**entry.LOD_CFG)
    jcfg = JConfig(use_pallas=False, **entry.LOD_CFG)
    kw = dict(entry.LOD_RANK)
    jfn = jds.build_device_render(jcfg, entry.LOD_W, entry.LOD_H,
                                  interpret=True, stop_after=rung, **kw)
    tfn = device_step.build_device_render(cfg, entry.LOD_W, entry.LOD_H,
                                          device="cpu", stop_after=rung,
                                          **kw)
    seen = set()
    for name, distance in TP_CAMERAS.items():
        args = _tp_args(cfg, distance)
        jpool, jout = jfn(jdp.init(cfg.cache_capacity, cfg.tile_dim), *args)
        pool = dp.init(cfg.cache_capacity, cfg.tile_dim, "cpu")
        frame = tfn(pool, *args)
        if rung == "geometry":
            want = [int(np.asarray(m)) for m in jout[3]]
        else:
            want = [int(jout.n_leaves), int(jout.n_generated),
                    int(jout.overflowed)]
            image = np.asarray(jout.image)
            assert image.shape == (entry.LOD_H, entry.LOD_W)
            if (rung in ("uniforms", "tess")
                    and want[0] < kw["render_cap"]):
                # the keep-alive term sums the padding rows' NaN normals
                # and shades
                assert np.isnan(image).all()
            else:
                assert not image.any()
        assert [int(frame.n_leaves), int(frame.n_generated),
                int(frame.overflowed)] == want, name
        assert not frame.image.any() and not frame.depth.any()
        cap = cfg.cache_capacity
        for k in ("keys_lo", "keys_hi", "tick"):
            np.testing.assert_array_equal(getattr(pool, k)[:cap].numpy(),
                                          np.asarray(getattr(jpool, k)), k)
        assert int(pool.now) == int(jpool.now)
        seen.add((int(frame.n_leaves), bool(frame.overflowed)))
    # one camera fits render_cap, the other overflows it
    assert seen == {(6, False), (kw["render_cap"], True)}, seen


# -------------------------------------------------------------- renderers

def test_renderer_rungs_frames():
    kw = dict(device="cpu", **dict(CAPS, gen_cap=256, max_lod=4))
    args = _args(1.3)
    base = device_step.DeviceRenderer(CFG, W, H, **kw)
    want = base.render(base.init_pool(), *args)
    for rung in device_step.RUNGS:
        r = device_step.DeviceRenderer(CFG, W, H, stop_after=rung, **kw)
        frame = r.render(r.init_pool(), *args)
        frames = [frame]
        if rung in ("tess", "full"):
            frames.append(device_step.build_device_render(
                CFG, W, H, stop_after=rung, **kw)(r.init_pool(), *args))
        assert all(f.n_leaves == want.n_leaves > 24 for f in frames)
        assert want.n_generated > 0 and not want.overflowed
        if rung == "full":
            for f in frames:
                assert torch.equal(f.image, want.image)
                assert torch.equal(f.depth, want.depth)
            assert r.last_counters is not None
            continue
        gen = want.n_generated if rung == "geometry" else 0
        for f in frames:
            assert (int(f.n_generated), bool(f.overflowed)) == (gen, False)
            assert f.image.shape == f.depth.shape == (H, W)
            assert not f.image.any() and not f.depth.any()
        assert r.last_counters is None
        kind = (device_step.Geometry if rung == "geometry"
                else device_step.Truncated)
        assert isinstance(r.last_geometry, kind)
    u8 = device_step.DeviceRenderer(CFG, W, H, stop_after="tess",
                                    fetch="u8", preview=2, **kw)
    frame = u8.render(u8.init_pool(), *args)
    assert frame.image.dtype == torch.uint8 and not frame.image.any()
    assert frame.preview.shape == (H // 2, W // 2)
    for bad in ("raster", "geometry "):
        with pytest.raises(ValueError, match="stop_after"):
            device_step.DeviceRenderer(CFG, W, H, stop_after=bad, **kw)
    with pytest.raises(ValueError, match="stop_after"):
        device_step.build_geometry_step(CFG, device="cpu", stop_after="full")


def test_stage_ladder_at_its_cpu_size():
    report = stage_times.ladders("cpu", small=True, reps=1)
    assert report["card"] is None and report["unassigned_events"] is None
    for scene, rows in report["scenes"].items():
        assert [r["rung"] for r in rows] == list(device_step.RUNGS)
        leaves = [r["n_leaves"] for r in rows]
        assert all(x == leaves[0] for x in leaves), (scene, leaves)
        # the side rung ("uniforms": U1, in no later rung) apart, the
        # marginals add up to the full rung; the tess rung's is over
        # "generate"
        by = {r["rung"]: r for r in rows}
        assert sum(r["marginal_ms"] for r in rows
                   if r["rung"] not in stage_times.SIDE_RUNGS
                   ) == pytest.approx(rows[-1]["ms"])
        assert by["tess"]["base"] == "generate"
        assert by["tess"]["marginal_ms"] == pytest.approx(
            by["tess"]["ms"] - by["generate"]["ms"])
        assert by["uniforms"]["marginal_ms"] == pytest.approx(
            by["uniforms"]["ms"] - by["generate"]["ms"])
        assert all("kernels" not in r for r in rows)
    moving = {r["rung"]: r for r in report["scenes"]["moving-1080p"]}
    assert len(moving["full"]["n_leaves"]) == stage_times.SMALL[
        "orbit_frames"] - 1
    assert not any(moving["tess"]["n_generated"])
    lines = stage_times.table(report)
    assert len(lines) == 2 * (1 + len(device_step.RUNGS))
    assert all("host clock, CPU" in line for line in lines[::8])
