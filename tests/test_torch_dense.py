"""The dense mountain-valley view (the benchmark's lod-1080p-q16
configuration, perfbench/configs/lod-1080p-q16.json, under its dense
traffic, perfbench/traffic/dense.json), on the CPU with the kernels' plain
versions.

* The traffic's camera is tools/kernel_times.dense_camera, bit for bit,
  whatever the seed, and the plain refine there draws 3,177 leaves at
  LOD quality 16 on every frame of the turn.
* DeviceInteractiveEngine's frame from the empty pool at that camera,
  at the configuration's caps and cache, against the benchmark's plain
  reference (perfbench/reference/lod.frame), compared as the benchmark
  compares them (perfbench/drivers/lod.compare) within the
  configuration's limits.
"""

import json
import pathlib

import numpy as np
import torch

from perfbench.drivers import lod as drv
from perfbench.harness import traffic
from perfbench.reference import lod as ref_lod
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.geom.camera import Camera
from planet_tpu_torch.io.driver import DeviceInteractiveEngine
from planet_tpu_torch.lod import refine
from planet_tpu_torch.tools import kernel_times

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
CONF = json.loads((ROOT / "perfbench/configs/lod-1080p-q16.json")
                  .read_text())
DENSE = json.loads((ROOT / "perfbench/traffic/dense.json").read_text())
FIELDS = EngineConfig.__dataclass_fields__
CFG = EngineConfig(**{k: v for k, v in CONF["settings"].items()
                      if k in FIELDS})
W, H = 64, 36
# a turn of the look-around is 242 frames: frames a third of a turn apart
YAW_FRAMES = (0, 81, 161)


def test_dense_traffic_is_the_dense_camera_with_3177_leaves():
    """Every frame of dense.json's path is at kernel_times.dense_camera
    bit for bit (three seeds, one past 32 bits; frames 0-241, a turn),
    its yaw turning; the plain refine (lod/refine.refine) at the
    configuration's quality, 16, gives 3,177 leaves there, down to
    max_lod, at three yaws a third of a turn apart. No cut: the refine
    alone, at full size."""
    want = kernel_times.dense_camera(CFG)
    assert CFG.lod_quality == kernel_times.DENSE_QUALITY == 16.0
    for seed in (7, 0, 2**33 + 5):
        pos, ang = traffic.make(DENSE, seed, CFG.radius).frames(0, 242)
        assert (pos == want).all(), seed
        assert np.ptp(ang[:, 1]) > 6.0 and (ang[:, 0] == np.float32(0.35)) \
            .all()
    path = traffic.make(DENSE, 7, CFG.radius)
    yaws = set()
    for k in YAW_FRAMES:
        pos, ang = path.at(k)
        yaws.add(float(ang[1]))
        r = refine.refine(pos, CFG.max_lod, CFG.radius,
                          quality=CFG.lod_quality)
        assert len(r.ids) == 3177, k
        assert int(r.depths.max()) == CFG.max_lod
    assert len(yaws) == len(YAW_FRAMES)


def test_dense_frame_from_the_empty_pool_equals_the_reference():
    """The first frame of the dense path (seed 7) from the empty pool
    through DeviceInteractiveEngine at the configuration's cap,
    render_cap and cache (4,096 each) equals the plain reference's within
    lod-1080p-q16.json's limits: leaf rows, tiles, clip-space vertices,
    image, depth and the pool's bookkeeping. Cut to run in under a minute
    on one thread: a 64 x 36 window, LOD quality 10 (2,055 leaves, down to
    max_lod 18) and gen_cap 2,304, the least multiple of 256 that holds
    those leaves' generations (the plain tile generation runs over every
    gen_cap slot, ~9 ms a slot here); so the frame draws more than 1,024
    leaves over more than 512 rows, past lod-1080p's cache and render
    cap."""
    cfg = EngineConfig(**{**vars(CFG), "window_w": W, "window_h": H,
                          "lod_quality": 10.0})
    caps = {**{k: v for k, v in CONF["engine"].items() if k != "preview"},
            "gen_cap": 2304}
    assert caps["cap"] == caps["render_cap"] == cfg.cache_capacity == 4096
    pos, ang = traffic.make(DENSE, 7, cfg.radius).at(0)
    eng = DeviceInteractiveEngine(cfg, W, H, device="cpu", **caps)
    out, image, depth = eng.render(Camera(pos, ang))
    g = eng.renderer.last_geometry
    n = int(g.meta[0])
    assert n == 2055 and out.stats.quads == n
    assert int(g.meta[1]) == n and not bool(g.meta[2])
    assert not bool(eng.renderer.last_counters.overflowed)
    assert g.vertices.clip.shape[0] == caps["render_cap"]
    kept = dict(n=g.meta[0], leaf_lo=g.leaf_lo, leaf_hi=g.leaf_hi,
                leaf_depth=g.leaf_depth, tiles=g.tiles, clip=g.vertices.clip,
                image=image, depth=depth,
                after=ref_lod.PoolBook(eng.pool.keys_lo, eng.pool.keys_hi,
                                       eng.pool.tick, eng.pool.now))
    ref = ref_lod.frame(ref_lod.engine_config(vars(cfg)), W, H, caps, pos,
                        ang, None, "cpu")
    assert ref.n_leaves == n and not ref.overflowed
    got = drv.compare(kept, ref)
    assert got.keys() == CONF["limits"].keys()
    for name, value in got.items():
        assert value <= CONF["limits"][name], (name, value)
    assert int(torch.isfinite(depth).sum()) > W * H // 2
