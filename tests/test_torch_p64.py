"""BASELINE config 3's patch size on the fused frame, on the CPU: 64-vertex
patches (a 66 x 66 grid with its skirt ring) over 66 x 66 tiles, through
DeviceInteractiveEngine with the kernels' plain versions.

* The frame from the flight's first camera (the benchmark's flight traffic,
  perfbench/traffic/flight.json) at a small window and caps, against the
  benchmark's plain reference at any patch size
  (perfbench/reference/lod_grid.frame), compared as the benchmark compares
  them (perfbench/drivers/lod.compare): leaf rows, tiles, clip-space
  vertices, image, depth and the pool's bookkeeping, each within the
  lod-1080p-p64 configuration's limit.
* The skirts: every live leaf's skirt ring hangs the reference's skirt
  for its depth below its edge, from the largest skirt at 63 quads
  (EngineConfig.max_skirt_size of the 64-vertex patch), on every side.
* V1's wide instance's band table: along the 66-row grid the y taps of
  every variant are nondecreasing, so a band's first and last rows bound
  the tile rows it reads, and those fit its staging (BAND_TEX rows); the
  wrappers take grid 66 with 66 x 66 tiles in the rows mode alone.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from perfbench.drivers import lod as drv
from perfbench.harness import traffic
from perfbench.reference import lod_grid
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.geom.camera import Camera
from planet_tpu_torch.io.driver import DeviceInteractiveEngine
from planet_tpu_torch.tess import vertex
from planet_tpu_torch.tess import vertex_cuda

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
W, H = 64, 36
# config 3's widths; a quarter of the reference's split threshold and
# small caps keep the plain frame a few seconds on the CPU
CFG = EngineConfig(patch_verts=64, tile_dim=66, cache_capacity=512,
                   lod_quality=0.25, window_w=W, window_h=H)
CAPS = dict(cap=256, render_cap=96, gen_cap=96)
# edges as (corner a, corner b) and their vertices from a to b: the
# interior row or column, and the skirt ring's beside it
EDGES = {(0, 1): (np.s_[1, 1:-1], np.s_[0, 1:-1]),
         (2, 3): (np.s_[-2, 1:-1], np.s_[-1, 1:-1]),
         (0, 2): (np.s_[1:-1, 1], np.s_[1:-1, 0]),
         (1, 3): (np.s_[1:-1, -2], np.s_[1:-1, -1])}


@pytest.fixture(scope="module")
def frame():
    params = json.loads((ROOT / "perfbench/traffic/flight.json").read_text())
    pos, ang = traffic.make(params, 0, CFG.radius).at(0)
    eng = DeviceInteractiveEngine(CFG, W, H, device="cpu", **CAPS)
    _, image, depth = eng.render(Camera(pos, ang))
    return eng, pos, ang, image, depth


def test_frame_equals_the_reference_at_64_vertex_patches(frame):
    eng, pos, ang, image, depth = frame
    g = eng.renderer.last_geometry
    n = int(g.meta[0])
    assert n > 40 and not bool(g.meta[2])
    assert g.vertices.clip.shape == (CAPS["render_cap"], 66, 66, 4)
    assert g.tiles.shape == (CAPS["render_cap"], 66, 66)
    kept = dict(n=g.meta[0], leaf_lo=g.leaf_lo, leaf_hi=g.leaf_hi,
                leaf_depth=g.leaf_depth, tiles=g.tiles, clip=g.vertices.clip,
                image=image, depth=depth,
                after=lod_grid.PoolBook(eng.pool.keys_lo, eng.pool.keys_hi,
                                        eng.pool.tick, eng.pool.now))
    ref = lod_grid.frame(lod_grid.engine_config(vars(CFG)), W, H, CAPS, pos,
                         ang, None, "cpu")
    limits = json.loads((ROOT / "perfbench/configs/lod-1080p-p64.json")
                        .read_text())["limits"]
    got = drv.compare(kept, ref)
    assert got.keys() == limits.keys()
    for name, value in got.items():
        assert value <= limits[name], (name, value)
    assert int(torch.isfinite(depth).sum()) > W * H // 4


def test_skirts_hang_the_reference_rule_at_63_quads(frame):
    """Each live leaf's skirt ring stands below its edge by the reference's
    skirt for the leaf's depth (main.cpp:500, 674-677), from the largest
    skirt at 63 quads, on all four sides."""
    eng = frame[0]
    g = eng.renderer.last_geometry
    n = int(g.meta[0])
    assert CFG.patch_quads == 63
    height = g.vertices.height[:n].double().numpy()
    for q in range(n):
        want = CFG.skirt_size_for_depth(int(g.leaf_depth[q]))
        for edge, skirt in EDGES.values():
            drop = height[q][edge] - height[q][skirt]
            np.testing.assert_allclose(drop, want, rtol=1e-6, atol=2e-3)


def test_wide_band_reads_the_tile_rows_it_stages():
    idx, _ = vertex.blend_taps(vertex_cuda.WIDE_DIM, vertex_cuda.WIDE_GRID - 2)
    g = vertex_cuda.WIDE_GRID
    band = -(-g // vertex_cuda.WIDE_PARTS)
    assert (np.diff(idx, axis=2) >= 0).all()
    for var in range(3):
        for r0 in range(0, g, band):
            r1 = min(g, r0 + band)
            lo, hi = idx[var, :, r0, 0].min(), idx[var, :, r1 - 1, 1].max()
            assert lo == idx[var, :, r0:r1].min()
            assert hi == idx[var, :, r0:r1].max()
            assert hi - lo + 1 <= vertex_cuda.BAND_TEX, (var, r0)


def test_wrappers_take_the_wide_grid_in_the_rows_mode_alone():
    assert vertex_cuda._check_grid(32, 32, rows=True) == "tess"
    assert vertex_cuda._check_grid(66, 66, rows=True) == "tess_wide"
    for grid, dim, rows in ((66, 66, False), (66, 32, True), (64, 64, True),
                            (33, 32, True)):
        with pytest.raises(ValueError, match="at most 32"):
            vertex_cuda._check_grid(grid, dim, rows=rows)
