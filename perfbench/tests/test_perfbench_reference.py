"""The plain reference (perfbench/reference) against the port, run
eagerly on the CPU at a small window and a small field: the LOD frame's
leaf rows, sampled tiles, vertices, image, depth and pool bookkeeping,
from the empty pool and from the pool a path left; the tiles of cached
quads from their ids; the field's heights and shade. The reference
imports nothing of the port."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.drivers import lod as lod_driver
from perfbench.harness import traffic
from perfbench.reference import field as ref_field
from perfbench.reference import lod as ref_lod

W, H = 96, 54
CAPS = {"cap": 1024, "render_cap": 512, "gen_cap": 256}
FLIGHT = {"generator": "camera_path",
          "orbit": {"latitude_sin": 0.6, "theta_step": 0.01},
          "altitude": {"high": 20000.0, "low": 3000.0, "period": 8},
          "pitch": 0.35, "yaw_follows_orbit": True, "rotate": True,
          "random_phase": True}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_engine():
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.io.driver import DeviceInteractiveEngine
    return DeviceInteractiveEngine(EngineConfig(window_w=W, window_h=H), W,
                                   H, device="cpu", **CAPS)


def _book(pool):
    return ref_lod.PoolBook(*(t.clone() for t in (
        pool.keys_lo, pool.keys_hi, pool.tick, pool.now)))


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_lod_frames_equal_the_port(seed):
    from planet_tpu_torch.geom.camera import Camera
    eng = _port_engine()
    rcfg = ref_lod.engine_config({"window_w": W, "window_h": H})
    path = traffic.make(FLIGHT, seed, rcfg.radius)
    for k in range(4):
        book = _book(eng.pool) if k else None
        pos, ang = path.at(k)
        _, image, depth = eng.render(Camera(pos, ang))
        g = eng.renderer.last_geometry
        kept = dict(book=book, n=g.meta[0], leaf_lo=g.leaf_lo,
                    leaf_hi=g.leaf_hi, leaf_depth=g.leaf_depth,
                    tiles=g.tiles, clip=g.vertices.clip, image=image,
                    depth=depth, after=_book(eng.pool))
        ref = ref_lod.frame(rcfg, W, H, CAPS, pos, ang, book, "cpu")
        got = lod_driver.compare(kept, ref)
        assert all(v == 0 for v in got.values()), (k, got)
        assert ref.n_leaves > 100


def test_key_tiles_are_the_generated_tiles():
    from planet_tpu_torch.geom.camera import Camera
    eng = _port_engine()
    rcfg = ref_lod.engine_config({"window_w": W, "window_h": H})
    pos, ang = traffic.make(FLIGHT, 9, rcfg.radius).at(0)
    eng.render(Camera(pos, ang))
    pool = eng.pool
    used = torch.nonzero(pool.keys_hi[:-1] < 0).flatten()[:64]
    tiles = ref_lod.key_tiles(rcfg, pool.keys_lo[used], pool.keys_hi[used])
    assert torch.equal(tiles, pool.tiles[used])


def test_field_equals_the_port():
    from planet_tpu_torch.models import heightfield
    kw = dict(kind="ridged", octaves=6, lacunarity=2.0, gain=0.55,
              coord_scale=0.00001, amplitude=8848.0)
    h, s = heightfield.frame_cube(128, 6.0e6, fused=True, device="cpu", **kw)
    rh, rs = ref_field.field(128, 6.0e6, kw, "cpu")
    assert torch.equal(h, rh) and torch.equal(s, rs)


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import perfbench.reference.lod, perfbench.reference.field;"
            "import perfbench.harness.roofline;"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('planet_tpu') or "
            "m.split('.')[0] in ('jax', 'jaxlib')))")
    import os
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code, root],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_frame_rows_match_the_frame():
    rcfg = ref_lod.engine_config({"window_w": W, "window_h": H})
    pos, ang = traffic.make(FLIGHT, 4, rcfg.radius).at(2)
    n, rows, normals = ref_lod.frame_rows(rcfg, W, H, CAPS, pos, ang, "cpu")
    ref = ref_lod.frame(rcfg, W, H, CAPS, pos, ang, None, "cpu")
    assert n == ref.n_leaves and rows == CAPS["render_cap"]
    assert normals.shape == (n, 4, 3)
    assert np.allclose((normals ** 2).sum(-1).numpy(), 1.0, atol=1e-6)
