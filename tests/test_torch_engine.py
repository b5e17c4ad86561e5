"""The port's host-orchestrated frame (planet_tpu_torch.engine.planet,
plain versions on the CPU) against planet_tpu's PlanetEngine on its XLA
path, from the far camera of the LOD goldens (3R out).

* cold and warm frames: the same leaf ids, depths, stats and cache index;
  pool tiles within the tile bar of tests/test_torch_tiles.py (heights over
  the amplitude within rtol = atol = 2e-6);
* the state carried across: TilePool.from_state of the warm planet_tpu pool,
  then the next frame in both packages — vertices at the bars of
  tests/test_tess.py:116-146, and a 160x120 render at the raster bars of
  tests/test_raster_exact.py:243-288;
* the zero-budget parent-crop frame and LRU eviction, against planet_tpu's
  TilePool driven with the same leaf lists.
"""

import numpy as np
import pytest
import torch

from planet_tpu.cache.tile_pool import TilePool as JTilePool
from planet_tpu.engine.config import EngineConfig as JEngineConfig
from planet_tpu.engine.planet import PlanetEngine as JEngine
from planet_tpu.geom import quadid
from planet_tpu.raster.shade import lambert as jlambert
from planet_tpu_torch.cache.tile_pool import TilePool
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import PlanetEngine
from planet_tpu_torch.geom import camera as cam_mod

torch.set_num_threads(1)
GOLD = "tests/goldens/"
CFG = EngineConfig()
JCFG = JEngineConfig(use_pallas=False)     # planet_tpu's XLA noise path
AMP = np.float32(CFG.amplitude)
EMPTY = 2**31 - 1
W, H = 160, 120


def g(name):
    return np.load(GOLD + name + ".npy")


def _camera(pos, angles=(0.0, 0.0, 0.0)):
    return cam_mod.Camera(position=np.asarray(pos, np.float64),
                          angles=np.asarray(angles, np.float32))


FAR = g("lod_cams")[2]
# the far camera pitched straight at the planet centre (LOD depends on the
# position only, so the leaf set is the unpitched frames')
VIEW = _camera(FAR, (np.pi / 2, 0.0, 0.0))


def _jax_pool_state(pool):
    return {"slot_of": pool.slot_of, "id_of": pool.id_of,
            "tick_of": pool.tick_of, "occupied": pool.occupied,
            "free": np.asarray(pool._free, np.int64),
            "render_tick": pool.render_tick,
            "tiles": np.asarray(pool.tiles)}


def _packed(image, depth):
    """(image, depth) -> packed (depth << 10 | shade) keys, EMPTY where
    nothing was drawn (tests/test_raster_exact.packed_from_images)."""
    image, depth = np.asarray(image), np.asarray(depth)
    empty = ~np.isfinite(depth)
    zq = np.clip((np.where(empty, -1.0, depth) * 0.5 + 0.5) * (2**21 - 1),
                 0, 2**21 - 1).astype(np.int64)
    sq = np.round(image * 1023).astype(np.int64)
    return np.where(empty, EMPTY, (zq << 10) | sq)


def _assert_raster_bars(got, want):
    cov_eq = (got == EMPTY) == (want == EMPTY)
    assert cov_eq.mean() > 0.999, cov_eq.mean()
    both = (got != EMPTY) & (want != EMPTY)
    assert both.mean() > 0.1, "the view must show the planet"
    assert np.abs((got[both] >> 10) - (want[both] >> 10)).max() <= 1
    assert np.abs((got[both] & 1023) - (want[both] & 1023)).max() <= 1


@pytest.fixture(scope="module")
def runs():
    cam = _camera(FAR)
    jeng = JEngine(JCFG)
    j1 = jeng.frame(cam)
    jtiles1 = np.asarray(jeng.pool.tiles)
    j2 = jeng.frame(cam)
    state = _jax_pool_state(jeng.pool)       # warm, after two frames
    j3, jimg, jdep = jeng.render(VIEW, W, H)

    teng = PlanetEngine(CFG, device="cpu")
    t1 = teng.frame(cam)
    ttiles1 = teng.pool.tiles.numpy().copy()
    t2 = teng.frame(cam)
    t3, timg, tdep = teng.render(VIEW, W, H)

    carried = PlanetEngine(CFG, device="cpu",
                           pool=TilePool.from_state(state, device="cpu"))
    c3, cimg, cdep = carried.render(VIEW, W, H)
    return dict(jeng=jeng, j=(j1, j2, j3), jtiles1=jtiles1,
                jimage=_packed(jimg, jdep), teng=teng, t=(t1, t2, t3),
                ttiles1=ttiles1, timage=_packed(timg, tdep),
                carried=carried, c3=c3, cimage=_packed(cimg, cdep))


def test_cold_and_warm_frames_match_jax(runs):
    for jf, tf in zip(runs["j"], runs["t"]):
        np.testing.assert_array_equal(tf.leaf_ids, jf.leaf_ids)
        np.testing.assert_array_equal(tf.leaf_depths, jf.leaf_depths)
        assert tf.n_leaves == jf.n_leaves
        for k in ("tris", "quads", "tiles_generated", "texels_generated"):
            assert getattr(tf.stats, k) == getattr(jf.stats, k), k
    t1 = runs["t"][0]
    assert t1.n_leaves == g("lod_leaf_counts")[2]
    assert t1.stats.tiles_generated == t1.n_leaves      # cold: soft budget
    assert runs["t"][1].stats.tiles_generated == 0      # warm: all hits
    jp, tp = runs["jeng"].pool, runs["teng"].pool
    assert tp.slot_of == jp.slot_of
    np.testing.assert_array_equal(tp.tick_of, jp.tick_of)
    np.testing.assert_array_equal(tp.occupied, jp.occupied)
    assert tp.render_tick == jp.render_tick == 3


def test_pool_tiles_match_jax(runs):
    occ = runs["jeng"].pool.occupied
    assert occ.sum() == runs["t"][0].n_leaves
    np.testing.assert_allclose(runs["ttiles1"][occ] / AMP,
                               runs["jtiles1"][occ] / AMP,
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(runs["ttiles1"][~occ], 0.0)


def test_carried_state_vertices_at_tess_bars(runs):
    """Same tiles in both packages (the carried pool): the port's vertex
    program against planet_tpu's on the render frame."""
    jf, cf = runs["j"][2], runs["c3"]
    n = cf.n_leaves
    assert cf.stats.tiles_generated == 0
    jv = {k: np.asarray(getattr(jf.vertices, k))[:n]
          for k in ("height", "world", "normal", "clip")}
    cv = {k: getattr(cf.vertices, k).numpy() for k in jv}
    np.testing.assert_allclose(cv["height"], jv["height"], rtol=1e-5,
                               atol=1e-2)
    scale = max(np.abs(jv["world"]).max(), 1.0)
    assert np.abs(cv["world"] - jv["world"]).max() / scale < 1e-5
    np.testing.assert_allclose(cv["normal"], jv["normal"], rtol=0, atol=5e-4)
    cscale = np.maximum(np.abs(jv["clip"]), np.abs(jv["clip"]).max() * 1e-3)
    assert np.max(np.abs(cv["clip"] - jv["clip"]) / cscale) < 2e-4
    np.testing.assert_allclose(cf.vertex_shade.numpy(),
                               np.asarray(jlambert(jv["normal"])),
                               rtol=0, atol=5e-4)
    assert runs["carried"].pool.render_tick == runs["jeng"].pool.render_tick


@pytest.mark.parametrize("which", ["carried", "own_tiles"])
def test_render_matches_jax_at_raster_bars(runs, which):
    got = runs["cimage"] if which == "carried" else runs["timage"]
    _assert_raster_bars(got, runs["jimage"])


def test_from_state_copies_the_index():
    jpool = JTilePool(capacity=8, dim=4)
    ids = np.array([int(quadid.from_path(f, [])) for f in range(5)],
                   np.uint64)
    jpool.resolve(ids, budget=10)
    jpool.store(np.arange(5), np.arange(80, dtype=np.float32).reshape(5, 4, 4))
    jpool.end_frame()
    pool = TilePool.from_state(_jax_pool_state(jpool), device="cpu")
    assert pool.slot_of == jpool.slot_of and pool.render_tick == 1
    assert pool._free == jpool._free
    np.testing.assert_array_equal(pool.tiles.numpy(), np.asarray(jpool.tiles))
    more = np.array([int(quadid.from_path(5, [c])) for c in range(4)],
                    np.uint64)
    rj, rt = jpool.resolve(more, budget=10), pool.resolve(more, budget=10)
    np.testing.assert_array_equal(rt.slot, rj.slot)
    with pytest.raises(ValueError):
        TilePool.from_state({**_jax_pool_state(jpool),
                             "tiles": np.zeros((8, 4, 5))}, device="cpu")


def test_zero_budget_uses_parent_crop():
    """tests/test_engine.py's scenario: a cold far frame fills the cache,
    a closer camera splits quads, and with a zero budget the children crop
    their parents' tiles. planet_tpu's TilePool, driven with the same leaf
    lists, must end in the same state and make the same plan."""
    cfg = EngineConfig(generations_per_frame=0)
    eng = PlanetEngine(cfg, device="cpu")
    jpool = JTilePool(capacity=cfg.cache_capacity, dim=cfg.tile_dim)
    f1 = eng.frame(_camera(FAR))
    f2 = eng.frame(_camera(FAR * 0.55))
    assert f2.n_leaves > f1.n_leaves
    for f in (f1, f2):
        jpool.resolve(f.leaf_ids, 0)
        jpool.end_frame()
    assert eng.pool.slot_of == jpool.slot_of
    np.testing.assert_array_equal(eng.pool.tick_of, jpool.tick_of)
    assert np.isfinite(f2.vertices.world.numpy()).all()

    rt = eng.pool.resolve(f2.leaf_ids, budget=0)
    rj = jpool.resolve(f2.leaf_ids, budget=0)
    for k in ("slot", "rect_lo", "rect_hi", "pixel_size", "variant_x",
              "variant_y", "generate_mask"):
        np.testing.assert_array_equal(getattr(rt, k), getattr(rj, k), k)
    assert rt.generated == rj.generated
    # leaves whose parent is cached and who are missing themselves crop it
    # with the reference rect constants (main.cpp:216-237)
    dim, crops = cfg.tile_dim, 0
    for i, qid in enumerate(f2.leaf_ids):
        qid = np.uint64(qid)
        if int(qid) in eng.pool.slot_of or quadid.depth_of(qid) == 0:
            continue
        if int(quadid.parent_of(qid)) not in eng.pool.slot_of:
            continue
        crops += 1
        child = int(quadid.child_index_of(qid))
        assert rt.variant_x[i] == 1 + (child & 1)
        assert rt.variant_y[i] == 1 + ((child >> 1) & 1)
        x0 = 1.5 if child in (0, 2) else dim / 2 + 0.5
        y0 = 1.5 if child in (0, 1) else dim / 2 + 0.5
        np.testing.assert_allclose(rt.rect_lo[i], [x0 / dim, y0 / dim])
        np.testing.assert_allclose(rt.pixel_size[i],
                                   ((dim / 2 - 1) / (dim - 3)) / dim)
    assert crops > 0


def test_lru_eviction_when_full():
    ids = [int(quadid.from_path(0, [c])) for c in range(4)]
    ids += [int(quadid.from_path(1, [c])) for c in range(2)]
    pool, jpool = TilePool(capacity=4, dim=8, device="cpu"), \
        JTilePool(capacity=4, dim=8)
    for sel in (ids[:4], ids[2:4], ids[4:6]):
        rt = pool.resolve(np.array(sel, np.uint64), budget=10)
        rj = jpool.resolve(np.array(sel, np.uint64), budget=10)
        np.testing.assert_array_equal(rt.slot, rj.slot)
        np.testing.assert_array_equal(rt.generate_mask, rj.generate_mask)
        pool.end_frame()
        jpool.end_frame()
    assert ids[0] not in pool.slot_of and ids[1] not in pool.slot_of
    assert ids[2] in pool.slot_of and ids[3] in pool.slot_of
    assert pool.slot_of == jpool.slot_of


def test_store_writes_in_place():
    pool = TilePool(capacity=4, dim=2, device="cpu")
    buf = pool.tiles
    pool.store(np.array([2, 0]), torch.ones((2, 2, 2)))
    assert pool.tiles is buf
    np.testing.assert_array_equal(buf[:, 0, 0].numpy(), [1, 0, 1, 0])
