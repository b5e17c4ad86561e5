"""The port's sharded streaming-LOD engine (planet_tpu_torch.parallel.
sharded_lod) on the CPU over gloo, one spawned process a rank
(tests/torch_ranks.py), against the single-device step from the same 24
depth-1 roots, and its pieces against planet_tpu
(tests/test_sharded_lod.py, ported).

Bars: the composited frame (1-D meshes of 2 and 4 ranks and a (2, 2)
("slice", "quads") mesh; zero probes at max_lod 4 and ridged6 probes at
max_lod 3) equal to the single-device frame bit for bit (image and
depth), the ranks' leaf sets disjoint with the single-device set as their
union, the summed counts equal, nothing overflowed; a second frame with
warm pools generates nothing and draws the same image. The camera sits at
1.15 radii, where the 24 subtrees refine to depth 4 (69 leaves; planet_tpu's
1.8 radii leaves every subtree a single leaf). Caps are per rank, chosen so
that no rank overflows (render_cap 64 against at most 51 leaves a rank).
"""

import numpy as np
import pytest
import torch

import torch_ranks
from planet_tpu.geom import quadid as jq
from planet_tpu.lod import refine_device as jrd
from planet_tpu.parallel import sharded_lod as jsl
from planet_tpu_torch.engine import device_step
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.geom import quadid as tq
from planet_tpu_torch.lod import refine_device as trd
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.parallel import sharded_lod

torch.set_num_threads(1)
W, H = 160, 120
CFG_KW = dict(cache_capacity=256)
CFG = EngineConfig(**CFG_KW)
RANK_CAPS = dict(cap=512, render_cap=64, gen_cap=64)
PROBES = {"zero": 4, "ridged6": 3}            # probe -> max_lod


ARGS = torch_ranks.lod_camera_args(CFG, W, H)
WORLDS = {
    2: {"n2_zero": dict(mesh=(2,), probe="zero"),
        "n2_ridged6": dict(mesh=(2,), probe="ridged6")},
    4: {"n4_zero": dict(mesh=(4,), probe="zero", frames=2),
        "n4_ridged6": dict(mesh=(4,), probe="ridged6"),
        "mesh22_zero": dict(mesh=(2, 2), probe="zero")},
}
CASES = {name: (world, case) for world, cases in WORLDS.items()
         for name, case in cases.items()}


def _ids(lo, hi):
    return set(int(q) for q in tq.from_words(np.asarray(lo), np.asarray(hi)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks render their cases; returns name -> (world,
    directory)."""
    out = {}
    for world, cases in WORLDS.items():
        d = tmp_path_factory.mktemp(f"lod{world}")
        spec = dict(cfg=CFG_KW, width=W, height=H, caps=RANK_CAPS, cases={
            name: dict(mesh=c["mesh"], probe=c["probe"],
                       max_lod=PROBES[c["probe"]],
                       frames=[ARGS] * c.get("frames", 1))
            for name, c in cases.items()})
        torch_ranks.spawn(torch_ranks.lod_worker, world, d, spec)
        out.update({name: (world, d) for name in cases})
    return out


@pytest.fixture(scope="module")
def single():
    """probe -> (DeviceFrame, leaf ids, packed framebuffer) of the
    single-device step from all 24 roots."""
    roots = sharded_lod.subtree_roots(CFG.radius, "cpu")
    out = {}
    for probe, max_lod in PROBES.items():
        r = device_step.DeviceRenderer(
            CFG, W, H, device="cpu", roots=roots, cap=1024, render_cap=512,
            gen_cap=512, max_lod=max_lod, probe=probe)
        frame = r.render(r.init_pool(), *ARGS)
        g = r.last_geometry
        (packed, *_), _ = device_step.raster_packed(g, CFG, W, H)
        out[probe] = (frame, _ids(g.leaf_lo[:frame.n_leaves],
                                  g.leaf_hi[:frame.n_leaves]), packed)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_composite_equals_single_device(runs, single, name):
    world, d = runs[name]
    frame, want_ids, _ = single[CASES[name][1]["probe"]]
    assert not frame.overflowed and frame.n_generated == frame.n_leaves > 24

    def load(key, rank):
        return torch_ranks.load(d, f"{name}.f0", key, rank)
    counts = [load("counts", r) for r in range(world)]
    # the shard index of each rank, in rank order (slice-major on 2-D)
    assert [int(c[5]) for c in counts] == list(range(world))
    got = set()
    for r in range(world):
        part = _ids(load("q_lo", r), load("q_hi", r))
        assert not got & part, "the ranks' leaf sets must be disjoint"
        got |= part
        n, n_gen, t_n, t_gen, ovf, _ = counts[r]
        assert (t_n, t_gen, ovf) == (frame.n_leaves, frame.n_generated, 0)
        assert len(part) == n and n <= RANK_CAPS["render_cap"]
        # the composite reached every rank
        np.testing.assert_array_equal(load("image", r), frame.image.numpy())
        np.testing.assert_array_equal(load("depth", r), frame.depth.numpy())
    assert got == want_ids
    assert sum(int(c[1]) for c in counts) == frame.n_generated
    assert np.isfinite(frame.depth.numpy()).mean() > 0.5


def test_second_frame_with_warm_pools_generates_nothing(runs, single):
    world, d = runs["n4_zero"]
    frame = single["zero"][0]
    for r in range(world):
        c = torch_ranks.load(d, "n4_zero.f1", "counts", r)
        assert c[1] == 0 and c[3] == 0 and c[2] == frame.n_leaves
        np.testing.assert_array_equal(
            torch_ranks.load(d, "n4_zero.f1", "image", r),
            torch_ranks.load(d, "n4_zero.f0", "image", r))


@pytest.mark.parametrize("probe", list(PROBES))
def test_ranks_in_turn_fold_to_the_single_device_frame(single, probe):
    """Four ranks' shares run one after another in this process, each
    with its own pool: the elementwise min of their packed framebuffers
    is the single-device framebuffer."""
    roots = sharded_lod.subtree_roots(CFG.radius, "cpu")
    fold, n_total = None, 0
    for rank in range(4):
        r = device_step.DeviceRenderer(
            CFG, W, H, device="cpu", roots=sharded_lod.local_roots(
                roots, rank, 4), max_lod=PROBES[probe], probe=probe,
            **RANK_CAPS)
        geom = r.geometry(r.init_pool(), *ARGS)
        (packed, n, _, ovf, _, _), _ = device_step.raster_packed(
            geom, CFG, W, H)
        assert not ovf
        n_total += n
        fold = packed if fold is None else torch.minimum(fold, packed)
    frame, _, want = single[probe]
    assert n_total == frame.n_leaves
    assert torch.equal(fold, want)


def test_dynamic_face_roots_equal_the_static_step():
    """The renderer's default roots are the six faces at depth 0: given as
    host arrays they draw the default frame bit for bit. From the 24
    subtree roots the step keeps the faces' leaves, except that a face the
    faces' refine leaves whole comes back as its four children."""
    kw = dict(device="cpu", cap=512, render_cap=256, gen_cap=256,
              max_lod=4, probe="ridged6")
    faces = device_step.DeviceRenderer(CFG, W, H, **kw)
    given = device_step.build_device_render(
        CFG, W, H, roots=[r.numpy() for r in
                          device_step.face_roots(CFG.radius, "cpu")], **kw)
    a = faces.render(faces.init_pool(), *ARGS)
    b = given(faces.init_pool(), *ARGS)
    assert (a.n_leaves, a.n_generated) == (b.n_leaves, b.n_generated)
    assert torch.equal(a.image, b.image) and torch.equal(a.depth, b.depth)
    sub = device_step.DeviceRenderer(
        CFG, W, H, roots=sharded_lod.subtree_roots(CFG.radius, "cpu"), **kw)
    c = sub.render(sub.init_pool(), *ARGS)
    assert not (a.overflowed or c.overflowed)
    g, h = faces.last_geometry, sub.last_geometry
    want = _ids(g.leaf_lo[:a.n_leaves], g.leaf_hi[:a.n_leaves])
    whole = {q for q in want if tq.depth_of(np.uint64(q)) == 0}
    want = (want - whole) | {int(tq.make_child(np.uint64(q), k))
                             for q in whole for k in range(4)}
    assert 0 < len(whole) < 6
    assert _ids(h.leaf_lo[:c.n_leaves], h.leaf_hi[:c.n_leaves]) == want
    with pytest.raises(ValueError, match="exact"):
        splat = EngineConfig(raster_mode="splat")
        r = device_step.DeviceRenderer(splat, W, H, **kw)
        device_step.raster_packed(r.geometry(r.init_pool(), *ARGS), splat,
                                  W, H)


def test_subtree_roots_are_planet_tpus():
    lo, hi, ch, cl, depth = sharded_lod.subtree_roots(CFG.radius, "cpu")
    jlo, jhi, jch, jcl, jdepth = jsl.subtree_roots(CFG.radius)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(depth.numpy(), np.asarray(jdepth))
    ids = tq.from_words(lo.numpy(), hi.numpy())
    assert len(set(int(q) for q in ids)) == 24
    assert all(int(tq.depth_of(np.uint64(q))) == 1 for q in ids)
    p = ch.numpy().astype(np.float64) + cl.numpy().astype(np.float64)
    np.testing.assert_allclose(np.linalg.norm(p, axis=-1), CFG.radius,
                               rtol=1e-8)
    # planet_tpu's corners come from its jitted subdivision, which XLA:CPU
    # contracts to FMA (planet_tpu/nums/df.py:104-112)
    jp = np.asarray(jch, np.float64) + np.asarray(jcl, np.float64)
    np.testing.assert_allclose(p, jp, rtol=1e-8, atol=1e-8 * CFG.radius)


def test_refine_from_subtree_roots_matches_planet_tpu():
    """refine_device from the 24 depth-1 roots with their depths, against
    planet_tpu's refine_device(..., root_depth=...) on the same roots:
    the same leaves in the same order; the depth-1 roots set the lod term
    (with depth 0 the split threshold differs and so do the leaves)."""
    roots = sharded_lod.subtree_roots(CFG.radius, "cpu")
    cam = np.array([0.2, -0.3, -1.0]) / np.linalg.norm([0.2, -0.3, -1.0])
    cam_t = tdf.from_f64_np(cam * CFG.radius * 1.05)
    got = trd.refine_device(*(torch.from_numpy(c) for c in cam_t), *roots[:4],
                            max_lod=6, cap=1024, radius=CFG.radius,
                            probe="zero", root_depth=roots[4])
    want = jrd.refine_device(*cam_t, *(r.numpy() for r in roots[:4]),
                             max_lod=6, cap=1024, radius=CFG.radius,
                             probe_fn_name="zero",
                             root_depth=roots[4].numpy(), tight=())
    n = int(got.n_leaves)
    assert not bool(got.overflowed) and int(want.n_leaves) == n > 24
    for a, b in ((want.leaf_lo, got.leaf_lo), (want.leaf_hi, got.leaf_hi),
                 (want.leaf_depth, got.leaf_depth)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ids = tq.from_words(got.leaf_lo[:n].numpy(), got.leaf_hi[:n].numpy())
    np.testing.assert_array_equal(got.leaf_depth[:n].numpy(),
                                  [int(jq.depth_of(q)) for q in ids])
    depth0 = trd.refine_device(*(torch.from_numpy(c) for c in cam_t),
                               *roots[:4], max_lod=6, cap=1024,
                               radius=CFG.radius, probe="zero")
    assert int(depth0.n_leaves) != n or not torch.equal(
        depth0.leaf_lo, got.leaf_lo)


def test_pool_from_planet_tpu_takes_each_ranks_block():
    n, cap, dim = 4, 16, 8
    stacked = {k: np.asarray(v) for k, v in
               jsl.init_pools(n, cap, dim)._asdict().items()}
    rng = np.random.default_rng(4)
    for k in ("keys_lo", "keys_hi", "tick"):
        stacked[k] = rng.integers(-2**31, 2**31, stacked[k].shape,
                                  dtype=np.int64).astype(np.int32)
    stacked["tiles"] = rng.standard_normal(stacked["tiles"].shape).astype(
        np.float32)
    stacked["now"] = np.arange(n, dtype=np.int32) + 7
    for rank in range(n):
        pool = sharded_lod.pool_from_planet_tpu(stacked, n, rank, "cpu")
        assert pool.capacity == cap
        rows = slice(rank * cap, (rank + 1) * cap)
        for k in ("keys_lo", "keys_hi", "tick", "tiles"):
            t = getattr(pool, k)
            np.testing.assert_array_equal(t[:cap].numpy(), stacked[k][rows])
            assert not t[cap].any(), f"{k}: the dump row must start empty"
        assert int(pool.now) == 7 + rank
    with pytest.raises(ValueError):
        sharded_lod.pool_from_planet_tpu(stacked, 3, 0, "cpu")
