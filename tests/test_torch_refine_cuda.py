"""R1, the device refine kernel (planet_tpu_torch/csrc/refine.cu, wrapper
ops/kernels/refine_cuda.py), against its plain version
(lod/refine_device.refine_plain), and the premise it rests on.

On the CPU: the wrapper's metadata checks (CPU tensors, wrong dtypes,
shapes that do not fit), refine_device counting no launch, and
planet_tpu's `tight` premise: a plain run that evaluates each level over
[0, f_n) only and stops at an empty frontier (refine_plain(narrow=True),
what R1 does on the card) equals the full-width run bit for bit — leaf
ids, depths, DF corners, n_leaves and the overflow flag — on the 1080p
static camera, the 8 orbit cameras, an overflowing cap, quality 1.5 and
the 24 subtree roots with their depths and a dense camera (300 m above
the ridged surface at LOD quality 16), with both probes; the narrow run
gives planet_tpu's own laddered refine_device its leaf ids; and R1's
lane map: each lane's one octave of the probes' noise, folded in order
from its probe's fold lane, is ops/perlin.accumulate_octaves bit for bit
at the refine's five probes.

The DFS order: the rank rule the order kernel (csrc/order.cu) computes a
row's column by, written in numpy, gives torch's stable argsort's
permutation on random keys with ties and padding rows; its wrapper's
metadata checks.

Marked `gpu` (skipped without a card): R1 equals the plain version on the
same inputs on the card, bit for bit, on the same cases plus the oracle's
max_lod 18 LOD scenes (whose DFS-ordered ids are also the oracle's), R1
captured in a CUDA graph equals R1 run eagerly, and R1's bench-only
designs (refine_cuda.DESIGNS) equal the plain version. The order kernel
equals its plain version (refine_device.dfs_order_plain) bit for bit on
R1's leaves of every case (the dense camera's 3,177 leaves among them)
at render caps of 512 (past which the overflow is set) and the whole cap,
on the oracle's LOD scenes (whose ids it puts in the oracle's order), and
on leaf buffers of random ids with ties and non-zero rows past n; the
step's "refine" rung on the card equals R1's leaves through the plain
order."""

import numpy as np
import pytest
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.engine import device_step
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.geom import quadid as tq
from planet_tpu_torch.lod import refine_device as trd
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.ops.kernels import refine_cuda
from planet_tpu_torch.parallel import sharded_lod
from planet_tpu_torch.ops import perlin
from planet_tpu_torch.tools import kernel_times, r1_s1_parts, stage_times

torch.set_num_threads(1)
CFG = EngineConfig(window_w=1920, window_h=1080)
CAP = 4096                    # the fused frame's (build_geometry_step)
GOLD = "tests/goldens/"

# name -> (camera position, refine keywords, roots: "faces" | "subtrees")
CASES = {
    "static-1080p": (kernel_times.scene_camera(CFG).position, {}, "faces"),
    **{f"orbit-{i}": (cam.position, {}, "faces")
       for i, (_, cam) in enumerate(kernel_times.orbit_cameras(CFG))},
    "overflow-cap64": (kernel_times.scene_camera(CFG).position,
                       dict(cap=64), "faces"),
    "quality-1.5": (kernel_times.scene_camera(CFG).position,
                    dict(quality=1.5), "faces"),
    "subtree-roots": (kernel_times.scene_camera(CFG).position, {},
                      "subtrees"),
    # 300 m above the ridged surface at LOD quality 16: 3,177 leaves,
    # frontiers of up to 384 slots a level
    "dense": (r1_s1_parts.dense_camera(CFG),
              dict(quality=r1_s1_parts.DENSE_QUALITY), "faces"),
}


def _inputs(name, device):
    """(args, keywords) of refine_plain / refine_cuda for case `name`."""
    pos, kw, roots = CASES[name]
    cam = [torch.as_tensor(a, device=device) for a in tdf.from_f64_np(pos)]
    if roots == "faces":
        r = device_step.face_roots(CFG.radius, device)[:4]
        depth = None
    else:
        *r, depth = sharded_lod.subtree_roots(CFG.radius, device)
    kw = dict(dict(max_lod=CFG.max_lod, cap=CAP, radius=CFG.radius,
                   root_depth=depth), **kw)
    return (*cam, *r), kw


def _same(got, want):
    """Two results (tensors in the same order) equal bit for bit."""
    for a, b in zip(got, want):
        a, b = a.cpu(), b.cpu()
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


# ---------------------------------------------------------------- the CPU


def test_wrapper_raises_for_cpu_tensors():
    args, kw = _inputs("static-1080p", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        refine_cuda.refine_cuda(*args, probe="ridged6", **kw)


@pytest.mark.parametrize("which,bad", [
    (0, lambda t: t.double()),                  # cam_hi f64
    (2, lambda t: t.long()),                    # root_lo i64
    (4, lambda t: t.half()),                    # root_ch f16
    (1, lambda t: t[:2]),                       # cam_lo (2,)
    (3, lambda t: t[:5]),                       # root_hi (5,) of 6 roots
    (5, lambda t: t.reshape(6, 12)),            # root_cl (6, 12)
    (2, lambda t: t.reshape(2, 3)),             # root_lo not (R,)
])
def test_wrapper_raises_for_bad_metadata(which, bad):
    args, kw = _inputs("static-1080p", "cpu")
    args = list(args)
    args[which] = bad(args[which])
    with pytest.raises(ValueError, match="expected"):
        refine_cuda.refine_cuda(*args, **kw)


@pytest.mark.parametrize("kw", [dict(cap=5), dict(max_lod=-1),
                                dict(probe="fbm")])
def test_wrapper_raises_for_arguments_that_do_not_fit(kw):
    args, base = _inputs("static-1080p", "cpu")
    with pytest.raises(ValueError):
        refine_cuda.refine_cuda(*args, **dict(base, **kw))


def test_refine_device_on_the_cpu_counts_no_launch():
    args, kw = _inputs("static-1080p", "cpu")
    before = dict(_cuda.launches)
    res = trd.refine_device(*args, probe="ridged6", **kw)
    assert _cuda.launches == before
    assert int(res.n_leaves) > 6


@pytest.mark.parametrize("probe", trd.PROBES)
@pytest.mark.parametrize("name", list(CASES))
def test_narrow_plain_equals_full_width(name, probe):
    """planet_tpu's `tight` premise, the one R1 rests on: evaluating only
    [0, f_n) a level and stopping at an empty frontier changes no bit."""
    args, kw = _inputs(name, "cpu")
    full = trd.refine_plain(*args, probe=probe, **kw)
    narrow = trd.refine_plain(*args, probe=probe, narrow=True, **kw)
    _same(narrow, full)
    assert int(full[2]) > 6
    assert bool(full[3]) == (name == "overflow-cap64")


def test_narrow_plain_gives_planet_tpu_laddered_leaves():
    """planet_tpu's refine_device with its default `tight` ladder and the
    narrow plain run: the same leaf ids and depths in the same order (DF
    corners differ in the last bits: XLA:CPU contracts planet_tpu's to
    FMA, tests/test_torch_refine_device.py)."""
    from planet_tpu.lod import refine_device as jrd
    pos = CASES["static-1080p"][0]
    cam_hi, cam_lo = tdf.from_f64_np(pos)
    roots = [t.numpy() for t in device_step.face_roots(CFG.radius, "cpu")[:4]]
    want = jrd.refine_device(cam_hi, cam_lo, *roots, max_lod=CFG.max_lod,
                             cap=1024, radius=CFG.radius,
                             probe_fn_name="zero")
    args, kw = _inputs("static-1080p", "cpu")
    got = trd.refine_plain(*args, probe="zero", narrow=True,
                           **dict(kw, cap=1024))
    n = int(got[2])
    assert n == int(want.n_leaves) > 6
    for a, b in ((want.leaf_lo, got[0][0]), (want.leaf_hi, got[0][1]),
                 (want.leaf_depth, got[0][2])):
        np.testing.assert_array_equal(np.asarray(a)[:n], b[:n].numpy())


def test_lane_map():
    """R1's warp: lanes 0-29 hold each (probe, octave) once, in order;
    lanes 30 and 31 repeat probe 4's octaves 0 and 1; probe j folds from
    lane 6j."""
    lanes, folds = refine_cuda.lane_map()
    assert len(lanes) == 32
    assert lanes[:30] == [(j, o) for j in range(5) for o in range(6)]
    assert lanes[30:] == [(4, 0), (4, 1)]
    assert folds == [0, 6, 12, 18, 24]
    assert all(lanes[f] == (j, 0) for j, f in enumerate(folds))


def test_lane_octaves_folded_equal_accumulate_octaves():
    """The refine's five probes (a level's corners and normalized
    midpoints, on the 1080p static camera's leaves as a frontier, scaled
    by 1e-5): each lane's one octave of noise, computed apart, folded in
    octave order from its probe's fold lane (noise.cuh add_octave), equals
    ops/perlin.accumulate_octaves("ridged", 6) bit for bit, probe for
    probe."""
    args, kw = _inputs("static-1080p", "cpu")
    res = trd.refine_plain(*args, probe="ridged6", narrow=True, **kw)
    w = int(res[2])
    cor = res[1][:, :w]
    corners = (cor[:12].view(4, 3, w), cor[12:].view(4, 3, w))
    csum = tuple(((c[0] + c[1]) + c[2]) + c[3] for c in corners)
    mid = trd._df_normalize3(csum, trd._split_const(CFG.radius, args[0]))
    probes = tuple(torch.cat([c.transpose(0, 1), m[:, None]], dim=1)
                   for c, m in zip(corners, mid))        # (3, 5, w)
    sh = np.float32(trd._PROBE_SCALE)
    sl = np.float32(np.float64(trd._PROBE_SCALE) - np.float64(sh))
    xh, xl = perlin._df_scale(probes[0], probes[1], sh, sl)   # (3, 5, w)
    coords = [t for a in range(3) for t in (xh[a], xl[a])]
    parts = [tdf.int24_parts(h, l) for h, l in zip(coords[::2], coords[1::2])]
    perm, signs = perlin._tables("cpu")

    def octave(o):
        args = []
        for cell, frac64 in (tdf.shift_frac48(*p, o) for p in parts):
            args += [cell.long(), *perlin.frac_parts(frac64)]
        return perlin.noise3_core(perm, signs, *args)    # (5, w)

    lanes, folds = refine_cuda.lane_map()
    noise = {o: octave(o) for o in range(refine_cuda.PROBE_OCTAVES)}
    lane_vals = [noise[o][j] for j, o in lanes]            # each (w,)
    want = perlin.accumulate_octaves("ridged", 6, 2.0, np.float32(0.55),
                                     *coords)              # (5, w)
    for j, f in enumerate(folds):
        value = torch.zeros(w)
        weight = torch.ones(w)
        amp = np.float32(1.0)
        for k in range(refine_cuda.PROBE_OCTAVES):
            assert lanes[f + k] == (j, k)
            v = 1.0 - torch.abs(lane_vals[f + k])
            v = v * v
            value = value + (v * float(amp)) * weight
            weight = v
            amp = np.float32(amp * np.float32(0.55))
        assert torch.equal(value.view(torch.int32), want[j].view(torch.int32))


def _rank_rule(key, n):
    """The order kernel's column of each row (numpy): a live row (< n) goes
    after the live keys below its own and the equal live keys of lower
    rows, a padding row to its own index."""
    live = key[:n]
    below = (live[None, :] < live[:, None]).sum(1)
    ties = np.tril(live[None, :] == live[:, None], -1).sum(1)
    return np.concatenate([below + ties, np.arange(n, key.shape[0])])


@pytest.mark.parametrize("seed", range(4))
def test_rank_rule_is_the_stable_argsort(seed):
    """On random non-negative int64 keys drawn from a few values (so with
    ties), the rank rule's columns are the inverse of torch's stable
    argsort of the keys with the rows past n set to KEY_PAD."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 600))
    n = int(rng.integers(0, cap + 1))
    key = rng.integers(0, 2**57, 1 + cap // 8)[rng.integers(0, 1 + cap // 8,
                                                            cap)]
    rows = torch.arange(cap)
    padded = torch.where(rows < n, torch.from_numpy(key),
                         torch.full((cap,), trd.KEY_PAD))
    perm = torch.argsort(padded, stable=True).numpy()
    rank = _rank_rule(key, n)
    np.testing.assert_array_equal(perm[rank], np.arange(cap))


def _order_inputs(device, cap=64, n=40):
    """dfs_order's arguments on zero leaves of `cap` rows."""
    i32 = torch.int32
    return ([torch.zeros(cap, dtype=i32, device=device) for _ in range(3)]
            + [torch.zeros((12, cap), device=device) for _ in range(2)]
            + [torch.tensor(n, dtype=i32, device=device),
               torch.tensor(False, device=device)])


@pytest.mark.parametrize("which,bad,render_cap", [
    (None, None, 0),                            # render_cap below 1
    (None, None, 65),                           # render_cap past cap
    (0, lambda t: t.long(), 32),                # lo int64
    (3, lambda t: t.t().contiguous(), 32),      # corners (cap, 12)
    (5, lambda t: t[None], 32),                 # n (1,)
    (6, lambda t: t.int(), 32),                 # overflowed int32
])
def test_order_wrapper_raises_for_bad_metadata(which, bad, render_cap):
    args = _order_inputs("cpu")
    if which is not None:
        args[which] = bad(args[which])
    with pytest.raises(ValueError, match="expected"):
        refine_cuda.dfs_order_cuda(*args, render_cap)


def test_order_wrapper_raises_for_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        refine_cuda.dfs_order_cuda(*_order_inputs("cpu"), 32)


# ------------------------------------------------------------- the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("probe", trd.PROBES)
@pytest.mark.parametrize("name", list(CASES))
def test_r1_equals_plain(dev, name, probe):
    args, kw = _inputs(name, dev)
    want = trd.refine_plain(*args, probe=probe, **kw)
    before = _cuda.launches["refine"]
    got = refine_cuda.refine_cuda(*args, probe=probe, **kw)
    assert _cuda.launches["refine"] == before + kw["max_lod"] + 1
    _same(got, want)


@pytest.mark.gpu
def test_r1_equals_plain_on_the_oracle_lod_scenes(dev):
    """The LOD golden cameras at max_lod 18 (tests/test_lod.py:28-43): R1
    equals the plain version, and its leaves in DFS order are the
    oracle's ids."""
    cams = np.load(GOLD + "lod_cams.npy")
    counts = np.load(GOLD + "lod_leaf_counts.npy")
    all_ids = np.load(GOLD + "lod_leaf_ids.npy")
    roots = device_step.face_roots(CFG.radius, dev)[:4]
    offset = 0
    for cam, count in zip(cams, counts):
        c = [torch.as_tensor(a, device=dev) for a in tdf.from_f64_np(cam)]
        kw = dict(max_lod=18, cap=1024, radius=CFG.radius, probe="ridged6")
        want = trd.refine_plain(*c, *roots, **kw)
        got = refine_cuda.refine_cuda(*c, *roots, **kw)
        _same(got, want)
        n = int(got[2])
        lo, hi = got[0][0, :n], got[0][1, :n]
        order = torch.argsort(tq.words_dfs_key(lo, hi), stable=True)
        ids = tq.from_words(lo[order].cpu().numpy(), hi[order].cpu().numpy())
        np.testing.assert_array_equal(ids, all_ids[offset:offset + count])
        offset += count


@pytest.mark.gpu
@pytest.mark.parametrize("design", list(refine_cuda.DESIGNS))
@pytest.mark.parametrize("name", ["static-1080p", "dense", "overflow-cap64",
                                  "subtree-roots"])
def test_r1_designs_equal_plain(dev, name, design):
    """The bench-only designs of R1 (the level kernel, the same with its
    compaction a second kernel, the whole refine in one block) equal the
    plain version bit for bit; one C call a level, or one a refine."""
    args, kw = _inputs(name, dev)
    want = trd.refine_plain(*args, probe="ridged6", **kw)
    before = _cuda.launches["t_refine"]
    got = refine_cuda.refine_design(design, *args, probe="ridged6", **kw)
    calls = 1 if design == "one block" else kw["max_lod"] + 1
    assert _cuda.launches["t_refine"] == before + calls
    _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("probe", trd.PROBES)
def test_captured_r1_equals_eager(dev, probe):
    args, kw = _inputs("static-1080p", dev)
    want = refine_cuda.refine_cuda(*args, probe=probe, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with _cuda.captured() as tally, torch.cuda.graph(graph):
        got = refine_cuda.refine_cuda(*args, probe=probe, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert tally["refine"] == kw["max_lod"] + 1
    _same(got, want)


def _order_args(res):
    """dfs_order's arguments from a refine_cuda / refine_plain result."""
    l_int, l_cor, n, overflowed = res
    return (l_int[0], l_int[1], l_int[2], l_cor[:12], l_cor[12:], n,
            overflowed)


def _assert_order_equal(args, render_cap):
    before = _cuda.launches["order"]
    got = refine_cuda.dfs_order_cuda(*args, render_cap)
    assert _cuda.launches["order"] == before + 1
    want = trd.dfs_order_plain(*args, render_cap)
    _same(got, want)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("render_cap", [512, None])
@pytest.mark.parametrize("name", list(CASES))
def test_order_equals_plain(dev, name, render_cap):
    """The order kernel on R1's leaves equals the plain chain bit for bit,
    at render cap 512 (the fused frame's: the dense camera's 3,177 leaves
    overflow it) and at the whole cap (None)."""
    args, kw = _inputs(name, dev)
    res = refine_cuda.refine_cuda(*args, probe="ridged6", **kw)
    cap = kw["cap"]
    rc = cap if render_cap is None else min(render_cap, cap)
    got = _assert_order_equal(_order_args(res), rc)
    n = int(res[2])
    assert bool(got[6]) == (bool(res[3]) or n > rc)
    if name == "dense":
        assert n > 3000 and bool(got[6]) == (rc < n)


@pytest.mark.gpu
def test_order_equals_plain_on_the_oracle_lod_scenes(dev):
    """The LOD golden cameras at max_lod 18: the order kernel on R1's
    leaves equals the plain chain, and its ids are the oracle's."""
    cams = np.load(GOLD + "lod_cams.npy")
    counts = np.load(GOLD + "lod_leaf_counts.npy")
    all_ids = np.load(GOLD + "lod_leaf_ids.npy")
    roots = device_step.face_roots(CFG.radius, dev)[:4]
    offset = 0
    for cam, count in zip(cams, counts):
        c = [torch.as_tensor(a, device=dev) for a in tdf.from_f64_np(cam)]
        res = refine_cuda.refine_cuda(*c, *roots, max_lod=18, cap=1024,
                                      radius=CFG.radius, probe="ridged6")
        got = _assert_order_equal(_order_args(res), 1024)
        n = int(got[5])
        assert n == count
        ids = tq.from_words(got[0][:n].cpu().numpy(),
                            got[1][:n].cpu().numpy())
        np.testing.assert_array_equal(ids, all_ids[offset:offset + count])
        offset += count


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(6))
def test_order_equals_plain_on_random_leaves(dev, seed):
    """Leaf buffers of random ids drawn from a few (so with ties: equal
    keys keep their rows' order), random words in every row (past n too:
    the padding columns copy them), a random n (below 0 and past cap
    among them) and render cap, and either overflow flag."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 4097))
    render_cap = int(rng.integers(1, cap + 1))
    n = int(rng.integers(-2, cap + 3))
    pick = rng.integers(0, 1 + cap // 4, cap)
    words = rng.integers(-2**31, 2**31, (27, 1 + cap // 4))[:, pick]
    words[:, rng.random(cap) < 0.5] = rng.integers(-2**31, 2**31, (27, 1))
    t = torch.as_tensor(np.ascontiguousarray(words, np.int32), device=dev)
    args = (t[0], t[1], t[2], t[3:15].view(torch.float32),
            t[15:].view(torch.float32),
            torch.tensor(n, dtype=torch.int32, device=dev),
            torch.tensor(bool(seed % 2), device=dev))
    _assert_order_equal(args, render_cap)


@pytest.mark.gpu
def test_refine_rung_equals_r1_through_the_plain_order(dev):
    """The fused step's "refine" rung on the card (R1, then the order
    kernel) gives what R1's leaves through the plain chain give: the ids,
    depths and corners in DFS order and the early counts."""
    cfg = EngineConfig(window_w=1920, window_h=1080)
    args = stage_times.camera_args(cfg, kernel_times.scene_camera(cfg),
                                   1920, 1080)
    targs = [torch.as_tensor(a, device=dev) for a in args]
    roots = device_step.face_roots(cfg.radius, dev)
    step = device_step.build_geometry_step(cfg, device=dev,
                                           stop_after="refine")
    got = step(None, *targs, *roots)
    ref = trd.refine_device(*targs[:2], *roots[:4], max_lod=cfg.max_lod,
                            cap=4096, radius=cfg.radius, probe="ridged6",
                            root_depth=roots[4], quality=cfg.lod_quality,
                            transposed=True)
    want = trd.dfs_order_plain(*ref[:2], ref.leaf_depth,
                               ref.leaf_corners_hi, ref.leaf_corners_lo,
                               ref.n_leaves, ref.overflowed, 512)
    o = got.outputs
    _same((o["leaf_lo"], o["leaf_hi"], o["leaf_depth"],
           o["corners_hi"].permute(1, 2, 0).reshape(12, 512),
           o["corners_lo"].permute(1, 2, 0).reshape(12, 512)), want[:5])
    assert got.meta.tolist() == [int(want.n_leaves), 0,
                                 int(want.overflowed)]
    assert int(want.n_leaves) > 100
