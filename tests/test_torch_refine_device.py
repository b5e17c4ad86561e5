"""The port's device refiner (planet_tpu_torch.lod.refine_device, eager on
the CPU, K4's plain version for the ridged probes) against planet_tpu's
refine_device, the port's host refiner and the oracle's LOD goldens
(tests/test_refine_device.py and tests/test_lod.py, ported).

Leaf ids are held exactly. Corners are held at 1e-9 relative to the host
refiner's f64 corners (tests/test_refine_device.py:46-51), not to
planet_tpu's: its jitted refiner runs its double-float arithmetic on
XLA:CPU, which contracts it to FMA (planet_tpu/nums/df.py:104-112)."""

import numpy as np
import pytest
import torch

from planet_tpu.geom import quadid as jq
from planet_tpu.lod import refine_device as jrd
from planet_tpu_torch.geom import cubesphere
from planet_tpu_torch.geom import quadid as tq
from planet_tpu_torch.lod import refine as host
from planet_tpu_torch.lod import refine_device as trd
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.ops import perlin
from planet_tpu_torch.ops.kernels import perlin_cuda

torch.set_num_threads(1)
RADIUS = 6371000.0
GOLD = "tests/goldens/"


def _roots():
    corners = cubesphere.root_corners(RADIUS)
    ids = np.array([jq.make_root(f) for f in range(6)], np.uint64)
    lo, hi = jq.to_words(ids)
    ch, cl = tdf.from_f64_np(corners)
    return lo, hi, ch, cl


def _refine(cam, **kw):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (*tdf.from_f64_np(cam), *_roots())]
    return trd.refine_device(*t, radius=RADIUS, **kw)


def _ids(res):
    n = int(res.n_leaves)
    return tq.from_words(res.leaf_lo[:n].numpy(), res.leaf_hi[:n].numpy())


def _zero(p):
    return np.zeros(p.shape[:-1], np.float32)


def _ridged6_height_fn(p):
    """Host probe heights through the port's K4 plain version, so the host
    and device refiners see identical heights and the test isolates the
    split geometry (tests/test_refine_device.py:54-69)."""
    hi, lo = tdf.from_f64_np(np.asarray(p, np.float64))
    sh = np.float32(1e-5)
    sl = np.float32(np.float64(1e-5) - np.float64(sh))
    xh, xl = perlin._df_scale(torch.from_numpy(hi), torch.from_numpy(lo),
                              sh, sl)
    h = perlin_cuda.noise_df("ridged", xh[..., 0], xl[..., 0], xh[..., 1],
                             xl[..., 1], xh[..., 2], xl[..., 2], octaves=6,
                             gain=0.55)
    return h.numpy() * np.float32(8848.0)


@pytest.mark.parametrize("dist", [2.5, 1.05])
def test_zero_probes_match_planet_tpu_and_host(dist):
    cam = np.array([0.0, 0.0, -dist * RADIUS])
    max_lod = 6
    got = _refine(cam, max_lod=max_lod, cap=1024, probe="zero")
    assert not bool(got.overflowed)
    n = int(got.n_leaves)

    cam_hi, cam_lo = tdf.from_f64_np(cam)
    want = jrd.refine_device(cam_hi, cam_lo, *_roots(), max_lod=max_lod,
                             cap=1024, radius=RADIUS, probe_fn_name="zero",
                             tight=())
    assert int(want.n_leaves) == n
    # the same leaves in the same (level) order, ids and depths bitwise
    for a, b in ((want.leaf_lo, got.leaf_lo), (want.leaf_hi, got.leaf_hi),
                 (want.leaf_depth, got.leaf_depth)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ids = _ids(got)
    np.testing.assert_array_equal(
        got.leaf_depth[:n].numpy(), [int(jq.depth_of(q)) for q in ids])

    ref = host.refine(cam, max_lod, RADIUS, height_fn=_zero)
    assert set(int(q) for q in ids) == set(int(q) for q in ref.ids)
    # corners: within 1e-9 of the host's f64 corners (planet_tpu's jitted
    # corners are FMA-contracted on XLA:CPU, ~5e-8 relative, and are not
    # held to this bar beyond the roots)
    by_id = {int(q): c for q, c in zip(ref.ids, ref.corners)}
    corners = (got.leaf_corners_hi[:n].numpy().astype(np.float64)
               + got.leaf_corners_lo[:n].numpy().astype(np.float64))
    for i, q in enumerate(ids):
        want_c = by_id[int(q)]
        err = np.max(np.abs(corners[i] - want_c)
                     / np.maximum(np.abs(want_c), 1.0))
        assert err < 1e-9, (i, err)


def test_ridged_probes_match_host_over_orbit():
    """tests/test_refine_device.py:72-103: DF split decisions give the host
    refiner's exact leaf sets over an orbit of real-terrain cameras."""
    angles = np.linspace(0.0, 2 * np.pi, 4, endpoint=False)
    for ang, alt in zip(angles, [30e3, 300e3, 3000e3, 120.0]):
        cdir = np.array([np.cos(ang), 0.31 * np.sin(2 * ang), np.sin(ang)])
        cam = cdir / np.linalg.norm(cdir) * (RADIUS + alt)
        want = host.refine(cam, 7, RADIUS, height_fn=_ridged6_height_fn)
        got = _refine(cam, max_lod=7, cap=2048, probe="ridged6")
        assert not bool(got.overflowed)
        got_ids = set(int(q) for q in _ids(got))
        want_ids = set(int(q) for q in want.ids)
        assert got_ids == want_ids, (alt, len(got_ids ^ want_ids))


def test_matches_oracle_leaf_ids_at_max_lod_18():
    """Every LOD golden camera at max_lod 18 (tests/test_lod.py:28-43): the
    device leaves, in DFS order, are the oracle's leaf ids exactly."""
    cams = np.load(GOLD + "lod_cams.npy")
    counts = np.load(GOLD + "lod_leaf_counts.npy")
    all_ids = np.load(GOLD + "lod_leaf_ids.npy")
    offset = 0
    for cam, count in zip(cams, counts):
        got = _refine(cam, max_lod=18, cap=1024, probe="ridged6")
        assert not bool(got.overflowed)
        n = int(got.n_leaves)
        lo, hi = got.leaf_lo[:n], got.leaf_hi[:n]
        order = torch.argsort(tq.words_dfs_key(lo, hi), stable=True)
        ids = tq.from_words(lo[order].numpy(), hi[order].numpy())
        np.testing.assert_array_equal(ids, all_ids[offset:offset + count])
        offset += count


def test_quality_matches_host():
    """tests/test_refine_device.py:106-135: lod_quality multiplies the
    split threshold in both refiners; quality > 1 refines deeper."""
    cam_dir = np.array([0.3, 0.25, -0.9])
    cam = cam_dir / np.linalg.norm(cam_dir) * (RADIUS + 30e3)
    n_prev = 0
    for q in (1.0, 3.0, 8.0):
        want = host.refine(cam, 7, RADIUS, height_fn=_ridged6_height_fn,
                           quality=q)
        got = _refine(cam, max_lod=7, cap=2048, probe="ridged6", quality=q)
        assert not bool(got.overflowed)
        assert set(int(x) for x in _ids(got)) == set(int(x) for x in want.ids)
        assert int(got.n_leaves) >= n_prev
        n_prev = int(got.n_leaves)


def test_overflow_flag():
    cam = np.array([0.0, 0.0, -(RADIUS + 50.0)])   # very close: deep splits
    got = _refine(cam, max_lod=10, cap=64, probe="zero")
    assert bool(got.overflowed)
    assert int(got.n_leaves) <= 64
