"""Seeded raster and vertex-program scenes shared by the port's CPU and GPU
tests (numpy only, so the GPU tests run where JAX is not installed), and
the bars a frame of the C oracle's golden scenes is held to."""

import pathlib

import numpy as np

from planet_tpu_torch.geom import camera as cam_mod

F = np.float32
GOLD = pathlib.Path(__file__).parent / "goldens"

# taller than 16 aligned 8-row blocks, so the biggest triangles take the
# huge kernel
SCREEN = dict(width=200, height=160,
              sizes=((80, 1.5), (30, 8.0), (8, 40.0), (4, 200.0)))
# a view scene with near-plane straddlers and far-straddlers (seed 14)
VIEW = dict(seed=14, width=160, height=120, far=40.0)
# straddle_scene's: 888 near-plane straddlers over 20 blocks of 256
# candidates, past the clip pass's 512 slots
STRADDLE = dict(seed=3, q=40, g=8, width=64, height=48, far=50.0)


def screen_scene(seed, width, height, sizes):
    """Random screen-space triangles (tests/test_raster_exact.rand_tris),
    each one cell of a (Q, 2, 2) patch batch with a degenerate T1."""
    rng = np.random.default_rng(seed)
    tris = []
    for n, span in sizes:
        for _ in range(n):
            base = rng.uniform([0, 0], [width, height])
            verts = []
            for _ in range(3):
                p = base + rng.uniform(-span, span, 2)
                nrm = rng.normal(size=3)
                verts.append((np.round(F(p) * F(16.0)) * F(1.0 / 16.0),
                              F(rng.uniform(-0.9, 0.9)),
                              F(rng.uniform(0.1, 2.0)),
                              (nrm / np.linalg.norm(nrm)).astype(F)))
            tris.append(verts)
    q = len(tris)
    clip = np.zeros((q, 2, 2, 4), F)
    normal = np.zeros((q, 2, 2, 3), F)
    for i, t in enumerate(tris):
        slots = {(0, 0): t[0], (1, 0): t[1], (0, 1): t[2], (1, 1): t[1]}
        for (r, c), (xy, z, iw, nrm) in slots.items():
            w = 1.0 / iw
            ndc_x = (xy[0] / width - 0.5) * 2.0
            ndc_y = (0.5 - xy[1] / height) * 2.0
            clip[i, r, c] = [ndc_x * w, ndc_y * w, z * w, w]
            normal[i, r, c] = nrm
    return clip, normal, np.ones((q, 2, 2), bool)


def straddle_scene(seed, q, g, **_):
    """(clip (Q, G, G, 4) f32, normal (Q, G, G, 3) f32, valid (Q, G, G)
    bool): clip positions uniform in [-1, 1] with w in [-0.5, 2], so about
    a fifth of the cell triangles straddle the near plane, every vertex
    valid, random normals."""
    rng = np.random.default_rng(seed)
    clip = rng.uniform(-1.0, 1.0, (q, g, g, 4)).astype(np.float32)
    clip[..., 3] = rng.uniform(-0.5, 2.0, (q, g, g))
    normal = rng.normal(size=(q, g, g, 3)).astype(np.float32)
    return clip, normal, np.ones((q, g, g), bool)


def view_scene(seed, width, height, far):
    """Random view-space 3x3 patches around the camera, projected with the
    engine's perspective: cells cross the near plane (straddlers) and the
    far plane (far-straddlers); sizes range from sub-pixel to screen-wide."""
    rng = np.random.default_rng(seed)
    proj = cam_mod.perspective_lh(
        cam_mod.proj_factor_from_fovy(np.deg2rad(50.0)), width / height,
        1.0, far)
    q = 48
    centre = np.stack([rng.uniform(-8, 8, q), rng.uniform(-6, 6, q),
                       rng.uniform(-2.0, far * 1.1, q)], axis=1)
    step = rng.uniform(0.05, 6.0, (q, 1, 1, 1))
    gy, gx = np.mgrid[-1:2, -1:2].astype(np.float64)
    tilt = rng.normal(size=(q, 3))
    pts = centre[:, None, None, :] + step * (
        gx[None, :, :, None] * np.array([1.0, 0.0, 0.0])
        + gy[None, :, :, None] * np.array([0.0, 0.3, 1.0])
        + (gx * gy)[None, :, :, None] * tilt[:, None, None, :] * 0.3)
    hom = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], axis=-1)
    clip = np.einsum("ij,qabj->qabi", proj.astype(np.float64), hom).astype(F)
    nrm = rng.normal(size=(q, 3, 3, 3))
    normal = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(F)
    valid = rng.uniform(size=(q, 3, 3)) > 0.05
    return clip, normal, valid


# the adversarial records' screen: wide enough for full-width rows
EDGE = dict(seed=21, width=240, height=136)


def adversarial_tris(seed, width, height, n=12):
    """(clip (K, 3, 4), normal (K, 3, 3)) f32 of screen triangles that
    stress the span kernel's row intervals, each in both windings (one of
    them faces the camera): near-horizontal and exactly horizontal edges,
    near-vertical and exactly vertical edges, slivers 1/16 px thick,
    one-pixel triangles, rows wider than the screen, and triangles hanging
    over each side of the screen (bboxes clamped at its edge)."""
    rng = np.random.default_rng(seed)
    tris = []
    for _ in range(n):
        x0, y0 = rng.uniform(-20, width + 20), rng.uniform(-10, height + 10)
        tilt = rng.choice([0.0, 1 / 16, -1 / 16, 1 / 8])
        long = rng.uniform(20, width)
        tris.append([(x0, y0), (x0 + long, y0 + tilt),
                     (x0 + long * rng.uniform(), y0 + rng.uniform(2, 40))])
        tris.append([(x0, y0), (x0 + tilt, y0 + rng.uniform(2, 100)),
                     (x0 + rng.uniform(-30, 30), y0 + rng.uniform(0, 50))])
        d = rng.normal(size=2)
        d /= np.linalg.norm(d)
        a = np.array([x0, y0])
        b = a + d * rng.uniform(5, 200)
        tris.append([a, b, b + np.array([-d[1], d[0]]) / 16])
        cx = rng.integers(0, width) + 0.5
        cy = rng.integers(0, height) + 0.5
        tris.append([(cx - 0.3, cy - 0.3), (cx + 0.4, cy), (cx, cy + 0.4)])
        tris.append([(-50.0, y0), (width + 50.0, y0 + rng.uniform(0, 2)),
                     (width * rng.uniform(), y0 + rng.uniform(3, 60))])
        side = rng.integers(4)
        ex = (-15.0, width + 15.0, x0, x0)[side]
        ey = (y0, y0, -15.0, height + 15.0)[side]
        tris.append([(ex, ey), (ex + rng.uniform(-60, 60), ey + 40),
                     (ex + 40, ey + rng.uniform(-60, 60))])
    tris += [t[::-1] for t in tris]
    k = len(tris)
    xy = np.array([[np.asarray(p, np.float64) for p in t] for t in tris])
    w = rng.uniform(0.5, 2.0, (k, 3))
    clip = np.zeros((k, 3, 4), F)
    clip[..., 0] = (xy[..., 0] / width - 0.5) * 2.0 * w
    clip[..., 1] = (0.5 - xy[..., 1] / height) * 2.0 * w
    clip[..., 2] = rng.uniform(-0.9, 0.9, (k, 3)) * w
    clip[..., 3] = w
    nrm = rng.normal(size=(k, 3, 3))
    normal = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(F)
    return clip, normal


def adversarial_records(seed, width, height, device="cpu"):
    """(M, 32) f32 span records: the live adversarial_tris set up by the
    raster's record math (nearclip.setup_tris, records_from_tris), then
    a copy of them with the edge words' zeros made -0.0, and records
    the span kernel scans whole, each with one edge word at or beyond its
    limit: an accept bias of -1e35 or -inf (the edge passes everywhere, the
    other two bound the triangle), of 1e35 or NaN, or an edge constant of
    NaN (the record draws nothing). Their fragment math stays finite, so
    the kernel and its plain version compute the same keys; records whose
    shades are NaN are nan_shade_records'."""
    import torch

    from planet_tpu_torch.raster import nearclip

    clip, normal = adversarial_tris(seed, width, height)
    t = nearclip.setup_tris(torch.as_tensor(clip, device=device),
                            torch.as_tensor(normal, device=device),
                            torch.ones(len(clip), dtype=torch.bool,
                                       device=device), width, height)
    recs = nearclip.records_from_tris(t)[t.live]
    neg0 = recs.clone()
    edge = neg0[:, :9]
    neg0[:, :9] = torch.where(edge == 0.0, torch.full_like(edge, -0.0), edge)
    odd = recs[:6].clone()
    for i, (word, value) in enumerate(((29, -1e35), (30, float("-inf")),
                                       (31, 1e35), (29, float("nan")),
                                       (2, float("nan")), (31, -1e30))):
        odd[i, word] = value
    return torch.cat([recs, neg0, odd]).contiguous()


# pixel_records' set: pixel-sized triangles, as the dense and config-3
# frames draw them, with a few of ~2,000 px
PIXELS = dict(seed=5, width=320, height=200, n_small=24000, n_large=12)


def pixel_records(seed, width, height, n_small, n_large, device="cpu"):
    """(M, 32) f32 span records in a seeded order: the live ones of
    n_small triangles a pixel or two across and n_large of about 2,000
    pixels (each in both windings; one of them faces the camera), every
    7th of them made dead (row 28 zero) and every 97th scanned whole (one accept bias or edge constant at or beyond
    the kernel's limit, as adversarial_records' are), so that a warp's
    batches hold all three."""
    import torch

    from planet_tpu_torch.raster import nearclip

    rng = np.random.default_rng(seed)
    centre = rng.uniform([0, 0], [width, height], (n_small + n_large, 1, 2))
    reach = np.where(np.arange(n_small + n_large) < n_small, 4.0, 45.0)
    xy = centre + rng.uniform(-1.0, 1.0, centre.shape[:1] + (3, 2)) \
        * reach[:, None, None]
    xy = np.concatenate([xy, xy[:, ::-1]])
    k = len(xy)
    w = rng.uniform(0.5, 2.0, (k, 3))
    clip = np.zeros((k, 3, 4), F)
    clip[..., 0] = (xy[..., 0] / width - 0.5) * 2.0 * w
    clip[..., 1] = (0.5 - xy[..., 1] / height) * 2.0 * w
    clip[..., 2] = rng.uniform(-0.9, 0.9, (k, 3)) * w
    clip[..., 3] = w
    nrm = rng.normal(size=(k, 3, 3))
    normal = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(F)
    t = nearclip.setup_tris(torch.as_tensor(clip, device=device),
                            torch.as_tensor(normal, device=device),
                            torch.ones(k, dtype=torch.bool, device=device),
                            width, height)
    recs = nearclip.records_from_tris(t)[t.live]
    recs = recs[torch.as_tensor(rng.permutation(len(recs)), device=device)]
    rows = np.arange(len(recs))
    dead = rows % 7 == 3
    whole = rows % 97 == 5
    out = recs.clone()
    out[torch.as_tensor(dead, device=device), 28] = 0.0
    odd = ((29, -1e35), (30, float("-inf")), (31, 1e35), (2, float("nan")))
    for i, row in enumerate(rows[whole]):
        word, value = odd[i % len(odd)]
        out[int(row), word] = value
    return out.contiguous()


def nan_shade_records(seed, width, height, device="cpu"):
    """(M, 32) f32 span records whose every fragment has a NaN shade: the
    first live adversarial_tris records, each with one edge constant made
    +inf (edge 0, 1, 2 in turn). That edge then passes everywhere and its
    value is inf, so the interpolated normal is inf or NaN and the shade
    NaN, while z stays >= -1 where its weight is positive (its key's depth
    saturates). The span kernel scans these records whole. K2, K3 and
    their plain versions pack each such shade as 0, as planet_tpu's
    float -> int32 conversion (XLA's) turns NaN into 0."""
    recs = adversarial_records(seed, width, height, device)[:24].clone()
    for i in range(len(recs)):
        recs[i, 3 * (i % 3) + 2] = float("inf")
    return recs


def counter_values(rc):
    """A RasterCounters of device tensors as host values: ints, the
    per-class pair as a tuple of ints, the overflow flag as a bool."""
    return type(rc)(n_tris=int(rc.n_tris),
                    n_per_class=tuple(int(v) for v in rc.n_per_class),
                    n_huge=int(rc.n_huge), overflowed=bool(rc.overflowed),
                    n_straddle=int(rc.n_straddle))


def ssim(a, b, window: int = 8) -> float:
    """Mean local SSIM over non-overlapping windows (f32 images in [0, 1];
    tests/test_golden_frame's measure)."""
    h = a.shape[0] // window * window
    w = a.shape[1] // window * window

    def blocks(x):
        return x[:h, :w].reshape(h // window, window, w // window, window) \
            .transpose(0, 2, 1, 3).reshape(-1, window * window)

    xa, xb = blocks(a.astype(np.float64)), blocks(b.astype(np.float64))
    mu_a, mu_b = xa.mean(1), xb.mean(1)
    va, vb = xa.var(1), xb.var(1)
    cov = ((xa - mu_a[:, None]) * (xb - mu_b[:, None])).mean(1)
    c1, c2 = 0.01**2, 0.03**2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2)))
    return float(s.mean())


def assert_golden_counts(name, n_leaves, rc):
    """A frame of golden scene `name` ("frame", "nearclip" or "farclip")
    holds the oracle's leaf count and its raster counters `rc` did not
    overflow; the near-clip scene's straddlers and the far-clip scene's
    far-straddlers take the huge path."""
    meta = np.load(GOLD / f"{name}_meta.npy")
    assert int(n_leaves) == int(meta[0])
    assert not rc.overflowed
    if name == "nearclip":
        assert rc.n_straddle == int(meta[3])
        assert rc.n_huge > 0
    if name == "farclip":
        assert int(meta[5]) > 1000          # the scene really crosses far
        assert rc.n_huge > 0                # far-straddlers take the huge path


def assert_golden_image(name, image, depth):
    """A frame's (H, W) numpy image and depth of golden scene `name` at
    the bars of tests/test_golden_frame.py:71-97,
    tests/test_golden_nearclip.py:59-87 and tests/test_golden_farclip.py:
    56-87: coverage agreement, the shade's p99 and mean, the altitude
    frame's depth p99, SSIM."""
    gold_img = np.load(GOLD / f"{name}_image.npy")
    gold_dep = np.load(GOLD / f"{name}_depth.npy")
    cov, gcov = np.isfinite(depth), np.isfinite(gold_dep)
    if name == "nearclip":
        assert 0.5 < gcov.mean() < 0.95, gcov.mean()
    agree = (cov == gcov).mean()
    assert agree > 0.999, f"coverage agreement {agree}"
    both = cov & gcov
    ds = np.abs(image[both] - gold_img[both])
    assert np.quantile(ds, 0.99) <= 2.5 / 1023, np.quantile(ds, 0.99)
    assert ds.mean() < 1.0 / 1023, ds.mean()
    if name == "frame":
        dd = np.abs(depth[both] - gold_dep[both])
        assert np.quantile(dd, 0.99) < 1e-5, np.quantile(dd, 0.99)
    assert ssim(image, gold_img) > 0.99


# the vertex program's inputs (tests/test_torch_tess.py, and V1 on the
# card): one quad for each (variant_x, variant_y) pair
TESS_PAIRS = [(vx, vy) for vx in range(3) for vy in range(3)]
# batch -> (seed, quad half-width in radians, skirt range in m, camera
# altitude in m): quads 0.1 rad wide (the LOD's depth-4 quads, 640 km)
# seen from 3,000 km up, where the LOD draws quads that wide, whose
# interpolations all take the slerp, with and without skirts; quads 5e-4
# rad wide (3 km) from 20 km up, whose interpolations all take the linear
# fallback (1 - dot(n0, n1) < 0.001)
TESS_BATCHES = {"slerp": (14, 0.05, 0.0, 3e6),
                "skirt": (15, 0.05, 500.0, 3e6),
                "linear": (16, 2.5e-4, 500.0, 2e4)}
RADIUS = 6.371e6


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def tess_batch(seed: int, half: float, skirt: float, altitude: float,
               q: int = len(TESS_PAIRS), dim: int = 32):
    """(corners_rel, corner_normals, tiles, variant_x, variant_y, skirt,
    view_proj) as numpy arrays: q quads on the sphere whose centres lie
    within 0.2 rad of the point below a camera `altitude` up, each a square
    of corners half +- `half` rad along the tangent frame, with 32x32
    tiles of heights (sigma 3000 m), skirts uniform in [0, skirt), row k
    the pair TESS_PAIRS[k % 9], and the camera's view-projection (tiles
    dim x dim with `dim`)."""
    return _tess_scene(seed, half, skirt, altitude, q, dim)[0]


def _tess_scene(seed, half, skirt, altitude, q, dim=32):
    """(tess_batch's arrays, the camera's position in m, f64)."""
    rng = np.random.default_rng(seed)
    up = _unit(rng.normal(size=3))
    cam_pos = up * (RADIUS + altitude)
    e1 = _unit(np.cross(up, [0.0, 0.0, 1.0]))
    e2 = np.cross(up, e1)
    centre = _unit(up + rng.uniform(-0.2, 0.2, (q, 2)) @ np.stack([e1, e2]))
    t1 = _unit(np.cross(centre, e2))
    t2 = np.cross(centre, t1)
    signs = np.array([(-1, -1), (1, -1), (-1, 1), (1, 1)], np.float64)
    nrm = _unit(centre[:, None, :] + half * (
        signs[None, :, 0:1] * t1[:, None, :]
        + signs[None, :, 1:2] * t2[:, None, :]))
    corners_rel = (nrm * RADIUS - cam_pos).astype(F)
    tiles = (rng.normal(size=(q, dim, dim)) * 3000.0).astype(F)
    pairs = np.array([TESS_PAIRS[k % len(TESS_PAIRS)] for k in range(q)],
                     np.int32)
    skirts = rng.uniform(0.0, skirt, q).astype(F)
    cam = cam_mod.Camera(position=cam_pos, angles=np.array([0.35, 0.3, 0.0]))
    vp = (cam_mod.perspective_lh(cam_mod.proj_factor_from_fovy(
        np.deg2rad(60.0)), 4.0 / 3.0, 1.0, 1e8)
        @ cam_mod.view_from_rotation(cam_mod.camera_rotation(cam)))
    return (corners_rel, nrm.astype(F), tiles, pairs[:, 0].copy(),
            pairs[:, 1].copy(), skirts, vp.astype(F)), cam_pos


def tess_padded(q: int = 6, live: int = 3):
    """The skirt batch's first q quads with rows `live`.. made padding rows
    as the fused frame has them: zero DF corners, so NaN corner normals
    (0 / 0) and camera-relative corners at minus the camera position."""
    args, cam_pos = _tess_scene(*TESS_BATCHES["skirt"], q=q)
    args = list(args)
    args[1] = args[1].copy()
    args[1][live:] = F(np.nan)
    args[0] = args[0].copy()
    args[0][live:] = (-cam_pos).astype(F)
    return tuple(args)


# ------------------------------------------------- the cache stage's cases
# (A1, cache/device_pool_cuda.cache_stage, and U1, tess/uniforms_cuda):
# name -> (capacity, budget, gen_cap). Every case has padding rows past
# its live count (stale ids, zero words, zero corners).
CACHE_CASES = {
    "budget": (4096, 6, 1024),      # no pressure, the budget binds: crops
    "pressure": (64, 10**6, 64),    # more generations than free slots
    "tie": (64, 10**6, 64),         # the evictions among equal ticks
    "spill_parent": (256, 10**6, 8),   # past gen_cap, parents cached
    "spill_orphan": (256, 10**6, 8),   # past gen_cap, some without one
    "padding": (64, 10**6, 64),     # no live row
}
CACHE_MAX_LOD = 18
CACHE_DIM = 2           # the pool's tiles play no part in the stage


def _quads(face: int, depth: int):
    """Every quad of `face` at `depth`, in DFS order."""
    from planet_tpu_torch.geom import quadid
    ids = [quadid.make_root(face)]
    for _ in range(depth):
        ids = [quadid.make_child(q, c) for q in ids for c in range(4)]
    return ids


def _children(ids):
    from planet_tpu_torch.geom import quadid
    return [quadid.make_child(q, c) for q in ids for c in range(4)]


def cache_case(name: str, seed: int = 7) -> dict:
    """One case of CACHE_CASES as numpy arrays: the pool's state
    (device_pool.PoolState.from_state's dict), the rows (q_lo, q_hi,
    depth (R,) int32; corners_hi, corners_lo (12, R) f32 corner-major DF
    corners at planet scale, zero in padding rows), n the live rows, the
    stage's parameters (capacity, budget, gen_cap, max_lod, coord_scale)
    and U1's (cam_hi, cam_lo (3,) f32, max_skirt)."""
    from planet_tpu_torch.geom import quadid
    capacity, budget, gen_cap = CACHE_CASES[name]
    rng = np.random.default_rng(seed)
    lo = np.zeros(capacity, np.int64)
    hi = np.zeros(capacity, np.int64)
    tick = np.zeros(capacity, np.int32)
    cached = []

    def put(slots, ids, ticks):
        words = quadid.to_words(np.asarray(ids, np.uint64))
        lo[slots], hi[slots] = words
        tick[slots] = ticks
        cached.extend(ids)

    if name == "budget":
        d1 = [q for f in range(3) for q in _quads(f, 1)]
        put(np.arange(12) * 37, d1, rng.integers(0, 4, 12))
        now = 4
        live = _children(d1[:8]) + d1[8:12] + [quadid.make_root(f)
                                               for f in (3, 4, 5)]
    elif name == "pressure":
        d2 = [q for f in range(1, 5) for q in _quads(f, 2)]
        put(np.arange(64), d2, rng.integers(0, 10, 64))
        now = 10
        hits = [d2[k] for k in rng.choice(64, 20, replace=False)]
        live = hits + _children([d2[k] for k in range(40, 55)])
    elif name in ("tie", "padding"):
        d2 = [q for f in (0, 3, 4) for q in _quads(f, 2)]
        put(np.arange(48), d2[:48], 5)
        now = 6
        live = _children(d2[:10]) + [d2[20], d2[21]]
    else:
        d1 = [q for f in range(4) for q in _quads(f, 1)]
        put(rng.choice(capacity, 16, replace=False), d1,
            rng.integers(0, 3, 16))
        now = 3
        live = _children(d1[:8]) if name == "spill_parent" else (
            _children(d1[:3])[:10] + _children(_children(_quads(5, 1))[:5]))
    live = sorted(set(live), key=quadid.dfs_key)
    if name == "padding":
        live = []
    # padding rows: stale ids (cached or not) and zero words
    stale = [cached[0], cached[-1], live[0] if live else cached[1]]
    pad = stale + [np.uint64(0)] * 4
    ids = np.array(list(live) + pad, np.uint64)
    q_lo, q_hi = quadid.to_words(ids)
    depth = np.array([int(quadid.depth_of(q)) for q in ids], np.int32)
    depth[len(live):] = rng.integers(0, 6, len(pad))
    rows = len(ids)
    corners = (rng.uniform(-1.0, 1.0, (12, rows))
               * 6.4e6 + rng.uniform(-1.0, 1.0, (12, rows)))
    corners[:, len(live):] = 0.0
    c_hi = corners.astype(F)
    c_lo = (corners - c_hi.astype(np.float64)).astype(F)
    scale = 1e-5
    cam = rng.uniform(-1.0, 1.0, 3) * 7e6
    cam_hi = cam.astype(F)
    return dict(
        state=dict(keys_lo=lo.astype(np.uint32).view(np.int32),
                   keys_hi=hi.astype(np.uint32).view(np.int32), tick=tick,
                   tiles=np.zeros((capacity, CACHE_DIM, CACHE_DIM), F),
                   now=np.int32(now)),
        q_lo=q_lo, q_hi=q_hi, depth=depth, corners_hi=c_hi, corners_lo=c_lo,
        n=len(live), budget=budget, gen_cap=gen_cap,
        max_lod=CACHE_MAX_LOD,
        coord_scale=(F(scale), F(scale - np.float64(F(scale)))),
        cam_hi=cam_hi, cam_lo=(cam - cam_hi.astype(np.float64)).astype(F),
        max_skirt=1500.0)


# V1's rows mode (tess/vertex_cuda.tessellate_rows) on the cache cases'
# rows: every case, "depths" (budget's rows at depths 0-29, where the
# skirt's exp2 runs) and "crops" (budget's rows all cropped, the padding
# rows' zero words and the roots among them: child index 0 by the
# words' guard)
TESS_ROWS_CASES = list(CACHE_CASES) + ["depths", "crops"]


def tess_rows(name: str, device="cpu", seed: int = 17, grid: int = 32):
    """tessellate_rows' arguments (q_lo, q_hi, crop, depth, corners_hi,
    corners_lo, cam_hi, cam_lo, max_skirt, tiles, view_proj, grid) for
    TESS_ROWS_CASES[name] on `device`, and the live rows' count: the
    case's rows and camera (cache_case), its crops as the cache stage's
    plain version plans them, grid x grid tiles of heights (sigma 3000 m;
    the reference's tile side is the grid's) and a view-projection from
    the camera's position."""
    import torch

    from planet_tpu_torch.cache import device_pool, device_pool_cuda

    c = cache_case(name if name in CACHE_CASES else "budget")
    rows = len(c["q_lo"])
    if name == "depths":
        c["depth"] = (np.arange(rows) % 30).astype(np.int32)
    args = [torch.as_tensor(np.ascontiguousarray(c[k])) for k in (
        "q_lo", "q_hi", "depth", "corners_hi", "corners_lo")]
    crop = device_pool_cuda.cache_stage_plain(
        device_pool.PoolState.from_state(c["state"], "cpu"), *args,
        torch.tensor(c["n"], dtype=torch.int32),
        **{k: c[k] for k in ("budget", "gen_cap", "max_lod",
                             "coord_scale")}).crop
    if name == "crops":
        crop = torch.ones_like(crop)
    rng = np.random.default_rng(seed)
    tiles = (rng.normal(size=(rows, grid, grid)) * 3000.0).astype(F)
    pos = c["cam_hi"].astype(np.float64) + c["cam_lo"]
    cam = cam_mod.Camera(position=pos, angles=np.array([0.35, 0.3, 0.0]))
    vp = (cam_mod.perspective_lh(cam_mod.proj_factor_from_fovy(
        np.deg2rad(60.0)), 16.0 / 9.0, 1.0, 1e8)
        @ cam_mod.view_from_rotation(cam_mod.camera_rotation(cam)))
    q_lo, q_hi, depth, c_hi, c_lo = (t.to(device) for t in args)
    return (q_lo, q_hi, crop.to(device), depth, c_hi, c_lo,
            torch.as_tensor(c["cam_hi"], device=device),
            torch.as_tensor(c["cam_lo"], device=device), c["max_skirt"],
            torch.as_tensor(tiles, device=device),
            torch.as_tensor(vp.astype(F), device=device), grid), c["n"]
