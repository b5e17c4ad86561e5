"""Host-side quadtree LOD refinement (reference ProcessQuad, main.cpp:537-598).

This is planet_tpu.lod.refine unchanged (numpy f64 on the host, probe memo
included), carried as the port's own copy: the port imports nothing of
planet_tpu.

The reference recursively splits a quad when any of 5 displaced probe points
(4 corners + sphere-projected midpoint, heights from the 6-octave terrain)
is closer than an lod-scaled fraction of the quad's diagonal:

    d = (|p3-p0|^2 + |p2-p1|^2) / (1 + 2.5*lod/max_lod)
    split iff  min_i |p_i - cam|^2 * 2 < d

Recursion becomes LEVEL-SYNCHRONOUS breadth-first sweeps — at each depth
the entire frontier's probes are evaluated as one vectorized numpy f64
batch, for exact reference parity.
The split decision depends only on (quad, camera), so BFS visits exactly
the recursion's node set; leaves are then ordered by their padded-path DFS
key (geom.quadid.dfs_key) to reproduce the reference's emission order, which
matters because it decides who wins the per-frame generation budget
(main.cpp:653).

Double precision is mandatory here: probe distances at planet scale with
metre-scale displacements decide splits; f32 would flip borderline cases.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from planet_tpu_torch.geom import cubesphere, quadid
from planet_tpu_torch.ops import perlin_np

RADIUS_DEFAULT = 6371000.0


@dataclasses.dataclass
class RefineResult:
    ids: np.ndarray        # (L,) uint64 leaf QuadIDs, DFS order
    corners: np.ndarray    # (L, 4, 3) f64 leaf corner positions
    depths: np.ndarray     # (L,) int32


def _normalize_rows(v):
    # match the oracle/reference op order: len = sqrt(x*x + y*y + z*z)
    length = np.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                     + v[..., 2] * v[..., 2])
    return v / length[..., None]


def _root_frontier(radius):
    corners = cubesphere.root_corners(radius)          # (6, 4, 3)
    ids = np.array([quadid.make_root(f) for f in range(6)], np.uint64)
    return ids, corners


def _subdivide_batch(corners, radius):
    """(N, 4, 3) -> (N, 4, 4, 3) children corners, reference op order
    (main.cpp:581-594)."""
    p0, p1, p2, p3 = (corners[:, i, :] for i in range(4))
    r = np.float64(radius)
    mid = _normalize_rows(((p0 + p1) + p2) + p3) * r
    e01 = _normalize_rows(p0 + p1) * r
    e02 = _normalize_rows(p0 + p2) * r
    e13 = _normalize_rows(p1 + p3) * r
    e23 = _normalize_rows(p2 + p3) * r
    g = np.stack([p0, e01, p1, e02, mid, e13, p2, e23, p3], axis=1)  # (N,9,3)
    sel = np.array([[0, 1, 3, 4], [1, 2, 4, 5], [3, 4, 6, 7], [4, 5, 7, 8]])
    return g[:, sel, :]


def refine(camera_position, max_lod: int, radius: float = RADIUS_DEFAULT,
           height_fn=None, probe_cache=None,
           quality: float = 1.0) -> RefineResult:
    """Breadth-first refinement against one camera.

    height_fn(points (..., 3) f64) -> f32 probe heights; defaults to the
    production terrain at (depth=0, max_depth=1), i.e. 6 octaves
    (reference main.cpp:552-556 passes (p, 0, 1)).

    probe_cache: optional dict {quad id -> (5,) f32 probe heights}. Probe
    heights are pure functions of quad geometry, so caching across frames
    is exact; the visited tree changes little per camera step, making the
    refine cost ~the tree-walk alone on warm frames.

    quality: split-threshold multiplier (EngineConfig.lod_quality);
    1.0 is bit-exactly the reference rule.
    """
    cam = np.asarray(camera_position, np.float64)
    if height_fn is None:
        height_fn = lambda p: perlin_np.terrain_height(p, 0, 1)

    ids, corners = _root_frontier(radius)
    depths = np.zeros(len(ids), np.int64)

    leaf_ids, leaf_corners, leaf_depths = [], [], []

    for level in range(max_lod + 1):
        if len(ids) == 0:
            break
        lod = max_lod - level
        if lod == 0:
            leaf_ids.append(ids)
            leaf_corners.append(corners)
            leaf_depths.append(depths)
            break

        p0, p1, p2, p3 = (corners[:, i, :] for i in range(4))
        mid_n = _normalize_rows(((p0 + p1) + p2) + p3)
        mid = mid_n * np.float64(radius)

        # probe heights: 4 corners + midpoint (cached by quad id when a
        # cache is provided — pure function of geometry)
        if probe_cache is not None:
            need = np.array([int(q) not in probe_cache for q in ids])
        else:
            need = np.ones(len(ids), bool)
        h5 = np.empty((len(ids), 5), np.float32)
        if need.any():
            pts = np.concatenate(
                [corners[need].reshape(-1, 3), mid[need]], axis=0)
            hs = height_fn(pts)
            k = int(need.sum())
            h5[need, :4] = hs[:4 * k].reshape(k, 4)
            h5[need, 4] = hs[4 * k:]
            if probe_cache is not None:
                for q, row in zip(ids[need], h5[need]):
                    probe_cache[int(q)] = row.copy()
        if probe_cache is not None and (~need).any():
            for i in np.nonzero(~need)[0]:
                h5[i] = probe_cache[int(ids[i])]

        probes = np.empty((len(ids), 5, 3), np.float64)
        for i in range(4):
            n = _normalize_rows(corners[:, i, :])
            probes[:, i, :] = corners[:, i, :] \
                + n * h5[:, i].astype(np.float64)[:, None]
        probes[:, 4, :] = mid + mid_n * h5[:, 4].astype(np.float64)[:, None]

        d30 = probes[:, 3] - probes[:, 0]
        d21 = probes[:, 2] - probes[:, 1]
        d = ((d30 * d30).sum(-1) + (d21 * d21).sum(-1)) \
            / (1.0 + 2.5 * lod / max_lod)
        if quality != 1.0:
            d = d * np.float64(quality)
        dc = probes - cam[None, None, :]
        dist2 = (dc * dc).sum(-1)                     # (N, 5)
        split = (dist2 * 2.0 < d[:, None]).any(axis=1)

        keep = ~split
        if keep.any():
            leaf_ids.append(ids[keep])
            leaf_corners.append(corners[keep])
            leaf_depths.append(depths[keep])

        if split.any():
            kids = _subdivide_batch(corners[split], radius)   # (S, 4, 4, 3)
            sids = ids[split]
            child_ids = np.stack(
                [np.array([quadid.make_child(q, c) for q in sids], np.uint64)
                 for c in range(4)], axis=1)                   # (S, 4)
            ids = child_ids.reshape(-1)
            corners = kids.reshape(-1, 4, 3)
            depths = np.repeat(depths[split] + 1, 4)
        else:
            ids = np.empty(0, np.uint64)
            corners = np.empty((0, 4, 3))
            depths = np.empty(0, np.int64)

    ids = np.concatenate(leaf_ids) if leaf_ids else np.empty(0, np.uint64)
    corners = (np.concatenate(leaf_corners) if leaf_corners
               else np.empty((0, 4, 3)))
    depths = (np.concatenate(leaf_depths) if leaf_depths
              else np.empty(0, np.int64))

    order = np.argsort(np.array([quadid.dfs_key(q) for q in ids], np.uint64),
                       kind="stable")
    return RefineResult(ids=ids[order], corners=corners[order],
                        depths=depths[order].astype(np.int32))
