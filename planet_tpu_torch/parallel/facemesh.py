"""Cube-face adjacency and cube-sphere texel grids (planet_tpu
parallel/facemesh.py, ported).

Face numbering and windings follow the reference's root quads
(main.cpp:604-624, see geom.cubesphere): face corners (p0, p1, p2, p3) with
u along p0->p1 and v along p0->p2.

Edge naming: 0 = v=0 row (u increasing), 1 = u=1 column (v increasing),
2 = v=1 row (u increasing), 3 = u=0 column (v increasing).

The sharded field step's face-seam exchange (parallel/sharded.py) routes
its halos through `edge_adjacency`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from planet_tpu_torch.geom import cubesphere
from planet_tpu_torch.nums import df as dfm

N_FACES = 6
EDGE_V0, EDGE_U1, EDGE_V1, EDGE_U0 = 0, 1, 2, 3


@functools.lru_cache()
def edge_adjacency():
    """(6, 4) arrays: neighbor face, neighbor edge, and orientation flag
    (True = the shared edge runs in opposite parameter direction on the two
    faces). Derived numerically from the root corner geometry so it is
    correct by construction against geom.cubesphere."""
    corners = cubesphere.root_corners(1.0)    # (6, 4, 3)

    # endpoints of each edge in corner indices (p0,p1,p2,p3 layout)
    edge_ends = {
        EDGE_V0: (0, 1),
        EDGE_U1: (1, 3),
        EDGE_V1: (2, 3),
        EDGE_U0: (0, 2),
    }

    nbr_face = np.full((N_FACES, 4), -1, np.int32)
    nbr_edge = np.full((N_FACES, 4), -1, np.int32)
    reversed_ = np.zeros((N_FACES, 4), bool)

    def key(p):
        return tuple(np.round(p, 9))

    for f in range(N_FACES):
        for e, (a, b) in edge_ends.items():
            pa, pb = corners[f, a], corners[f, b]
            for g in range(N_FACES):
                if g == f:
                    continue
                for e2, (c, d) in edge_ends.items():
                    pc, pd = corners[g, c], corners[g, d]
                    if key(pa) == key(pc) and key(pb) == key(pd):
                        nbr_face[f, e], nbr_edge[f, e] = g, e2
                        reversed_[f, e] = False
                    elif key(pa) == key(pd) and key(pb) == key(pc):
                        nbr_face[f, e], nbr_edge[f, e] = g, e2
                        reversed_[f, e] = True
    assert (nbr_face >= 0).all()
    return nbr_face, nbr_edge, reversed_


def face_grid_points_df(n: int, radius: float, overscan: int = 0,
                        row0=None, rows: int = None, *, device="cuda"):
    """Double-float sphere points of all 6 faces at texel centres, computed
    on the device from the 6x4x3 corner constants (no host grid crosses to
    the device).

    Returns (px, py, pz), each a DF `(hi, lo)` pair of (6, R, n + 2o) f32
    tensors. u = (i + 0.5)/n is an exact DF division, the bilinear blend
    of the root corners runs in DF, and the points are normalized with DF
    dot3/sqrt/div: ~1e-14 relative to the host f64 grid (face_grid_points).
    planet_tpu's op sequence, except that nums.df.sqrt seeds its Newton
    step with the correctly rounded 1/sqrt, so the last bits may differ
    from planet_tpu's.

    row0/rows select a horizontal strip: R = rows grid rows starting at
    global row row0 (an int or a 0-dim tensor; the strip's rows equal the
    matching rows of the full grid bit for bit). Default: all rows
    (R = n + 2o)."""
    o = int(overscan)
    g = n + 2 * o
    f32 = torch.float32
    z = torch.zeros((), dtype=f32, device=device)
    ch, cl = (torch.as_tensor(a, device=device)
              for a in dfm.from_f64_np(cubesphere.root_corners(1.0)))

    def param(idx):
        """Edge parameter (i + 0.5)/n in DF for f32 grid indices."""
        return dfm.div(dfm.from_f32(idx), dfm.from_f32(dfm.const(n, z)))

    ci = torch.arange(-o, n + o, dtype=f32, device=device) + 0.5
    u1 = param(ci)                                    # (g,) columns
    if rows is None:
        v1 = u1
        gr = g
    else:
        gr = int(rows)
        if isinstance(row0, torch.Tensor):
            r0 = row0.to(device=device, dtype=f32)
        else:
            r0 = dfm.const(row0, z)
        ri = ((torch.arange(gr, dtype=f32, device=device) + 0.5) + r0) - o
        v1 = param(ri)                                # (gr,) strip rows
    one = dfm.from_f32(dfm.const(1.0, z))
    w1 = dfm.sub(one, u1)
    wv1 = dfm.sub(one, v1)

    def cols(d):          # (g,) -> (1, g), broadcast down the rows
        return d[0][None, :], d[1][None, :]

    def rws(d):           # (gr,) -> (gr, 1), broadcast across the columns
        return d[0][:, None], d[1][:, None]

    u, v, nu, nv = cols(u1), rws(v1), cols(w1), rws(wv1)
    # the weights as full (gr, g) grids, as planet_tpu broadcasts them
    w00, w10, w01, w11 = (tuple(t.expand(gr, g) for t in dfm.mul(a, b))
                          for a, b in ((nu, nv), (u, nv), (nu, v), (u, v)))

    rad = tuple(dfm.const(x, z) for x in dfm.from_f64_np(np.float64(radius)))
    out = []
    for k in range(3):
        def c(j):         # corner j's component k of every face, (6, 1, 1)
            return ch[:, j, k].reshape(6, 1, 1), cl[:, j, k].reshape(6, 1, 1)
        out.append(dfm.add(dfm.add(dfm.mul(w00, c(0)), dfm.mul(w10, c(1))),
                           dfm.add(dfm.mul(w01, c(2)), dfm.mul(w11, c(3)))))
    px, py, pz = out
    n2 = dfm.dot3(px, py, pz, px, py, pz)
    inv_len = dfm.div(rad, dfm.sqrt(n2))
    return (dfm.mul(px, inv_len), dfm.mul(py, inv_len),
            dfm.mul(pz, inv_len))


def face_grid_points(face: int, n: int, radius: float,
                     overscan: int = 0) -> np.ndarray:
    """(n+2o, n+2o, 3) f64 sphere points of face `face` sampled at texel
    centers u = (i + 0.5)/n, optionally extended `overscan` texels past the
    face edge (the reference's locally-generated halo, generalized).

    Cube-sphere parameterization: bilinear on the face quad in cube space,
    then normalized to the sphere — the n -> infinity limit of tile
    sampling on root quads."""
    o = int(overscan)
    idx = (np.arange(-o, n + o, dtype=np.float64) + 0.5) / n
    u, v = np.meshgrid(idx, idx, indexing="xy")
    c = cubesphere.root_corners(1.0)[int(face)]
    p = (c[0] * ((1 - u) * (1 - v))[..., None]
         + c[1] * (u * (1 - v))[..., None]
         + c[2] * ((1 - u) * v)[..., None]
         + c[3] * (u * v)[..., None])
    return cubesphere.normalize(p) * np.float64(radius)
