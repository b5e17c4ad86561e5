"""Cube-sphere geometry: root faces and spherical quad subdivision
(planet_tpu geom/cubesphere.py, copied — the parts the port calls — so the
port imports nothing of planet_tpu).

The planet is a quadtree on 6 cube faces whose corners are normalized onto
the sphere (reference main.cpp:604-624). A quad's 4 corners are ordered

    p0 --u--> p1
    |          |
    v          v
    p2 -----> p3

(u along p0->p1, second row p2->p3), matching the bilinear layout the tile
rasterizer and tessellator expect. Subdivision re-projects edge midpoints and
the center onto the sphere: VERT(i,j) = normalize(p_i + p_j) * radius
(main.cpp:581-594). Host-side float64 (numpy): the reference keeps quad
corners in double.
"""

from __future__ import annotations

import numpy as np

# Cube corner positions in the reference's numbering (main.cpp:607-617):
# 0:(-1,-1,-1) 1:(1,-1,-1) 2:(1,1,-1) 3:(-1,1,-1)
# 4:(-1,-1,1)  5:(1,-1,1)  6:(1,1,1)  7:(-1,1,1)
_CUBE = np.array([
    [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
    [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
], dtype=np.float64)

# Face loops (a, b, c, d) per main.cpp:619-624; the root quad takes corners
# in order (a, b, d, c) — the reference RenderPlanet QUAD macro swaps the
# last two so the loop becomes the bilinear layout above.
_FACE_LOOPS = np.array([
    [0, 1, 2, 3],  # front
    [1, 5, 6, 2],  # right
    [5, 4, 7, 6],  # back
    [4, 0, 3, 7],  # left
    [3, 2, 6, 7],  # top
    [4, 5, 1, 0],  # bottom
], dtype=np.int64)


# child quad -> indices into the 3x3 subdivision grid
#   0 1 2
#   3 4 5
#   6 7 8
_CHILD_SEL = np.array([
    [0, 1, 3, 4],
    [1, 2, 4, 5],
    [3, 4, 6, 7],
    [4, 5, 7, 8],
], dtype=np.int64)


def normalize(v):
    v = np.asarray(v, np.float64)
    return v / np.sqrt((v * v).sum(axis=-1, keepdims=True))


def root_corners(radius: float) -> np.ndarray:
    """(6, 4, 3) f64 corner positions of the six root quads."""
    verts = normalize(_CUBE) * np.float64(radius)
    loops = verts[_FACE_LOOPS]                      # (6, 4, 3) in loop order
    # reorder (a, b, c, d) -> (a, b, d, c)
    return loops[:, [0, 1, 3, 2], :]


def subdivision_grid(corners, radius: float) -> np.ndarray:
    """The 3x3 grid of a quad's subdivision: corners, sphere-projected edge
    midpoints, and sphere-projected center. corners: (..., 4, 3) -> (..., 9, 3).
    """
    c = np.asarray(corners, np.float64)
    p0, p1, p2, p3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    r = np.float64(radius)
    mid = normalize(p0 + p1 + p2 + p3) * r
    e01 = normalize(p0 + p1) * r
    e02 = normalize(p0 + p2) * r
    e13 = normalize(p1 + p3) * r
    e23 = normalize(p2 + p3) * r
    return np.stack([p0, e01, p1, e02, mid, e13, p2, e23, p3], axis=-2)


def child_corners(corners, radius: float) -> np.ndarray:
    """All 4 children of a quad: (..., 4, 3) -> (..., 4, 4, 3) [child, corner]."""
    grid = subdivision_grid(corners, radius)
    return grid[..., _CHILD_SEL, :]


def corners_from_path(face: int, digits, radius: float) -> np.ndarray:
    """(4, 3) corners of the quad at `digits` below root `face`."""
    q = root_corners(radius)[int(face)]
    for c in digits:
        q = child_corners(q, radius)[int(c)]
    return q
