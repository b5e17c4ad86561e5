"""Cube-sphere root faces (planet_tpu geom/cubesphere.py, copied — the
parts the port calls — so the port imports nothing of planet_tpu).

The planet is a quadtree on 6 cube faces whose corners are normalized onto
the sphere (reference main.cpp:604-624). A quad's 4 corners are ordered

    p0 --u--> p1
    |          |
    v          v
    p2 -----> p3

(u along p0->p1, second row p2->p3), matching the bilinear layout the tile
rasterizer and tessellator expect. Host-side float64 (numpy): the reference
keeps quad corners in double.
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


def normalize(v):
    v = np.asarray(v, np.float64)
    return v / np.sqrt((v * v).sum(axis=-1, keepdims=True))


def root_corners(radius: float) -> np.ndarray:
    """(6, 4, 3) f64 corner positions of the six root quads."""
    verts = normalize(_CUBE) * np.float64(radius)
    loops = verts[_FACE_LOOPS]                      # (6, 4, 3) in loop order
    # reorder (a, b, c, d) -> (a, b, d, c)
    return loops[:, [0, 1, 3, 2], :]
