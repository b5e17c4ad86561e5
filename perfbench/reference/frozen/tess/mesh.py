"""The static patch mesh (reference main.cpp:391-481; planet_tpu
tess/mesh.py, copied — the parts the port calls — so the port imports
nothing of planet_tpu).

The reference tessellates every quad with one fixed 30x30-vertex grid plus a
ring of skirt vertices (reference counts: 1020 vertices, 2036 triangle-strip
indices, 29*29*2 = 1682 interior triangles). A vertex is (u, v, skirt_flag).

Dense reformulation: the 1020 vertices are exactly a 32x32 grid minus its
4 corners — row 0 and row 31 are the bottom/top skirts, columns 0 and 31 of
the interior rows are the side skirts. We therefore keep the patch as dense
(32, 32) u/v/skirt arrays and give the 4 phantom corner texels clamped UVs
with the skirt flag set, plus a validity mask. The vertex program is a pure array map over this grid; no index buffer
is needed until rasterization, where the strip's triangles are enumerated
directly from grid coordinates.

The exact reference vertex ordering (vertex_list) and strip indices are
also provided; the strip decides which dense-grid triangles are drawn
(cell_triangle_mask).
"""

from __future__ import annotations

import functools

import numpy as np

PATCH_VERTS = 30          # patch_size_in_verts (reference main.cpp:391)
PATCH_QUADS = PATCH_VERTS - 1
GRID = PATCH_VERTS + 2    # the dense grid: interior + skirt ring


@functools.lru_cache()
def strip_indices(n: int = PATCH_VERTS) -> np.ndarray:
    """The exact reference triangle-strip index buffer (main.cpp:427-474).

    One strip covering bottom skirt, all interior rows (each row widened by
    the two side-skirt columns), and top skirt, with 2-index degenerate
    resets between strips.
    """
    quads = n - 1
    idx = []
    v0, v1 = 0, n + 1
    for _ in range(n):                     # bottom skirt row
        idx += [v0, v1]
        v0 += 1
        v1 += 1
    idx += [v1 - 1, v0]                    # reset
    v1 += 1
    for y in range(quads):                 # interior rows (incl. side skirts)
        for _ in range(n + 2):
            idx += [v0, v1]
            v0 += 1
            v1 += 1
        if y + 1 < quads:
            idx += [v1 - 1, v0]            # reset
    v0 += 1
    idx += [v1 - 1, v0]                    # reset
    for _ in range(n):                     # top skirt row
        idx += [v0, v1]
        v0 += 1
        v1 += 1
    out = np.asarray(idx, dtype=np.uint32)
    expected = quads * (2 + quads * 2 + 2) - 2 + (quads * 4 + 2 * (2 + quads * 2 + 2))
    assert out.shape[0] == expected
    return out


def strip_to_triangles(indices: np.ndarray) -> np.ndarray:
    """Decode a triangle strip into a (T, 3) triangle list, dropping
    degenerates and normalizing winding (GL strip parity: triangle k is
    (k, k+1, k+2) for even k, (k+1, k, k+2) for odd k)."""
    i = np.asarray(indices)
    a, b, c = i[:-2], i[1:-1], i[2:]
    odd = (np.arange(len(i) - 2) & 1).astype(bool)
    t0 = np.where(odd, b, a)
    t1 = np.where(odd, a, b)
    tris = np.stack([t0, t1, c], axis=1)
    keep = (tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2]) & (tris[:, 0] != tris[:, 2])
    return tris[keep]


@functools.lru_cache()
def flat_to_grid(n: int = PATCH_VERTS):
    """Map reference vertex-list index -> (row, col) in the dense grid.

    Grid layout: row 0 = bottom skirt (cols 1..n), rows 1..n = [left skirt,
    interior, right skirt], row n+1 = top skirt (cols 1..n).
    """
    rows, cols = [], []
    for x in range(n):
        rows.append(0)
        cols.append(x + 1)
    for y in range(n):
        rows.append(y + 1)
        cols.append(0)
        for x in range(n):
            rows.append(y + 1)
            cols.append(x + 1)
        rows.append(y + 1)
        cols.append(n + 1)
    for x in range(n):
        rows.append(n + 1)
        cols.append(x + 1)
    return np.asarray(rows), np.asarray(cols)


@functools.lru_cache()
def grid_uv_skirt(n: int = PATCH_VERTS):
    """Dense (n+2, n+2) grid arrays: u, v, skirt flag, and validity mask.

    Valid cells reproduce vertex_list exactly (checked in tests); the 4
    corners are phantom (mask False) with clamped UV and skirt=1, so the
    vertex program can run dense without special cases.
    """
    g = n + 2
    # compute in f64 then narrow, matching the reference's double `x*div`
    # narrowed at Vec3 construction (main.cpp:406-425)
    div = 1.0 / (n - 1)
    gx = np.arange(g, dtype=np.float64)
    u1 = (np.clip(gx - 1.0, 0.0, n - 1) * div).astype(np.float32)
    u = np.broadcast_to(u1[None, :], (g, g)).copy()
    v = np.broadcast_to(u1[:, None], (g, g)).copy()
    border = np.zeros((g, g), dtype=bool)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    skirt = border.astype(np.float32)
    mask = np.ones((g, g), dtype=bool)
    for r, c in ((0, 0), (0, g - 1), (g - 1, 0), (g - 1, g - 1)):
        mask[r, c] = False
    return u, v, skirt, mask


@functools.lru_cache()
def grid_triangles(n: int = PATCH_VERTS) -> np.ndarray:
    """All rendered triangles as (T, 3) indices into the FLATTENED dense grid
    (row*G + col), decoded from the reference strip so coverage and winding
    match the reference exactly."""
    rows, cols = flat_to_grid(n)
    flat2grid = rows * (n + 2) + cols
    tris = strip_to_triangles(strip_indices(n))
    return flat2grid[tris.astype(np.int64)]


@functools.lru_cache()
def cell_triangle_mask(n: int = PATCH_VERTS) -> np.ndarray:
    """(2, n+1, n+1) bool: which of the dense grid's per-cell triangles
    (T0 = (g[r,c], g[r+1,c], g[r,c+1]), T1 = (g[r,c+1], g[r+1,c],
    g[r+1,c+1])) the reference strip actually draws. The strip skips the 4
    skirt-corner cells (its skirt rows span only the interior columns,
    main.cpp:402-474), so a dense enumeration must mask those out."""
    g = n + 2
    ref = set()
    for a, b, c in grid_triangles(n):
        ref |= {(int(a), int(b), int(c)), (int(b), int(c), int(a)),
                (int(c), int(a), int(b))}
    mask = np.zeros((2, g - 1, g - 1), bool)
    found = 0
    for r in range(g - 1):
        for c in range(g - 1):
            g00, g10 = r * g + c, (r + 1) * g + c
            g01, g11 = r * g + c + 1, (r + 1) * g + c + 1
            for t, tri in enumerate(((g00, g10, g01), (g01, g10, g11))):
                if tri in ref:
                    mask[t, r, c] = True
                    found += 1
    assert found == len(grid_triangles(n)), (found, len(grid_triangles(n)))
    return mask


