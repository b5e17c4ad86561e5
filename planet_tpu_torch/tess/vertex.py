"""Batched patch tessellation — the vertex program (planet_tpu
tess/vertex.py, ported).

For every leaf quad and every vertex of its dense (G, G) patch grid:
interpolate along the sphere between the quad's four corner (p, n)
pairs, displace by the height sampled from the quad's 32x32 tile (skirt
vertices pulled down by skirt_size), take a normal from central
differences of four height taps in the local tangent frame, and project
to clip space. All math is float32 on the tensors' device.

Tile sampling, two forms as in planet_tpu. The engines use the blend
matrices (`tessellate_blend`): they only sample tiles at three rect
variants per axis (full tile, parent-crop low/high half), so bilinear
sampling is a constant sparse linear map per (variant, tap). Every row of
that map has one or two nonzero weights, so it is applied as a two-tap
lerp (`blend_taps`): fl(fl(T[a] w_a) + fl(T[b] w_b)) along x, then the
same along y. `tessellate` takes any tile rect per quad and samples with
`sample_bilinear` (GL_LINEAR + CLAMP_TO_EDGE, a gather of four texels),
as the forward step of planet_tpu_torch.entry does.

This is the plain version of the vertex kernel V1 (csrc/tess.cu,
tess/vertex_cuda.py), pinned so that the kernel can copy it op for op:
every rounding is its own torch op. Dot products and squared norms are
x x + y y + z z, left to right (`_dot`); cross products are separate
products and differences (`_cross`); the clip transform is
((M[i,0] x + M[i,1] y) + M[i,2] z) + M[i,3]; the division by the
patch's quads (grid - 3) is by a device tensor (a Python-scalar divisor
on the card is a multiply by its reciprocal). planet_tpu's XLA einsums
and sums round in another order, so the two agree at the tess bars
(tests/test_torch_tess.py), not bit for bit; no matrix product is left,
so nothing here depends on TF32.

The constant tables (the two-tap table, the patch grid's uv and skirt
masks) are uploaded once per device and shape, so a call copies nothing
from the host and can run inside a CUDA-graph capture once it has run
eagerly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from planet_tpu_torch.nums.fp import sqrt_rn
from planet_tpu_torch.tess import mesh


class PatchVertices(NamedTuple):
    """Outputs of the vertex program, each (Q, G, G, ...)."""

    clip: torch.Tensor      # (Q, G, G, 4) clip-space positions
    world: torch.Tensor     # (Q, G, G, 3) camera-relative world positions
    normal: torch.Tensor    # (Q, G, G, 3) shading normals (world space)
    height: torch.Tensor    # (Q, G, G) sampled height (minus skirt drop)
    snormal: torch.Tensor   # (Q, G, G, 3) interpolated sphere normal


def _dot(a, b):
    """(...,) dot products of (..., 3) vectors, x x + y y + z z left to
    right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _norm(v):
    return v / sqrt_rn(_dot(v, v))[..., None]


def _cross(a, b):
    """torch.linalg.cross's formula, each product and difference its own
    op (ATen's CUDA cross kernel is built with FMA contraction)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _lerp(a, b, t):
    return a + (b - a) * t


def interpolate(p0, n0, p1, n1, t):
    """Spherical interpolation of a (position, normal) pair along the great
    circle between two corners, with the reference's linear fallback when
    1 - dot(n0, n1) < 0.001 (main.cpp:310-332).

    p0/n0/p1/n1: (..., 3); t: (..., 1). Returns (p, n)."""
    d = _dot(n0, n1)[..., None]

    n_lin = _norm(_lerp(n0, n1, t))
    p_lin = _lerp(p0, p1, t)

    # both branches are evaluated; keep the unselected one finite
    d_safe = torch.clamp(d, -1.0, 1.0 - 1e-6)
    theta2 = torch.arccos(d_safe)
    k = 1.0 - t
    n_slerp = _norm(torch.sin(k * theta2) * n0 + torch.sin(t * theta2) * n1)
    theta = theta2 * 0.5
    gamma = theta - theta2 * t
    tan_theta = torch.tan(theta)
    x = 1.0 - torch.tan(gamma) / tan_theta
    y = 1.0 / torch.sin(theta) - 1.0 / (torch.cos(gamma) * tan_theta)
    half = (p1 - p0) * 0.5
    hlen = sqrt_rn(_dot(half, half))[..., None]
    p_slerp = p0 + x * half + y * n_slerp * hlen

    use_lin = (1.0 - d) < 0.001
    return (torch.where(use_lin, p_lin, p_slerp),
            torch.where(use_lin, n_lin, n_slerp))


@functools.lru_cache()
def blend_taps(dim: int = 32, n: int = mesh.PATCH_VERTS):
    """The blend matrices as a two-tap table: (idx (3, 3, n + 2, 2) int32,
    w (3, 3, n + 2, 2) f32), [variant, tap, output, k] — the two nonzero
    entries of each row of blend_matrices(dim, n), lower index first (the
    weights as the matrix holds them, a clamp-merged pair summed). A row
    with one nonzero entry repeats its index with weight 0."""
    mat = blend_matrices(dim, n)
    idx = np.zeros(mat.shape[:3] + (2,), np.int32)
    w = np.zeros(mat.shape[:3] + (2,), np.float32)
    for pos in np.ndindex(*mat.shape[:3]):
        cols = np.flatnonzero(mat[pos])
        assert 1 <= len(cols) <= 2, (pos, cols)
        idx[pos] = (cols[0], cols[-1])
        w[pos] = (mat[pos][cols[0]],
                  mat[pos][cols[1]] if len(cols) == 2 else 0.0)
    return idx, w


@functools.lru_cache(maxsize=None)
def tap_table(dim: int, grid: int, device: str):
    """blend_taps(dim, grid - 2) on `device`: (idx int32, w f32)."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in blend_taps(dim, grid - 2))


@functools.lru_cache(maxsize=None)
def _grid_tables(grid: int, device: str):
    """The patch grid's (u, v, skirt mask) as (G, G) tensors on `device`."""
    u2d, v2d, skirt2d, _ = mesh.grid_uv_skirt(grid - 2)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (u2d, v2d, skirt2d))


@functools.lru_cache()
def blend_matrices(dim: int = 32, n: int = mesh.PATCH_VERTS) -> np.ndarray:
    """(3, 3, n + 2, dim) f32 bilinear sampling weights: [variant 0=full,
    1=crop-lo, 2=crop-hi; tap 0=-pixel, 1=centre, 2=+pixel] (GL_LINEAR +
    CLAMP_TO_EDGE, texel centres at (i + 0.5)/dim; planet_tpu
    tess/vertex.blend_matrices)."""
    params = [
        (1.5, dim - 1.5, 1.0),
        (1.5, dim / 2 - 0.5, (dim / 2 - 1) / (n - 1)),
        (dim / 2 + 0.5, dim - 1.5, (dim / 2 - 1) / (n - 1)),
    ]
    g = n + 2
    w = np.zeros((3, 3, g, dim), np.float32)
    for v, (lo, hi, pix_texels) in enumerate(params):
        for ti, t in enumerate((-1.0, 0.0, 1.0)):
            for j in range(g):
                u = min(max(j - 1, 0), n - 1) / (n - 1)
                su = (lo + (hi - lo) * u) + t * pix_texels - 0.5
                x0 = int(np.floor(su))
                fx = su - x0
                xa = min(max(x0, 0), dim - 1)
                xb = min(max(x0 + 1, 0), dim - 1)
                w[v, ti, j, xa] += np.float32(1.0 - fx)
                w[v, ti, j, xb] += np.float32(fx)
    return w


def sample_bilinear(tile, u, v):
    """GL_LINEAR + CLAMP_TO_EDGE sampling of (..., H, W) f32 tiles at
    normalized coordinates u, v of shape (..., *S), one tile per leading
    index (planet_tpu's per-tile sample_bilinear, vmapped): texel centres
    sit at (i + 0.5) / W (glTexImage2D + GL_LINEAR, render.cpp:415-435).
    Returns (..., *S)."""
    h, w = tile.shape[-2:]
    su = u * float(w) - 0.5
    sv = v * float(h) - 0.5
    x0 = torch.floor(su)
    y0 = torch.floor(sv)
    fx = su - x0
    fy = sv - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    xa, xb = x0i.clamp(0, w - 1), (x0i + 1).clamp(0, w - 1)
    ya, yb = y0i.clamp(0, h - 1), (y0i + 1).clamp(0, h - 1)
    lead = tile.shape[:-2]
    flat = tile.reshape(lead + (h * w,))

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(lead + (-1,))
        return torch.gather(flat, -1, idx).reshape(u.shape)

    t00, t10 = tap(ya, xa), tap(ya, xb)
    t01, t11 = tap(yb, xa), tap(yb, xb)
    return _lerp(_lerp(t00, t10, fx), _lerp(t01, t11, fx), fy)


def tessellate(corners_rel, corner_normals, tiles, rect_lo, rect_hi,
               pixel_size, skirt_size, view_proj,
               grid: int = mesh.GRID) -> PatchVertices:
    """The vertex program with gathered tile sampling (planet_tpu
    tess/vertex.tessellate).

    corners_rel (Q, 4, 3) f32 camera-relative corners (p0, p1 the first
    row, p2, p3 the second); corner_normals (Q, 4, 3) f32 unit sphere
    normals; tiles (Q, H, W) f32; rect_lo/rect_hi (Q, 2) f32 tile-rect uv
    corners; pixel_size (Q, 2) f32 one-texel uv step of the normal taps;
    skirt_size (Q,) f32; view_proj (4, 4) f32 (out = M @ v). Returns
    PatchVertices of (Q, grid, grid)."""
    q = corners_rel.shape[0]
    dev = tiles.device
    u2d, v2d, _ = _grid_tables(grid, str(dev))
    uu = u2d[None, :, :, None]
    vv = v2d[None, :, :, None]
    lo = rect_lo.to(torch.float32)[:, None, None, :]
    hi = rect_hi.to(torch.float32)[:, None, None, :]
    tex = lo + (hi - lo) * torch.cat([uu, vv], dim=-1)
    tu, tv = tex[..., 0], tex[..., 1]
    ps = pixel_size.to(torch.float32)[:, None, None, :]
    pu = ps[..., 0].expand(tu.shape)
    pvs = ps[..., 1].expand(tv.shape)
    tiles = tiles.to(torch.float32)
    hgt = sample_bilinear(tiles, tu, tv)
    x0 = sample_bilinear(tiles, tu - pu, tv)
    x1 = sample_bilinear(tiles, tu + pu, tv)
    y0 = sample_bilinear(tiles, tu, tv - pvs)
    y1 = sample_bilinear(tiles, tu, tv + pvs)
    return _assemble(corners_rel, corner_normals, hgt, x0, x1, y0, y1,
                     skirt_size, view_proj, q, grid)


def tessellate_blend(corners_rel, corner_normals, tiles, variant_x,
                     variant_y, skirt_size, view_proj,
                     grid: int = mesh.GRID) -> PatchVertices:
    """The vertex program over Q quads.

    corners_rel (Q, 4, 3) f32 camera-relative corners; corner_normals
    (Q, 4, 3) f32; tiles (Q, dim, dim) f32; variant_x/y (Q,) int in
    {0, 1, 2} (rect variant per axis); skirt_size (Q,) f32; view_proj
    (4, 4) f32 (out = M @ v). Returns PatchVertices of (Q, grid, grid)."""
    q, dim = tiles.shape[0], tiles.shape[-1]
    idx, w = tap_table(dim, grid, str(tiles.device))
    ix, wx = idx[variant_x.long()].long(), w[variant_x.long()]  # (Q,3,G,2)
    iy, wy = idx[variant_y.long()].long(), w[variant_y.long()]
    tiles = tiles.to(torch.float32)

    def xblend(tap):
        # t1[q, y, o] = T[q, y, a] w_a + T[q, y, b] w_b, (a, b) = taps of o
        def term(k):
            at = ix[:, None, tap, :, k].expand(q, dim, grid)
            return torch.gather(tiles, 2, at) * wx[:, None, tap, :, k]
        return term(0) + term(1)

    def yblend(t1, tap):
        # out[q, o, x] = t1[q, a, x] w_a + t1[q, b, x] w_b
        def term(k):
            at = iy[:, tap, :, k, None].expand(q, grid, grid)
            return torch.gather(t1, 1, at) * wy[:, tap, :, k, None]
        return term(0) + term(1)

    tc = xblend(1)
    hgt = yblend(tc, 1)
    y0 = yblend(tc, 0)
    y1 = yblend(tc, 2)
    x0 = yblend(xblend(0), 1)
    x1 = yblend(xblend(2), 1)
    return _assemble(corners_rel, corner_normals, hgt, x0, x1, y0, y1,
                     skirt_size, view_proj, q, grid)


def _assemble(corners_rel, corner_normals, hgt, x0, x1, y0, y1, skirt_size,
              view_proj, q, grid) -> PatchVertices:
    """Corner interpolation, skirt drop, central-difference normals + TBN,
    clip transform (main.cpp:338-367)."""
    dev = hgt.device
    u2d, v2d, skirt2d = _grid_tables(grid, str(dev))
    uu = u2d[None, :, :, None]
    vv = v2d[None, :, :, None]
    sk = skirt2d[None, :, :]

    c = corners_rel.to(torch.float32)
    n = corner_normals.to(torch.float32)

    def corner(i):
        return c[:, i, None, None, :], n[:, i, None, None, :]

    (p0, n0), (p1, n1), (p2, n2), (p3, n3) = (corner(i) for i in range(4))
    pa, na = interpolate(p0, n0, p1, n1, uu)     # row 1 at u
    pb, nb = interpolate(p2, n2, p3, n3, uu)     # row 2 at u
    pv, nv = interpolate(pa, na, pb, nb, vv)     # blended at v

    height = hgt - skirt_size.to(torch.float32)[:, None, None] * sk

    # tangent-space normal from central differences (main.cpp:338-346):
    # the row's length over the patch's quads (the shader's 29 for the
    # reference's 30-vertex patches; the grid less 3 at any size); the
    # divisor a device tensor: a true division on the card too
    row_dir = pb - pa
    quads = torch.full((), float(grid - 3), dtype=torch.float32, device=dev)
    xyscale = sqrt_rn(_dot(row_dir, row_dir)) / quads
    n_tan = _norm(torch.stack([x0 - x1, 2.0 * xyscale, y0 - y1], dim=-1))

    # TBN (main.cpp:361-365)
    t_vec = _norm(_cross(nv, row_dir))
    bi = _norm(_cross(t_vec, nv))
    normal = _norm(t_vec * n_tan[..., 0:1] + nv * n_tan[..., 1:2]
                   + bi * n_tan[..., 2:3])

    world = pv + nv * height[..., None]
    m = view_proj.to(torch.float32)
    wx, wy, wz = world.unbind(-1)
    clip = torch.stack([((m[i, 0] * wx + m[i, 1] * wy) + m[i, 2] * wz)
                        + m[i, 3] for i in range(4)], dim=-1)
    return PatchVertices(clip=clip, world=world, normal=normal,
                         height=height, snormal=nv)
