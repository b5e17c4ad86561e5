"""Heightmap tiles' plain version (K1's): quad corners -> (N, dim, dim) f32
height tiles, `tiles_plain`.

Per texel (x, y) of a tile (reference GenerateHeightMap + terrain functor,
main.cpp:123-151, 823-832):

    u = (x - 1) / (dim - 3), v = (y - 1) / (dim - 3)    (1-texel overscan)
    a = p0 + (p1 - p0) u,  b = p2 + (p3 - p2) u,  p = a + (b - a) v
    height = amplitude * noise(p)                          (in double-float)

with the corners pre-scaled by the terrain's coord_scale (f64, split into
hi/lo f32 pairs), so the blend happens in noise space. Each tile carries
its own octave count, at most MAX_OCTAVES.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.frozen.nums import df as dfm
from perfbench.reference.frozen.ops import perlin
from perfbench.reference.frozen.ops.kernels.perlin_cuda import MAX_OCTAVES

# the kernel keeps a tile's column terms in shared memory (60 bytes a
# column, at most 32 KB: csrc/tile.cu)
MAX_DIM = 512


def _uv_df(dim: int, device):
    """(x - 1) * (1/(dim - 3)) per texel column as a double-float pair —
    the kernel's `_df_scale` of an exact small integer by the DF constant."""
    div = np.float64(1.0) / np.float64(dim - 3)
    div_hi = np.float32(div)
    div_lo = np.float32(div - np.float64(div_hi))
    xm1 = torch.arange(dim, dtype=torch.float32, device=device) - 1.0
    return perlin._df_scale(xm1, torch.zeros_like(xm1), div_hi, div_lo)


def _check_meta(corners_hi, corners_lo, octaves, kind, lacunarity):
    """Shape, type and argument checks; reads no tensor values."""
    if kind not in ("fbm", "ridged"):
        raise ValueError(kind)
    n = corners_hi.shape[0]
    if tuple(corners_hi.shape) != (n, 4, 3) or corners_lo.shape != corners_hi.shape:
        raise ValueError(f"corners must be (N, 4, 3) hi/lo pairs, got "
                         f"{tuple(corners_hi.shape)} / {tuple(corners_lo.shape)}")
    if corners_hi.dtype != torch.float32 or corners_lo.dtype != torch.float32:
        raise ValueError(f"corners must be torch.float32, got "
                         f"{corners_hi.dtype} / {corners_lo.dtype}")
    if tuple(octaves.shape) != (n,):
        raise ValueError(f"octaves must be (N,), got {tuple(octaves.shape)}")
    if octaves.dtype != torch.int32:
        raise ValueError(f"octaves must be torch.int32, got {octaves.dtype}")
    if float(lacunarity) <= 0.0:
        raise ValueError("lacunarity must be positive")


def tiles_plain(corners_hi, corners_lo, octaves, *, kind="ridged",
                lacunarity=2.0, gain=0.55, amplitude=8848.0, dim=32):
    """Plain PyTorch tile generator, the kernel's op sequence.

    corners_hi/lo: (N, 4, 3) f32 coord-scaled corner pairs; octaves: (N,)
    int32 per-tile octave count. Returns (N, dim, dim) f32."""
    _check_meta(corners_hi, corners_lo, octaves, kind, lacunarity)
    if octaves.numel() and int(octaves.max()) > MAX_OCTAVES:
        raise ValueError(f"octave counts above {MAX_OCTAVES} unsupported")
    value = perlin.accumulate_octaves(
        kind, octaves.to(torch.int64)[:, None, None], lacunarity, gain,
        *tile_coords(corners_hi, corners_lo, dim))
    return value * float(np.float32(amplitude))


def tile_uv(dim: int, device):
    """((uh, ul) along x as (1, 1, dim), (vh, vl) along y as (1, dim, 1)):
    the overscan uv of every texel (csrc/tile_blend.cuh tile_uv)."""
    uh, ul = _uv_df(dim, device)
    return ((uh[None, None, :], ul[None, None, :]),
            (uh[None, :, None], ul[None, :, None]))


def tile_coords(corners_hi, corners_lo, dim: int = 32):
    """The six (N, dim, dim) double-float noise coordinates (xh, xl, yh,
    yl, zh, zl) of every texel: the corner blend at the overscan uv
    (csrc/tile_blend.cuh: tile_columns computes the (1, 1, dim) terms once
    a column, tile_texel the rest)."""
    u, v = tile_uv(dim, corners_hi.device)
    shape = (corners_hi.shape[0], dim, dim)
    coords = []
    for k in range(3):
        def c(j, t):
            return t[:, j, k][:, None, None]
        p0, p1, p2, p3 = ((c(j, corners_hi), c(j, corners_lo))
                          for j in range(4))
        a = dfm.add(p0, dfm.mul(dfm.sub(p1, p0), u))
        b = dfm.add(p2, dfm.mul(dfm.sub(p3, p2), u))
        ph, plo = dfm.add(a, dfm.mul(dfm.sub(b, a), v))
        coords += [ph.expand(shape), plo.expand(shape)]
    return coords


