"""Whole-cube heightfield's plain version (K5's): `field_plain`, the
heights and Lambert shade of all six cube faces, evaluated in bands of
rows.

It returns (heights, shade), each (6, n, n) (or (6, rows, n) for a strip
of rows) float32, the layout planet_tpu returns after its reshape. n must
be a power of two and a multiple of 128, as planet_tpu requires. Every
value is a function of the texel's absolute (face, row, column), halo
rows included.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from perfbench.reference.frozen.geom import cubesphere
from perfbench.reference.frozen.nums import df as dfm
from perfbench.reference.frozen.nums.fp import sqrt_rn
from perfbench.reference.frozen.ops import perlin
from perfbench.reference.frozen.ops.kernels import perlin_cuda
from perfbench.reference.frozen.raster import shade as shade_mod

TILE_COLS = 128               # csrc/field.cu's tile width; n must divide
PLAIN_BAND_TEXELS = 1 << 20   # field_plain evaluates rows in bands this big


@functools.lru_cache(maxsize=None)
def _face_affine_np() -> np.ndarray:
    """(6, 3, 3) f32: [face, component j, {C, A, B}] with
    q_j = C + A*(2u-1) + B*(2v-1) on the +-1 cube, in root_corners' corner
    order and winding (u along p0->p1, v along p0->p2). Exactly one of
    C, A, B is nonzero per component."""
    c = np.round(cubesphere.root_corners(1.0) * np.sqrt(3.0))  # +-1 corners
    assert np.allclose(c[:, 3], c[:, 1] + c[:, 2] - c[:, 0])
    out = np.stack([(c[:, 0] + c[:, 3]) / 2, (c[:, 1] - c[:, 0]) / 2,
                    (c[:, 2] - c[:, 0]) / 2], axis=-1).astype(np.float32)
    assert ((out != 0).sum(axis=-1) == 1).all()
    return out


# The noise and shading parameters every entry point takes as keywords,
# with planet_tpu's defaults; xyscale=None is default_xyscale(n, radius)
# and light=None is raster/shade's light.
FIELD_DEFAULTS = dict(kind="ridged", octaves=6, lacunarity=2.0, gain=0.55,
                      coord_scale=0.00001, amplitude=8848.0, xyscale=None,
                      light=None)


def default_xyscale(n, radius) -> float:
    """World-space texel spacing of an n x n face: a quarter great circle
    over n texels."""
    return (np.pi / 2) * float(radius) / n


def _params(n, radius, row0, rows, kw):
    """Validate the arguments; the kernel's f32 constants, rounded once on
    the host as planet_tpu rounds them at trace time."""
    unknown = set(kw) - set(FIELD_DEFAULTS)
    if unknown:
        raise TypeError(f"unexpected keyword arguments {sorted(unknown)}")
    kw = {**FIELD_DEFAULTS, **kw}
    n, row0 = int(n), int(row0)
    rows = n if rows is None else int(rows)
    if n <= 0 or n & (n - 1) or n % TILE_COLS:
        raise ValueError(f"n must be a power-of-two multiple of "
                         f"{TILE_COLS}: {n}")
    if rows <= 0 or row0 < 0 or row0 + rows > n:
        raise ValueError(f"rows [{row0}, {row0 + rows}) outside [0, {n})")
    if kw["kind"] not in ("fbm", "ridged"):
        raise ValueError(kw["kind"])
    if not 0 <= int(kw["octaves"]) <= perlin_cuda.MAX_OCTAVES:
        raise ValueError(f"octaves must be in [0, {perlin_cuda.MAX_OCTAVES}]"
                         f", got {kw['octaves']}")
    xyscale = kw["xyscale"]
    if xyscale is None:
        xyscale = default_xyscale(n, radius)
    light = shade_mod._LIGHT if kw["light"] is None else kw["light"]
    lx, ly, lz = (np.float32(v) for v in light)
    ny = np.float32(2.0 * xyscale)
    k = np.float64(radius) * np.float64(kw["coord_scale"])
    k_hi = np.float32(k)
    return dict(n=n, row0=row0, rows=rows, kind=kw["kind"],
                octaves=int(kw["octaves"]),
                lacunarity=float(kw["lacunarity"]),
                gain=np.float32(kw["gain"]), k_hi=k_hi,
                k_lo=np.float32(k - np.float64(k_hi)),
                amp=np.float32(kw["amplitude"]), ny2=np.float32(ny * ny),
                nyly=np.float32(ny * ly), lx=lx, lz=lz)


def _heights_plain(face, rr, p, device):
    """Heights of face `face` at absolute rows rr (int64 (R,)) and every
    column: (R, n) f32, csrc/field.cu's `height` op for op."""
    n = p["n"]
    z = torch.zeros((), dtype=torch.float32, device=device)
    inv_n = float(np.float32(1.0 / n))
    cc = torch.arange(n, device=device)
    a = (2 * cc + (1 - n)).to(torch.float32) * inv_n           # (n,)
    b = ((2 * rr + (1 - n)).to(torch.float32) * inv_n)[:, None]  # (R, 1)
    s1, e1 = dfm.quick_two_sum(dfm.const(1.0, z), a * a)
    s2, e2 = dfm.quick_two_sum(s1, b * b)
    n2 = dfm.quick_two_sum(s2, e1 + e2)
    ih, il = dfm.div((dfm.const(p["k_hi"], z), dfm.const(p["k_lo"], z)),
                     dfm.sqrt(n2))
    coords = []
    for cj, aj, bj in _face_affine_np()[face]:
        q = (dfm.const(cj, z) + dfm.const(aj, z) * a) + dfm.const(bj, z) * b
        pr, e = dfm.two_prod(ih, q)
        e = e + il * q
        coords += dfm.quick_two_sum(pr, e)
    value = perlin.accumulate_octaves(p["kind"], p["octaves"],
                                      p["lacunarity"], p["gain"], *coords)
    return value * dfm.const(p["amp"], z)


def field_plain(n, radius, row0=0, rows=None, *, device="cuda", **kw):
    """Plain PyTorch version of the kernel: (heights, shade) of rows
    [row0, row0 + rows) of every face (default: all n rows), each
    (6, rows, n) f32, in bands of rows so that large n fit in memory.
    kw: FIELD_DEFAULTS' keys."""
    p = _params(n, radius, row0, rows, kw)
    n, row0, rows = p["n"], p["row0"], p["rows"]
    h_out = torch.empty((6, rows, n), dtype=torch.float32, device=device)
    s_out = torch.empty_like(h_out)
    band = max(1, PLAIN_BAND_TEXELS // n)
    for face in range(6):
        for lo in range(0, rows, band):
            hi = min(lo + band, rows)
            # the band's rows and a one-row halo on each side, clamped to
            # the face (edge replication)
            rr = torch.arange(row0 + lo - 1, row0 + hi + 1,
                              device=device).clamp(0, n - 1)
            ext = _heights_plain(face, rr, p, device)
            hc = ext[1:-1]
            left = torch.cat([hc[:, :1], hc[:, :-1]], dim=1)
            right = torch.cat([hc[:, 1:], hc[:, -1:]], dim=1)
            dx = left - right
            dy = ext[:-2] - ext[2:]
            inv_len = torch.reciprocal(sqrt_rn(
                (dx * dx + float(p["ny2"])) + dy * dy))
            dot = ((dx * float(p["lx"]) + float(p["nyly"]))
                   + dy * float(p["lz"])) * inv_len
            h_out[face, lo:hi] = hc
            s_out[face, lo:hi] = sqrt_rn(
                float(np.float32(0.001)) + torch.clamp_min(dot, 0.0))
    return h_out, s_out


