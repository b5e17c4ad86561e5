"""Exact-coverage depth-tested triangle raster: triangle setup, the plain
fragment pass, and the packed framebuffer format (planet_tpu
raster/coverage.py, ported).

Semantics are planet_tpu's (see its module docstring): screen coordinates
snap to a 1/16-subpixel grid; coverage is three f32 edge functions with
the top-left fill rule folded into a per-edge accept bias of +-1/512;
z and normal*(1/w) interpolate affinely in screen space; shade is
sqrt(0.001 + max(0, n.l)); the depth test is a min over packed
(21-bit quantized NDC depth << 10 | 10-bit shade) int32 keys, LEQUAL with
ties to the darker shade. Near-plane straddlers are clipped geometrically
(raster/nearclip.py); far-straddlers (a vertex beyond far_w) reject
fragments with interpolated 1/w < 1/far_w.

`setup_t` builds the (32, N) triangle-record matrix the fragment kernels
read (planet_tpu coverage._setup_t, same row layout, same op order):

    0-8    edge constants (DX, DY, c) of the edges opposite vertices 0/1/2,
           relative to the bbox-min pixel centre
    9-11   z coefficients, 12-14 1/w coefficients, 15-23 normal*(1/w)
           coefficients (vertex-major x, y, z) — inv_area folded in
    24-27  clamped bbox px0, py0, px1, py1
    28     0 dead, -1 live, +1/far_w live far-straddler
    29-31  per-edge top-left accept bias

`fragments` is the plain fragment pass (planet_tpu coverage._fragments):
it expands every live record over its bbox and min-merges the accepted
fragments with `scatter_reduce(amin)`. It is what the CUDA raster kernels
(raster/coverage_cuda.py) are held to.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from planet_tpu_torch.nums.fp import sqrt_rn

_DEPTH_BITS = 21
_SHADE_BITS = 10
_EMPTY = 2**31 - 1              # background / no fragment
SNAP = 16.0                     # subpixel grid: 1/16 px
INV_SNAP = 1.0 / 16.0
FRONT_SIGN = 1.0                # y-down screen: front faces have area2 > 0
_W_MIN = float(np.float32(1e-9))
_LIGHT = np.array([0.0, 1.0, -1.0]) / np.sqrt(2.0)
LIGHT_Y = float(np.float32(_LIGHT[1]))
LIGHT_Z = float(np.float32(_LIGHT[2]))
_INT_MAX = 2**31 - 1

# bound on (record, pixel) pairs expanded at once by the plain fragment pass
_FRAG_CHUNK = 1 << 20


class RasterCounters(NamedTuple):
    """The raster's counters, tensors on the raster's device (as
    planet_tpu's are device arrays): reading one is the caller's host
    read."""

    n_tris: torch.Tensor       # () int32 live (kept, front-facing,
                               # on-screen) triangles
    n_per_class: torch.Tensor  # (2,) int32 span-kernel, huge-kernel
                               # triangles
    n_huge: torch.Tensor       # () int32 live triangles the huge kernel
                               # rasterizes
    overflowed: torch.Tensor   # () bool more straddlers than clip_cap
    n_straddle: torch.Tensor   # () int32 near-plane straddlers


class Tris(NamedTuple):
    """Per-triangle setup, all (N,) or (N, 3) / (N, 3, 3) tensors."""

    x: torch.Tensor        # (N, 3) snapped screen x per vertex
    y: torch.Tensor        # (N, 3)
    z: torch.Tensor        # (N, 3) NDC z
    iw: torch.Tensor       # (N, 3) 1/w
    niw: torch.Tensor      # (N, 3, 3) normal * (1/w)
    inv_area: torch.Tensor  # (N,)
    px0: torch.Tensor      # (N,) int32 clamped bbox
    py0: torch.Tensor
    px1: torch.Tensor
    py1: torch.Tensor
    live: torch.Tensor     # (N,) bool
    ilim: torch.Tensor     # (N,) f32 fragment 1/w floor (-1 = no far clip)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA's convert does: truncating toward zero,
    saturating out of range, and NaN -> 0 (a bare .to(torch.int32) wraps
    on the CPU and turns NaN into INT_MIN)."""
    big = x >= 2.0**31
    val = torch.clamp(x, min=-(2.0**31), max=2.0**31 - 128).to(torch.int32)
    val = torch.where(torch.isnan(x), torch.zeros_like(val), val)
    return torch.where(big, torch.full_like(val, _INT_MAX), val)


def project(clip, valid, width: int, height: int):
    """Per-vertex projection shared by setup_t and nearclip.setup_tris:
    (ok_w, inv_w, snapped sx, snapped sy) with planet_tpu's op order."""
    w4 = clip[..., 3]
    ok_w = valid & (w4 > _W_MIN)
    one = torch.ones_like(w4)
    inv_w = torch.where(ok_w, 1.0 / torch.where(ok_w, w4, one),
                        torch.zeros_like(w4))
    sx = (clip[..., 0] * inv_w * 0.5 + 0.5) * float(width)
    sy = (0.5 - clip[..., 1] * inv_w * 0.5) * float(height)
    sx = torch.round(sx * SNAP) * INV_SNAP
    sy = torch.round(sy * SNAP) * INV_SNAP
    return ok_w, inv_w, sx, sy


def bbox(x0, x1, x2, y0, y1, y2, width: int, height: int):
    """Clamped pixel bbox of pixel centres inside the triangle's extent."""
    min_x = torch.minimum(torch.minimum(x0, x1), x2)
    max_x = torch.maximum(torch.maximum(x0, x1), x2)
    min_y = torch.minimum(torch.minimum(y0, y1), y2)
    max_y = torch.maximum(torch.maximum(y0, y1), y2)
    px0 = torch.clamp_min(to_i32(torch.ceil(min_x - 0.5)), 0)
    px1 = torch.clamp_max(to_i32(torch.floor(max_x - 0.5)), width - 1)
    py0 = torch.clamp_min(to_i32(torch.ceil(min_y - 0.5)), 0)
    py1 = torch.clamp_max(to_i32(torch.floor(max_y - 0.5)), height - 1)
    return px0, py0, px1, py1


def edge_consts(xa, ya, xb, yb, ox, oy):
    """Edge a->b: (DX, DY, c relative to the bbox-min pixel centre
    (ox, oy), top-left accept bias)."""
    DX = (xb - xa) * FRONT_SIGN
    DY = (yb - ya) * FRONT_SIGN
    c = DX * (oy - ya) - DY * (ox - xa)
    topleft = (DY < 0.0) | ((DY == 0.0) & (DX > 0.0))
    bias = torch.where(topleft, torch.full_like(DX, -1 / 512),
                       torch.full_like(DX, 1 / 512))
    return DX, DY, c, bias


def tri3(a, q: int, g: int):
    """(Q, G, G) per-vertex array -> three (N,) per-triangle vertex arrays,
    N = 2*Q*G*G, in planet_tpu's parity-major candidate order: cell (r, c)
    gives T0 = (g00, g10, g01) and T1 = (g01, g10, g11); corners come from
    lane rotations, whose wrap only touches dead last-row/column cells."""
    a = a.reshape(q, g * g)
    g10 = torch.roll(a, -g, dims=1)
    g01 = torch.roll(a, -1, dims=1)
    g11 = torch.roll(g10, -1, dims=1)

    def st(p0, p1):
        return torch.cat([p0, p1], dim=0).reshape(-1)

    return st(a, g01), st(g10, g10), st(g01, g11)


@functools.lru_cache(maxsize=None)
def _cell_table(g: int, mask_key, device: str) -> torch.Tensor:
    cell_ok = np.zeros((g, g), bool)
    cell_ok[:g - 1, :g - 1] = True
    full = np.broadcast_to(cell_ok[None], (2, g, g)).copy()
    if mask_key is not None:
        shape, bits = mask_key
        full[:, :g - 1, :g - 1] &= np.frombuffer(bits, bool).reshape(shape)
    return torch.tensor(full, device=device)


def _mask_key(cell_mask):
    if cell_mask is None:
        return None
    m = np.ascontiguousarray(cell_mask, bool)
    return m.shape, m.tobytes()


def cell_table(g: int, cell_mask, device) -> torch.Tensor:
    """(2, G, G) bool: the drawn cell triangles of one patch by parity
    (cell_mask, (2, G-1, G-1)), never the wrap-padding cells of the last
    grid row/column. A device tensor built once per (g, mask, device) and
    cached: the eager warm-up before a CUDA-graph capture uploads it, and
    no frame copies it from the host again. Callers must not write it."""
    return _cell_table(g, _mask_key(cell_mask), str(torch.device(device)))


@functools.lru_cache(maxsize=16)       # PlanetEngine's Q varies by frame
def _cell_ok(q: int, g: int, mask_key, device: str) -> torch.Tensor:
    table = _cell_table(g, mask_key, device)
    return table[:, None].expand(2, q, g, g).reshape(-1).clone()


def cell_ok_mask(q: int, g: int, cell_mask, device):
    """(N,) bool: cell_table for every patch of a Q-patch batch, in
    setup_t's candidate order. Cached per (q, g, mask, device) as
    cell_table is."""
    return _cell_ok(q, g, _mask_key(cell_mask), str(torch.device(device)))


def setup_t(clip, normal, valid, width: int, height: int, cell_mask=None,
            far_w=None):
    """Project, snap, cull and bbox every cell triangle of a patch batch.

    clip (Q, G, G, 4), normal (Q, G, G, 3), valid (Q, G, G) bool.
    Returns (tm (32, N) f32 record matrix, live (N,) bool, span (N,) int32
    — how many aligned 8-row blocks the clamped bbox touches)."""
    ok_w, inv_w, sx, sy = project(clip, valid, width, height)
    w4 = clip[..., 3]
    z = clip[..., 2] * inv_w
    nxw = normal[..., 0] * inv_w
    nyw = normal[..., 1] * inv_w
    nzw = normal[..., 2] * inv_w
    q, g = w4.shape[0], w4.shape[1]

    x0, x1, x2 = tri3(sx, q, g)
    y0, y1, y2 = tri3(sy, q, g)
    z0, z1, z2 = tri3(z, q, g)
    w0, w1, w2 = tri3(inv_w, q, g)
    nx0, nx1, nx2 = tri3(nxw, q, g)
    ny0, ny1, ny2 = tri3(nyw, q, g)
    nz0, nz1, nz2 = tri3(nzw, q, g)
    o0, o1, o2 = tri3(ok_w, q, g)
    tri_ok = o0 & o1 & o2 & cell_ok_mask(q, g, cell_mask, clip.device)

    area2 = ((x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)) * FRONT_SIGN
    front = area2 > 0.0
    px0, py0, px1, py1 = bbox(x0, x1, x2, y0, y1, y2, width, height)
    nonempty = (px0 <= px1) & (py0 <= py1)
    live = tri_ok & front & nonempty
    one = torch.ones_like(area2)
    inv_area = torch.where(live, 1.0 / torch.where(live, area2, one),
                           torch.zeros_like(area2))

    ox = px0.to(torch.float32) + 0.5
    oy = py0.to(torch.float32) + 0.5
    dx0, dy0, c0, b0 = edge_consts(x1, y1, x2, y2, ox, oy)
    dx1, dy1, c1, b1 = edge_consts(x2, y2, x0, y0, ox, oy)
    dx2, dy2, c2, b2 = edge_consts(x0, y0, x1, y1, ox, oy)

    if far_w is not None:
        fw = float(np.float32(far_w))
        wv0, wv1, wv2 = tri3(w4, q, g)
        far = (wv0 > fw) | (wv1 > fw) | (wv2 > fw)
        ilim = torch.where(far, torch.full_like(area2, float(np.float32(1.0 / far_w))),
                           torch.full_like(area2, -1.0))
    else:
        ilim = torch.full_like(area2, -1.0)
    rows = [dx0, dy0, c0, dx1, dy1, c1, dx2, dy2, c2,
            z0 * inv_area, z1 * inv_area, z2 * inv_area,
            w0 * inv_area, w1 * inv_area, w2 * inv_area,
            nx0 * inv_area, ny0 * inv_area, nz0 * inv_area,
            nx1 * inv_area, ny1 * inv_area, nz1 * inv_area,
            nx2 * inv_area, ny2 * inv_area, nz2 * inv_area,
            px0.to(torch.float32), py0.to(torch.float32),
            px1.to(torch.float32), py1.to(torch.float32),
            live.to(torch.float32) * ilim,
            b0, b1, b2]
    tm = torch.stack([r.to(torch.float32) for r in rows], dim=0)
    span = (py1 // 8) - (py0 // 8) + 1
    return tm.contiguous(), live, span


def fragments(records, fb, *, iw_test: bool, wireframe: bool = False):
    """Plain fragment pass: rasterize (M, 32) row records into the packed
    (H, W) int32 framebuffer `fb` in place (scatter_reduce amin) and
    return it. iw_test=True adds the interpolated-1/w tests (iw > 0 and
    the far clip iw > row 28) that the huge kernel applies; the span kernel
    omits them (provably vacuous inside the exact coverage domain, see
    planet_tpu coverage._fragments)."""
    height, width = fb.shape
    recs = records[records[:, 28] != 0.0]
    if recs.shape[0] == 0:
        return fb
    px0 = recs[:, 24].to(torch.int64)
    py0 = recs[:, 25].to(torch.int64)
    bw = recs[:, 26].to(torch.int64) - px0 + 1
    bh = recs[:, 27].to(torch.int64) - py0 + 1
    area = (bw * bh).cpu()
    ends = torch.cumsum(area, 0)
    flat = fb.view(-1)
    start = 0
    m = recs.shape[0]
    while start < m:
        base = int(ends[start - 1]) if start else 0
        stop = int(torch.searchsorted(ends, base + _FRAG_CHUNK, right=True))
        stop = max(stop, start + 1)
        sel = torch.arange(start, stop, device=recs.device)
        cnt = area[start:stop].to(recs.device)
        rep = torch.repeat_interleave(sel, cnt)
        first = torch.cumsum(cnt, 0) - cnt
        local = torch.arange(rep.shape[0], device=recs.device) \
            - torch.repeat_interleave(first, cnt)
        ry_i = local // bw[rep]
        rx_i = local - ry_i * bw[rep]
        _merge(flat, recs[rep], px0[rep] + rx_i, py0[rep] + ry_i,
               rx_i.to(torch.float32), ry_i.to(torch.float32), width,
               iw_test, wireframe)
        start = stop
    return fb


def _merge(flat, r, px, py, rx, ry, width, iw_test, wireframe):
    """Fragment math for (F,) (record, pixel) pairs; min-merge the
    accepted ones. Op order is the CUDA kernels' (csrc/raster.cu)."""
    def edge(k):
        e = (r[:, 3 * k] * ry - r[:, 3 * k + 1] * rx) + r[:, 3 * k + 2]
        return e, e > r[:, 29 + k]

    e0, a0 = edge(0)
    e1, a1 = edge(1)
    e2, a2 = edge(2)
    inside = a0 & a1 & a2
    if wireframe:
        def on_edge(e, k):
            e2w = e + e
            DX, DY = r[:, 3 * k], r[:, 3 * k + 1]
            return e2w * e2w <= DX * DX + DY * DY

        inside = inside & (on_edge(e0, 0) | on_edge(e1, 1) | on_edge(e2, 2))

    def interp(c):
        return (e0 * r[:, c] + e1 * r[:, c + 1]) + e2 * r[:, c + 2]

    z = interp(9)
    ok = inside & (z >= -1.0)
    if iw_test:
        iw = interp(12)
        ok = ok & (iw > 0.0) & (iw > r[:, 28])
    keep = torch.nonzero(ok).squeeze(1)
    r, e0, e1, e2, z = r[keep], e0[keep], e1[keep], e2[keep], z[keep]

    def interp_n(c):
        return (e0 * r[:, c] + e1 * r[:, c + 3]) + e2 * r[:, c + 6]

    nx, ny, nz = interp_n(15), interp_n(16), interp_n(17)
    nlen = sqrt_rn((nx * nx + ny * ny) + nz * nz)
    ndl = (ny * LIGHT_Y + nz * LIGHT_Z) / torch.where(
        nlen > 0.0, nlen, torch.ones_like(nlen))
    shade = sqrt_rn(0.001 + torch.where(ndl < 0.0, torch.zeros_like(ndl),
                                      ndl))
    # a NaN shade (an infinite edge word) packs as 0, as XLA converts it
    zq = to_i32(torch.clamp_max((z * 0.5 + 0.5) * float(2**_DEPTH_BITS - 1),
                                float(2**_DEPTH_BITS - 2)))
    sq = to_i32(torch.clamp_max(shade * float(2**_SHADE_BITS - 1),
                                float(2**_SHADE_BITS - 1)))
    packed = (zq << _SHADE_BITS) | sq
    idx = py[keep] * width + px[keep]
    flat.scatter_reduce_(0, idx, packed, reduce="amin")


@functools.lru_cache(maxsize=None)
def _const(value: float, device: str) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def _div(x: torch.Tensor, d: int) -> torch.Tensor:
    """x / d correctly rounded on every device: CUDA divides by a Python
    number as a multiply by its reciprocal, so the divisor is a 0-dim
    tensor on x's device, made once per device and cached (the eager
    warm-up before a capture makes it)."""
    return x / _const(float(d), str(x.device))


def decode_packed(img_packed, background: float = 0.0):
    """(H, W) packed int32 framebuffer -> (image, depth): shade in [0, 1]
    and NDC depth, with `background` / +inf where nothing was drawn (the
    same bits on every device, and planet_tpu's)."""
    empty = img_packed == _EMPTY
    shade = _div((img_packed & (2**_SHADE_BITS - 1)).to(torch.float32),
                 2**_SHADE_BITS - 1)
    image = torch.where(empty, torch.full_like(shade, background), shade)
    depth = _div((img_packed >> _SHADE_BITS).to(torch.float32),
                 2**_DEPTH_BITS - 1) * 2.0 - 1.0
    depth = torch.where(empty, torch.full_like(depth, float("inf")), depth)
    return image, depth
