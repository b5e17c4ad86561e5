"""Depth-tested splat raster (planet_tpu raster/splat.py, ported): the
plain versions of the splat raster mode, with the back-face cull
(engine/planet.splat_valid) beside them.

Every patch grid cell gives k x k bilinear points between its four
corners (`upsample_cells`), each one fragment; `pack_keys` projects them
and depth-tests them with one scatter-min of packed int32 keys (21-bit
quantized NDC depth << 10 | 10-bit shade, coverage.py's format, so min()
keeps the nearest fragment and its shade rides along); `_fill_holes`
closes the gaps between splats with one 3x3 min round. Every float ->
int32 conversion goes through coverage.to_i32 (truncate, saturate,
NaN -> 0), and the fill and the depth test compare int32 keys alone.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from perfbench.reference.frozen.raster.coverage import (_EMPTY, _W_MIN,
                                                         to_i32)

_DEPTH_BITS = 21
_SHADE_BITS = 10


def splat_valid(pv, valid):
    """valid without the vertices whose outward sphere normal faces away
    from the camera (the reference's CW front-face cull, main.cpp:811-816),
    the dot product summed in one fixed order."""
    w, n = pv.world, pv.snormal
    return valid & (((w[..., 0] * n[..., 0] + w[..., 1] * n[..., 1])
                     + w[..., 2] * n[..., 2]) < 0.0)


def pack_keys(clip, shade, valid, width: int, height: int):
    """Project, pack and depth-test fragments: clip (..., 4), shade (...),
    valid (...) bool -> (H, W) int32 keys (EMPTY where no fragment
    landed): one scatter-min into an (H*W + 1) buffer whose last slot
    takes the culled fragments."""
    w4 = clip[..., 3]
    ok = valid & (w4 > _W_MIN)
    one = torch.ones_like(w4)
    inv_w = torch.where(ok, 1.0 / torch.where(ok, w4, one),
                        torch.zeros_like(w4))
    ndc_x = clip[..., 0] * inv_w
    ndc_y = clip[..., 1] * inv_w
    ndc_z = clip[..., 2] * inv_w

    px = to_i32(torch.floor((ndc_x * 0.5 + 0.5) * float(width)))
    py = to_i32(torch.floor((0.5 - ndc_y * 0.5) * float(height)))
    inb = (ok & (px >= 0) & (px < width) & (py >= 0) & (py < height)
           & (ndc_z >= -1.0) & (ndc_z <= 1.0))

    zmax = float(2**_DEPTH_BITS - 1)
    smax = float(2**_SHADE_BITS - 1)
    zq = to_i32(torch.clamp((ndc_z * 0.5 + 0.5) * zmax, 0.0, zmax))
    sq = to_i32(torch.clamp(shade * smax, 0.0, smax))
    packed = (zq << _SHADE_BITS) | sq

    n_pix = width * height
    idx = torch.where(inb, py.long() * width + px.long(),
                      torch.full_like(px, n_pix, dtype=torch.long))
    buf = torch.full((n_pix + 1,), _EMPTY, dtype=torch.int32,
                     device=clip.device)
    buf.scatter_reduce_(0, idx.reshape(-1), packed.reshape(-1),
                        reduce="amin")
    return buf[:n_pix].reshape(height, width)


@functools.lru_cache(maxsize=None)
def weights(k: int, wireframe: bool = False):
    """The bilinear weights (w00, w01, w10, w11) of each upsampled point of
    a cell, in upsample_cells' order (i rows, j columns; with wireframe
    only i == 0 or j == 0), as planet_tpu's f32 constants. Inclusive [0, 1]
    sampling: a cell edge is covered from both neighbouring cells."""
    one = np.float32(1.0)
    out = []
    for i in range(k):
        for j in range(k):
            if wireframe and i != 0 and j != 0:
                continue
            fu = np.float32(j / (k - 1))
            fv = np.float32(i / (k - 1))
            out.append(tuple(float(w) for w in (
                (one - fu) * (one - fv), fu * (one - fv), (one - fu) * fv,
                fu * fv)))
    return tuple(out)


def upsample_cells(clip, shade, valid, k: int, wireframe: bool = False):
    """Cell-level bilinear supersampling: clip (..., G, G, 4), shade (...,
    G, G), valid (..., G, G) -> (clip (..., G-1, G-1, F, 4), shade (...,
    G-1, G-1, F), valid the shade's shape), F = k*k (2k - 1 cell-edge
    points with wireframe); a cell is valid where its four corners are. At
    k <= 1 the inputs pass through. Each weighted sum is separate
    multiplies and adds in its order, so no product is fused."""
    if k <= 1:
        return clip, shade, valid

    def corners(a):
        return (a[..., :-1, :-1, :], a[..., :-1, 1:, :],
                a[..., 1:, :-1, :], a[..., 1:, 1:, :])

    c00, c01, c10, c11 = corners(clip)
    s00, s01, s10, s11 = corners(shade[..., None])
    v = (valid[..., :-1, :-1] & valid[..., :-1, 1:]
         & valid[..., 1:, :-1] & valid[..., 1:, 1:])

    outs_c, outs_s = [], []
    for w00, w01, w10, w11 in weights(k, wireframe):
        outs_c.append(c00 * w00 + c01 * w01 + c10 * w10 + c11 * w11)
        outs_s.append(s00 * w00 + s01 * w01 + s10 * w10 + s11 * w11)
    clip_up = torch.stack(outs_c, dim=-2)            # (..., G-1, G-1, F, 4)
    shade_up = torch.stack(outs_s, dim=-2)[..., 0]   # (..., G-1, G-1, F)
    valid_up = v[..., None].expand(shade_up.shape)
    return clip_up, shade_up, valid_up


def _fill_holes(img_packed):
    """Fill empty pixels with the nearest-depth key of their 3x3 window
    (planet_tpu's reduce_window min with SAME padding of EMPTY): nine
    shifted minimums over an EMPTY-padded copy, exact on int32."""
    h, w = img_packed.shape
    pad = img_packed.new_full((h + 2, w + 2), _EMPTY)
    pad[1:h + 1, 1:w + 1] = img_packed
    neigh = pad[1:h + 1, 1:w + 1]
    for dy in range(3):
        for dx in range(3):
            if (dy, dx) != (1, 1):
                neigh = torch.minimum(neigh, pad[dy:dy + h, dx:dx + w])
    return torch.where(img_packed == _EMPTY, neigh, img_packed)


def splat_keys_plain(clip, shade, valid, width: int, height: int, k: int = 1,
                     wireframe: bool = False):
    """(Q, G, G) grids -> (H, W) int32 keys: upsample_cells, then
    pack_keys."""
    return pack_keys(*upsample_cells(clip, shade, valid, k, wireframe),
                     width, height)
