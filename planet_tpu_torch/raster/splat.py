"""Depth-tested splat raster (planet_tpu raster/splat.py, ported).

The approximate raster of `raster_mode="splat"`: every patch grid vertex
(or, with `upsample_cells`, every one of k x k bilinear points a grid
cell) becomes one fragment, depth-tested with one scatter-min of packed
int32 keys, then `fill_rounds` 3x3 min hole fills close the gaps between
splats. The exact edge/area raster is raster/coverage_cuda.py.

Keys are coverage.py's: 21-bit quantized NDC depth << 10 | 10-bit shade,
so min() keeps the nearest fragment and its shade rides along, and they
decode with coverage.decode_packed. Every
float -> int32 conversion goes through coverage.to_i32, which converts as
XLA does (truncate, saturate, NaN -> 0), so the keys equal planet_tpu's
bit for bit on the same inputs.

planet_tpu writes the splat in XLA, not Pallas. The engines' splat
(`splat_keys`: upsample, project, pack, depth test) is one hand-written
CUDA kernel on the card (csrc/splat.cu, launch key "splat": a thread, or
two lanes, a grid cell walking its fragments through a weight table in
`weights`' order, formed at `table_slot`), because the composed torch ops
took most of a 1080p splat frame there; on CPU tensors
it runs `splat_keys_plain` — `upsample_cells`, then `pack_keys`'s
projection, packing and one scatter_reduce "amin" — which the kernel
equals bit for bit. `splat_frame` is planet_tpu's API on fragments
already upsampled (any leading shape), in plain PyTorch. Nothing here
reads a tensor value on the host, so a frame queues on the card with no
synchronisation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.raster.coverage import (_EMPTY, _W_MIN, decode_packed,
                                             to_i32)

_DEPTH_BITS = 21
_SHADE_BITS = 10


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


def splat_frame(clip, shade, valid, width: int, height: int,
                background: float = 0.0, fill_rounds: int = 1):
    """clip (..., 4) clip positions, shade (...) grayscale, valid (...)
    bool. Returns (H, W) f32 image and (H, W) f32 depth (NDC z, +inf where
    nothing was drawn)."""
    img_packed = pack_keys(clip, shade, valid, width, height)
    for _ in range(fill_rounds):
        img_packed = _fill_holes(img_packed)
    return decode_packed(img_packed, background)


@functools.lru_cache(maxsize=None)
def weights(k: int, wireframe: bool = False):
    """The bilinear weights (w00, w01, w10, w11) of each upsampled point of
    a cell, in upsample_cells' order (i rows, j columns; with wireframe
    only i == 0 or j == 0), as planet_tpu's f32 constants. Inclusive [0, 1]
    sampling: a cell edge is covered from both neighbouring cells, closing
    seams (the duplicates depth-test away)."""
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


def table_slot(i: int, j: int, k: int, wireframe: bool = False) -> int:
    """The position of point (i, j) of a cell's k x k points in `weights`'
    order (rows i, columns j; with wireframe the row i == 0, then the
    column j == 0 below it), -1 for a point wireframe drops: where the
    splat kernel's block stores the point's weights in its table
    (csrc/splat.cu:table_slot), with no division."""
    if not wireframe:
        return i * k + j
    if i == 0:
        return j
    return k + i - 1 if j == 0 else -1


def upsample_cells(clip, shade, valid, k: int, wireframe: bool = False):
    """Cell-level bilinear supersampling: every grid cell gives k*k points
    interpolated between its four corners instead of its corner vertices
    alone. clip (..., G, G, 4), shade (..., G, G), valid (..., G, G) ->
    (clip (..., G-1, G-1, F, 4), shade (..., G-1, G-1, F), valid the
    shade's shape), F = k*k.

    wireframe=True keeps only the cell-edge points (i == 0 or j == 0, F =
    2k - 1; the reference's key-P line mode, main.cpp:980-985). At k <= 1
    the inputs pass through unchanged, so wireframe needs k >= 2 (the
    engines raise k to 2 when wireframe is on).

    The weights are planet_tpu's f32 constants and each weighted sum is
    separate multiplies and adds in its order, so no product is fused."""
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
    shifted minimums over an EMPTY-padded copy, exact on int32 on every
    device."""
    h, w = img_packed.shape
    pad = img_packed.new_full((h + 2, w + 2), _EMPTY)
    pad[1:h + 1, 1:w + 1] = img_packed
    neigh = pad[1:h + 1, 1:w + 1]
    for dy in range(3):
        for dx in range(3):
            if (dy, dx) != (1, 1):
                neigh = torch.minimum(neigh, pad[dy:dy + h, dx:dx + w])
    return torch.where(img_packed == _EMPTY, neigh, img_packed)


def _check_grid(clip, shade, valid):
    """Shapes and types of splat_keys' (Q, G, G) operands (metadata only)."""
    q, g = clip.shape[0], clip.shape[1]
    if tuple(clip.shape) != (q, g, g, 4) or g < 2:
        raise ValueError(f"clip must be (Q, G, G, 4), got {tuple(clip.shape)}")
    if tuple(shade.shape) != (q, g, g) or tuple(valid.shape) != (q, g, g):
        raise ValueError("shade and valid must be (Q, G, G)")
    if clip.dtype != torch.float32 or shade.dtype != torch.float32:
        raise ValueError("clip and shade must be torch.float32")
    if valid.dtype != torch.bool:
        raise ValueError("valid must be torch.bool")


def splat_keys_plain(clip, shade, valid, width: int, height: int, k: int = 1,
                     wireframe: bool = False):
    """Plain PyTorch version of the splat kernel: (Q, G, G) grids -> (H, W)
    int32 keys (upsample_cells, then pack_keys)."""
    _check_grid(clip, shade, valid)
    return pack_keys(*upsample_cells(clip, shade, valid, k, wireframe),
                     width, height)


def splat_keys_cuda(clip, shade, valid, width: int, height: int, k: int = 1,
                    wireframe: bool = False):
    """The CUDA kernel (csrc/splat.cu); same signature as splat_keys_plain,
    k <= 32 (the kernel's weight table in shared memory)."""
    _check_grid(clip, shade, valid)
    if k > 32:
        raise ValueError(f"supersample {k}: the splat kernel takes k <= 32")
    clip, shade, valid = (t.contiguous() for t in (clip, shade, valid))
    if clip.data_ptr() % 16:               # read as float4
        clip = clip.clone()
    _cuda.check_cuda(clip, "clip", torch.float32)
    _cuda.check_cuda(shade, "shade", torch.float32)
    _cuda.check_cuda(valid, "valid", torch.bool)
    q, g = clip.shape[0], clip.shape[1]
    fb = torch.full((height, width), _EMPTY, dtype=torch.int32,
                    device=clip.device)
    _cuda.launch("splat", "planet_splat", clip.data_ptr(), shade.data_ptr(),
                 valid.data_ptr(), q, g, int(k), int(bool(wireframe)), width,
                 height, fb.data_ptr())
    return fb


def splat_keys(clip, shade, valid, width: int, height: int, k: int = 1,
               wireframe: bool = False):
    """(Q, G, G) patch grids of clip positions, shades and validity ->
    (H, W) int32 packed keys of the upsampled (k x k a cell), projected,
    depth-tested fragments: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if clip.device.type == "cuda":
        return splat_keys_cuda(clip, shade, valid, width, height, k,
                               wireframe)
    if clip.device.type != "cpu":
        raise ValueError(f"unsupported device {clip.device}")
    return splat_keys_plain(clip, shade, valid, width, height, k, wireframe)
