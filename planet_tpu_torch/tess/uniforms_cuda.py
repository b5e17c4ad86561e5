"""U1, the fused frame's uniforms as one kernel (csrc/uniforms.cu): the
port's counterpart of the XLA fusion of planet_tpu's geometry step that
makes the vertex program's per-row inputs (engine/device_step.py:242-263).

* uniforms(q_lo, q_hi, crop, depth, corners_hi, corners_lo, cam_hi,
  cam_lo, max_skirt) -> Uniforms: for R rows (q_lo, q_hi, depth (R,)
  int32, crop (R,) bool, corners_hi, corners_lo (12, R) f32 corner-major,
  cam_hi, cam_lo (3,) f32 the camera's DF position) the crop variants
  from the id's child index, the camera-relative corners (the DF
  subtract's hi word), the corner normals and the skirt.

The dispatcher launches the kernel for CUDA tensors (or raises) and runs
the plain version, `uniforms_plain`, for CPU tensors; the kernel equals it
bit for bit. The normals are the corners over the correctly rounded root
of (x x + y y) + z z (nums.fp.sqrt_rn), planet_tpu's order of the sum; a
padding row's zero corners give 0 / 0, on the card the NaN word
0x7fffffff in both. The skirt is max_skirt / exp2(depth) below depth 2,
an exact power-of-two divisor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.geom import quadid
from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.nums.fp import sqrt_rn

_I32 = torch.int32


class Uniforms(NamedTuple):
    corners_rel: torch.Tensor   # (R, 4, 3) f32
    normals: torch.Tensor       # (R, 4, 3) f32
    vx: torch.Tensor            # (R,) int32 crop variant selectors
    vy: torch.Tensor
    skirt: torch.Tensor         # (R,) f32


def uniforms_plain(q_lo, q_hi, crop, depth, corners_hi, corners_lo, cam_hi,
                   cam_lo, max_skirt: float) -> Uniforms:
    """U1's plain version."""
    rows = q_lo.shape[0]
    c_hi, c_lo = (c.reshape(4, 3, rows).permute(2, 0, 1)
                  for c in (corners_hi, corners_lo))
    # crop quadrant by child index (main.cpp:216-237) as blend-matrix
    # variant selectors
    child = quadid.words_child_index(q_lo, q_hi)
    vx = torch.where(crop, 1 + (child & 1), 0)
    vy = torch.where(crop, 1 + ((child >> 1) & 1), 0)
    # camera-relative f32 corners: DF subtract, then narrow
    # (main.cpp:666-672)
    corners_rel = dfm.sub((c_hi, c_lo), (cam_hi, cam_lo))[0]
    nrm = c_hi + c_lo
    x, y, z = nrm.unbind(-1)
    normals = nrm / sqrt_rn((x * x + y * y) + z * z)[..., None]
    d1 = (depth - 1).to(torch.float32)
    skirt_max = dfm.const(max_skirt, c_hi)
    skirt = torch.where(d1 > 0, skirt_max / torch.exp2(d1 + 1.0), skirt_max)
    return Uniforms(corners_rel, normals, vx, vy, skirt)


def uniforms_cuda(q_lo, q_hi, crop, depth, corners_hi, corners_lo, cam_hi,
                  cam_lo, max_skirt: float) -> Uniforms:
    rows = q_lo.shape[0]
    for t, name in ((q_lo, "q_lo"), (q_hi, "q_hi"), (depth, "depth")):
        _cuda.check_cuda(t, name, _I32, (rows,))
    _cuda.check_cuda(crop, "crop", torch.bool, (rows,))
    _cuda.check_cuda(corners_hi, "corners_hi", torch.float32, (12, rows))
    _cuda.check_cuda(corners_lo, "corners_lo", torch.float32, (12, rows))
    _cuda.check_cuda(cam_hi, "cam_hi", torch.float32, (3,))
    _cuda.check_cuda(cam_lo, "cam_lo", torch.float32, (3,))
    dev = q_lo.device
    for t in (q_hi, crop, depth, corners_hi, corners_lo, cam_hi, cam_lo):
        if t.device != dev:
            raise ValueError(f"expected every operand on {dev}, got "
                             f"{t.device}")

    def out(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    res = Uniforms(corners_rel=out(rows, 4, 3), normals=out(rows, 4, 3),
                   vx=out(rows, dtype=_I32), vy=out(rows, dtype=_I32),
                   skirt=out(rows))
    if rows:
        _cuda.launch("uniforms", "planet_uniforms", q_lo.data_ptr(),
                     q_hi.data_ptr(), crop.data_ptr(), depth.data_ptr(),
                     corners_hi.data_ptr(), corners_lo.data_ptr(),
                     cam_hi.data_ptr(), cam_lo.data_ptr(), rows,
                     float(np.float32(max_skirt)), res.vx.data_ptr(),
                     res.vy.data_ptr(), res.corners_rel.data_ptr(),
                     res.normals.data_ptr(), res.skirt.data_ptr())
    return res


def uniforms(q_lo, q_hi, crop, depth, corners_hi, corners_lo, cam_hi,
             cam_lo, max_skirt: float) -> Uniforms:
    if q_lo.device.type == "cuda":
        return uniforms_cuda(q_lo, q_hi, crop, depth, corners_hi,
                             corners_lo, cam_hi, cam_lo, max_skirt)
    if q_lo.device.type != "cpu":
        raise ValueError(f"unsupported device {q_lo.device}")
    return uniforms_plain(q_lo, q_hi, crop, depth, corners_hi, corners_lo,
                          cam_hi, cam_lo, max_skirt)
