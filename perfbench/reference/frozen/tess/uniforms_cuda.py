"""The fused frame's uniforms, plain (U1's version): `uniforms_plain`.

For R rows (q_lo, q_hi, depth (R,) int32, crop (R,) bool, corners_hi,
corners_lo (12, R) f32 corner-major, cam_hi, cam_lo (3,) f32 the camera's
DF position) it makes the crop variants from the id's child index, the
camera-relative corners (the DF subtract's hi word), the corner normals
and the skirt. The normals are the corners over the correctly rounded
root of (x x + y y) + z z (nums.fp.sqrt_rn), planet_tpu's order of the
sum; a padding row's zero corners give 0 / 0. The skirt is max_skirt /
exp2(depth) below depth 2, an exact power-of-two divisor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference.frozen.geom import quadid
from perfbench.reference.frozen.nums import df as dfm
from perfbench.reference.frozen.nums.fp import sqrt_rn

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


