"""Static cube-sphere heightfield models (BASELINE configs 1, 2 and 5;
planet_tpu models/heightfield.py, ported).

Unlike the quadtree engine (engine.planet), these evaluate a whole
fixed-resolution heightfield: per-texel sphere position -> multi-octave
noise height -> central-difference normal -> Lambert shade. The flat patch
(config 1), the full 6-face cube sphere (config 2) and its row strips
(config 5: one strip at a time on one card, or a strip a rank through
parallel/sharded.py).

Entry points run on the card unless the caller passes device="cpu": the
kernels (K4 for the noise of given points, K5 for the whole-cube frame)
for a CUDA device, their plain versions for the CPU.

Reference anchors: terrain chain main.cpp:823-832, normal generation
main.cpp:338-346, shade main.cpp:369-381.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.nums.fp import sqrt_rn
from planet_tpu_torch.ops.kernels import field_cuda, perlin_cuda
from planet_tpu_torch.parallel import facemesh
from planet_tpu_torch.raster import shade as shade_mod
from planet_tpu_torch.utils import timing


class FieldOutput(NamedTuple):
    heights: torch.Tensor   # (..., H, W)
    normal: torch.Tensor    # (..., H, W, 3) tangent-space normal
    shade: torch.Tensor     # (..., H, W)


def noise_coords(px, py, pz, coord_scale):
    """The six f32 noise-space coordinates (x, y, z as DF hi/lo pairs) of
    double-float world positions: each scaled by coord_scale in DF."""
    z = px[0].new_zeros(())
    scale = tuple(dfm.const(x, z)
                  for x in dfm.from_f64_np(np.float64(coord_scale)))
    return tuple(t for p in (px, py, pz) for t in dfm.mul(p, scale))


def heights_df(px, py, pz, *, kind="ridged", octaves=6, lacunarity=2.0,
               gain=0.55, coord_scale=0.00001, amplitude=8848.0):
    """Noise heights at double-float world positions (DF `(hi, lo)` pairs
    of one shape): DF scale by coord_scale, K4 noise (its plain version on
    the CPU), times the amplitude."""
    h = perlin_cuda.noise_df(kind, *noise_coords(px, py, pz, coord_scale),
                             lacunarity=lacunarity, gain=np.float32(gain),
                             octaves=octaves)
    return h * dfm.const(amplitude, px[0].new_zeros(()))


def normals_from_heights(h_pad: torch.Tensor, xyscale) -> torch.Tensor:
    """Central-difference tangent-space normals (reference compute_normal,
    main.cpp:338-346): h_pad is the height grid with a 1-texel halo ring
    (overscanned or edge-replicated); output is for the interior (H, W).

    xyscale: world-space texel spacing."""
    x0 = h_pad[..., 1:-1, :-2]
    x1 = h_pad[..., 1:-1, 2:]
    y0 = h_pad[..., :-2, 1:-1]
    y1 = h_pad[..., 2:, 1:-1]
    n = torch.stack([x0 - x1, torch.full_like(x0, float(np.float32(
        2.0 * xyscale))), y0 - y1], dim=-1)
    return n / sqrt_rn(torch.sum(n * n, dim=-1, keepdim=True))


def frame_cube(n: int, radius: float, *, kind="ridged", octaves=6,
               lacunarity=2.0, gain=0.55, coord_scale=0.00001,
               amplitude=8848.0, fused=True, device="cuda"):
    """The full-cube frame step (BASELINE config 2): heights + Lambert
    shade of all six n x n faces, (6, n, n) each.

    fused=True runs the one-kernel algorithm (ops/kernels/field_cuda: K5 on
    a CUDA device, its plain version on the CPU — coordinates, noise,
    halo, normals and shade per texel, nothing but the two outputs in
    memory). fused=False composes the same frame from the general pieces
    (face_grid_points_df -> heights_df -> edge-padded central-difference
    normals -> lambert), the spec the fused kernel is held to."""
    with timing.span("field"):
        if fused:
            return field_cuda.field_cube(
                n, radius, kind=kind, octaves=octaves,
                lacunarity=lacunarity, gain=gain, coord_scale=coord_scale,
                amplitude=amplitude, device=device)
        px, py, pz = facemesh.face_grid_points_df(n, radius, device=device)
        h = heights_df(px, py, pz, kind=kind, octaves=octaves,
                       lacunarity=lacunarity, gain=gain,
                       coord_scale=coord_scale, amplitude=amplitude)
        h_rows = torch.cat([h[:, :1], h, h[:, -1:]], dim=1)
        h_pad = torch.cat([h_rows[:, :, :1], h_rows, h_rows[:, :, -1:]],
                          dim=2)
        normal = normals_from_heights(h_pad,
                                      field_cuda.default_xyscale(n, radius))
        return h, shade_mod.lambert(normal)


def field_from_padded_points(px, py, pz, xyscale, **noise_kw) -> FieldOutput:
    """Points include a 1-texel halo ring; heights are computed for the full
    padded grid locally (the reference's overscan strategy) and outputs
    cover the interior."""
    h_pad = heights_df(px, py, pz, **noise_kw)
    normal = normals_from_heights(h_pad, xyscale)
    return FieldOutput(heights=h_pad[..., 1:-1, 1:-1], normal=normal,
                       shade=shade_mod.lambert(normal))


def flat_patch_points(n: int, extent: float = 256.0, z: float = 0.0,
                      overscan: int = 1, *, device="cuda"):
    """Config 1: an n x n flat patch in the z-plane, texel centers, with
    halo ring. Returns DF point components, each an `(hi, lo)` pair of
    (n+2o, n+2o) f32 tensors, and the texel spacing."""
    o = int(overscan)
    idx = (np.arange(-o, n + o, dtype=np.float64) + 0.5) / n * extent
    u, v = np.meshgrid(idx, idx, indexing="xy")

    def df(x):
        return tuple(torch.as_tensor(a, device=device)
                     for a in dfm.from_f64_np(x))

    return df(u), df(np.full_like(u, z)), df(v), float(extent / n)
