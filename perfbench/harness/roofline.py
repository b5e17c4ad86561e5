"""The least time of a kernel's work on one H100 SXM, frozen from the
port's attribution tools (planet_tpu_torch/tools/common.py and
chip_smoke.py's OPS_FIELD_TEXEL, as of the commit that added this
benchmark), so that a later change to the program cannot move the
yardstick.

Rates (NVIDIA's data sheet and the CUDA C++ Programming Guide's
throughput table for compute capability 9.0): HBM at 3.35 TB/s; on each
of 132 SMs a clock, 128 f32 results (the kernels are built with
-fmad=false, so none is fused) and 64 f64 results, at the data sheet's
1980 MHz. Operations are counted from the kernels' sources as the least
work of the function (tools/common.py's comments give each count)."""

from __future__ import annotations

PEAK_BYTES = 3.35e12
SMS = 132
F32_PER_SM_CLOCK = 128
F64_PER_SM_CLOCK = 64
CLOCK_HZ = 1.98e9

OPS_OCTAVE_RIDGED = 92
OPS_SPLIT = 96
F64_OPS_OCTAVE = 24
OPS_FIELD_TEXEL = 101
OPS_DF_ADD = 20
OPS_INTERP_LINEAR = 34
LIBM_INSTRUCTIONS = {"acosf": 26, "sinf": 26, "cosf": 27, "tanf": 23}
OPS_INTERP_SLERP = 67 + (LIBM_INSTRUCTIONS["acosf"]
                         + 3 * LIBM_INSTRUCTIONS["sinf"]
                         + LIBM_INSTRUCTIONS["cosf"]
                         + 2 * LIBM_INSTRUCTIONS["tanf"])
OPS_TESS_VERTEX = 15 + 2 + 12 + 36 + 24 + 6 + 24 + 18
OPS_TESS_COLUMN = 10
OPS_TESS_PAD_VERTEX = 5
OPS_UNIFORMS_ROW = 4 * (3 * OPS_DF_ADD + 12) + 3
TILE_DIM = 32


def bound_ms(ops: float = 0.0, nbytes: float = 0.0,
             f64_ops: float = 0.0) -> float:
    """The larger of the operations' time (f32 over the f32 rate plus f64
    over the f64 rate) and the bytes over the memory rate, in ms."""
    clock = SMS * CLOCK_HZ
    t_ops = (ops / (F32_PER_SM_CLOCK * clock)
             + f64_ops / (F64_PER_SM_CLOCK * clock))
    return max(t_ops, nbytes / PEAK_BYTES) * 1e3


def noise_work(octaves: int):
    """(f32, f64 operations) of one point of ridged noise at lacunarity
    2: the int24 split once, each octave's noise3 and update."""
    return (int(octaves) * OPS_OCTAVE_RIDGED + OPS_SPLIT,
            int(octaves) * F64_OPS_OCTAVE)


def field_bound_ms(n: int, octaves: int) -> float:
    """K5 on six n x n faces: each texel's coordinates, noise, normal and
    shade; heights and shade written once."""
    texels = 6 * n * n
    ops, f64 = noise_work(octaves)
    return bound_ms(texels * (OPS_FIELD_TEXEL + ops), texels * 8,
                    texels * f64)


def tess_work(rows: int, grid: int, slerps: int, live: int,
              dim: int = TILE_DIM):
    interps = live * (grid * grid + 2 * grid)
    ops = ((interps - slerps) * OPS_INTERP_LINEAR
           + slerps * OPS_INTERP_SLERP
           + live * (grid * grid * OPS_TESS_VERTEX + grid * OPS_TESS_COLUMN
                     + 3 * dim * grid * 3)
           + (rows - live) * (grid * grid * OPS_TESS_PAD_VERTEX
                              + dim * grid * 3))
    nbytes = (rows * (grid * grid * 15 * 4 + dim * dim * 4 + 2 * 12 * 4
                      + 2 * 4 + 4)
              + 16 * 4 + 3 * 3 * grid * 2 * 8 + grid * 4)
    return float(ops), float(nbytes)


def tess_rows_bound_ms(rows: int, grid: int, slerps: int, live: int,
                       dim: int = TILE_DIM) -> float:
    """V1's rows mode on `rows` rows, `live` of them evaluated and the
    rest padding, `slerps` of the live rows' interpolations taking the
    slerp: V1's work and the uniforms' (computed in its staging, neither
    written nor read: 108 B a row)."""
    ops, nbytes = tess_work(rows, grid, slerps, live, dim)
    u_ops = rows * OPS_UNIFORMS_ROW
    u_bytes = rows * (13 + 96 + 108) + 24
    return bound_ms(ops + u_ops, nbytes + u_bytes - 2 * rows * 108)


def tess_slerps(normals, grid: int) -> int:
    """The interpolations of live rows with (n, 4, 3) corner normals that
    take the slerp branch (1 - dot(n0, n1) >= 0.001): each row's two
    column endpoints, grid times, and each column's interpolation between
    them, grid times."""
    import torch
    from perfbench.reference.frozen.tess import vertex

    n = normals.to(torch.float32)
    u = vertex._grid_tables(grid, str(n.device))[0][0][None, :, None]
    z = torch.zeros_like(n[:, :1])

    def slerp(a, b):
        return ~((1.0 - vertex._dot(a, b)) < 0.001)

    _, na = vertex.interpolate(z, n[:, 0:1], z, n[:, 1:2], u)
    _, nb = vertex.interpolate(z, n[:, 2:3], z, n[:, 3:4], u)
    ends = slerp(n[:, 0], n[:, 1]).sum() + slerp(n[:, 2], n[:, 3]).sum()
    return int(ends) * grid + int(slerp(na, nb).sum()) * grid
