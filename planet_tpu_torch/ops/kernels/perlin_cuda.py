"""Flat multi-octave noise over double-float coordinates (K4).

`noise_df` is the entry point. For CUDA tensors it launches the
hand-written kernel in csrc/perlin.cu (it replaces planet_tpu's Pallas
noise kernel, ops/kernels/perlin_pallas._make_kernel, launched through
noise_df); for CPU tensors it runs `noise_plain`, the port's plain noise
core ops/perlin.accumulate_octaves, which the kernel equals bit for bit.
The kernel and the tile kernel (K1) share one device noise core
(csrc/noise.cuh), so both give the same height for the same point and
octave count.

planet_tpu's noise_df pads its inputs to whole (block_rows, 128) blocks;
that is TPU sizing, and the kernel here takes the flat (n,) arrays as they
are, a thread a point. The wrapper reads no tensor value, so it stays legal
inside a CUDA-graph capture.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.ops import perlin
from planet_tpu_torch.ops.tables import PERLIN_TABLE

MAX_OCTAVES = 24          # int24 octave shifts and the kernels' freq table


def _check_args(kind, coords, octaves, lacunarity):
    if kind not in ("fbm", "ridged"):
        raise ValueError(kind)
    shape = coords[0].shape
    for name, t in zip(("xh", "xl", "yh", "yl", "zh", "zl"), coords):
        if t.shape != shape:
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected torch.float32, got {t.dtype}")
    if not 0 <= int(octaves) <= MAX_OCTAVES:
        raise ValueError(f"octaves must be in [0, {MAX_OCTAVES}], got "
                         f"{octaves}")
    if float(lacunarity) <= 0.0:
        raise ValueError("lacunarity must be positive")


def noise_plain(kind, xh, xl, yh, yl, zh, zl, *, lacunarity=2.0, gain=0.55,
                octaves=6):
    """Plain PyTorch version of the kernel; same signature as noise_df."""
    coords = (xh, xl, yh, yl, zh, zl)
    _check_args(kind, coords, octaves, lacunarity)
    return perlin.accumulate_octaves(kind, int(octaves), lacunarity,
                                     np.float32(gain), *coords)


def pair_table(t: np.ndarray) -> np.ndarray:
    """(256,) int32 pairs t[i] | t[(i + 1) & 255] << 16 of a table of
    values below 2^15: the noise core reads a lookup and its neighbour in
    one shared-memory read (csrc/noise.cuh)."""
    t = t.astype(np.int32)
    return t | (np.roll(t, -1) << 16)


@functools.lru_cache(maxsize=None)
def kernel_tables(lacunarity: float, device: str):
    """Device operands of the noise kernels (K1, K4 and K5): the pair
    tables of the permutation and of the packed gradient-sign codes (both
    (256,) int32, `pair_table`) and the (MAX_OCTAVES, 3) f32 per-octave
    frequency (hi, lo, exact-power-of-two flag) of the general-lacunarity
    path. Uploaded at first use, so a CUDA-graph capture must be preceded
    by one eager call."""
    perm = torch.as_tensor(pair_table(PERLIN_TABLE), device=device)
    signs = torch.as_tensor(pair_table(perlin.packed_sign_table()),
                            device=device)
    freq = np.array([(hi, lo, float(perlin.is_pow2_scale(hi, lo)))
                     for hi, lo in perlin.freq_consts(lacunarity,
                                                      MAX_OCTAVES)],
                    np.float32)
    return perm, signs, torch.as_tensor(freq, device=device)


def noise_cuda(kind, xh, xl, yh, yl, zh, zl, *, lacunarity=2.0, gain=0.55,
               octaves=6):
    """The CUDA kernel (csrc/perlin.cu); same signature as noise_plain."""
    coords = (xh, xl, yh, yl, zh, zl)
    _check_args(kind, coords, octaves, lacunarity)
    for name, t in zip(("xh", "xl", "yh", "yl", "zh", "zl"), coords):
        _cuda.check_cuda(t, name, torch.float32)
    out = torch.empty_like(xh)
    n = xh.numel()
    if n == 0:
        return out
    perm, signs, freq = kernel_tables(float(lacunarity), str(xh.device))
    _cuda.launch("noise", "planet_noise", *(t.data_ptr() for t in coords),
                 perm.data_ptr(), signs.data_ptr(), freq.data_ptr(),
                 out.data_ptr(), n, int(octaves), int(kind == "ridged"),
                 int(float(lacunarity) == 2.0), float(np.float32(gain)))
    return out


def noise_df(kind, xh, xl, yh, yl, zh, zl, *, lacunarity=2.0, gain=0.55,
             octaves=6):
    """Fused multi-octave noise over double-float coordinates.

    kind: "fbm" or "ridged". The six f32 coordinate tensors (x, y, z as
    hi/lo pairs) share one shape, any shape; returns f32 noise of that
    shape: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if xh.device.type == "cuda":
        return noise_cuda(kind, xh, xl, yh, yl, zh, zl, lacunarity=lacunarity,
                          gain=gain, octaves=octaves)
    if xh.device.type != "cpu":
        raise ValueError(f"unsupported device {xh.device}")
    return noise_plain(kind, xh, xl, yh, yl, zh, zl, lacunarity=lacunarity,
                       gain=gain, octaves=octaves)


def fbm_df(x, y, z, lacunarity=2.0, gain=0.5, octaves=6):
    """fBm of double-float (hi, lo) coordinate pairs (planet_tpu
    perlin_pallas.fbm_df)."""
    return noise_df("fbm", *x, *y, *z, lacunarity=lacunarity, gain=gain,
                    octaves=octaves)


def ridged_df(x, y, z, lacunarity=2.0, gain=0.5, octaves=6):
    """Ridged noise of double-float (hi, lo) coordinate pairs (planet_tpu
    perlin_pallas.ridged_df)."""
    return noise_df("ridged", *x, *y, *z, lacunarity=lacunarity, gain=gain,
                    octaves=octaves)
