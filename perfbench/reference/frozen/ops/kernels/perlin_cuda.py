"""Flat multi-octave noise over double-float coordinates (K4's plain
version): `noise_plain`, the noise core ops/perlin.accumulate_octaves
with the argument checks.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.frozen.ops import perlin

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
    """Fused multi-octave noise over double-float coordinates: kind
    "fbm" or "ridged"; the six f32 coordinate tensors (x, y, z as hi/lo
    pairs) share one shape; returns f32 noise of that shape."""
    coords = (xh, xl, yh, yl, zh, zl)
    _check_args(kind, coords, octaves, lacunarity)
    return perlin.accumulate_octaves(kind, int(octaves), lacunarity,
                                     np.float32(gain), *coords)


