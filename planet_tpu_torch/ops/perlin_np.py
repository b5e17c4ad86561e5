"""Vectorized numpy implementation of the reference noise chain
(planet_tpu ops/perlin_np.py, copied so the port imports nothing of
planet_tpu).

Reference perlin.h:50-88, main.cpp:689-734, 823-832, bit-identical to the
C build: float64 coordinates, f64-evaluated-then-narrowed fade, f32
gradient/lerp chain.

Used where noise is needed on the host without a device round-trip: the
host LOD refiner's probe heights (split decisions must be exact to
reproduce the reference's leaf sets) and the checks of the field path.
The device paths live in ops.perlin and ops.kernels.perlin_cuda.
"""

from __future__ import annotations

import numpy as np

from planet_tpu_torch.ops.tables import PERLIN_TABLE, fused_gradient_tables

_T = PERLIN_TABLE.astype(np.int64)
_SX, _SY, _SZ = fused_gradient_tables()


def _floor_ref(x):
    return np.trunc(np.where(x < 0.0, x - 1.0, x)).astype(np.int64)


def _fade(t):
    return ((((t * 6.0 - 15.0) * t + 10.0) * t * t * t)).astype(np.float32)


def perlin3(x, y, z):
    """float64 in, float32 out; bit-identical to the reference scalar chain."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    ix, iy, iz = _floor_ref(x), _floor_ref(y), _floor_ref(z)
    fx64, fy64, fz64 = x - ix, y - iy, z - iz
    u, v, w = _fade(fx64), _fade(fy64), _fade(fz64)
    fx, fy, fz = (a.astype(np.float32) for a in (fx64, fy64, fz64))
    fxm1, fym1, fzm1 = ((a - 1.0).astype(np.float32) for a in (fx64, fy64, fz64))

    def hash2(a, b, c):
        r1 = _T[a & 255]
        r2 = _T[(r1 + b) & 255]
        return (r2 + c) & 255

    def grad(s, gx, gy, gz):
        return (gx * _SX[s] + gy * _SY[s]) + gz * _SZ[s]

    g000 = grad(hash2(ix, iy, iz), fx, fy, fz)
    g100 = grad(hash2(ix + 1, iy, iz), fxm1, fy, fz)
    g010 = grad(hash2(ix, iy + 1, iz), fx, fym1, fz)
    g110 = grad(hash2(ix + 1, iy + 1, iz), fxm1, fym1, fz)
    g001 = grad(hash2(ix, iy, iz + 1), fx, fy, fzm1)
    g101 = grad(hash2(ix + 1, iy, iz + 1), fxm1, fy, fzm1)
    g011 = grad(hash2(ix, iy + 1, iz + 1), fx, fym1, fzm1)
    g111 = grad(hash2(ix + 1, iy + 1, iz + 1), fxm1, fym1, fzm1)

    def lerp(a, b, t):
        return a + (b - a) * t

    x00 = lerp(g000, g100, u)
    x10 = lerp(g010, g110, u)
    x01 = lerp(g001, g101, u)
    x11 = lerp(g011, g111, u)
    return lerp(lerp(x00, x10, v), lerp(x01, x11, v), w)


def fbm(x, y, z, lacunarity=2.0, gain=np.float32(0.5), octaves=6):
    gain = np.float32(gain)
    freq = np.float64(1.0)
    amp = np.float32(1.0)
    value = np.zeros(np.broadcast(np.asarray(x), np.asarray(y), np.asarray(z)).shape,
                     np.float32)
    for _ in range(octaves):
        value = value + perlin3(x * freq, y * freq, z * freq) * amp
        freq = freq * np.float64(lacunarity)
        amp = amp * gain
    return value


def ridged(x, y, z, lacunarity=2.0, gain=np.float32(0.5), octaves=6):
    gain = np.float32(gain)
    offset = np.float32(1.0)
    freq = np.float64(1.0)
    amp = np.float32(1.0)
    shape = np.broadcast(np.asarray(x), np.asarray(y), np.asarray(z)).shape
    weight = np.ones(shape, np.float32)
    value = np.zeros(shape, np.float32)
    for _ in range(octaves):
        n = perlin3(x * freq, y * freq, z * freq)
        v = offset - np.abs(n)
        v = v * v
        value = value + v * amp * weight
        weight = v
        freq = freq * np.float64(lacunarity)
        amp = amp * gain
    return value


def terrain_height(p, depth: int, max_depth: int,
                   lacunarity=2.0, gain=np.float32(0.55),
                   coord_scale=0.00001, amplitude=8848.0):
    """The production terrain functor (reference main.cpp:823-832):
    p (..., 3) float64 world position -> f32 height."""
    p = np.asarray(p, np.float64) * np.float64(coord_scale)
    octaves = 6 + (12 * int(depth)) // int(max_depth)
    h = ridged(p[..., 0], p[..., 1], p[..., 2],
               lacunarity=lacunarity, gain=np.float32(gain), octaves=octaves)
    return h * np.float32(amplitude)
