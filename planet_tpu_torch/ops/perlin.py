"""Multi-octave gradient noise over double-float coordinates, in plain
PyTorch — the noise core of the tile path (planet_tpu's Pallas kernels
inline theirs: ops/kernels/perlin_pallas.accumulate_octaves and helpers).
The CUDA tile kernel (csrc/tile.cu) is held to this module bit for bit.

It keeps planet_tpu's coordinate handling and hash:

* lacunarity 2.0: one int24 fixed-point split at octave 0 (48-bit
  fraction), every octave's cell/fraction derived by static shifts
  (nums.df.int24_parts / shift_frac48);
* any other lacunarity: the coordinates are scaled per octave by the
  double-float frequency (`_df_scale`, freq accumulated in f64 the way the
  reference does, main.cpp:702) and split with the FLOOR-macro split;
* hash t[(t[(t[ix] + iy) & 255] + iz) & 255] into the packed gradient sign
  code, dot (gx*sx + gy*sy) + gz*sz, lerp a + (b - a)*t in f32;
* ridged: v = (1 - |n|)^2, value += v*amp*weight, weight = v (unclamped
  feedback, main.cpp:721-731); fbm: value += n*amp; amp *= gain in f32.

Fractions and fades are taken at the REFERENCE's precision, not the TPU
kernel's: the reference splits in double, narrows frac and frac - 1 to
f32, and evaluates the quintic fade ((t*6 - 15)*t + 10)*t*t*t in double
before narrowing (perlin.h:52-75). planet_tpu's Pallas kernel, having no
f64, truncates the fraction to 24 bits and evaluates the fade in f32; the
H100 has f64, and the exact fraction is already at hand (the int24 split
carries 48 bits). This puts the tiles within ~1e-7 of the oracle's f64
tiles (bit-identical on almost every texel) instead of ~4e-6 — which
decides the near-plane golden scene, where terrain grazes the near plane
and centimetres of height flip whole pixel runs.

Octave counts may differ per element (`octaves` a tensor): octave i then
contributes only where i < count — what planet_tpu's mixed-octave tile mode
computes, and what stopping the octave loop at the count computes.

The module also holds planet_tpu ops/perlin's public functions: the f64
specification path (perlin3_f64, fbm_f64, ridged_f64) on float64 tensors,
bit-identical to the oracle, and the double-float path (perlin3_df,
fbm_df, ridged_df), which runs K4 (ops/kernels/perlin_cuda.noise_df).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.ops.tables import (PERLIN_TABLE, PERLIN_VECTORS,
                                         fused_gradient_tables)


def packed_sign_table() -> np.ndarray:
    """P[s] = packed signs (sx+1) | (sy+1)<<2 | (sz+1)<<4 of gradient
    PERLIN_VECTORS[PERLIN_TABLE[s] & 15] — the last hash stage folded into
    the gradient choice (planet_tpu perlin_pallas._packed_sign_table)."""
    g = PERLIN_VECTORS[PERLIN_TABLE & 15].astype(np.int32)
    return ((g[:, 0] + 1) | ((g[:, 1] + 1) << 2)
            | ((g[:, 2] + 1) << 4)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _tables(device: str):
    perm = torch.as_tensor(PERLIN_TABLE.astype(np.int64), device=device)
    signs = torch.as_tensor(packed_sign_table().astype(np.int64),
                            device=device)
    return perm, signs


def freq_consts(lacunarity: float, octaves: int):
    """Per-octave frequency as exact double-float (hi, lo) f32 pairs,
    accumulated as the reference accumulates it (freq *= lacunarity in
    double, main.cpp:702)."""
    out = []
    freq = np.float64(1.0)
    for _ in range(octaves):
        hi = np.float32(freq)
        lo = np.float32(freq - np.float64(hi))
        out.append((hi, lo))
        freq = freq * np.float64(lacunarity)
    return out


def is_pow2_scale(chi, clo) -> bool:
    """`_df_scale` multiplies exactly (no Dekker product) by a constant
    that is a power of two 2^0 .. 2^63 with no lo part."""
    return float(clo) == 0.0 and float(chi) in (2.0**i for i in range(64))


def _df_scale(xhi, xlo, chi, clo):
    """Double-float multiply by a (hi, lo) f32 constant (Dekker)."""
    if is_pow2_scale(chi, clo):
        return xhi * float(chi), xlo * float(chi)
    split = np.float32(4097.0)
    chi, clo = np.float32(chi), np.float32(clo)
    # the constant's Dekker halves, in f32 on the host (numpy f32 scalars)
    cb = split * chi
    bhi = cb - (cb - chi)
    blo = chi - bhi
    chi, clo, bhi, blo = float(chi), float(clo), float(bhi), float(blo)
    p = xhi * chi
    ca = xhi * float(split)
    ahi = ca - (ca - xhi)
    alo = xhi - ahi
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    err = err + (xhi * clo + xlo * chi)
    return dfm.quick_two_sum(p, err)


def fade64(t):
    """Quintic fade, evaluated on float64 tensors."""
    return ((t * 6.0 - 15.0) * t + 10.0) * t * t * t


def frac_parts(frac64):
    """(frac, frac - 1, fade) in f32 from an exact float64 fraction, each
    rounded once (the reference's double-then-narrow)."""
    return (frac64.to(torch.float32), (frac64 - 1.0).to(torch.float32),
            fade64(frac64).to(torch.float32))


def _floor_frac64(hi, lo):
    """General-lacunarity split: (cell, exact float64 fraction)."""
    cell, fh, fl = dfm.floor_split_parts(hi, lo)
    return cell, fh.to(torch.float64) + fl.to(torch.float64)


def _lerp(a, b, t):
    return a + (b - a) * t


def noise3_core(perm, signs, cx, fx, fxm1, u, cy, fy, fym1, v, cz, fz,
                fzm1, w):
    """One octave of gradient noise from per-axis (cell, frac, frac - 1,
    fade)."""
    def t(i):
        return perm[(i & 255)]

    a0, a1 = t(cx), t(cx + 1)
    b00, b01 = t(a0 + cy), t(a0 + cy + 1)
    b10, b11 = t(a1 + cy), t(a1 + cy + 1)

    def grad2(b, gx, gy):
        # corner column (dx, dy) fixed by b; dz = 0 (frac fz) and dz = 1
        # (frac fzm1) gradient dots from the packed sign codes
        def dot(s, gz):
            sx = (s & 3).to(torch.float32) - 1.0
            sy = ((s >> 2) & 3).to(torch.float32) - 1.0
            sz = ((s >> 4) & 3).to(torch.float32) - 1.0
            return (gx * sx + gy * sy) + gz * sz
        bz = b + cz
        return dot(signs[(bz & 255)], fz), dot(signs[((bz + 1) & 255)], fzm1)

    g000, g001 = grad2(b00, fx, fy)
    g010, g011 = grad2(b01, fx, fym1)
    g100, g101 = grad2(b10, fxm1, fy)
    g110, g111 = grad2(b11, fxm1, fym1)

    x00 = _lerp(g000, g100, u)
    x10 = _lerp(g010, g110, u)
    x01 = _lerp(g001, g101, u)
    x11 = _lerp(g011, g111, u)
    return _lerp(_lerp(x00, x10, v), _lerp(x01, x11, v), w)


def accumulate_octaves(kind: str, octaves, lacunarity: float, gain,
                       xh, xl, yh, yl, zh, zl):
    """Multi-octave fBm ("fbm") or ridged ("ridged") noise of double-float
    coordinates. octaves: an int, or an int tensor broadcastable to the
    coordinates giving each element its own octave count."""
    if kind not in ("fbm", "ridged"):
        raise ValueError(kind)
    if isinstance(octaves, torch.Tensor):
        counts = octaves.to(xh.device)
        n_oct = int(counts.max()) if counts.numel() else 0
    else:
        counts, n_oct = None, int(octaves)
    gain = np.float32(gain)
    perm, signs = _tables(str(xh.device))
    freqs = freq_consts(lacunarity, n_oct)
    pow2 = float(lacunarity) == 2.0

    value = torch.zeros_like(xh)
    weight = torch.ones_like(xh)
    amplitude = np.float32(1.0)
    parts = None
    for i in range(n_oct):
        if pow2:
            if parts is None:
                parts = (dfm.int24_parts(xh, xl), dfm.int24_parts(yh, yl),
                         dfm.int24_parts(zh, zl))
            splits = [dfm.shift_frac48(*p, i) for p in parts]
        else:
            chi, clo = freqs[i]
            splits = [_floor_frac64(*_df_scale(h, l, chi, clo))
                      for h, l in ((xh, xl), (yh, yl), (zh, zl))]
        args = []
        for cell, frac64 in splits:
            args += [cell.long(), *frac_parts(frac64)]
        n = noise3_core(perm, signs, *args)
        live = None if counts is None else (counts > i)
        amp = float(amplitude)
        if kind == "fbm":
            contrib = n * amp
            if live is not None:
                contrib = torch.where(live, contrib, torch.zeros_like(contrib))
            value = value + contrib
        else:
            v = 1.0 - torch.abs(n)
            v = v * v
            contrib = v * amp * weight
            if live is not None:
                contrib = torch.where(live, contrib, torch.zeros_like(contrib))
                weight = torch.where(live, v, weight)
            else:
                weight = v
            value = value + contrib
        amplitude = np.float32(amplitude * gain)
    return value


# ---------------------------------------------------------------------------
# The f64 specification path (planet_tpu ops/perlin.perlin3_f64, fbm_f64,
# ridged_f64) on torch float64 tensors, on their device (arrays go to
# `device`, the card unless the caller asks for the CPU): the op order of
# ops/perlin_np.py, which the oracle goldens hold bit for bit. Each torch
# op rounds once, so the card gives the host's bits.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _f64_tables(device: str):
    """The permutation (int64) and the three fused gradient sign tables
    (f32) on `device` (tables.fused_gradient_tables)."""
    perm = torch.as_tensor(PERLIN_TABLE.astype(np.int64), device=device)
    return (perm,) + tuple(torch.as_tensor(t, device=device)
                           for t in fused_gradient_tables())


def as_f64(x, device) -> torch.Tensor:
    """x as float64: a tensor stays on its device, anything else goes to
    `device`."""
    if torch.is_tensor(x):
        return x.to(torch.float64)
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _xyz_f64(x, y, z, device):
    """Three coordinates as float64 tensors on x's device (see as_f64)."""
    x = as_f64(x, device)
    return (x,) + tuple(torch.as_tensor(c, dtype=torch.float64,
                                        device=x.device) for c in (y, z))


def perlin3_f64(x, y, z, device="cuda"):
    """Specification path: float64 coordinates in (tensors stay on their
    device; arrays go to `device`), float32 noise out, bit-identical to
    the reference C build (perlin.h:50-88): the FLOOR-macro cell split in
    double, the fade in double narrowed to f32, frac and frac - 1 narrowed
    to f32 after the offset, the gradient dots and lerps in f32."""
    x, y, z = _xyz_f64(x, y, z, device)
    perm, sx, sy, sz = _f64_tables(str(x.device))

    def floor_ref(a):
        return torch.trunc(torch.where(a < 0.0, a - 1.0, a)).to(torch.int64)

    ix, iy, iz = floor_ref(x), floor_ref(y), floor_ref(z)
    fx64, fy64, fz64 = x - ix, y - iy, z - iz
    u, v, w = (fade64(t).to(torch.float32) for t in (fx64, fy64, fz64))
    fx, fy, fz = (t.to(torch.float32) for t in (fx64, fy64, fz64))
    fxm1, fym1, fzm1 = ((t - 1.0).to(torch.float32)
                        for t in (fx64, fy64, fz64))

    def hash3(a, b, c):
        r1 = perm[a & 255]
        r2 = perm[(r1 + b) & 255]
        return (r2 + c) & 255

    def grad(s, gx, gy, gz):
        return (gx * sx[s] + gy * sy[s]) + gz * sz[s]

    g000 = grad(hash3(ix, iy, iz), fx, fy, fz)
    g100 = grad(hash3(ix + 1, iy, iz), fxm1, fy, fz)
    g010 = grad(hash3(ix, iy + 1, iz), fx, fym1, fz)
    g110 = grad(hash3(ix + 1, iy + 1, iz), fxm1, fym1, fz)
    g001 = grad(hash3(ix, iy, iz + 1), fx, fy, fzm1)
    g101 = grad(hash3(ix + 1, iy, iz + 1), fxm1, fy, fzm1)
    g011 = grad(hash3(ix, iy + 1, iz + 1), fx, fym1, fzm1)
    g111 = grad(hash3(ix + 1, iy + 1, iz + 1), fxm1, fym1, fzm1)
    x00 = _lerp(g000, g100, u)
    x10 = _lerp(g010, g110, u)
    x01 = _lerp(g001, g101, u)
    x11 = _lerp(g011, g111, u)
    return _lerp(_lerp(x00, x10, v), _lerp(x01, x11, v), w)


def fbm_f64(x, y, z, lacunarity=2.0, gain=np.float32(0.5), octaves=6,
            device="cuda"):
    """fBm: value += noise * amp; freq *= lacunarity (f64); amp *= gain
    (f32) (main.cpp:689-705)."""
    x, y, z = _xyz_f64(x, y, z, device)
    gain = np.float32(gain)
    freq = np.float64(1.0)
    amp = np.float32(1.0)
    value = torch.zeros(torch.broadcast_shapes(x.shape, y.shape, z.shape),
                        dtype=torch.float32, device=x.device)
    for _ in range(octaves):
        f = float(freq)
        value = value + perlin3_f64(x * f, y * f, z * f) * float(amp)
        freq = freq * np.float64(lacunarity)
        amp = amp * gain
    return value


def ridged_f64(x, y, z, lacunarity=2.0, gain=np.float32(0.5), octaves=6,
               device="cuda"):
    """Ridged multifractal with the reference's unclamped weight feedback
    (main.cpp:721-731): v = (1 - |n|)^2; value += v * amp * weight;
    weight = v."""
    x, y, z = _xyz_f64(x, y, z, device)
    gain = np.float32(gain)
    freq = np.float64(1.0)
    amp = np.float32(1.0)
    shape = torch.broadcast_shapes(x.shape, y.shape, z.shape)
    weight = torch.ones(shape, dtype=torch.float32, device=x.device)
    value = torch.zeros(shape, dtype=torch.float32, device=x.device)
    for _ in range(octaves):
        f = float(freq)
        n = perlin3_f64(x * f, y * f, z * f)
        v = 1.0 - torch.abs(n)
        v = v * v
        value = value + v * float(amp) * weight
        weight = v
        freq = freq * np.float64(lacunarity)
        amp = amp * gain
    return value


# ---------------------------------------------------------------------------
# The double-float path (planet_tpu ops/perlin.perlin3_df, fbm_df,
# ridged_df) over (hi, lo) f32 coordinate pairs of one shape, through K4
# (ops/kernels/perlin_cuda.noise_df: the kernel on CUDA tensors, its plain
# version, accumulate_octaves, on CPU tensors). The port's fraction and
# fade are the reference's f64 ones (module docstring), so these agree
# with the f64 path to ~1e-7, inside planet_tpu's parity bars.
# ---------------------------------------------------------------------------


def fbm_df(x, y, z, lacunarity=2.0, gain=np.float32(0.5), octaves=6):
    from planet_tpu_torch.ops.kernels import perlin_cuda
    return perlin_cuda.fbm_df(x, y, z, lacunarity=lacunarity, gain=gain,
                              octaves=octaves)


def ridged_df(x, y, z, lacunarity=2.0, gain=np.float32(0.5), octaves=6):
    from planet_tpu_torch.ops.kernels import perlin_cuda
    return perlin_cuda.ridged_df(x, y, z, lacunarity=lacunarity, gain=gain,
                                 octaves=octaves)


def perlin3_df(x, y, z):
    """One noise evaluation of double-float coordinates: one fBm octave
    (amplitude 1, so the sum is the noise itself)."""
    return fbm_df(x, y, z, octaves=1)
