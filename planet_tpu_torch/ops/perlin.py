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
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.ops.tables import PERLIN_TABLE, PERLIN_VECTORS


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
