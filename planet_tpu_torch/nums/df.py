"""Double-float (two-float32) arithmetic on torch tensors (planet_tpu
nums.df, ported).

A double-float value is x = hi + lo with |lo| <= ulp(hi)/2, carried as a
pair of float32 tensors. The split helpers (floor_split_parts, int24_parts,
...) take hi and lo as two arguments; the arithmetic (add, mul, div, sqrt,
dot3, ...) takes and returns `(hi, lo)` tuples, whose two tensors may
broadcast against each other's shapes. Every function keeps planet_tpu's
op order exactly (each torch op rounds once, as XLA and Mosaic do, and
torch never contracts separate ops to FMA), so results are bit-identical
to the reference on the same inputs. See planet_tpu/nums/df.py for the
error analysis of each transform.

Constants enter as float32 tensors (`const`), never as Python floats: a
Python float would make two_prod's splitting run in float64, and dividing
a CUDA tensor by a Python float multiplies by its reciprocal instead.
"""

from __future__ import annotations

import numpy as np
import torch

from planet_tpu_torch.nums.fp import sqrt_rn

_M24 = 2**24 - 1
_P24 = float(np.float32(2.0**-24))
_SPLIT = float(np.float32(4097.0))   # Dekker split constant, 2^12 + 1


def const(x, like: torch.Tensor) -> torch.Tensor:
    """x rounded to float32, as a 0-dim tensor on `like`'s device (made by
    a fill, so it is safe inside a CUDA-graph capture)."""
    return like.new_full((), float(np.float32(x)), dtype=torch.float32)


def from_f32(x: torch.Tensor):
    """Lift exact float32 values into DF (lo = 0)."""
    return x, torch.zeros_like(x)


def two_sum(a, b):
    """Error-free sum: a + b = s + err exactly (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


def two_prod(a, b):
    """Error-free product via Dekker splitting: a * b = p + err exactly."""
    p = a * b
    ca = _SPLIT * a
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = _SPLIT * b
    bhi = cb - (cb - b)
    blo = b - bhi
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def add(a, b):
    """Accurate double-float addition (Knuth/Shewchuk), exact under
    cancellation."""
    s, e = two_sum(a[0], b[0])
    t, f = two_sum(a[1], b[1])
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return quick_two_sum(s, e)


def sub(a, b):
    return add(a, (-b[0], -b[1]))


def mul(a, b):
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return quick_two_sum(p, e)


def mul_pow2(a, scale: torch.Tensor):
    """Exact multiply by a power of two (a float32 tensor)."""
    return a[0] * scale, a[1] * scale


def div(a, b):
    q1 = a[0] / b[0]
    # r = a - q1*b, computed accurately
    p, e = two_prod(q1, b[0])
    r_hi, r_e = two_sum(a[0], -p)
    r = r_hi + (r_e + a[1] - e - q1 * b[1])
    q2 = r / b[0]
    return quick_two_sum(q1, q2)


def sqrt(a):
    """Double-float square root (Karp's method, one Newton step).

    planet_tpu seeds the step with lax.rsqrt. The port seeds it with the
    correctly rounded 1 / sqrt(hi) (two IEEE operations, the root by
    nums.fp.sqrt_rn), because CUDA's rsqrt is approximate: this way the
    CPU and the card give identical bits. The Newton step makes both seeds
    accurate to DF precision; the last bit may differ from planet_tpu's."""
    x = torch.reciprocal(sqrt_rn(a[0]))
    ax = a[0] * x  # approx sqrt
    p, e = two_prod(ax, ax)
    d_hi, d_e = two_sum(a[0], -p)
    diff = d_hi + (d_e + a[1] - e)
    corr = diff * (x * 0.5)
    return quick_two_sum(ax, corr)


def dot3(ax, ay, az, bx, by, bz):
    return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz))


def from_f64_np(x):
    """Host-side exact split of float64 into an (hi, lo) numpy f32 pair."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def floor_split_parts(hi, lo):
    """(int32 cell, frac hi, frac lo) with the reference FLOOR-macro
    semantics, FLOOR(x) = (int)((x < 0) ? x - 1 : x) — planet_tpu's
    nums.df.floor_split_parts op for op (including the frac == 1.0 case at
    exact negative integers, which must not renormalize)."""
    one = 1.0
    neg = hi < 0.0
    cell_f = torch.where(neg, torch.trunc(hi - one), torch.trunc(hi))
    d, derr = two_sum(hi, -cell_f)
    f, e = two_sum(d, lo)
    e = e + derr
    f, e = quick_two_sum(f, e)
    adj = torch.floor(f)
    adj = torch.where((f == one) & (e <= 0.0), torch.zeros_like(adj), adj)
    cell = cell_f.to(torch.int32) + adj.to(torch.int32)
    ff, ferr = two_sum(f, -adj)
    fh, fl = quick_two_sum(ff, e + ferr)
    return cell, fh, fl


def int24_parts(hi, lo):
    """(cell, hi24, lo24) int32: the FLOOR-macro cell plus the fraction as
    48-bit fixed point (planet_tpu nums.df.int24_parts, same op order)."""
    cell, fh, fl = floor_split_parts(hi, lo)
    t = fh * float(2.0**24)
    hi_f = torch.trunc(t)
    r = t - hi_f
    lo_f = torch.floor(r * float(2.0**24) + fl * float(2.0**48))
    lo_i = lo_f.to(torch.int32)
    hi_i = hi_f.to(torch.int32) + (lo_i >> 24)
    lo_i = lo_i & _M24
    cell = cell + (hi_i >> 24)
    hi_i = hi_i & _M24
    return cell, hi_i, lo_i


def _shift24(cell, hi24, lo24, o: int):
    """Octave-o (cell, hi24, lo24) of 2^o * x from octave 0's int24 parts,
    o in [0, 24). Left shifts of negative cells wrap in two's complement,
    as in numpy and XLA."""
    o = int(o)
    if not 0 <= o < 24:
        raise ValueError(f"octave shift {o} outside [0, 24)")
    if not o:
        return cell, hi24, lo24
    cell_o = (cell << o) + (hi24 >> (24 - o))
    hi_o = ((hi24 << o) | (lo24 >> (24 - o))) & _M24
    lo_o = (lo24 << o) & _M24
    return cell_o, hi_o, lo_o


def shift_split24(cell, hi24, lo24, o: int):
    """planet_tpu's octave-o split: (cell, frac, frac - 1) with the
    fraction truncated to its 24-bit hi window, in f32."""
    cell_o, hi_o, _ = _shift24(cell, hi24, lo24, o)
    fh = hi_o.to(torch.float32) * _P24
    return cell_o, fh, fh - 1.0


def shift_frac48(cell, hi24, lo24, o: int):
    """Octave-o (cell, fraction): the fraction's full 48 bits as an exact
    float64 tensor (the reference splits cell/fraction in double,
    perlin.h:52-56)."""
    cell_o, hi_o, lo_o = _shift24(cell, hi24, lo24, o)
    frac = hi_o.to(torch.float64) * 2.0**-24 + lo_o.to(torch.float64) * 2.0**-48
    return cell_o, frac
