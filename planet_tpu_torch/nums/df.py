"""Double-float (two-float32) arithmetic on torch tensors — the subset of
planet_tpu.nums.df the tile path needs.

A double-float value is x = hi + lo with |lo| <= ulp(hi)/2, carried as a
pair of equal-shaped float32 tensors. Every function keeps planet_tpu's op
order exactly (each torch op rounds once, as XLA and Mosaic do, and torch
never contracts separate ops to FMA), so results are bit-identical to the
reference on the same inputs. See planet_tpu/nums/df.py for the error
analysis of each transform.
"""

from __future__ import annotations

import numpy as np
import torch

_M24 = 2**24 - 1
_P24 = float(np.float32(2.0**-24))


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
