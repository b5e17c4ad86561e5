"""Device-side LOD refinement's plain version (planet_tpu
lod/refine_device.py, ported): `refine_plain`, which R1 equals bit for bit.

The reference's recursive ProcessQuad (main.cpp:537-598) becomes a fixed
sequence of max_lod + 1 level steps over fixed-capacity buffers:

    frontier ids/corners/depths (cap,) + count f_n
    leaf     ids/corners/depths (cap,) + count l_n

    level: probe heights for every live frontier slot -> split mask (in
           double-float) -> append the non-split slots to the leaf buffers
           -> expand the split slots x4 into the next frontier

Every level runs at the full width `cap` with an `active` mask; the
compaction is an exclusive cumsum giving each kept slot its destination,
plus a scatter whose rejected rows land in a dump column. Semantics are
planet_tpu's: the same double-float split test (refine_device.py:260-323),
the same child order (child c of the r-th split slot goes to frontier
slot 4r + c), leaves appended in slot order at offset l_n, and the
overflow flag raised when leaves or children exceed `cap`. The "ridged6"
probe is the noise core (ops/kernels/perlin_cuda.noise_plain) on the
1e-5-scaled double-float probe points, times 8848.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.frozen.geom import quadid
from perfbench.reference.frozen.nums import df as dfm
from perfbench.reference.frozen.ops import perlin
from perfbench.reference.frozen.ops.kernels import perlin_cuda, refine_cuda

PROBES = refine_cuda.PROBES
_PROBE_SCALE = 1e-5        # terrain coord_scale (main.cpp:823-832)
_PROBE_AMPLITUDE = 8848.0
_CHILD_CORNERS = ((0, 1, 3, 4), (1, 2, 4, 5), (3, 4, 6, 7), (4, 5, 7, 8))


def _split_const(x, like):
    """A float64 constant as a double-float pair of 0-dim f32 tensors."""
    hi, lo = refine_cuda.split_f32(x)
    return dfm.const(hi, like), dfm.const(lo, like)


def _at(a, i):
    """Row i (along the leading axis) of a DF pair."""
    return a[0][i], a[1][i]


def _rows(a, idx, dim=0):
    """Rows idx of a DF pair along `dim`, by stacking (indexing with a list
    would copy an index tensor from the host, which a CUDA-graph capture
    refuses)."""
    return tuple(torch.stack([t.select(dim, i) for i in idx], dim)
                 for t in a)


def _norm2(p):
    """|p|^2 of DF points p whose leading axis is (x, y, z): planet_tpu's
    dot3 order, (x*x + y*y) + z*z."""
    sq = dfm.mul(p, p)
    return dfm.add(dfm.add(_at(sq, 0), _at(sq, 1)), _at(sq, 2))


def _df_normalize3(p, radius):
    """normalize(p) * radius in double-float; p's leading axis is
    (x, y, z) (planet_tpu's _df_normalize3, all points in one pass)."""
    s = dfm.div(radius, dfm.sqrt(_norm2(p)))
    return dfm.mul(p, (s[0][None], s[1][None]))


def _subdivide(c, radius):
    """DF corners c = (hi, lo), each (4 corner, 3 axis, W) -> children
    (4 child, 12, W) with row = corner*3 + axis (planet_tpu's
    _subdivide_t, reference VERT rule main.cpp:581-594)."""
    # edge sums 01, 02, 13, 23 and the centre sum (01) + (23)
    s = dfm.add(_rows(c, (0, 0, 1, 2)), _rows(c, (1, 2, 3, 3)))
    m = dfm.add(_at(s, 0), _at(s, 3))
    mids = (torch.cat([s[0], m[0][None]]).transpose(0, 1),
            torch.cat([s[1], m[1][None]]).transpose(0, 1))  # (3, 5, W)
    e = _df_normalize3(mids, radius)
    # the 3x3 grid c0, e01, c1, e02, m, e13, c2, e23, c3 as (9, 3, W)
    grid = [[c[k][0], e[k][:, 0], c[k][1], e[k][:, 1], e[k][:, 4],
             e[k][:, 2], c[k][2], e[k][:, 3], c[k][3]] for k in range(2)]
    w = c[0].shape[-1]
    return tuple(torch.stack([g[i] for row in _CHILD_CORNERS for i in row])
                 .reshape(4, 12, w) for g in grid)


def _probe_heights(probe, p):
    """(3, 5, W) DF probe positions -> (5, W) f32 heights."""
    if probe == "zero":
        return torch.zeros_like(p[0][0])
    # the production terrain at (depth=0, max_depth=1): 6 octaves
    # (reference ProcessQuad probes, main.cpp:552-556 / 823-832)
    sh = np.float32(_PROBE_SCALE)
    sl = np.float32(np.float64(_PROBE_SCALE) - np.float64(sh))
    xh, xl = perlin._df_scale(p[0], p[1], sh, sl)
    h = perlin_cuda.noise_plain("ridged", xh[0], xl[0], xh[1], xl[1],
                                xh[2], xl[2], octaves=6, gain=0.55)
    return h * float(np.float32(_PROBE_AMPLITUDE))


def _level(f_int, f_cor, f_n, l_int, l_cor, l_n, overflow, consts, *,
           cap: int, max_lod: int, probe: str, quality: float):
    """One refinement level over the frontier's first w columns (f_int
    (3, w), f_cor (24, w), w <= cap; f_n of them live) into the leaf
    buffers (3 and 24 rows x cap + 1, column cap the dump). Returns the
    next frontier (cap columns), f_n, l_n and the overflow flag. Every
    column's arithmetic is its own, so a level over [0, f_n) gives the
    full width's bits (planet_tpu's `tight` premise)."""
    dev = f_int.device
    i32 = torch.int32
    f32 = torch.float32
    w = f_int.shape[1]
    one, rad, cam, two, lod_scale, lod_max, qual = consts
    slots = torch.arange(w, device=dev, dtype=i32)
    dump = torch.full((w,), cap, device=dev, dtype=torch.int64)
    child_col = torch.arange(4, device=dev, dtype=i32)[:, None]

    active = slots < f_n
    lodv = max_lod - f_int[2]                      # (w,) per-quad lod
    corners = (f_cor[:12].view(4, 3, w), f_cor[12:].view(4, 3, w))

    # --- probes: 4 corners + sphere midpoint, displaced by heights.
    # Corner sums per axis in plain f32, sequential corner order
    # (0+1)+2)+3 — planet_tpu's, feeding only the DF normalize
    csum = tuple(((c[0] + c[1]) + c[2]) + c[3] for c in corners)
    mid = _df_normalize3(csum, rad)                 # (3, w)
    probes = tuple(torch.cat([c.transpose(0, 1), m[:, None]], dim=1)
                   for c, m in zip(corners, mid))   # (3, 5, w)
    hts = _probe_heights(probe, probes)             # (5, w)

    # --- split decision in double-float (the reference evaluates
    # ProcessQuad in double, main.cpp:546-571): displacement
    # p * (1 + h/|p|), diagonals, camera distances, threshold
    plen = dfm.sqrt(_norm2(probes))
    scale = dfm.add(one, dfm.div(dfm.from_f32(hts), plen))
    d = dfm.mul(probes, (scale[0][None], scale[1][None]))
    diag2 = _norm2(dfm.sub(_rows(d, (3, 2), 1), _rows(d, (0, 1), 1)))
    diag = dfm.add(_at(diag2, 0), _at(diag2, 1))     # |d30|^2 + |d21|^2
    denom = dfm.add(one, dfm.div(
        dfm.mul(lod_scale, dfm.from_f32(lodv.to(f32))), lod_max))
    thr = dfm.div(diag, denom)                       # (w,) DF
    if quality != 1.0:
        thr = dfm.mul(thr, qual)
    lhs = dfm.mul_pow2(_norm2(dfm.sub(d, cam)), two)  # (5, w) DF
    # lexicographic DF compare (canonical (hi, lo) pairs)
    closer = (lhs[0] < thr[0]) | ((lhs[0] == thr[0]) & (lhs[1] < thr[1]))
    split = active & (lodv > 0) & closer.any(dim=0)
    leaf = active & ~split

    # --- append the leaves at [l_n, l_n + n_leaf), in slot order
    leaf_i = leaf.to(i32)
    pos = l_n + torch.cumsum(leaf_i, 0, dtype=i32) - leaf_i
    dst = torch.where(leaf & (pos < cap), pos.long(), dump)
    l_int.index_copy_(1, dst, f_int)
    l_cor.index_copy_(1, dst, f_cor)
    new_l_n = l_n + leaf_i.sum(dtype=i32)
    overflow = overflow | (new_l_n > cap)
    l_n = torch.clamp(new_l_n, max=cap)

    # --- expand the splits: the r-th split slot's child c goes to
    # frontier slot 4r + c (planet_tpu's child ordering)
    kids_h, kids_l = _subdivide(corners, rad)        # (4, 12, w)
    split_i = split.to(i32)
    rank = torch.cumsum(split_i, 0, dtype=i32) - split_i
    n_split = split_i.sum(dtype=i32)
    overflow = overflow | (n_split * 4 > cap)
    tgt = 4 * rank[None] + child_col                 # (4, w)
    dst = torch.where(split[None] & (tgt < cap), tgt.long(),
                      dump[None]).reshape(-1)
    c_lo, c_hi = quadid.words_make_child(f_int[0][None], f_int[1][None],
                                         child_col)
    c_int = torch.stack([c_lo, c_hi, (f_int[2] + 1).expand(4, w)])
    c_cor = torch.cat([kids_h, kids_l], dim=1)       # (4, 24, w)
    nf_int = torch.zeros((3, cap + 1), dtype=i32, device=dev)
    nf_cor = torch.zeros((24, cap + 1), dtype=f32, device=dev)
    nf_int.index_copy_(1, dst, c_int.reshape(3, 4 * w))
    nf_cor.index_copy_(1, dst, c_cor.transpose(0, 1).reshape(24, 4 * w))
    f_n = torch.clamp(n_split * 4, max=cap)
    return nf_int[:, :cap], nf_cor[:, :cap], f_n, l_n, overflow


def refine_plain(cam_hi, cam_lo, root_lo, root_hi, root_ch, root_cl, *,
                 max_lod: int, cap: int, radius: float, probe: str = "zero",
                 root_depth=None, quality: float = 1.0, narrow: bool = False):
    """The plain version of R1: max_lod + 1 levels (`_level`), each at the
    full width cap with dead slots masked, and no host read. Returns what
    refine_cuda returns: (l_int (3, cap), l_cor (24, cap), n_leaves,
    overflowed).

    narrow=True runs each level over [0, f_n) only and stops at an empty
    frontier, as R1 does on the card; it reads f_n on the host a level, so
    it is for eager runs (the tests hold it to the full width bit for
    bit)."""
    dev = cam_hi.device
    i32 = torch.int32
    n_roots = root_lo.shape[0]
    f_int, f_cor = refine_cuda.frontier(root_lo, root_hi, root_ch, root_cl,
                                        root_depth, cap)
    f_n = torch.full((), n_roots, dtype=i32, device=dev)
    l_int = torch.zeros((3, cap + 1), dtype=i32, device=dev)
    l_cor = torch.zeros((24, cap + 1), dtype=torch.float32, device=dev)
    l_n = torch.zeros((), dtype=i32, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)

    one = dfm.from_f32(dfm.const(1.0, cam_hi))
    consts = (one, _split_const(radius, cam_hi),
              (cam_hi[:, None, None], cam_lo[:, None, None]),
              dfm.const(2.0, cam_hi), dfm.from_f32(dfm.const(2.5, cam_hi)),
              dfm.from_f32(dfm.const(max_lod, cam_hi)),
              _split_const(quality, cam_hi))
    for _ in range(max_lod + 1):
        if narrow:
            w = int(f_n)
            if w == 0:
                break
            f_int, f_cor = f_int[:, :w], f_cor[:, :w]
        f_int, f_cor, f_n, l_n, overflow = _level(
            f_int, f_cor, f_n, l_int, l_cor, l_n, overflow, consts, cap=cap,
            max_lod=max_lod, probe=probe, quality=quality)
    return l_int[:, :cap], l_cor[:, :cap], l_n, overflow


