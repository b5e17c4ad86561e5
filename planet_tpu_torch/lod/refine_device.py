"""Device-side LOD refinement (planet_tpu lod/refine_device.py, ported).

The reference's recursive ProcessQuad (main.cpp:537-598) becomes a fixed
sequence of max_lod + 1 level steps over fixed-capacity buffers:

    frontier ids/corners/depths (cap,) + count f_n
    leaf     ids/corners/depths (cap,) + count l_n

    level: probe heights for every live frontier slot -> split mask (in
           double-float) -> append the non-split slots to the leaf buffers
           -> expand the split slots x4 into the next frontier

`refine_device` runs it with no host sync, so on CUDA it can be captured
in a CUDA graph (engine/device_step.DeviceRenderer). For CUDA tensors it
launches R1 (ops/kernels/refine_cuda, csrc/refine.cu): a launch a level,
whose threads at or past f_n exit at once, so dead slots and the levels
after the frontier has emptied do no work — planet_tpu's `tight` width
ladder (lax.cond width sizing, bit-identical by its own docstring) and
its while_loop's stop at an empty frontier, decided on the card. For CPU
tensors it runs `refine_plain`, the plain version R1 equals bit for bit:
every level at the full width `cap` with an `active` mask, a fixed
sequence of tensor ops whose compaction is an exclusive cumsum giving
each kept slot its destination, plus a scatter whose rejected rows land
in a dump column. There is no fallback between the two: a failure to
build or launch R1 raises.

Semantics are planet_tpu's: the same double-float split test
(refine_device.py:260-323), the same child order (`_subdivide_t`:
child c of the r-th split slot goes to frontier slot 4r + c), leaves
appended in slot order at offset l_n, and the overflow flag raised when
leaves or children exceed `cap`. The "ridged6" probe is K4
(ops/kernels/perlin_cuda.noise_df) on the 1e-5-scaled double-float probe
points, times 8848 (refine_device.py:230-241).

Roots may be any frontier of quads of one tree, with their depths
(`root_depth`): the sharded engine refines each rank's depth-1 subtrees
(parallel/sharded_lod.py). Left out, as TPU-only: the lane-major layout's
window/sort tricks.

`dfs_order` puts the leaves in the reference's DFS emission order and cuts
them to the rows a frame renders: the DFS order kernel
(refine_cuda.dfs_order_cuda, csrc/order.cu) for CUDA tensors, its plain
version `dfs_order_plain` (a stable sort of packed keys) for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from planet_tpu_torch.geom import quadid
from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.ops import perlin
from planet_tpu_torch.ops.kernels import perlin_cuda, refine_cuda

PROBES = refine_cuda.PROBES
_PROBE_SCALE = 1e-5        # terrain coord_scale (main.cpp:823-832)
_PROBE_AMPLITUDE = 8848.0
_CHILD_CORNERS = ((0, 1, 3, 4), (1, 2, 4, 5), (3, 4, 6, 7), (4, 5, 7, 8))
KEY_PAD = 2**63 - 1        # DFS key of a padding row: after every real leaf


class DeviceRefineResult(NamedTuple):
    leaf_lo: torch.Tensor          # (cap,) int32 id words
    leaf_hi: torch.Tensor
    leaf_corners_hi: torch.Tensor  # (cap, 4, 3) f32, or (12, cap) transposed
    leaf_corners_lo: torch.Tensor
    leaf_depth: torch.Tensor       # (cap,) int32
    n_leaves: torch.Tensor         # () int32
    overflowed: torch.Tensor       # () bool


class Ordered(NamedTuple):
    """The first render_cap leaves in DFS order (rows past n_leaves are
    padding: the leaf buffers' zeros)."""
    leaf_lo: torch.Tensor          # (render_cap,) int32 id words
    leaf_hi: torch.Tensor
    leaf_depth: torch.Tensor       # (render_cap,) int32
    corners_hi: torch.Tensor       # (12, render_cap) f32, lane-major
    corners_lo: torch.Tensor
    n_leaves: torch.Tensor         # () int32, at most render_cap
    overflowed: torch.Tensor       # () bool: refine's, or n > render_cap


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
    h = perlin_cuda.noise_df("ridged", xh[0], xl[0], xh[1], xl[1], xh[2],
                             xl[2], octaves=6, gain=0.55)
    return h * float(np.float32(_PROBE_AMPLITUDE))


def _frontier(root_lo, root_hi, root_ch, root_cl, root_depth, cap: int):
    """The first frontier from R roots: ints (3, cap) and corners (24, cap),
    the roots in columns [0, R), zeros after them (R1's level 0 stages the
    roots on the card)."""
    dev = root_lo.device
    n_roots = root_lo.shape[0]
    f_int = torch.zeros((3, cap), dtype=torch.int32, device=dev)
    f_cor = torch.zeros((24, cap), dtype=torch.float32, device=dev)
    f_int[0, :n_roots] = root_lo
    f_int[1, :n_roots] = root_hi
    if root_depth is not None:
        f_int[2, :n_roots] = root_depth
    f_cor[:12, :n_roots] = root_ch.permute(1, 2, 0).reshape(12, n_roots)
    f_cor[12:, :n_roots] = root_cl.permute(1, 2, 0).reshape(12, n_roots)
    return f_int, f_cor


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
    f_int, f_cor = _frontier(root_lo, root_hi, root_ch, root_cl, root_depth,
                             cap)
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


def refine_device(cam_hi, cam_lo, root_lo, root_hi, root_ch, root_cl, *,
                  max_lod: int, cap: int, radius: float,
                  probe: str = "zero", root_depth=None, quality: float = 1.0,
                  transposed: bool = False) -> DeviceRefineResult:
    """Device refinement from R roots: (R,) int32 id words and (R, 4, 3)
    f32 DF corners, all on one device with the (3,) f32 DF camera.
    root_depth: the roots' (R,) int32 quad depths (None: 0, the six faces);
    the split threshold's lod term is max_lod - depth (main.cpp:560-571).

    probe: "zero" (smooth sphere, ConstantZero generator, main.cpp:836-841)
    or "ridged6" (the production terrain: K4's noise core). quality
    multiplies the split threshold d in double-float
    (EngineConfig.lod_quality; 1.0 is exactly the reference rule).
    transposed=True returns the leaf corners lane-major, (12, cap) with
    row = corner*3 + axis.

    CUDA tensors run R1 (refine_cuda), CPU tensors refine_plain.
    Leaves land in level order at [0, n_leaves); the rows after them are
    zero. On overflow (more than cap leaves or frontier children) the flag
    is set and the excess is dropped."""
    if probe not in PROBES:
        raise ValueError(probe)
    n_roots = root_lo.shape[0]
    if n_roots > cap:
        raise ValueError(f"{n_roots} roots exceed cap {cap}")
    kw = dict(max_lod=max_lod, cap=cap, radius=radius, probe=probe,
              root_depth=root_depth, quality=quality)
    args = (cam_hi, cam_lo, root_lo, root_hi, root_ch, root_cl)
    if cam_hi.device.type == "cuda":
        l_int, l_cor, l_n, overflow = refine_cuda.refine_cuda(*args, **kw)
    elif cam_hi.device.type == "cpu":
        l_int, l_cor, l_n, overflow = refine_plain(*args, **kw)
    else:
        raise ValueError(f"unsupported device {cam_hi.device}")
    c_hi, c_lo = l_cor[:12], l_cor[12:]
    if not transposed:
        c_hi = c_hi.reshape(4, 3, cap).permute(2, 0, 1)
        c_lo = c_lo.reshape(4, 3, cap).permute(2, 0, 1)
    return DeviceRefineResult(l_int[0], l_int[1], c_hi, c_lo, l_int[2], l_n,
                              overflow)


def dfs_order_plain(lo, hi, depth, c_hi, c_lo, n, overflowed,
                    render_cap: int) -> Ordered:
    """The plain version of the DFS order kernel: leaves (cap,) int32 id
    words and depths and (12, cap) f32 lane-major DF corners, in level
    order at [0, n) (n () int32, overflowed () bool) -> the first
    render_cap in DFS order (the rows past n keyed KEY_PAD, so they follow
    every leaf in their own order), the refine's or the render cap's
    overflow and n clamped to render_cap."""
    rows = torch.arange(lo.shape[0], device=lo.device, dtype=torch.int32)
    key = quadid.words_dfs_key(lo, hi)
    key = torch.where(rows < n, key, torch.full_like(key, KEY_PAD))
    perm = torch.argsort(key, stable=True)[:render_cap]
    return Ordered(lo.index_select(0, perm), hi.index_select(0, perm),
                   depth.index_select(0, perm), c_hi.index_select(1, perm),
                   c_lo.index_select(1, perm), torch.clamp(n, max=render_cap),
                   overflowed | (n > render_cap))


def dfs_order(ref: DeviceRefineResult, render_cap: int) -> Ordered:
    """refine_device's leaves (transposed=True) in DFS order, cut to the
    first render_cap: the DFS order kernel on CUDA tensors, dfs_order_plain
    on CPU tensors."""
    args = (ref.leaf_lo, ref.leaf_hi, ref.leaf_depth, ref.leaf_corners_hi,
            ref.leaf_corners_lo, ref.n_leaves, ref.overflowed)
    if ref.leaf_lo.device.type == "cuda":
        return Ordered(*refine_cuda.dfs_order_cuda(*args, render_cap))
    return dfs_order_plain(*args, render_cap)
