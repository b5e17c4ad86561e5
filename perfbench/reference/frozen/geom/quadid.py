"""Quadtree node addressing (planet_tpu.geom.quadid, ported): uint64 quad
ids with the reference QuadID bit layout.

    bit  63     valid flag (zero id is invalid)
    bits 60-62  root face (0-5)
    bits 55-59  depth (5 bits)
    bits 0-54   child path, 2 bits per level; the child taken at depth d
                is stored at bits 2*(d-1)

The host half works on numpy uint64. The device half (`words_*`) works on
ids split into two int32 tensors, lo = bits 0-31 and hi = bits 32-63, as
planet_tpu keeps them on the device; every op is bit-identical to
planet_tpu's. Shift counts are guarded with `where` as planet_tpu guards
them: torch does not define an int32 shift by 32 or more.
"""

from __future__ import annotations

import numpy as np
import torch

VALID_BIT = np.uint64(1) << np.uint64(63)
_ROOT_SHIFT = np.uint64(60)

MAX_DEPTH_REPRESENTABLE = 27  # 54 path bits / 2


# ------------------------------------------------------------- host (numpy)


def make_root(face) -> np.uint64:
    face = np.uint64(face)
    return VALID_BIT | (face << _ROOT_SHIFT)


# ----------------------------------------------------------- device (int32)


def to_words(qid):
    """uint64 (array ok) -> (lo, hi) int32 words for device residency."""
    qid = np.asarray(qid, np.uint64)
    lo = (qid & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (qid >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi


_HI_DEPTH_SHIFT = 55 - 32   # depth field within the hi word
_HI_ROOT_SHIFT = 60 - 32
_HI_DEPTH_UNIT = 1 << _HI_DEPTH_SHIFT
_PATH_BITS = 2 * MAX_DEPTH_REPRESENTABLE


def words_depth(hi):
    return (hi >> _HI_DEPTH_SHIFT) & 31


def words_root(hi):
    return (hi >> _HI_ROOT_SHIFT) & 7


def _digit_at(lo, hi, pos):
    """2-bit field at bit `pos` (int32 tensor, 0 <= pos < 64) of the id."""
    in_lo = pos < 32
    zero = torch.zeros_like(pos)
    from_lo = (lo >> torch.where(in_lo, pos, zero)) & 3
    from_hi = (hi >> torch.where(in_lo, zero, pos - 32)) & 3
    return torch.where(in_lo, from_lo, from_hi)


def words_make_child(lo, hi, child):
    """Vectorized MakeChildID on word pairs. child: int32 in 0..3 (a
    tensor, or an int for every id)."""
    d = words_depth(hi)
    if not isinstance(child, torch.Tensor):
        child = torch.full_like(lo, int(child))
    hi = hi + _HI_DEPTH_UNIT
    pos = 2 * d
    in_lo = pos < 32
    zero = torch.zeros_like(pos)
    lo_bits = torch.where(in_lo, child << torch.where(in_lo, pos, zero), zero)
    hi_bits = torch.where(in_lo, zero,
                          child << torch.where(in_lo, zero, pos - 32))
    return lo | lo_bits, hi | hi_bits


def words_child_index(lo, hi):
    return _digit_at(lo, hi, 2 * (words_depth(hi) - 1))


def words_parent(lo, hi):
    d = words_depth(hi)
    pos = 2 * (d - 1)
    in_lo = pos < 32
    zero = torch.zeros_like(pos)
    three = torch.full_like(pos, 3)
    lo_mask = torch.where(in_lo, three << torch.where(in_lo, pos, zero), zero)
    hi_mask = torch.where(in_lo, zero,
                          three << torch.where(in_lo, zero, pos - 32))
    return lo & ~lo_mask, (hi - _HI_DEPTH_UNIT) & ~hi_mask


def words_path_digit(lo, hi, level):
    """Child index taken at depth `level` (1-based; an int or an int32
    tensor), i.e. bits 2*(level-1)."""
    if not isinstance(level, torch.Tensor):
        level = torch.full_like(lo, int(level))
    return _digit_at(lo, hi, 2 * (level - 1))


_REVERSE_PAIRS = ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                  (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF),
                  (32, 0x00000000FFFFFFFF))


def words_dfs_key(lo, hi):
    """Device twin of dfs_key as ONE non-negative int64 sort key per id:
    planet_tpu's (khi, klo) pair packed as khi << 26 | klo, so that one
    sort gives the reference's DFS leaf-emission order (root, then path
    digits most significant first, zero-padded to depth 27).

    Bit layout of the 57-bit key: root at bits 54-56, the digit of level i
    (1-based) at bits 54-2i. The path is cut to the id's depth, then its
    27 two-bit digits are reversed in place (five swap stages over the
    64-bit word) — the same key as planet_tpu's per-level loop."""
    depth = words_depth(hi).to(torch.int64)
    path = (((hi.to(torch.int64) & ((1 << (_PATH_BITS - 32)) - 1)) << 32)
            | (lo.to(torch.int64) & 0xFFFFFFFF))
    depth = torch.clamp(depth, max=MAX_DEPTH_REPRESENTABLE)
    path = path & ((torch.ones_like(path) << (2 * depth)) - 1)
    for shift, mask in _REVERSE_PAIRS:
        path = ((path >> shift) & mask) | ((path & mask) << shift)
    # digit 1 now sits at bits 62-63; it belongs at bits 52-53
    path = (path >> (64 - _PATH_BITS)) & ((1 << _PATH_BITS) - 1)
    return (words_root(hi).to(torch.int64) << _PATH_BITS) | path
