"""Quadtree node addressing, host half (planet_tpu.geom.quadid lines
23-108, unchanged): uint64 quad ids with the reference QuadID bit layout,
in numpy on the host.

    bit  63     valid flag (zero id is invalid)
    bits 60-62  root face (0-5)
    bits 55-59  depth (5 bits)
    bits 0-54   child path, 2 bits per level; the child taken at depth d
                is stored at bits 2*(d-1)

The device-side int32-word ops (planet_tpu's words_*) belong to the device
refine path and are not part of this module yet.
"""

from __future__ import annotations

import numpy as np

VALID_BIT = np.uint64(1) << np.uint64(63)
_DEPTH_SHIFT = np.uint64(55)
_ROOT_SHIFT = np.uint64(60)
_DEPTH_UNIT = np.uint64(1) << _DEPTH_SHIFT

MAX_DEPTH_REPRESENTABLE = 27  # 54 path bits / 2


# ------------------------------------------------------------- host (numpy)


def make_root(face) -> np.uint64:
    face = np.uint64(face)
    return VALID_BIT | (face << _ROOT_SHIFT)


def depth_of(qid) -> np.uint64:
    return (np.uint64(qid) >> _DEPTH_SHIFT) & np.uint64(31)


def root_of(qid) -> np.uint64:
    return (np.uint64(qid) >> _ROOT_SHIFT) & np.uint64(7)


def make_child(qid, child_index) -> np.uint64:
    qid = np.uint64(qid)
    d = depth_of(qid)
    return (qid + _DEPTH_UNIT) | (np.uint64(child_index) << (np.uint64(2) * d))


def child_index_of(qid) -> np.uint64:
    qid = np.uint64(qid)
    d = depth_of(qid)
    return (qid >> (np.uint64(2) * (d - np.uint64(1)))) & np.uint64(3)


def parent_of(qid) -> np.uint64:
    qid = np.uint64(qid)
    d = depth_of(qid)
    mask = ~(np.uint64(3) << (np.uint64(2) * (d - np.uint64(1))))
    return (qid - _DEPTH_UNIT) & mask


def path_digits(qid):
    """Child indices along the path, root-first: list of ints, len == depth."""
    qid = np.uint64(qid)
    d = int(depth_of(qid))
    return [int((qid >> np.uint64(2 * i)) & np.uint64(3)) for i in range(d)]


def from_path(face, digits) -> np.uint64:
    q = make_root(face)
    for c in digits:
        q = make_child(q, c)
    return q


def dfs_key(qid) -> np.uint64:
    """Sort key reproducing the reference's DFS leaf emission order
    (ProcessQuad recurses children 0,1,2,3 — main.cpp:591-594): pad the path
    with zeros to full depth and compare lexicographically, most-significant
    digit first. Leaves of a proper quadtree are never ancestors of each
    other, so plain integer order on the padded path is the DFS order."""
    qid = np.uint64(qid)
    d = int(depth_of(qid))
    key = np.uint64(root_of(qid)) << np.uint64(2 * MAX_DEPTH_REPRESENTABLE)
    for i, c in enumerate(path_digits(qid)):
        key |= np.uint64(c) << np.uint64(2 * (MAX_DEPTH_REPRESENTABLE - 1 - i))
    return key


# ----------------------------------------------------------- device (int32)


def to_words(qid):
    """uint64 (array ok) -> (lo, hi) int32 words for device residency."""
    qid = np.asarray(qid, np.uint64)
    lo = (qid & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (qid >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi


def from_words(lo, hi):
    lo = np.asarray(lo, np.int32).view(np.uint32).astype(np.uint64)
    hi = np.asarray(hi, np.int32).view(np.uint32).astype(np.uint64)
    return (hi << np.uint64(32)) | lo
