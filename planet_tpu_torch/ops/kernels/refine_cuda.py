"""The device refine kernel (R1): the fused frame's LOD refinement on the card.

`refine_cuda` launches the hand-written kernel in csrc/refine.cu for CUDA
tensors and raises for anything else; lod/refine_device.refine_device is
the entry point, which runs the plain version, refine_device.refine_plain,
for CPU tensors. planet_tpu has no Pallas refine kernel: its device refine
(planet_tpu/lod/refine_device.py:153) is one jit whose probes call K4
(perlin_pallas.py:370) and whose while_loop skips dead slots and stops at
an empty frontier. R1 is that program as CUDA C++: one launch a level, a
warp a live frontier slot with the five probes' 30 noise octaves on its
lanes (`lane_map`), the level's compaction by the last block to finish,
dead slots and emptied levels skipped on the card, bit for bit equal to
refine_plain.

The frontier and leaf layout is refine_plain's: ints (3, cap) (id lo, id
hi, depth) and corners (24, cap) (hi rows 0-11, lo rows 12-23, row =
corner*3 + axis). Level 0 stages the roots into its frontier itself, so
the set-up on the card is one zero fill (the leaf buffers and the counts
share it). The wrapper reads no tensor value and allocates every buffer
from metadata, so it stays legal inside a CUDA-graph capture (the noise
tables come from perlin_cuda.kernel_tables' cache, which an eager call
fills first).

`dfs_order_cuda` launches the DFS order kernel (csrc/order.cu) on R1's
leaves; refine_device.dfs_order is its entry point, which runs the plain
version, refine_device.dfs_order_plain, for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.ops.kernels import perlin_cuda

PROBES = ("zero", "ridged6")
# the probes a slot (its 4 corners, then the normalized midpoint) and the
# ridged octaves a probe; a warp's lanes
N_PROBES, PROBE_OCTAVES, WARP = 5, 6, 32


def lane_map():
    """R1's evaluation of one slot by one warp: [(probe, octave)] of lanes
    0-31 (lane l < 30 takes probe l // 6 and octave l % 6; lanes 30 and 31
    repeat probe 4's octaves 0 and 1, which nothing folds), and the fold
    lane of each probe, 6j: the first lane whose shuffles gather probe j's
    octaves 0-5 in order (every lane of the probe folds the same values)."""
    lanes = [(min(lane // PROBE_OCTAVES, N_PROBES - 1), lane % PROBE_OCTAVES)
             for lane in range(WARP)]
    folds = [PROBE_OCTAVES * j for j in range(N_PROBES)]
    return lanes, folds


def split_f32(x: float):
    """A float64 constant as its (hi, lo) float32 pair, as Python floats."""
    hi = np.float32(x)
    return float(hi), float(np.float32(np.float64(x) - np.float64(hi)))


def _check_args(cam_hi, cam_lo, root_lo, root_hi, root_ch, root_cl,
                root_depth, *, max_lod, cap, probe):
    """Metadata checks, the device last: a CPU tensor of the right dtype
    and shape gets "expected a CUDA tensor"."""
    if probe not in PROBES:
        raise ValueError(probe)
    if int(cap) < 1 or int(max_lod) < 0:
        raise ValueError(f"cap must be >= 1 and max_lod >= 0, got cap {cap}, "
                         f"max_lod {max_lod}")
    n_roots = root_lo.shape[0] if root_lo.dim() == 1 else -1
    if not 0 <= n_roots <= cap:
        raise ValueError(f"root_lo: expected (R,) roots with R <= cap {cap}, "
                         f"got shape {tuple(root_lo.shape)}")
    named = [("cam_hi", cam_hi, torch.float32, (3,)),
             ("cam_lo", cam_lo, torch.float32, (3,)),
             ("root_lo", root_lo, torch.int32, (n_roots,)),
             ("root_hi", root_hi, torch.int32, (n_roots,)),
             ("root_ch", root_ch, torch.float32, (n_roots, 4, 3)),
             ("root_cl", root_cl, torch.float32, (n_roots, 4, 3))]
    if root_depth is not None:
        named.append(("root_depth", root_depth, torch.int32, (n_roots,)))
    for name, t, dtype, shape in named:
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t, dtype, shape in named:
        if t.device != cam_hi.device or t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor on "
                             f"{cam_hi.device}, got {t.device}")
    for name, t, dtype, shape in named:         # the kernel reads these
        _cuda.check_cuda(t, name, dtype, shape)


def refine_cuda(cam_hi, cam_lo, root_lo, root_hi, root_ch, root_cl, *,
                max_lod: int, cap: int, radius: float, probe: str = "zero",
                root_depth=None, quality: float = 1.0):
    """R1 from R roots on the card; refine_device.refine_plain's arguments.

    Returns (l_int (3, cap) int32 leaf id lo, id hi, depth; l_cor (24, cap)
    f32 leaf corners; n_leaves () int32; overflowed () bool), leaves in
    level order at [0, n_leaves) and zeros after them. One zero fill, then
    one launch a level (one kernel: the level's evaluation and compaction),
    max_lod + 1 in all, call L with level L's operands on buffers allocated
    from metadata: the first frontier (level 0 stages the roots into it)
    and the next one (swapped after each call), the children's scratch,
    the flags, and one zero fill holding the leaf buffers and the state
    (the counts f_n, l_n and overflowed of even levels, the same of odd
    levels, the blocks' ticket; level 0 takes its f_n, the roots' count,
    from the arguments)."""
    _check_args(cam_hi, cam_lo, root_lo, root_hi, root_ch, root_cl,
                root_depth, max_lod=max_lod, cap=cap, probe=probe)
    dev = cam_hi.device
    i32 = torch.int32
    cur = (torch.empty((3, cap), dtype=i32, device=dev),
           torch.empty((24, cap), dtype=torch.float32, device=dev))
    nxt = (torch.empty_like(cur[0]), torch.empty_like(cur[1]))
    kid_int = torch.empty((4, 3, cap), dtype=i32, device=dev)
    kid_cor = torch.empty((4, 24, cap), dtype=torch.float32, device=dev)
    flags = torch.empty((cap,), dtype=i32, device=dev)
    zeros = torch.zeros((27 * cap + 7,), dtype=i32, device=dev)
    l_int = zeros[:3 * cap].view(3, cap)
    l_cor = zeros[3 * cap:27 * cap].view(torch.float32).view(24, cap)
    state = zeros[27 * cap:]
    tables = (perlin_cuda.kernel_tables(2.0, str(dev)) if probe == "ridged6"
              else (None, None, None))
    ptrs = [None if t is None else t.data_ptr() for t in tables]
    roots = [None if t is None else t.data_ptr() for t in (
        root_lo, root_hi, root_depth, root_ch, root_cl)]
    for level in range(int(max_lod) + 1):
        _cuda.launch("refine", "planet_refine_level", *roots,
                     root_lo.shape[0], cur[0].data_ptr(), cur[1].data_ptr(),
                     nxt[0].data_ptr(), nxt[1].data_ptr(), kid_int.data_ptr(),
                     kid_cor.data_ptr(), flags.data_ptr(), state.data_ptr(),
                     l_int.data_ptr(), l_cor.data_ptr(), cam_hi.data_ptr(),
                     cam_lo.data_ptr(), *ptrs, int(cap), int(max_lod),
                     int(probe == "ridged6"), int(quality != 1.0),
                     *split_f32(radius), *split_f32(quality), level)
        cur, nxt = nxt, cur
    q = 3 * ((int(max_lod) + 1) % 2)      # the parity the last level wrote
    # the flag word is 0 or 1, so its first byte (the card is
    # little-endian) is the bool, read in place by a view
    return (l_int, l_cor, state[q + 1],
            state[q + 2:q + 3].view(torch.bool)[0])


def _check_order_args(lo, hi, depth, c_hi, c_lo, n, overflowed,
                      render_cap: int):
    cap = lo.shape[0] if lo.dim() == 1 else -1
    if not 1 <= int(render_cap) <= cap:
        raise ValueError(f"render_cap {render_cap}: expected 1 <= render_cap "
                         f"<= cap, the leaf rows' {cap}")
    named = [("leaf_lo", lo, torch.int32, (cap,)),
             ("leaf_hi", hi, torch.int32, (cap,)),
             ("leaf_depth", depth, torch.int32, (cap,)),
             ("corners_hi", c_hi, torch.float32, (12, cap)),
             ("corners_lo", c_lo, torch.float32, (12, cap)),
             ("n_leaves", n, torch.int32, ()),
             ("overflowed", overflowed, torch.bool, ())]
    for name, t, dtype, shape in named:
        if t.device != lo.device:
            raise ValueError(f"{name}: expected a tensor on {lo.device}, got "
                             f"{t.device}")
        _cuda.check_cuda(t, name, dtype, shape)


def dfs_order_cuda(lo, hi, depth, c_hi, c_lo, n, overflowed,
                   render_cap: int):
    """The DFS order kernel on R1's leaves, refine_device.dfs_order_plain's
    arguments: (cap,) int32 id words and depths and (12, cap) f32 lane-major
    DF corners in level order at [0, n), n () int32 and overflowed () bool
    on the card. Returns what dfs_order_plain returns, from one launch
    (counted in _cuda.launches["order"])."""
    _check_order_args(lo, hi, depth, c_hi, c_lo, n, overflowed, render_cap)
    dev = lo.device
    i32 = torch.int32
    out = (torch.empty((render_cap,), dtype=i32, device=dev),
           torch.empty((render_cap,), dtype=i32, device=dev),
           torch.empty((render_cap,), dtype=i32, device=dev),
           torch.empty((12, render_cap), dtype=torch.float32, device=dev),
           torch.empty((12, render_cap), dtype=torch.float32, device=dev),
           torch.empty((), dtype=i32, device=dev),
           torch.empty((), dtype=torch.bool, device=dev))
    _cuda.launch("order", "planet_dfs_order",
                 *(t.data_ptr() for t in (lo, hi, depth, c_hi, c_lo, n,
                                          overflowed)),
                 lo.shape[0], int(render_cap), *(t.data_ptr() for t in out))
    return out
