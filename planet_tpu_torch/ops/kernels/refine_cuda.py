"""The device refine kernel (R1): the fused frame's LOD refinement on the card.

`refine_cuda` launches the hand-written kernel in csrc/refine.cu for CUDA
tensors and raises for anything else; lod/refine_device.refine_device is
the entry point, which runs the plain version, refine_device.refine_plain,
for CPU tensors. planet_tpu has no Pallas refine kernel: its device refine
(planet_tpu/lod/refine_device.py:153) is one jit whose probes call K4
(perlin_pallas.py:370) and whose while_loop skips dead slots and stops at
an empty frontier. R1 is that program as CUDA C++: a launch a level, K4's
noise core inlined at the probes, dead slots and emptied levels skipped on
the card, bit for bit equal to refine_plain.

The frontier and leaf layout is refine_plain's: ints (3, cap) (id lo, id
hi, depth) and corners (24, cap) (hi rows 0-11, lo rows 12-23, row =
corner*3 + axis). The wrapper reads no tensor value and allocates every
buffer from metadata, so it stays legal inside a CUDA-graph capture (the
noise tables come from perlin_cuda.kernel_tables' cache, which an eager
call fills first).
"""

from __future__ import annotations

import numpy as np
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.ops.kernels import perlin_cuda

PROBES = ("zero", "ridged6")


def frontier(root_lo, root_hi, root_ch, root_cl, root_depth, cap: int):
    """The first frontier from R roots: ints (3, cap) and corners (24, cap),
    the roots in columns [0, R), zeros after them."""
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
    for name, t, dtype, shape in named[:2]:     # the kernel reads these
        _cuda.check_cuda(t, name, dtype, shape)
    return n_roots


def refine_cuda(cam_hi, cam_lo, root_lo, root_hi, root_ch, root_cl, *,
                max_lod: int, cap: int, radius: float, probe: str = "zero",
                root_depth=None, quality: float = 1.0):
    """R1 from R roots on the card; refine_device.refine_plain's arguments.

    Returns (l_int (3, cap) int32 leaf id lo, id hi, depth; l_cor (24, cap)
    f32 leaf corners; n_leaves () int32; overflowed () bool), leaves in
    level order at [0, n_leaves) and zeros after them. One launch a level
    (its evaluate and compact kernels), max_lod + 1 in all."""
    n_roots = _check_args(cam_hi, cam_lo, root_lo, root_hi, root_ch, root_cl,
                          root_depth, max_lod=max_lod, cap=cap, probe=probe)
    dev = cam_hi.device
    i32 = torch.int32
    cur = frontier(root_lo, root_hi, root_ch, root_cl, root_depth, cap)
    nxt = (torch.empty_like(cur[0]), torch.empty_like(cur[1]))
    kid_int = torch.empty((4, 3, cap), dtype=i32, device=dev)
    kid_cor = torch.empty((4, 24, cap), dtype=torch.float32, device=dev)
    flags = torch.empty((cap,), dtype=i32, device=dev)
    state = torch.zeros((3,), dtype=i32, device=dev)   # f_n, l_n, overflow
    state[0].fill_(n_roots)
    l_int = torch.zeros((3, cap), dtype=i32, device=dev)
    l_cor = torch.zeros((24, cap), dtype=torch.float32, device=dev)
    ridged = probe == "ridged6"
    tables = (perlin_cuda.kernel_tables(2.0, str(dev)) if ridged
              else (None, None, None))
    ptrs = [None if t is None else t.data_ptr() for t in tables]
    rad, qual = split_f32(radius), split_f32(quality)
    for _ in range(int(max_lod) + 1):
        _cuda.launch("refine", "planet_refine_level", cur[0].data_ptr(),
                     cur[1].data_ptr(), nxt[0].data_ptr(), nxt[1].data_ptr(),
                     kid_int.data_ptr(), kid_cor.data_ptr(),
                     flags.data_ptr(), state.data_ptr(), l_int.data_ptr(),
                     l_cor.data_ptr(), cam_hi.data_ptr(), cam_lo.data_ptr(),
                     *ptrs, int(cap), int(max_lod), int(ridged),
                     int(quality != 1.0), *rad, *qual)
        cur, nxt = nxt, cur
    return l_int, l_cor, state[1], state[2] != 0
