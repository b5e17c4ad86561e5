"""The refine's frontier layout and constants (R1's wrapper, without its
launch): `frontier` makes the first frontier from the roots, `split_f32`
splits a float64 constant into its double-float pair.
"""

from __future__ import annotations

import numpy as np
import torch


PROBES = ("zero", "ridged6")
# the probes a slot (its 4 corners, then the normalized midpoint) and the
# ridged octaves a probe; a warp's lanes
N_PROBES, PROBE_OCTAVES, WARP = 5, 6, 32


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


