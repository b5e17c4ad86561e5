"""The port's one float32 square root.

The kernels take sqrtf built with -prec-sqrt=true, which is correctly
rounded, and so is torch.sqrt on a CUDA tensor. torch.sqrt on a float32
CPU tensor is not on every host: on one AVX-512 host it was 1 ulp off in
about one input in six (e.g. sqrt(3762.098) gave 61.335945 against the
correctly rounded 61.335941), so a plain version on the CPU would neither
equal what the card computes nor be the same on two hosts. sqrt_rn takes
the root of a CPU float32 tensor in float64 and rounds it to float32,
which is exact: float64 carries at least 2 * 24 + 2 bits, so rounding the
correctly rounded float64 root to float32 gives the correctly rounded
float32 root. (torch.sqrt on a float64 CPU tensor was off on the same
host too, 19 of 1,024 inputs; the port takes no float64 root in torch.)

Every square root of the port's plain paths goes through sqrt_rn
(tests/test_torch_fp.py scans the sources for any other).
"""

from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of x: any tensor on the card, a
    float32 tensor on the CPU."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    if x.dtype != torch.float32:
        raise TypeError(f"sqrt_rn takes float32 on the CPU, got {x.dtype}")
    return torch.sqrt(x.double()).float()
