"""Fragment shading (reference fragment shader, main.cpp:369-381;
planet_tpu raster/shade.py, ported).

One directional light l = normalize(0, 1, -1); intensity
0.001 + max(0, dot(n, l)); grayscale colour sqrt(intensity) (gamma).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_LIGHT = np.array([0.0, 1.0, -1.0], np.float32)
_LIGHT = _LIGHT / np.sqrt((_LIGHT * _LIGHT).sum())


@functools.lru_cache(maxsize=None)
def _light(device: str) -> torch.Tensor:
    # uploaded once per device: lambert then copies nothing from the host
    # (so it can run inside a CUDA-graph capture)
    return torch.as_tensor(_LIGHT, device=device)


