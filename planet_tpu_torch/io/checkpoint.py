"""State persistence (reference SaveState, main.cpp:858-894, 1118-1138;
planet_tpu io/checkpoint.py, copied so the port imports nothing of
planet_tpu).

The reference fwrites a raw struct {active camera, 12 saved camera slots} to
a file called "save" at exit and freads it at startup, silently keeping
defaults on a short read. Same semantics here with an npz container; the
heightmap cache is deliberately NOT persisted — tiles are pure functions of
their quad id and regenerate (reference behavior).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from planet_tpu_torch.geom.camera import Camera

N_SLOTS = 12


def default_state(radius: float = 6371000.0) -> Tuple[Camera, List[Camera]]:
    active = Camera(position=np.array([0.0, 0.0, -radius - 10.0]))
    slots = [Camera() for _ in range(N_SLOTS)]
    return active, slots


def save(path: str, active: Camera, slots: List[Camera]) -> None:
    pos = np.stack([active.position] + [c.position for c in slots])
    ang = np.stack([active.angles] + [c.angles for c in slots])
    tmp = path + ".tmp"
    np.savez(tmp, positions=pos, angles=ang)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load(path: str, radius: float = 6371000.0) -> Tuple[Camera, List[Camera]]:
    """Returns saved state, or defaults if the file is missing/corrupt
    (reference: silent fallback with a warning, main.cpp:869-888)."""
    active, slots = default_state(radius)
    try:
        with np.load(path) as z:
            pos = z["positions"]
            ang = z["angles"]
        if pos.shape != (1 + N_SLOTS, 3) or ang.shape != (1 + N_SLOTS, 3):
            raise ValueError("bad shapes")
        active = Camera(position=pos[0].astype(np.float64),
                        angles=ang[0].astype(np.float32))
        slots = [Camera(position=pos[i + 1].astype(np.float64),
                        angles=ang[i + 1].astype(np.float32))
                 for i in range(N_SLOTS)]
    except Exception:
        import logging
        logging.getLogger(__name__).warning("Couldn't read save file.")
    return active, slots
