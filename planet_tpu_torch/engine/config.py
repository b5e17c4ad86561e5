"""Engine configuration — one frozen dataclass (planet_tpu
engine/config.py, copied — the fields the port reads — so the port imports
nothing of planet_tpu).

The reference has no config system: everything is a compile-time constant
(SURVEY.md section 5 lists them all). Defaults here are those exact values.
planet_tpu's leaf_pad, gen_pad and use_pallas are jit-bucket sizes and the
TPU-kernel switch, so they are not copied (the port's device switch is the
engines' `device`).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    radius: float = 6371000.0          # main.cpp:821
    tile_dim: int = 32                 # main.cpp:194
    patch_verts: int = 30              # main.cpp:391
    generations_per_frame: int = 100   # main.cpp:653
    cache_capacity: int = 1024         # CACHE_MAX, main.cpp:75
    fovy_deg: float = 50.0             # main.cpp:1072
    near_plane: float = 1.0            # main.cpp:1074
    far_plane: float = 20000000.0      # main.cpp:1075
    window_w: int = 800                # main.cpp:759
    window_h: int = 600
    # terrain (main.cpp:823-832)
    lacunarity: float = 2.0
    gain: float = 0.55
    coord_scale: float = 0.00001
    amplitude: float = 8848.0
    # rasterizer: "exact" = exact-coverage triangle raster (render.cpp
    # semantics, raster/coverage_cuda.py); "splat" = depth-tested vertex
    # splats (raster/splat.py)
    raster_mode: str = "exact"
    raster_supersample: int = 4        # splat fragments per cell edge
    check_finite: bool = False         # per-frame NaN/inf tile guard
    # LOD quality dial: multiplies the split threshold d (split iff
    # 2*dist^2 < lod_quality * d). 1.0 is exactly the reference rule
    # (main.cpp:558-571, the hardcoded 2.5 ladder); larger values refine
    # deeper at the same distance.
    lod_quality: float = 1.0

    @property
    def patch_quads(self) -> int:
        return self.patch_verts - 1

    @property
    def max_lod(self) -> int:
        """(int)(log2(2*pi*r / patch_quads) - 2) (main.cpp:497)."""
        return int(math.log2(2.0 * math.pi * self.radius / self.patch_quads) - 2)

    @property
    def max_skirt_size(self) -> float:
        """(2*pi*r)/(4*patch_quads) * coord_scale * 8 * amplitude
        (main.cpp:500)."""
        return ((2.0 * math.pi * self.radius) / (4.0 * self.patch_quads)
                * self.coord_scale * 8.0 * self.amplitude)

    def skirt_size_for_depth(self, depth: int) -> float:
        """Reference skirt scaling (main.cpp:674-677): divide by 2<<(d-1)
        for quads deeper than 1."""
        s = self.max_skirt_size
        d1 = int(depth) - 1
        if d1 > 0:
            s /= float(2 << d1)
        return s

    def octaves_for_depth(self, depth: int) -> int:
        """6 + 12*depth/max_lod with C integer division (main.cpp:827)."""
        return 6 + (12 * int(depth)) // self.max_lod
