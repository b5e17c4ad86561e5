"""The least time of S1's work, the splat raster's kernel
(planet_tpu_torch/csrc/splat.cu, `cell_kernel`), on one H100 SXM, frozen
from the port's attribution tool (planet_tpu_torch/tools/kernel_times.py,
OPS_SPLAT_FRAGMENT and its splat bound, as of the commit that added this
file), at harness/roofline.py's rates, so that a later change to the
program cannot move the yardstick.

Operations: each of the k x k fragments of every cell whose four corners
pass the back-face cull, 60 f32 operations a fragment (the blend of five
values 35, the w test and reciprocal 2, the NDC 3, the pixel 8, the range
and depth tests 2, the two clamped quantizations 10). Bytes: every grid
vertex's clip position, shade and validity read once (21 B) and each
covered pixel's key written once (4 B)."""

from __future__ import annotations

from perfbench.harness import roofline

OPS_SPLAT_FRAGMENT = 60


def splat_bound_ms(cells: int, k: int, rows: int, grid: int,
                   covered: int) -> float:
    """S1 on `rows` (grid x grid) patch grids at supersample k: `cells`
    cells pass the cull, `covered` pixels take a fragment."""
    return roofline.bound_ms(cells * k * k * OPS_SPLAT_FRAGMENT,
                             rows * grid * grid * 21 + covered * 4)
