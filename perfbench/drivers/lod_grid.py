"""The interactive LOD frame at any patch size: drivers/lod.py's run (the
same program, window, trace and readers) checked against
reference/lod_grid.py, the frozen reference with its vertex program's
patch-quads divisor taken from the configuration, in place of
reference/lod.py, whose divisor is the 30-vertex patch's."""

from __future__ import annotations

from perfbench.drivers import lod
from perfbench.reference import lod_grid

__all__ = ["Run", "RunError"]

RunError = lod.RunError


class Run(lod.Run):
    def check(self) -> dict:
        with lod_grid.patch_quads(self._ref_cfg()):
            return super().check()
