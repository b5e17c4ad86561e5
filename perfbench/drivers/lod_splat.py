"""The interactive LOD frame in the splat raster mode: drivers/lod.py's run
(the same program entry, DeviceInteractiveEngine.render, window, trace and
readers) with three differences. A frame fails when it raises or the
geometry step's overflow flag is set: the splat raster has no counters
of its own. The kept frames are checked against reference/lod_splat.py,
the frozen splat on the frozen geometry. The traced run also works out
S1's least time on each picked stretch frame (harness/roofline_splat,
over the cells and covered pixels of the reference's own splat frame at
that camera) for metrics/s1_roofline.py."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench.drivers import lod
from perfbench.harness import roofline_splat
from perfbench.harness import trace as trace_mod
from perfbench.reference import lod_splat as ref_splat

__all__ = ["Run", "RunError"]

RunError = lod.RunError


class Run(lod.Run):
    def _flags(self, traced: bool):
        """Add this frame's geometry overflow flag to the device's tally:
        no host read, one launch (annotated as the harness's in a
        trace)."""
        meta = self.eng.renderer.last_geometry.meta
        with trace_mod.harness() if traced else contextlib.nullcontext():
            self.fail_tally.add_(meta[2] != 0)

    def _picks(self) -> list:
        """The complete stretch frames the readers' bounds are worked out
        on: `v1_frames` of them, spread evenly, as drivers/lod.py picks
        V1's."""
        done = self.red.complete
        n = min(int(self.c.config["v1_frames"]), len(done))
        return sorted({done[j] for j in np.linspace(
            0, len(done) - 1, n).astype(int)})

    def per_layer(self) -> dict:
        rcfg = self._ref_cfg()
        bounds = {}
        for i in self._picks():
            k = self.stretch_k0 + i
            cells, covered = ref_splat.work(
                rcfg, self.width, self.height, self.engine_kw, self._pos[k],
                self._ang[k], self.device)
            bounds[i] = roofline_splat.splat_bound_ms(
                cells, rcfg.raster_supersample, int(self.engine_kw[
                    "render_cap"]), rcfg.patch_verts + 2, covered)
        self.red.extras["s1_bound_ms"] = bounds
        return super().per_layer()

    def check(self) -> dict:
        """Each compared number over the kept frames, with its limit."""
        rcfg = self._ref_cfg()
        limits = self.c.config["limits"]
        worst = {k: 0.0 for k in limits}
        for k, s in self.samples:
            args = (rcfg, self.width, self.height, self.engine_kw,
                    self._pos[k], self._ang[k], s["book"], self.device)
            ref = ref_splat.frame(*args)
            if self.control:
                got = ref_splat.frame(*args, f32_control=True)
                s = dict(n=torch.tensor(got.n_leaves), leaf_lo=got.leaf_lo,
                         leaf_hi=got.leaf_hi, leaf_depth=got.leaf_depth,
                         tiles=got.tiles, clip=got.clip, image=got.image,
                         depth=got.depth, after=got.book)
            for name, v in lod.compare(s, ref).items():
                worst[name] = max(worst[name], v)
        return {name: {"value": worst[name], "limit": limits[name]}
                for name in limits}
