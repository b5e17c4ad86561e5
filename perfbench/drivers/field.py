"""The whole-cube field regen: models/heightfield.frame_cube(n, radius,
fused=True), heights and Lambert shade of the six n x n faces (K5), the
frame of a user generating planets.

Closed loop: each regen's call is followed by a synchronize, and the next
starts when its heights and shade are finished on the device. Each regen
takes the traffic's radius for it (no two alike, so nothing computed for
one serves the next). A regen that raises counts in `failed`.

Correctness: the regens at the seed's sample points keep their outputs
(the program allocates new ones each call) and are compared, once the
window has closed and the program's state is freed, with the plain
reference's field for the same radius (reference/field.py).
"""

from __future__ import annotations

import sys
import time

import torch

from perfbench.drivers.common import (Result, RunError, max_gap,
                                      read_metrics, reduce_trace,
                                      sample_times)
from perfbench.harness import roofline
from perfbench.harness import trace as trace_mod
from perfbench.harness import traffic as traffic_mod
from perfbench.reference import field as ref_field

__all__ = ["Run", "RunError"]


class Run:
    def __init__(self, cell, *, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, control: bool = False):
        self.c = cell
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.control = control
        self.settings = dict(cell.config["settings"])
        self.n = int(self.settings.pop("n"))
        self.radius = float(self.settings.pop("radius"))
        self.regens = traffic_mod.make(cell.traffic, self.seed, self.radius)
        self.samples = []      # (radius, heights, shade)
        self.red = None

    def _regen(self, k):
        from planet_tpu_torch.models import heightfield
        out = heightfield.frame_cube(self.n, self.regens.radius_at(k),
                                     fused=True, device=self.device,
                                     **self.settings)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return out

    def measure(self) -> Result:
        cuda = self.device.type == "cuda"
        cfg = self.c.config
        warm = int(self.c.traffic["warmup_regens"])
        try:
            for k in range(warm):
                self._regen(k)
        except Exception as e:
            raise RunError(f"set-up: a warm-up regen raised {e!r}") from e
        trace_steps = int(cfg["trace_regens"]) if self.trace else 0
        marks = sample_times(self.seed, int(cfg["samples"]))
        k, failed = warm, 0
        t_win = time.perf_counter()
        setup_s = t_win - self.t_start
        if trace_steps:
            with trace_mod.session(cuda) as holder:
                for _ in range(int(cfg["trace_lead"])):
                    self._regen(k)
                    k += 1
                with trace_mod.stretch():
                    for _ in range(trace_steps):
                        with trace_mod.step():
                            self._regen(k)
                        k += 1
            # the profiler's export took its time: the window proper, with
            # its sample points, starts now
            t_win = time.perf_counter()
        k_win = k
        while True:
            el = time.perf_counter() - t_win
            if el >= self.seconds:
                break
            try:
                h, s = self._regen(k)
            except Exception as e:      # a regen that raises has failed
                failed += 1
                print(f"perfbench: regen {k} raised {e!r}", file=sys.stderr,
                      flush=True)
                k += 1
                continue
            if marks and el >= marks[0] * self.seconds:
                marks.pop(0)
                self.samples.append((self.regens.radius_at(k), h, s))
            k += 1
        window_s = time.perf_counter() - t_win
        regens = k - warm
        res = Result(attempted=regens, failed=failed)
        if regens == failed:
            raise RunError("no regen finished in the window")
        res.end_to_end = {"regen_ms": window_s * 1e3 / max(1, k - k_win),
                          "setup_s": setup_s}
        if cuda:
            res.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        if trace_steps:
            bound = roofline.field_bound_ms(self.n,
                                            int(self.settings["octaves"]))
            try:
                # a regen of the untraced window, for the idle share
                step_s = res.end_to_end["regen_ms"] / 1e3
                self.red = reduce_trace(holder.events, self.c.layers,
                                        trace_steps,
                                        {"k5_bound_ms": bound,
                                         "step_s": step_s})
            except trace_mod.TraceError as e:
                raise RunError(str(e)) from e
            res.busy_s, res.window_s = self.red.busy_s, self.red.window_s
            res.breakdown = self.red.breakdown()
        return res

    def release(self):
        pass

    def per_layer(self) -> dict:
        return read_metrics(self.c.readers(), self.red)

    def check(self) -> dict:
        limits = self.c.config["limits"]
        worst = {k: 0.0 for k in limits}
        for radius, h, s in self.samples:
            rh, rs = ref_field.field(self.n, radius, self.settings,
                                     self.device)
            if self.control:
                h, s = ref_field.field(self.n, radius, self.settings,
                                       self.device, f32_control=True)
            got = {"height_gap_m": max_gap(h, rh),
                   "shade_gap": max_gap(s, rs)}
            for name, v in got.items():
                worst[name] = max(worst[name], v)
            del rh, rs
        return {name: {"value": worst[name], "limit": limits[name]}
                for name in limits}
