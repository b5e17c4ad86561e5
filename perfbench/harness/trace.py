"""A torch.profiler window over a bounded stretch of steady steps, reduced
to the numbers the per-layer readers take; the trace itself is written to
the run's temporary directory, read once and deleted.

The stretch is the host-clock range of a `perfbench/stretch` annotation,
and each of its steps (a frame, a regen) the range of a `perfbench/step`
annotation inside it. A device event (kernel, copy, fill) belongs to the
step in which the host call that launched it lies (matched by the
profiler's correlation id), or, where the trace lost that call, to the
step in which it starts on the device. Events whose launch the harness
made itself (inside a `perfbench/harness` annotation) are left out. Each
device event is given a layer by the configuration's layer table
(perfbench/layers/<config>.json): the first rule whose regular expression
finds the event's name gives its layer, "@previous" the layer of the
device event before it in time (a generic torch kernel belongs to the
stage it runs in) or the third element of the rule that gave that event
its layer, and a name no rule finds counts under "other".

The profiler now and then loses events. A step is complete when it shows
every one of the table's "require" kernels and the trace lost none of its
launches: no device event of it lacks its host call where events of the
same name have theirs elsewhere in the stretch. The per-step numbers are
taken over the complete steps alone, so a lost event costs its step, not
the reading; fewer complete steps than half the stretch refuse the trace,
as does a "require" kernel that no step shows: a profiler that missed a
kernel must not report its layer as 0.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

STRETCH = "perfbench/stretch"
STEP = "perfbench/step"
HARNESS = "perfbench/harness"
# host calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the slack of the device's clock against the host's over a session
SLACK_US = 500.0


class TraceError(Exception):
    pass


def harness():
    """The annotation around the harness's own launches in a stretch."""
    import torch
    return torch.profiler.record_function(HARNESS)


def stretch():
    """The annotation around the stretch of steps that the trace reduces;
    steps profiled before it (a lead-in, while the profiler settles) are
    left out."""
    import torch
    return torch.profiler.record_function(STRETCH)


def step():
    """The annotation around one step of the stretch."""
    import torch
    return torch.profiler.record_function(STEP)


@contextlib.contextmanager
def session(cuda: bool):
    """Profile the block, which holds one `stretch`; yields a holder whose
    `.events` is the trace's event list once the block has ended."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    holder = type("Holder", (), {})()
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _span(e):
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


class Reduced:
    """A stretch of steps, reduced: device events with their layers and
    steps, host syncs, the busy and window seconds, the breakdown; the
    per-step numbers over the complete steps."""

    def __init__(self, events: list, table: dict, steps: int, extras=None):
        self.extras = extras or {}

        def host(name):
            # the profiler also projects each annotation onto the device's
            # timeline ("gpu_user_annotation"); the host's range is the one
            return [e for e in events if e.get("name") == name
                    and e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"]

        spans = host(STRETCH)
        if not spans:
            raise TraceError("the trace holds no stretch annotation")
        self.t0, self.t1 = _span(spans[0])
        starts = sorted(float(e["ts"]) for e in host(STEP)
                        if self.t0 <= float(e["ts"]) <= self.t1)
        if len(starts) != int(steps):
            raise TraceError(f"the stretch holds {len(starts)} step "
                             f"annotations, not {int(steps)}")
        self.steps = len(starts)
        own = [_span(e) for e in host(HARNESS)]

        def in_harness(ts):
            return any(a <= ts <= b for a, b in own)

        def step_at(ts):
            """The step whose host range holds ts (the last one started
            before it), or None before the first."""
            lo, hi = 0, len(starts)
            while lo < hi:
                mid = (lo + hi) // 2
                if starts[mid] <= ts:
                    lo = mid + 1
                else:
                    hi = mid
            return lo - 1 if lo else None

        runtime = [e for e in events if e.get("ph") == "X" and e.get("cat")
                   in ("cuda_runtime", "cuda_driver")]
        call_at = {e["args"].get("correlation"): float(e["ts"])
                   for e in runtime if "correlation" in e.get("args", {})}

        def call_of(e):
            return call_at.get(e.get("args", {}).get("correlation"))

        def of_stretch(e):
            """Launched in the stretch, not by the harness; an event whose
            call the trace lost starts in it (late on the device's clock
            by SLACK_US at most)."""
            call = call_of(e)
            if call is None:
                return self.t0 <= float(e["ts"]) <= self.t1 + SLACK_US
            return self.t0 <= call <= self.t1 and not in_harness(call)

        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in _DEVICE_CATS and of_stretch(e)]
        dev.sort(key=lambda e: float(e["ts"]))
        self.device = []          # (name, start us, dur us, layer, step)
        self.unmapped = set()
        rules = [(re.compile(r[0]), r[1], r[2] if len(r) > 2 else None)
                 for r in table["rules"]]
        prev = "other"
        orphans = []              # (step, name): the trace lost the call
        partnered = set()         # names some of whose calls it kept
        for e in dev:
            name = e["name"]
            hit = next(((lay, nxt) for rx, lay, nxt in rules
                        if rx.search(name)), None)
            if hit is None:
                layer, nxt = "other", None
                self.unmapped.add(name)
            else:
                layer, nxt = hit
                if layer == "@previous":
                    layer = prev
            prev = nxt or layer
            call = call_of(e)
            st = step_at(call if call is not None else float(e["ts"]))
            if call is None:
                orphans.append((st, name))
            else:
                partnered.add(name)
            self.device.append((name, float(e["ts"]), float(e["dur"]),
                                layer, st))
        required = [re.compile(p) for p in table.get("require", [])]
        names = {d[0] for d in self.device}
        missing = [rx.pattern for rx in required
                   if not any(rx.search(n) for n in names)]
        if missing:
            raise TraceError("the trace shows no device event named like "
                             + ", ".join(missing))
        # the steps the trace lost something of
        lost = {st for st, name in orphans if name in partnered}
        shown = [set() for _ in range(self.steps)]
        for name, _, _, _, st in self.device:
            if st is not None:
                shown[st].add(name)
        for st in range(self.steps):
            if not all(any(rx.search(n) for n in shown[st])
                       for rx in required):
                lost.add(st)
        self.lost_events = sum(1 for _, name in orphans if name in partnered)
        self.complete = [st for st in range(self.steps) if st not in lost]
        if 2 * len(self.complete) < self.steps:
            raise TraceError(f"the trace lost events in {len(lost)} of "
                             f"{self.steps} steps")
        ok = set(self.complete)
        self.syncs = sum(
            1 for e in runtime
            if e["name"] in SYNC_CALLS and self.t0 <= float(e["ts"]) <= self.t1
            and not in_harness(float(e["ts"]))
            and step_at(float(e["ts"])) in ok)
        self.cpu = [e for e in events if e.get("ph") == "X"
                    and e.get("cat") in ("cpu_op", "cuda_runtime",
                                         "cuda_driver", "user_annotation",
                                         "python_function")
                    and e.get("name") not in (STRETCH, STEP)]
        self.busy_us, self.gaps = self._union(
            (s, d) for _, s, d, _, _ in self.device)
        self.complete_busy_us, _ = self._union(
            (s, d) for _, s, d, _, st in self.device if st in ok)

    def _union(self, intervals):
        """(busy us of the intervals (start, dur) inside the stretch, idle
        gaps [(start, end)])."""
        busy, gaps = 0.0, []
        cur_s, cur_e = None, self.t0
        for s, d in sorted(intervals):
            s, e = max(s, self.t0), min(s + d, self.t1)
            if e <= s:
                continue
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        gaps.append((cur_e, self.t1))
        return busy, [g for g in gaps if g[1] > g[0]]

    # ---- what the readers take
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    def _complete_events(self):
        ok = set(self.complete)
        return [d for d in self.device if d[4] in ok]

    def busy_ms_per_step(self) -> float:
        """Device-busy ms a step (the union of its activity) over the
        complete steps."""
        return self.complete_busy_us / 1e3 / len(self.complete)

    def idle_share(self, step_s: float) -> float:
        """The device's idle share, %, of a step that takes step_s seconds
        on the host clock: 1 - its busy time over step_s."""
        return 100.0 * (1.0 - self.busy_ms_per_step() / 1e3 / step_s)

    def events_per_step(self) -> float:
        return len(self._complete_events()) / len(self.complete)

    def syncs_per_step(self) -> float:
        return self.syncs / len(self.complete)

    def layer_ms_per_step(self, layer: str) -> float:
        return sum(d[2] for d in self._complete_events() if d[3] == layer) \
            / 1e3 / len(self.complete)

    def step_durations_ms(self, step: int, pattern: str) -> list:
        """The durations of step `step`'s device events named like
        `pattern`, in time order."""
        rx = re.compile(pattern)
        return [d[2] / 1e3 for d in self.device
                if d[4] == step and rx.search(d[0])]

    def durations_ms(self, pattern: str) -> list:
        """The durations of the complete steps' device events named like
        `pattern`, in time order."""
        rx = re.compile(pattern)
        return [d[2] / 1e3 for d in self._complete_events()
                if rx.search(d[0])]

    def has_layer(self, layer: str) -> bool:
        return any(d[3] == layer for d in self._complete_events())

    def _host_at(self, ts: float) -> str:
        """The innermost host event that covers ts."""
        best = None
        for e in self.cpu:
            a = float(e["ts"])
            b = a + float(e["dur"])
            if a <= ts <= b and (best is None or float(e["dur"]) <
                                 float(best["dur"])):
                best = e
        return best["name"] if best is not None else "python, no traced op"

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for n, _, d, _, _ in self.device:
            key = n if len(n) <= 96 else n[:93] + "..."
            by_name[key] = by_name.get(key, 0.0) + d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self._host_at((a + b) / 2), (b - a) / 1e6]
                              for a, b in gaps]}
