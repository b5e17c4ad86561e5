"""The host time and the device's idle time of a torch.profiler trace, put
down to the port's spans (utils/timing.span: host ranges named
planet/<name> on the clock of the trace's device events).

    python -m planet_tpu_torch.tools.span_split TRACE.json [--window NAME]

reads a Chrome trace (the driver's --profile writes one) and prints one
JSON object. The window is the host range of the first annotation named
NAME (e.g. a benchmark's stretch), else the first planet/render (or
planet/field) span's start to the last one's end; spans that start in it
count. Each instant counts once, at its innermost planet/ span, so nested
spans are not counted twice. The device is idle where none of its
kernels, copies and fills runs. Per step (a planet/render span, else a
planet/field span), in ms:

  enqueue_host_ms     host time in planet/camera, planet/geometry and
                      planet/raster (with upload, replay and capture
                      inside them)
  readback_host_ms    host time in planet/readback
  idle_ms             the device's idle time in the window
  idle_enqueue_ms     ... whose innermost span is camera, geometry,
                      upload, replay, raster or capture
  idle_readback_ms    ... inside planet/readback
  idle_render_own_ms  ... in planet/render's own time
  idle_outside_render_ms  ... outside every planet/render (the caller's
                      loop); with the three above it makes up idle_ms
  idle_field_ms, idle_outside_field_ms  ... inside and outside
                      planet/field
  host_ms, idle_by_span   both by innermost span ("outside": no span)

and `recaptures`, the planet/capture spans in the window, and `lag_us`,
the least and median time from a launching call to the start of the
first device event it launched, by the call's name, as the trace has
them: a negative lag is a skew between the trace's host and device
clocks.

The profiler's two clocks can drift apart within a trace (by 1.5-3.7 us a
ms, hundreds of us over a benchmark's stretch, on the H100 machines), and
an idle gap is then put down to the wrong span. So the device's events
are first put on the host's clock: `clock` is the line fitted through
each step's least lag of a direct launch (a single kernel, copy or fill;
a graph's first node waits for the graph's launch), given by its values
at the window's start and end (None, and no move, with fewer than two
steps holding a direct launch). Each device
event moves by that line less its least value over the window where that
is above 0: a trace without drift stays as it is (a steady lead above 0
cannot be told from the launch latency), a drift is taken out, and no
direct launch's lag stays below 0. A profiled step's
host work is the profiler's too, so these are traced times, not shares
of an untraced step. A trace without planet/ spans gives steps 0 and no
times.

Imports nothing of planet_tpu.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics

from planet_tpu_torch.utils.timing import SPAN_PREFIX

ENQUEUE = ("planet/camera", "planet/geometry", "planet/upload",
           "planet/replay", "planet/raster", "planet/capture")
_HOST_CATS = ("cpu_op", "user_annotation")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_CALL_CATS = ("cuda_runtime", "cuda_driver")


def load(path: str) -> list:
    """The event list of a Chrome trace (torch.profiler's
    export_chrome_trace)."""
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _range(e) -> tuple:
    a = float(e["ts"])
    return a, a + float(e["dur"])


def _complete(events, cats) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def spans(events, t0=None, t1=None, names=None) -> list:
    """[(start us, end us, name)] of the host's planet/ spans (those named
    in `names`, if given) that start in [t0, t1], by start, each cut at
    t1."""
    out = []
    for e in _complete(events, _HOST_CATS):
        name = str(e.get("name", ""))
        if not name.startswith(SPAN_PREFIX) or (names and name not in names):
            continue
        a, b = _range(e)
        if (t0 is None or a >= t0) and (t1 is None or a <= t1):
            out.append((a, b if t1 is None else min(b, t1), name))
    return sorted(out)


def window(events, name=None):
    """(t0, t1): the host range of the first annotation named `name`, else
    the first planet/render (or planet/field) span's start to the last
    one's end; None where there is neither."""
    if name is not None:
        for e in _complete(events, _HOST_CATS):
            if e.get("name") == name:
                return _range(e)
        return None
    for step in ("planet/render", "planet/field"):
        sp = spans(events, names=(step,))
        if sp:
            return sp[0][0], max(b for _, b, _ in sp)
    return None


def pieces(sp) -> list:
    """The time the spans `sp` cover, cut wherever one starts or ends:
    [(start, end, name)] in time order, each piece named by its innermost
    span (the last started of those that cover it, the shorter at a
    tie)."""
    bounds = sorted([(a, 1, i) for i, (a, _, _) in enumerate(sp)]
                    + [(b, 0, i) for i, (_, b, _) in enumerate(sp)])
    active, out, prev = {}, [], None
    for x, opens, i in bounds:
        if active and x > prev:
            inner = max(active.values(), key=lambda s: (s[0], -s[1]))
            out.append((prev, x, inner[2]))
        prev = x
        if opens:
            active[i] = sp[i]
        else:
            active.pop(i, None)
    return out


def _launches(events, t0: float, t1: float) -> list:
    """[(call, its first device event's start - the call's start)] of the
    launching calls in [t0, t1] (matched by the profiler's correlation
    id)."""
    calls = {e["args"]["correlation"]: e for e in _complete(events,
                                                            _CALL_CATS)
             if "correlation" in e.get("args", {})}
    first: dict = {}
    for e in _complete(events, _DEVICE_CATS):
        call = calls.get(e.get("args", {}).get("correlation"))
        if call is None or not t0 <= float(call["ts"]) <= t1:
            continue
        lag = float(e["ts"]) - float(call["ts"])
        if id(call) not in first or lag < first[id(call)][1]:
            first[id(call)] = (call, lag)
    return list(first.values())


def clock_fit(events, steps):
    """(a, b): the device clock's lead over the host's at host time t,
    a + b * (t - t0) from the first step's start t0, fitted through each
    step's least lag of a direct launch (a step launches one while the
    device idles: the camera's uploads, the field's kernel); None with
    fewer than two steps holding one. `steps`: [(start, end, name)]."""
    t0 = steps[0][0] if steps else 0.0
    starts = [s[0] for s in steps]
    least: dict = {}
    for call, lag in _launches(events, t0, steps[-1][1] if steps else 0.0):
        if "Graph" in call["name"]:
            continue
        ts = float(call["ts"])
        k = bisect.bisect_right(starts, ts) - 1
        if k < 0 or ts > steps[k][1]:
            continue
        if k not in least or lag < least[k][1]:
            least[k] = (ts - t0, lag)
    if len(least) < 2:
        return None
    xs, ys = zip(*least.values())
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    var = sum((x - mx) ** 2 for x in xs)
    b = (sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / var
         if var > 0 else 0.0)
    return my - b * mx, b


def shift(fit, t0: float, t1: float):
    """f(t): the us by which a device event that starts at host time t
    moves back, given clock_fit's line `fit` from t0 and the window's end
    t1: the line less its least value over [t0, t1] where that is above 0
    (none without a fit)."""
    if fit is None:
        return lambda t: 0.0
    a, b = fit
    floor = max(0.0, min(a, a + b * (t1 - t0)))
    return lambda t: a + b * (t - t0) - floor


def device_ranges(events, move) -> list:
    """[(start, end)] of the device's kernels, copies and fills, each moved
    back by move(its start) (shift's)."""
    out = []
    for e in _complete(events, _DEVICE_CATS):
        a, b = _range(e)
        d = move(a)
        out.append((a - d, b - d))
    return out


def device_gaps(ranges, t0: float, t1: float) -> list:
    """[(start, end)]: the stretches of [t0, t1] that none of the device's
    ranges [(start, end)] covers."""
    gaps, cur = [], t0
    for a, b in sorted(ranges):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


def by_span(sp, intervals) -> dict:
    """{innermost span name: us of `intervals` [(start, end)] under it;
    None: the us outside every span of `sp`}."""
    ps = pieces(sp)
    starts = [p[0] for p in ps]
    out: dict = {None: 0.0}
    for ga, gb in intervals:
        covered = 0.0
        i = max(0, bisect.bisect_right(starts, ga) - 1)
        while i < len(ps) and ps[i][0] < gb:
            a, b, name = ps[i]
            over = min(b, gb) - max(a, ga)
            if over > 0:
                out[name] = out.get(name, 0.0) + over
                covered += over
            i += 1
        out[None] += (gb - ga) - covered
    return out


def launch_lag_us(events, t0: float, t1: float) -> dict:
    """{call name: {n, least, median}} of the time from a launching call
    in [t0, t1] to the start of the first device event it launched, as
    the trace has them; "all" over every call."""
    groups: dict = {}
    for call, lag in _launches(events, t0, t1):
        groups.setdefault(call["name"], []).append(lag)
        groups.setdefault("all", []).append(lag)
    return {name: {"n": len(v), "least": min(v),
                   "median": statistics.median(v)}
            for name, v in sorted(groups.items())}


def split(events, window_name=None) -> dict:
    """The summary the module docstring lists, over the window."""
    win = window(events, window_name)
    out = {"steps": 0}
    if win is None:
        return out
    t0, t1 = win
    sp = spans(events, t0, t1)
    renders = [s for s in sp if s[2] == "planet/render"]
    fields = [s for s in sp if s[2] == "planet/field"]
    steps = len(renders) or len(fields)
    out["steps"] = steps
    if not steps:
        return out

    def ms(us):
        return us / 1e3 / steps

    fit = clock_fit(events, renders or fields)
    start = (renders or fields)[0][0]
    gaps = device_gaps(device_ranges(events, shift(fit, start, t1)), t0, t1)
    host = by_span(sp, [(t0, t1)])
    idle = by_span(sp, gaps)
    out.update(
        window_ms=ms(t1 - t0),
        idle_ms=ms(sum(b - a for a, b in gaps)),
        recaptures=sum(1 for s in sp if s[2] == "planet/capture"),
        host_ms={str(k or "outside"): ms(v) for k, v in host.items()},
        idle_by_span={str(k or "outside"): ms(v) for k, v in idle.items()},
        lag_us=launch_lag_us(events, t0, t1),
        clock=None if fit is None else {
            "lead_us_at_start": fit[0] + fit[1] * (t0 - start),
            "lead_us_at_end": fit[0] + fit[1] * (t1 - start)})
    if renders:
        out.update(
            enqueue_host_ms=ms(sum(host.get(n, 0.0) for n in ENQUEUE)),
            readback_host_ms=ms(host.get("planet/readback", 0.0)),
            idle_enqueue_ms=ms(sum(idle.get(n, 0.0) for n in ENQUEUE)),
            idle_readback_ms=ms(idle.get("planet/readback", 0.0)),
            idle_render_own_ms=ms(idle.get("planet/render", 0.0)),
            idle_outside_render_ms=ms(by_span(renders, gaps)[None]))
    if fields:
        field = by_span(fields, gaps)
        out.update(idle_field_ms=ms(field.get("planet/field", 0.0)),
                   idle_outside_field_ms=ms(field[None]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="span_split")
    ap.add_argument("trace", help="a Chrome trace (JSON)")
    ap.add_argument("--window", default=None, metavar="NAME",
                    help="the annotation whose host range is the window")
    args = ap.parse_args(argv)
    print(json.dumps(split(load(args.trace), args.window), indent=1))


if __name__ == "__main__":
    main()
