"""Host-side timing utilities (the reference's timing.h; planet_tpu
utils/timing.py, ported).

ScopeTimer / TIMED_FUNCTION (reference timing.h:13-30) become a
context-manager timer and a global toggle (key T). Device work is included
by synchronizing the CUDA device at the end of a block; deep profiling
goes through torch.profiler traces (the driver's --profile).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_print_timings = False
_accum = defaultdict(lambda: [0.0, 0])  # name -> [total_s, count]


def toggle_timing():
    """The reference's key-T toggle (main.cpp:996-1000)."""
    global _print_timings
    _print_timings = not _print_timings
    return _print_timings


def timing_enabled():
    return _print_timings


def synchronize(sync) -> None:
    """Wait for the device work behind `sync`: a tensor, a torch.device or
    device string, or a list or tuple of them. CPU tensors and devices need
    no wait, so nothing here touches CUDA on a machine without it."""
    if isinstance(sync, (list, tuple)):
        for s in sync:
            synchronize(s)
        return
    if isinstance(sync, torch.Tensor):
        sync = sync.device
    sync = torch.device(sync)
    if sync.type == "cuda":
        torch.cuda.synchronize(sync)


@contextlib.contextmanager
def timed(name: str, sync=None):
    """Time a block. If `sync` is given (see `synchronize`), the block's
    device work on it is waited for, so the time includes it."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        synchronize(sync)
    dt = time.perf_counter() - t0
    _accum[name][0] += dt
    _accum[name][1] += 1
    if _print_timings:
        print(f"[timing] {name}: {dt * 1e6:.1f} us")


def bench(fn, *args, warmup=2, iters=10):
    """Median wall time of fn(*args) in seconds, each call's device work
    waited for: fn's result, a tensor or a list or tuple holding tensors."""
    def run():
        out = fn(*args)
        outs = out if isinstance(out, (list, tuple)) else [out]
        synchronize([t for t in outs if isinstance(t, torch.Tensor)])

    for _ in range(warmup):
        run()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def report():
    return {k: {"total_s": v[0], "count": v[1]} for k, v in _accum.items()}
