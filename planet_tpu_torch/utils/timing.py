"""Host-side timing utilities (the reference's timing.h; planet_tpu
utils/timing.py, ported).

ScopeTimer / TIMED_FUNCTION (reference timing.h:13-30) become a
context-manager timer and a global toggle (key T). Device work is included
by synchronizing the CUDA device at the end of a block; deep profiling
goes through torch.profiler traces (the driver's --profile), in which
`span` names the port's own host ranges.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_print_timings = False

SPAN_PREFIX = "planet/"
_NO_SPAN = contextlib.nullcontext()
# a range recorded without record_function's Python layers (exported with
# the category cpu_op); absent from older torch builds
_FAST_SPAN = getattr(torch._C._profiler, "_RecordFunctionFast", None)


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
    """Time a block and print its time while timing prints are on. If
    `sync` is given (see `synchronize`), the block's device work on it is
    waited for, so the time includes it."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        synchronize(sync)
    if _print_timings:
        print(f"[timing] {name}: {(time.perf_counter() - t0) * 1e6:.1f} us")


def span(name: str):
    """A context manager that records the block as the host range
    `planet/<name>` in a running torch.profiler trace, on the profiler's
    own clock, which the trace puts its CUDA events on too (up to a drift
    that tools/span_split takes out). With no
    profiler running it is one shared no-op context, and the call costs a
    flag read. It neither waits for the device nor launches anything, so
    a span may wrap a graph's replay; none belongs in code that a CUDA
    graph captures, where it would record the capture once and no
    replay."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    if _FAST_SPAN is not None:
        return _FAST_SPAN(SPAN_PREFIX + name)
    return torch.profiler.record_function(SPAN_PREFIX + name)
