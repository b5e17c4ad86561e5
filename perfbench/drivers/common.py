"""What every entry point's driver shares: the run's result, the sampled
steps of the window, the trace's reduction and the readers."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from perfbench.harness import trace as trace_mod


class RunError(Exception):
    pass


@dataclasses.dataclass
class Result:
    attempted: int = 0
    failed: int = 0
    end_to_end: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    busy_s: float = 0.0
    window_s: float = 0.0
    breakdown: dict = dataclasses.field(default_factory=dict)


def sample_times(seed: int, count: int, lo: float = 0.05,
                 hi: float = 0.95) -> list:
    """`count` points of the window, as shares of its length, drawn from
    the seed: the steps that start first at or after them are compared
    with the reference."""
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 7])
    return sorted(float(x) for x in rng.uniform(lo, hi, int(count)))


def reduce_trace(events, table: dict, steps: int, extras: dict):
    """The stretch's Reduced trace; the names no layer rule maps are
    listed on standard error."""
    red = trace_mod.Reduced(events, table, steps, extras)
    for name in sorted(red.unmapped):
        print(f"perfbench: trace: no layer for device event {name!r} "
              "(counted under other)", file=sys.stderr)
    print(f"perfbench: trace: {len(red.complete)} of {red.steps} steps "
          f"complete; {red.lost_events} device events lost their launch; "
          f"busy {red.busy_ms_per_step():.4f} ms a step", file=sys.stderr)
    return red


def read_metrics(readers: dict, red) -> dict:
    """{name: value} of each reader that found something to read."""
    out = {}
    for name, read in readers.items():
        v = read(red)
        if v is not None:
            out[name] = float(v)
    return out


def max_gap(a, b, relative: bool = False) -> float:
    """The largest |a - b| (with `relative`, |a - b| / (|b| + 1)): equal
    values (infinities too) and NaN on both sides are no gap, a NaN on one
    side only an infinite one."""
    import torch
    a, b = a.double(), b.double().to(a.device)
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = (a - b).abs()
    if relative:
        d = d / (b.abs() + 1.0)
    d = torch.where(same, torch.zeros_like(a), d)
    d = torch.nan_to_num(d, nan=float("inf"))
    return float(d.max()) if d.numel() else 0.0
