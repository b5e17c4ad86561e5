"""What the three attribution tools share: the device argument, timing,
the card's peak rates and the bound, and the per-variant report line."""

from __future__ import annotations

import argparse
import functools
import subprocess
import time

import numpy as np
import torch

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet): f32
# outside the tensor cores, HBM, and the SMs' shared-memory lookups (32
# four-byte reads a clock on each of 132 SMs).
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
SMS = 132
LOOKUPS_PER_SM_CLOCK = 32
REPS = 7
# host seconds a queued call may take: the spin ahead of the timed calls
# lasts this long for each of them
QUEUE_S = 0.5e-3


def parse_args(argv, doc: str):
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default): the kernels, timed with CUDA "
                        "events; cpu: the plain versions only")
    p.add_argument("--small", action="store_true",
                   help="the CPU tests' sizes instead of the tools' own")
    p.add_argument("--reps", type=int, default=REPS,
                   help="timed calls per variant (the median is kept)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run the plain versions")
    return args


def time_calls(fn, setup=lambda: (), reps: int = REPS,
               device: str = "cuda") -> list:
    """ms of each of `reps` calls of fn(*setup()), the setups made first
    and untimed. On the card the calls are queued behind a spin kernel
    (torch.cuda._sleep) and timed call by call with CUDA events, so the
    host's launch time does not land in a kernel's time; on the CPU, the
    host clock."""
    args = [setup() for _ in range(reps)]
    if device != "cuda":
        times = []
        for a in args:
            t0 = time.perf_counter()
            fn(*a)
            times.append((time.perf_counter() - t0) * 1e3)
        return times
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(QUEUE_S * reps * sm_clock_hz()))
    events[0].record()
    for a, end in zip(args, events[1:]):
        fn(*a)
        end.record()
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def time_ms(fn, setup=lambda: (), reps: int = REPS,
            device: str = "cuda") -> float:
    """Median ms of `reps` calls (time_calls)."""
    return float(np.median(time_calls(fn, setup, reps, device)))


def bound_ms(ops: float = 0.0, nbytes: float = 0.0, lookups: float = 0.0,
             sm_clock_hz: float | None = None):
    """(least ms, "operations" | "bytes" | "lookups"): the largest of the
    f32 operations over the f32 rate, the bytes over the memory rate and,
    given the SM clock, the table lookups over the SMs' lookup rate."""
    cands = [(ops / PEAK_F32_OPS * 1e3, "operations"),
             (nbytes / PEAK_BYTES * 1e3, "bytes")]
    if lookups and sm_clock_hz:
        cands.append((lookups / (SMS * LOOKUPS_PER_SM_CLOCK * sm_clock_hz)
                      * 1e3, "lookups"))
    return max(cands)


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def device_of(t: torch.Tensor) -> str:
    """"cuda" or "cpu": which of a variant's two versions runs on t."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-for-bit equality (floats compared as their int32 words)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def line(group: str, r: dict, rate_unit: str, device: str) -> str:
    """One variant's report line: ms, the tool's rate, the bound on the
    card and whether the variant equals its plain version."""
    clock = "CUDA events" if device == "cuda" else "host clock, CPU"
    text = (f"{group:3s} {r['name']:24s} {r['ms']:10.4f} ms ({clock})  "
            f"{r['rate']:9.3f} {rate_unit}")
    if device == "cuda":
        text += f"  bound {r['bound'][0]:.5f} ms ({r['bound'][1]})"
        if "plain_ms" in r:
            text += f"  plain {r['plain_ms']:.4f} ms"
    return text + f"  equal to plain: {r['equal']}"
