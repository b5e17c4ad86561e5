"""One run of one cell: argument parsing, the cell's files, the device
check, the entry point's driver, the result line and the no-JAX check."""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time

from perfbench.harness import cell as cell_mod
from perfbench.harness import nojax


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="put the reference computed in the precision "
                         "below the configuration's in the program's place "
                         "in the correctness check (a check of the check; "
                         "the benchmark's own runs never use it)")
    ap.add_argument("--dry-run", action="store_true",
                    help="the whole run on the CPU at the configuration's "
                         "dry_run sizes, through the port's plain path; no "
                         "metric is printed")
    return ap.parse_args(argv)


def _fail(msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv, root: str, t_start: float) -> int:
    args = parse(argv)
    try:
        c = cell_mod.load(root, args.workload)
    except (cell_mod.CellError, OSError, ValueError) as e:
        return _fail(str(e))
    import torch
    if args.dry_run:
        device = "cpu"
        c = c.dry_run()
        torch.set_num_threads(min(4, torch.get_num_threads()))
    else:
        if not torch.cuda.is_available():
            return _fail("no CUDA device: a measurement run needs the card "
                         "and never falls back to the CPU")
        if torch.cuda.device_count() < c.chips:
            return _fail(f"{c.name} needs {c.chips} cards, "
                         f"{torch.cuda.device_count()} found")
        device = "cuda"
        torch.cuda.reset_peak_memory_stats()
    driver = importlib.import_module(f"perfbench.drivers.{c.entry}")
    run = driver.Run(c, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=device, t_start=t_start,
                     control=args.control)
    try:
        result = run.measure()
    except driver.RunError as e:
        return _fail(str(e))
    # the window has closed and the peak is read: free the program's
    # state before the reference runs
    run.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    per_layer = run.per_layer() if args.trace else {}
    checks = run.check()
    print(f"perfbench: reference and readers took "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    found = nojax.loaded()
    if found:
        return _fail("JAX or the JAX package is loaded in this process: "
                     + ", ".join(found))
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    line = {"correct": correct, "attempted": result.attempted,
            "failed": result.failed}
    if args.dry_run:
        line = {"dry_run": True, **line, "metrics": {}}
    else:
        metrics = per_layer if args.trace else result.end_to_end
        missing = [m for m in c.metric_names(bool(args.trace))
                   if m not in metrics]
        if args.trace and missing:
            return _fail("the trace gave no reading for "
                         + ", ".join(missing))
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": c.chips,
               "memory_peak_bytes": result.memory_peak_bytes}
        if args.trace:
            dev["busy_s"] = result.busy_s
            dev["window_s"] = result.window_s
        line.update(metrics={k: {"value": v, "unit": c.unit(k)}
                             for k, v in metrics.items()}, device=dev)
        if args.trace:
            line["breakdown"] = result.breakdown
    line["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

