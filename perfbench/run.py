#!/usr/bin/env python3
"""The benchmark of planet_tpu_torch, the PyTorch and CUDA port, on one
NVIDIA H100.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--dry-run]

runs one cell of BENCHMARK.json once from the root of a checkout and prints
one JSON object as the last line of its standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), `device`, with --trace 1
`breakdown`, and last `checks`, each number of the correctness check
beside its limit (also the last lines of standard error).

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name: perfbench/configs/<config>.json (the
deployment, its entry point and its limits), perfbench/traffic/<mix>.json
(the parameters of the general generators in harness/traffic.py),
perfbench/layers/<config>.json (the trace's kernel names to the port's
layers) and perfbench/metrics/<metric>.py (one reader a metric). The entry
point named by a configuration is perfbench/drivers/<entry>.py.

A run without a card, or with fewer cards than the cell asks for, exits 2
and prints no result. --dry-run drives the whole run on the CPU at the
configuration's `dry_run` sizes through the port's plain path and prints a
line with no metric.
"""

import os
import sys
import time

_T_ENTRY = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started (Linux's /proc), 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from perfbench.harness import cli
    return cli.main(argv, root, t_start=_T_ENTRY - _process_age_s())


if __name__ == "__main__":
    sys.exit(main())
