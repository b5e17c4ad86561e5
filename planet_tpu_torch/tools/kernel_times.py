"""Queued device times of the noise kernels, for comparing two trees of the
port on one card in one run.

    python planet_tpu_torch/tools/kernel_times.py [--root DIR] [--reps N]

Imports planet_tpu_torch from DIR (default: the checkout that holds this
file), so the same script times an older tree unpacked beside it, built
from that tree's own sources: run it as old, new, new, old and compare
within the run. Times (tools/common.time_ms: the median of REPS calls
queued behind a spin kernel) the calls of `noise_calls` — the set that
chip_smoke.py phase 8 times for the kernels line — and t_noise's variants
(noise_stages.NOISE_VARIANTS, which phase 8 times through
noise_stages.bench) on DIR's tree. Prints the card's nvidia-smi name and
power limit, then one JSON line: {"root": DIR, "ms": {label: ms},
"build_s": s}. Needs a CUDA device.

chip_smoke.py cannot take this role with a --root argument: it drives and
checks the whole main path, and an older tree's phases and kernels line
differ from this one's; this script needs only the kernels' wrappers and
noise_stages' inputs, which every tree since the attribution tools has.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


def noise_calls(device) -> list:
    """[(kernels-line key or None, label, call)]: the noise kernels at the
    main path's shapes, on inputs made from numpy seeds
    (noise_stages.noise_inputs / tile_inputs) — K1 on 256 tiles of octaves
    6-18, K4 at the refine-probe shape (5 x 4096 points, ridged 6) and at
    2^20 points x 18 octaves, K5 at 6 x 2048^2. The modules are imported
    here, so they come from whichever tree is first on sys.path."""
    import numpy as np
    import torch

    from planet_tpu_torch.ops.kernels import field_cuda, perlin_cuda, tile_cuda
    from planet_tpu_torch.tools import noise_stages

    corners = noise_stages.tile_inputs(256, device)
    octs = torch.as_tensor(6 + np.arange(256, dtype=np.int32) % 13,
                           device=device)
    probe = noise_stages.noise_inputs(5 * 4096, device)
    sphere = noise_stages.noise_inputs(1 << 20, device)
    return [
        ("tile", "K1 tile, 256 tiles x octaves 6-18",
         lambda: tile_cuda.tiles_cuda(*corners, octs, kind="ridged",
                                      gain=0.55, amplitude=8848.0)),
        ("noise", "K4 noise, refine probes 5x4096, ridged 6",
         lambda: perlin_cuda.noise_cuda("ridged", *probe, octaves=6,
                                        gain=0.55)),
        (None, "K4 noise, 2^20 points, ridged 18",
         lambda: perlin_cuda.noise_cuda("ridged", *sphere, octaves=18,
                                        gain=0.55)),
        ("field", "K5 field 6x2048^2",
         lambda: field_cuda.field_kernel(2048, 6371000.0, device=device)),
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                         .parents[2]))
    p.add_argument("--reps", type=int, default=7)
    args = p.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch

    from planet_tpu_torch import _cuda
    from planet_tpu_torch.tools import common, noise_stages

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    _cuda.library()
    dev = torch.device("cuda")
    runs = {label: fn for _, label, fn in noise_calls(dev)}
    points = noise_stages.noise_inputs(1 << 22, dev)
    for name in noise_stages.NOISE_VARIANTS:
        runs[f"t_noise {name}"] = (
            lambda name=name: noise_stages.noise_stage(name, points))
    ms = {}
    for name, fn in runs.items():
        fn()
        ms[name] = common.time_ms(fn, reps=args.reps)
    torch.cuda.synchronize()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"root": args.root, "ms": ms,
                      "build_s": _cuda.build_info.get("seconds")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
