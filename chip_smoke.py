#!/usr/bin/env python3
"""The port's check on one NVIDIA GPU (planet_tpu_torch).

    python chip_smoke.py

1. builds the kernel library and prints what the build reports (ptxas'
   registers, shared memory and spills a kernel; the SASS census where
   the toolkit has cuobjdump: tools/kernel_times.build_report) and the
   card's `nvidia-smi --query-gpu=name,power.limit` line; no CUDA device
   -> exit 2;
2. runs the port's `gpu`-marked tests (GPU_TESTS) in a process of their
   own: every kernel against its plain version at the tests' and the main
   path's shapes, and every path on the card (both frame paths, the
   configs' field steps, the tools, splat, the driver, the sharded paths,
   the stage ladder); a failure exits with pytest's code;
3. counts the kernels' launches over one run of the main path, the
   counters reset just before it: after a warm-up frame (the graphs'
   capture), the orbit's frames (tools/kernel_times.orbit_cameras) through
   io/driver.DeviceInteractiveEngine at the benchmark's lod-1080p and
   lod-1080p-p64 configurations, then one field regen at field-6x2048's;
4. times each kernel queued at the main path's shapes
   (tools/kernel_times.measure) beside its bound (kernel_times.bounds).

The second-to-last lines are {"kernels": [...]}, one entry a kernel of
_cuda.launches (its name, source, the planet_tpu code it replaces, its
launches in step 3, its queued ms at the shape kernel_times keys to it, its
bound there (tools/common.bound_ms at the card's maximum SM clock) and
library_ms, a library call's ms where one computes the same function:
none does), and the card's line; the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
CONFIGS = ROOT / "perfbench" / "configs"
# the files that hold every `gpu`-marked test of the port
# (tests/test_torch_cuda_abi.py holds them to it)
GPU_TESTS = ("tests/test_torch_kernels_gpu.py",
             "tests/test_torch_refine_cuda.py", "tests/test_torch_splat.py")
# kernel -> (its source, the planet_tpu code it replaces)
SOURCES = {
    "tile": ("csrc/tile.cu", "planet_tpu/ops/kernels/tile_pallas.py:66"),
    "noise": ("csrc/perlin.cu",
              "planet_tpu/ops/kernels/perlin_pallas.py:351"),
    "gather": ("csrc/raster.cu", "planet_tpu/raster/coverage_pallas.py:471"),
    "span": ("csrc/raster.cu", "planet_tpu/raster/coverage_pallas.py:67"),
    "huge": ("csrc/raster.cu", "planet_tpu/raster/coverage_pallas.py:271"),
    "field": ("csrc/field.cu", "planet_tpu/ops/kernels/field_pallas.py:149"),
    "splat": ("csrc/splat.cu", "planet_tpu/raster/splat.py:30"),
    "refine": ("csrc/refine.cu", "planet_tpu/lod/refine_device.py:153, "
               "planet_tpu/ops/kernels/perlin_pallas.py:370"),
    "order": ("csrc/order.cu", "planet_tpu/engine/device_step.py:130"),
    "setup": ("csrc/setup.cu", "planet_tpu/raster/coverage.py:428, "
              "planet_tpu/raster/nearclip.py:94"),
    "clip": ("csrc/setup.cu", "planet_tpu/raster/coverage.py:840, "
             "planet_tpu/raster/nearclip.py:292"),
    "tess": ("csrc/tess.cu", "planet_tpu/tess/vertex.py:148, "
             "planet_tpu/tess/vertex.py:232, planet_tpu/raster/shade.py:18"),
    "tess_wide": ("csrc/tess.cu", "planet_tpu/tess/vertex.py:148"),
    "cache": ("csrc/cache.cu", "planet_tpu/engine/device_step.py:164, "
              "planet_tpu/cache/device_pool.py:52"),
    "uniforms": ("csrc/uniforms.cu", "planet_tpu/engine/device_step.py:242"),
    "t_noise": ("csrc/bench_noise.cu", "tools/microbench_stages.py:32"),
    "t_tile": ("csrc/bench_noise.cu", "tools/bench_tiles2.py:87"),
    "t_lut": ("csrc/bench_lut.cu", "tools/microbench_lut.py:71"),
    "t_span": ("csrc/bench_span.cu", "tools/microbench_span3.py:116"),
}


def main_path_launches() -> dict:
    """{"launches": {kernel: n}, "frames": {config: n}}: step 3's run."""
    import torch

    from planet_tpu_torch import _cuda
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.io.driver import DeviceInteractiveEngine
    from planet_tpu_torch.models import heightfield
    from planet_tpu_torch.tools import kernel_times

    fields = EngineConfig.__dataclass_fields__
    engines = {}
    for name in ("lod-1080p", "lod-1080p-p64"):
        c = json.loads((CONFIGS / f"{name}.json").read_text())
        s = c["settings"]
        cfg = EngineConfig(**{k: v for k, v in s.items() if k in fields})
        eng = DeviceInteractiveEngine(cfg, s["window_w"], s["window_h"],
                                      device="cuda", **c["engine"])
        cams = [cam for _, cam in kernel_times.orbit_cameras(cfg)]
        eng.render(cams[0])
        engines[name] = (eng, cams)
    field = dict(json.loads((CONFIGS / "field-6x2048.json").read_text())
                 ["settings"])
    n, radius = field.pop("n"), field.pop("radius")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    frames = {}
    for name, (eng, cams) in engines.items():
        for cam in cams:
            eng.render(cam)
        frames[name] = len(cams)
    heightfield.frame_cube(n, radius, fused=True, device="cuda", **field)
    frames["field-6x2048"] = 1
    torch.cuda.synchronize()
    return {"launches": dict(_cuda.launches), "frames": frames}


def main() -> int:
    import torch

    from planet_tpu_torch import _cuda
    from planet_tpu_torch.tools import common, kernel_times

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    _cuda.library()
    for line in kernel_times.build_report(_cuda, common):
        print(line, flush=True)
    print(common.card_line(), flush=True)
    rc = subprocess.run([sys.executable, "-m", "pytest", "-m", "gpu",
                         "--noconftest", "-p", "no:cacheprovider",
                         *GPU_TESTS], cwd=ROOT).returncode
    if rc:
        print(f"chip_smoke: the gpu tests failed ({rc})", file=sys.stderr)
        return rc
    run = main_path_launches()
    print(json.dumps(run), flush=True)
    r = kernel_times.measure()
    clock = common.sm_clock_hz()
    bounds = kernel_times.bounds(torch.device("cuda"), r["sets"], clock)
    keys = r["keys"]
    kernels = []
    for k, (src, rep) in SOURCES.items():
        row = dict(name=k, route="cuda", source=f"planet_tpu_torch/{src}",
                   replaces=rep, launches=run["launches"][k],
                   queued_ms=r["ms"].get(keys.get(k)), bound_ms=None,
                   bound_by=None, library_ms=None)
        if k in bounds:
            row.update(bound_ms=bounds[k][0], bound_by=bounds[k][1])
        kernels.append(row)
        if k == "tile":
            row["queued_fused_ms"] = r["ms"][keys["tile_fused"]]
        if k == "tess":
            row["rows_mode"] = dict(queued_ms=r["ms"][keys["tess_rows"]],
                                    bound_ms=bounds["tess_rows"][0],
                                    bound_by=bounds["tess_rows"][1])
        if k == "gather":
            p64 = kernel_times.ROUTE_P64
            row["p64"] = dict(queued_ms=r["ms"][p64],
                              bound_ms=r["bounds"][p64][0])
        if k == "t_noise":
            row["variants"] = {label[8:]: ms for label, ms in r["ms"].items()
                               if label.startswith("t_noise ")}
    if any(m == "jax" or m.startswith(("jax.", "planet_tpu."))
           or m == "planet_tpu" for m in sys.modules):
        print("chip_smoke: jax or planet_tpu was imported", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(common.card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
