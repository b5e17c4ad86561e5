"""Runs a function on the ranks of a process group, one spawned process a
rank, over gloo: how the multi-card paths (parallel/sharded,
parallel/sharded_lod) run where there are fewer cards than ranks — on the
CPU, or as processes sharing one card (NCCL cannot put two ranks on one
card).

`spawn(worker, world, out_dir, spec)` starts `world` spawned processes,
each joining a process group through a FileStore in out_dir (no TCP port)
with a 60 s collective timeout, and runs worker(rank, world, out_dir,
spec); worker must be importable (a module-level function). Workers send
their results back as .npy files in out_dir (`save`, `load`). A rank that
fails ends the run at once; a run past its deadline is killed. Either way
spawn raises, so a hung collective fails its caller.

spec["device"] == "cuda" makes each rank's current device the first card.
"""

from __future__ import annotations

import os
import pathlib
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist


def _rank_main(worker, rank, world, out_dir, spec, backend):
    torch.set_num_threads(1)
    if spec.get("device", "cpu") == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(out_dir, "store"),
        rank=rank, world_size=world, timeout=timedelta(seconds=60))
    try:
        worker(rank, world, out_dir, spec)
    finally:
        dist.destroy_process_group()


def spawn(worker, world: int, out_dir, spec: dict, *, backend="gloo",
          deadline_s: float = 150.0):
    """Runs worker on `world` ranks; raises unless every rank exits 0
    within deadline_s seconds."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(worker, r, world, out_dir, spec, backend))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > end:
                raise RuntimeError(f"ranks still running after {deadline_s} "
                                   "s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"rank exit codes {codes}")


def save(out_dir, name: str, rank: int, **arrays):
    for key, a in arrays.items():
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        np.save(pathlib.Path(out_dir) / f"{name}.{key}.{rank}.npy",
                np.asarray(a))


def load(out_dir, name: str, key: str, rank: int) -> np.ndarray:
    return np.load(pathlib.Path(out_dir) / f"{name}.{key}.{rank}.npy")
