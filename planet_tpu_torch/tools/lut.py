"""Where a small lookup table should live on the H100 (T3-T7).

    python -m planet_tpu_torch.tools.lut                      # on the card
    python -m planet_tpu_torch.tools.lut --device cpu --small

The port's counterpart of planet_tpu's lookup microbenchmarks in tools/:
microbench_lut.py (T3: C, C2, D, E), microbench_gather.py (T4: G1, G2,
G2f, R1), microbench_gather2.py (T5: chains of 1/4/16 dependent lookups,
the 64-op integer calibration, a copy, block sizes), microbench_gather_
wide.py (T6: 20 dependent lookups with a running sum, narrow and wide) and
microbench_gather_tp.py (T7: 24 independent lookups). Every variant
computes table[idx], chained, dependent or independent, on the tool's own
inputs (the same seeds and shapes), with a hand-written kernel in
csrc/bench_lut.cu and a plain PyTorch version here that it equals bit for
bit. The noise core's permutation table (csrc/noise.cuh) lives in shared
memory today; this tool asks whether it should.

Placements: `smem` (the table in shared memory, one lookup a thread),
`halves` (256 entries as two 128 halves and a select), `ldg` (the table
read through the read-only cache from device memory), `shfl` (the table in
registers, 32 entries a register, looked up with warp shuffles), `mma`
(tensor-core one-hot lookups, mma.sync bf16). `lookup` launches the kernel
for CUDA tensors (counted in _cuda.launches["t_lut"]) and runs the plain
version for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.ops.tables import PERLIN_TABLE
from planet_tpu_torch.tools import common


@dataclasses.dataclass(frozen=True)
class Variant:
    group: str          # T3 .. T7
    code: int           # csrc/bench_lut.cu Variant
    inputs: str         # which tool's inputs (make_inputs)
    table: str = "t256"
    idx: str = "idx"
    entries: int = 256
    depth: int = 1      # lookups in a chain (kChain*)
    threads: int = 256
    f32: bool = False
    lookups: int = 1    # table lookups per element


VARIANTS = {
    # T3, microbench_lut.py: PERLIN_TABLE, 2^22 indices in [0, 256)
    "smem_i32_256": Variant("T3", 0, "lut"),
    "smem_f32_256": Variant("T3", 1, "lut", f32=True),
    "ldg_i32_256": Variant("T3", 4, "lut"),
    "shfl_i32_256": Variant("T3", 5, "lut"),
    "mma_onehot": Variant("T3", 6, "lut"),
    "mma_nibble": Variant("T3", 7, "lut"),
    # T4, microbench_gather.py: seeded 128- and 256-entry tables
    "smem_i32_128": Variant("T4", 0, "gather", "t128", "idx128", 128),
    "shfl_i32_128": Variant("T4", 5, "gather", "t128", "idx128", 128),
    "halves_i32_256": Variant("T4", 2, "gather"),
    "halves_f32_256": Variant("T4", 3, "gather", f32=True),
    "repeat": Variant("T4", 8, "gather", idx="x", lookups=0),
    # T5, microbench_gather2.py: 128 entries, (32768, 128) indices
    **{f"chain{k}_{p}": Variant("T5", 9 if p == "smem" else 10, "gather2",
                                "t128", entries=128, depth=k, lookups=k)
       for p in ("smem", "shfl") for k in (1, 4, 16)},
    "arith64": Variant("T5", 11, "gather2", "t128", entries=128, lookups=0),
    "copy": Variant("T5", 12, "gather2", "t128", entries=128, lookups=0),
    "chain1_smem_t128": Variant("T5", 9, "gather2", "t128", entries=128,
                                threads=128),
    "chain1_smem_t1024": Variant("T5", 9, "gather2", "t128", entries=128,
                                 threads=1024),
    # T6, microbench_gather_wide.py: 2^23 indices, 20 dependent lookups
    "runsum20_smem": Variant("T6", 13, "wide", "t128", entries=128,
                             lookups=20),
    "runsum20_shfl": Variant("T6", 14, "wide", "t128", entries=128,
                             lookups=20),
    "runsum20_wide": Variant("T6", 15, "wide", "t2048", entries=128,
                             lookups=20),
    # T7, microbench_gather_tp.py: (8192, 128) indices, 24 independent
    "indep24_smem": Variant("T7", 16, "tp", "t128", entries=128, lookups=24),
    "indep24_shfl": Variant("T7", 17, "tp", "t128", entries=128, lookups=24),
}
HEADLINE = "smem_i32_256"
# one variant of each tool whose plain version is timed too
PLAIN_TIMED = ("smem_i32_256", "smem_i32_128", "chain1_smem",
               "runsum20_smem", "indep24_smem")
WIDE = 2048            # the wide layout's row width (T6)
REPLACES = {
    "T3": "tools/microbench_lut.py:71",
    "T4": "tools/microbench_gather.py:49",
    "T5": "tools/microbench_gather2.py:22",
    "T6": "tools/microbench_gather_wide.py:54",
    "T7": "tools/microbench_gather_tp.py:24",
}
SIZES = {"lut": 1 << 22, "gather": 1 << 22, "gather2": 1 << 22,
         "wide": 1 << 23, "tp": 1 << 20}
SMALL = {"lut": 1 << 12, "gather": 1 << 12, "gather2": 1 << 12,
         "wide": 1 << 13, "tp": 1 << 12}


def make_inputs(kind: str, n: int, device="cuda") -> dict:
    """The tool's tables and indices (int32), drawn as the tool draws them
    from numpy's default_rng(0), with n indices."""
    rng = np.random.default_rng(0)
    i32 = np.int32
    if kind == "lut":
        out = {"t256": PERLIN_TABLE.astype(i32),
               "idx": rng.integers(0, 256, n, dtype=i32)}
    elif kind == "gather":
        out = {"t128": rng.integers(0, 256, 128, dtype=i32),
               "t256": rng.integers(0, 256, 256, dtype=i32)}
        out["idx128"] = rng.integers(0, 128, n, dtype=i32)
        out["idx"] = rng.integers(0, 256, n, dtype=i32)
        out["x"] = np.arange(64, dtype=i32).reshape(8, 8)
    elif kind == "gather2":
        out = {"t128": rng.integers(0, 128, 128, dtype=i32),
               "idx": rng.integers(0, 128, n, dtype=i32)}
    elif kind == "wide":
        out = {"idx": rng.integers(0, 1 << 20, n, dtype=i32)}
        out["t128"] = rng.integers(0, 256, 128, dtype=i32)
        out["t2048"] = np.tile(out["t128"], WIDE // 128)
    elif kind == "tp":
        out = {"idx": rng.integers(0, 1 << 20, n, dtype=i32),
               "t128": rng.integers(0, 256, (8, 128), dtype=i32)[0].copy()}
    else:
        raise ValueError(f"unknown inputs {kind!r}")
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def operands(name: str, inputs: dict):
    """(idx, table) of variant `name` from its tool's inputs."""
    v = VARIANTS[name]
    table = inputs[v.table]
    return inputs[v.idx], table.float() if v.f32 else table


# ---------------------------------------------------------- plain versions

def lookup_plain(name: str, idx, table):
    """Plain PyTorch version of variant `name` (bench_lut.cu's body)."""
    v = VARIANTS[name]

    def tab(i):
        return table[i.long()]

    if v.code in (0, 1, 4, 5):
        return tab(idx & (v.entries - 1))
    if v.code in (2, 3):
        low = (idx & 127).long()
        return torch.where(idx >= 128, table[128:][low], table[:128][low])
    if v.code in (6, 7):
        return tab(idx & 255)
    if v.code == 8:
        return idx.repeat_interleave(16, dim=1)
    if v.code in (9, 10):
        out = idx
        for _ in range(v.depth):
            out = tab(out & 127)
        return out
    if v.code == 11:
        out = idx
        for _ in range(64):
            out = (out * 3 + 1) & 127
        return out
    if v.code == 12:
        return idx.clone()
    acc = torch.zeros_like(idx)
    if v.code in (13, 14, 15):
        off = 0
        if v.code == 15:
            off = (torch.arange(idx.numel(), device=idx.device,
                                dtype=torch.int32) % WIDE) & ~127
        val = idx
        for _ in range(20):
            g = tab((val & 127) + off)
            acc = acc + g
            val = val + g
        return acc
    for k in range(24):                       # codes 16, 17
        acc = acc + tab((idx ^ k) & 127)
    return acc


# ------------------------------------------------------------- the kernel

def lookup_kernel(name: str, idx, table):
    """Variant `name` on the card (csrc/bench_lut.cu)."""
    v = VARIANTS[name]
    _cuda.check_cuda(idx, "idx", torch.int32)
    _cuda.check_cuda(table, "table", torch.float32 if v.f32 else torch.int32)
    n = idx.numel()
    need = {2: 256, 3: 256, 6: 256, 7: 256, 8: 0, 11: 0, 12: 0,
            15: WIDE}.get(v.code, v.entries)
    if table.numel() < need:
        raise ValueError(f"{name}: table of {table.numel()} entries, "
                         f"needs {need}")
    if v.code == 8:
        if tuple(idx.shape) != (8, 8):
            raise ValueError("repeat takes an (8, 8) input")
        out = torch.empty((8, 128), dtype=torch.int32, device=idx.device)
    else:
        out = torch.empty_like(idx, dtype=table.dtype)
    if n:
        _cuda.launch("t_lut", "planet_t_lut", v.code, idx.data_ptr(),
                     table.data_ptr(), out.data_ptr(), n, v.entries,
                     v.depth, WIDE, v.threads)
    return out


def lookup(name: str, idx, table):
    """Variant `name`: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if name not in VARIANTS:
        raise ValueError(f"unknown lookup variant {name!r}")
    if common.device_of(idx) == "cuda":
        return lookup_kernel(name, idx, table)
    return lookup_plain(name, idx, table)


# ------------------------------------------------------------------- runs

def bench(device: str = "cuda", small: bool = False,
          reps: int = common.REPS) -> dict:
    """Every variant once against its plain version, then timed. Returns
    {"rows": [...], "inputs": {...}, "library_ms": torch.take's ms on the
    headline's operands}; a row holds name, group, ms, rate (G lookups a
    second; elements a second for the lookup-free variants), bound, equal,
    max_abs_err, and plain_ms for the PLAIN_TIMED variants."""
    sizes = SMALL if small else SIZES
    inputs = {k: make_inputs(k, n, device) for k, n in sizes.items()}
    clock = common.sm_clock_hz() if device == "cuda" else None
    rows = []
    for name, v in VARIANTS.items():
        idx, table = operands(name, inputs[v.inputs])
        got = lookup(name, idx, table)
        want = lookup_plain(name, idx, table)
        ms = common.time_ms(lambda: lookup(name, idx, table), reps=reps,
                            device=device)
        n = idx.numel()
        rows.append(dict(
            name=name, group=v.group, ms=ms,
            rate=n * max(v.lookups, 1) / ms / 1e6,
            bound=common.bound_ms(nbytes=4 * (n + got.numel()),
                                  lookups=n * v.lookups,
                                  sm_clock_hz=clock),
            equal=common.same(got, want),
            max_abs_err=common.max_abs_err(got, want)))
        if name in PLAIN_TIMED:
            rows[-1]["plain_ms"] = common.time_ms(
                lambda: lookup_plain(name, idx, table), reps=reps,
                device=device)
    idx, table = operands(HEADLINE, inputs["lut"])
    idx_long = idx.long()
    take = torch.take(table, idx_long)
    if not common.same(take, lookup(HEADLINE, idx, table)):
        raise RuntimeError("torch.take disagrees with the lookup kernel")
    library_ms = common.time_ms(lambda: torch.take(table, idx_long),
                                reps=reps, device=device)
    return {"rows": rows, "inputs": inputs, "library_ms": library_ms}


def main(argv=None) -> int:
    args = common.parse_args(argv, __doc__.splitlines()[0])
    res = bench(args.device, args.small, args.reps)
    for r in res["rows"]:
        print(common.line(r["group"], r, "Glookup/s", args.device),
              flush=True)
    print(f"torch.take on {HEADLINE}'s operands: {res['library_ms']:.4f} ms",
          flush=True)
    return 0 if all(r["equal"] for r in res["rows"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
