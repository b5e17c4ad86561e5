"""What the attribution tools and kernel_times share: the device argument,
timing, the card's instruction rates and the bound (with the noise core's
operation counts), a census of compiled instructions, and the per-variant
report line."""

from __future__ import annotations

import argparse
import functools
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from planet_tpu_torch.ops import perlin

# The rates of one H100 SXM (NVIDIA's data sheet and the CUDA C++
# Programming Guide's throughput table for compute capability 9.0): HBM at
# 3.35 TB/s; on each of 132 SMs a clock, 128 f32 results (adds, multiplies,
# compares — the kernels are built with -fmad=false, so none is fused; the
# data sheet's 67 TFLOP/s counts an FMA as two), 64 f64 results, and 32
# four-byte shared-memory reads. The SM clock is read from the card
# (clocks.max.sm, 1980 MHz on the H100 SXM: 33.5e12 f32 and 16.7e12 f64
# operations a second); CPU runs, which print no bound, take 1980 MHz.
PEAK_BYTES = 3.35e12
SMS = 132
F32_PER_SM_CLOCK = 128
F64_PER_SM_CLOCK = 64
LOOKUPS_PER_SM_CLOCK = 32
DATA_SHEET_CLOCK_HZ = 1.98e9
REPS = 7

# f32 operations counted from csrc/noise.cuh (each add, subtract, multiply,
# divide, compare and min/max is one): an error-free product is its two
# instructions, the multiply and the fmaf that gives its exact error;
# df_add is 20 (two two_sums, two adds, two quick_two_sums), df_mul and a
# non-power-of-two df_scale 9 (the product, three for the cross terms, the
# error add, a quick_two_sum), a power-of-two df_scale 2, floor_split_parts
# 27. The noise core: the int24 split of a point (3 axes), one octave's
# noise3 and update, and the f64 operations of one octave's fades (8 an
# axis: the fraction and the quintic). K1's texel adds the overscan uv and
# the corner blend of a 32x32 tile, counted as the function's least work
# with each term where it belongs: the uv a df_scale a column, shared by
# the rows (v of row i is u of column i); per axis the corner differences
# (2 df_add) a tile, a = p0 + (p1 - p0) u and b = p2 + (p3 - p2) u (2 df_mul,
# 2 df_add) a column, and the texel's p = a + (b - a) v (2 df_add, 1 df_mul)
# — the per-tile and per-column terms divided over their texels (the
# unsplit blend runs 2 df_scale and 3 x (5 df_add + 3 df_mul) a texel,
# 399 operations). Integer
# hashing, conversions and table reads are not counted: the bound counts
# the function's arithmetic, not one implementation's.
OPS_DF_ADD = 20
OPS_DF_MUL = 9
OPS_DF_SCALE_POW2 = 2
OPS_FLOOR_SPLIT = 27
OPS_SPLIT = 96
OPS_OCTAVE = {"ridged": 92, "fbm": 88}
F64_OPS_OCTAVE = 24
TILE_DIM = 32
OPS_TILE_UV = TILE_DIM * OPS_DF_MUL / TILE_DIM**2
OPS_TILE_BLEND = 3 * ((2 * OPS_DF_ADD + OPS_DF_MUL)
                      + 2 * (OPS_DF_MUL + OPS_DF_ADD) / TILE_DIM
                      + 2 * OPS_DF_ADD / TILE_DIM**2)
# R1 (csrc/refine.cu), counted the same way: df div 18 (the quotient, an
# error-free product, a two_sum, the residual's 5, the second quotient, a
# quick_two_sum), df sqrt 19 (the sqrt and its reciprocal, the product,
# an error-free square, a two_sum, the correction's 5, a quick_two_sum),
# |p|^2 67 and normalize 131. An evaluated frontier slot: the corner sums
# (18), the midpoint's normalize, per probe its length, displacement and
# camera distance (5 x 151 and 5 x 129), the diagonals (274), the
# threshold (65, 74 with a quality factor) and the five compares (15);
# with ridged probes each probe also scales its point (27), runs 6
# octaves of the noise core and scales the height (1). A split slot adds
# its children's 5 edge and centre sums and their normalizes (955).
OPS_DF_DIV = 18
OPS_DF_SQRT = 19
OPS_REFINE_SLOT = 1903
OPS_REFINE_SPLIT = 955
# C1 and C2 (csrc/setup.cu), counted the same way. A projected triangle:
# each of its three vertices' projection (the w test, the reciprocal,
# 4 + 4 operations to the screen, 3 + 3 to snap, z and the normal's 3
# scaled: 21), the area (8), the bbox (8 min/max, 4 offsets, 4 roundings,
# 4 clamps: 20), the live tests (3), 1/area, the bbox-min centre (4), the
# three edges' constants and top-left tests (12 each), the 15 scaled
# attributes and 4 converted bbox words (19) and the far test (3). C1's
# live candidate adds the straddle test (det3 14, the outcodes 24, the w
# and f tests 9, the sign 1: 48); C2's live slot is the clip (the three
# f = z + w and their tests 6, the two edge parameters 4, 7 interpolated
# words of each of two points at 3: 42; 52) and two triangles.
OPS_TRIANGLE = 3 * 21 + 8 + 20 + 3 + 1 + 4 + 3 * 12 + 19 + 3
OPS_SETUP_LIVE = OPS_TRIANGLE + 48
OPS_CLIP_SLOT = 52 + 2 * OPS_TRIANGLE
# V1 (csrc/tess.cu), counted the same way. An interpolation taking the
# linear fallback: the dot (5), the test (2), two lerps (9 each) and a
# normalize (the dot, the sqrt, 3 divisions: 9): 34. One taking the slerp:
# the dot, the test, the clamp (3), 1 - t and the two angles (3), the
# normal's blend (9) and normalize (9), theta, gamma, x and y (9), half and
# its length (12), the position (15): 67, and its acosf, three sinf, cosf
# and two tanf, each counted by the instructions ptxas emits on its path
# for |x| < 105615 (sm_90a, CUDA 12.9, -fmad=false; `cuobjdump -sass` of a
# kernel calling it alone, without the load and store): acosf 26, sinf 26,
# cosf 27, tanf 23. A vertex beyond its interpolation: five y blends (15),
# the skirt drop (2), the tangent normal (12), the two cross products and
# normalizes (36), the normal's combination and normalize (24), the world
# position (6), the clip transform (24), the shade (18). A column of a row:
# its two endpoint interpolations, row_dir and xyscale (10). A row: its
# three x-blended (dim, G) arrays (3 a value). A padding row past the leaf
# count: its tap-1 x blend (3 a value) and a vertex's height (the y blend
# 3, the skirt drop 2).
OPS_INTERP_LINEAR = 34
LIBM_INSTRUCTIONS = {"acosf": 26, "sinf": 26, "cosf": 27, "tanf": 23}
OPS_INTERP_SLERP = 67 + (LIBM_INSTRUCTIONS["acosf"]
                         + 3 * LIBM_INSTRUCTIONS["sinf"]
                         + LIBM_INSTRUCTIONS["cosf"]
                         + 2 * LIBM_INSTRUCTIONS["tanf"])
OPS_TESS_VERTEX = 15 + 2 + 12 + 36 + 24 + 6 + 24 + 18
OPS_TESS_COLUMN = 10
OPS_TESS_PAD_VERTEX = 5
# A1 (csrc/cache.cu): a generation's 12 noise-space corner words, a DF
# product each; its probes, scans and sort are integer work and not
# counted. U1 (csrc/uniforms.cu): a corner's three DF subtracts, its
# normal (the DF words' sums 3, the dot 5, the root 1, three divisions:
# 12); a row's skirt (3).
OPS_CACHE_GENERATION = 12 * OPS_DF_MUL
OPS_UNIFORMS_ROW = 4 * (3 * OPS_DF_ADD + 12) + 3
# host seconds a queued call may take: the spin ahead of the timed calls
# lasts this long for each of them (R1's wrapper, ~30 host calls, takes
# ~0.5 ms)
QUEUE_S = 2e-3


def parser(doc: str) -> argparse.ArgumentParser:
    """The tools' arguments: --device, --small, --reps."""
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default): the kernels, timed with CUDA "
                        "events; cpu: the plain versions only")
    p.add_argument("--small", action="store_true",
                   help="the CPU tests' sizes instead of the tools' own")
    p.add_argument("--reps", type=int, default=REPS,
                   help="timed calls per variant (the median is kept)")
    return p


def parse_args(argv, p: argparse.ArgumentParser):
    """p's arguments from argv; --device cuda needs a card."""
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
             f64_ops: float = 0.0, sm_clock_hz: float | None = None):
    """(least ms, "operations" | "bytes" | "lookups"): the largest of the
    operations' time (f32 over the f32 rate plus f64 over the f64 rate),
    the bytes over the memory rate and the table lookups over the SMs'
    lookup rate, at the SM clock `sm_clock_hz` (DATA_SHEET_CLOCK_HZ when
    None)."""
    clock = SMS * (sm_clock_hz or DATA_SHEET_CLOCK_HZ)
    cands = [((ops / (F32_PER_SM_CLOCK * clock)
               + f64_ops / (F64_PER_SM_CLOCK * clock)) * 1e3, "operations"),
             (nbytes / PEAK_BYTES * 1e3, "bytes")]
    if lookups:
        cands.append((lookups / (LOOKUPS_PER_SM_CLOCK * clock) * 1e3,
                      "lookups"))
    return max(cands)


def setup_work(rows: int, grid: int, candidates: int, live: int):
    """(f32 operations, bytes) of C1 on a batch whose first `rows` patch
    rows (of grid x grid vertices) are live and whose `candidates`
    triangles hold `live` live ones: each live row's vertices read once
    (clip 16 B, normal 12 B, valid 1 B) and the cell table; each
    candidate's straddle byte written once, and K6's route (two mask
    words each 32 candidates, two counts and the straddler count each
    256), and each live record's 128 bytes; OPS_SETUP_LIVE a live
    candidate."""
    words = candidates + candidates // 4 + -(-candidates // 256) * 12
    nbytes = (rows * grid * grid * (16 + 12 + 1) + 2 * grid * grid + words
              + live * 128)
    return float(live * OPS_SETUP_LIVE), float(nbytes)


def clip_work(blocks: int, slots: int, used: int, live_records: int,
              straddle_blocks: int = 0):
    """(f32 operations, bytes) of C2 on `blocks` C1 block counts and
    `slots` straddler slots of which `used` hold a straddler, clipped into
    `live_records` live records: the counts read once, the straddle bytes
    of the `straddle_blocks` C1 blocks that hold a straddler, each used
    slot's three vertices (clip 16 B, normal 12 B), the slots' indices
    and each live record (128 B) written once; OPS_CLIP_SLOT a used
    slot."""
    nbytes = (blocks * 4 + straddle_blocks * 256 + used * 3 * (16 + 12)
              + slots * 4 + live_records * 128)
    return float(used * OPS_CLIP_SLOT), float(nbytes)


def route_work(candidates: int, live: int):
    """(f32 operations, bytes) of K6 on `candidates` candidates, `live` of
    them live, on the route C1 wrote: the two mask words of each 32
    candidates read once, each 256's count pair read and overwritten by
    the scan and read by the scatter, each live record's 128 bytes read
    and written once, and the two counts written; no f32 operation (the
    offsets are integer sums)."""
    route = candidates // 4 + -(-candidates // 256) * 8 * 3
    return 0.0, float(route + live * 256 + 8)


def tess_work(rows: int, grid: int, slerps: int = 0, dim: int = TILE_DIM,
              live: int | None = None):
    """(f32 operations, bytes) of V1 on `rows` patch rows of grid x grid
    vertices and dim x dim tiles, `live` of them (default all) evaluated
    and the rest padding rows (tess_live; their height alone computed);
    `slerps` of the live rows' interpolations (grid^2 +
    2 grid a row) take the slerp (tess_slerps; the others the linear
    fallback): each row's tile, corners, normals, variants and skirt read
    once, the view-projection and the tap table once, and the six outputs
    (15 floats a vertex) written once, a padding row's too."""
    live = rows if live is None else live
    interps = live * (grid * grid + 2 * grid)
    ops = ((interps - slerps) * OPS_INTERP_LINEAR
           + slerps * OPS_INTERP_SLERP
           + live * (grid * grid * OPS_TESS_VERTEX + grid * OPS_TESS_COLUMN
                     + 3 * dim * grid * 3)
           + (rows - live) * (grid * grid * OPS_TESS_PAD_VERTEX
                              + dim * grid * 3))
    nbytes = (rows * (grid * grid * 15 * 4 + dim * dim * 4 + 2 * 12 * 4
                      + 2 * 4 + 4)
              + 16 * 4 + 3 * 3 * grid * 2 * 8 + grid * 4)
    return float(ops), float(nbytes)


def cache_work(rows: int, capacity: int, live: int, generated: int,
               gen_cap: int):
    """(f32 operations, bytes) of A1 on `rows` rows (`live` of them live)
    over a pool of `capacity` slots, `generated` generations into gen_cap
    rows: the pool's keys and ticks read once (12 B a slot), each row's
    id words and depth (12 B) and each generation's DF corners (96 B)
    read once, the leaf count and render tick; each row's slot, target,
    generate and crop (10 B), each of the gen_cap rows' corners, octaves
    and slot (104 B), the generations' keys and ticks (12 B) and the live
    rows' touched ticks (4 B) written once, and the flag and count."""
    nbytes = (capacity * 12 + rows * 12 + generated * 96 + 8 + rows * 10
              + gen_cap * 104 + generated * 12 + live * 4 + 5)
    return float(generated * OPS_CACHE_GENERATION), float(nbytes)


def uniforms_work(rows: int):
    """(f32 operations, bytes) of U1 on `rows` rows: each row's id words,
    depth and crop (13 B) and DF corners (96 B) and the camera (24 B) read
    once; its variants (8 B), camera-relative corners and normals (96 B)
    and skirt (4 B) written once."""
    return float(rows * OPS_UNIFORMS_ROW), float(rows * (13 + 96 + 108)
                                                 + 24)


def tess_rows_work(rows: int, grid: int, slerps: int = 0,
                   dim: int = TILE_DIM, live: int | None = None):
    """(f32 operations, bytes) of V1's rows mode: V1's work (tess_work)
    and U1's (uniforms_work) on the same rows, U1's outputs neither
    written nor read (each row's variants, corners, normals and skirt,
    108 B); the uniforms counted once a row, though both of its blocks
    compute them."""
    ops, nbytes = tess_work(rows, grid, slerps, dim, live)
    u_ops, u_bytes = uniforms_work(rows)
    return ops + u_ops, nbytes + u_bytes - 2 * rows * 108


def tess_live(corner_normals: torch.Tensor) -> torch.Tensor:
    """(Q,) bool: the rows V1 evaluates, those whose (Q, 4, 3) corner
    normals hold no NaN (the others are padding rows)."""
    return ~torch.isnan(corner_normals).flatten(1).any(1)


def tess_slerps(corner_normals: torch.Tensor, grid: int) -> int:
    """The interpolations of the rows V1 evaluates (tess_live) that take
    the slerp branch (1 - dot(n0, n1) >= 0.001, as torch.where takes it):
    each row's two column endpoints between corners 0-1 and 2-3 at the
    grid's u values, and each column's interpolation between them, grid
    times."""
    from planet_tpu_torch.tess import vertex

    n = corner_normals[tess_live(corner_normals)].to(torch.float32)
    u = vertex._grid_tables(grid, str(n.device))[0][0][None, :, None]
    z = torch.zeros_like(n[:, :1])

    def slerp(a, b):
        return ~((1.0 - vertex._dot(a, b)) < 0.001)

    _, na = vertex.interpolate(z, n[:, 0:1], z, n[:, 1:2], u)
    _, nb = vertex.interpolate(z, n[:, 2:3], z, n[:, 3:4], u)
    ends = slerp(n[:, 0], n[:, 1]).sum() + slerp(n[:, 2], n[:, 3]).sum()
    return int(ends) * grid + int(slerp(na, nb).sum()) * grid


def noise_work(octaves: int, kind: str = "ridged", lacunarity: float = 2.0):
    """(f32 operations, f64 operations) of one point of `octaves` octaves
    of the noise core: at lacunarity 2 the point's int24 split once and
    each octave by shifts; otherwise each octave scales the point by its
    frequency (2 operations an axis where that is a power of two, as at
    octave 0, else a df_scale) and splits it."""
    octaves = int(octaves)
    f32 = octaves * OPS_OCTAVE[kind]
    if float(lacunarity) == 2.0:
        f32 += OPS_SPLIT
    else:
        for hi, lo in perlin.freq_consts(float(lacunarity), octaves):
            scale = (OPS_DF_SCALE_POW2 if perlin.is_pow2_scale(hi, lo)
                     else OPS_DF_MUL)
            f32 += 3 * (scale + OPS_FLOOR_SPLIT)
    return f32, octaves * F64_OPS_OCTAVE


def refine_work(slots: int, splits: int, probe: str = "ridged6",
                quality: float = 1.0):
    """(f32 operations, f64 operations) of a refine that evaluates `slots`
    live frontier slots of which `splits` split (dead slots and emptied
    levels are no part of its work)."""
    f32 = (slots * (OPS_REFINE_SLOT + (OPS_DF_MUL if quality != 1.0 else 0))
           + splits * OPS_REFINE_SPLIT)
    f64 = 0.0
    if probe == "ridged6":
        ops, f64_ops = noise_work(6)
        f32 += slots * 5 * (3 * OPS_DF_MUL + ops + 1)
        f64 = slots * 5 * f64_ops
    return float(f32), float(f64)


def sass_census(library: str, match=("noise", "field", "tile", "stage",
                                    "refine"),
                opcodes=("I2F", "I2FP", "F2F", "F2I", "DADD", "DMUL", "DFMA",
                         "FADD", "FMUL", "FFMA", "LDS", "SHFL")) -> dict:
    """{kernel name: {opcode: count, "all": instructions}} of the compiled
    kernels whose (mangled) names contain one of `match` (static counts:
    a loop body counts once), read with cuobjdump -sass from the CUDA
    toolkit beside nvcc; {} if cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            name = name if any(m in name for m in match) else None
            if name:
                out[name] = dict.fromkeys(opcodes + ("all",), 0)
        elif name and line.startswith("/*") and "*/" in line:
            body = line.split("*/", 1)[1].strip()
            if body.startswith("@"):            # predicated
                body = body.split(None, 1)[1] if " " in body else ""
            op = body.split(" ", 1)[0].split(".", 1)[0].rstrip(";")
            if op:
                out[name]["all"] += 1
            if op in opcodes:
                out[name][op] += 1
    return out


@functools.lru_cache(maxsize=None)
def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The card's SM clock now (nvidia-smi clocks.sm), in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


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
