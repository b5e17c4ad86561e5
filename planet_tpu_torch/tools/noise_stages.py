"""Stage split of the noise core and the tile texel (T1, T2).

    python -m planet_tpu_torch.tools.noise_stages            # on the card
    python -m planet_tpu_torch.tools.noise_stages --device cpu --small

The port's counterpart of planet_tpu's tools/microbench_stages.py (T1) and
tools/bench_tiles2.py (T2): the noise core shared by K1, K4 and K5
(csrc/noise.cuh) and K1's texel, cut into the stages the TPU tools timed,
each a compile-time variant of csrc/bench_noise.cu with a plain PyTorch
version here that it equals bit for bit.

t_noise (T1), 2^22 points uniform in [-60, 60]^3 (numpy default_rng(0),
as double-float pairs), ridged, 6 octaves, lacunarity 2, gain 0.55:

* full — ops/perlin.accumulate_octaves: K4's body;
* splits — the int24 split once, then each octave's cells, fractions and
  fades (nums/df.shift_frac48, ops/perlin.frac_parts), summed;
* splits_gathers — the same plus noise3's 8-corner permutation chain and
  its 8 gradient-sign lookups, summed;
* hoisted — octave 0's split and fade reused every octave, the x cell
  moved by the octave index (microbench_stages.nosplit_full: cx + i): noise3
  and the ridged update only.

t_tile (T2), 4096 tiles of 32x32: the corners of lod/refine.refine at
bench_tiles2's camera (1.2 radii from the centre, max_lod 18) x 1e-5,
tiled to 4096, ridged 6, amplitude 8848:

* full — K1's texel (tile.cu): the overscan uv, the corner blend, the
  noise, the amplitude;
* bilinear — the uv and the blend only, the six words summed;
* noise — the uv as the coordinates (u, v, u / 2), noise and amplitude.

The CUDA kernels start with nothing on the card; `noise_stage` and
`tile_stage` launch them for CUDA tensors (counted in
_cuda.launches["t_noise"] / ["t_tile"]) and run the plain versions for CPU
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.lod import refine as lod_refine
from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.ops import perlin
from planet_tpu_torch.ops.kernels import perlin_cuda, tile_cuda
from planet_tpu_torch.tools import common

NOISE_VARIANTS = ("full", "splits", "splits_gathers", "hoisted")
TILE_VARIANTS = ("full", "bilinear", "noise")
REPLACES = {"t_noise": "tools/microbench_stages.py:32",
            "t_tile": "tools/bench_tiles2.py:87"}
SIZES = {"points": 1 << 22, "tiles": 4096}
SMALL = {"points": 1 << 12, "tiles": 16}
OCTAVES, GAIN, AMPLITUDE, DIM = 6, 0.55, 8848.0, 32
RADIUS, MAX_LOD = 6371000.0, 18
CAMERA = (0.0, 0.0, -1.2 * RADIUS)

# f32 operations per point or texel, counted from csrc/bench_noise.cu (each
# add, subtract, multiply, divide, compare and min/max is one; -fmad=false,
# so no FMA). The integer hashing and the f64 fraction and fade are not
# counted, so each bound is a floor.
OPS_SPLIT = 96        # int24_parts of a point, 3 axes
OPS_OCTAVE = 92       # noise3 (85) + the ridged update
OPS_SPLIT_SUM = 10    # split_sum (9) + the accumulate
OPS_UV = 48           # two non-power-of-two df_scale
OPS_BLEND = 516       # 3 axes x (5 df_add + 3 df_mul)
NOISE_OPS = {"full": OPS_SPLIT + OCTAVES * OPS_OCTAVE,
             "splits": OPS_SPLIT + OCTAVES * OPS_SPLIT_SUM,
             "splits_gathers": OPS_SPLIT + OCTAVES * (OPS_SPLIT_SUM + 1),
             "hoisted": OPS_SPLIT + OCTAVES * OPS_OCTAVE}
TILE_OPS = {"full": OPS_UV + OPS_BLEND + OPS_SPLIT + OCTAVES * OPS_OCTAVE + 1,
            "bilinear": OPS_UV + OPS_BLEND + 5,
            "noise": OPS_UV + 2 + OPS_SPLIT + OCTAVES * OPS_OCTAVE + 1}


# ------------------------------------------------------------------ inputs

def noise_inputs(n: int = SIZES["points"], device="cuda", seed: int = 0):
    """Six (n,) f32 tensors (xh, xl, yh, yl, zh, zl): n points uniform in
    [-60, 60]^3 from numpy's default_rng(seed), split into double-float."""
    pts = np.random.default_rng(seed).uniform(-60.0, 60.0, (3, n))
    out = []
    for a in range(3):
        out += [torch.as_tensor(x, device=device)
                for x in dfm.from_f64_np(pts[a])]
    return out


def tile_inputs(n: int = SIZES["tiles"], device="cuda"):
    """(corners_hi, corners_lo), each (n, 4, 3) f32: bench_tiles2's leaf
    corners x 1e-5, tiled to n tiles."""
    res = lod_refine.refine(np.array(CAMERA), MAX_LOD, RADIUS)
    reps = -(-n // len(res.corners))
    corners = np.tile(res.corners, (reps, 1, 1))[:n] * 1e-5
    return tuple(torch.as_tensor(x, device=device)
                 for x in dfm.from_f64_np(corners))


# ---------------------------------------------------------- plain versions

def octave_splits(coords, octaves: int = OCTAVES):
    """Per octave, per axis: (cell int32, f, f - 1, fade) f32 — the split
    each octave of the kernels takes (int24 split once, static shifts)."""
    parts = [dfm.int24_parts(coords[2 * k], coords[2 * k + 1])
             for k in range(3)]
    out = []
    for o in range(octaves):
        axes = []
        for p in parts:
            cell, frac = dfm.shift_frac48(*p, o)
            axes.append((cell, *perlin.frac_parts(frac)))
        out.append(axes)
    return out


def split_sum(axes):
    """One octave's split sum of variants splits and splits_gathers
    (bench_noise.cu split_sum): f, f - 1 and fade of the three axes, then
    the three cells."""
    s = axes[0][1] + axes[0][2]
    s = s + axes[0][3]
    for _, f, fm1, fade in axes[1:]:
        s = s + f
        s = s + fm1
        s = s + fade
    cells = axes[0][0] + axes[1][0] + axes[2][0]
    return s + cells.to(torch.float32)


def sign_sum(perm, signs, cx, cy, cz):
    """noise3's hash chain: the sum of the 8 corners' gradient-sign codes
    (int64 cells in, int64 out)."""
    a0, a1 = perm[cx & 255], perm[(cx + 1) & 255]
    g = torch.zeros_like(cx)
    for b in (perm[(a0 + cy) & 255], perm[(a0 + cy + 1) & 255],
              perm[(a1 + cy) & 255], perm[(a1 + cy + 1) & 255]):
        g = g + signs[(b + cz) & 255] + signs[(b + cz + 1) & 255]
    return g


def noise_plain(variant: str, coords, *, octaves: int = OCTAVES,
                gain=GAIN):
    """Plain PyTorch version of t_noise `variant` on the six coordinate
    tensors; bench_noise.cu's op order."""
    if variant not in NOISE_VARIANTS:
        raise ValueError(f"unknown noise variant {variant!r}")
    gain = np.float32(gain)
    if variant == "full":
        return perlin.accumulate_octaves("ridged", octaves, 2.0, gain,
                                         *coords)
    perm, signs = perlin._tables(str(coords[0].device))
    if variant == "hoisted":
        axes = octave_splits(coords, 1)[0]
        value = torch.zeros_like(coords[0])
        weight = torch.ones_like(coords[0])
        amplitude = np.float32(1.0)
        for o in range(octaves):
            args = []
            for k, (cell, f, fm1, fade) in enumerate(axes):
                args += [(cell + (o if k == 0 else 0)).long(), f, fm1, fade]
            n = perlin.noise3_core(perm, signs, *args)
            v = 1.0 - torch.abs(n)
            v = v * v
            value = value + v * float(amplitude) * weight
            weight = v
            amplitude = np.float32(amplitude * gain)
        return value
    acc = torch.zeros_like(coords[0])
    for axes in octave_splits(coords, octaves):
        acc = acc + split_sum(axes)
        if variant == "splits_gathers":
            g = sign_sum(perm, signs, *(a[0].long() for a in axes))
            acc = acc + g.to(torch.float32)
    return acc


def tile_plain(variant: str, corners_hi, corners_lo, *,
               octaves: int = OCTAVES, gain=GAIN, amplitude=AMPLITUDE):
    """Plain PyTorch version of t_tile `variant`: (N, 32, 32) f32."""
    if variant not in TILE_VARIANTS:
        raise ValueError(f"unknown tile variant {variant!r}")
    n = corners_hi.shape[0]
    if variant == "full":
        octs = torch.full((n,), octaves, dtype=torch.int32,
                          device=corners_hi.device)
        return tile_cuda.tiles_plain(corners_hi, corners_lo, octs,
                                     kind="ridged", lacunarity=2.0,
                                     gain=gain, amplitude=amplitude, dim=DIM)
    if variant == "bilinear":
        c = tile_cuda.tile_coords(corners_hi, corners_lo, DIM)
        value = c[0] + c[2]
        for k in (4, 1, 3, 5):
            value = value + c[k]
        return value
    shape = (n, DIM, DIM)
    (uh, ul), (vh, vl) = tile_cuda.tile_uv(DIM, corners_hi.device)
    coords = [t.expand(shape) for t in (uh, ul, vh, vl, uh * 0.5, ul * 0.5)]
    value = perlin.accumulate_octaves("ridged", octaves, 2.0,
                                      np.float32(gain), *coords)
    return value * float(np.float32(amplitude))


# ------------------------------------------------------------ the kernels

def _check_coords(coords):
    if len(coords) != 6:
        raise ValueError("expected six coordinate tensors (xh .. zl)")
    for name, t in zip(("xh", "xl", "yh", "yl", "zh", "zl"), coords):
        _cuda.check_cuda(t, name, torch.float32, coords[0].shape)


def noise_kernel(variant: str, coords, *, octaves: int = OCTAVES, gain=GAIN):
    """t_noise `variant` on the card (csrc/bench_noise.cu)."""
    if variant not in NOISE_VARIANTS:
        raise ValueError(f"unknown noise variant {variant!r}")
    if not 0 <= int(octaves) <= perlin_cuda.MAX_OCTAVES:
        raise ValueError(f"octaves must be in [0, {perlin_cuda.MAX_OCTAVES}]")
    _check_coords(coords)
    out = torch.empty_like(coords[0])
    if out.numel():
        perm, signs, freq = perlin_cuda.kernel_tables(2.0,
                                                      str(out.device))
        _cuda.launch("t_noise", "planet_t_noise",
                     NOISE_VARIANTS.index(variant),
                     *(t.data_ptr() for t in coords), perm.data_ptr(),
                     signs.data_ptr(), freq.data_ptr(), out.data_ptr(),
                     out.numel(), int(octaves), float(np.float32(gain)))
    return out


def tile_kernel(variant: str, corners_hi, corners_lo, *,
                    octaves: int = OCTAVES, gain=GAIN, amplitude=AMPLITUDE):
    """t_tile `variant` on the card (csrc/bench_noise.cu)."""
    if variant not in TILE_VARIANTS:
        raise ValueError(f"unknown tile variant {variant!r}")
    if not 0 <= int(octaves) <= perlin_cuda.MAX_OCTAVES:
        raise ValueError(f"octaves must be in [0, {perlin_cuda.MAX_OCTAVES}]")
    n = corners_hi.shape[0]
    _cuda.check_cuda(corners_hi, "corners_hi", torch.float32, (n, 4, 3))
    _cuda.check_cuda(corners_lo, "corners_lo", torch.float32, (n, 4, 3))
    out = torch.empty((n, DIM, DIM), dtype=torch.float32,
                      device=corners_hi.device)
    if n:
        perm, signs, freq = perlin_cuda.kernel_tables(2.0,
                                                      str(out.device))
        div = np.float64(1.0) / np.float64(DIM - 3)
        div_hi = np.float32(div)
        div_lo = np.float32(div - np.float64(div_hi))
        _cuda.launch("t_tile", "planet_t_tile", TILE_VARIANTS.index(variant),
                     corners_hi.data_ptr(), corners_lo.data_ptr(),
                     perm.data_ptr(), signs.data_ptr(), freq.data_ptr(),
                     out.data_ptr(), n, int(octaves), float(np.float32(gain)),
                     float(np.float32(amplitude)), float(div_hi),
                     float(div_lo))
    return out


def noise_stage(variant: str, coords, **kw):
    """t_noise `variant`: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if common.device_of(coords[0]) == "cuda":
        return noise_kernel(variant, coords, **kw)
    return noise_plain(variant, coords, **kw)


def tile_stage(variant: str, corners_hi, corners_lo, **kw):
    """t_tile `variant`: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if common.device_of(corners_hi) == "cuda":
        return tile_kernel(variant, corners_hi, corners_lo, **kw)
    return tile_plain(variant, corners_hi, corners_lo, **kw)


# ------------------------------------------------------------------- runs

def bench(device: str = "cuda", small: bool = False,
          reps: int = common.REPS) -> dict:
    """Every variant of both tools once against its plain version, then
    timed: {"t_noise": [...], "t_tile": [...], "inputs": ...}, one dict a
    variant (name, ms, rate in G points or texels a second, bound, equal,
    max_abs_err), the headline ("full") also with plain_ms."""
    sizes = SMALL if small else SIZES
    coords = noise_inputs(sizes["points"], device)
    corners = tile_inputs(sizes["tiles"], device)
    out = {"inputs": {"coords": coords, "corners": corners}}
    for key, names, run, plain, args, count, ops, nbytes in (
            ("t_noise", NOISE_VARIANTS, noise_stage, noise_plain, (coords,),
             coords[0].numel(), NOISE_OPS, lambda n: n * 28),
            ("t_tile", TILE_VARIANTS, tile_stage, tile_plain, corners,
             corners[0].shape[0] * DIM * DIM, TILE_OPS,
             lambda n: corners[0].shape[0] * 96 + n * 4)):
        rows = []
        for name in names:
            got = run(name, *args)
            want = plain(name, *args)
            ms = common.time_ms(lambda: run(name, *args), reps=reps,
                                device=device)
            rows.append(dict(
                name=name, ms=ms, rate=count / ms / 1e6,
                bound=common.bound_ms(count * ops[name], nbytes(count)),
                equal=common.same(got, want),
                max_abs_err=common.max_abs_err(got, want),
                finite=bool(torch.isfinite(got).all())))
            if name == "full":
                rows[-1]["plain_ms"] = common.time_ms(
                    lambda: plain(name, *args), reps=min(reps, 3),
                    device=device)
        out[key] = rows
    return out


def main(argv=None) -> int:
    args = common.parse_args(argv, __doc__.splitlines()[0])
    res = bench(args.device, args.small, args.reps)
    for key, unit in (("t_noise", "Gpoint/s"), ("t_tile", "Gtexel/s")):
        for r in res[key]:
            print(common.line(key[2:], r, unit, args.device), flush=True)
    ok = all(r["equal"] and r["finite"]
             for key in ("t_noise", "t_tile") for r in res[key])
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
