"""Where R1's and S1's time goes, split into parts on the card.

    python planet_tpu_torch/tools/r1_s1_parts.py [--reps N] [--json PATH]
    python planet_tpu_torch/tools/r1_s1_parts.py --root OLD_TREE

With --root, imports planet_tpu_torch from OLD_TREE (another tree of the
port unpacked beside this one, built from its own sources) and runs the
R1 split alone there (refine_row on its refine_cuda; the designs and S1's
bench variants need this tree's kernels).

R1 (csrc/refine.cu), on each case of `refine_cases` (the 1080p static
camera and the dense camera, cap 4096, max_lod 18, from the six faces):
the refine queued (tools/common.time_ms) with the ridged probes and with
"zero" probes (the same code without the noise: the difference is the
probes' noise), and
one refine of each under torch.profiler, whose kernel events say what each
level's launches took on the device, split into the levels that had a
live frontier and the empty ones after it (the frontier of each level
comes from the leaves' depths, `frontier_sizes`); the queued time less
the sum of every device event of the call (R1's kernels and the
wrapper's fills) is what the launches cost between the kernels.

R1's designs (refine_cuda.DESIGNS: the shipped level kernel that
compacts in its last block, the same with the compaction a second kernel,
the whole refine in one block): the split one under the profiler as
above, and each on every case of refine_cases(every=True) (phase 3's
cases and the dense camera), queued, bit for bit against refine_plain.

S1 (csrc/splat.cu), on kernel_times.splat_inputs (PlanetEngine's 12.9 M
fragments and DeviceRenderer's 512 rows, with and without wireframe):
each variant of SPLAT_VARIANTS queued (planet_t_splat, bench-only, counted
in _cuda.launches["t_splat"]), those that store keys bit for bit against
splat_keys_plain.

Prints the card's name and power limit, one line a row, then one JSON
object of every row. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

# planet_t_splat's variants (csrc/splat.cu Variant) -> (code, whether it
# stores the keys, and so is held to the plain version): "frag" is the
# first design (a thread a fragment), "cell" the shipped one
SPLAT_VARIANTS = {"frag": (0, True), "frag no atomic": (1, False),
                  "frag fast div": (2, True), "cell": (3, True),
                  "cell no atomic": (4, False), "cell read skip": (5, True),
                  "cell 1 lane": (9, True), "cell 2 lanes": (7, True),
                  "cell 4 lanes": (6, True), "cell 8 lanes": (8, True)}
# host seconds each queued call may take (tools/common.QUEUE_S, raised for
# an older tree too): a refine's ~30 host calls take ~0.5 ms
QUEUE_S = 2e-3
# the dense frontier: a camera this high above the ridged surface under
# the 1080p scene camera, at this LOD quality (EngineConfig.lod_quality):
# 3,177 leaves, frontiers of up to 384 slots a level, ~4,300 live slots in
# all (quality 24 overflows cap 4096)
DENSE_ALTITUDE = 300.0
DENSE_QUALITY = 16.0


def dense_camera(cfg):
    """The dense case's camera position (f64, metres): DENSE_ALTITUDE above
    the probes' ridged6 surface (6 ridged octaves at gain 0.55 of the unit
    point at 1e-5 per metre, times 8848) under the 1080p scene camera."""
    from planet_tpu_torch.ops import perlin
    from planet_tpu_torch.tools import kernel_times

    pos = kernel_times.scene_camera(cfg).position
    unit = pos / np.linalg.norm(pos)
    p = unit * cfg.radius * 1e-5
    h = perlin.ridged_f64(*(np.array([c]) for c in p), gain=np.float32(0.55),
                          octaves=6, device="cpu")
    return unit * (cfg.radius + float(h[0]) * 8848.0 + DENSE_ALTITUDE)


def refine_cases(device, every: bool = False) -> dict:
    """{name: (args, keywords)} of refine_cuda as the fused frame calls it
    (ridged probes): the 1080p static camera and the dense camera
    (DENSE_QUALITY), from the six faces; with `every` also chip_smoke.py
    phase 3's other cases, the orbit's first frames and the 24 subtree
    roots with their depths."""
    from planet_tpu_torch.engine import device_step
    from planet_tpu_torch.engine.config import EngineConfig
    from planet_tpu_torch.nums import df as dfm
    from planet_tpu_torch.parallel import sharded_lod
    from planet_tpu_torch.tools import kernel_times

    cfg = EngineConfig(window_w=kernel_times.SCENE_W,
                       window_h=kernel_times.SCENE_H)
    faces = device_step.face_roots(cfg.radius, device)[:4]
    kw = dict(max_lod=cfg.max_lod, cap=4096, radius=cfg.radius,
              probe="ridged6")
    static = kernel_times.scene_camera(cfg).position
    cases = [("1080p static", static, faces, {}),
             ("dense", dense_camera(cfg), faces,
              dict(quality=DENSE_QUALITY))]
    if every:
        *subs, depth = sharded_lod.subtree_roots(cfg.radius, device)
        cases[1:1] = [
            *((f"orbit {i}", cam.position, faces, {}) for i, (_, cam)
              in enumerate(kernel_times.orbit_cameras(cfg))),
            ("24 subtree roots", static, subs, dict(root_depth=depth))]
    out = {}
    for name, pos, roots, extra in cases:
        cam = [torch.as_tensor(a, device=device)
               for a in dfm.from_f64_np(pos)]
        out[name] = ((*cam, *roots), dict(kw, **extra))
    return out


def frontier_sizes(depths, max_lod: int, n_roots: int) -> list:
    """Each level's frontier size, from the leaves' depths of a refine
    from n_roots depth-0 roots that did not overflow: a level's frontier
    is its leaves and its split slots, whose 4 children each are the next
    level's frontier."""
    leaves = np.bincount(np.asarray(depths), minlength=max_lod + 1)
    sizes = [0] * (max_lod + 2)
    for d in range(max_lod, -1, -1):
        sizes[d] = int(leaves[d]) + sizes[d + 1] // 4
    assert sizes[0] == n_roots, (sizes[0], n_roots)
    return sizes[:max_lod + 1]


def kernel_events(fn) -> list:
    """[(name, device µs)] of the kernels of one call of fn(), in order,
    from a torch.profiler session around it alone."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    evs.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.end - e.time_range.start) for e in evs]


def _short(name: str) -> str:
    """A kernel's name without its namespace, arguments and "void"."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.split("::")[-1].replace("void ", "").strip()


def refine_row(name, args, kw, probe, reps, call=None) -> dict:
    """R1 on one case with one probe: queued ms, the level sizes, and the
    profiler's kernel µs by level (live or empty) and kernel name."""
    from planet_tpu_torch.ops.kernels import refine_cuda
    from planet_tpu_torch.tools import common

    kw = dict(kw, probe=probe)
    if call is None:
        def call():
            return refine_cuda.refine_cuda(*args, **kw)
    res = call()
    n = int(res[2])
    sizes = frontier_sizes(res[0][2, :n].cpu().numpy(), kw["max_lod"],
                           args[2].shape[0])
    ms = common.time_ms(call, reps=reps)
    all_evs = kernel_events(call)
    evs = [e for e in all_evs if "refine" in e[0].lower()
           or any(k in e[0] for k in ("evaluate", "compact", "level"))]
    levels = kw["max_lod"] + 1
    per_level = len(evs) // levels if evs and len(evs) % levels == 0 else 0
    parts: dict = {}
    if per_level:
        for i, (ename, us) in enumerate(evs):
            live = sizes[i // per_level] > 0
            key = f"{_short(ename)} ({'live' if live else 'empty'})"
            c, t = parts.get(key, (0, 0.0))
            parts[key] = (c + 1, t + us)
    else:
        for ename, us in evs:
            c, t = parts.get(_short(ename), (0, 0.0))
            parts[_short(ename)] = (c + 1, t + us)
    busy_us = sum(us for _, us in evs)
    return dict(case=name, probe=probe, ms=ms, leaves=n,
                overflowed=bool(res[3]), sizes=sizes,
                live_levels=sum(1 for s in sizes if s),
                events=len(evs), busy_us=busy_us,
                device_events=len(all_evs),
                between_us=ms * 1e3 - sum(us for _, us in all_evs),
                parts={k: dict(n=c, us=t, us_each=t / c)
                       for k, (c, t) in parts.items()})


def design_rows(reps: int, dev) -> list:
    """Each R1 design of refine_cuda.DESIGNS on every case of refine_cases
    (every=True), queued, each bit for bit against refine_plain."""
    from planet_tpu_torch.lod import refine_device
    from planet_tpu_torch.ops.kernels import refine_cuda
    from planet_tpu_torch.tools import common

    rows = []
    for name, (args, kw) in refine_cases(dev, every=True).items():
        want = refine_device.refine_plain(*args, **kw)
        for design in refine_cuda.DESIGNS:
            got = refine_cuda.refine_design(design, *args, **kw)
            equal = all(common.same(a, b) for a, b in zip(got, want))
            rows.append(dict(case=name, design=design, equal=equal,
                             leaves=int(got[2]), ms=common.time_ms(
                                 lambda d=design: refine_cuda.refine_design(
                                     d, *args, **kw), reps=reps)))
    return rows


def t_splat(variant: str, clip, shade, valid, width, height, k, wireframe):
    """S1's bench variant `variant` (planet_t_splat) into a fresh
    framebuffer."""
    from planet_tpu_torch import _cuda
    from planet_tpu_torch.raster import splat

    code, _ = SPLAT_VARIANTS[variant]
    splat._check_grid(clip, shade, valid)
    fb = torch.full((height, width), splat._EMPTY, dtype=torch.int32,
                    device=clip.device)
    _cuda.launch("t_splat", "planet_t_splat", code, clip.data_ptr(),
                 shade.data_ptr(), valid.data_ptr(), clip.shape[0],
                 clip.shape[1], int(k), int(wireframe), width, height,
                 fb.data_ptr())
    return fb


def splat_rows(reps: int, dev) -> list:
    """Each variant of SPLAT_VARIANTS and the shipped S1 on every shape of
    kernel_times.splat_inputs, queued, bit for bit against the plain
    version where the variant stores keys."""
    from planet_tpu_torch.raster import splat
    from planet_tpu_torch.tools import common, kernel_times

    rows = []
    for name, sargs in kernel_times.splat_inputs(dev).items():
        want = splat.splat_keys_plain(*sargs)
        for variant, (_, stores) in SPLAT_VARIANTS.items():
            got = t_splat(variant, *sargs)
            equal = common.same(got, want) if stores else None
            rows.append(dict(shape=name, variant=variant, equal=equal,
                             ms=common.time_ms(
                                 lambda v=variant: t_splat(v, *sargs),
                                 reps=reps)))
        rows.append(dict(shape=name, variant="shipped (splat_keys_cuda)",
                         equal=common.same(splat.splat_keys_cuda(*sargs),
                                           want),
                         ms=common.time_ms(
                             lambda: splat.splat_keys_cuda(*sargs),
                             reps=reps)))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--json", default=None)
    p.add_argument("--root", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(
        args.root or pathlib.Path(__file__).resolve().parents[2]).resolve()))
    from planet_tpu_torch import _cuda
    from planet_tpu_torch.tools import common

    if not torch.cuda.is_available():
        print("r1_s1_parts: no CUDA device", file=sys.stderr)
        return 2
    common.QUEUE_S = max(common.QUEUE_S, QUEUE_S)
    _cuda.library()
    dev = torch.device("cuda")
    print(common.card_line(), flush=True)
    out = {"card": common.card_line(), "root": args.root, "refine": [],
           "splat": []}
    for name, (rargs, kw) in refine_cases(dev).items():
        for probe in ("ridged6", "zero"):
            r = refine_row(name, rargs, kw, probe, args.reps)
            out["refine"].append(r)
            print(f"R1 {name:14s} {probe:8s} {r['ms']:.4f} ms queued; "
                  f"{r['leaves']} leaves, {r['live_levels']} live levels "
                  f"(frontier {r['sizes']}), {r['events']} kernels, "
                  f"{r['busy_us']:.1f} us busy ({r['device_events']} device "
                  f"events), {r['between_us']:.1f} us between; " + "; ".join(
                      f"{k}: {v['n']} x {v['us_each']:.2f} us"
                      for k, v in r["parts"].items()), flush=True)
    if not args.root:
        from planet_tpu_torch.ops.kernels import refine_cuda
        for name, (rargs, kw) in refine_cases(dev).items():
            r = refine_row(name, rargs, kw, "ridged6", args.reps,
                           call=lambda a=rargs, k=kw: refine_cuda.
                           refine_design("split", *a, **k))
            r["design"] = "split"
            out["refine"].append(r)
            print(f"R1 {name:14s} split design {r['ms']:.4f} ms queued; "
                  + "; ".join(f"{k}: {v['n']} x {v['us_each']:.2f} us"
                              for k, v in r["parts"].items()), flush=True)
        out["designs"] = design_rows(args.reps, dev)
        for r in out["designs"]:
            print(f"R1 design {r['design']:10s} {r['case']:18s} "
                  f"{r['ms']:.4f} ms queued; {r['leaves']} leaves; equal "
                  f"to plain: {r['equal']}", flush=True)
        for r in splat_rows(args.reps, dev):
            out["splat"].append(r)
            print(f"S1 {r['shape']:32s} {r['variant']:28s} {r['ms']:.4f} "
                  f"ms queued; equal to plain: {r['equal']}", flush=True)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
