"""The LOD cells' chip probe: one period of a traffic mix's camera path,
each frame's leaf count, generations and overflow flags (read back after
each frame; nothing is timed), to size the configuration's caps.

    python3 perfbench/tools/probe.py <workload> <frames> <seed> [<seed> ...]

prints one line a seed: the leaves' and generations' least, median and
largest, the frames that overflowed and the largest refine the path asks
for (leaves before the render cap)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv):
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from perfbench.harness import cell as cell_mod
    from perfbench.drivers import lod

    name, frames, seeds = argv[0], int(argv[1]), [int(s) for s in argv[2:]]
    c = cell_mod.load(ROOT, name)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    if dev == "cpu":
        c = c.dry_run()
    for seed in seeds:
        run = lod.Run(c, seed=seed, seconds=0, trace=False, device=dev,
                      t_start=0.0)
        eng = run._engine()
        rows = []
        from planet_tpu_torch.geom.camera import Camera
        for k in range(frames):
            pos, ang = run.path.at(k)
            eng.render(Camera(pos, ang))
            r = eng.renderer
            g = r.last_geometry
            meta = g.meta.tolist()
            rows.append((meta[0], meta[1], meta[2],
                         int(r.last_counters.overflowed),
                         int(r.last_counters.n_straddle)))
        a = np.array(rows)
        g = a[min(96, frames - 1):, 1]
        print(f"{name} seed {seed}: generated a frame after the first 96: "
              f"median {np.median(g):.0f}, p90 {np.percentile(g, 90):.0f}, "
              f"max {g.max()}, share of frames at the 100-tile budget "
              f"{np.mean(g >= 100):.3f}; leaves p90 "
              f"{np.percentile(a[:, 0], 90):.0f}", flush=True)
        print(f"{name} seed {seed}: leaves {a[:, 0].min()}-"
              f"{int(np.median(a[:, 0]))}-{a[:, 0].max()}, generated "
              f"{a[:, 1].min()}-{int(np.median(a[:, 1]))}-{a[:, 1].max()} "
              f"(after frame 3: max {a[3:, 1].max() if frames > 3 else 0}), "
              f"geometry overflow frames {int((a[:, 2] != 0).sum())}, "
              f"raster overflow frames {int(a[:, 3].sum())}, straddlers max "
              f"{a[:, 4].max()}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
