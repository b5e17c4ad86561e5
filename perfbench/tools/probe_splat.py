"""The splat cells' chip probe: one period of a traffic mix's camera path
through the cell's engine in the splat raster mode, each frame's leaf
count, generations and geometry overflow flag, the S1 fragments of the
cells that pass the back-face cull, and the pixels a fragment lands on
before and after the hole fill (read back after each frame; nothing is
timed), then the peak of the card's memory.

    python3 perfbench/tools/probe_splat.py <workload> <frames> <seed> [...]

prints one line a seed."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv):
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from perfbench.drivers import lod_splat
    from perfbench.harness import cell as cell_mod
    from planet_tpu_torch.engine.planet import splat_valid
    from planet_tpu_torch.geom.camera import Camera
    from planet_tpu_torch.raster import splat

    name, frames, seeds = argv[0], int(argv[1]), [int(s) for s in argv[2:]]
    c = cell_mod.load(ROOT, name)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    if dev == "cpu":
        c = c.dry_run()
    for seed in seeds:
        run = lod_splat.Run(c, seed=seed, seconds=0, trace=False, device=dev,
                            t_start=0.0)
        eng = run._engine()
        cfg, w, h = eng.cfg, eng.width, eng.height
        k = cfg.raster_supersample
        rows = []
        for f in range(frames):
            pos, ang = run.path.at(f)
            _, _, depth = eng.render(Camera(pos, ang))
            g = eng.renderer.last_geometry
            v = splat_valid(g.vertices, g.valid)
            cells = (v[:, :-1, :-1] & v[:, :-1, 1:] & v[:, 1:, :-1]
                     & v[:, 1:, 1:]).sum()
            keys = splat.splat_keys(g.vertices.clip, g.vertex_shade, v, w, h,
                                    k)
            covered = (keys != splat._EMPTY).sum()
            rows.append(torch.stack([
                g.meta[0], g.meta[1], g.meta[2], cells, covered,
                torch.isfinite(depth).sum()]).tolist())
        a = np.array(rows, dtype=np.float64)
        frags = a[:, 3] * k * k
        pix = float(w * h)
        peak = (torch.cuda.max_memory_allocated() if dev == "cuda" else 0)
        print(f"{name} seed {seed}: {frames} frames; leaves "
              f"{a[:, 0].min():.0f}-{np.median(a[:, 0]):.0f}-"
              f"{a[:, 0].max():.0f}; generated after the first 96 median "
              f"{np.median(a[min(96, frames - 1):, 1]):.0f}; geometry "
              f"overflow frames {int((a[:, 2] != 0).sum())}; S1 fragments a "
              f"frame {frags.min():.0f}-{np.median(frags):.0f}-"
              f"{frags.max():.0f}; covered before the fill "
              f"{a[:, 4].min() / pix:.4f}-{np.median(a[:, 4]) / pix:.4f}-"
              f"{a[:, 4].max() / pix:.4f}, after "
              f"{a[:, 5].min() / pix:.4f}-{np.median(a[:, 5]) / pix:.4f}-"
              f"{a[:, 5].max() / pix:.4f}; peak {peak} B", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
