"""Sharded streaming-LOD engine (planet_tpu parallel/sharded_lod.py, ported
to torch.distributed; BASELINE config 5's quadtree path).

Every rank runs the fused device frame (engine/device_step: refine ->
cache -> generate -> tessellate -> exact raster) over its own SUBTREES of
the planet quadtree, and the ranks composite one global frame with
collectives, outside the rank's captured geometry graph:

* Work: the 24 depth-1 quads (6 faces x 4 children, the reference's root
  seeding and first split, main.cpp:604-624/581-594) in DFS order; rank r
  of N owns the contiguous block [r 24/N, (r+1) 24/N) (`local_roots`),
  which is what planet_tpu's shard_map over P(axis) gives it. Refinement
  of disjoint subtrees is independent (ProcessQuad's split decision
  depends only on the quad and the camera, main.cpp:546-571), so a rank's
  leaves are the single-device leaves of its subtrees.
* Tile cache: each rank keeps its own device pool (cache/device_pool.py);
  tiles never move between ranks. The generation budget (main.cpp:653)
  and the caps apply per rank.
* Seams need no height exchange: tiles carry the reference's one-texel
  overscan border (main.cpp:135-148), a function of the quad alone.
* Composite: the exact raster's packed int32 keys (21-bit depth, 10-bit
  shade) take their elementwise MIN as the LEQUAL depth test
  (raster/coverage.py), so the global frame is `all_reduce(MIN)` of the
  ranks' packed framebuffers, and the counts an `all_reduce(SUM)`.

MIN and SUM are associative and commutative and every other stage is per
leaf, so the composite equals the single-device step from all 24 roots
bit for bit whenever no rank overruns its budget or caps.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from planet_tpu_torch.cache import device_pool as dp
from planet_tpu_torch.engine import device_step
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.geom import quadid
from planet_tpu_torch.lod import refine_device
from planet_tpu_torch.parallel import sharded
from planet_tpu_torch.raster import coverage

N_SUBTREES = 24


def subtree_roots(radius: float, device="cuda"):
    """The 24 depth-1 quads in DFS order: (lo, hi (24,) int32 id words,
    ch, cl (24, 4, 3) f32 DF corners, depth (24,) int32) on `device`. The
    corners are the device refiner's own DF subdivision of the six faces
    (refine_device._subdivide), so a refine from them replays the
    single-device refine's arithmetic from its first split on."""
    root_lo, root_hi, root_ch, root_cl, _ = device_step.face_roots(radius,
                                                                    device)
    corners = (root_ch.permute(1, 2, 0), root_cl.permute(1, 2, 0))
    kids = refine_device._subdivide(
        corners, refine_device._split_const(radius, root_ch))
    # (4 child, 12, 6 faces) -> (6 faces x 4 children, 4 corners, 3 axes)
    ch, cl = (k.permute(2, 0, 1).reshape(N_SUBTREES, 4, 3).contiguous()
              for k in kids)
    ids = np.array([quadid.make_child(quadid.make_root(f), c)
                    for f in range(6) for c in range(4)], np.uint64)
    lo, hi = (torch.as_tensor(w, device=device)
              for w in quadid.to_words(ids))
    depth = torch.ones(N_SUBTREES, dtype=torch.int32, device=device)
    return lo, hi, ch, cl, depth


def shard_index(mesh: DeviceMesh, axis="quads"):
    """(index, count) of this rank over the mesh axis, or over the
    flattened product of a tuple of axes (outer axis major, as shard_map
    flattens them)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    index, count = 0, 1
    for a in axes:
        size = mesh.shape[mesh.mesh_dim_names.index(a)]
        index, count = index * size + mesh.get_local_rank(a), count * size
    return index, count


def local_roots(roots, index: int, count: int):
    """Shard `index` of `count`'s contiguous block of the 24 roots."""
    if N_SUBTREES % count:
        raise ValueError(f"{count} shards do not divide {N_SUBTREES} "
                         "subtrees")
    per = N_SUBTREES // count
    return tuple(r[index * per:(index + 1) * per] for r in roots)


def pool_from_planet_tpu(stacked: dict, n: int, rank: int,
                         device="cuda") -> dp.PoolState:
    """Rank `rank`'s pool from planet_tpu's stacked pools (its
    init_pools(n, ...) state as numpy: keys_lo, keys_hi, tick (n*CAP,),
    tiles (n*CAP, dim, dim), now (n,)), with the port's dump row. planet_tpu
    stacks one pool a chip along dim 0 because one program holds them all;
    a rank of the port holds its own (cache/device_pool.init)."""
    cap, rem = divmod(np.asarray(stacked["keys_lo"]).shape[0], n)
    if rem or not 0 <= rank < n:
        raise ValueError(f"cannot take rank {rank} of {n} stacked pools")
    rows = slice(rank * cap, (rank + 1) * cap)
    state = {k: np.asarray(stacked[k])[rows]
             for k in ("keys_lo", "keys_hi", "tick", "tiles")}
    state["now"] = np.asarray(stacked["now"])[rank]
    return dp.PoolState.from_state(state, device)


def build_sharded_render(cfg: EngineConfig, mesh: DeviceMesh, width: int,
                         height: int, *, axis="quads", cap: int = 4096,
                         render_cap: int = 512, gen_cap: int = 256,
                         max_lod=None, probe: str = "ridged6"):
    """Returns this rank's fn(pool, cam_hi, cam_lo, view_proj) ->
    (DeviceFrame, (leaf_lo, leaf_hi (render_cap,) int32, n_leaves,
    n_generated (0-dim int32))): the rank's geometry step (one CUDA-graph replay on the
    card) from its share of the 24 subtree roots (`local_roots` of
    subtree_roots at `shard_index(mesh, axis)`, fixed when built; planet_tpu
    passes all 24 to every call and shard_map slices them), the packed
    raster, the MIN composite over the mesh and the summed counts. The
    frame holds the composited image and depth and the mesh's totals; the
    leaf words and counts are the rank's own. pool: this rank's, from
    cache/device_pool.init(cfg.cache_capacity, cfg.tile_dim, device),
    updated in place. Caps (cap, render_cap, gen_cap, the budget) are per
    rank.

    axis: one mesh axis name, or a tuple of names (("slice", "quads") on a
    make_mesh_2d mesh): the subtrees shard over the flattened product and
    the composite reduces the inner axis first, then crosses slices once
    a frame."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    groups = [mesh.get_group(a) for a in reversed(axes)]
    device = sharded.rank_device(mesh)
    roots = local_roots(subtree_roots(cfg.radius, device),
                        *shard_index(mesh, axes))
    renderer = device_step.DeviceRenderer(
        cfg, width, height, device=device, roots=roots, cap=cap,
        render_cap=render_cap, gen_cap=gen_cap, max_lod=max_lod, probe=probe)

    def render(pool, cam_hi, cam_lo, view_proj):
        geom = renderer.geometry(pool, cam_hi, cam_lo, view_proj)
        (packed, n, n_gen, ovf, q_lo, q_hi), _ = device_step.raster_packed(
            geom, cfg, width, height)
        totals = torch.stack([n, n_gen, ovf.to(torch.int32)])
        for group in groups:                 # inner axis first
            dist.all_reduce(packed, op=dist.ReduceOp.MIN, group=group)
            dist.all_reduce(totals, group=group)
        image, depth = coverage.decode_packed(packed)
        frame = device_step.DeviceFrame(image, depth, totals[0], totals[1],
                                        totals[2] > 0)
        # the words and counts are the graph's output buffers: the next
        # replay writes them
        return frame, (q_lo.clone(), q_hi.clone(), n.clone(), n_gen.clone())

    return render
