"""The fused frame's cache stage and generate's prologue, plain (A1's
version): `cache_stage_plain`, device_pool's probe, plan, allocate and
touch and the step's spill and generation prologue, in planet_tpu's order
(engine/device_step.py:164-198, 200-237).

cache_stage_plain(pool, q_lo, q_hi, depth, corners_hi, corners_lo, n, *,
budget, gen_cap, max_lod, coord_scale, touch=True) -> CacheStage: one
frame's R rows in DFS order (q_lo, q_hi, depth (R,) int32; corners_hi,
corners_lo (12, R) f32, corner-major: row 3 c + a is corner c's axis a),
n () int32 the live rows (the first n). It updates the pool's keys and
ticks in place: the generations' keys and ticks, and with `touch` the
tick of the slot each live row samples. coord_scale is the DF (hi, lo)
float32 pair of the noise space's scale. Its index_copy_ also writes the
dump row at index `capacity`, which is not part of the result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference.frozen.cache import device_pool as dp
from perfbench.reference.frozen.geom import quadid
from perfbench.reference.frozen.nums import df as dfm

_I32 = torch.int32


class CacheStage(NamedTuple):
    slot: torch.Tensor         # (R,) int32 the slot each row samples
    target: torch.Tensor       # (R,) int32 allocated slot, -1 for none
    generate: torch.Tensor     # (R,) bool given a slot to generate into
    crop: torch.Tensor         # (R,) bool samples its parent's crop
    failed: torch.Tensor       # () bool a generation spilled, no parent
    gen_hi: torch.Tensor       # (gen_cap, 4, 3) f32 noise-space corners
    gen_lo: torch.Tensor
    gen_oct: torch.Tensor      # (gen_cap,) int32 octaves, 0 past the count
    gen_slot: torch.Tensor     # (gen_cap,) int32, capacity past the count
    n_generated: torch.Tensor  # () int32


def _rows_corners(c: torch.Tensor) -> torch.Tensor:
    """(12, R) corner-major corners as an (R, 4, 3) view."""
    return c.reshape(4, 3, c.shape[1]).permute(2, 0, 1)


def cache_stage_plain(pool: dp.PoolState, q_lo, q_hi, depth, corners_hi,
                      corners_lo, n, *, budget: int, gen_cap: int,
                      max_lod: int, coord_scale, touch: bool = True):
    """A1's plain version."""
    dev = q_lo.device
    active = torch.arange(q_lo.shape[0], device=dev, dtype=_I32) < n
    slot, found = dp.probe(pool, q_lo, q_hi)
    found = found & active
    p_lo, p_hi = quadid.words_parent(q_lo, q_hi)
    has_parent = depth > 0
    p_slot, p_found = dp.probe(pool, torch.where(has_parent, p_lo, 0),
                               torch.where(has_parent, p_hi, 0))
    p_found = p_found & has_parent
    generate, use_crop = dp.plan(found | ~active, p_found, depth, budget)
    # slots this frame resolved (hits, crop parents, parents of planned
    # generations, which a spilled generation falls back to) must not be
    # evicted by the batched allocator (see dp.allocate)
    pcap = pool.capacity
    protect = torch.zeros(pcap + 1, dtype=torch.bool, device=dev)
    protect.index_fill_(0, torch.where(found, slot, pcap).long(), True)
    protect.index_fill_(0, torch.where((use_crop | generate) & p_found,
                                       p_slot, pcap).long(), True)
    tgt, _ = dp.allocate(pool, generate, q_lo, q_hi, max_gen=gen_cap,
                         protect=protect[:pcap])
    gen_ok = generate & (tgt >= 0)
    # generation spill (beyond gen_cap, or no evictable slot): the parent
    # crop, as the reference's exhausted budget (main.cpp:208-237); only a
    # spilled leaf with no cached parent is a failure
    gen_fail = generate & active & (tgt < 0)
    use_crop = use_crop | (gen_fail & p_found)
    # the slot each row samples: its new tile, its parent's, or its hit
    slot = torch.where(gen_ok, tgt, torch.where(use_crop, p_slot, slot))
    if touch:
        # refresh ticks: hits, crop parents, and the slot to sample from
        dp.touch(pool, slot, active)

    # generate's prologue: the generations compacted into gen_cap rows
    gen_i = gen_ok.to(_I32)
    gtgt = torch.where(gen_ok, torch.cumsum(gen_i, 0, dtype=_I32) - 1,
                       gen_cap).long()
    # corners in noise space: DF times the DF coord_scale
    c_hi = _rows_corners(corners_hi)
    sc = dfm.mul((c_hi, _rows_corners(corners_lo)),
                 tuple(dfm.const(x, c_hi) for x in coord_scale))
    gen_hi, gen_lo = (torch.zeros((gen_cap + 1, 4, 3), dtype=torch.float32,
                                  device=dev).index_copy_(0, gtgt, part)
                      [:gen_cap] for part in sc)
    octs = (6 + (12 * depth) // max_lod).to(_I32)
    gen_oct = torch.zeros(gen_cap + 1, dtype=_I32,
                          device=dev).index_copy_(0, gtgt, octs)[:gen_cap]
    gen_slot = torch.full((gen_cap + 1,), pcap, dtype=_I32,
                          device=dev).index_copy_(0, gtgt, tgt)[:gen_cap]
    return CacheStage(slot, tgt, gen_ok, use_crop,
                      (gen_fail & ~p_found).any(), gen_hi, gen_lo, gen_oct,
                      gen_slot, gen_i.sum(dtype=_I32))


