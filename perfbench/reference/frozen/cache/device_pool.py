"""Fully device-resident tile cache (planet_tpu cache/device_pool.py,
ported): the capture-safe twin of cache.tile_pool.

The reference's open-addressed CPU hash (main.cpp:75-104, LRU eviction by
stalest render tick, main.cpp:247-266) becomes fixed-shape tensor ops with
no host sync, so the fused frame step can run them inside a CUDA graph:

* probe     — (L, CAP) key compare + argmax
* plan      — the per-frame budget policy in closed form (one exclusive
              cumsum; see `plan`)
* allocate  — K slots for K generations at once: free slots first, then
              stalest occupied, protected slots never
* touch/store/gather/end_frame — tick refresh, tile scatter, tile gather,
              render-tick advance

State lives in persistent tensors that every op updates IN PLACE. planet_tpu
rebuilds a cap + 1 copy of the keys, ticks and the (cap, dim, dim) tile pool
with `.at[].set` in each call (JAX arrays are immutable; XLA donates the
buffers under jit), which on the GPU would copy the 4 MB pool per store.
Here every state tensor carries a dump row at index `capacity` once and
for all: a masked-off write lands there and is never read. The semantics,
and every value in rows [0, capacity), are planet_tpu's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_I32 = torch.int32


class PoolState(NamedTuple):
    """Device pool state; each tensor has a dump row at index `capacity`."""

    keys_lo: torch.Tensor   # (CAP + 1,) int32 — (0, 0) = empty
    keys_hi: torch.Tensor   # (CAP + 1,) int32 — valid ids have bit 63 set
    tick: torch.Tensor      # (CAP + 1,) int32 last-used render tick
    tiles: torch.Tensor     # (CAP + 1, dim, dim) f32
    now: torch.Tensor       # () int32 render tick

    @property
    def capacity(self) -> int:
        return self.keys_lo.shape[0] - 1


def init(capacity: int, dim: int, device) -> PoolState:
    return PoolState(
        keys_lo=torch.zeros(capacity + 1, dtype=_I32, device=device),
        keys_hi=torch.zeros(capacity + 1, dtype=_I32, device=device),
        tick=torch.zeros(capacity + 1, dtype=_I32, device=device),
        tiles=torch.zeros((capacity + 1, dim, dim), dtype=torch.float32,
                          device=device),
        now=torch.zeros((), dtype=_I32, device=device))


def probe(state: PoolState, q_lo, q_hi):
    """(L,) id words -> (slot, found). Empty-key queries return
    found=False; a miss returns slot 0 (planet_tpu's argmax of no match)."""
    cap = state.capacity
    eq = (q_lo[:, None] == state.keys_lo[None, :cap]) \
        & (q_hi[:, None] == state.keys_hi[None, :cap])      # (L, CAP)
    found = eq.any(dim=1) & (q_hi < 0)                     # valid bit = sign
    slot = torch.argmax(eq.to(torch.uint8), dim=1).to(_I32)
    return slot, found


def plan(found, parent_found, depth, budget: int):
    """The reference GetHeightMapForQuad policy over one frame's leaves in
    order (main.cpp:191-278): returns (generate, use_crop) masks.

    The generation count is nondecreasing, so until it first reaches the
    budget EVERY miss generates; after that every croppable miss crops.
    Hence generate_i = miss_i & (no_parent_i | misses_before_i < budget)."""
    miss = ~found
    can_crop = parent_found & (depth > 0)
    miss_i = miss.to(_I32)
    misses_before = torch.cumsum(miss_i, 0, dtype=_I32) - miss_i
    generate = miss & (~can_crop | (misses_before < budget))
    use_crop = miss & ~generate
    return generate, use_crop


def allocate(state: PoolState, generate, q_lo, q_hi, max_gen: int,
             protect=None):
    """Assign slots to the first max_gen generating leaves: free slots
    first, then stalest occupied (batched LRU), never a `protect`ed slot
    ((CAP,) bool: this frame's hits and crop parents). Writes the new keys
    and ticks in place. Returns (slots (L,) int32, -1 where no slot was
    given; n_over, the generations left without one).

    The eviction order is a STABLE argsort, as jnp.argsort is: an unstable
    sort would break ties between equal ticks differently and pick other
    slots than planet_tpu."""
    cap = state.capacity
    occupied = state.keys_hi[:cap] < 0
    order_key = torch.where(occupied, state.tick[:cap],
                            torch.full_like(state.tick[:cap], -2**31))
    if protect is not None:
        order_key = torch.where(protect, torch.full_like(order_key,
                                                         2**31 - 1),
                                order_key)
    slot_order = torch.argsort(order_key, stable=True).to(_I32)   # (CAP,)

    gen_i = generate.to(_I32)
    gen_rank = torch.cumsum(gen_i, 0, dtype=_I32) - 1      # rank among gens
    ok = generate & (gen_rank < max_gen)
    if protect is not None:
        ok = ok & (gen_rank < cap - protect.to(_I32).sum(dtype=_I32))
    else:
        ok = ok & (gen_rank < cap)
    tgt = torch.where(ok, slot_order[torch.clamp(gen_rank, 0, cap - 1)],
                      torch.full_like(gen_rank, -1))

    # write new keys/ticks at allocated slots (dump row for the rest)
    w = torch.where(ok, tgt, torch.full_like(tgt, cap)).long()
    state.keys_lo.index_copy_(0, w, q_lo)
    state.keys_hi.index_copy_(0, w, q_hi)
    state.tick.index_copy_(0, w, state.now.expand(w.shape[0]))
    n_over = (generate & ~ok).to(_I32).sum(dtype=_I32)
    return tgt, n_over


def touch(state: PoolState, slots, mask):
    """Refresh the tick of `slots` where `mask`, in place."""
    w = torch.where(mask, slots, torch.full_like(slots, state.capacity))
    state.tick.index_copy_(0, w.long(), state.now.expand(w.shape[0]))


def store(state: PoolState, slots, mask, new_tiles):
    """Write (K, dim, dim) tiles into `slots` where `mask`, in place."""
    w = torch.where(mask, slots, torch.full_like(slots, state.capacity))
    state.tiles.index_copy_(0, w.long(), new_tiles.to(torch.float32))


def gather(state: PoolState, slots):
    return state.tiles.index_select(0, torch.clamp(slots, min=0).long())


def end_frame(state: PoolState):
    state.now.add_(1)
