"""Device-resident heightmap tile pool with a host-authoritative index
(planet_tpu.cache.tile_pool, ported).

The reference keeps a CPU open-addressed hash of GL texture handles
(HeightMapCache, main.cpp:75-104: 1024 live entries, LRU eviction by
stalest render tick, main.cpp:247-266). The split is the same here:

* the INDEX (id -> slot, ticks, occupancy, free list) stays numpy on the
  host, identical to planet_tpu — a few thousand integer ops per frame;
* the TILES are one (capacity, dim, dim) float32 tensor on the pool's
  device. `store` writes generated tiles IN PLACE with `index_copy_` (JAX
  arrays are immutable, so planet_tpu rebinds `.at[].set`; the port
  updates the one buffer and never reallocates it).

Semantics are planet_tpu's exactly: a hit refreshes the tick; a miss
evicts the stalest occupied slot only when the pool is full; the engine
applies the generation budget and parent-crop fallback through `resolve`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from planet_tpu_torch.geom import quadid

CACHE_CAP_DEFAULT = 1024      # reference CACHE_MAX (main.cpp:75)


@dataclasses.dataclass
class ResolvedTiles:
    """Per-leaf tile access plan for one frame."""

    slot: np.ndarray         # (L,) int32 pool slot to sample from
    rect_lo: np.ndarray      # (L, 2) f32 tile-rect UV corners
    rect_hi: np.ndarray      # (L, 2) f32
    pixel_size: np.ndarray   # (L, 2) f32
    variant_x: np.ndarray    # (L,) int32: 0 full, 1 crop-lo, 2 crop-hi
    variant_y: np.ndarray    # (L,) int32
    generate_mask: np.ndarray  # (L,) bool — leaves whose tile must be generated
    generated: int           # how many generations this frame consumed


class TilePool:
    """Host index + device tile pool."""

    def __init__(self, capacity: int = CACHE_CAP_DEFAULT, dim: int = 32, *,
                 device):
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.slot_of: Dict[int, int] = {}
        self.id_of = np.zeros(self.capacity, np.uint64)
        self.tick_of = np.zeros(self.capacity, np.int64)
        self.occupied = np.zeros(self.capacity, bool)
        self._free = list(range(self.capacity - 1, -1, -1))
        self.tiles = torch.zeros((self.capacity, self.dim, self.dim),
                                 dtype=torch.float32, device=device)
        self.render_tick = 0

    @classmethod
    def from_state(cls, state: dict, device) -> "TilePool":
        """A pool on `device` from the state of a planet_tpu TilePool:
        `slot_of` (its {quad id: slot} dict), the numpy arrays `id_of`,
        `tick_of`, `occupied` and `free` (the free list in pop order, last
        element popped first), `render_tick`, and `tiles`
        ((capacity, dim, dim) f32, e.g. np.asarray(jax_pool.tiles))."""
        tiles = np.array(state["tiles"], np.float32)
        if tiles.ndim != 3 or tiles.shape[1] != tiles.shape[2]:
            raise ValueError(f"tiles must be (capacity, dim, dim), got "
                             f"{tiles.shape}")
        cap, dim = tiles.shape[0], tiles.shape[1]
        pool = cls(capacity=cap, dim=dim, device=device)
        pool.slot_of = {int(q): int(s) for q, s in state["slot_of"].items()}
        pool.id_of = np.array(state["id_of"], np.uint64)
        pool.tick_of = np.array(state["tick_of"], np.int64)
        pool.occupied = np.array(state["occupied"], bool)
        pool._free = [int(s) for s in state["free"]]
        pool.render_tick = int(state["render_tick"])
        for name in ("id_of", "tick_of", "occupied"):
            if getattr(pool, name).shape != (cap,):
                raise ValueError(f"{name} must have shape ({cap},)")
        pool.tiles.copy_(torch.from_numpy(tiles))
        return pool

    # ------------------------------------------------------------- internals

    def _evict_lru(self) -> int:
        """Reference LRU: stalest occupied slot by render-tick delta
        (main.cpp:247-266)."""
        ticks = np.where(self.occupied, self.tick_of, np.iinfo(np.int64).max)
        slot = int(np.argmin(ticks))
        old = int(self.id_of[slot])
        self.slot_of.pop(old, None)
        self.occupied[slot] = False
        self.id_of[slot] = 0
        return slot

    def _alloc(self, qid: int) -> int:
        if self._free:
            slot = self._free.pop()
        else:
            slot = self._evict_lru()
        self.slot_of[int(qid)] = slot
        self.id_of[slot] = np.uint64(qid)
        self.occupied[slot] = True
        self.tick_of[slot] = self.render_tick
        return slot

    # ------------------------------------------------------------- frame API

    def resolve(self, ids: np.ndarray, budget: int) -> ResolvedTiles:
        """The reference GetHeightMapForQuad policy over a frame's leaf list,
        in leaf order (which is what gives earlier leaves budget priority).

        For each id: cache hit -> its slot, full-tile rect. Miss with budget
        -> allocate a slot, mark for generation. Miss without budget ->
        parent's tile cropped to the child quadrant; if the parent is also
        absent, generate anyway (budget is soft, main.cpp:239).
        """
        dim = self.dim
        n = len(ids)
        slot = np.zeros(n, np.int32)
        rect_lo = np.zeros((n, 2), np.float32)
        rect_hi = np.zeros((n, 2), np.float32)
        pix = np.zeros((n, 2), np.float32)
        vx = np.zeros(n, np.int32)
        vy = np.zeros(n, np.int32)
        gen = np.zeros(n, bool)

        full_lo = np.float32(1.5 / dim)
        full_hi = np.float32((dim - 1.5) / dim)
        full_pix = np.float32(1.0 / dim)
        crop_pix = np.float32(((dim / 2.0 - 1.0) / (dim - 3)) / dim)

        left = int(budget)
        generated = 0

        for i, qid in enumerate(np.asarray(ids, np.uint64)):
            qid_i = int(qid)
            s = self.slot_of.get(qid_i)
            use_crop = False
            if s is None:
                depth = int(quadid.depth_of(qid))
                if left <= 0 and depth > 0:
                    parent = int(quadid.parent_of(qid))
                    ps = self.slot_of.get(parent)
                    if ps is not None:
                        # parent-quadrant crop (main.cpp:216-237)
                        child = int(quadid.child_index_of(qid))
                        x0, y0 = 1.5, 1.5
                        x1, y1 = dim / 2.0 - 0.5, dim / 2.0 - 0.5
                        if child in (1, 3):
                            x0, x1 = dim / 2.0 + 0.5, dim - 1.5
                        if child in (2, 3):
                            y0, y1 = dim / 2.0 + 0.5, dim - 1.5
                        s = ps
                        self.tick_of[ps] = self.render_tick
                        rect_lo[i] = (x0 / dim, y0 / dim)
                        rect_hi[i] = (x1 / dim, y1 / dim)
                        pix[i] = crop_pix
                        vx[i] = 1 + (child & 1)
                        vy[i] = 1 + ((child >> 1) & 1)
                        use_crop = True
                if not use_crop:
                    left -= 1
                    generated += 1
                    s = self._alloc(qid_i)
                    gen[i] = True
            if not use_crop:
                rect_lo[i] = full_lo
                rect_hi[i] = full_hi
                pix[i] = full_pix
                self.tick_of[s] = self.render_tick
            slot[i] = s

        return ResolvedTiles(slot=slot, rect_lo=rect_lo, rect_hi=rect_hi,
                             pixel_size=pix, variant_x=vx, variant_y=vy,
                             generate_mask=gen, generated=generated)

    def store(self, slots, new_tiles: torch.Tensor):
        """Write freshly generated (K, dim, dim) tiles into their slots, in
        place on the pool's device."""
        if len(slots) == 0:
            return
        idx = torch.as_tensor(np.asarray(slots, np.int64),
                              device=self.tiles.device)
        self.tiles.index_copy_(0, idx, new_tiles.to(torch.float32))

    def end_frame(self):
        self.render_tick += 1
