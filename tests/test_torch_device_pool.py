"""The port's device tile pool (planet_tpu_torch.cache.device_pool, on the
CPU) against the port's host TilePool and against planet_tpu's
device_pool (tests/test_device_pool.py and tests/test_pool_divergence.py,
ported).

* policy: the same hit/generate/crop masks and cached id sets as the host
  TilePool when nothing is evicted, and the right LRU survivors;
* state: from one common `from_state`, the port's keys, ticks, tiles and
  render tick equal planet_tpu's bit for bit after every probe, plan,
  allocate (with protect), store, touch and end_frame of a multi-frame
  real-terrain orbit, with and without capacity pressure;
* safety under capacity pressure: a slot this frame resolved (hit or crop
  parent) is never evicted before its gather, and every dropped
  generation is counted.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from planet_tpu.cache import device_pool as jdp
from planet_tpu.geom import quadid as jq
from planet_tpu_torch.cache import device_pool as tdp
from planet_tpu_torch.cache.tile_pool import TilePool
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.geom import quadid as tq
from planet_tpu_torch.lod import refine as lod_refine

torch.set_num_threads(1)
DIM = 8            # tiny tiles: the pool is about keys and ticks


def _words(ids):
    lo, hi = tq.to_words(np.asarray(ids, np.uint64))
    return torch.from_numpy(lo), torch.from_numpy(hi)


def _parents(ids):
    return np.array([jq.parent_of(np.uint64(q)) if jq.depth_of(q) > 0
                     else np.uint64(0) for q in ids], np.uint64)


def _is_ancestor(a, q):
    da, dq = int(jq.depth_of(a)), int(jq.depth_of(q))
    if da >= dq:
        return False
    q = np.uint64(q)
    for _ in range(dq - da):
        q = jq.parent_of(q)
    return int(q) == int(a)


def _cached_ids(pool):
    cap = pool.capacity
    occ = pool.keys_hi[:cap] < 0
    return set(int(q) for q in tq.from_words(pool.keys_lo[:cap][occ].numpy(),
                                             pool.keys_hi[:cap][occ].numpy()))


def test_device_pool_matches_host_policy():
    """tests/test_device_pool.py:37-116: with no eviction (capacity above
    the universe), the batched plan reproduces the host pool's masks and
    cached sets frame by frame, and gathers return the right tiles."""
    rng = np.random.default_rng(7)
    cap, budget = 64, 4
    host = TilePool(capacity=cap, dim=DIM, device="cpu")
    pool = tdp.init(cap, DIM, "cpu")
    universe = []
    for f in range(6):
        universe.append(jq.from_path(f, []))
        for c in range(4):
            universe.append(jq.from_path(f, [c]))
            universe.append(jq.from_path(f, [c, (c + 1) % 4]))
    universe = np.array(universe, np.uint64)

    for frame in range(12):
        ids = rng.choice(universe, size=int(rng.integers(4, 20)),
                         replace=False)
        ids = np.array([q for q in ids
                        if not any(_is_ancestor(a, q) for a in ids)],
                       np.uint64)
        depths = torch.as_tensor([int(jq.depth_of(q)) for q in ids])
        res = host.resolve(ids, budget)

        q_lo, q_hi = _words(ids)
        p_lo, p_hi = _words(_parents(ids))
        slot, found = tdp.probe(pool, q_lo, q_hi)
        _, p_found = tdp.probe(pool, p_lo, p_hi)
        gen, crop = tdp.plan(found, p_found, depths, budget)
        np.testing.assert_array_equal(gen.numpy(), res.generate_mask)
        np.testing.assert_array_equal(crop.numpy(), res.variant_x > 0)

        tgt, n_over = tdp.allocate(pool, gen, q_lo, q_hi, max_gen=cap)
        assert int(n_over) == 0
        tdp.store(pool, tgt, gen, q_lo.to(torch.float32)[:, None, None]
                  .expand(len(ids), DIM, DIM))
        tdp.touch(pool, slot, found)
        p_slot, _ = tdp.probe(pool, p_lo, p_hi)
        tdp.touch(pool, p_slot, crop)
        host.end_frame()
        tdp.end_frame(pool)
        assert _cached_ids(pool) == set(host.slot_of.keys()), frame

    ids = rng.choice(np.array(sorted(host.slot_of), np.uint64), 5,
                     replace=False)
    q_lo, q_hi = _words(ids)
    slot, found = tdp.probe(pool, q_lo, q_hi)
    assert bool(found.all())
    np.testing.assert_array_equal(tdp.gather(pool, slot)[:, 0, 0].numpy(),
                                  q_lo.to(torch.float32).numpy())


def test_device_pool_lru_eviction():
    """tests/test_device_pool.py:119-139: the stalest slots go first."""
    cap = 4
    pool = tdp.init(cap, DIM, "cpu")
    ids = [jq.from_path(0, [c]) for c in range(4)] \
        + [jq.from_path(1, [0]), jq.from_path(1, [1])]

    def insert(subset):
        q_lo, q_hi = _words(subset)
        slot, found = tdp.probe(pool, q_lo, q_hi)
        tdp.allocate(pool, ~found, q_lo, q_hi, max_gen=cap)
        tdp.touch(pool, slot, found)
        tdp.end_frame(pool)

    insert(ids[:4])      # fill
    insert(ids[2:4])     # refresh 2, 3
    insert(ids[4:6])     # must evict 0, 1 (stalest)
    assert _cached_ids(pool) == {int(q) for q in ids[2:6]}


# ------------------------------------------------- state against planet_tpu

CFG = EngineConfig()


@pytest.fixture(scope="module")
def orbit():
    """Per-frame DFS-ordered (ids, depths) of a descending real-terrain
    orbit (tests/test_pool_divergence.py:45-56), 2.0 R -> 1.03 R: earlier
    frames' leaves are later frames' parents."""
    frames = []
    for t, alt in zip(np.linspace(0.0, 0.25, 6), np.geomspace(2.0, 1.03, 6)):
        pos = alt * CFG.radius * np.array([np.sin(t), 0.2, -np.cos(t)])
        res = lod_refine.refine(pos, 6, CFG.radius)
        frames.append((res.ids, res.depths))
    return frames


def _content(ids):
    lo = (np.asarray(ids, np.uint64) & np.uint64(0xFFFFFFFF)).astype(
        np.float32)
    return np.broadcast_to(lo[:, None, None], (len(lo), DIM, DIM)).copy()


def _assert_state(jpool, tpool, where):
    got = tpool.to_state()
    for name in ("keys_lo", "keys_hi", "tick", "tiles", "now"):
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(jpool, name)),
                                      err_msg=f"{name} after {where}")


def _frame(jpool, tpool, ids, depths, budget, gen_cap):
    """One frame in both packages, in device_step's op order (probe ->
    parent probe -> plan -> protect -> allocate -> store -> touch ->
    gather -> end_frame), comparing the states after every op. Returns
    (jpool', gen, gen_ok, gathered, expected, n_over)."""
    lo, hi = tq.to_words(np.asarray(ids, np.uint64))
    jq_lo, jq_hi, jdepth = jnp.asarray(lo), jnp.asarray(hi), \
        jnp.asarray(depths, jnp.int32)
    tq_lo, tq_hi = torch.from_numpy(lo), torch.from_numpy(hi)
    tdepth = torch.as_tensor(np.asarray(depths), dtype=torch.int32)
    cap = tpool.capacity

    j_slot, j_found = jdp.probe(jpool, jq_lo, jq_hi)
    t_slot, t_found = tdp.probe(tpool, tq_lo, tq_hi)
    jp_lo, jp_hi = jq.words_parent(jq_lo, jq_hi)
    tp_lo, tp_hi = tq.words_parent(tq_lo, tq_hi)
    jp_slot, jp_found = jdp.probe(jpool, jnp.where(jdepth > 0, jp_lo, 0),
                                  jnp.where(jdepth > 0, jp_hi, 0))
    tp_slot, tp_found = tdp.probe(tpool,
                                  torch.where(tdepth > 0, tp_lo, 0),
                                  torch.where(tdepth > 0, tp_hi, 0))
    jp_found = jp_found & (jdepth > 0)
    tp_found = tp_found & (tdepth > 0)
    for a, b in ((j_slot, t_slot), (j_found, t_found), (jp_slot, tp_slot),
                 (jp_found, tp_found)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _assert_state(jpool, tpool, "probe")

    j_gen, j_crop = jdp.plan(j_found, jp_found, jdepth, budget)
    t_gen, t_crop = tdp.plan(t_found, tp_found, tdepth, budget)
    np.testing.assert_array_equal(np.asarray(j_gen), t_gen.numpy())
    np.testing.assert_array_equal(np.asarray(j_crop), t_crop.numpy())

    j_prot = jnp.zeros((cap + 1,), bool)
    j_prot = j_prot.at[jnp.where(j_found, j_slot, cap)].set(True)
    j_prot = j_prot.at[jnp.where(j_crop & jp_found, jp_slot, cap)].set(True)
    t_prot = torch.zeros(cap + 1, dtype=torch.bool)
    t_prot.index_fill_(0, torch.where(t_found, t_slot, cap).long(), True)
    t_prot.index_fill_(0, torch.where(t_crop & tp_found, tp_slot,
                                      cap).long(), True)
    jpool, j_tgt, j_over = jdp.allocate(jpool, j_gen, jq_lo, jq_hi,
                                        max_gen=gen_cap,
                                        protect=j_prot[:cap])
    t_tgt, t_over = tdp.allocate(tpool, t_gen, tq_lo, tq_hi,
                                 max_gen=gen_cap, protect=t_prot[:cap])
    np.testing.assert_array_equal(np.asarray(j_tgt), t_tgt.numpy())
    assert int(j_over) == int(t_over)
    _assert_state(jpool, tpool, "allocate")

    gen_ok = t_gen & (t_tgt >= 0)
    content = _content(ids)
    jpool = jdp.store(jpool, jnp.where(np.asarray(gen_ok), j_tgt, cap),
                      np.asarray(gen_ok), jnp.asarray(content))
    tdp.store(tpool, torch.where(gen_ok, t_tgt, cap), gen_ok,
              torch.from_numpy(content))
    _assert_state(jpool, tpool, "store")

    j_use = jnp.where(np.asarray(gen_ok), j_tgt,
                      jnp.where(j_crop, jp_slot, j_slot))
    t_use = torch.where(gen_ok, t_tgt, torch.where(t_crop, tp_slot, t_slot))
    jpool = jdp.touch(jpool, j_use, jnp.ones(len(ids), bool))
    tdp.touch(tpool, t_use, torch.ones(len(ids), dtype=torch.bool))
    _assert_state(jpool, tpool, "touch")

    gathered = tdp.gather(tpool, t_use).numpy()
    np.testing.assert_array_equal(np.asarray(jdp.gather(jpool, j_use)),
                                  gathered)
    jpool = jdp.end_frame(jpool)
    tdp.end_frame(tpool)
    _assert_state(jpool, tpool, "end_frame")

    parent = _parents(ids)
    exp_id = np.where(t_crop.numpy(), parent, np.asarray(ids, np.uint64))
    expected = (exp_id & np.uint64(0xFFFFFFFF)).astype(np.float32)
    return jpool, t_gen.numpy(), gen_ok.numpy(), gathered, expected, \
        int(t_over)


@pytest.mark.parametrize("capacity,budget,gen_cap", [
    (4096, 24, 1024),      # no pressure, the budget binds: crops
    (None, 10**6, None),   # capacity < working set: eviction every frame
])
def test_state_equals_planet_tpu_from_common_state(orbit, capacity, budget,
                                                   gen_cap):
    if capacity is None:
        # tests/test_pool_divergence.py:149-190's pressure: half the
        # smallest frame, so every frame evicts
        capacity = max(64, min(len(ids) for ids, _ in orbit) // 2)
        gen_cap = capacity
    # a common non-empty starting state: planet_tpu's pool after the first
    # frame, carried across with from_state
    jpool = jdp.init(capacity, DIM)
    tpool = tdp.init(capacity, DIM, "cpu")
    jpool, *_ = _frame(jpool, tpool, *orbit[0], budget, gen_cap)
    tpool = tdp.PoolState.from_state(
        {name: np.asarray(getattr(jpool, name))
         for name in ("keys_lo", "keys_hi", "tick", "tiles", "now")}, "cpu")
    _assert_state(jpool, tpool, "from_state")

    saw_drop = False
    for ids, depths in orbit[1:]:
        jpool, gen, gen_ok, gathered, expected, n_over = _frame(
            jpool, tpool, ids, depths, budget, gen_cap)
        # safety: every leaf whose generation was not dropped gathers its
        # own (or its crop parent's) tile — protected slots were never
        # evicted mid-frame — and every dropped generation is counted
        ok_rows = ~(gen & ~gen_ok)
        np.testing.assert_array_equal(gathered[ok_rows, 0, 0],
                                      expected[ok_rows])
        assert n_over == int((gen & ~gen_ok).sum())
        saw_drop |= n_over > 0
    assert saw_drop == (budget == 10**6)
