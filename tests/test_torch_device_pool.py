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
  generation is counted;
* the fused frame's cache stage (A1's plain version,
  device_pool_cuda.cache_stage_plain) against planet_tpu's, composed from
  its device_pool functions in engine/device_step.py's order, from one
  common state (from_state) on torch_scenes.CACHE_CASES: no pressure with
  the budget binding, capacity pressure, evictions among equal ticks, a
  spill past gen_cap with and without a cached parent, all-padding rows;
  with and without the touch. Bitwise: slot, target, generate, crop, the
  failure flag, the generations' payload (noise-space DF corners),
  octaves and slots, their count, and the pool's keys and ticks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_scenes
from planet_tpu.cache import device_pool as jdp
from planet_tpu.geom import quadid as jq
from planet_tpu.ops.kernels import tile_pallas
from planet_tpu_torch.cache import device_pool as tdp
from planet_tpu_torch.cache import device_pool_cuda as dpc
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


# ------------------------------------------ the cache stage (A1's plain)

def _tp_cache_stage(jpool, c, touch):
    """planet_tpu's cache stage and generate's prologue
    (engine/device_step.py:164-237) from its device_pool functions, in
    its order, on a torch_scenes.cache_case: (pool', outputs)."""
    q_lo, q_hi, depth = (jnp.asarray(c[k]) for k in ("q_lo", "q_hi",
                                                       "depth"))
    rows, gen_cap = q_lo.shape[0], c["gen_cap"]
    active = jnp.arange(rows) < c["n"]
    slot, found = jdp.probe(jpool, q_lo, q_hi)
    found = found & active
    p_lo, p_hi = jq.words_parent(q_lo, q_hi)
    has_parent = depth > 0
    p_slot, p_found = jdp.probe(jpool, jnp.where(has_parent, p_lo, 0),
                                jnp.where(has_parent, p_hi, 0))
    p_found = p_found & has_parent
    generate, use_crop = jdp.plan(found | ~active, p_found, depth,
                                  c["budget"])
    pcap = jpool.keys_lo.shape[0]
    protect = jnp.zeros((pcap + 1,), bool)
    protect = protect.at[jnp.where(found, slot, pcap)].set(True)
    protect = protect.at[jnp.where((use_crop | generate) & p_found,
                                   p_slot, pcap)].set(True)
    jpool, tgt, _ = jdp.allocate(jpool, generate, q_lo, q_hi,
                                 max_gen=gen_cap, protect=protect[:pcap])
    gen_ok = generate & (tgt >= 0)
    gen_fail = generate & active & (tgt < 0)
    use_crop = use_crop | (gen_fail & p_found)
    n_over = jnp.sum((gen_fail & ~p_found).astype(jnp.int32))
    gtgt = jnp.where(gen_ok, jnp.cumsum(gen_ok.astype(jnp.int32)) - 1,
                     gen_cap)
    c_hi, c_lo = (jnp.transpose(jnp.asarray(c[k]).reshape(4, 3, rows),
                                (2, 0, 1))
                  for k in ("corners_hi", "corners_lo"))
    sh, sl = c["coord_scale"]
    sc_h, sc_l = zip(*(tile_pallas._df_mul(
        c_hi[..., a], c_lo[..., a], jnp.full_like(c_hi[..., a], sh),
        jnp.full_like(c_hi[..., a], sl)) for a in range(3)))
    sc_h, sc_l = jnp.stack(sc_h, -1), jnp.stack(sc_l, -1)
    per_tile = jnp.concatenate(
        [jnp.stack([sc_h.transpose(0, 2, 1), sc_l.transpose(0, 2, 1)],
                   axis=-1).reshape(rows, 24),
         jnp.zeros((rows, 8), jnp.float32)], axis=1)
    payload = jnp.zeros((gen_cap + 1, 32), jnp.float32).at[gtgt].set(
        per_tile)[:gen_cap]
    octs = (6 + (12 * depth) // c["max_lod"]).astype(jnp.float32)
    oct_slots = jnp.zeros((gen_cap + 1,), jnp.float32).at[gtgt].set(
        octs)[:gen_cap]
    slot_of_gen = jnp.full((gen_cap + 1,), pcap, jnp.int32).at[gtgt].set(
        tgt)[:gen_cap]
    slot = jnp.where(gen_ok, tgt, jnp.where(use_crop, p_slot, slot))
    if touch:
        jpool = jdp.touch(jpool, slot, active)
    return jpool, dict(slot=slot, target=tgt, generate=gen_ok,
                       crop=use_crop, failed=n_over > 0, payload=payload,
                       oct=oct_slots, gen_slot=slot_of_gen,
                       n_generated=jnp.sum(gen_ok.astype(jnp.int32)))


def _cache_args(c):
    t = [torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("q_lo", "q_hi", "depth", "corners_hi", "corners_lo")]
    kw = {k: c[k] for k in ("budget", "gen_cap", "max_lod", "coord_scale")}
    return t + [torch.tensor(c["n"], dtype=torch.int32)], kw


@pytest.mark.parametrize("touch", [False, True])
@pytest.mark.parametrize("case", list(torch_scenes.CACHE_CASES))
def test_cache_stage_equals_planet_tpu(case, touch):
    c = torch_scenes.cache_case(case)
    jpool = jdp.PoolState(**{k: jnp.asarray(v)
                             for k, v in c["state"].items()})
    tpool = tdp.PoolState.from_state(c["state"], "cpu")
    jpool, want = _tp_cache_stage(jpool, c, touch)
    args, kw = _cache_args(c)
    got = dpc.cache_stage_plain(tpool, *args, touch=touch, **kw)
    for k in ("slot", "target", "generate", "crop", "gen_slot",
              "n_generated"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(want[k]), err_msg=k)
    assert bool(got.failed) == bool(want["failed"])
    payload = np.concatenate([np.stack(
        [got.gen_hi.numpy().transpose(0, 2, 1),
         got.gen_lo.numpy().transpose(0, 2, 1)], -1).reshape(-1, 24),
        np.zeros((c["gen_cap"], 8), np.float32)], axis=1)
    np.testing.assert_array_equal(payload.view(np.int32),
                                  np.asarray(want["payload"]).view(np.int32))
    np.testing.assert_array_equal(got.gen_oct.numpy().astype(np.float32),
                                  np.asarray(want["oct"]))
    state = tpool.to_state()
    for k in ("keys_lo", "keys_hi", "tick"):
        np.testing.assert_array_equal(state[k], np.asarray(getattr(jpool, k)),
                                      err_msg=k)
    # what each case is there for
    n, gen = c["n"], got.generate.numpy()
    crop, tgt = got.crop.numpy(), got.target.numpy()
    expect = {
        "budget": crop.any() and gen.any() and not bool(got.failed),
        "pressure": crop.any() and int(got.n_generated) < int(
            (gen | crop)[:n].sum()),
        # free slots first, then the equal ticks by slot, past the
        # protected parents (0-9) and hits (20, 21)
        "tie": list(tgt[gen]) == list(range(48, 64)) + list(range(10, 20))
        + list(range(22, 36)),
        "spill_parent": int(got.n_generated) == c["gen_cap"]
        and crop.any() and not bool(got.failed),
        "spill_orphan": int(got.n_generated) == c["gen_cap"]
        and crop.any() and bool(got.failed),
        "padding": n == 0 and not gen.any() and not crop.any(),
    }
    assert expect[case], case
