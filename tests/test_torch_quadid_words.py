"""The port's device-side quad-id word ops (planet_tpu_torch.geom.quadid
words_*) against planet_tpu's: bitwise equal on 500 seeded ids at depths
0-27, and the packed DFS key orders ids as the host dfs_key does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from planet_tpu.geom import quadid as jq
from planet_tpu_torch.geom import quadid as tq

torch.set_num_threads(1)


def _ids(seed, n, max_depth):
    rng = np.random.default_rng(seed)
    ids = []
    for _ in range(n):
        face = int(rng.integers(0, 6))
        depth = int(rng.integers(0, max_depth + 1))
        ids.append(jq.from_path(face, [int(c) for c in
                                       rng.integers(0, 4, depth)]))
    return np.array(ids, np.uint64)


@pytest.fixture(scope="module")
def words():
    lo, hi = jq.to_words(_ids(3, 500, 27))
    return (jnp.asarray(lo), jnp.asarray(hi),
            torch.from_numpy(lo), torch.from_numpy(hi))


def _eq(want, got):
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("op", ["words_depth", "words_root"])
def test_hi_word_fields_bitwise(words, op):
    jlo, jhi, tlo, thi = words
    _eq(getattr(jq, op)(jhi), getattr(tq, op)(thi))


def test_valid_child_index_parent_bitwise(words):
    jlo, jhi, tlo, thi = words
    _eq(jq.words_valid(jlo, jhi), tq.words_valid(tlo, thi))
    # depth-0 ids (roots) have no child index or parent; planet_tpu's words
    # ops are defined on them all the same, and so are the port's
    _eq(jq.words_child_index(jlo, jhi), tq.words_child_index(tlo, thi))
    for a, b in zip(jq.words_parent(jlo, jhi), tq.words_parent(tlo, thi)):
        _eq(a, b)


@pytest.mark.parametrize("child", [0, 1, 2, 3])
def test_make_child_bitwise(words, child):
    jlo, jhi, tlo, thi = words
    want = jq.words_make_child(jlo, jhi, jnp.int32(child))
    for a, b in zip(want, tq.words_make_child(tlo, thi, child)):
        _eq(a, b)
    per_id = torch.full_like(tlo, child)
    for a, b in zip(want, tq.words_make_child(tlo, thi, per_id)):
        _eq(a, b)


@pytest.mark.parametrize("level", [1, 2, 16, 17, 27])
def test_path_digit_bitwise(words, level):
    jlo, jhi, tlo, thi = words
    _eq(jq.words_path_digit(jlo, jhi, level),
        tq.words_path_digit(tlo, thi, level))


def test_dfs_key_is_planet_tpus_pair_packed(words):
    """One int64 key = planet_tpu's (khi, klo) as khi << 26 | klo."""
    jlo, jhi, tlo, thi = words
    khi, klo = jq.words_dfs_key(jlo, jhi)
    want = (np.asarray(khi).astype(np.int64) << 26) \
        | np.asarray(klo).astype(np.int64)
    _eq(want, tq.words_dfs_key(tlo, thi))


def test_words_dfs_key_matches_host_order():
    """tests/test_device_step.py:169-184, ported: a stable sort of the
    device keys gives the host dfs_key order."""
    ids = _ids(11, 200, 18)
    host_keys = np.array([jq.dfs_key(q) for q in ids], np.uint64)
    lo, hi = tq.to_words(ids)
    key = tq.words_dfs_key(torch.from_numpy(lo), torch.from_numpy(hi))
    dev_order = torch.argsort(key, stable=True).numpy()
    np.testing.assert_array_equal(dev_order,
                                  np.argsort(host_keys, kind="stable"))


def test_words_equal_bitwise(words):
    jlo, jhi, tlo, thi = words
    # each id against itself, its neighbour in the list, and an id that
    # differs from it in one word only
    for shift in (0, 1):
        blo, bhi = np.roll(np.asarray(jlo), shift), np.roll(np.asarray(jhi),
                                                            shift)
        _eq(jq.words_equal(jlo, jhi, jnp.asarray(blo), jnp.asarray(bhi)),
            tq.words_equal(tlo, thi, torch.from_numpy(blo),
                           torch.from_numpy(bhi)))
    _eq(jq.words_equal(jlo, jhi, jlo ^ 1, jhi),
        tq.words_equal(tlo, thi, tlo ^ 1, thi))
    assert bool(tq.words_equal(tlo, thi, tlo, thi).all())
