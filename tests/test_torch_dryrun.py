"""planet_tpu_torch.entry.dryrun_multichip on the CPU (gloo ranks, one
spawned process each, CPU tensors) and the package's rank spawner,
planet_tpu_torch.parallel.ranks.

* n = 4 runs every part: (a) the row-sharded field step, (a2) the 2-axis
  mesh bit for bit the 1-axis one, (b) the sharded LOD composite bit for
  bit the single-device step's over the same 24 roots, (b2) the 2-axis
  LOD mesh bit for bit (b);
* n = 3 runs (a) and (b) without (a2) and (b2) (3 is odd), and n = 5 runs
  (a) alone (5 divides no 24 subtrees); which parts ran is read off the
  results the caller loads;
* a single-device reference that differs (another camera in the caller
  only) fails the run, as does a bad argument;
* the spawner raises for a rank that fails and for ranks past their
  deadline, and kills the ranks.
"""

import time

import numpy as np
import pytest

from planet_tpu_torch import entry
from planet_tpu_torch.parallel import ranks


@pytest.fixture
def loaded(monkeypatch):
    """The result names the caller loads, as a set it fills."""
    names = set()
    load = ranks.load

    def spy(out_dir, name, key, rank):
        names.add(name)
        return load(out_dir, name, key, rank)
    monkeypatch.setattr(ranks, "load", spy)
    return names


@pytest.mark.parametrize("n, parts", [(4, {"a", "a2", "b", "b2"}),
                                      (3, {"a", "b"}), (5, {"a"})])
def test_dryrun_multichip_on_the_cpu(loaded, n, parts):
    entry.dryrun_multichip(n, device="cpu")
    assert loaded == parts


def test_dryrun_fails_when_the_reference_differs(monkeypatch):
    """The caller's single-device step sees the camera 5 % nearer than the
    ranks' (each rank imports entry afresh): its composite differs."""
    camera = entry.dryrun_camera

    def nearer(cfg):
        hi, lo, vp = camera(cfg)
        return hi * np.float32(0.95), lo * np.float32(0.95), vp
    monkeypatch.setattr(entry, "dryrun_camera", nearer)
    with pytest.raises(AssertionError, match=r"\(b\)"):
        entry.dryrun_multichip(2, device="cpu")


def test_dryrun_rejects_bad_arguments():
    with pytest.raises(ValueError):
        entry.dryrun_multichip(0, device="cpu")
    with pytest.raises(ValueError):
        entry.dryrun_multichip(2, device="tpu")


def _raise(rank, world, out_dir, spec):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    time.sleep(spec["sleep"])


def _sleep(rank, world, out_dir, spec):
    time.sleep(spec["sleep"])


def test_spawn_raises_for_a_failing_rank(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank exit codes"):
        ranks.spawn(_raise, 2, tmp_path, dict(sleep=60.0))
    # the surviving rank was killed, not waited for
    assert time.monotonic() - t0 < 40.0


def test_spawn_kills_ranks_past_the_deadline(tmp_path):
    with pytest.raises(RuntimeError, match="still running"):
        ranks.spawn(_sleep, 2, tmp_path, dict(sleep=60.0), deadline_s=5.0)
