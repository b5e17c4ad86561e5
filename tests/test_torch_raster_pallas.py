"""The port's raster path (planet_tpu_torch.raster.coverage_cuda.raster_frame,
plain versions on the CPU) against planet_tpu's Pallas raster in interpret
mode (coverage_pallas.raster_frame_pallas) — the TPU engine whose routing
the port keeps: span-class records to one kernel, huge ones and
far-straddlers to the other. Bars of tests/test_raster_exact.py:243-288:
coverage agreement > 0.999, packed depth and shade within 1 quantum.

Interpret mode runs every class kernel grid step by step on the CPU (about
a minute here), so this file holds that one comparison and runs beside the
other raster tests."""

import numpy as np
import torch

import jax.numpy as jnp

from planet_tpu.raster import coverage_pallas
from planet_tpu_torch.raster import coverage_cuda as tcc
from torch_scenes import SCREEN, screen_scene

torch.set_num_threads(1)
EMPTY = 2**31 - 1


def test_screen_scene_matches_pallas_interpret():
    w, h = SCREEN["width"], SCREEN["height"]
    clip, normal, valid = screen_scene(11, w, h, SCREEN["sizes"])
    got, counters = tcc.raster_frame(
        torch.from_numpy(clip), torch.from_numpy(normal),
        torch.from_numpy(valid), w, h, decode=False)
    got = got.numpy()
    assert counters.n_per_class[0] > 0 and counters.n_huge > 0
    want, pc = coverage_pallas.raster_frame_pallas(
        jnp.asarray(clip), jnp.asarray(normal), jnp.asarray(valid), w, h,
        decode=False, interpret=True, caps=(128,) * 6, huge_cap=16,
        quad_cap=None)
    want = np.asarray(want)
    assert not bool(pc.overflowed)
    assert int(pc.n_tris) == counters.n_tris
    assert int(pc.n_huge) == counters.n_huge
    cov_eq = (got == EMPTY) == (want == EMPTY)
    assert cov_eq.mean() > 0.999, cov_eq.mean()
    both = (got != EMPTY) & (want != EMPTY)
    assert np.abs((got[both] >> 10) - (want[both] >> 10)).max() <= 1
    assert np.abs((got[both] & 1023) - (want[both] & 1023)).max() <= 1
