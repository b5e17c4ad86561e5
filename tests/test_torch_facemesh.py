"""The port's cube-face grids and adjacency (planet_tpu_torch
parallel/facemesh) against planet_tpu's parallel/facemesh."""

import numpy as np
import pytest
import torch

from planet_tpu.parallel import facemesh as jfm
from planet_tpu_torch.parallel import facemesh as tfm

torch.set_num_threads(1)
N, O = 32, 1
RADIUS = 6.371e6


@pytest.fixture(scope="module")
def grid():
    return tfm.face_grid_points_df(N, RADIUS, O, device="cpu")


def _f64(d):
    return (d[0].double() + d[1].double()).numpy()


def test_grid_df_matches_host_f64(grid):
    got = np.stack([_f64(d) for d in grid], axis=-1)
    assert got.shape == (6, N + 2 * O, N + 2 * O, 3)
    want = np.stack([jfm.face_grid_points(f, N, RADIUS, O)
                     for f in range(6)])
    assert np.abs(got - want).max() / RADIUS < 1e-12


def test_grid_df_matches_planet_tpu_df(grid):
    """Same op sequence as planet_tpu's device grid; only the DF square
    root's seed differs (nums/df.sqrt), so the values agree to DF
    precision."""
    for got, want in zip(grid, jfm.face_grid_points_df(N, RADIUS, O)):
        w = np.asarray(want.hi, np.float64) + np.asarray(want.lo, np.float64)
        assert np.abs(_f64(got) - w).max() / RADIUS < 1e-13


@pytest.mark.parametrize("row0", [0, 5, 26, torch.tensor(13)])
def test_row_strips_tile_the_grid(grid, row0):
    strip = tfm.face_grid_points_df(N, RADIUS, O, row0=row0, rows=8,
                                    device="cpu")
    r0 = int(row0)
    for s, full in zip(strip, grid):
        assert s[0].shape == (6, 8, N + 2 * O)
        assert torch.equal(s[0], full[0][:, r0:r0 + 8])
        assert torch.equal(s[1], full[1][:, r0:r0 + 8])


def test_host_grid_equals_planet_tpu():
    for f in range(6):
        np.testing.assert_array_equal(tfm.face_grid_points(f, 16, RADIUS, 2),
                                      jfm.face_grid_points(f, 16, RADIUS, 2))


def test_edge_adjacency_equals_planet_tpu():
    for got, want in zip(tfm.edge_adjacency(), jfm.edge_adjacency()):
        np.testing.assert_array_equal(got, want)
