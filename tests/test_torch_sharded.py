"""The port's sharded heightfield step (planet_tpu_torch.parallel.sharded)
on the CPU over gloo, one spawned process a rank (tests/torch_ranks.py),
against the port's single-device twin and planet_tpu
(tests/test_sharded.py, ported).

Bars: the sharded step (1-D meshes of 1, 2 and 4 ranks and a (2, 2) mesh
with the face-seam exchange, a (3, 1) mesh with clamp) equal to the
port's unsharded step bit for bit in heights and shade, stats at rtol
1e-6 (f32 sums in another order); the fused path on 2 and 4 ranks equal
to field_cuda.field_plain bit for bit; the port's unsharded step within
0.2 m and 1e-3 of planet_tpu's (the field bars: the port takes each
octave's fraction in f64, ROADMAP section 3); `_seam_lines` equal to
planet_tpu's bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

import torch_ranks
from planet_tpu.nums import df as jdf
from planet_tpu.parallel import sharded as jsh
from planet_tpu_torch.nums import df as tdf
from planet_tpu_torch.ops.kernels import field_cuda
from planet_tpu_torch.parallel import facemesh
from planet_tpu_torch.parallel import sharded

torch.set_num_threads(1)
RADIUS = 6371000.0
FUSED_N = 128


def _points(n):
    """The six (6, n, n) DF point components of every face's texels."""
    pts = np.stack([facemesh.face_grid_points(f, n, RADIUS)
                    for f in range(6)])
    return [a for k in range(3) for a in tdf.from_f64_np(pts[..., k])]


P32, P16 = _points(32), _points(16)
EXCHANGE = dict(octaves=4, xyscale=1000.0, seam="exchange", points=P32)
# world size -> the cases its ranks run, one process group each
WORLDS = {
    1: {"n1": dict(EXCHANGE, mesh=(1,))},
    2: {"n2": dict(EXCHANGE, mesh=(2,)),
        "fused2": dict(mesh=(2,), fused=FUSED_N, octaves=6)},
    3: {"clamp31": dict(mesh=(3, 1), octaves=2, xyscale=500.0, seam="clamp",
                        points=P16)},
    4: {"n4": dict(EXCHANGE, mesh=(4,)),
        "mesh22": dict(EXCHANGE, mesh=(2, 2)),
        "fused4": dict(mesh=(4,), fused=FUSED_N, octaves=6)},
}
CASES = {name: (world, case) for world, cases in WORLDS.items()
         for name, case in cases.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks run once; the ranks' strips put back together,
    per case: (heights, shade, each rank's stats)."""
    out = {}
    for world, cases in WORLDS.items():
        d = tmp_path_factory.mktemp(f"field{world}")
        torch_ranks.spawn(torch_ranks.field_worker, world, d,
                          {"cases": cases})
        for name, case in cases.items():
            h, sh, st = ([torch_ranks.load(d, name, k, r)
                          for r in range(world)]
                         for k in ("h", "sh", "stats"))
            slices = case["mesh"][0] if len(case["mesh"]) == 2 else 1
            per = world // slices          # ranks along the rows axis

            def whole(parts):
                return np.concatenate([np.concatenate(
                    parts[s * per:(s + 1) * per], axis=1)
                    for s in range(slices)], axis=0)
            out[name] = (whole(h), whole(sh), st)
    return out


def _unsharded(case):
    step = sharded.unsharded_field_step(
        octaves=case["octaves"], xyscale=case["xyscale"], seam=case["seam"])
    return [t.numpy() for t in step(*(torch.from_numpy(c)
                                      for c in case["points"]))]


@pytest.mark.parametrize("name", ["n1", "n2", "n4", "mesh22", "clamp31"])
def test_sharded_step_equals_unsharded(runs, name):
    world, case = CASES[name]
    h, sh, stats = runs[name]
    uh, ush, ust = _unsharded(case)
    np.testing.assert_array_equal(h, uh)
    # halo rows crossed ranks: the shade at strip seams must match too
    np.testing.assert_array_equal(sh, ush)
    assert len(stats) == world
    for st in stats:
        np.testing.assert_allclose(st, ust, rtol=1e-6)
    assert stats[0][0] == h.size


@pytest.mark.parametrize("name", ["fused2", "fused4"])
def test_sharded_fused_equals_plain_field(runs, name):
    h, sh, stats = runs[name]
    wh, ws = field_cuda.field_plain(FUSED_N, 6.371e6, octaves=6,
                                    device="cpu")
    np.testing.assert_array_equal(h, wh.numpy())
    np.testing.assert_array_equal(sh, ws.numpy())
    for st in stats:
        assert st[0] == 6 * FUSED_N * FUSED_N
        np.testing.assert_allclose(st[1], wh.sum(dtype=torch.float32),
                                   rtol=1e-6)


@pytest.mark.parametrize("seam", ["exchange", "clamp"])
def test_unsharded_step_within_field_bars_of_planet_tpu(seam):
    step = sharded.unsharded_field_step(octaves=4, xyscale=1000.0, seam=seam)
    h, sh, st = step(*(torch.from_numpy(c) for c in P32))
    pts = np.stack([facemesh.face_grid_points(f, 32, RADIUS)
                    for f in range(6)])
    comps = [w for k in range(3) for w in jdf.from_f64(pts[..., k])]
    jh, jsh_, jst = jsh.unsharded_field_step(
        octaves=4, xyscale=1000.0, seam=seam, use_pallas=False)(*comps)
    assert np.abs(h.numpy() - np.asarray(jh)).max() <= 0.2
    assert np.abs(sh.numpy() - np.asarray(jsh_)).max() <= 1e-3
    assert float(st[0]) == float(jst[0]) == 6 * 32 * 32
    np.testing.assert_allclose(float(st[1]), float(jst[1]), rtol=1e-5)


def test_seam_lines_equal_planet_tpus():
    ring = np.random.default_rng(9).standard_normal((6, 4, 24)).astype(
        np.float32)
    got = sharded._seam_lines(torch.from_numpy(ring))
    want = jsh._seam_lines(jnp.asarray(ring))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_exchange_fixes_seam_derivatives():
    """tests/test_sharded.py's check on the port: the exchange changes
    only face-edge texels (their central differences now read the
    neighbour face), and some of them."""
    pts = [torch.from_numpy(c) for c in P16]
    _, sh_ex, _ = sharded.unsharded_field_step(octaves=2, xyscale=500.0)(
        *pts)
    _, sh_cl, _ = sharded.unsharded_field_step(
        octaves=2, xyscale=500.0, seam="clamp")(*pts)
    sh_ex, sh_cl = sh_ex.numpy(), sh_cl.numpy()
    np.testing.assert_array_equal(sh_ex[:, 1:-1, 1:-1], sh_cl[:, 1:-1, 1:-1])
    edge = np.ones_like(sh_ex, bool)
    edge[:, 1:-1, 1:-1] = False
    assert (sh_ex[edge] != sh_cl[edge]).any()


def test_exchange_needs_square_faces():
    pts = [torch.from_numpy(np.ascontiguousarray(c[:, :8])) for c in P16]
    with pytest.raises(ValueError, match="square"):
        sharded.unsharded_field_step(octaves=2)(*pts)
    with pytest.raises(ValueError):
        sharded.unsharded_field_step(seam="wrap")


def test_meshes_need_the_world_they_name(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = sharded.make_mesh(1, device_type="cpu")
        assert mesh.mesh_dim_names == ("rows",) and mesh.size() == 1
        mesh2 = sharded.make_mesh_2d(1, 1, axis="quads", device_type="cpu")
        assert mesh2.mesh_dim_names == ("slice", "quads")
        with pytest.raises(ValueError, match="world"):
            sharded.make_mesh(2, device_type="cpu")
        with pytest.raises(ValueError, match="world"):
            sharded.make_mesh_2d(2, 2, device_type="cpu")
    finally:
        dist.destroy_process_group()
