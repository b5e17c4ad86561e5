"""The traffic generators: the same seed makes the same inputs, another
seed others; the flight is tools/bench_moving.py's orbit; the
look-around's fixed point and turning yaw; each regen its own radius."""

import numpy as np
import pytest

from perfbench.harness import traffic

FLIGHT = {"generator": "camera_path", "warmup_frames": 96,
          "orbit": {"latitude_sin": 0.6, "theta_step": 0.001},
          "altitude": {"high": 20000.0, "low": 3000.0, "period": 96},
          "offset_period": 6283, "pitch": 0.35, "yaw_step": 0.0,
          "yaw_follows_orbit": True}
LOOK = {"generator": "camera_path", "warmup_frames": 96,
        "orbit": {"latitude_sin": 0.6, "theta_step": 0.0},
        "altitude": {"high": 20000.0, "low": 20000.0, "period": 96},
        "direction": [0.2, 0.5, -0.8], "pitch": 0.35, "yaw_step": 0.026,
        "random_yaw": True}
R = 6371000.0
SEEDS = (0, 1, 2**31 + 5, 2**40 + 3)


@pytest.mark.parametrize("params", [FLIGHT, LOOK], ids=["flight", "look"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_path(params, seed):
    a = traffic.make(params, seed, R)
    b = traffic.make(params, seed, R)
    for k in (0, 1, 95, 1000, 123456):
        pa, aa = a.at(k)
        pb, ab = b.at(k)
        assert np.array_equal(pa, pb) and np.array_equal(aa, ab)


def test_seeds_start_the_same_path_elsewhere():
    """Every seed flies the same path from another frame of its lap (the
    flight) or turns over the same point from another yaw (the
    look-around)."""
    paths = [traffic.make(FLIGHT, s, R) for s in SEEDS]
    starts = {p._k0 for p in paths}
    assert len(starts) > 1 and all(0 <= k0 < 6283 for k0 in starts)
    ref = traffic.make(FLIGHT, SEEDS[0], R)
    ref._k0 = 0
    for p in paths:
        for k in (0, 7, 200):
            pos, ang = p.at(k)
            rpos, rang = ref.at(p._k0 + k)
            assert np.allclose(pos, rpos, rtol=0, atol=1e-6)
            assert np.allclose(ang, rang, rtol=0, atol=1e-6)
    looks = [traffic.make(LOOK, s, R) for s in SEEDS]
    assert all(np.array_equal(lk.at(0)[0], looks[0].at(0)[0])
               for lk in looks)
    assert len({float(lk.at(0)[1][1]) for lk in looks}) == len(looks)


def test_flight_altitude_wave_and_orbit():
    """tools/bench_moving.py's camera_at: cdir (0.8 cos t, 0.6, 0.8 sin t),
    t 1 mrad a frame, angles (0.35, t, 0); its descent 20 km -> 3 km over
    48 frames, and the way back up."""
    p = traffic.make(FLIGHT, 7, R)
    p._k0 = 0
    for k in (0, 1, 48, 1000, 6283):
        pos, ang = p.at(k)
        t = 0.001 * k
        alt = np.linalg.norm(pos) - R
        cdir = np.array([np.cos(t) * 0.8, 0.6, np.sin(t) * 0.8])
        assert np.allclose(pos / np.linalg.norm(pos), cdir, rtol=0,
                           atol=1e-12)
        assert np.allclose(ang, np.array([0.35, t, 0.0], np.float32))
    alts = [np.linalg.norm(p.at(k)[0]) - R for k in range(97)]
    assert np.allclose(alts[:48], np.linspace(20000.0, 3000.0, 49)[:48],
                       rtol=0, atol=1e-6)
    assert alts[48] == pytest.approx(3000.0, abs=1e-6)
    assert alts[96] == pytest.approx(20000.0, abs=1e-6)
    assert all(alts[48 + k] < alts[49 + k] for k in range(48))
    # 0.8 mrad of arc a frame, ~5.1 km on the ground
    d0, d1 = (p.at(k)[0] / np.linalg.norm(p.at(k)[0]) for k in (0, 1))
    assert np.arccos(np.clip(d0 @ d1, -1, 1)) == pytest.approx(0.0008,
                                                               rel=1e-3)


def test_lookaround_holds_its_point_and_turns():
    p = traffic.make(LOOK, 11, R)
    pos0 = p.at(0)[0]
    for k in (1, 50, 5000):
        pos, ang = p.at(k)
        assert np.array_equal(pos, pos0)
        assert ang[1] - p.at(0)[1][1] == pytest.approx(0.026 * k, rel=1e-5)
    assert np.linalg.norm(pos0) == pytest.approx(R + 20000.0)


def test_lookaround_is_the_bench_scene():
    pos, _ = traffic.make(LOOK, 5, R).at(0)
    d = np.array([0.2, 0.5, -0.8])
    assert np.allclose(pos, d / np.linalg.norm(d) * (R + 20000.0))


def test_each_regen_its_own_radius():
    params = {"generator": "field_regen", "warmup_regens": 3,
              "radius_jitter": 0.1}
    for seed in SEEDS:
        g = traffic.make(params, seed, R)
        radii = [g.radius_at(k) for k in range(500)]
        assert len(set(radii)) == len(radii)
        assert all(0.9 * R <= r <= 1.1 * R for r in radii)
        assert radii == [traffic.make(params, seed, R).radius_at(k)
                         for k in range(500)]
