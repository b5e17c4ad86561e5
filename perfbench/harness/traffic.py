"""The general generators that read a traffic mix's parameters
(perfbench/traffic/<mix>.json, chosen by its "generator" key). The program
receives only what they make; the same seed makes the same inputs.

camera_path: frame k's camera, a point above a sphere of the
configuration's radius. Its direction is R (cos(lat) cos(theta_j),
sin(lat), cos(lat) sin(theta_j)) with j = k0 + k, sin(lat) =
orbit.latitude_sin and theta_j = j * orbit.theta_step (tools/
bench_moving.py's circle of latitude); R turns the path's first point onto
`direction` where one is given. The altitude is a triangle wave from
altitude.high down to altitude.low and back over altitude.period frames.
The Euler angles are [pitch, yaw_0 + k * yaw_step (+ theta_j with
"yaw_follows_orbit"), 0]. The seed draws only where the path starts: the
offset k0 in [0, offset_period) (a lap of the orbit) and, with
"random_yaw", yaw_0; so every seed flies the same path from another
point.

field_regen: the k-th regen's planet radius, the configuration's radius
times 1 + U(-radius_jitter, radius_jitter), drawn from the seed and k.
"""

from __future__ import annotations

import numpy as np


def _turn_onto(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The rotation about a x b that takes unit vector a to unit vector b."""
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + k + k @ k / (1.0 + c)


class CameraPath:
    def __init__(self, params: dict, seed: int, radius: float):
        self.p = params
        self.radius = float(radius)
        rng = np.random.default_rng(int(seed) & ((1 << 64) - 1))
        s = float(params["orbit"]["latitude_sin"])
        self._lat = (np.sqrt(1.0 - s * s), s)
        self._k0 = int(rng.integers(int(params.get("offset_period", 1))))
        self._yaw0 = (float(rng.uniform(0.0, 2 * np.pi))
                      if params.get("random_yaw") else 0.0)
        self._rot = np.eye(3)
        if "direction" in params:
            d = np.asarray(params["direction"], np.float64)
            self._rot = _turn_onto(self._base(0), d / np.linalg.norm(d))

    def _theta(self, j):
        return j * float(self.p["orbit"]["theta_step"])

    def _base(self, j):
        c, s = self._lat
        t = self._theta(np.asarray(j, np.float64))
        return np.stack([c * np.cos(t), np.full_like(t, s), c * np.sin(t)],
                        axis=-1)

    def _altitude(self, j):
        a = self.p["altitude"]
        hi, lo, period = float(a["high"]), float(a["low"]), int(a["period"])
        phase = np.asarray(j) % period
        return hi - (hi - lo) * np.minimum(phase, period - phase) \
            / (period / 2)

    def frames(self, k0: int, n: int):
        """(positions (n, 3) f64, angles (n, 3) f32) of frames k0 .. k0 +
        n - 1, all at once (a run makes its path before its window)."""
        k = np.arange(int(k0), int(k0) + int(n))
        j = self._k0 + k
        b, r = self._base(j), self._rot
        # R b written out, so that every frame rounds alike however many
        # are made at once
        d = np.stack([(r[i, 0] * b[:, 0] + r[i, 1] * b[:, 1])
                      + r[i, 2] * b[:, 2] for i in range(3)], axis=-1)
        pos = d * (self.radius + self._altitude(j))[:, None]
        yaw = self._yaw0 + k * float(self.p.get("yaw_step", 0.0))
        if self.p.get("yaw_follows_orbit"):
            yaw = yaw + self._theta(j)
        ang = np.stack([np.full(n, self.p["pitch"]), yaw, np.zeros(n)],
                       axis=-1).astype(np.float32)
        return pos, ang

    def at(self, k: int):
        """(position (3,) f64, angles (3,) f32) of frame k."""
        pos, ang = self.frames(k, 1)
        return pos[0], ang[0]


class FieldRegen:
    def __init__(self, params: dict, seed: int, radius: float):
        self.jitter = float(params["radius_jitter"])
        self.radius = float(radius)
        self.seed = int(seed) & ((1 << 64) - 1)

    def radius_at(self, k: int) -> float:
        rng = np.random.default_rng([self.seed, int(k)])
        return self.radius * (1.0 + float(rng.uniform(-self.jitter,
                                                      self.jitter)))


GENERATORS = {"camera_path": CameraPath, "field_regen": FieldRegen}


def make(params: dict, seed: int, radius: float):
    return GENERATORS[params["generator"]](params, seed, radius)
