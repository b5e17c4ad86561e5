"""Camera matrices and camera state (planet_tpu geom/camera.py, copied —
the parts the port calls — so the port imports nothing of planet_tpu).

Matrix convention: standard math row-major, out = M @ v (the reference
stores GL column-major arrays, math.h:161-283; values here are the same
matrices expressed as numpy (row, col)).

The camera keeps a float64 position (planet-scale coordinates need it —
reference Vec3d position, main.cpp:852-855) and float32 Euler angles; all
rendering is camera-relative so device code only ever sees f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def perspective_lh(proj_factor: float, aspect_ratio: float,
                   near: float, far: float) -> np.ndarray:
    """Left-handed infinite-far-friendly projection (reference
    RenderPlanet, main.cpp:629-639): w' = z, depth in [-1, 1]."""
    f, n = np.float64(far), np.float64(near)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = np.float32(proj_factor / aspect_ratio)
    m[1, 1] = np.float32(proj_factor)
    m[2, 2] = np.float32((f + n) / (f - n))
    m[3, 2] = np.float32(1.0)
    m[2, 3] = np.float32(-2.0 * f * n / (f - n))
    return m


def proj_factor_from_fovy(fovy_rad: float) -> float:
    """1 / tan(fovy/2) (reference InitCameraInfo, main.cpp:527-535)."""
    return float(1.0 / np.tan(0.5 * np.float32(fovy_rad)))


def view_from_rotation(rotation: np.ndarray) -> np.ndarray:
    """View matrix = inverse (transpose) of the camera's world rotation,
    translation omitted — positions are camera-relative (main.cpp:641-649).

    rotation: (3, 3) whose COLUMNS are the camera basis (right, up, forward)
    in world space.
    """
    v = np.zeros((4, 4), np.float32)
    v[:3, :3] = np.asarray(rotation, np.float32).T
    v[3, 3] = 1.0
    return v


def rot_x(rad: float) -> np.ndarray:
    s, c = np.sin(np.float32(rad)), np.cos(np.float32(rad))
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def rot_y(rad: float) -> np.ndarray:
    s, c = np.sin(np.float32(rad)), np.cos(np.float32(rad))
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def rot_z(rad: float) -> np.ndarray:
    s, c = np.sin(np.float32(rad)), np.cos(np.float32(rad))
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _normalize(v):
    return v / np.linalg.norm(v)


@dataclasses.dataclass
class Camera:
    """Free camera on the planet: f64 position + Euler angles
    (reference Camera struct, main.cpp:852-856)."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float64))
    angles: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))


def camera_rotation(cam: Camera) -> np.ndarray:
    """World rotation matrix (columns right/up/forward) for a camera on the
    sphere: tangent base frame from the planet normal, then Euler Y*X*Z
    (reference update loop, main.cpp:1039-1061)."""
    up = _normalize(cam.position.astype(np.float32))
    if 1.0 - np.dot(up, np.array([0, 1, 0], np.float32)) < 0.1:
        right = _normalize(np.cross(up, np.array([0, 0, 1], np.float32)))
    else:
        right = _normalize(np.cross(up, np.array([0, 1, 0], np.float32)))
    forward = _normalize(np.cross(right, up))
    base = np.stack([right, up, forward], axis=1)   # columns
    ax, ay, az = (float(a) for a in cam.angles)
    return (base @ rot_y(ay) @ rot_x(ax) @ rot_z(az)).astype(np.float32)


