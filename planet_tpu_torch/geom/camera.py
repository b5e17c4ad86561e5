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


def ortho_lh(left: float, right: float, bottom: float, top: float,
             near: float, far: float) -> np.ndarray:
    """Left-handed orthographic projection mapping near -> -1, far -> 1
    (reference Mat4OrthoLH, math.h:270-283). Library-surface parity: the
    planet frame path is perspective-only, like the reference (which also
    never calls its ortho constructor); kept for embedding UIs."""
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = np.float32(2.0 / (right - left))
    m[1, 1] = np.float32(2.0 / (top - bottom))
    m[2, 2] = np.float32(2.0 / (far - near))
    m[0, 3] = np.float32((right + left) / (left - right))
    m[1, 3] = np.float32((top + bottom) / (bottom - top))
    m[2, 3] = np.float32((far + near) / (near - far))
    m[3, 3] = np.float32(1.0)
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


def _sin_cos(rad: float):
    """sin and cos of the float32 angle, as Python floats (float32 values,
    so exact)."""
    r = np.float32(rad)
    return float(np.sin(r)), float(np.cos(r))


def _matrix(*entries) -> np.ndarray:
    """A (3, 3) float32 matrix from its nine float32-valued entries, row by
    row (one conversion of Python floats: no per-scalar dtype discovery)."""
    return np.array(entries, np.float32).reshape(3, 3)


def rot_x(rad: float) -> np.ndarray:
    s, c = _sin_cos(rad)
    return _matrix(1.0, 0.0, 0.0, 0.0, c, -s, 0.0, s, c)


def rot_y(rad: float) -> np.ndarray:
    s, c = _sin_cos(rad)
    return _matrix(c, 0.0, s, 0.0, 1.0, 0.0, -s, 0.0, c)


def rot_z(rad: float) -> np.ndarray:
    s, c = _sin_cos(rad)
    return _matrix(c, -s, 0.0, s, c, 0.0, 0.0, 0.0, 1.0)


def _normalize(v):
    return v / np.linalg.norm(v)


_Y = np.array([0, 1, 0], np.float32)
_Z = np.array([0, 0, 1], np.float32)
# np.cross's operands for (3,) vectors: a[_CROSS_A] * b[_CROSS_B] holds
# a1 b2, a2 b0, a0 b1 in row 0 and a2 b1, a0 b2, a1 b0 in row 1
_CROSS_A = np.array([[1, 2, 0], [2, 0, 1]])
_CROSS_B = np.array([[2, 0, 1], [1, 2, 0]])


def _cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """np.cross(a, b) of two (3,) float32 vectors, bit for bit: the same
    float32 products (those by b's zeros too, so that signed zeros match)
    and differences, in numpy's order, without its moveaxis and broadcast
    set-up."""
    p = a[_CROSS_A] * b[_CROSS_B]
    return p[0] - p[1]


@dataclasses.dataclass
class Camera:
    """Free camera on the planet: f64 position + Euler angles
    (reference Camera struct, main.cpp:852-856)."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float64))
    angles: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))

    def copy(self) -> "Camera":
        return Camera(self.position.copy(), self.angles.copy())


def camera_rotation(cam: Camera) -> np.ndarray:
    """World rotation matrix (columns right/up/forward) for a camera on the
    sphere: tangent base frame from the planet normal, then Euler Y*X*Z
    (reference update loop, main.cpp:1039-1061)."""
    up = _normalize(cam.position.astype(np.float32))
    if 1.0 - np.dot(up, _Y) < 0.1:
        right = _normalize(_cross(up, _Z))
    else:
        right = _normalize(_cross(up, _Y))
    forward = _normalize(_cross(right, up))
    base = np.empty((3, 3), np.float32)     # columns; C order, as np.stack
    base[:, 0], base[:, 1], base[:, 2] = right, up, forward
    ax, ay, az = np.asarray(cam.angles).tolist()
    return base @ rot_y(ay) @ rot_x(ax) @ rot_z(az)


def update_camera(cam: Camera, move: np.ndarray, look: np.ndarray,
                  move_speed: float, look_speed: float, dt: float) -> np.ndarray:
    """Advance camera state in place; returns the world rotation used.

    move: (3,) in camera space (x=strafe, z=forward); look: (3,) Euler rate
    multipliers — semantics of the reference's WASD/arrow handling
    (main.cpp:1039-1065).
    """
    cam.angles = (cam.angles + np.asarray(look, np.float32)
                  * np.float32(look_speed) * np.float32(dt))
    rot = camera_rotation(cam)
    delta = (rot[:, 0] * move[0] + rot[:, 1] * move[1] + rot[:, 2] * move[2])
    cam.position = cam.position + delta.astype(np.float64) * (move_speed * dt)
    return rot


def speed_for_digit(digit: int) -> float:
    """Move speed for number keys 1-8: 10^digit m/s (reference
    main.cpp:947-954)."""
    return float(10.0 ** int(digit))
