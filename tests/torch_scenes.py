"""Seeded raster scenes shared by the port's CPU and GPU tests (numpy only,
so the GPU tests run where JAX is not installed)."""

import numpy as np

from planet_tpu_torch.geom import camera as cam_mod

F = np.float32

# taller than 16 aligned 8-row blocks, so the biggest triangles take the
# huge kernel
SCREEN = dict(width=200, height=160,
              sizes=((80, 1.5), (30, 8.0), (8, 40.0), (4, 200.0)))
# a view scene with near-plane straddlers and far-straddlers (seed 14)
VIEW = dict(seed=14, width=160, height=120, far=40.0)


def screen_scene(seed, width, height, sizes):
    """Random screen-space triangles (tests/test_raster_exact.rand_tris),
    each one cell of a (Q, 2, 2) patch batch with a degenerate T1."""
    rng = np.random.default_rng(seed)
    tris = []
    for n, span in sizes:
        for _ in range(n):
            base = rng.uniform([0, 0], [width, height])
            verts = []
            for _ in range(3):
                p = base + rng.uniform(-span, span, 2)
                nrm = rng.normal(size=3)
                verts.append((np.round(F(p) * F(16.0)) * F(1.0 / 16.0),
                              F(rng.uniform(-0.9, 0.9)),
                              F(rng.uniform(0.1, 2.0)),
                              (nrm / np.linalg.norm(nrm)).astype(F)))
            tris.append(verts)
    q = len(tris)
    clip = np.zeros((q, 2, 2, 4), F)
    normal = np.zeros((q, 2, 2, 3), F)
    for i, t in enumerate(tris):
        slots = {(0, 0): t[0], (1, 0): t[1], (0, 1): t[2], (1, 1): t[1]}
        for (r, c), (xy, z, iw, nrm) in slots.items():
            w = 1.0 / iw
            ndc_x = (xy[0] / width - 0.5) * 2.0
            ndc_y = (0.5 - xy[1] / height) * 2.0
            clip[i, r, c] = [ndc_x * w, ndc_y * w, z * w, w]
            normal[i, r, c] = nrm
    return clip, normal, np.ones((q, 2, 2), bool)


def view_scene(seed, width, height, far):
    """Random view-space 3x3 patches around the camera, projected with the
    engine's perspective: cells cross the near plane (straddlers) and the
    far plane (far-straddlers); sizes range from sub-pixel to screen-wide."""
    rng = np.random.default_rng(seed)
    proj = cam_mod.perspective_lh(
        cam_mod.proj_factor_from_fovy(np.deg2rad(50.0)), width / height,
        1.0, far)
    q = 48
    centre = np.stack([rng.uniform(-8, 8, q), rng.uniform(-6, 6, q),
                       rng.uniform(-2.0, far * 1.1, q)], axis=1)
    step = rng.uniform(0.05, 6.0, (q, 1, 1, 1))
    gy, gx = np.mgrid[-1:2, -1:2].astype(np.float64)
    tilt = rng.normal(size=(q, 3))
    pts = centre[:, None, None, :] + step * (
        gx[None, :, :, None] * np.array([1.0, 0.0, 0.0])
        + gy[None, :, :, None] * np.array([0.0, 0.3, 1.0])
        + (gx * gy)[None, :, :, None] * tilt[:, None, None, :] * 0.3)
    hom = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], axis=-1)
    clip = np.einsum("ij,qabj->qabi", proj.astype(np.float64), hom).astype(F)
    nrm = rng.normal(size=(q, 3, 3, 3))
    normal = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(F)
    valid = rng.uniform(size=(q, 3, 3)) > 0.05
    return clip, normal, valid
