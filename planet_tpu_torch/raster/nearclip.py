"""Near-plane triangle clipping for the exact-coverage raster (planet_tpu
raster/nearclip.py, ported op for op).

With the engine's projection (w' = z_view) the near plane is the clip-space
half-space f = z + w >= 0. A triangle is a STRADDLER iff its three vertices
are valid, one has w <= 1e-9 (projection breaks), one has f > 0 (something
is visible), it is front-facing by det3(x, y, w) < 0, and no lateral
frustum plane has all three vertices outside. Straddlers are
Sutherland-Hodgman clipped against f >= 0 into 1 or 2 triangles (winding
preserved, clip positions and normals interpolated linearly in clip space
— GL's rule), projected with the raster's own setup, and drawn by the
huge-triangle kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from planet_tpu_torch.raster import coverage as cov


def straddle_from_verts(v3, wl3, f3, x3, y3, w3):
    """The per-vertex straddle predicate. Inputs are 3-tuples of
    same-shaped per-vertex tensors: valid, w <= _W_MIN, f = z + w > 0,
    clip x, clip y, clip w."""
    v0, v1, v2 = v3
    wl0, wl1, wl2 = wl3
    f0, f1, f2 = f3
    x0, x1, x2 = x3
    y0, y1, y2 = y3
    w0, w1, w2 = w3
    det3 = (x0 * (y1 * w2 - y2 * w1)
            - y0 * (x1 * w2 - x2 * w1)
            + w0 * (x1 * y2 - x2 * y1))
    all_out = (((w0 - x0 < 0.0) & (w1 - x1 < 0.0) & (w2 - x2 < 0.0))
               | ((w0 + x0 < 0.0) & (w1 + x1 < 0.0) & (w2 + x2 < 0.0))
               | ((w0 - y0 < 0.0) & (w1 - y1 < 0.0) & (w2 - y2 < 0.0))
               | ((w0 + y0 < 0.0) & (w1 + y1 < 0.0) & (w2 + y2 < 0.0)))
    return ((v0 & v1 & v2) & (wl0 | wl1 | wl2) & (f0 | f1 | f2)
            & (det3 < 0.0) & ~all_out)


def straddle_mask_t(clip, valid, cell_mask=None):
    """(N,) bool straddler mask in coverage.setup_t's candidate order."""
    q, g = clip.shape[0], clip.shape[1]
    w4 = clip[..., 3]
    f4 = clip[..., 2] + w4
    m = straddle_from_verts(cov.tri3(valid, q, g),
                            cov.tri3(w4 <= cov._W_MIN, q, g),
                            cov.tri3(f4 > 0.0, q, g),
                            cov.tri3(clip[..., 0], q, g),
                            cov.tri3(clip[..., 1], q, g),
                            cov.tri3(w4, q, g))
    return m & cov.cell_ok_mask(q, g, cell_mask, clip.device)


def gather_tri_verts_t(clip, normal, idx):
    """Straddler triangle vertices from the patch grids.

    idx: (K,) int64 candidate indices in setup_t's order (>= N marks a dead
    lane). Returns (vc (K, 3, 4), vn (K, 3, 3), ok (K,) bool)."""
    q, g = clip.shape[0], clip.shape[1]
    ncell = q * g * g
    n = 2 * ncell
    ok = idx < n
    i = torch.clamp_max(idx, n - 1)
    p = i // ncell
    rem = i % ncell
    qq = rem // (g * g)
    j = rem % (g * g)
    lim = g * g - 1
    a00 = j
    a10 = torch.clamp_max(j + g, lim)
    a01 = torch.clamp_max(j + 1, lim)
    a11 = torch.clamp_max(j + g + 1, lim)
    v0 = torch.where(p == 0, a00, a01)
    v1 = a10
    v2 = torch.where(p == 0, a01, a11)
    flat_c = clip.reshape(q, g * g, 4)
    flat_n = normal.reshape(q, g * g, 3)
    vc = torch.stack([flat_c[qq, v0], flat_c[qq, v1], flat_c[qq, v2]], dim=1)
    vn = torch.stack([flat_n[qq, v0], flat_n[qq, v1], flat_n[qq, v2]], dim=1)
    return vc.to(torch.float32), vn.to(torch.float32), ok


def clip_expand(vc, vn, live):
    """Sutherland-Hodgman clip against f = z + w >= 0.

    vc (K, 3, 4), vn (K, 3, 3), live (K,) -> (cvc (2K, 3, 4),
    cvn (2K, 3, 3), clive (2K,)): triangle A in [:K], triangle B (the
    second fan triangle of a 4-gon) in [K:]. Winding is preserved."""
    k = vc.shape[0]
    f = vc[..., 2] + vc[..., 3]                       # (K, 3)
    inside = f > 0.0
    cnt = inside.to(torch.int32).sum(dim=1)

    def first_true(m):
        return torch.where(m[:, 0], 0, torch.where(m[:, 1], 1, 2))

    rot = torch.where(cnt == 1, first_true(inside), first_true(~inside))
    rows = torch.arange(k, device=vc.device)

    def at(a, i):
        return a[rows, i]

    i0, i1, i2 = rot, (rot + 1) % 3, (rot + 2) % 3
    c0, c1, c2 = at(vc, i0), at(vc, i1), at(vc, i2)
    n0, n1, n2 = at(vn, i0), at(vn, i1), at(vn, i2)
    f0, f1, f2 = at(f, i0), at(f, i1), at(f, i2)

    usable = live & ((cnt == 1) | (cnt == 2))
    one, zero = torch.ones_like(f0), torch.zeros_like(f0)
    t01 = torch.where(usable, f0 / torch.where(usable, f0 - f1, one), zero)
    t20 = torch.where(usable, f2 / torch.where(usable, f2 - f0, one), zero)
    i01c = c0 + (c1 - c0) * t01[:, None]
    i01n = n0 + (n1 - n0) * t01[:, None]
    i20c = c2 + (c0 - c2) * t20[:, None]
    i20n = n2 + (n0 - n2) * t20[:, None]

    sel = (cnt == 1)[:, None]
    a0c, a0n = torch.where(sel, c0, i01c), torch.where(sel, n0, i01n)
    a1c, a1n = torch.where(sel, i01c, c1), torch.where(sel, i01n, n1)
    a2c, a2n = torch.where(sel, i20c, c2), torch.where(sel, i20n, n2)
    cvc = torch.cat([torch.stack([a0c, a1c, a2c], dim=1),
                     torch.stack([i01c, c2, i20c], dim=1)])
    cvn = torch.cat([torch.stack([a0n, a1n, a2n], dim=1),
                     torch.stack([i01n, n2, i20n], dim=1)])
    clive = torch.cat([usable, live & (cnt == 2)])
    return cvc, cvn, clive


def setup_tris(vc, vn, live, width: int, height: int,
               far_w=None) -> cov.Tris:
    """Project clipped triangles with the raster's setup op sequence."""
    w = vc[..., 3]                                   # (K, 3)
    okw, inv_w, sx, sy = cov.project(vc, live[:, None], width, height)
    z = vc[..., 2] * inv_w
    niw = vn * inv_w[..., None]

    tri_ok = live & okw.all(dim=1)
    area2 = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
             - (sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0])) \
        * cov.FRONT_SIGN
    front = area2 > 0.0
    px0, py0, px1, py1 = cov.bbox(sx[:, 0], sx[:, 1], sx[:, 2],
                                  sy[:, 0], sy[:, 1], sy[:, 2], width, height)
    nonempty = (px0 <= px1) & (py0 <= py1)

    out_live = tri_ok & front & nonempty
    one = torch.ones_like(area2)
    inv_area = torch.where(out_live, 1.0 / torch.where(out_live, area2, one),
                           torch.zeros_like(area2))
    if far_w is not None:
        far = (w > float(np.float32(far_w))).any(dim=1)
        ilim = torch.where(
            far, torch.full_like(area2, float(np.float32(1.0 / far_w))),
            torch.full_like(area2, -1.0))
    else:
        ilim = torch.full_like(area2, -1.0)
    return cov.Tris(x=sx, y=sy, z=z, iw=inv_w, niw=niw, inv_area=inv_area,
                    px0=px0, py0=py0, px1=px1, py1=py1, live=out_live,
                    ilim=ilim)


def records_from_tris(t: cov.Tris):
    """(K,) Tris -> (K, 32) f32 row records in setup_t's row layout."""
    ox = t.px0.to(torch.float32) + 0.5
    oy = t.py0.to(torch.float32) + 0.5
    x, y = t.x, t.y
    dx0, dy0, c0, b0 = cov.edge_consts(x[:, 1], y[:, 1], x[:, 2], y[:, 2],
                                       ox, oy)
    dx1, dy1, c1, b1 = cov.edge_consts(x[:, 2], y[:, 2], x[:, 0], y[:, 0],
                                       ox, oy)
    dx2, dy2, c2, b2 = cov.edge_consts(x[:, 0], y[:, 0], x[:, 1], y[:, 1],
                                       ox, oy)
    ia = t.inv_area
    rows = [dx0, dy0, c0, dx1, dy1, c1, dx2, dy2, c2,
            t.z[:, 0] * ia, t.z[:, 1] * ia, t.z[:, 2] * ia,
            t.iw[:, 0] * ia, t.iw[:, 1] * ia, t.iw[:, 2] * ia,
            t.niw[:, 0, 0] * ia, t.niw[:, 0, 1] * ia, t.niw[:, 0, 2] * ia,
            t.niw[:, 1, 0] * ia, t.niw[:, 1, 1] * ia, t.niw[:, 1, 2] * ia,
            t.niw[:, 2, 0] * ia, t.niw[:, 2, 1] * ia, t.niw[:, 2, 2] * ia,
            t.px0.to(torch.float32), t.py0.to(torch.float32),
            t.px1.to(torch.float32), t.py1.to(torch.float32),
            t.live.to(torch.float32) * t.ilim,
            b0, b1, b2]
    return torch.stack([r.to(torch.float32) for r in rows], dim=1).contiguous()


def clipped_tris(clip, normal, idx, width: int, height: int,
                 far_w=None) -> cov.Tris:
    """Straddler indices -> projected clipped-triangle Tris (2K rows)."""
    vc, vn, ok = gather_tri_verts_t(clip, normal, idx)
    cvc, cvn, clive = clip_expand(vc, vn, ok)
    return setup_tris(cvc, cvn, clive, width, height, far_w=far_w)
