"""The plain reference of one interactive LOD frame (reference/lod.py) at
any patch size.

The frozen vertex program divides the tangent-space normal's row length
by mesh.PATCH_QUADS, the 29 quads of the reference's 30-vertex patches
(frozen/tess/vertex.py `_assemble`; main.cpp's shader writes the 29 out),
whatever the grid it is given: the one number of the frozen copies that
is fixed at the 30-vertex patch. A patch of n vertices has n - 1 quads.
frame() here is reference/lod.py's with that number set to the
configuration's patch_quads while it runs, and put back after; at
30-vertex patches it is reference/lod.py's own. (reference/lod.py's
frame_rows tessellates nothing, and holds at any patch size.)
"""

from __future__ import annotations

import contextlib

from perfbench.reference import lod as ref_lod
from perfbench.reference.frozen.tess import mesh

PoolBook = ref_lod.PoolBook
engine_config = ref_lod.engine_config


@contextlib.contextmanager
def patch_quads(cfg):
    """The frozen vertex program's divisor set to cfg.patch_quads."""
    saved = mesh.PATCH_QUADS
    mesh.PATCH_QUADS = cfg.patch_quads
    try:
        yield
    finally:
        mesh.PATCH_QUADS = saved


def frame(cfg, *args, **kw) -> ref_lod.Frame:
    """reference/lod.frame at cfg's patch size."""
    with patch_quads(cfg):
        return ref_lod.frame(cfg, *args, **kw)

