"""Multi-card sharded heightfield step (planet_tpu parallel/sharded.py,
ported to torch.distributed; BASELINE config 5's field path).

One process per rank and one device per rank, in a process group the
caller initialised (torchrun, or init_process_group): NCCL on GPUs, gloo
on the CPU. The meshes are torch DeviceMeshes over that group; a mesh
axis is a process group (`mesh.get_group(name)`), as JAX's mesh axis is a
set of devices.

Sharding layout: the (6, H, W) cube-sphere heightfield is sharded by ROWS
over one mesh axis — each rank owns a (6, H/n, W) strip of every face,
and with a leading "slice" axis the faces are sharded over slices too.
Collectives (planet_tpu's, with their torch counterparts):

* halo rows (JAX `ppermute`): one boundary row each way between row
  neighbours, `batch_isend_irecv` over the rows group, so central
  differences at strip seams see the neighbour's heights (the reference's
  overscan border, main.cpp:135-148);
* the face-edge ring (JAX `psum`): the 6 x 4 boundary lines assembled from
  each rank's disjoint contributions by `all_reduce(SUM)` over the rows
  group, then the slice group. Each entry has one non-zero contribution,
  so the sum is exact in any order and the ring bitwise. Every rank then
  takes its face-seam halos from the neighbour face's texels through the
  static cube adjacency (facemesh.edge_adjacency);
* frame statistics (JAX `psum`): texel count and height checksum, f32
  sums whose order differs from one device's (hold them at rtol 1e-6).

seam="exchange" (default) performs the face-seam exchange; seam="clamp"
keeps CLAMP_TO_EDGE (one-sided derivatives at face edges) for comparison
and for non-square fields.

make_mesh_2d's outer "slice" axis plays planet_tpu's TPU slice (DCN
between slices, ICI inside one): torchrun numbers ranks node by node, so
each inner row of ranks lies on one node, its halo rows on NVLink, and
only the ring and the stats cross the network.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from planet_tpu_torch.models import heightfield
from planet_tpu_torch.ops.kernels import field_cuda
from planet_tpu_torch.parallel import facemesh
from planet_tpu_torch.raster import shade as shade_mod

SEAMS = ("exchange", "clamp")


def _seam_lines(ring):
    """(6, 4, H) global edge ring -> per-face halo lines, each indexed along
    the OWNING face's edge direction (edge 0/2: u increasing = columns;
    edge 1/3: v increasing = rows): (top, bot, left, right), each (6, H).

    The halo texel across a face seam is the neighbour face's boundary
    texel (its first interior line), so both faces' central differences at
    the seam read the same height pair."""
    nbr_f, nbr_e, rev = facemesh.edge_adjacency()
    out = []
    for e in (facemesh.EDGE_V0, facemesh.EDGE_V1,
              facemesh.EDGE_U0, facemesh.EDGE_U1):
        lines = []
        for f in range(6):
            line = ring[int(nbr_f[f, e]), int(nbr_e[f, e])]
            lines.append(line.flip(0) if rev[f, e] else line)
        out.append(torch.stack(lines))
    return tuple(out)                        # top, bot, left, right


def make_mesh(n_devices: Optional[int] = None, axis: str = "rows", *,
              device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh named `axis` over the initialised world (one rank a
    device). n_devices, if given, must be the world size."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} needs a world of as many "
                         f"ranks, have {world}")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def make_mesh_2d(n_slices: int, rows_per_slice: int, axis: str = "rows", *,
                 device_type: str = "cuda") -> DeviceMesh:
    """(n_slices, rows_per_slice) mesh with axes ("slice", axis) over the
    initialised world, rank r at (r // rows_per_slice, r % rows_per_slice):
    each inner row holds consecutive ranks, which torchrun puts on one node
    (planet_tpu groups by `slice_index` for the same reason)."""
    world = dist.get_world_size()
    if n_slices * rows_per_slice != world:
        raise ValueError(f"a {n_slices} x {rows_per_slice} mesh needs a "
                         f"world of {n_slices * rows_per_slice} ranks, have "
                         f"{world}")
    return init_device_mesh(device_type, (n_slices, rows_per_slice),
                            mesh_dim_names=("slice", axis))


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: the current CUDA device on a CUDA mesh (set
    it, torch.cuda.set_device, before making the mesh)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def _reduce_groups(mesh: DeviceMesh, axis: str):
    """The groups a global sum runs over: the inner axis, then the slices."""
    groups = [mesh.get_group(axis)]
    if "slice" in mesh.mesh_dim_names and _axis_size(mesh, "slice") > 1:
        groups.append(mesh.get_group("slice"))
    return groups


def _all_reduce(t, groups):
    """Sum t in place over each group in turn."""
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def _stats(h):
    """(2,) f32: the texel count and the height checksum (the reference's
    title-bar stats, main.cpp:1030-1037)."""
    return torch.stack([h.new_full((), float(h.numel())),
                        h.sum(dtype=torch.float32)])


def _row_halos(h, group, idx: int, n: int):
    """(from_above, from_below): the last row of rank idx - 1's strip and
    the first row of rank idx + 1's (None where there is no neighbour).
    gloo sends and receives host memory only, so over gloo a strip on a
    card sends and receives its rows through the host."""
    if n == 1:
        return None, None
    via = "cpu" if dist.get_backend(group) == "gloo" else h.device
    ops, above, below = [], None, None
    row = (h.shape[0], 1, h.shape[2])   # contiguous: NCCL receives into it
    if idx > 0:
        above = h.new_empty(row, device=via)
        ops += [dist.P2POp(dist.isend, h[:, :1].contiguous().to(via),
                           dist.get_global_rank(group, idx - 1), group),
                dist.P2POp(dist.irecv, above,
                           dist.get_global_rank(group, idx - 1), group)]
    if idx < n - 1:
        below = h.new_empty(row, device=via)
        ops += [dist.P2POp(dist.isend, h[:, -1:].contiguous().to(via),
                           dist.get_global_rank(group, idx + 1), group),
                dist.P2POp(dist.irecv, below,
                           dist.get_global_rank(group, idx + 1), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(None if t is None else t.to(h.device)
                 for t in (above, below))


def sharded_field_step(mesh: DeviceMesh, *, octaves: int = 6,
                       kind: str = "ridged", xyscale: float = 1000.0,
                       axis: str = "rows", seam: str = "exchange"):
    """Returns this rank's step: its (6/S, H/n, W) strips of the six DF
    point components (px_hi, px_lo, py_hi, py_lo, pz_hi, pz_lo; S slices,
    n ranks on `axis`) -> (heights, shade (6/S, H/n, W), stats (2,):
    texels and height checksum over the whole mesh). Heights come from
    heightfield.heights_df: K4 for CUDA tensors, its plain version on the
    CPU. seam: "exchange" routes face-seam halos from the neighbour face
    (needs H == W); "clamp" keeps CLAMP_TO_EDGE."""
    if seam not in SEAMS:
        raise ValueError(seam)
    n = _axis_size(mesh, axis)
    idx = mesh.get_local_rank(axis)
    rows_group = mesh.get_group(axis)
    groups = _reduce_groups(mesh, axis)
    n_slices = (_axis_size(mesh, "slice")
                if "slice" in mesh.mesh_dim_names else 1)
    if 6 % n_slices:
        raise ValueError(f"slice axis must divide 6 faces: {n_slices}")
    fl = 6 // n_slices                             # local faces
    f0 = mesh.get_local_rank("slice") * fl if n_slices > 1 else 0

    def step(px_hi, px_lo, py_hi, py_lo, pz_hi, pz_lo):
        h = heightfield.heights_df((px_hi, px_lo), (py_hi, py_lo),
                                   (pz_hi, pz_lo), kind=kind,
                                   octaves=octaves)   # (fl, hl, w)
        if h.shape[0] != fl:
            raise ValueError(f"expected {fl} faces a rank, got {h.shape[0]}")
        hl, w = h.shape[1], h.shape[2]
        hg = hl * n                                   # global rows
        above, below = _row_halos(h, rows_group, idx, n)
        if seam == "exchange":
            if hg != w:
                raise ValueError("seam='exchange' needs square faces")
            # the global face-edge ring from disjoint contributions
            r0 = idx * hl
            ring = h.new_zeros((6, 4, hg))
            faces = slice(f0, f0 + fl)
            ring[faces, 1, r0:r0 + hl] = h[:, :, -1]
            ring[faces, 3, r0:r0 + hl] = h[:, :, 0]
            if idx == 0:
                ring[faces, 0] = h[:, 0]
            if idx == n - 1:
                ring[faces, 2] = h[:, -1]
            _all_reduce(ring, groups)
            top, bot, left, right = (a[faces] for a in _seam_lines(ring))
            top_halo = top[:, None] if idx == 0 else above
            bot_halo = bot[:, None] if idx == n - 1 else below
            h_rows = torch.cat([top_halo, h, bot_halo], dim=1)
            lcol, rcol = left[:, r0:r0 + hl], right[:, r0:r0 + hl]
            # halo columns padded to the extended rows (the corner texels
            # are never read by the central difference; clamp them)
            lc = torch.cat([lcol[:, :1], lcol, lcol[:, -1:]], dim=1)
            rc = torch.cat([rcol[:, :1], rcol, rcol[:, -1:]], dim=1)
            h_pad = torch.cat([lc[:, :, None], h_rows, rc[:, :, None]],
                              dim=2)
        else:
            top_halo = h[:, :1] if idx == 0 else above
            bot_halo = h[:, -1:] if idx == n - 1 else below
            h_rows = torch.cat([top_halo, h, bot_halo], dim=1)
            h_pad = torch.cat([h_rows[:, :, :1], h_rows, h_rows[:, :, -1:]],
                              dim=2)
        normal = heightfield.normals_from_heights(h_pad, xyscale)
        sh = shade_mod.lambert(normal)
        return h, sh, _all_reduce(_stats(h), groups)

    return step


def sharded_field_step_fused(mesh: DeviceMesh, n: int, radius: float, *,
                             octaves: int = 6, kind: str = "ridged",
                             axis: str = "rows"):
    """Config 5's fast path: returns fn() -> (heights, shade (6, n/N, n)
    for this rank's rows [rank n/N, (rank + 1) n/N), stats (2,) over the
    mesh). Each rank runs the fused field (field_cuda.field_cube_strip: K5
    on a CUDA device, its plain version on the CPU), whose halo rows are
    recomputed from absolute coordinates, so the only collective is the
    stats' all_reduce. Face seams clamp (the fused kernel's policy; the
    exchange variant is sharded_field_step)."""
    nsh = _axis_size(mesh, axis)
    if n % nsh:
        raise ValueError(f"{nsh} ranks do not divide {n} rows")
    rows = n // nsh
    idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    device = rank_device(mesh)

    def step():
        h, sh = field_cuda.field_cube_strip(n, radius, idx * rows, rows,
                                            kind=kind, octaves=octaves,
                                            device=device)
        stats = _stats(h)
        dist.all_reduce(stats, group=group)
        return h, sh, stats

    return step


def unsharded_field_step(*, octaves: int = 6, kind: str = "ridged",
                         xyscale: float = 1000.0, seam: str = "exchange"):
    """Single-device twin of sharded_field_step: the sharded output equals
    this bitwise (the same halo values, the same op order)."""
    if seam not in SEAMS:
        raise ValueError(seam)

    def step(px_hi, px_lo, py_hi, py_lo, pz_hi, pz_lo):
        h = heightfield.heights_df((px_hi, px_lo), (py_hi, py_lo),
                                   (pz_hi, pz_lo), kind=kind,
                                   octaves=octaves)
        if seam == "exchange":
            if h.shape[1] != h.shape[2]:
                raise ValueError("seam='exchange' needs square faces")
            ring = torch.stack([h[:, 0], h[:, :, -1], h[:, -1], h[:, :, 0]],
                               dim=1)
            top, bot, left, right = _seam_lines(ring)
            h_rows = torch.cat([top[:, None], h, bot[:, None]], dim=1)
            lc = torch.cat([left[:, :1], left, left[:, -1:]], dim=1)
            rc = torch.cat([right[:, :1], right, right[:, -1:]], dim=1)
            h_pad = torch.cat([lc[:, :, None], h_rows, rc[:, :, None]],
                              dim=2)
        else:
            h_rows = torch.cat([h[:, :1], h, h[:, -1:]], dim=1)
            h_pad = torch.cat([h_rows[:, :, :1], h_rows, h_rows[:, :, -1:]],
                              dim=2)
        normal = heightfield.normals_from_heights(h_pad, xyscale)
        sh = shade_mod.lambert(normal)
        return h, sh, _stats(h)

    return step
