"""The fused device frame (planet_tpu engine/device_step.py, ported): every
stage of a frame on the device, with no per-level or per-leaf host round
trip.

  1. refine       lod.refine_device: max_lod + 1 levels over fixed-cap
                  buffers, ridged probes through K4
  2. DFS order    lod.refine_device.dfs_order: the leaves in the
                  reference's DFS order, padding rows last (the generation
                  budget's priority, main.cpp:591-594), cut to render_cap:
                  one launch of the DFS order kernel (csrc/order.cu)
  3. cache        one A1 launch (cache.device_pool_cuda.cache_stage):
                  probe, parent probe, plan, protect, allocate, the
                  spill-to-crop fallback, touch, and generate's prologue
                  (the generations' noise-space DF corners, octave counts
                  6 + 12*depth // max_lod and slots in gen_cap rows; dead
                  rows: count 0, zeros)
  4. generate     one K1 launch over gen_cap slots, then store
  5. tessellate   gather, one V1 launch in its rows mode
                  (tess.vertex_cuda.tessellate_rows: from the rows' id
                  words and DF corners it computes the uniforms -- crop
                  variants, camera-relative corners, corner normals,
                  skirt -- in its own staging, then the vertex program
                  and its shade; the padding rows' NaN outputs written,
                  not computed: their corner normals are NaN). The
                  "uniforms" rung alone launches U1 (tess.uniforms_cuda),
                  as planet_tpu's rung returns the uniforms
  6. raster       raster.coverage_cuda.raster_frame (C1, K6, K2, C2, K3)
                  on all render_cap rows, padding rows invalid and skipped
                  by C1 through the leaf count on the device, or with
                  raster_mode="splat" engine.planet.splat_raster (the
                  splat raster, raster/splat.py)

Stages 1-5 are the geometry step. It is a fixed sequence of tensor ops and
kernel launches that reads no value back to the host, so DeviceRenderer
captures it ONCE as a CUDA graph and replays it every frame — the analogue
of planet_tpu's one-jit geometry step. The raster is a second graph, as
planet_tpu's DeviceRenderer splits it into a second jit
(device_step.py:325-332): fixed shapes, the counters left on the device,
nothing read back to the host between or after the two. The frame's
counts (DeviceFrame.n_leaves, n_generated, overflowed) are 0-dim device
tensors, as planet_tpu's are device scalars: the caller reads them where
it prints or reduces them. On the CPU the same step runs eagerly (the
tests).

Rules for a stage added to the geometry step or the raster (a capture
refuses, or silently bakes in, anything else):
  * no host sync: no .item(), int(tensor), bool(tensor), torch.nonzero,
    boolean-mask indexing, repeat_interleave with tensor repeats;
  * no host-to-device copy: no torch.tensor / torch.as_tensor of host data
    and no indexing with Python lists; constants are made with fills
    (nums.df.const) or uploaded once by an eager warm-up (lru caches);
  * fixed shapes: every tensor's shape follows from the build arguments;
  * kernels launch through planet_tpu_torch._cuda.launch, whose counts
    DeviceRenderer carries over to every replay;
  * no utils/timing.span: a host span inside a capture would record the
    capture and no replay (DeviceRenderer's spans wrap the replays).

The step takes its refinement roots as inputs: the six cube faces
(`face_roots`) by default, or, in the sharded engine
(parallel/sharded_lod.py), each rank's own subtrees; `raster_packed`
returns the packed int32 framebuffer, whose elementwise min over ranks is
the depth test across them.

`stop_after` cuts the step after one of its STAGES (refine, cache,
generate, uniforms, tess, geometry), as planet_tpu's stage bisection
does (device_step.py:84-86); each such rung is a graph of its own, which
tools/stage_times.py replays to split the frame's time by stage.
planet_tpu's `jit=False` (the untraced step, for shard_map) stands for
the step run eagerly: here that is build_device_render, and the
sharded engine runs DeviceRenderer's graph in each rank. The skirt size
is baked into the step, as in planet_tpu; the TPU-only
`optimization_barrier` seams have no counterpart here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from planet_tpu_torch import _cuda
from planet_tpu_torch.cache import device_pool as dp
from planet_tpu_torch.cache import device_pool_cuda
from planet_tpu_torch.engine.config import EngineConfig
from planet_tpu_torch.engine.planet import splat_raster
from planet_tpu_torch.geom import cubesphere
from planet_tpu_torch.geom import quadid
from planet_tpu_torch.lod import refine_device
from planet_tpu_torch.nums import df as dfm
from planet_tpu_torch.ops.kernels import tile_cuda
from planet_tpu_torch.ops.kernels.perlin_cuda import MAX_OCTAVES
from planet_tpu_torch.raster import coverage as cov
from planet_tpu_torch.raster import coverage_cuda
from planet_tpu_torch.tess import mesh
from planet_tpu_torch.tess import vertex
from planet_tpu_torch.tess import uniforms_cuda
from planet_tpu_torch.tess import vertex_cuda
from planet_tpu_torch.utils import timing

_I32 = torch.int32

# build_geometry_step's stop_after values, in the step's order; the
# renderers add "full" (the geometry and the raster)
STAGES = ("refine", "cache", "generate", "uniforms", "tess", "geometry")
RUNGS = STAGES + ("full",)


class Geometry(NamedTuple):
    """What the geometry step leaves on the device, per rendered leaf row
    (render_cap rows in DFS order; rows >= n_leaves are padding)."""

    vertices: vertex.PatchVertices   # (R, G, G, ...)
    vertex_shade: torch.Tensor       # (R, G, G)
    valid: torch.Tensor              # (R, G, G) bool
    leaf_lo: torch.Tensor            # (R,) int32 id words
    leaf_hi: torch.Tensor
    leaf_depth: torch.Tensor         # (R,) int32
    slot: torch.Tensor               # (R,) int32 pool slot sampled
    tiles: torch.Tensor              # (R, dim, dim) gathered tiles
    meta: torch.Tensor     # (3,) int32: n_leaves, n_generated, overflowed


class Truncated(NamedTuple):
    """What the geometry step returns when stop_after names a stage before
    "geometry": planet_tpu's early() counts and the stage's own outputs.
    The outputs keep the stage's work in what a captured rung returns
    (planet_tpu adds `probe_sum * 0.0` to its image for the same end; a
    CUDA graph drops no kernel, so the port needs no such term).

    refine:   leaf_lo, leaf_hi, leaf_depth (R,), corners_hi, corners_lo
              (R, 4, 3) in DFS order
    cache:    slot (the slot each row samples), target (allocated slot,
              -1 for none), generate, crop (R,) bool
    generate: slot, tiles (gen_cap, dim, dim) the K1 launch made,
              gen_slot (gen_cap,) the pool slot each went to
    uniforms: slot, corners_rel, normals (R, 4, 3), vx, vy, skirt (R,)
    tess:     slot, tiles (R, dim, dim) gathered, vertices, vertex_shade
    """

    meta: torch.Tensor     # (3,) int32: n_leaves, 0 generated, overflowed
    outputs: dict


class DeviceFrame(NamedTuple):
    """One frame; every field a tensor on the frame's device. DeviceRenderer
    returns its graphs' output buffers: the next render writes them (copy
    what you keep)."""

    image: torch.Tensor       # (H, W) f32 (u8 with fetch="u8")
    depth: torch.Tensor       # (H, W) f32 NDC z, +inf where empty
    n_leaves: torch.Tensor    # () int32
    n_generated: torch.Tensor  # () int32
    overflowed: torch.Tensor  # () bool
    preview: Optional[torch.Tensor] = None   # (H//k, W//k) u8, preview=k > 1


def face_roots(radius: float, device="cuda"):
    """The six cube faces as refinement roots: (lo, hi (6,) int32 id words,
    ch, cl (6, 4, 3) f32 DF corners, depth (6,) int32 zeros) on
    `device`."""
    corners = cubesphere.root_corners(radius)
    ids = np.array([quadid.make_root(f) for f in range(6)], np.uint64)
    lo, hi = quadid.to_words(ids)
    ch, cl = dfm.from_f64_np(corners)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (lo, hi, ch, cl, np.zeros(6, np.int32)))


def build_geometry_step(cfg: EngineConfig, *, device, cap: int = 4096,
                        render_cap: int = 512, gen_cap: int = 256,
                        max_lod: Optional[int] = None,
                        probe: str = "ridged6",
                        stop_after: str = "geometry"):
    """Returns step(pool, cam_hi (3,), cam_lo (3,), view_proj (4, 4),
    root_lo, root_hi (R,) int32 id words, root_ch, root_cl (R, 4, 3) f32
    DF corners, root_depth (R,) int32) -> Geometry: stages 1-5 on
    `device` from the R refinement roots (face_roots: the whole planet),
    updating the pool in place (tiles, keys, ticks, render tick).

    cap bounds the refinement buffers; render_cap the leaves cached,
    generated and drawn per frame (the DFS sort puts real leaves first, so
    the first render_cap are kept; more sets the overflow flag); gen_cap the
    tiles generated per frame (excess generations fall back to the parent
    crop, or set the overflow flag when there is no cached parent). max_lod
    caps the refinement depth (default cfg.max_lod); the octave schedule
    always uses cfg.max_lod (main.cpp:659, 827).

    stop_after (one of STAGES) ends the step after that stage and returns
    a Truncated, leaving the pool as planet_tpu's truncated step leaves
    it: untouched after "refine", with this frame's slots allocated after
    "cache", with the new tiles stored and the ticks refreshed after
    "generate", "uniforms" and "tess" (no render-tick advance). "geometry"
    (the default) is the whole step."""
    if stop_after not in STAGES:
        raise ValueError(f"stop_after {stop_after!r}: one of {STAGES}")
    device = torch.device(device)
    max_lod = cfg.max_lod if max_lod is None else int(max_lod)
    if render_cap > cap:
        raise ValueError(f"render_cap {render_cap} exceeds cap {cap}")
    if 6 + (12 * max_lod) // cfg.max_lod > MAX_OCTAVES:
        raise ValueError(f"max_lod {max_lod} needs more than {MAX_OCTAVES} "
                         "octaves")
    if cfg.raster_mode not in ("exact", "splat"):
        raise ValueError(f"raster_mode {cfg.raster_mode!r}")
    dim = cfg.tile_dim
    grid = cfg.patch_verts + 2
    grid_mask = torch.as_tensor(mesh.grid_uv_skirt(cfg.patch_verts)[3],
                                device=device)
    coord_scale = (np.float32(cfg.coord_scale),
                   np.float32(np.float64(cfg.coord_scale)
                              - np.float64(np.float32(cfg.coord_scale))))

    def step(pool: dp.PoolState, cam_hi, cam_lo, view_proj, root_lo,
             root_hi, root_ch, root_cl, root_depth) -> Geometry:
        # ------------------------------------------------ 1. refinement
        ref = refine_device.refine_device(
            cam_hi, cam_lo, root_lo, root_hi, root_ch, root_cl,
            max_lod=max_lod, cap=cap, radius=cfg.radius, probe=probe,
            root_depth=root_depth, quality=cfg.lod_quality, transposed=True)

        # ------------------------------------------------ 2. DFS order
        # the corners stay lane-major, (12, render_cap), as A1, U1 and
        # V1's rows mode take them; the refine rung returns (render_cap,
        # 4, 3) views
        q_lo, q_hi, depth, c_hi_t, c_lo_t, n, overflow = (
            refine_device.dfs_order(ref, render_cap))

        def early(**outputs) -> Truncated:
            # planet_tpu's early(): no generation counted, and the overflow
            # of the refine and the render cap only
            return Truncated(torch.stack([n, torch.zeros_like(n),
                                          overflow.to(_I32)]), outputs)

        if stop_after == "refine":
            c_hi, c_lo = (c.reshape(4, 3, render_cap).permute(2, 0, 1)
                          for c in (c_hi_t, c_lo_t))
            return early(leaf_lo=q_lo, leaf_hi=q_hi, leaf_depth=depth,
                         corners_hi=c_hi, corners_lo=c_lo)

        # ------------------------------------ 3. cache plan (A1), with the
        # generation's prologue; the "cache" rung stops before the touch,
        # as planet_tpu's does
        pcap = pool.capacity
        cs = device_pool_cuda.cache_stage(
            pool, q_lo, q_hi, depth, c_hi_t, c_lo_t, n,
            budget=cfg.generations_per_frame, gen_cap=gen_cap,
            max_lod=cfg.max_lod, coord_scale=coord_scale,
            touch=stop_after != "cache")
        slot = cs.slot
        if stop_after == "cache":
            return early(slot=slot, target=cs.target, generate=cs.generate,
                         crop=cs.crop)
        failed = overflow | cs.failed

        # ------------------------------------------------ 4. generation
        tiles = tile_cuda.generate_tiles(
            cs.gen_hi, cs.gen_lo, cs.gen_oct, kind="ridged",
            lacunarity=cfg.lacunarity, gain=cfg.gain,
            amplitude=cfg.amplitude, dim=dim)
        dp.store(pool, cs.gen_slot, cs.gen_slot < pcap, tiles)
        if stop_after == "generate":
            return early(slot=slot, tiles=tiles, gen_slot=cs.gen_slot)

        # ------------------------------------------------ 5. tessellate
        # the vertex program's per-row inputs: crop variants,
        # camera-relative corners, corner normals, skirt. The "uniforms"
        # rung returns them (U1); past it V1 computes them itself
        if stop_after == "uniforms":
            u = uniforms_cuda.uniforms(q_lo, q_hi, cs.crop, depth, c_hi_t,
                                       c_lo_t, cam_hi, cam_lo,
                                       cfg.max_skirt_size)
            return early(slot=slot, corners_rel=u.corners_rel,
                         normals=u.normals, vx=u.vx, vy=u.vy, skirt=u.skirt)
        pool_tiles = dp.gather(pool, slot)
        # the rows past n are padding (zero DF corners, so NaN normals):
        # V1 finds their NaN normals on the card and skips their
        # interpolations
        pv, vshade = vertex_cuda.tessellate_rows(
            q_lo, q_hi, cs.crop, depth, c_hi_t, c_lo_t, cam_hi, cam_lo,
            cfg.max_skirt_size, pool_tiles, view_proj, grid=grid)
        if stop_after == "tess":
            return early(slot=slot, tiles=pool_tiles, vertices=pv,
                         vertex_shade=vshade)
        active = torch.arange(render_cap, device=device, dtype=_I32) < n
        valid = active[:, None, None] & grid_mask[None]
        dp.end_frame(pool)
        meta = torch.stack([n, cs.n_generated, failed.to(_I32)])
        return Geometry(pv, vshade, valid, q_lo, q_hi, depth, slot,
                        pool_tiles, meta)

    return step


def _f32(a) -> torch.Tensor:
    """A camera or view-projection input (numpy or tensor) as f32."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32))


def _pinned(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t, pinned when it is bound from the host to the card: a copy from
    pinned memory can be queued (non_blocking), where a pageable one
    synchronizes the stream; the pinned block's allocator keeps it until
    the copy has run."""
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory()
    return t


# the camera inputs' places in DeviceRenderer's 22-float input buffer:
# view_proj first (16-byte aligned), then cam_hi, cam_lo
_INPUTS = ((16, 19, (3,)), (19, 22, (3,)), (0, 16, (4, 4)))


def _input_views(buf):
    """(cam_hi, cam_lo, view_proj) views of a 22-float input buffer."""
    return tuple(buf[a:b].reshape(shape) for a, b, shape in _INPUTS)


def _meta(out):
    """The step's three counters as 0-dim device tensors (views of
    out.meta, no host read): n_leaves, n_generated, overflowed."""
    return out.meta[0], out.meta[1], out.meta[2] != 0


@functools.lru_cache(maxsize=None)
def _cell_mask(patch_verts: int) -> np.ndarray:
    return mesh.cell_triangle_mask(patch_verts)


def raster_packed(geom: Geometry, cfg: EngineConfig, width: int,
                  height: int, wireframe: bool = False):
    """The exact raster on all render_cap rows of the geometry step's
    output, undecoded: ((packed (H, W) int32, n_leaves, n_generated,
    overflowed (0-dim device tensors), leaf_lo, leaf_hi (render_cap,)
    int32), RasterCounters). The padding rows are invalid, and C1 skips
    them through the leaf count (geom.meta[0]) on the device. The packed
    keys' min is the depth test, so frames drawn apart (the sharded
    engine's ranks) composite exactly by an elementwise min. Reads
    nothing back to the host."""
    if cfg.raster_mode != "exact":
        raise ValueError("packed raster output requires raster_mode='exact'")
    pv = geom.vertices
    packed, counters = coverage_cuda.raster_frame(
        pv.clip, pv.normal, geom.valid, width, height,
        cell_mask=_cell_mask(cfg.patch_verts), decode=False,
        wireframe=wireframe, far_w=cfg.far_plane, count=geom.meta[0:1])
    n, n_gen, ovf = _meta(geom)
    return ((packed, n, n_gen, ovf | counters.overflowed, geom.leaf_lo,
             geom.leaf_hi), counters)


def raster(geom: Geometry, cfg: EngineConfig, width: int, height: int,
           wireframe: bool = False):
    """Stage 6 on all render_cap rows of the geometry step's output, whose
    padding rows are invalid: (DeviceFrame, the exact raster's
    RasterCounters, None in splat mode). Reads nothing back to the host,
    so a CUDA graph can capture it."""
    if cfg.raster_mode == "splat":
        image, depth = splat_raster(geom.vertices, geom.vertex_shade,
                                    geom.valid, cfg, width, height,
                                    wireframe)
        return DeviceFrame(image, depth, *_meta(geom)), None
    (packed, n, n_gen, ovf, _, _), counters = raster_packed(
        geom, cfg, width, height, wireframe)
    image, depth = cov.decode_packed(packed)
    return DeviceFrame(image, depth, n, n_gen, ovf), counters


def _step_stage(stop_after: str) -> str:
    """The geometry step's stop_after for a renderer's rung."""
    if stop_after not in RUNGS:
        raise ValueError(f"stop_after {stop_after!r}: one of {RUNGS}")
    return "geometry" if stop_after == "full" else stop_after


def unrastered(out, width: int, height: int) -> DeviceFrame:
    """The frame of a rung before "full" (a Geometry or a Truncated): a
    zero image and depth, as planet_tpu's truncated step returns, and the
    step's three counters (device tensors, no host read)."""
    zero = torch.zeros((height, width), dtype=torch.float32,
                       device=out.meta.device)
    return DeviceFrame(zero, zero, *_meta(out))


def _root_tensors(roots, radius: float, device) -> tuple:
    if roots is None:
        return face_roots(radius, device)
    return tuple(torch.as_tensor(r, device=device).clone() for r in roots)


def build_device_render(cfg: EngineConfig, width: int, height: int, *,
                        device, roots=None, stop_after: str = "full",
                        **kw):
    """Returns fn(pool, cam_hi, cam_lo, view_proj) -> DeviceFrame: the
    geometry step from `roots` (the five root arrays of
    build_geometry_step's step; None: face_roots) and the raster, run
    eagerly; the pool is updated in place. This eager step is the
    counterpart of planet_tpu's build_device_render(jit=False).

    stop_after: one of RUNGS. "full" (the default) rasterizes; a rung
    before it stops the step there and returns its `unrastered` frame.
    Other keywords as build_geometry_step."""
    device = torch.device(device)
    step = build_geometry_step(cfg, device=device,
                               stop_after=_step_stage(stop_after), **kw)
    roots = _root_tensors(roots, cfg.radius, device)

    def render(pool, cam_hi, cam_lo, view_proj) -> DeviceFrame:
        geom = step(pool, *(_pinned(_f32(a), device).to(device,
                                                         non_blocking=True)
                            for a in (cam_hi, cam_lo, view_proj)), *roots)
        if stop_after != "full":
            return unrastered(geom, width, height)
        return raster(geom, cfg, width, height)[0]

    return render


class DeviceRenderer:
    """Two-graph device frame: the geometry step (stages 1-5) and the
    raster (stage 6), each captured once as a CUDA graph and replayed per
    frame on CUDA, with no host read between or after them (run eagerly
    on the CPU).

    The camera and view-projection enter through static input tensors,
    views of one 22-float device buffer, copied in before each replay: the
    host inputs (numpy or CPU tensors) are written into one 22-float host
    buffer (pinned once on CUDA) and go over in one queued copy. On CUDA a
    later frame writes that buffer only once the copy that read it has
    run: an event recorded after each copy is queried first, and waited
    on only when it has not completed (`staging_waits` counts those waits;
    a caller that reads its frame back before the next never waits). The
    refinement roots (`roots`, as build_device_render takes them) are
    static inputs filled once. The
    capture is made on the first frame rendered into a pool: a warm-up run
    of the step on a side stream first uploads the lazily built tables and
    creates the library handles (nothing may be copied from the host during
    capture); it runs on a copy of the pool's state, which is put back
    afterwards, so the warm-up changes nothing. Rendering into another pool
    captures again. The raster graph reads the geometry graph's output
    buffers; it is captured after the geometry graph's first replay, with
    the same warm-up on a side stream (the raster writes no state, so
    there is nothing to put back), once for each value of `wireframe` (a
    kernel argument the graph bakes in), lazily, and again after each
    geometry capture. The raster graph holds fetch="u8", preview and
    decode. A capture that fails raises: there is no eager fallback on
    the card.

    The graphs' kernel launches are added to _cuda.launches on every
    replay, so the counts mean "launched on the card". The frame `render`
    returns is the raster graph's output buffers (and last_geometry the
    geometry graph's): the next render writes them.

    stop_after (one of RUNGS) is the stage bisection of planet_tpu's
    build_device_render: "full" (the default) is the frame above; a stage
    name captures the geometry step cut after that stage
    (build_geometry_step's stop_after), so `geometry` returns what the
    cut step returns (the Geometry at "geometry", else a Truncated) and
    `render` its `unrastered` frame, with no raster. Each rung is a graph
    of its own; tools/stage_times.py times them.

    fetch="u8" quantizes the image on the device exactly as
    io/png.write_png does (clip, * 255 + 0.5, truncate);
    preview=k > 1 (u8 only) adds a [::k, ::k] subsampled image.
    `wireframe` (reference key P) is a raster option, read each frame: each
    value replays its own raster graph.
    device: "cuda" (the default) or "cpu"."""

    def __init__(self, cfg: EngineConfig, width: int, height: int, *,
                 device="cuda", roots=None, fetch: str = "f32",
                 preview: int = 1, stop_after: str = "full", **kw):
        if fetch not in ("f32", "u8"):
            raise ValueError(fetch)
        if preview > 1 and fetch != "u8":
            raise ValueError("preview requires fetch='u8'")
        self.cfg = cfg
        self.width, self.height = int(width), int(height)
        self.device = torch.device(device)
        self.fetch = fetch
        self.preview = int(preview)
        self.wireframe = False
        self.stop_after = stop_after
        self._step = build_geometry_step(
            cfg, device=self.device, stop_after=_step_stage(stop_after), **kw)
        self._roots = _root_tensors(roots, cfg.radius, self.device)
        self._inputs = torch.zeros(22, dtype=torch.float32,
                                   device=self.device)
        self._cam_hi, self._cam_lo, self._vp = _input_views(self._inputs)
        cuda = self.device.type == "cuda"
        self._staging = torch.zeros(22, dtype=torch.float32, pin_memory=cuda)
        self._staging_views = _input_views(self._staging.numpy())
        self._staged = torch.cuda.Event() if cuda else None
        self._staged_pending = False
        # waits for a staged copy still queued when the next frame staged
        self.staging_waits = 0
        self._graph = None
        self._graph_pool = None
        self._graph_out = None
        self._tally: dict = {}
        # wireframe -> (raster graph, its (DeviceFrame, counters), tally)
        self._rasters: dict = {}
        # raster captures so far; each one's warm-up ran the raster's
        # kernels once, eagerly (counted in _cuda.launches)
        self.raster_captures = 0
        # geometry graph captures (each with one eager warm-up, counted in
        # _cuda.launches too) and replays so far
        self.geometry_captures = 0
        self.geometry_replays = 0
        self.last_geometry: Optional[Geometry] = None
        self.last_counters = None

    def init_pool(self) -> dp.PoolState:
        return dp.init(self.cfg.cache_capacity, self.cfg.tile_dim,
                       self.device)

    def _run_step(self, pool):
        return self._step(pool, self._cam_hi, self._cam_lo, self._vp,
                          *self._roots)

    def _captured(self, fn, warm_up):
        """(graph, fn()'s outputs, its kernel tally): fn captured as a CUDA
        graph after warm_up() has run on a side stream."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm_up()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _cuda.captured() as tally:
            with torch.cuda.graph(graph):
                out = fn()
        return graph, out, tally

    def _capture(self, pool: dp.PoolState):
        saved = [t.clone() for t in pool]

        def warm_up():
            self._run_step(pool)
            for t, v in zip(pool, saved):
                t.copy_(v)

        self._graph = self._graph_out = None
        self._rasters = {}
        with timing.span("capture"):
            self._graph, self._graph_out, self._tally = self._captured(
                lambda: self._run_step(pool), warm_up)
        self._graph_pool = pool
        self.geometry_captures += 1

    def _fetch(self, frame: DeviceFrame) -> DeviceFrame:
        if self.fetch != "u8":
            return frame
        image = (torch.clamp(frame.image, 0.0, 1.0) * 255.0 + 0.5).to(
            torch.uint8)
        preview = (image[::self.preview, ::self.preview]
                   if self.preview > 1 else None)
        return frame._replace(image=image, preview=preview)

    def _raster(self, geom, wireframe: bool):
        """Stage 6 and the fetch on a Geometry: (DeviceFrame, counters)."""
        frame, counters = raster(geom, self.cfg, self.width, self.height,
                                 wireframe)
        return self._fetch(frame), counters

    def _capture_raster(self, wireframe: bool):
        def run():
            return self._raster(self._graph_out, wireframe)

        with timing.span("capture"):
            self._rasters[wireframe] = self._captured(run, run)
        self.raster_captures += 1

    @property
    def graph_launches(self) -> dict:
        """Kernel launches per frame of the captured graphs: the geometry
        step's and, once captured, the raster's for the current wireframe
        setting (empty before the first capture, and on the CPU)."""
        tally = dict(self._tally)
        if bool(self.wireframe) in self._rasters:
            for k, v in self._rasters[bool(self.wireframe)][2].items():
                tally[k] = tally.get(k, 0) + v
        return tally

    def _staging_free(self):
        """Wait for the last staged copy, if it has not run yet."""
        if self._staged_pending:
            self._staged_pending = False
            if not self._staged.query():
                self.staging_waits += 1
                self._staged.synchronize()

    def _upload_inputs(self, srcs):
        """Write the camera inputs into the staging buffer and queue its
        one copy to the static inputs."""
        self._staging_free()
        for view, src in zip(self._staging_views, srcs):
            view[...] = src.numpy() if isinstance(src, torch.Tensor) else src
        self._inputs.copy_(self._staging, non_blocking=True)
        if self._staged is not None:
            self._staged.record(torch.cuda.current_stream(self.device))
            self._staged_pending = True

    def geometry(self, pool: dp.PoolState, cam_hi, cam_lo, view_proj):
        """Stages 1-5 for one camera ((3,) f32 DF camera, (4, 4) f32
        view-projection; numpy or CPU tensors), updating the pool in
        place: a Geometry, or a Truncated when stop_after names an earlier
        stage."""
        with timing.span("geometry"):
            with timing.span("upload"):
                self._upload_inputs((cam_hi, cam_lo, view_proj))
            if self.device.type != "cuda":
                geom = self._run_step(pool)
            else:
                if self._graph_pool is not pool:
                    self._capture(pool)
                with timing.span("replay"):
                    self._graph.replay()
                    _cuda.add_launches(self._tally)
                self.geometry_replays += 1
                geom = self._graph_out
            self.last_geometry = geom
        return geom

    def render(self, pool: dp.PoolState, cam_hi, cam_lo,
               view_proj) -> DeviceFrame:
        """One frame into `pool` (updated in place): on CUDA a replay of the
        geometry graph, then of the raster graph, with no host read; the
        raster's counters are on `self.last_counters`."""
        self.geometry(pool, cam_hi, cam_lo, view_proj)
        return self.rasterize()

    def rasterize(self) -> DeviceFrame:
        """Stage 6 on the last geometry: on CUDA a replay of the raster
        graph for the current `wireframe` (captured on first use), else the
        raster run eagerly; a rung before "full" gives its unrastered
        frame. The counters go to `self.last_counters`."""
        with timing.span("raster"):
            geom = self.last_geometry
            if self.stop_after != "full":
                self.last_counters = None
                return self._fetch(unrastered(geom, self.width, self.height))
            wireframe = bool(self.wireframe)
            if self.device.type != "cuda":
                frame, self.last_counters = self._raster(geom, wireframe)
                return frame
            if wireframe not in self._rasters:
                self._capture_raster(wireframe)
            graph, (frame, counters), tally = self._rasters[wireframe]
            with timing.span("replay"):
                graph.replay()
                _cuda.add_launches(tally)
            self.last_counters = counters
        return frame


class PipelinedRenderer:
    """Two-frame pipeline over DeviceRenderer: submit() enqueues a frame and
    the copy of its image to the host, and returns the PREVIOUS frame as
    (host numpy image, DeviceFrame) — the image being the u8 preview when
    the renderer makes one, else the full image — or None on the first
    call. On CUDA the copy goes into pinned host memory with
    non_blocking=True and an event marks its end, so the host reads a frame
    while the card works on the next; the frame's three counts are copied
    the same way, and the returned DeviceFrame holds them as host 0-dim
    tensors (its image and depth are the renderer's buffers, which the
    next frame has written). Frames run in submission order through one
    pool, so the output equals the sequential output."""

    def __init__(self, renderer: DeviceRenderer, pool: dp.PoolState):
        self._r = renderer
        self._pool = pool
        self._pending = None

    @property
    def pool(self) -> dp.PoolState:
        return self._pool

    def submit(self, cam_hi, cam_lo, view_proj):
        frame = self._r.render(self._pool, cam_hi, cam_lo, view_proj)
        src = frame.preview if frame.preview is not None else frame.image
        event = None
        if src.device.type == "cuda":
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src, non_blocking=True)
            counts = torch.empty(3, dtype=torch.int32, pin_memory=True)
            counts.copy_(torch.stack([frame.n_leaves, frame.n_generated,
                                      frame.overflowed.to(_I32)]),
                         non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            frame = frame._replace(n_leaves=counts[0], n_generated=counts[1],
                                   overflowed=counts[2])
        else:
            host = src
        prev, self._pending = self._pending, (host, event, frame)
        return self._finish(prev)

    def flush(self):
        """Drain the last frame in flight (None if there is none)."""
        prev, self._pending = self._pending, None
        return self._finish(prev)

    @staticmethod
    def _finish(pending):
        if pending is None:
            return None
        host, event, frame = pending
        if event is not None:
            event.synchronize()
            frame = frame._replace(overflowed=frame.overflowed != 0)
        return host.numpy(), frame
