// Triangle-setup kernels of the exact raster. C1 (setup_kernel): the
// per-candidate setup in one pass. (Q, G, G) patch grids of clip
// positions, shading normals and validity -> for every cell triangle, in
// coverage.setup_t's parity-major candidate order (N = 2 Q G G): its
// 32-float record column of the (32, N) matrix (live candidates only), the
// near-plane straddler mask and each block's count of straddlers, and
// K6's route (csrc/raster.cu): each 32 candidates' two class masks and
// each block's two class counts. C2
// (clip_kernel, below): the clip pass, the straddlers compacted and
// clipped into their live records.
//
// planet_tpu sets the triangles up in XLA (raster/coverage.py:_setup_t and
// raster/nearclip.py:straddle_mask_t), not in Pallas, so this kernel
// replaces no TPU kernel: on the card the composed torch ops were some 300
// launches a frame and most of the fused frame's raster time (PERF.md).
// Plain PyTorch version: planet_tpu_torch/raster/coverage_cuda.py:
// setup_plain (coverage.setup_t and nearclip.straddle_mask_t, unchanged),
// which it equals bit for bit in the straddler mask and every live record
// column, and route_masks_plain (coverage_cuda.route's class test on
// setup_plain's live, span and records), which it equals in every mask
// word and count; the wrapper is coverage_cuda.setup_cuda.
//
// A thread a candidate. setup_t's lane rotations (coverage.tri3) become
// index arithmetic: cell j of patch q gives T0 = (j, j + G, j + 1) and
// T1 = (j + 1, j + G, j + G + 1), all mod G G (the wrap only reaches the
// wrap-padding cells of the last grid row and column, which the cell table
// kills). The thread reads its three vertices (the projection is
// recomputed by each of the up to six triangles that share a vertex: the
// reads hit L1/L2, and a projection pass would be another launch), and
// runs setup_t's op order: project and snap, cull, bbox, the three edge
// constants and top-left biases, the 1/area terms, the far-straddler
// floor; then straddle_mask_t's det3 and frustum outcodes. Built with
// -fmad=false -prec-div=true, so every product, sum and reciprocal rounds
// as torch's; min and max propagate NaN as torch.minimum does.
//
// The leaf count: with a count pointer (the fused frame's geom.meta[0]) a
// thread whose patch row is at or past it writes straddle = 0 and reads
// nothing (those rows are padding, all invalid, so the plain version's
// live and straddle are 0 there too, and the route holds none of them), and
// a block whose candidates all lie on such rows writes its zero words and
// leaves before any index arithmetic. Without one (PlanetEngine) every row
// is evaluated. Record columns of dead candidates are not written: the
// only reader of the matrix, K6's scatter, reads a column only where a
// class mask holds it. Each block of 256 candidates also writes its
// straddlers' count, 4,096 words at 1080p: what C2 scans in place of the
// 1 M-candidate mask (plain version: coverage_cuda.straddle_blocks, which
// the plain clip pass does not need).
//
// K6's route. A C1 block is exactly one of K6's tiles
// (kSetupThreads = raster.cu kRouteTile = 256), and every bit of the
// route is a function of what the thread holds in registers: its live
// flag, its span and its row-28 word. So C1 writes it, with the route's
// own test (coverage_cuda.route: span class live, at most max_span blocks
// tall and not a far-straddler, row 28 > 0; huge class the other live
// ones): each warp's two ballots to masks[2 w] and masks[2 w + 1], and
// each block's (span, huge) counts to its pair, in the layout of the
// route's scratch (coverage_cuda.route_scratch_ints: the mask words, then
// the pairs), which K6's scan and scatter read as before. K6's first pass,
// which read live, span and row 28 back for all N candidates (9 B each,
// the padding rows' too) to form the same bits, is gone, and with it the
// 5 B a candidate of live and span that only it read: C1 writes neither
// (a candidate's span is only its class's test). A block with live rows
// runs griddepcontrol.launch_dependents after the padding test, so the
// scan, launched as C1's programmatic dependent, can start during C1's
// tail; a padding block leaves without it (a finished block needs no
// trigger). Issued at the start by every block, the trigger cost C1
// 0.016 ms at config 3's flight, whose 69,697 blocks are mostly padding
// ones with nothing else to do. Measured (queued, C1 then K6 as the frame
// runs them, the old hand-off then this one, one H100): config 3's flight
// 0.476 -> 0.385 ms, the dense frame 0.315 -> 0.282, the 1080p rows
// 0.033 -> 0.026; C1 alone 0.2437 -> 0.2336, 0.182 -> 0.189 and 0.0156 ->
// 0.0160 (what it adds where few blocks are padding is the prologue's
// integer work: 880 SASS instructions against 784; the class test ~0.001).
// Measured and dropped (C1 alone at config 3's flight, queued, with the
// trigger at the start): the block-wide padding test by a division of the
// block's first index (C1 + K6 0.405 either way, C1 alone 0.0168 at
// 1080p); the division before the padding test and no block-wide exit,
// 0.276; that and the three counts by __syncthreads_count, 0.277; the
// counts alone by __syncthreads_count 0.250, as the ballots; 5 and 6
// blocks an SM by launch bounds (48 and 40 registers), 0.278 and 0.343.
//
// C2, clip_kernel: coverage_cuda.clip_pass on the card, planet_tpu's
// clip pass behind its lax.cond (raster/coverage.py:_clipped, nearclip.py;
// XLA, no Pallas kernel). One block of 512 threads. The compaction:
// each thread sums the block counts of its run of C1 blocks, a block
// scan ranks the runs, and each thread writes the candidate indices of
// its straddlers that fall in the first clip_cap slots (reading the
// straddle bytes of the C1 blocks that hold one, and no other): planet_tpu's
// _compact_indices, N in the empty slots, n_straddle counting all. Then a
// thread a used slot (none when nothing straddles) runs nearclip's op
// order: gather_tri_verts_t (the clamped corner indices), clip_expand
// (Sutherland-Hodgman against z + w >= 0: the rotation to the lone
// vertex, the two edge parameters f0 / (f0 - f1) and f2 / (f2 - f0), the
// interpolated positions and normals), then for each of A and B
// setup_tris and records_from_tris (the same projection, cull, bbox and
// record words as C1). A block scan of each slot's live parts places the
// live records in (slot, A, B) order, no atomics, and their count is
// written on the card for K3, which draws that many (none: it leaves at
// once). The plain version is clip_pass_plain (compact_indices,
// nearclip.clipped_tris, records_from_tris, the live records in the same
// order), which it equals bit for bit in the indices, n_straddle, the
// records and their count. Bound: the block counts read once, the used
// slots' vertices read and their live records written; at 1080p with no
// straddler 16 KB, so a launch's latency is all it can cost.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// candidates a C1 block takes: also K6's tile (csrc/raster.cu kRouteTile),
// so that a block's class counts are one route block's
constexpr int kSetupThreads = 256;
constexpr int kSetupWarps = kSetupThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kWMin = 1e-9f;         // coverage._W_MIN
constexpr float kSnap = 16.0f, kInvSnap = 0.0625f;

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// coverage.to_i32: truncate toward zero, saturate, NaN -> 0
__device__ __forceinline__ int to_i32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  return (int)fminf(fmaxf(x, -2147483648.0f), 2147483520.0f);
}

struct Vert {
  float x, y, z, w;                    // clip position
  float nx, ny, nz;                    // shading normal
  bool valid;
};

// coverage.edge_consts of edge a -> b relative to the bbox-min pixel
// centre (ox, oy); FRONT_SIGN is 1
__device__ __forceinline__ void edge(float xa, float ya, float xb, float yb,
                                     float ox, float oy, float* dx,
                                     float* dy, float* c, float* bias) {
  const float DX = (xb - xa) * 1.0f;
  const float DY = (yb - ya) * 1.0f;
  *dx = DX;
  *dy = DY;
  *c = DX * (oy - ya) - DY * (ox - xa);
  const bool topleft = (DY < 0.0f) || (DY == 0.0f && DX > 0.0f);
  *bias = topleft ? -1.0f / 512.0f : 1.0f / 512.0f;
}

// coverage.project for one vertex: the w test, 1/w, the snapped screen
// position; and z and the normal scaled by 1/w
struct Projected {
  bool okw;
  float iw, sx, sy, z, nx, ny, nz;
};

__device__ __forceinline__ Projected project(float x, float y, float z,
                                             float w, float nx, float ny,
                                             float nz, bool valid,
                                             float width, float height) {
  Projected o;
  o.okw = valid && w > kWMin;
  o.iw = o.okw ? 1.0f / w : 0.0f;
  const float px = (x * o.iw * 0.5f + 0.5f) * width;
  const float py = (0.5f - y * o.iw * 0.5f) * height;
  o.sx = rintf(px * kSnap) * kInvSnap;
  o.sy = rintf(py * kSnap) * kInvSnap;
  o.z = z * o.iw;
  o.nx = nx * o.iw, o.ny = ny * o.iw, o.nz = nz * o.iw;
  return o;
}

// A projected triangle's cull and bbox (coverage.setup_t and
// nearclip.setup_tris): tri_ok is the three vertices' w tests and the
// caller's own
struct Tri {
  float area2;
  int px0, py0, px1, py1;
  bool live;
};

__device__ __forceinline__ Tri cull(const Projected* v, bool tri_ok,
                                    int wmax, int hmax) {
  Tri t;
  t.area2 = ((v[1].sx - v[0].sx) * (v[2].sy - v[0].sy)
             - (v[1].sy - v[0].sy) * (v[2].sx - v[0].sx)) * 1.0f;
  const float min_x = tmin(tmin(v[0].sx, v[1].sx), v[2].sx);
  const float max_x = tmax(tmax(v[0].sx, v[1].sx), v[2].sx);
  const float min_y = tmin(tmin(v[0].sy, v[1].sy), v[2].sy);
  const float max_y = tmax(tmax(v[0].sy, v[1].sy), v[2].sy);
  t.px0 = max(to_i32(ceilf(min_x - 0.5f)), 0);
  t.px1 = min(to_i32(floorf(max_x - 0.5f)), wmax);
  t.py0 = max(to_i32(ceilf(min_y - 0.5f)), 0);
  t.py1 = min(to_i32(floorf(max_y - 0.5f)), hmax);
  t.live = tri_ok && t.area2 > 0.0f && t.px0 <= t.px1 && t.py0 <= t.py1;
  return t;
}

// The 32 record words (coverage.setup_t's rows, nearclip.records_from_tris)
// of a triangle with its 1/area and row-28 word
__device__ __forceinline__ void record(const Projected* v, const Tri& t,
                                       float inv_area, float r28,
                                       float* r) {
  const float ox = (float)t.px0 + 0.5f, oy = (float)t.py0 + 0.5f;
  edge(v[1].sx, v[1].sy, v[2].sx, v[2].sy, ox, oy, &r[0], &r[1], &r[2],
       &r[29]);
  edge(v[2].sx, v[2].sy, v[0].sx, v[0].sy, ox, oy, &r[3], &r[4], &r[5],
       &r[30]);
  edge(v[0].sx, v[0].sy, v[1].sx, v[1].sy, ox, oy, &r[6], &r[7], &r[8],
       &r[31]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r[9 + k] = v[k].z * inv_area;
    r[12 + k] = v[k].iw * inv_area;
    r[15 + 3 * k] = v[k].nx * inv_area;
    r[16 + 3 * k] = v[k].ny * inv_area;
    r[17 + 3 * k] = v[k].nz * inv_area;
  }
  r[24] = (float)t.px0, r[25] = (float)t.py0;
  r[26] = (float)t.px1, r[27] = (float)t.py1;
  r[28] = r28;
}

// A candidate's outcome: its straddle word and its route class (span or
// huge class, neither when dead).
struct Outcome {
  bool straddle, span, huge;
};

// One candidate of C1: writes its straddle word and its record column
// where live; returns its straddle word and class. A candidate past the first
// live_cells cells of its parity (the cells of the rows below the leaf
// count) lies on a padding row: it reads nothing.
__device__ __forceinline__ Outcome setup_one(
    const float* __restrict__ clip, const float* __restrict__ normal,
    const unsigned char* __restrict__ valid,
    const unsigned char* __restrict__ cell_ok, long long live_cells,
    long long i, int q, int g, float width, float height, int wmax, int hmax,
    int has_far, float far_w, float far_ilim, int max_span,
    float* __restrict__ tm, unsigned char* __restrict__ straddle_out) {
  const int gg = g * g;
  const long long ncell = (long long)q * gg;
  const long long n = 2 * ncell;
  const int p = i >= ncell;
  const long long rem = i - p * ncell;
  if (rem >= live_cells) {
    straddle_out[i] = 0;
    return Outcome{false, false, false};
  }
  const int qq = (int)(rem / gg);
  const int j = (int)(rem - (long long)qq * gg);
  const int j1 = j + 1 < gg ? j + 1 : j + 1 - gg;
  const int jg = j + g < gg ? j + g : j + g - gg;
  const int jg1 = j + g + 1 < gg ? j + g + 1 : j + g + 1 - gg;
  const int idx[3] = {p ? j1 : j, jg, p ? jg1 : j1};

  Vert v[3];
  Projected pv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const long long at = (long long)qq * gg + idx[k];
    const float4 c = reinterpret_cast<const float4*>(clip)[at];
    v[k].x = c.x, v[k].y = c.y, v[k].z = c.z, v[k].w = c.w;
    v[k].nx = normal[at * 3], v[k].ny = normal[at * 3 + 1];
    v[k].nz = normal[at * 3 + 2];
    v[k].valid = valid[at] != 0;
    pv[k] = project(v[k].x, v[k].y, v[k].z, v[k].w, v[k].nx, v[k].ny,
                    v[k].nz, v[k].valid, width, height);
  }
  const bool cell = cell_ok[p * gg + j] != 0;

  // ---------------------------------------------- coverage.setup_t
  const Tri t = cull(pv, pv[0].okw && pv[1].okw && pv[2].okw && cell, wmax,
                     hmax);
  const int span = (t.py1 >> 3) - (t.py0 >> 3) + 1;   // floor division by 8
  float r28 = 0.0f;                                   // live * ilim
  if (t.live) {
    const bool far = has_far && (v[0].w > far_w || v[1].w > far_w
                                 || v[2].w > far_w);
    r28 = far ? far_ilim : -1.0f;
    float r[32];
    record(pv, t, 1.0f / t.area2, r28, r);
#pragma unroll
    for (int k = 0; k < 32; ++k) tm[(long long)k * n + i] = r[k];
  }
  // ------------------------------------------ coverage_cuda.route
  const bool span_class = t.live && span <= max_span && !(r28 > 0.0f);

  // -------------------------------------- nearclip.straddle_mask_t
  const float x0 = v[0].x, x1 = v[1].x, x2 = v[2].x;
  const float y0 = v[0].y, y1 = v[1].y, y2 = v[2].y;
  const float w0 = v[0].w, w1 = v[1].w, w2 = v[2].w;
  const float det3 = (x0 * (y1 * w2 - y2 * w1) - y0 * (x1 * w2 - x2 * w1))
                     + w0 * (x1 * y2 - x2 * y1);
  const bool all_out =
      (w0 - x0 < 0.0f && w1 - x1 < 0.0f && w2 - x2 < 0.0f)
      || (w0 + x0 < 0.0f && w1 + x1 < 0.0f && w2 + x2 < 0.0f)
      || (w0 - y0 < 0.0f && w1 - y1 < 0.0f && w2 - y2 < 0.0f)
      || (w0 + y0 < 0.0f && w1 + y1 < 0.0f && w2 + y2 < 0.0f);
  const bool wl = w0 <= kWMin || w1 <= kWMin || w2 <= kWMin;
  const bool fpos = v[0].z + w0 > 0.0f || v[1].z + w1 > 0.0f
                    || v[2].z + w2 > 0.0f;
  const bool st = v[0].valid && v[1].valid && v[2].valid && wl && fpos
                  && det3 < 0.0f && !all_out && cell;
  straddle_out[i] = st;
  return Outcome{st, span_class, t.live && !span_class};
}

// C1: a thread a candidate. Each block also writes its straddlers' count
// (blocks_out, a word a block), which C2 scans, and K6's route: each
// warp's span-class and huge-class ballots (masks[2 w], masks[2 w + 1])
// and the block's two class counts (pairs[2 b], pairs[2 b + 1]), which
// K6's scan and scatter read.
__global__ void __launch_bounds__(kSetupThreads)
setup_kernel(const float* __restrict__ clip, const float* __restrict__ normal,
             const unsigned char* __restrict__ valid,
             const unsigned char* __restrict__ cell_ok,
             const int* __restrict__ count, int q, int g, float width,
             float height, int wmax, int hmax, int has_far, float far_w,
             float far_ilim, int max_span, float* __restrict__ tm,
             unsigned char* __restrict__ straddle_out,
             int* __restrict__ blocks_out, unsigned* __restrict__ masks,
             int* __restrict__ pairs) {
  __shared__ int s_cnt[3][kSetupWarps];
  const long long ncell = (long long)q * g * g, n = 2 * ncell;
  const long long first = (long long)blockIdx.x * kSetupThreads;
  const long long i = first + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t w = (size_t)blockIdx.x * kSetupWarps + warp;
  // the cells of each parity on the rows below the leaf count: candidates
  // [0, live_cells) and [ncell, ncell + live_cells)
  const int rows = count != nullptr ? min(max(*count, 0), q) : q;
  const long long live_cells = (long long)rows * g * g;
  const long long last = min(first + kSetupThreads, n) - 1;
  if (first >= live_cells
      && (rows == 0 || last < ncell || first >= ncell + live_cells)) {
    // every candidate of the block lies on a padding row
    if (i < n) straddle_out[i] = 0;
    if (lane == 0) masks[2 * w] = 0, masks[2 * w + 1] = 0;
    if (threadIdx.x == 0)
      blocks_out[blockIdx.x] = 0, pairs[2 * blockIdx.x] = 0,
      pairs[2 * blockIdx.x + 1] = 0;
    return;
  }
  // K6's scan may be scheduled as this grid drains (it waits for its
  // results in griddepcontrol.wait); a padding block leaves without the
  // trigger, which a grid's finished blocks do not need
  asm volatile("griddepcontrol.launch_dependents;");
  Outcome o{false, false, false};
  if (i < n)
    o = setup_one(clip, normal, valid, cell_ok, live_cells, i, q, g, width,
                  height, wmax, hmax, has_far, far_w, far_ilim, max_span, tm,
                  straddle_out);
  const unsigned mst = __ballot_sync(kFull, o.straddle);
  const unsigned ms = __ballot_sync(kFull, o.span);
  const unsigned mh = __ballot_sync(kFull, o.huge);
  if (lane == 0) {
    masks[2 * w] = ms, masks[2 * w + 1] = mh;
    s_cnt[0][warp] = __popc(mst);
    s_cnt[1][warp] = __popc(ms), s_cnt[2][warp] = __popc(mh);
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < kSetupWarps; ++k) c += s_cnt[threadIdx.x][k];
    if (threadIdx.x == 0)
      blocks_out[blockIdx.x] = c;
    else
      pairs[2 * blockIdx.x + threadIdx.x - 1] = c;
  }
}

constexpr int kClipThreads = 512;

// Exclusive prefix sum of v over the clip block (all its threads must
// call it); total: the block's sum
__device__ __forceinline__ int clip_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kClipThreads / 32; ++w) {
    const int t = s_warp[w];
    before += w < warp ? t : 0;
    all += t;
  }
  __syncthreads();
  total = all;
  return x - v + before;
}

// One clipped triangle (nearclip.setup_tris): its projected vertices, its
// cull and bbox, its row-28 word
struct ClipTri {
  Projected pv[3];
  Tri t;
  float ilim;
};

__device__ __forceinline__ ClipTri clip_tri(const float (*c)[4],
                                            const float (*nv)[3], bool live,
                                            float width, float height,
                                            int wmax, int hmax, int has_far,
                                            float far_w, float far_ilim) {
  ClipTri o;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    o.pv[k] = project(c[k][0], c[k][1], c[k][2], c[k][3], nv[k][0],
                      nv[k][1], nv[k][2], live, width, height);
  o.t = cull(o.pv, live && o.pv[0].okw && o.pv[1].okw && o.pv[2].okw, wmax,
             hmax);
  const bool far = has_far && (c[0][3] > far_w || c[1][3] > far_w
                               || c[2][3] > far_w);
  o.ilim = far ? far_ilim : -1.0f;
  return o;
}

// A live clipped triangle's row record (nearclip.records_from_tris)
__device__ __forceinline__ void clip_record(const ClipTri& c,
                                            float* __restrict__ out) {
  float r[32];
  record(c.pv, c.t, 1.0f / c.t.area2, c.ilim, r);
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    o[k] = make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
}

// One block. (1) The straddlers' compaction: thread t sums the C1 block
// counts of its run of blocks, a block scan gives its first slot, and it
// writes the candidate indices of the straddlers of its blocks that fall
// in the first `cap` slots, in candidate order, reading the straddle
// bytes of those blocks alone (64 at a time, each 0 or 1); the empty
// slots get n. (2) A thread a used slot clips its straddler into triangles A
// and B; a block scan of their live counts places the live records in
// (slot, A, B) order. Nothing is atomic, so the order is the plain
// version's.
__global__ void __launch_bounds__(kClipThreads)
clip_kernel(const float* __restrict__ clip, const float* __restrict__ normal,
            const unsigned char* __restrict__ straddle,
            const int* __restrict__ blocks, int nblocks, int cap, int q,
            int g, float width, float height, int wmax, int hmax,
            int has_far, float far_w, float far_ilim,
            int* __restrict__ s_idx, int* __restrict__ n_straddle,
            float* __restrict__ recs, int* __restrict__ rec_count) {
  __shared__ int s_warp[kClipThreads / 32];
  const int tid = threadIdx.x;
  const long long gg = (long long)g * g, ncell = q * gg, n = 2 * ncell;

  // ------------------------------------------------- the compaction
  const int per = (nblocks + kClipThreads - 1) / kClipThreads;
  const int b0 = min(tid * per, nblocks), b1 = min(b0 + per, nblocks);
  int mine = 0;
#pragma unroll 8
  for (int b = b0; b < b1; ++b) mine += blocks[b];
  int total;
  int rank = clip_scan(mine, s_warp, total);
  const int used = min(total, cap);
  for (int b = b0; b < b1 && mine > 0 && rank < cap; ++b) {
    int left = blocks[b];
    if (left == 0) continue;
    mine -= left;
    const long long lo = (long long)b * kSetupThreads;
    const int len = (int)min((long long)kSetupThreads, n - lo);
    // the block's straddle bytes 64 at a time: four independent 16-byte
    // loads (bytes one by one past the mask's end), then their set bytes
    for (int at = 0; at < len && left > 0 && rank < cap; at += 64) {
      unsigned words[16];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int off = at + 16 * v;
        if (off + 16 <= len) {
          const uint4 x = *reinterpret_cast<const uint4*>(straddle + lo + off);
          words[4 * v] = x.x, words[4 * v + 1] = x.y;
          words[4 * v + 2] = x.z, words[4 * v + 3] = x.w;
        } else {
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            unsigned word = 0;
            for (int k = 0; k < 4 && off + 4 * w + k < len; ++k)
              word |= (unsigned)straddle[lo + off + 4 * w + k] << (8 * k);
            words[4 * v + w] = word;
          }
        }
      }
#pragma unroll
      for (int w = 0; w < 16; ++w) {
        for (unsigned word = words[w]; word != 0 && left > 0 && rank < cap;
             word &= word - 1) {
          s_idx[rank++] = (int)(lo + at + 4 * w + ((__ffs(word) - 1) >> 3));
          --left;
        }
      }
    }
  }
  for (int k = used + tid; k < cap; k += kClipThreads) s_idx[k] = (int)n;
  if (tid == 0) *n_straddle = total;
  __syncthreads();                     // the slots, written by the block

  // ------------------------------------------------------- the clip
  int written = 0;
  for (int k0 = 0; k0 < used; k0 += kClipThreads) {
    const int k = k0 + tid;
    ClipTri ta, tb;
    bool live_a = false, live_b = false;
    if (k < used) {
      // nearclip.gather_tri_verts_t (a used slot's index is below n)
      const long long i = s_idx[k];
      const long long p = i / ncell, rem = i % ncell;
      const long long qq = rem / gg, j = rem % gg, lim = gg - 1;
      const long long a01 = min(j + 1, lim), a10 = min(j + g, lim);
      const long long a11 = min(j + g + 1, lim);
      const long long vi[3] = {p == 0 ? j : a01, a10, p == 0 ? a01 : a11};
      float vc[3][4], vn[3][3], f[3];
      bool in[3];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const long long at = qq * gg + vi[t];
        const float4 c = reinterpret_cast<const float4*>(clip)[at];
        vc[t][0] = c.x, vc[t][1] = c.y, vc[t][2] = c.z, vc[t][3] = c.w;
        vn[t][0] = normal[at * 3], vn[t][1] = normal[at * 3 + 1];
        vn[t][2] = normal[at * 3 + 2];
        f[t] = vc[t][2] + vc[t][3];
        in[t] = f[t] > 0.0f;
      }
      // nearclip.clip_expand: rotate the lone vertex (the one inside when
      // one is, else the one outside) to position 0
      const int cnt = in[0] + in[1] + in[2];
      const int first_in = in[0] ? 0 : (in[1] ? 1 : 2);
      const int first_out = !in[0] ? 0 : (!in[1] ? 1 : 2);
      const int r0 = cnt == 1 ? first_in : first_out;
      const int r1 = r0 == 2 ? 0 : r0 + 1, r2 = r0 == 0 ? 2 : r0 - 1;
      const bool usable = cnt == 1 || cnt == 2;
      const float f0 = f[r0], f1 = f[r1], f2 = f[r2];
      const float t01 = usable ? f0 / (f0 - f1) : 0.0f;
      const float t20 = usable ? f2 / (f2 - f0) : 0.0f;
      float i01c[4], i20c[4], i01n[3], i20n[3];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        i01c[a] = vc[r0][a] + (vc[r1][a] - vc[r0][a]) * t01;
        i20c[a] = vc[r2][a] + (vc[r0][a] - vc[r2][a]) * t20;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        i01n[a] = vn[r0][a] + (vn[r1][a] - vn[r0][a]) * t01;
        i20n[a] = vn[r2][a] + (vn[r0][a] - vn[r2][a]) * t20;
      }
      const bool one = cnt == 1;
      float ac[3][4], an[3][3], bc[3][4], bn[3][3];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ac[0][a] = one ? vc[r0][a] : i01c[a];
        ac[1][a] = one ? i01c[a] : vc[r1][a];
        ac[2][a] = one ? i20c[a] : vc[r2][a];
        bc[0][a] = i01c[a], bc[1][a] = vc[r2][a], bc[2][a] = i20c[a];
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        an[0][a] = one ? vn[r0][a] : i01n[a];
        an[1][a] = one ? i01n[a] : vn[r1][a];
        an[2][a] = one ? i20n[a] : vn[r2][a];
        bn[0][a] = i01n[a], bn[1][a] = vn[r2][a], bn[2][a] = i20n[a];
      }
      ta = clip_tri(ac, an, usable, width, height, wmax, hmax, has_far,
                    far_w, far_ilim);
      tb = clip_tri(bc, bn, cnt == 2, width, height, wmax, hmax, has_far,
                    far_w, far_ilim);
      live_a = ta.t.live;
      live_b = tb.t.live;
    }
    int chunk;
    int at = written + clip_scan(live_a + live_b, s_warp, chunk);
    if (live_a) clip_record(ta, recs + (long long)at++ * 32);
    if (live_b) clip_record(tb, recs + (long long)at * 32);
    written += chunk;
  }
  if (tid == 0) *rec_count = written;
}

}  // namespace

// clip (Q, G, G, 4) f32, normal (Q, G, G, 3) f32, valid (Q, G, G) bool,
// cell_ok (2, G, G) bool, count: one int32 on the card or null; tm
// (32, 2 Q G G) f32, straddle (2 Q G G) bool, blocks (ceil(2 Q G G /
// 256),) int32: each 256 candidates' straddlers; route: K6's scratch of
// route_ints int32 words, 16-byte aligned (coverage_cuda.route_scratch_ints:
// two mask words a warp of candidates, then two counts a block), whose
// route C1 writes with max_span as the span class's limit. far_w <= 0: no
// far clip.
extern "C" int planet_setup(const void* clip, const void* normal,
                            const void* valid, const void* cell_ok,
                            const void* count, int q, int g, int width,
                            int height, float far_w, float far_ilim,
                            int max_span, void* tm, void* straddle,
                            void* blocks, void* route, int route_ints,
                            void* stream) {
  if (q < 0 || g <= 0 || width <= 0 || height <= 0
      || ((size_t)clip & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long n = 2LL * q * g * g;
  if (n == 0) return (int)cudaSuccess;
  const long long nb = (n + kSetupThreads - 1) / kSetupThreads;
  const long long mask_words = nb * 2 * kSetupWarps;
  if (route == nullptr || route_ints < mask_words + 2 * nb
      || ((size_t)route & 15) != 0)
    return (int)cudaErrorInvalidValue;
  setup_kernel<<<(unsigned)nb, kSetupThreads, 0, (cudaStream_t)stream>>>(
      (const float*)clip, (const float*)normal, (const unsigned char*)valid,
      (const unsigned char*)cell_ok, (const int*)count, q, g, (float)width,
      (float)height, width - 1, height - 1, far_w > 0.0f, far_w, far_ilim,
      max_span, (float*)tm, (unsigned char*)straddle, (int*)blocks,
      (unsigned*)route, (int*)route + mask_words);
  return (int)cudaGetLastError();
}

// clip (Q, G, G, 4) f32, normal (Q, G, G, 3) f32 (Q > 0), straddle
// (2 Q G G) bool, 16-byte aligned, and blocks (C1's outputs) -> s_idx
// (cap,) int32 (the first cap straddlers' candidate indices, 2 Q G G in
// the empty slots), n_straddle (1,) int32 (all the straddlers), recs
// (2 cap, 32) f32, 16-byte aligned, whose first rec_count[0] rows are the
// live clipped records in (slot, A, B) order. far_w <= 0: no far clip.
extern "C" int planet_clip_records(const void* clip, const void* normal,
                                   const void* straddle, const void* blocks,
                                   int cap, int q, int g, int width,
                                   int height, float far_w, float far_ilim,
                                   void* s_idx, void* n_straddle, void* recs,
                                   void* rec_count, void* stream) {
  const long long n = 2LL * q * g * g;
  if (cap < 0 || q <= 0 || g <= 0 || width <= 0 || height <= 0
      || n > 0x7fffffffLL || ((size_t)clip & 15) != 0
      || ((size_t)straddle & 15) != 0 || ((size_t)recs & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int nb = (int)((n + kSetupThreads - 1) / kSetupThreads);
  clip_kernel<<<1, kClipThreads, 0, (cudaStream_t)stream>>>(
      (const float*)clip, (const float*)normal,
      (const unsigned char*)straddle, (const int*)blocks, nb, cap, q, g,
      (float)width, (float)height, width - 1, height - 1, far_w > 0.0f,
      far_w, far_ilim, (int*)s_idx, (int*)n_straddle, (float*)recs,
      (int*)rec_count);
  return (int)cudaGetLastError();
}
