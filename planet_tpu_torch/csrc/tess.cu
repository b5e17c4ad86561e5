// V1: the vertex program and its shade as one kernel. For every patch row
// q of a batch of Q leaf quads and every vertex of its dense (G, G) grid:
// the spherical interpolation between the quad's four corner (p, n) pairs,
// the height from the quad's (dim, dim) tile through the two-tap blend
// table, the skirt drop, the central-difference normal in the TBN frame,
// the clip transform, and the vertex's Lambert shade.
//
// planet_tpu does this inside its one-jit geometry step
// (engine/device_step.py:273-279; tess/vertex.py:148 tessellate_blend and
// :232 _assemble; raster/shade.py lambert), fused by XLA, not in Pallas; so
// V1 replaces no TPU kernel. As torch ops it was six batched GEMMs for the
// blend, one for the clip transform and some 200 elementwise launches over
// 512 x 32 x 32 vertices: the fused frame's largest stage (PERF.md).
// Plain PyTorch version: planet_tpu_torch/tess/vertex_cuda.py:
// tessellate_shaded_plain (vertex.tessellate_blend, pinned op for op, and
// the pinned lambert), which V1 equals bit for bit in every output; the
// wrapper is vertex_cuda.tessellate_shaded.
//
// Bound: bytes. A vertex writes 15 floats (clip 4, world, normal and
// snormal 3 each, height, shade) and reads one texel; its arithmetic (the
// interpolation, the blends, the normals, the clip transform and the
// shade) is ~180 operations where the interpolation takes the linear
// fallback and ~400 where it takes the slerp, with its acos, three sin, a
// cos and two tan (tools/common.tess_work); a padding row's is its
// height's blends. On the fused frame's 512 rows (210 live at 1080p) the
// bytes, 33.6 MB, take 0.0100 ms at the card's rate.
//
// Design: two blocks a patch row (kParts), 256 threads, each block half
// of the row's grid rows. The block stages the row's tile, its two
// variants' taps, its corners, the skirt, the view-projection and the
// grid's u values in shared memory. Then warps 0-1 evaluate interpolate's
// row endpoints (pa, na) and (pb, nb) of each column, which depend only on
// (q, u), while warps 2-7 form the three x-blended (dim, G) arrays (taps
// 0, 1, 2 of the x variant); then lane c of warp 0 hoists the terms of
// column c's interpolations that do not depend on the row (the branch,
// the differences, acos, tan and 1 / sin of the half angle, the half chord
// and its length, the row direction and the tangent scale): the same ops
// on the same values, once a column. Then lane c of warp w takes column c
// of grid rows w, w + 8, ...: its vertices share one branch, so they run
// side by side, and no index is divided. The clip store is 16 bytes a
// lane, height and shade 4, each coalesced across the warp; world, normal
// and snormal 4-byte stores at a 12-byte stride. Measured and dropped
// (PERF.md): staging world, normal and snormal in shared memory for
// 16-byte stores (within 5 % either way), 1 or 4 blocks a row in place of
// 2, the live and padding rows interleaved in the grid (the long live
// blocks then start late), a 100 % shared-memory carveout (no change).
//
// Padding rows: a row whose corner normals hold a NaN (the fused frame's
// rows past its leaf count: zero DF corners, so 0 / 0) has NaN column
// endpoints on at least one side, so every interpolation in it takes the
// slerp on a NaN dot and every output but the height is NaN; the card's
// f32 arithmetic gives one NaN word whatever its operands, 0x7fffffff.
// The block tests its staged corner normals (one __syncthreads_or) and on
// such a row computes the height alone (the tap-1 blends of the tile,
// minus the skirt) and fills the five other outputs with that word in
// 16-byte stores, with no interpolation. On the fused frame at 1080p 302
// of the 512 rows are padding, and their NaN slerps (acos, three sin, a
// cos, two tan a vertex, with sin's and tan's long argument reduction on
// NaN) were most of the kernel's time (PERF.md).

// Rows mode (kFromRows, entry planet_tess_rows): the fused step's form. In
// place of the uniforms (corners, corner normals, variants and skirt, which
// U1 would write to memory for V1 to read back) the block reads the row's
// id words, crop flag and depth, its lane-major DF corners and the camera,
// first thing and by read-only loads (their latency then overlaps the
// tile's; plain loads were measured 2-6 % slower, PERF.md), and computes
// those values into the same shared arrays with U1's arithmetic
// (uniforms.cuh): every thread the variants, thread c 3 + a corner c's
// camera-relative position and normal on axis a (its corner's root
// computed by three threads side by side), thread 0 the skirt. Both
// blocks of a row compute them for themselves. Everything past the
// staging is the same code: a padding row's zero DF corners give NaN
// normals (0 / 0), which the padding test finds as before. So the fused
// step launches no U1, and its values never leave the SM (PERF.md).

// Wide rows (BASELINE config 3's 64-vertex patches: a 66 x 66 grid and
// 66 x 66 tiles, kWideGrid): the rows mode only, as the instance
// tess_kernel<kWideGrid, kWideDim, 1, true>. A 66-wide row does not fit
// a lane a column, and the whole tile and its three x-blended arrays
// would take 70 KB of shared memory, so a patch row is three blocks of
// 256 threads (kWideParts), each a band of 22 grid rows: it stages only
// the tile rows its band's y taps read (the taps are nondecreasing along
// the grid, so the band's first and last rows bound them: at most
// kBandTex rows, which the CPU tests check for every variant), blends
// those, and its threads stride over the band's vertices in memory order
// (a thread a vertex at a time: row and column by a division by the
// compile-time width, each store coalesced across the warp). The column
// terms, the corners and the padding test are the narrow instance's code;
// every block computes its row's for itself. 42 KB of static shared
// memory a block.

// Bits: every rounding is the plain version's op, in its order: dots as
// x x + y y + z z, cross products as separate products and differences,
// the clip transform as ((m0 x + m1 y) + m2 z) + m3, the two-tap blends as
// fl(fl(T[a] w_a) + fl(T[b] w_b)). Built with -fmad=false -prec-div=true
// -prec-sqrt=true; acosf, sinf, cosf and tanf are the functions torch's
// CUDA kernels call for f32. Python's scalars round as torch rounds them:
// the clamp's 1 - 1e-6 and the fallback's and the shade's 0.001 are the
// f32 of the double, torch.clamp and clamp_min keep a NaN, and 1 / x is
// reciprocal(x) (x 1.0, exact). torch.where(use_lin, ...) selects a whole
// value, so the kernel evaluates only the branch it takes.

#include <cuda_runtime.h>
#include <math.h>

#include "uniforms.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kParts = 2;         // blocks a patch row
constexpr int kMaxGrid = 32;      // the narrow instances' grid and tile side
constexpr int kMaxDim = 32;
constexpr int kWideGrid = 66;     // the wide instance's, exactly
constexpr int kWideDim = 66;
constexpr int kWideParts = 3;     // its blocks (bands) a patch row
constexpr int kBandTex = 24;      // tile rows a band's y taps may read
constexpr float kClampHi = (float)(1.0 - 1e-6);
constexpr float kLinEps = (float)0.001;
constexpr float kShadeFloor = (float)0.001;

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// vertex._norm: v / sqrt(dot(v, v)), in place
__device__ __forceinline__ void norm3(float* v) {
  const float l = sqrtf(dot3(v, v));
  v[0] = v[0] / l;
  v[1] = v[1] / l;
  v[2] = v[2] / l;
}

// vertex._cross
__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// vertex.interpolate at parameter t: the branch torch.where takes
__device__ __forceinline__ void interpolate(const float* p0, const float* n0,
                                            const float* p1, const float* n1,
                                            float t, float* p, float* n) {
  const float d = dot3(n0, n1);
  if ((1.0f - d) < kLinEps) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      n[k] = n0[k] + (n1[k] - n0[k]) * t;
      p[k] = p0[k] + (p1[k] - p0[k]) * t;
    }
    norm3(n);
    return;
  }
  // torch.clamp: a NaN stays itself
  const float d_safe = d != d ? d : fminf(fmaxf(d, -1.0f), kClampHi);
  const float theta2 = acosf(d_safe);
  const float k = 1.0f - t;
  const float sa = sinf(k * theta2), sb = sinf(t * theta2);
#pragma unroll
  for (int j = 0; j < 3; ++j) n[j] = sa * n0[j] + sb * n1[j];
  norm3(n);
  const float theta = theta2 * 0.5f;
  const float gamma = theta - theta2 * t;
  const float tan_theta = tanf(theta);
  const float x = 1.0f - tanf(gamma) / tan_theta;
  const float y = 1.0f / sinf(theta) - 1.0f / (cosf(gamma) * tan_theta);
  float half[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) half[j] = (p1[j] - p0[j]) * 0.5f;
  const float hlen = sqrtf(dot3(half, half));
#pragma unroll
  for (int j = 0; j < 3; ++j) p[j] = (p0[j] + x * half[j]) + (y * n[j]) * hlen;
}

template <int kGrid>
struct Taps {
  int a[3][kGrid], b[3][kGrid];
  float wa[3][kGrid], wb[3][kGrid];
};

// The NaN word of the card's f32 arithmetic, whatever the operands' words
constexpr unsigned kNaNWord = 0x7fffffffu;

// out[0, n) = the NaN word, by the block's threads: 16-byte stores where
// out is 16-byte aligned (every row of a 32 x 32 grid, every band of a
// 66 x 66 one), else 4-byte stores
__device__ __forceinline__ void fill_nan(float* __restrict__ out, int n) {
  const float nan = __uint_as_float(kNaNWord);
  int done = 0;
  if (((size_t)out & 15) == 0) {
    const int n4 = n >> 2;
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int i = threadIdx.x; i < n4; i += kThreads)
      o4[i] = make_float4(nan, nan, nan, nan);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) out[i] = nan;
}

// The terms of interpolate(pa, na, pb, nb, t) that do not depend on t, for
// one column of a row: its endpoints, the branch, the differences, the
// tangent scale (the row's length over its `quads`, the patch's quads:
// the grid less 3), and on the slerp branch the angle terms and the half
// chord
struct Column {
  float pa[3], na[3], nb[3], dn[3], row_dir[3], half[3];
  float theta2, theta, tan_theta, inv_sin, hlen, xyscale;
  int lin;
};

__device__ __forceinline__ void column_terms(const float* pa, const float* na,
                                             const float* pb, const float* nb,
                                             float quads, Column& o) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.pa[k] = pa[k];
    o.na[k] = na[k];
    o.nb[k] = nb[k];
    o.dn[k] = nb[k] - na[k];
    o.row_dir[k] = pb[k] - pa[k];
    o.half[k] = o.row_dir[k] * 0.5f;
  }
  o.xyscale = sqrtf(dot3(o.row_dir, o.row_dir)) / quads;
  const float d = dot3(na, nb);
  o.lin = (1.0f - d) < kLinEps;
  if (!o.lin) {
    // torch.clamp: a NaN stays itself
    const float d_safe = d != d ? d : fminf(fmaxf(d, -1.0f), kClampHi);
    o.theta2 = acosf(d_safe);
    o.theta = o.theta2 * 0.5f;
    o.tan_theta = tanf(o.theta);
    o.inv_sin = 1.0f / sinf(o.theta);
    o.hlen = sqrtf(dot3(o.half, o.half));
  }
}

// interpolate at t from a column's terms: the ops of interpolate() past
// those terms, in its order
__device__ __forceinline__ void interpolate_at(const Column& o, float t,
                                               float* p, float* n) {
  if (o.lin) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      n[k] = o.na[k] + o.dn[k] * t;
      p[k] = o.pa[k] + o.row_dir[k] * t;
    }
    norm3(n);
    return;
  }
  const float k1 = 1.0f - t;
  const float sa = sinf(k1 * o.theta2), sb = sinf(t * o.theta2);
#pragma unroll
  for (int j = 0; j < 3; ++j) n[j] = sa * o.na[j] + sb * o.nb[j];
  norm3(n);
  const float gamma = o.theta - o.theta2 * t;
  const float x = 1.0f - tanf(gamma) / o.tan_theta;
  const float y = o.inv_sin - 1.0f / (cosf(gamma) * o.tan_theta);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    p[j] = (o.pa[j] + x * o.half[j]) + (y * n[j]) * o.hlen;
}

// A live vertex's outputs from its column's terms, its interpolated
// position p and normal nv, its five blended heights (the centre tap and
// the y and x neighbours) and its skirt flag, written at vertex v
__device__ __forceinline__ void finish_vertex(
    const Column& o, const float* p, const float* nv, float hgt, float y0,
    float y1, float x0, float x1, float sk, float skirt_q, const float* m,
    float lx, float ly, float lz, long long v, float* __restrict__ clip_out,
    float* __restrict__ world_out, float* __restrict__ normal_out,
    float* __restrict__ height_out, float* __restrict__ snormal_out,
    float* __restrict__ shade_out) {
  const float height = hgt - skirt_q * sk;

  float nt[3] = {x0 - x1, 2.0f * o.xyscale, y0 - y1};
  norm3(nt);
  float tv[3], bi[3], nrm[3];
  cross3(nv, o.row_dir, tv);
  norm3(tv);
  cross3(tv, nv, bi);
  norm3(bi);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    nrm[j] = (tv[j] * nt[0] + nv[j] * nt[1]) + bi[j] * nt[2];
  norm3(nrm);

  float w[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) w[j] = p[j] + nv[j] * height;
  float cl[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    cl[j] = ((m[4 * j] * w[0] + m[4 * j + 1] * w[1]) + m[4 * j + 2] * w[2])
            + m[4 * j + 3];

  // the pinned lambert
  float sn[3] = {nrm[0], nrm[1], nrm[2]};
  norm3(sn);
  const float s = (sn[0] * lx + sn[1] * ly) + sn[2] * lz;
  const float shade = sqrtf(kShadeFloor + (s != s ? s : fmaxf(s, 0.0f)));

  reinterpret_cast<float4*>(clip_out)[v] =
      make_float4(cl[0], cl[1], cl[2], cl[3]);
  height_out[v] = height;
  shade_out[v] = shade;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    world_out[v * 3 + j] = w[j];
    normal_out[v * 3 + j] = nrm[j];
    snormal_out[v * 3 + j] = nv[j];
  }
}

// Rows mode's inputs: U1's, for the batch's q rows (null in the uniforms
// mode)
struct Words {
  const int* q_lo;
  const int* q_hi;
  const unsigned char* crop;
  const int* depth;
  const float* c_hi;       // (12, q): row 3 c + a is corner c's axis a
  const float* c_lo;
  const float* cam_hi;     // (3,)
  const float* cam_lo;
  float max_skirt;
};

// The row's words, and thread 3 c + a's corner c and camera axis a, read
// before anything is staged, by read-only loads (words' pointers carry no
// __restrict__, so plain loads through them would wait behind the
// staging's shared-memory stores); nq rows in the batch
struct RowWords {
  int lo = 0, hi = 0, depth = 0;
  unsigned char crop = 0;
  float cnrm[3] = {0.0f, 0.0f, 0.0f}, own_h = 0.0f, own_l = 0.0f;
  float cam_h = 0.0f, cam_l = 0.0f;
};

__device__ __forceinline__ RowWords read_words(const Words& words, int q,
                                               int nq, int tid) {
  RowWords w;
  w.lo = __ldg(words.q_lo + q);
  w.hi = __ldg(words.q_hi + q);
  w.crop = __ldg(words.crop + q);
  if (tid == 0) w.depth = __ldg(words.depth + q);
  if (tid < 12) {
    const int c = tid / 3, a = tid - 3 * c;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int at = (3 * c + k) * nq + q;
      const float h = __ldg(words.c_hi + at), l = __ldg(words.c_lo + at);
      w.cnrm[k] = h + l;
      if (k == a) w.own_h = h, w.own_l = l;     // word 3 c + a, tid's own
    }
    w.cam_h = __ldg(words.cam_hi + a);
    w.cam_l = __ldg(words.cam_lo + a);
  }
  return w;
}

// Block b takes grid rows [r0, r1) of patch row b / kParts, its half
// b % kParts of them; lane c of warp w takes column c of rows r0 + w,
// r0 + w + 8, ..., at most kRows of them (kRows 8-row groups). The fused
// frame's live rows come first, so its longest blocks start first.
// kFromRows: the row's uniforms from `words`, else from corners,
// corner_normals, vx, vy and skirt. kGrid and kDim: the largest grid and
// tile side (kMaxGrid, kMaxDim), g and dim at most those; the wide
// instance (kGrid = kWideGrid) is the band layout above, at g = kGrid and
// dim = kDim exactly, rows mode only.
template <int kGrid, int kDim, int kRows, bool kFromRows>
__global__ void __launch_bounds__(kThreads)
tess_kernel(const Words words, const float* __restrict__ corners,
            const float* __restrict__ corner_normals,
            const float* __restrict__ tiles, const int* __restrict__ vx,
            const int* __restrict__ vy, const float* __restrict__ skirt,
            const float* __restrict__ view_proj,
            const int* __restrict__ tap_idx, const float* __restrict__ tap_w,
            const float* __restrict__ u_table, int g, int dim, float lx,
            float ly, float lz,
            float* __restrict__ clip_out, float* __restrict__ world_out,
            float* __restrict__ normal_out, float* __restrict__ height_out,
            float* __restrict__ snormal_out, float* __restrict__ shade_out) {
  constexpr int kWarps = kThreads / 32;
  if constexpr (kGrid > kMaxGrid) {
    static_assert(kFromRows, "the wide instance runs the rows mode alone");
    constexpr int kBand = (kGrid + kWideParts - 1) / kWideParts;
    __shared__ float tex[kBandTex * kDim];          // the band's tile rows
    __shared__ float xbl[3][kBandTex][kGrid];       // x-blended, taps 0-2
    __shared__ float colp[2][kGrid][3], coln[2][kGrid][3];
    __shared__ Column col[kGrid];
    __shared__ Taps<kGrid> tx, ty;
    __shared__ float cp[4][3], cn[4][3], m[16], u[kGrid];
    __shared__ float skirt_q;

    const int q = blockIdx.x / kWideParts, tid = threadIdx.x;
    const int r0 = (blockIdx.x - q * kWideParts) * kBand;
    const int r1 = min(kGrid, r0 + kBand), band = (r1 - r0) * kGrid;
    const long long v0 = (long long)q * kGrid * kGrid;
    const RowWords rw = read_words(words, q, gridDim.x / kWideParts, tid);
    int var_x, var_y;
    uniforms_core::crop_variants(rw.lo, rw.hi, rw.crop != 0, &var_x,
                                 &var_y);
    // the band's tile rows [y_lo, y_lo + ny): the y taps of its first and
    // last grid rows bound those of the rows between
    int y_lo = kDim, y_hi = -1;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int* row = tap_idx + (var_y * 3 + t) * kGrid * 2;
      y_lo = min(y_lo, __ldg(row + r0 * 2));
      y_hi = max(y_hi, __ldg(row + (r1 - 1) * 2 + 1));
    }
    const int ny = y_hi - y_lo + 1;
    if (ny > kBandTex) __trap();
    const float* src = tiles + (long long)q * kDim * kDim + y_lo * kDim;
    for (int i = tid; i < ny * kDim; i += kThreads) tex[i] = src[i];
    for (int i = tid; i < 2 * 3 * kGrid; i += kThreads) {
      const int axis = i / (3 * kGrid), rem = i - axis * 3 * kGrid;
      const int tap = rem / kGrid, o = rem - tap * kGrid;
      const int var = axis ? var_y : var_x;
      const int at = ((var * 3 + tap) * kGrid + o) * 2;
      Taps<kGrid>& t = axis ? ty : tx;
      t.a[tap][o] = tap_idx[at], t.b[tap][o] = tap_idx[at + 1];
      t.wa[tap][o] = tap_w[at], t.wb[tap][o] = tap_w[at + 1];
    }
    float cn_word = 0.0f;
    if (tid < 12) {
      const int c = tid / 3, a = tid - 3 * c;
      // U1's (row, corner) work for one axis
      const float len = uniforms_core::normal_len(rw.cnrm);
      cn_word = (a == 0 ? rw.cnrm[0] : a == 1 ? rw.cnrm[1] : rw.cnrm[2])
                / len;
      cp[c][a] = uniforms_core::df_sub_hi(rw.own_h, rw.own_l, rw.cam_h,
                                          rw.cam_l);
      cn[c][a] = cn_word;
    }
    if (tid < 16) m[tid] = view_proj[tid];
    if (tid < kGrid) u[tid] = u_table[tid];
    if (tid == 0) skirt_q = uniforms_core::skirt_of(rw.depth, words.max_skirt);
    const bool pad = __syncthreads_or(cn_word != cn_word);

    // the first 2 kGrid threads: interpolate's row endpoints; the warps
    // past theirs (every thread on a padding row): the x blends of the
    // band's tile rows (a padding row's height needs tap 1 alone)
    if (!pad && tid < 2 * kGrid) {
      const int side = tid / kGrid, c = tid - side * kGrid;
      interpolate(cp[2 * side], cn[2 * side], cp[2 * side + 1],
                  cn[2 * side + 1], u[c], colp[side][c], coln[side][c]);
    }
    const int first = pad ? 0 : (2 * kGrid + 31) / 32 * 32;
    if (tid >= first) {
      for (int tap = pad ? 1 : 0; tap < (pad ? 2 : 3); ++tap)
        for (int i = tid - first; i < ny * kGrid; i += kThreads - first) {
          const int yy = i / kGrid, o = i - yy * kGrid;
          const int a = tx.a[tap][o], b = tx.b[tap][o];
          xbl[tap][yy][o] = tex[yy * kDim + a] * tx.wa[tap][o]
                            + tex[yy * kDim + b] * tx.wb[tap][o];
        }
    }
    __syncthreads();

    if (pad) {
      for (int i = tid; i < band; i += kThreads) {
        const int r = r0 + i / kGrid, c = i - (r - r0) * kGrid;
        const int a1 = ty.a[1][r] - y_lo, b1 = ty.b[1][r] - y_lo;
        const float hgt = xbl[1][a1][c] * ty.wa[1][r]
                          + xbl[1][b1][c] * ty.wb[1][r];
        const float sk = (r == 0 || r == kGrid - 1 || c == 0
                          || c == kGrid - 1) ? 1.0f : 0.0f;
        height_out[v0 + r * kGrid + c] = hgt - skirt_q * sk;
      }
      const long long at = v0 + (long long)r0 * kGrid;
      fill_nan(clip_out + at * 4, band * 4);
      fill_nan(world_out + at * 3, band * 3);
      fill_nan(normal_out + at * 3, band * 3);
      fill_nan(snormal_out + at * 3, band * 3);
      fill_nan(shade_out + at, band);
      return;
    }
    if (tid < kGrid)
      column_terms(colp[0][tid], coln[0][tid], colp[1][tid], coln[1][tid],
                   (float)(kGrid - 3), col[tid]);
    __syncthreads();
    for (int i = tid; i < band; i += kThreads) {
      const int r = r0 + i / kGrid, c = i - (r - r0) * kGrid;
      const Column& o = col[c];
      float p[3], nv[3];
      interpolate_at(o, u[r], p, nv);
      // the y blends of the x-blended arrays
      const int a0 = ty.a[0][r] - y_lo, b0 = ty.b[0][r] - y_lo;
      const int a1 = ty.a[1][r] - y_lo, b1 = ty.b[1][r] - y_lo;
      const int a2 = ty.a[2][r] - y_lo, b2 = ty.b[2][r] - y_lo;
      const float w0a = ty.wa[0][r], w0b = ty.wb[0][r];
      const float w1a = ty.wa[1][r], w1b = ty.wb[1][r];
      const float w2a = ty.wa[2][r], w2b = ty.wb[2][r];
      const float hgt = xbl[1][a1][c] * w1a + xbl[1][b1][c] * w1b;
      const float y0 = xbl[1][a0][c] * w0a + xbl[1][b0][c] * w0b;
      const float y1 = xbl[1][a2][c] * w2a + xbl[1][b2][c] * w2b;
      const float x0 = xbl[0][a1][c] * w1a + xbl[0][b1][c] * w1b;
      const float x1 = xbl[2][a1][c] * w1a + xbl[2][b1][c] * w1b;
      const float sk = (r == 0 || r == kGrid - 1 || c == 0 || c == kGrid - 1)
                           ? 1.0f : 0.0f;
      finish_vertex(o, p, nv, hgt, y0, y1, x0, x1, sk, skirt_q, m, lx, ly,
                    lz, v0 + r * kGrid + c, clip_out, world_out, normal_out,
                    height_out, snormal_out, shade_out);
    }
  } else {
    __shared__ float tile[kDim * kDim];
    __shared__ float xbl[3][kDim][kGrid];     // x-blended, taps 0-2
    __shared__ float colp[2][kGrid][3], coln[2][kGrid][3];
    __shared__ Column col[kGrid];
    __shared__ Taps<kGrid> tx, ty;
    __shared__ float cp[4][3], cn[4][3], m[16], u[kGrid];
    __shared__ float skirt_q;
    const int q = blockIdx.x / kParts, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int rows = (g + kParts - 1) / kParts;
    const int r0 = (blockIdx.x - q * kParts) * rows, r1 = min(g, r0 + rows);
    if (r0 >= r1) return;                            // g = 1: one row
    const long long v0 = (long long)q * g * g;       // the row's first vertex
    // rows mode: the row's words and corners, read first
    RowWords rw;
    if (kFromRows) rw = read_words(words, q, gridDim.x / kParts, tid);
    for (int i = tid; i < dim * dim; i += kThreads)
      tile[i] = tiles[(long long)q * dim * dim + i];
    // the row's variants' taps, taken as the plain version's idx[variant]
    // takes them: -3..-1 count from the end of the table; any other value
    // outside {0, 1, 2} stops the kernel, as the plain version's index
    // raises on the CPU and asserts on the card. Each entry is read for all
    // three variants, so these reads need not wait for the variant's.
    int var_x, var_y;
    if (kFromRows)
      uniforms_core::crop_variants(rw.lo, rw.hi, rw.crop != 0, &var_x,
                                   &var_y);
    else
      var_x = vx[q], var_y = vy[q];
    for (int i = tid; i < 2 * 3 * g; i += kThreads) {
      const int axis = i / (3 * g), rem = i - axis * 3 * g;
      const int tap = rem / g, o = rem - tap * g;
      int ia[3], ib[3];
      float wa[3], wb[3];
  #pragma unroll
      for (int v = 0; v < 3; ++v) {
        const int at = ((v * 3 + tap) * g + o) * 2;
        ia[v] = tap_idx[at], ib[v] = tap_idx[at + 1];
        wa[v] = tap_w[at], wb[v] = tap_w[at + 1];
      }
      const int var = axis ? var_y : var_x;
      const int sel = var == 0 || var == -3 ? 0 : var == 1 || var == -2 ? 1 : 2;
      Taps<kGrid>& t = axis ? ty : tx;
      t.a[tap][o] = sel == 0 ? ia[0] : sel == 1 ? ia[1] : ia[2];
      t.b[tap][o] = sel == 0 ? ib[0] : sel == 1 ? ib[1] : ib[2];
      t.wa[tap][o] = sel == 0 ? wa[0] : sel == 1 ? wa[1] : wa[2];
      t.wb[tap][o] = sel == 0 ? wb[0] : sel == 1 ? wb[1] : wb[2];
    }
    // rows mode's variants are 0-2 by construction
    if (!kFromRows && (var_x < -3 || var_x > 2 || var_y < -3 || var_y > 2))
      __trap();
    float cn_word = 0.0f;
    if (tid < 12) {
      const int c = tid / 3, a = tid - 3 * c;
      float p;
      if (kFromRows) {
        // U1's (row, corner) work for one axis
        const float len = uniforms_core::normal_len(rw.cnrm);
        cn_word = (a == 0 ? rw.cnrm[0] : a == 1 ? rw.cnrm[1] : rw.cnrm[2])
                  / len;
        p = uniforms_core::df_sub_hi(rw.own_h, rw.own_l, rw.cam_h, rw.cam_l);
      } else {
        cn_word = corner_normals[q * 12 + tid];
        p = corners[q * 12 + tid];
      }
      cp[c][a] = p;
      cn[c][a] = cn_word;
    }
    if (tid < 16) m[tid] = view_proj[tid];
    if (tid < g) u[tid] = u_table[tid];
    if (tid == 0)
      skirt_q = kFromRows ? uniforms_core::skirt_of(rw.depth, words.max_skirt)
                          : skirt[q];
    // a padding row: a NaN among its corner normals
    const bool pad = __syncthreads_or(cn_word != cn_word);

    // warps 0-1: interpolate's row endpoints at u (side 0 between corners 0
    // and 1, side 1 between corners 2 and 3); the other warps (all of them
    // on a padding row): the x blends, xbl[tap][y][o] = T[y][a] w_a +
    // T[y][b] w_b (a padding row's height needs tap 1 alone)
    const int blend_warp = pad ? 0 : 2;
    if (!pad && tid < 2 * g) {
      const int side = tid / g, c = tid - side * g;
      interpolate(cp[2 * side], cn[2 * side], cp[2 * side + 1],
                  cn[2 * side + 1], u[c], colp[side][c], coln[side][c]);
    }
    if (warp >= blend_warp && lane < g) {
      for (int tap = pad ? 1 : 0; tap < (pad ? 2 : 3); ++tap) {
        const int a = tx.a[tap][lane], b = tx.b[tap][lane];
        const float wa = tx.wa[tap][lane], wb = tx.wb[tap][lane];
        for (int yy = warp - blend_warp; yy < dim; yy += kWarps - blend_warp)
          xbl[tap][yy][lane] =
              tile[yy * dim + a] * wa + tile[yy * dim + b] * wb;
      }
    }
    __syncthreads();

    if (pad) {
      if (lane < g) {
        for (int r = r0 + warp; r < r1; r += kWarps) {
          const int a1 = ty.a[1][r], b1 = ty.b[1][r];
          const float hgt = xbl[1][a1][lane] * ty.wa[1][r]
                            + xbl[1][b1][lane] * ty.wb[1][r];
          const float sk = (r == 0 || r == g - 1 || lane == 0 || lane == g - 1)
                               ? 1.0f : 0.0f;
          height_out[v0 + r * g + lane] = hgt - skirt_q * sk;
        }
      }
      const long long at = v0 + (long long)r0 * g;
      const int n = (r1 - r0) * g;
      fill_nan(clip_out + at * 4, n * 4);
      fill_nan(world_out + at * 3, n * 3);
      fill_nan(normal_out + at * 3, n * 3);
      fill_nan(snormal_out + at * 3, n * 3);
      fill_nan(shade_out + at, n);
      return;
    }
    if (warp == 0 && lane < g)
      column_terms(colp[0][lane], coln[0][lane], colp[1][lane], coln[1][lane],
                   (float)(g - 3), col[lane]);
    __syncthreads();
    if (lane >= g) return;

    const int c = lane;
    const Column& o = col[c];
    float pv[kRows][3], nv[kRows][3];
  #pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = min(r0 + warp + k * kWarps, g - 1);
      interpolate_at(o, u[r], pv[k], nv[k]);
    }
  #pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = r0 + warp + k * kWarps;
      if (r >= r1) break;
      // the y blends of the x-blended arrays
      const int a0 = ty.a[0][r], b0 = ty.b[0][r];
      const int a1 = ty.a[1][r], b1 = ty.b[1][r];
      const int a2 = ty.a[2][r], b2 = ty.b[2][r];
      const float w0a = ty.wa[0][r], w0b = ty.wb[0][r];
      const float w1a = ty.wa[1][r], w1b = ty.wb[1][r];
      const float w2a = ty.wa[2][r], w2b = ty.wb[2][r];
      const float hgt = xbl[1][a1][c] * w1a + xbl[1][b1][c] * w1b;
      const float y0 = xbl[1][a0][c] * w0a + xbl[1][b0][c] * w0b;
      const float y1 = xbl[1][a2][c] * w2a + xbl[1][b2][c] * w2b;
      const float x0 = xbl[0][a1][c] * w1a + xbl[0][b1][c] * w1b;
      const float x1 = xbl[2][a1][c] * w1a + xbl[2][b1][c] * w1b;

      const float sk = (r == 0 || r == g - 1 || c == 0 || c == g - 1) ? 1.0f
                                                                       : 0.0f;
      finish_vertex(o, pv[k], nv[k], hgt, y0, y1, x0, x1, sk, skirt_q, m, lx,
                    ly, lz, v0 + r * g + c, clip_out, world_out, normal_out,
                    height_out, snormal_out, shade_out);
    }
  }
}

template <bool kFromRows>
int launch_tess(const Words& words, const void* corners,
                const void* corner_normals, const void* tiles, const void* vx,
                const void* vy, const void* skirt, const void* view_proj,
                const void* tap_idx, const void* tap_w, const void* u, int q,
                int g, int dim, float lx, float ly, float lz, void* clip,
                void* world, void* normal, void* height, void* snormal,
                void* shade, void* stream) {
  const bool wide = kFromRows && g == kWideGrid && dim == kWideDim;
  if (q < 0 || ((size_t)clip & 15) != 0
      || (!wide && (g <= 0 || g > kMaxGrid || dim <= 0 || dim > kMaxDim)))
    return (int)cudaErrorInvalidValue;
  if (q == 0) return (int)cudaSuccess;
  if constexpr (kFromRows) {
    if (wide) {
      tess_kernel<kWideGrid, kWideDim, 1, true>
          <<<q * kWideParts, kThreads, 0, (cudaStream_t)stream>>>(
              words, nullptr, nullptr, (const float*)tiles, nullptr, nullptr,
              nullptr, (const float*)view_proj, (const int*)tap_idx,
              (const float*)tap_w, (const float*)u, g, dim, lx, ly, lz,
              (float*)clip, (float*)world, (float*)normal, (float*)height,
              (float*)snormal, (float*)shade);
      return (int)cudaGetLastError();
    }
  }
  // the 8-row groups a warp takes: 1 or 2
  const auto kernel = (g + kParts - 1) / kParts > 8
                          ? tess_kernel<kMaxGrid, kMaxDim, 2, kFromRows>
                          : tess_kernel<kMaxGrid, kMaxDim, 1, kFromRows>;
  kernel<<<q * kParts, kThreads, 0, (cudaStream_t)stream>>>(
      words, (const float*)corners, (const float*)corner_normals,
      (const float*)tiles, (const int*)vx, (const int*)vy,
      (const float*)skirt, (const float*)view_proj, (const int*)tap_idx,
      (const float*)tap_w, (const float*)u, g, dim, lx, ly, lz,
      (float*)clip, (float*)world, (float*)normal, (float*)height,
      (float*)snormal, (float*)shade);
  return (int)cudaGetLastError();
}

}  // namespace

// corners and corner_normals (Q, 4, 3) f32, tiles (Q, dim, dim) f32,
// vx and vy (Q,) int32 in {0, 1, 2}, skirt (Q,) f32, view_proj (4, 4) f32,
// tap_idx (3, 3, G, 2) int32 and tap_w (3, 3, G, 2) f32 (vertex.blend_taps),
// u (G,) f32 (the grid's u values); light (lx, ly, lz); outputs clip (Q, G,
// G, 4), 16-byte aligned, world, normal and snormal (Q, G, G, 3), height
// and shade (Q, G, G), all f32. G and dim at most 32.
extern "C" int planet_tess(const void* corners, const void* corner_normals,
                           const void* tiles, const void* vx, const void* vy,
                           const void* skirt, const void* view_proj,
                           const void* tap_idx, const void* tap_w,
                           const void* u, int q, int g, int dim, float lx,
                           float ly, float lz, void* clip, void* world,
                           void* normal, void* height, void* snormal,
                           void* shade, void* stream) {
  return launch_tess<false>(Words{}, corners, corner_normals, tiles, vx, vy,
                            skirt, view_proj, tap_idx, tap_w, u, q, g, dim,
                            lx, ly, lz, clip, world, normal, height, snormal,
                            shade, stream);
}

// Rows mode: U1's inputs in place of the uniforms — q_lo, q_hi, depth (Q,)
// int32, crop (Q,) bool, c_hi, c_lo (12, Q) f32 lane-major DF corners (row
// 3 c + a: corner c's axis a), cam_hi, cam_lo (3,) f32, max_skirt — and the
// rest as planet_tess; G and dim at most 32, or both 66 (the wide
// instance).
extern "C" int planet_tess_rows(const void* q_lo, const void* q_hi,
                                const void* crop, const void* depth,
                                const void* c_hi, const void* c_lo,
                                const void* cam_hi, const void* cam_lo,
                                float max_skirt, const void* tiles,
                                const void* view_proj, const void* tap_idx,
                                const void* tap_w, const void* u, int q,
                                int g, int dim, float lx, float ly, float lz,
                                void* clip, void* world, void* normal,
                                void* height, void* snormal, void* shade,
                                void* stream) {
  const Words words{(const int*)q_lo, (const int*)q_hi,
                    (const unsigned char*)crop, (const int*)depth,
                    (const float*)c_hi, (const float*)c_lo,
                    (const float*)cam_hi, (const float*)cam_lo, max_skirt};
  return launch_tess<true>(words, nullptr, nullptr, tiles, nullptr, nullptr,
                           nullptr, view_proj, tap_idx, tap_w, u, q, g, dim,
                           lx, ly, lz, clip, world, normal, height, snormal,
                           shade, stream);
}
