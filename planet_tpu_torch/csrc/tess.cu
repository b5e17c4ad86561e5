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
// cos and two tan (tools/common.tess_work): on the fused frame's 512 rows
// half the time of its 33.6 MB at the card's rates.
//
// Design: a block a patch row, 256 threads. The block stages the row's
// tile, its two variants' taps from the table, its corners, the skirt, the
// view-projection and the grid's u values in shared memory. Then its
// threads form the three x-blended (dim, G) arrays (taps 0, 1, 2 of the x
// variant) and, on the first 2 G threads, interpolate's row endpoints
// (pa, na) and (pb, nb) of each column, which depend only on (q, u): one
// evaluation a column instead of one a vertex, the same bits. Then a thread
// a vertex (four a thread) runs the rest and writes the six outputs. The
// padding rows of the fused frame (NaN corner normals) are evaluated like
// any other and come out NaN, as the plain version's do.
//
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

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 32;
constexpr int kMaxDim = 32;
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

struct Taps {
  int a[3][kMaxGrid], b[3][kMaxGrid];
  float wa[3][kMaxGrid], wb[3][kMaxGrid];
};

__global__ void __launch_bounds__(kThreads)
tess_kernel(const float* __restrict__ corners,
            const float* __restrict__ corner_normals,
            const float* __restrict__ tiles, const int* __restrict__ vx,
            const int* __restrict__ vy, const float* __restrict__ skirt,
            const float* __restrict__ view_proj,
            const int* __restrict__ tap_idx, const float* __restrict__ tap_w,
            const float* __restrict__ u_table, int g, int dim, float lx,
            float ly, float lz, float* __restrict__ clip_out,
            float* __restrict__ world_out, float* __restrict__ normal_out,
            float* __restrict__ height_out, float* __restrict__ snormal_out,
            float* __restrict__ shade_out) {
  __shared__ float tile[kMaxDim * kMaxDim];
  __shared__ float xbl[3][kMaxDim][kMaxGrid];     // x-blended, taps 0-2
  __shared__ float colp[2][kMaxGrid][3], coln[2][kMaxGrid][3];
  __shared__ Taps tx, ty;
  __shared__ float cp[4][3], cn[4][3], m[16], u[kMaxGrid];
  __shared__ float skirt_q;

  const int q = blockIdx.x, tid = threadIdx.x;
  const int gg = g * g;
  for (int i = tid; i < dim * dim; i += kThreads)
    tile[i] = tiles[(long long)q * dim * dim + i];
  // the row's variants, taken as the plain version's idx[variant] takes
  // them: -3..-1 count from the end of the table; any other value outside
  // {0, 1, 2} stops the kernel, as the plain version's index raises on the
  // CPU and asserts on the card
  int var_x = vx[q], var_y = vy[q];
  if (var_x < -3 || var_x > 2 || var_y < -3 || var_y > 2) __trap();
  var_x += var_x < 0 ? 3 : 0;
  var_y += var_y < 0 ? 3 : 0;
  for (int i = tid; i < 2 * 3 * g; i += kThreads) {
    const int axis = i / (3 * g), rem = i - axis * 3 * g;
    const int tap = rem / g, o = rem - tap * g;
    const int at = (((axis ? var_y : var_x) * 3 + tap) * g + o) * 2;
    Taps& t = axis ? ty : tx;
    t.a[tap][o] = tap_idx[at];
    t.b[tap][o] = tap_idx[at + 1];
    t.wa[tap][o] = tap_w[at];
    t.wb[tap][o] = tap_w[at + 1];
  }
  if (tid < 12) {
    cp[tid / 3][tid % 3] = corners[q * 12 + tid];
    cn[tid / 3][tid % 3] = corner_normals[q * 12 + tid];
  }
  if (tid < 16) m[tid] = view_proj[tid];
  if (tid < g) u[tid] = u_table[tid];
  if (tid == 0) skirt_q = skirt[q];
  __syncthreads();

  // the x blends: xbl[tap][y][o] = T[y][a] w_a + T[y][b] w_b
  for (int i = tid; i < 3 * dim * g; i += kThreads) {
    const int tap = i / (dim * g), rem = i - tap * dim * g;
    const int yy = rem / g, o = rem - yy * g;
    xbl[tap][yy][o] = tile[yy * dim + tx.a[tap][o]] * tx.wa[tap][o]
                      + tile[yy * dim + tx.b[tap][o]] * tx.wb[tap][o];
  }
  // interpolate's row endpoints at u: side 0 between corners 0 and 1,
  // side 1 between corners 2 and 3
  if (tid < 2 * g) {
    const int side = tid / g, c = tid - side * g;
    interpolate(cp[2 * side], cn[2 * side], cp[2 * side + 1],
                cn[2 * side + 1], u[c], colp[side][c], coln[side][c]);
  }
  __syncthreads();

  for (int i = tid; i < gg; i += kThreads) {
    const int r = i / g, c = i - r * g;
    const float* pa = colp[0][c];
    const float* pb = colp[1][c];
    float pv[3], nv[3];
    interpolate(pa, coln[0][c], pb, coln[1][c], u[r], pv, nv);

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
    const float height = hgt - skirt_q * sk;

    float row_dir[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) row_dir[k] = pb[k] - pa[k];
    const float xyscale = sqrtf(dot3(row_dir, row_dir)) / 29.0f;
    float nt[3] = {x0 - x1, 2.0f * xyscale, y0 - y1};
    norm3(nt);
    float tv[3], bi[3], nrm[3];
    cross3(nv, row_dir, tv);
    norm3(tv);
    cross3(tv, nv, bi);
    norm3(bi);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      nrm[k] = (tv[k] * nt[0] + nv[k] * nt[1]) + bi[k] * nt[2];
    norm3(nrm);

    float w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = pv[k] + nv[k] * height;
    float cl[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      cl[k] = ((m[4 * k] * w[0] + m[4 * k + 1] * w[1]) + m[4 * k + 2] * w[2])
              + m[4 * k + 3];

    // the pinned lambert
    float sn[3] = {nrm[0], nrm[1], nrm[2]};
    norm3(sn);
    const float s = (sn[0] * lx + sn[1] * ly) + sn[2] * lz;
    const float shade = sqrtf(kShadeFloor + (s != s ? s : fmaxf(s, 0.0f)));

    const long long v = (long long)q * gg + i;
    reinterpret_cast<float4*>(clip_out)[v] =
        make_float4(cl[0], cl[1], cl[2], cl[3]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      world_out[v * 3 + k] = w[k];
      normal_out[v * 3 + k] = nrm[k];
      snormal_out[v * 3 + k] = nv[k];
    }
    height_out[v] = height;
    shade_out[v] = shade;
  }
}

}  // namespace

// corners and corner_normals (Q, 4, 3) f32, tiles (Q, dim, dim) f32,
// vx and vy (Q,) int32 in {0, 1, 2}, skirt (Q,) f32, view_proj (4, 4) f32,
// tap_idx (3, 3, G, 2) int32 and tap_w (3, 3, G, 2) f32 (vertex.blend_taps),
// u (G,) f32 (the grid's u values), light (lx, ly, lz); outputs clip
// (Q, G, G, 4), 16-byte aligned, world, normal and snormal (Q, G, G, 3),
// height and shade (Q, G, G), all f32. G and dim at most 32.
extern "C" int planet_tess(const void* corners, const void* corner_normals,
                           const void* tiles, const void* vx, const void* vy,
                           const void* skirt, const void* view_proj,
                           const void* tap_idx, const void* tap_w,
                           const void* u, int q, int g, int dim, float lx,
                           float ly, float lz, void* clip, void* world,
                           void* normal, void* height, void* snormal,
                           void* shade, void* stream) {
  if (q < 0 || g <= 0 || g > kMaxGrid || dim <= 0 || dim > kMaxDim
      || ((size_t)clip & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (q == 0) return (int)cudaSuccess;
  tess_kernel<<<q, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)corners, (const float*)corner_normals,
      (const float*)tiles, (const int*)vx, (const int*)vy,
      (const float*)skirt, (const float*)view_proj, (const int*)tap_idx,
      (const float*)tap_w, (const float*)u, g, dim, lx, ly, lz,
      (float*)clip, (float*)world, (float*)normal, (float*)height,
      (float*)snormal, (float*)shade);
  return (int)cudaGetLastError();
}
