// Device refine kernel (R1): one level of the fused frame's LOD refinement
// a launch, the frontier's probes, split test, subdivision and compaction.
//
// planet_tpu runs its device refine (planet_tpu/lod/refine_device.py:153)
// as one jit: a lax.while_loop over levels that stops once the frontier is
// empty, each level at the narrowest static width of its `tight` ladder
// that holds the frontier, with the probe heights from its Pallas noise
// kernel (K4, perlin_pallas.py:370) inside the same program. There is no
// Pallas refine kernel; this is the card's counterpart of that fused
// program. Plain PyTorch version: planet_tpu_torch/lod/refine_device.py:
// refine_plain (every level at the full width `cap`, K4's plain version
// for the probes), which it equals bit for bit in leaf ids, depths, DF
// corners, n_leaves and the overflow flag; the wrapper is
// planet_tpu_torch/ops/kernels/refine_cuda.py:refine_cuda.
//
// A level is two kernels on the caller's stream, over ping-pong frontier
// buffers, with every count on the device:
// - evaluate: a thread a frontier slot over a grid sized from cap; a
//   thread at or past f_n exits at once (a block wholly past it before it
//   loads the noise tables), so dead slots cost nothing and a level after
//   the frontier has emptied does no work: planet_tpu's tight ladder and
//   early stop, without a host read. A live slot computes the f32 corner
//   sum ((c0 + c1) + c2) + c3, the DF normalized midpoint, the five probes'
//   heights (for "ridged6" the 1e-5-scaled DF point through noise.cuh's
//   accumulate_octaves, 6 ridged octaves at gain 0.55, times 8848: K4's
//   core, inlined), the DF displacement, diagonals, threshold and the
//   lexicographic DF compare, in refine_plain's op order. It writes its
//   split flag and, for a split slot, its four children's DF corners
//   (_subdivide) and ids (quadid.words_make_child) into scratch at its
//   slot.
// - compact: one block scans the flags over [0, f_n) in chunks of its
//   width (a warp scan of the leaf and split counts packed in one word,
//   then a scan of the warp totals). Leaf r goes to leaf row l_n + r
//   (dropped at or past cap), child c of split r to next-frontier slot
//   4r + c (dropped at or past cap). One thread then updates f_n, l_n and
//   the overflow flag as refine_plain does: overflow when the leaves pass
//   cap or when 4 x (all split slots) does.
// The DF arithmetic is nums/df.py's op for op (add, sub, mul, div, sqrt;
// the sqrt's seed is the correctly rounded 1 / sqrt(hi)); two_prod's error
// comes from one fmaf, equal to Dekker's split (noise.cuh). Built with
// -fmad=false and IEEE division and square root, so every other product
// and sum rounds as torch's.
//
// What bounds it on the H100: the level's serial chain. A live slot runs
// ~2,000 f32 operations of DF arithmetic and, with ridged probes, five
// 6-octave noise points; the frontier holds a few hundred slots at most
// (a few blocks), so a level's time is one thread's chain plus the two
// launches, and a refine is max_lod + 1 such levels. The compaction is
// one block: its scan is a few dozen instructions a chunk, its copies 27
// words a leaf and 4 x 27 a split.

#include "noise.cuh"

namespace {

using namespace noise_core;

constexpr int kEvalThreads = 128;
constexpr int kCompactThreads = 1024;
constexpr int kWarps = kCompactThreads / 32;
constexpr int kCornerRows = 24;        // hi rows 0-11, lo 12-23: corner*3 + axis
constexpr int kIntRows = 3;            // id lo, id hi, depth
constexpr int kHiDepthShift = 55 - 32; // the depth field in the id's hi word
// the probes' noise (refine_device._probe_heights): terrain coord_scale
// 1e-5 as a DF pair, 6 ridged octaves at gain 0.55, heights times 8848
constexpr float kScaleHi = 1e-5f;
constexpr float kScaleLo = (float)(1e-5 - (double)1e-5f);
constexpr int kProbeOctaves = 6;
constexpr float kProbeGain = 0.55f;
constexpr float kProbeAmplitude = 8848.0f;

struct DF {
  float h, l;
};

__device__ __forceinline__ DF add(DF a, DF b) {
  DF r;
  df_add(a.h, a.l, b.h, b.l, r.h, r.l);
  return r;
}

__device__ __forceinline__ DF sub(DF a, DF b) { return add(a, DF{-b.h, -b.l}); }

__device__ __forceinline__ DF mul(DF a, DF b) {
  DF r;
  df_mul(a.h, a.l, b.h, b.l, r.h, r.l);
  return r;
}

// nums/df.py div: r = a - q1 b, its low part ((r_e + a_lo) - e) - q1 b_lo
__device__ __forceinline__ DF div(DF a, DF b) {
  const float q1 = a.h / b.h;
  float p, e, r_hi, r_e;
  two_prod(q1, b.h, p, e);
  two_sum(a.h, -p, r_hi, r_e);
  const float r = r_hi + (((r_e + a.l) - e) - q1 * b.l);
  const float q2 = r / b.h;
  DF out;
  quick_two_sum(q1, q2, out.h, out.l);
  return out;
}

// nums/df.py sqrt: Karp's step from the correctly rounded 1 / sqrt(hi)
__device__ __forceinline__ DF sqrt_df(DF a) {
  const float x = 1.0f / sqrtf(a.h);
  const float ax = a.h * x;
  float p, e, d_hi, d_e;
  two_prod(ax, ax, p, e);
  two_sum(a.h, -p, d_hi, d_e);
  const float diff = d_hi + ((d_e + a.l) - e);
  const float corr = diff * (x * 0.5f);
  DF out;
  quick_two_sum(ax, corr, out.h, out.l);
  return out;
}

// |p|^2 in planet_tpu's dot3 order, (x*x + y*y) + z*z
__device__ __forceinline__ DF norm2(const DF* p) {
  return add(add(mul(p[0], p[0]), mul(p[1], p[1])), mul(p[2], p[2]));
}

// normalize(p) * radius (refine_device._df_normalize3)
__device__ __forceinline__ void normalize3(const DF* p, DF radius, DF* out) {
  const DF s = div(radius, sqrt_df(norm2(p)));
  for (int a = 0; a < 3; ++a) out[a] = mul(p[a], s);
}

__device__ __forceinline__ bool df_less(DF a, DF b) {
  return (a.h < b.h) | ((a.h == b.h) & (a.l < b.l));
}

// quadid.words_make_child on one id's words
__device__ __forceinline__ void make_child(int lo, int hi, int c, int& c_lo,
                                           int& c_hi) {
  const int d = (hi >> kHiDepthShift) & 31;
  uint32_t ulo = (uint32_t)lo;
  uint32_t uhi = (uint32_t)hi + (1u << kHiDepthShift);
  const int pos = 2 * d;
  if (pos < 32) {
    ulo |= (uint32_t)c << pos;
  } else {
    uhi |= (uint32_t)c << (pos - 32);
  }
  c_lo = (int)ulo;
  c_hi = (int)uhi;
}

// axis a of point g of the children's 3x3 grid c0, e01, c1, e02, m, e13,
// c2, e23, c3 (row-major; e: the normalized sums 01, 02, 13, 23, centre)
__device__ __forceinline__ DF grid_at(int g, int a, const DF (&c)[4][3],
                                      const DF (&e)[5][3]) {
  switch (g) {
    case 0: return c[0][a];
    case 1: return e[0][a];
    case 2: return c[1][a];
    case 3: return e[1][a];
    case 4: return e[4][a];
    case 5: return e[2][a];
    case 6: return c[2][a];
    case 7: return e[3][a];
    default: return c[3][a];
  }
}

struct Params {
  int cap, max_lod, use_quality;
  DF radius, quality;
};

// Evaluate one level: split flags for [0, f_n) and each split slot's
// children into scratch (kid_int (4, 3, cap), kid_cor (4, 24, cap)).
template <bool kRidged>
__global__ void __launch_bounds__(kEvalThreads)
evaluate_kernel(const int* __restrict__ f_int, const float* __restrict__ f_cor,
                int* __restrict__ kid_int, float* __restrict__ kid_cor,
                int* __restrict__ flags, const int* __restrict__ state,
                const float* __restrict__ cam_hi,
                const float* __restrict__ cam_lo,
                const int* __restrict__ perm_g, const int* __restrict__ sign_g,
                const float* __restrict__ freq, Params prm) {
  __shared__ Tables<kFast> tab;
  const int f_n = state[0];
  if ((int)(blockIdx.x * kEvalThreads) >= f_n) return;
  if constexpr (kRidged) load_tables(tab, perm_g, sign_g);
  const int i = blockIdx.x * kEvalThreads + threadIdx.x;
  if (i >= f_n) return;
  const int cap = prm.cap;

  DF c[4][3];
  for (int k = 0; k < 4; ++k)
    for (int a = 0; a < 3; ++a)
      c[k][a] = DF{f_cor[(k * 3 + a) * cap + i],
                   f_cor[(12 + k * 3 + a) * cap + i]};
  const int depth = f_int[2 * cap + i];
  const int lodv = prm.max_lod - depth;

  // probes: the 4 corners and the normalized midpoint of their f32 sums
  DF csum[3], mid[3];
  for (int a = 0; a < 3; ++a)
    csum[a] = DF{((c[0][a].h + c[1][a].h) + c[2][a].h) + c[3][a].h,
                 ((c[0][a].l + c[1][a].l) + c[2][a].l) + c[3][a].l};
  normalize3(csum, prm.radius, mid);

  const DF one{1.0f, 0.0f};
  const DF cam[3] = {DF{cam_hi[0], cam_lo[0]}, DF{cam_hi[1], cam_lo[1]},
                     DF{cam_hi[2], cam_lo[2]}};
  DF d[5][3];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const DF* p = j < 4 ? c[j] : mid;
    float h = 0.0f;
    if constexpr (kRidged) {
      float ph[3], pl[3];
      for (int a = 0; a < 3; ++a)
        df_scale(p[a].h, p[a].l, kScaleHi, kScaleLo, false, ph[a], pl[a]);
      h = accumulate_octaves<kFast>(tab, freq, kProbeOctaves, true, true,
                                    kProbeGain, ph, pl) *
          kProbeAmplitude;
    }
    // displacement p * (1 + h / |p|)
    const DF plen = sqrt_df(norm2(p));
    const DF scale = add(one, div(DF{h, 0.0f}, plen));
    for (int a = 0; a < 3; ++a) d[j][a] = mul(p[a], scale);
  }

  // threshold: (|d3 - d0|^2 + |d2 - d1|^2) / (1 + 2.5 lod / max_lod)
  DF d30[3], d21[3];
  for (int a = 0; a < 3; ++a) {
    d30[a] = sub(d[3][a], d[0][a]);
    d21[a] = sub(d[2][a], d[1][a]);
  }
  const DF diag = add(norm2(d30), norm2(d21));
  const DF denom = add(one, div(mul(DF{2.5f, 0.0f}, DF{(float)lodv, 0.0f}),
                                DF{(float)prm.max_lod, 0.0f}));
  DF thr = div(diag, denom);
  if (prm.use_quality) thr = mul(thr, prm.quality);
  bool closer = false;
  for (int j = 0; j < 5; ++j) {
    DF rel[3];
    for (int a = 0; a < 3; ++a) rel[a] = sub(d[j][a], cam[a]);
    const DF dist2 = norm2(rel);
    closer |= df_less(DF{dist2.h * 2.0f, dist2.l * 2.0f}, thr);
  }
  const bool split = (lodv > 0) && closer;
  flags[i] = split ? 1 : 0;
  if (!split) return;

  // children (_subdivide): edge sums 01, 02, 13, 23, the centre (01) + (23),
  // each normalized onto the sphere
  DF mids[5][3], e[5][3];
  for (int a = 0; a < 3; ++a) {
    mids[0][a] = add(c[0][a], c[1][a]);
    mids[1][a] = add(c[0][a], c[2][a]);
    mids[2][a] = add(c[1][a], c[3][a]);
    mids[3][a] = add(c[2][a], c[3][a]);
    mids[4][a] = add(mids[0][a], mids[3][a]);
  }
#pragma unroll
  for (int j = 0; j < 5; ++j) normalize3(mids[j], prm.radius, e[j]);
  const int lo = f_int[i], hi = f_int[cap + i];
  // child k = (ky, kx) takes grid points (ky + qy, kx + qx), q = (qy, qx)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float* kc = kid_cor + (size_t)k * kCornerRows * cap;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int g = ((k >> 1) + (q >> 1)) * 3 + (k & 1) + (q & 1);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const DF v = grid_at(g, a, c, e);
        kc[(q * 3 + a) * cap + i] = v.h;
        kc[(12 + q * 3 + a) * cap + i] = v.l;
      }
    }
    int* ki = kid_int + (size_t)k * kIntRows * cap;
    make_child(lo, hi, k, ki[i], ki[cap + i]);
    ki[2 * cap + i] = depth + 1;
  }
}

// Compact one level: leaves appended at l_n, children to slots 4r + c of
// the next frontier; then the counts. One block.
__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const int* __restrict__ f_int, const float* __restrict__ f_cor,
               const int* __restrict__ kid_int,
               const float* __restrict__ kid_cor,
               const int* __restrict__ flags, int* __restrict__ state,
               int* __restrict__ n_int, float* __restrict__ n_cor,
               int* __restrict__ l_int, float* __restrict__ l_cor, int cap) {
  __shared__ int warp_sum[kWarps];
  const int f_n = state[0];
  if (f_n <= 0) return;
  const int l_n = state[1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int leaf_base = 0, split_base = 0;
  for (int base = 0; base < f_n; base += kCompactThreads) {
    const int i = base + tid;
    const int sp = i < f_n ? flags[i] : 0;
    const int lf = i < f_n ? 1 - sp : 0;
    // leaf count in the low half, split count in the high half (a chunk
    // holds at most kCompactThreads of each)
    const int v = lf | sp << 16;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
      for (int o = 1; o < kWarps; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += t;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int excl = incl - v + (warp ? warp_sum[warp - 1] : 0);
    const int total = warp_sum[kWarps - 1];
    if (lf) {
      const int pos = l_n + leaf_base + (excl & 0xFFFF);
      if (pos < cap) {
        for (int r = 0; r < kIntRows; ++r)
          l_int[r * cap + pos] = f_int[r * cap + i];
        for (int r = 0; r < kCornerRows; ++r)
          l_cor[r * cap + pos] = f_cor[r * cap + i];
      }
    }
    if (sp) {
      const int rank = split_base + (excl >> 16);
      for (int k = 0; k < 4; ++k) {
        const int tgt = 4 * rank + k;
        if (tgt >= cap) break;
        const int* ki = kid_int + (size_t)k * kIntRows * cap;
        const float* kc = kid_cor + (size_t)k * kCornerRows * cap;
        for (int r = 0; r < kIntRows; ++r)
          n_int[r * cap + tgt] = ki[r * cap + i];
        for (int r = 0; r < kCornerRows; ++r)
          n_cor[r * cap + tgt] = kc[r * cap + i];
      }
    }
    leaf_base += total & 0xFFFF;
    split_base += total >> 16;
    __syncthreads();   // warp_sum is rewritten by the next chunk
  }
  if (tid == 0) {
    const int new_l_n = l_n + leaf_base;
    const bool over = state[2] != 0 || new_l_n > cap || split_base * 4 > cap;
    state[0] = min(split_base * 4, cap);
    state[1] = min(new_l_n, cap);
    state[2] = over ? 1 : 0;
  }
}

}  // namespace

// One refine level: evaluate the frontier (f_int (3, cap) int32 id lo, id
// hi, depth; f_cor (24, cap) f32 DF corners) and compact it into the leaf
// buffers (l_int, l_cor: the same layout) and the next frontier (n_int,
// n_cor). state: (3,) int32 f_n, l_n, overflowed, read and updated on the
// device. kid_int (4, 3, cap), kid_cor (4, 24, cap) and flags (cap,) are
// scratch. perm, sign, freq: perlin_cuda.kernel_tables(2.0), read only
// when ridged.
extern "C" int planet_refine_level(
    const void* f_int, const void* f_cor, void* n_int, void* n_cor,
    void* kid_int, void* kid_cor, void* flags, void* state, void* l_int,
    void* l_cor, const void* cam_hi, const void* cam_lo, const void* perm,
    const void* sign, const void* freq, int cap, int max_lod, int ridged,
    int use_quality, float radius_hi, float radius_lo, float quality_hi,
    float quality_lo, void* stream) {
  if (cap <= 0 || max_lod < 0 || (ridged && (!perm || !sign || !freq)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Params prm{cap, max_lod, use_quality, DF{radius_hi, radius_lo},
                   DF{quality_hi, quality_lo}};
  const int blocks = (cap + kEvalThreads - 1) / kEvalThreads;
  if (ridged) {
    evaluate_kernel<true><<<blocks, kEvalThreads, 0, s>>>(
        (const int*)f_int, (const float*)f_cor, (int*)kid_int,
        (float*)kid_cor, (int*)flags, (const int*)state,
        (const float*)cam_hi, (const float*)cam_lo, (const int*)perm,
        (const int*)sign, (const float*)freq, prm);
  } else {
    evaluate_kernel<false><<<blocks, kEvalThreads, 0, s>>>(
        (const int*)f_int, (const float*)f_cor, (int*)kid_int,
        (float*)kid_cor, (int*)flags, (const int*)state,
        (const float*)cam_hi, (const float*)cam_lo, nullptr, nullptr,
        nullptr, prm);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_kernel<<<1, kCompactThreads, 0, s>>>(
      (const int*)f_int, (const float*)f_cor, (const int*)kid_int,
      (const float*)kid_cor, (const int*)flags, (int*)state, (int*)n_int,
      (float*)n_cor, (int*)l_int, (float*)l_cor, cap);
  return (int)cudaGetLastError();
}
