// Device refine kernel (R1): the fused frame's LOD refinement, one level
// a launch: the frontier's probes, split test, subdivision and compaction.
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
// What bounds it on the H100: the level's chain. A live slot runs ~2,000
// f32 operations of DF arithmetic and, with ridged probes, five 6-octave
// noise points; the frontier holds a few dozen slots a level at a flying
// camera (a few hundred at LOD quality 16), so a level's time is one
// slot's dependent chain plus its launch, and a refine is max_lod + 1 such
// levels. The design shortens the chain and the launches:
// - a warp a live frontier slot (level_kernel). The grid is sized from
//   cap (at most two blocks an SM); f_n is read on the device, the blocks
//   past the ceil(f_n / 8) live ones exit at once and the live ones'
//   warps stride over [0, f_n), so dead slots cost nothing and a level
//   after the frontier has emptied does no work: planet_tpu's tight
//   ladder and early stop, without a host read. Lane l < 30 takes probe
//   l / 6 and octave l % 6 (refine_cuda.lane_map): it scales its probe's
//   DF point by 1e-5, splits it and computes that one octave of the noise
//   (noise.cuh octave_noise); each lane then folds its probe's six octave
//   values in octave order by shuffles (add_octave, accumulate_octaves'
//   operations in its order), so the 30 octaves run side by side. Each
//   lane displaces its own probe, the four displaced corners reach every
//   lane by shuffles for the diagonals and the threshold, each lane tests
//   its probe's camera distance and the split is __any_sync of the tests
//   (an OR, in any order). A split slot's five subdivision points are
//   normalized on lanes 0-4 and its four children's 108 words written by
//   the warp's lanes together.
// - the compaction in the same launch: each live block, done with its
//   slots, takes a ticket after a __threadfence, and the block that takes
//   the last one compacts the level (compact_block: a scan of the leaf and
//   split counts packed in one word; leaf r to leaf row l_n + r, child c
//   of split r to next-frontier slot 4r + c, each dropped at or past cap,
//   a thread a destination column), writes f_n, l_n and the overflow flag
//   as refine_plain does and puts the ticket back to 0. The counts
//   alternate between two parities of `state` (level L reads parity L % 2
//   and writes the other), so a block that starts late still reads this
//   level's f_n; with an empty frontier block 0 carries the counts over.
// - the set-up in the launches: level 0 takes its f_n, the roots' count,
//   from its arguments and each of its warps stages its root into the
//   frontier before evaluating it (stage_root), so the wrapper's one fill
//   is the zeros of the leaf buffers and the counts.
// Values move between lanes; none is recomputed in another order, so
// every operation of refine_plain's _level keeps its operands and order.
// The DF arithmetic is nums/df.py's op for op (add, sub, mul, div, sqrt;
// the sqrt's seed is the correctly rounded 1 / sqrt(hi)); two_prod's error
// comes from one fmaf, equal to Dekker's split (noise.cuh). Built with
// -fmad=false and IEEE division and square root, so every other product
// and sum rounds as torch's.
//
// Two designs lost to this one on the card and were taken out (PERF.md
// R1 row; git ee5a145 holds them): the compaction as a second kernel (two
// launches a level), and the whole refine in one launch of one block,
// which won by 8-17 % at the flying cameras and lost 4.8x at the dense
// one, where one SM evaluates up to 384 slots a level.

#include <algorithm>

#include "noise.cuh"

namespace {

using namespace noise_core;

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

struct Params {
  int cap, max_lod, use_quality, n_roots;
  DF radius, quality;
};

// the probe-by-octave lane map (refine_cuda.lane_map): lane l < 30 takes
// probe l / 6 (corners 0-3, then the midpoint) and octave l % 6; lanes 30
// and 31 repeat probe 4's octaves 0 and 1
constexpr int kLaneOctaves = kProbeOctaves;
constexpr int kProbes = 5;
// a warp's shared scratch: the 5 normalized sums (DF, 3 axes) and the
// slot's 24 corner rows
constexpr int kWarpScratch = 6 * kProbes + kCornerRows;

// a frontier's buffers: ints (3, cap) and corners (24, cap)
struct Frontier {
  const int* ints;
  const float* cor;
};

// Evaluate frontier slot i with one warp (every lane calls it): its split
// flag and, for a split slot, its children into scratch (kid_int (4, 3,
// cap), kid_cor (4, 24, cap)). es: the warp's kWarpScratch floats of
// shared memory.
template <bool kRidged>
__device__ __forceinline__ void evaluate_slot(
    int i, Frontier f, int* __restrict__ kid_int, float* __restrict__ kid_cor,
    int* __restrict__ flags, const DF (&cam)[3], const Tables<kFast>& tab,
    const float* __restrict__ freq, const Params& prm, float* es) {
  const int lane = threadIdx.x & 31;
  const int cap = prm.cap;
  // the slot's words a split writes again into its children: corner row
  // `lane` (lanes 0-23) and the id words, loaded now beside the corners
  const float own_row = lane < kCornerRows ? __ldcg(f.cor + lane * cap + i)
                                           : 0.0f;
  const int lo_id = __ldcg(f.ints + i), hi_id = __ldcg(f.ints + cap + i);
  DF c[4][3];
  for (int k = 0; k < 4; ++k)
    for (int a = 0; a < 3; ++a)
      c[k][a] = DF{__ldcg(f.cor + (k * 3 + a) * cap + i),
                   __ldcg(f.cor + (12 + k * 3 + a) * cap + i)};
  const int depth = __ldcg(f.ints + 2 * cap + i);
  const int lodv = prm.max_lod - depth;

  // the midpoint: the normalized f32 corner sums ((c0 + c1) + c2) + c3
  DF csum[3], mid[3];
  for (int a = 0; a < 3; ++a)
    csum[a] = DF{((c[0][a].h + c[1][a].h) + c[2][a].h) + c[3][a].h,
                 ((c[0][a].l + c[1][a].l) + c[2][a].l) + c[3][a].l};
  normalize3(csum, prm.radius, mid);

  // this lane's probe j and octave o
  const int j = min(lane / kLaneOctaves, kProbes - 1);
  const int o = lane - kLaneOctaves * (lane / kLaneOctaves);
  DF p[3];
  for (int a = 0; a < 3; ++a)
    p[a] = j == 0 ? c[0][a] : j == 1 ? c[1][a] : j == 2 ? c[2][a]
         : j == 3 ? c[3][a] : mid[a];
  float h = 0.0f;
  if constexpr (kRidged) {
    float ph[3], pl[3];
    for (int a = 0; a < 3; ++a)
      df_scale(p[a].h, p[a].l, kScaleHi, kScaleLo, false, ph[a], pl[a]);
    PointSplit sp;
    split_point(true, ph, pl, sp);
    const float n = octave_noise<kFast>(tab, freq, o, true, sp, ph, pl);
    // the fold of probe j's octaves 0-5, in order, on each of its lanes
    float value = 0.0f, weight = 1.0f, amp = 1.0f;
#pragma unroll
    for (int k = 0; k < kLaneOctaves; ++k)
      add_octave(true, kProbeGain,
                 __shfl_sync(0xffffffffu, n, kLaneOctaves * j + k), value,
                 weight, amp);
    h = value * kProbeAmplitude;
  }
  // probe j's displacement p * (1 + h / |p|)
  const DF one{1.0f, 0.0f};
  const DF plen = sqrt_df(norm2(p));
  const DF scale = add(one, div(DF{h, 0.0f}, plen));
  DF d[3];
  for (int a = 0; a < 3; ++a) d[a] = mul(p[a], scale);

  // threshold: (|d3 - d0|^2 + |d2 - d1|^2) / (1 + 2.5 lod / max_lod), the
  // displaced corners from the lanes of probes 0-3
  DF dc[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    for (int a = 0; a < 3; ++a)
      dc[k][a] = DF{__shfl_sync(0xffffffffu, d[a].h, kLaneOctaves * k),
                    __shfl_sync(0xffffffffu, d[a].l, kLaneOctaves * k)};
  DF d30[3], d21[3];
  for (int a = 0; a < 3; ++a) {
    d30[a] = sub(dc[3][a], dc[0][a]);
    d21[a] = sub(dc[2][a], dc[1][a]);
  }
  const DF diag = add(norm2(d30), norm2(d21));
  const DF denom = add(one, div(mul(DF{2.5f, 0.0f}, DF{(float)lodv, 0.0f}),
                                DF{(float)prm.max_lod, 0.0f}));
  DF thr = div(diag, denom);
  if (prm.use_quality) thr = mul(thr, prm.quality);
  DF rel[3];
  for (int a = 0; a < 3; ++a) rel[a] = sub(d[a], cam[a]);
  const DF dist2 = norm2(rel);
  const bool closer = __any_sync(
      0xffffffffu, df_less(DF{dist2.h * 2.0f, dist2.l * 2.0f}, thr));
  const bool split = (lodv > 0) && closer;
  if (lane == 0) flags[i] = split ? 1 : 0;
  if (!split) return;

  // children (_subdivide): edge sums 01, 02, 13, 23 and the centre (01) +
  // (23), sum m normalized onto the sphere on lane m into es[6m + 2a + lo];
  // the slot's corner rows into es[30 + row]
  if (lane < kCornerRows) es[6 * kProbes + lane] = own_row;
  if (lane < 5) {
    DF m[3], e[3];
    for (int a = 0; a < 3; ++a) {
      const DF m01 = add(c[0][a], c[1][a]);
      const DF m23 = add(c[2][a], c[3][a]);
      m[a] = lane == 0 ? m01 : lane == 1 ? add(c[0][a], c[2][a])
           : lane == 2 ? add(c[1][a], c[3][a]) : lane == 3 ? m23
           : add(m01, m23);
    }
    normalize3(m, prm.radius, e);
    for (int a = 0; a < 3; ++a) {
      es[6 * lane + 2 * a] = e[a].h;
      es[6 * lane + 2 * a + 1] = e[a].l;
    }
  }
  __syncwarp();
  // child k = (ky, kx) takes grid points (ky + qy, kx + qx), q = (qy, qx),
  // of the 3x3 grid c0, e01, c1, e02, m, e13, c2, e23, c3; word w < 24 of
  // child k is its corner row w (hi 0-11, lo 12-23), w 24-26 its id lo, id
  // hi and depth
  for (int t = lane; t < 4 * (kCornerRows + kIntRows); t += 32) {
    const int k = t / (kCornerRows + kIntRows);
    const int w = t - k * (kCornerRows + kIntRows);
    if (w < kCornerRows) {
      const int lo = w >= 12, r = w - 12 * lo;
      const int q = r / 3, a = r - 3 * q;
      const int g = ((k >> 1) + (q >> 1)) * 3 + (k & 1) + (q & 1);
      // grid point g: a corner (0, 2, 6, 8) or sum 0, 1, 4, 2, 3 (1, 3,
      // 4, 5, 7)
      float v;
      if ((g & 1) == 0 && g != 4) {
        const int corner = g == 0 ? 0 : g == 2 ? 1 : g == 6 ? 2 : 3;
        v = es[6 * kProbes + 12 * lo + corner * 3 + a];
      } else {
        const int e = g == 1 ? 0 : g == 3 ? 1 : g == 4 ? 4 : g == 5 ? 2 : 3;
        v = es[6 * e + 2 * a + lo];
      }
      kid_cor[((size_t)k * kCornerRows + w) * cap + i] = v;
    } else {
      int c_lo, c_hi;
      make_child(lo_id, hi_id, k, c_lo, c_hi);
      const int r = w - kCornerRows;
      kid_int[((size_t)k * kIntRows + r) * cap + i] =
          r == 0 ? c_lo : r == 1 ? c_hi : depth + 1;
    }
  }
  __syncwarp();   // es is rewritten by the warp's next slot
}

// the block's shared memory of a compaction: the warp totals of the scan
// and, for a chunk of kThreads slots, each leaf's and each split's slot
template <int kThreads>
struct CompactShared {
  int warp_sum[kThreads / 32];
  int leaf_slot[kThreads];
  int split_slot[kThreads];
};

// Copy one slot's 27 words (3 int rows, then 24 corner rows; row r at
// r * cap) from src to dst, the 27 loads issued before the stores
__device__ __forceinline__ void copy_slot(const int* src_int,
                                          const float* src_cor, int* dst_int,
                                          float* dst_cor, int cap) {
  int v[kIntRows + kCornerRows];
#pragma unroll
  for (int r = 0; r < kIntRows; ++r) v[r] = __ldcg(src_int + r * cap);
#pragma unroll
  for (int r = 0; r < kCornerRows; ++r)
    v[kIntRows + r] = __ldcg((const int*)src_cor + r * cap);
#pragma unroll
  for (int r = 0; r < kIntRows; ++r) dst_int[r * cap] = v[r];
#pragma unroll
  for (int r = 0; r < kCornerRows; ++r)
    ((int*)dst_cor)[r * cap] = v[kIntRows + r];
}

// Compact one level of f_n slots with one block of kThreads threads:
// leaves appended at l_n, children to slots 4r + c of the next frontier;
// the counts l_n and overflowed read from st, and (f_n, l_n, overflowed)
// written to st_next. The flags and
// children come from other blocks of the same launch, so every operand is
// read from L2 (__ldcg). A chunk of kThreads slots is scanned (leaf and split
// counts packed in one word), each leaf's and split's slot listed in
// shared memory, then the block copies the leaves' 27 words and the
// splits' children's 4 x 27 together, a thread a destination column.
template <int kThreads>
__device__ __forceinline__ void compact_block(
    Frontier f, const int* __restrict__ kid_int,
    const float* __restrict__ kid_cor, const int* __restrict__ flags,
    int f_n, const int* st, int* st_next, int* __restrict__ n_int,
    float* __restrict__ n_cor, int* __restrict__ l_int,
    float* __restrict__ l_cor, int cap, CompactShared<kThreads>& sh) {
  constexpr int kWarpsC = kThreads / 32;
  const int l_n = __ldcg(st + 1), over_in = __ldcg(st + 2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int leaf_base = 0, split_base = 0;
  for (int base = 0; base < f_n; base += kThreads) {
    const int i = base + tid;
    const int sp = i < f_n ? __ldcg(flags + i) : 0;
    const int lf = i < f_n ? 1 - sp : 0;
    // leaf count in the low half, split count in the high half (a chunk
    // holds at most kThreads of each)
    const int v = lf | sp << 16;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) sh.warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kWarpsC ? sh.warp_sum[lane] : 0;
      for (int o = 1; o < kWarpsC; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += t;
      }
      if (lane < kWarpsC) sh.warp_sum[lane] = w;
    }
    __syncthreads();
    const int excl = incl - v + (warp ? sh.warp_sum[warp - 1] : 0);
    const int total = sh.warp_sum[kWarpsC - 1];
    if (lf) sh.leaf_slot[excl & 0xFFFF] = i;
    if (sp) sh.split_slot[excl >> 16] = i;
    __syncthreads();
    // the block's threads together: leaf r (thread r) to leaf row l_n +
    // leaf_base + r, then child k of split r (thread 4r + k) to row
    // 4 (split_base + r) + k of the next frontier; consecutive threads
    // write consecutive columns
    for (int r = tid; r < (total & 0xFFFF); r += kThreads) {
      const int s = sh.leaf_slot[r], pos = l_n + leaf_base + r;
      if (pos < cap)
        copy_slot(f.ints + s, f.cor + s, l_int + pos, l_cor + pos, cap);
    }
    for (int t = tid; t < 4 * (total >> 16); t += kThreads) {
      const int s = sh.split_slot[t >> 2], k = t & 3;
      const int tgt = 4 * split_base + t;
      if (tgt < cap)
        copy_slot(kid_int + k * kIntRows * cap + s,
                  kid_cor + k * kCornerRows * cap + s, n_int + tgt,
                  n_cor + tgt, cap);
    }
    leaf_base += total & 0xFFFF;
    split_base += total >> 16;
    __syncthreads();   // the shared lists are rewritten by the next chunk
  }
  if (tid == 0) {
    const int new_l_n = l_n + leaf_base;
    const bool over = over_in != 0 || new_l_n > cap || split_base * 4 > cap;
    st_next[0] = min(split_base * 4, cap);
    st_next[1] = min(new_l_n, cap);
    st_next[2] = over ? 1 : 0;
  }
}

constexpr int kLevelThreads = 256;              // 8 warps, 8 slots at once
constexpr int kLevelWarps = kLevelThreads / 32;
// state: the counts (f_n, l_n, overflowed) of even levels at 0-2, of odd
// levels at 3-5 (a level reads its own and writes the other), and the live
// blocks' ticket at 6 (0 between launches). It starts as zeros: level 0
// takes its f_n, the roots' count, from Params, and l_n and overflowed 0
constexpr int kTicket = 6;

struct Buffers {
  int* f_int;
  float* f_cor;
  int *n_int, *kid_int, *flags, *state, *l_int;
  float *n_cor, *kid_cor, *l_cor;
  const float *cam_hi, *cam_lo;
  const int *perm, *sign;
  const float* freq;
  // the roots: (R,) id lo, id hi, depth (null: 0) and (R, 4, 3) DF corners
  const int *r_lo, *r_hi, *r_depth;
  const float *r_ch, *r_cl;
};

// the camera as DF, from the (hi, lo) f32 vectors
__device__ __forceinline__ void load_camera(const Buffers& b, DF (&cam)[3]) {
  for (int a = 0; a < 3; ++a) cam[a] = DF{b.cam_hi[a], b.cam_lo[a]};
}

// the frontier's f_n at `level`: level 0's is the roots' count
__device__ __forceinline__ int level_slots(const Params& prm, const int* st,
                                           int level) {
  return level == 0 ? prm.n_roots : __ldcg(st);
}

// Level 0's slot i from root i (every lane of the warp that evaluates it
// calls it): lane w < 27 copies word w (id lo, id hi, depth, then corner
// row w - 3: hi rows, then lo rows) into the frontier, where evaluate_slot
// and the compaction read it
__device__ __forceinline__ void stage_root(int i, const Buffers& b, int cap) {
  const int lane = threadIdx.x & 31;
  if (lane < kIntRows) {
    const int v = lane == 0 ? b.r_lo[i] : lane == 1 ? b.r_hi[i]
                : b.r_depth ? b.r_depth[i] : 0;
    b.f_int[lane * cap + i] = v;
  } else if (lane < kIntRows + kCornerRows) {
    const int r = lane - kIntRows, lo = r >= 12;
    b.f_cor[r * cap + i] = (lo ? b.r_cl : b.r_ch)[i * 12 + r - 12 * lo];
  }
  __threadfence_block();
  __syncwarp();
}

// One level, its counts at state + 3 * (level % 2): the live blocks' warps
// stride over [0, f_n), a warp a slot (at level 0 staging its root first),
// and the live block that takes the last ticket compacts the level into
// the other parity's counts. kCompact is always true: as a template
// argument it keeps the kernel's name, level_kernel<kRidged, true>, which
// traces and the benchmark's breakdowns read. A block past the live ones
// exits at once (block 0 carries the counts over when the frontier is
// empty); every block reads only this level's counts, which nothing writes
// in this launch.
template <bool kRidged, bool kCompact>
__global__ void __launch_bounds__(kLevelThreads)
level_kernel(Buffers b, Params prm, int level) {
  __shared__ Tables<kFast> tab;
  __shared__ float es[kLevelWarps][kWarpScratch];
  __shared__ CompactShared<kLevelThreads> sh;
  __shared__ bool last;
  const int parity = level & 1;
  const int* st = b.state + 3 * parity;
  int* st_next = b.state + 3 * (1 - parity);
  const int f_n = level_slots(prm, st, level);
  const int live = min((int)gridDim.x, (f_n + kLevelWarps - 1) / kLevelWarps);
  if ((int)blockIdx.x >= live) {                   // uniform in the block
    if (kCompact && f_n <= 0 && blockIdx.x == 0 && threadIdx.x == 0) {
      st_next[0] = 0;
      st_next[1] = __ldcg(st + 1);
      st_next[2] = __ldcg(st + 2);
    }
    return;
  }
  if constexpr (kRidged) load_tables(tab, b.perm, b.sign);
  DF cam[3];
  load_camera(b, cam);
  const int warp = threadIdx.x >> 5;
  const Frontier f{b.f_int, b.f_cor};
  for (int i = blockIdx.x * kLevelWarps + warp; i < f_n;
       i += live * kLevelWarps) {
    if (level == 0) stage_root(i, b, prm.cap);
    evaluate_slot<kRidged>(i, f, b.kid_int, b.kid_cor, b.flags, cam, tab,
                           b.freq, prm, es[warp]);
  }
  if constexpr (kCompact) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(b.state + kTicket, 1) == live - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    compact_block<kLevelThreads>(f, b.kid_int, b.kid_cor, b.flags, f_n, st,
                                 st_next, b.n_int, b.n_cor, b.l_int, b.l_cor,
                                 prm.cap, sh);
    if (threadIdx.x == 0) b.state[kTicket] = 0;
  }
}

// blocks of a level launch: as many as the frontier can fill (cap slots,
// kLevelWarps a block), at most two an SM (all resident at once)
int level_blocks(int cap) {
  static int sms[64] = {0};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64)
    device = 0;
  if (sms[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n <= 0)
      n = 132;
    sms[device] = n;
  }
  return std::min((cap + kLevelWarps - 1) / kLevelWarps, 2 * sms[device]);
}

template <bool kRidged>
int launch_level(const Buffers& b, const Params& prm, int level,
                 cudaStream_t s) {
  level_kernel<kRidged, true><<<level_blocks(prm.cap), kLevelThreads, 0, s>>>(
      b, prm, level);
  return (int)cudaGetLastError();
}

}  // namespace

// Refine level `level`: evaluate the frontier (f_int (3, cap) int32 id
// lo, id hi, depth; f_cor (24, cap) f32 DF corners) and compact it into
// the leaf buffers (l_int, l_cor: the same layout) and the next frontier
// (n_int, n_cor). Level 0's frontier is the n_roots roots (r_lo, r_hi,
// r_depth (R,) int32, r_depth null for depth 0; r_ch, r_cl (R, 4, 3) f32),
// which it stages into f_int and f_cor itself. state: (7,) int32, zeros
// before level 0, the counts f_n, l_n, overflowed of even levels at 0-2
// and of odd levels at 3-5, and the blocks' ticket at 6 (0 between
// launches), read and updated on the device. The leaf buffers start as
// zeros; the frontier, kid_int (4, 3, cap), kid_cor (4, 24, cap) and flags
// (cap,) are scratch. perm, sign, freq: perlin_cuda.kernel_tables(2.0),
// read only when ridged.
extern "C" int planet_refine_level(
    const void* r_lo, const void* r_hi, const void* r_depth, const void* r_ch,
    const void* r_cl, int n_roots, void* f_int, void* f_cor, void* n_int,
    void* n_cor, void* kid_int, void* kid_cor, void* flags, void* state,
    void* l_int, void* l_cor, const void* cam_hi, const void* cam_lo,
    const void* perm, const void* sign, const void* freq, int cap,
    int max_lod, int ridged, int use_quality, float radius_hi,
    float radius_lo, float quality_hi, float quality_lo, int level,
    void* stream) {
  if (cap <= 0 || max_lod < 0 || level < 0 || n_roots < 0 || n_roots > cap ||
      (ridged && (!perm || !sign || !freq)))
    return (int)cudaErrorInvalidValue;
  const Params prm{cap, max_lod, use_quality, n_roots,
                   DF{radius_hi, radius_lo}, DF{quality_hi, quality_lo}};
  const Buffers b{(int*)f_int, (float*)f_cor, (int*)n_int,
                  (int*)kid_int, (int*)flags, (int*)state, (int*)l_int,
                  (float*)n_cor, (float*)kid_cor, (float*)l_cor,
                  (const float*)cam_hi, (const float*)cam_lo,
                  (const int*)perm, (const int*)sign, (const float*)freq,
                  (const int*)r_lo, (const int*)r_hi, (const int*)r_depth,
                  (const float*)r_ch, (const float*)r_cl};
  cudaStream_t s = (cudaStream_t)stream;
  return ridged ? launch_level<true>(b, prm, level, s)
                : launch_level<false>(b, prm, level, s);
}

