// Table-lookup placements (t_lut): where a small table such as the noise
// core's 256-entry permutation should live on the H100, and what a
// dependent or independent lookup costs there.
//
// Replaces the Pallas lookup microbenchmarks in planet_tpu's tools/:
// microbench_lut.py:71/101/133/181 (C, C2, D, E), microbench_gather.py:49/
// 83/120/145 (G1, G2, G2f, R1), microbench_gather2.py:22, microbench_
// gather_wide.py:54 and microbench_gather_tp.py:24. Plain PyTorch
// versions: planet_tpu_torch/tools/lut.py, which every variant equals bit
// for bit; the wrapper is lut.lookup.
//
// Each TPU placement becomes its Hopper counterpart:
//   VMEM take / lane take_along_axis (C, C2, G1, G2, G2f) -> the table in
//     shared memory, one lookup a thread (int32 or f32, 128 or 256
//     entries, or 256 as two 128 halves + a select on bit 7);
//   the lane gather as such -> a warp-shuffle lookup from a register-held
//     table (entries / 32 registers a lane, one __shfl_sync each, then a
//     select over the registers);
//   XLA jnp.take from HBM -> __ldg from the global table;
//   one-hot / nibble MXU (D, E) -> tensor-core lookups with
//     mma.sync.m16n8k16 bf16 (table values < 256 are exact in bf16, the f32
//     accumulator holds one non-zero product per output);
//   pltpu.repeat (R1) -> a lane repeat, (8, 8) -> (8, 128).
//
// What bounds them: a lookup is one shared-memory read (32 a clock per SM),
// a shuffle one per register; the idx read and the output write are 8 bytes
// an element, so a single lookup a thread is bound by HBM bytes and a chain
// of lookups by shared-memory latency. The kernels are grid-stride loops
// over at most kMaxBlocks blocks, so each block copies its table once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xffffffffu;

enum Variant {
  kSmem = 0,         // out = tab[idx & (entries - 1)], int32 table
  kSmemF32 = 1,      // the same, f32 table
  kSmemHalves = 2,   // 256 entries as two 128 halves + select, int32
  kSmemHalvesF32 = 3,
  kLdg = 4,          // __ldg(table + (idx & (entries - 1)))
  kShfl = 5,         // register table, warp shuffles, int32
  kMmaOnehot = 6,    // one-hot (16 x 256) x table (256 x 8), 16 mma a tile
  kMmaNibble = 7,    // hi-nibble one-hot (16 x 16) x (16 x 16), 2 mma a tile
  kRepeat = 8,       // (8, 8) -> (8, 128): out[r, c] = x[r, c / 16]
  kChain = 9,        // v = tab[v & 127], `depth` times (dependent)
  kChainShfl = 10,
  kArith = 11,       // v = (v * 3 + 1) & 127, 64 times (no lookup)
  kCopy = 12,        // out = idx
  kRunSum = 13,      // 20 x {g = tab[v & 127]; acc += g; v += g}
  kRunSumShfl = 14,
  kRunSumWide = 15,  // the same with a 2048-entry table read at
                     // (v & 127) + (column & ~127) of a (rows, 2048) layout
  kIndep = 16,       // acc += tab[(v ^ k) & 127], k < 24 (independent)
  kIndepShfl = 17,
};

__device__ __forceinline__ int grid_start() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int grid_stride() { return gridDim.x * blockDim.x; }

template <typename T>
__device__ __forceinline__ void load_table(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// table[i & (32 * kRegs - 1)] from a table held as reg[j] = table[32 j +
// lane]; every lane of the warp must call it
template <int kRegs>
__device__ __forceinline__ int shfl_lookup(const int (&reg)[kRegs], int i) {
  const int lane = i & 31, r = (i >> 5) & (kRegs - 1);
  int v = 0;
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    const int t = __shfl_sync(kFull, reg[j], lane);
    v = r == j ? t : v;
  }
  return v;
}

template <typename T>
__global__ void smem_kernel(const int* __restrict__ idx,
                            const T* __restrict__ table, T* __restrict__ out,
                            int n, int entries) {
  __shared__ T tab[256];
  load_table(tab, table, entries);
  const int mask = entries - 1;
  for (int i = grid_start(); i < n; i += grid_stride())
    out[i] = tab[idx[i] & mask];
}

template <typename T>
__global__ void halves_kernel(const int* __restrict__ idx,
                              const T* __restrict__ table,
                              T* __restrict__ out, int n) {
  __shared__ T lo[128];
  __shared__ T hi[128];
  for (int i = threadIdx.x; i < 128; i += blockDim.x) {
    lo[i] = table[i];
    hi[i] = table[128 + i];
  }
  __syncthreads();
  for (int i = grid_start(); i < n; i += grid_stride()) {
    const int v = idx[i], low = v & 127;
    const T a = lo[low], b = hi[low];
    out[i] = v >= 128 ? b : a;
  }
}

__global__ void ldg_kernel(const int* __restrict__ idx,
                           const int* __restrict__ table,
                           int* __restrict__ out, int n, int entries) {
  const int mask = entries - 1;
  for (int i = grid_start(); i < n; i += grid_stride())
    out[i] = __ldg(table + (idx[i] & mask));
}

// one warp-uniform trip count, so every lane reaches each shuffle
template <int kRegs>
__global__ void shfl_kernel(const int* __restrict__ idx,
                            const int* __restrict__ table,
                            int* __restrict__ out, int n) {
  const int lane = threadIdx.x & 31;
  int reg[kRegs];
#pragma unroll
  for (int j = 0; j < kRegs; ++j) reg[j] = table[32 * j + lane];
  const int warp0 = grid_start() - lane;
  for (int base = warp0; base < n; base += grid_stride()) {
    const int i = base + lane;
    const int v = shfl_lookup(reg, i < n ? idx[i] : 0);
    if (i < n) out[i] = v;
  }
}

__device__ __forceinline__ uint32_t bf16_pair(int lo, int hi) {
  // small non-negative integers are exact in bf16: the f32's top 16 bits
  return (__float_as_uint((float)lo) >> 16) |
         (__float_as_uint((float)hi) & 0xffff0000u);
}

__device__ __forceinline__ uint32_t onehot_pair(int v, int col) {
  return (v == col ? 0x3f80u : 0u) | (v == col + 1 ? 0x3f800000u : 0u);
}

__device__ __forceinline__ void mma_bf16(const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 lookups a warp tile: row g = lane / 4 and row g + 8 of the mma's A.
// kNibble: A is the one-hot of idx >> 4 (16 wide) against B0/B1[k][n] =
// table[16 k + n] / table[16 k + 8 + n]; the lane holding column idx & 15
// of the row hands it over by a shuffle. Otherwise A is the full 256-wide
// one-hot in 16 chunks against B[k][n] = table[k] (every column alike).
template <bool kNibble>
__global__ void mma_kernel(const int* __restrict__ idx,
                           const int* __restrict__ table,
                           int* __restrict__ out, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = grid_start() >> 5, warps = grid_stride() >> 5;
  constexpr int kChunks = kNibble ? 2 : 16;
  uint32_t b[kChunks][2];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (kNibble) {   // c = 0: columns n = g, c = 1: n = g + 8
      const int col = g + 8 * c;
      b[c][0] = bf16_pair(table[16 * (2 * t) + col],
                          table[16 * (2 * t + 1) + col]);
      b[c][1] = bf16_pair(table[16 * (2 * t + 8) + col],
                          table[16 * (2 * t + 9) + col]);
    } else {
      const int k = 16 * c + 2 * t;
      b[c][0] = bf16_pair(table[k], table[k + 1]);
      b[c][1] = bf16_pair(table[k + 8], table[k + 9]);
    }
  }
  for (int base = warp * 16; base < n; base += warps * 16) {
    const int r0 = base + g, r1 = base + g + 8;
    const int v0 = r0 < n ? idx[r0] & 255 : 0;
    const int v1 = r1 < n ? idx[r1] & 255 : 0;
    int res0, res1;
    if (kNibble) {
      const int h0 = v0 >> 4, h1 = v1 >> 4;
      const uint32_t a[4] = {onehot_pair(h0, 2 * t), onehot_pair(h1, 2 * t),
                             onehot_pair(h0, 2 * t + 8),
                             onehot_pair(h1, 2 * t + 8)};
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(a, b[0][0], b[0][1], c0);
      mma_bf16(a, b[1][0], b[1][1], c1);
      // row r's column l = lo & 15 sits in lane 4 g + (l & 7) / 2, tile
      // l / 8, element l & 1 (rows g: c[0..1], rows g + 8: c[2..3])
      const int l0 = v0 & 15, l1 = v1 & 15;
      const float m0 = l0 >= 8 ? (l0 & 1 ? c1[1] : c1[0])
                               : (l0 & 1 ? c0[1] : c0[0]);
      const float m1 = l1 >= 8 ? (l1 & 1 ? c1[3] : c1[2])
                               : (l1 & 1 ? c0[3] : c0[2]);
      res0 = (int)__shfl_sync(kFull, m0, (lane & ~3) | ((l0 & 7) >> 1));
      res1 = (int)__shfl_sync(kFull, m1, (lane & ~3) | ((l1 & 7) >> 1));
    } else {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int col = 16 * k + 2 * t;
        const uint32_t a[4] = {onehot_pair(v0, col), onehot_pair(v1, col),
                               onehot_pair(v0, col + 8),
                               onehot_pair(v1, col + 8)};
        mma_bf16(a, b[k][0], b[k][1], c);
      }
      res0 = (int)c[0];
      res1 = (int)c[2];
    }
    if (t == 0) {
      if (r0 < n) out[r0] = res0;
      if (r1 < n) out[r1] = res1;
    }
  }
}

__global__ void repeat_kernel(const int* __restrict__ x, int* __restrict__ out,
                              int rows) {
  const int i = grid_start();
  if (i < rows * 128) out[i] = x[(i >> 7) * 8 + ((i & 127) >> 4)];
}

// the dependent and independent 128-entry lookups of microbench_gather2 /
// _wide / _tp, from shared memory (kShfl false) or registers (true)
template <int kKind, bool kShfl>
__global__ void chain_kernel(const int* __restrict__ idx,
                             const int* __restrict__ table,
                             int* __restrict__ out, int n, int depth,
                             int width) {
  __shared__ int tab[2048];
  const int lane = threadIdx.x & 31;
  int reg[4];
  if (kShfl) {
#pragma unroll
    for (int j = 0; j < 4; ++j) reg[j] = table[32 * j + lane];
  } else {
    load_table(tab, table, kKind == kRunSumWide ? 2048 : 128);
  }
  auto look = [&](int i) {
    if (kShfl) return shfl_lookup(reg, i);
    return tab[i];
  };
  const int warp0 = grid_start() - lane;
  for (int base = warp0; base < n; base += grid_stride()) {
    const int i = base + lane;
    int v = i < n ? idx[i] : 0, acc = 0;
    if (kKind == kChain) {
      for (int d = 0; d < depth; ++d) v = look(v & 127);
      acc = v;
    } else if (kKind == kRunSum) {
      for (int d = 0; d < 20; ++d) {
        const int gv = look(v & 127);
        acc += gv;
        v += gv;
      }
    } else if (kKind == kRunSumWide) {
      const int off = (i % width) & ~127;
      for (int d = 0; d < 20; ++d) {
        const int gv = look((v & 127) + off);
        acc += gv;
        v += gv;
      }
    } else {   // kIndep
#pragma unroll
      for (int k = 0; k < 24; ++k) acc += look((v ^ k) & 127);
    }
    if (i < n) out[i] = acc;
  }
}

__global__ void arith_kernel(const int* __restrict__ idx,
                             int* __restrict__ out, int n) {
  for (int i = grid_start(); i < n; i += grid_stride()) {
    int v = idx[i];
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      v = (v * 3 + 1) & 127;
      asm volatile("" : "+r"(v));   // keep the 64 steps from folding
    }
    out[i] = v;
  }
}

__global__ void copy_kernel(const int* __restrict__ idx, int* __restrict__ out,
                            int n) {
  for (int i = grid_start(); i < n; i += grid_stride()) out[i] = idx[i];
}

}  // namespace

// variant: the Variant codes above; entries: 128 or 256 (table variants);
// depth: the chain length (kChain*); width: the row width of kRunSumWide's
// layout; threads: the block size (a multiple of 32, at most 1024).
extern "C" int planet_t_lut(int variant, const void* idx_, const void* table_,
                            void* out_, int n, int entries, int depth,
                            int width, int threads, void* stream) {
  if (n <= 0 || threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  if ((variant <= kShfl) && entries != 128 && entries != 256)
    return (int)cudaErrorInvalidValue;
  if ((variant == kSmemHalves || variant == kSmemHalvesF32) && entries != 256)
    return (int)cudaErrorInvalidValue;
  if (variant == kRunSumWide && (width < 128 || width % 128 || width > 2048))
    return (int)cudaErrorInvalidValue;
  const int* idx = (const int*)idx_;
  const int* table = (const int*)table_;
  int* out = (int*)out_;
  const long long want = ((long long)n + threads - 1) / threads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kSmem:
      smem_kernel<int><<<blocks, threads, 0, s>>>(idx, table, out, n, entries);
      break;
    case kSmemF32:
      smem_kernel<float><<<blocks, threads, 0, s>>>(
          idx, (const float*)table_, (float*)out_, n, entries);
      break;
    case kSmemHalves:
      halves_kernel<int><<<blocks, threads, 0, s>>>(idx, table, out, n);
      break;
    case kSmemHalvesF32:
      halves_kernel<float><<<blocks, threads, 0, s>>>(
          idx, (const float*)table_, (float*)out_, n);
      break;
    case kLdg:
      ldg_kernel<<<blocks, threads, 0, s>>>(idx, table, out, n, entries);
      break;
    case kShfl:
      if (entries == 128)
        shfl_kernel<4><<<blocks, threads, 0, s>>>(idx, table, out, n);
      else
        shfl_kernel<8><<<blocks, threads, 0, s>>>(idx, table, out, n);
      break;
    case kMmaOnehot:
    case kMmaNibble: {
      // 16 lookups a warp tile
      const long long tiles = ((long long)n + 15) / 16;
      const long long wb = (tiles * 32 + threads - 1) / threads;
      const int mb = (int)(wb < kMaxBlocks ? wb : kMaxBlocks);
      if (variant == kMmaOnehot)
        mma_kernel<false><<<mb, threads, 0, s>>>(idx, table, out, n);
      else
        mma_kernel<true><<<mb, threads, 0, s>>>(idx, table, out, n);
      break;
    }
    case kRepeat:
      if (n % 8) return (int)cudaErrorInvalidValue;   // n = rows * 8 inputs
      repeat_kernel<<<(n / 8 * 128 + threads - 1) / threads, threads, 0, s>>>(
          idx, out, n / 8);
      break;
    case kChain:
      chain_kernel<kChain, false><<<blocks, threads, 0, s>>>(
          idx, table, out, n, depth, width);
      break;
    case kChainShfl:
      chain_kernel<kChain, true><<<blocks, threads, 0, s>>>(
          idx, table, out, n, depth, width);
      break;
    case kRunSum:
      chain_kernel<kRunSum, false><<<blocks, threads, 0, s>>>(
          idx, table, out, n, depth, width);
      break;
    case kRunSumShfl:
      chain_kernel<kRunSum, true><<<blocks, threads, 0, s>>>(
          idx, table, out, n, depth, width);
      break;
    case kRunSumWide:
      chain_kernel<kRunSumWide, false><<<blocks, threads, 0, s>>>(
          idx, table, out, n, depth, width);
      break;
    case kIndep:
      chain_kernel<kIndep, false><<<blocks, threads, 0, s>>>(
          idx, table, out, n, depth, width);
      break;
    case kIndepShfl:
      chain_kernel<kIndep, true><<<blocks, threads, 0, s>>>(
          idx, table, out, n, depth, width);
      break;
    case kArith:
      arith_kernel<<<blocks, threads, 0, s>>>(idx, out, n);
      break;
    case kCopy:
      copy_kernel<<<blocks, threads, 0, s>>>(idx, out, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
