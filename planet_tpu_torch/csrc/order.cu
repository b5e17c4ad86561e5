// The fused frame's DFS order as one kernel (order_kernel): R1's leaves, in
// level order at [0, n), put in the reference's DFS leaf-emission order
// (ProcessQuad recurses children 0-3, main.cpp:591-594) and cut to the
// first render_cap, with the render cap's overflow and the clamped count.
// planet_tpu does this in XLA in its geometry jit (a stable sort of packed
// keys, planet_tpu/engine/device_step.py), not in Pallas, so this kernel
// replaces no TPU kernel: on the card the composed torch ops were some 64
// launches a frame (PERF.md). Plain PyTorch version:
// planet_tpu_torch/lod/refine_device.py: dfs_order_plain (words_dfs_key,
// padding rows keyed past every leaf, a stable argsort, the gathers), which
// it equals bit for bit; the wrapper is
// planet_tpu_torch/ops/kernels/refine_cuda.py: dfs_order_cuda.
//
// A row's place is its rank: the live keys below its own, and the equal
// live keys of lower rows (the inverse of a stable argsort over the live
// rows). A padding row (at or past n) keys past every live row, so its
// rank is its own index. A block takes kRows rows and kParts threads a
// row; it stages the n live keys through shared memory a tile at a time,
// each part counting a slice of every tile, so the work follows the n read
// on the card: a block with no live row only copies the padding rows it
// holds below render_cap, and one past both leaves at once. A row ranked
// below render_cap then writes its 27 words (id lo, id hi, depth, 24
// corner rows) to that column. No float is computed: the outputs are
// copies of the inputs' words.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;                   // rows a block, a lane each
constexpr int kThreads = 256;
constexpr int kParts = kThreads / kRows;    // threads a row: the warps
constexpr int kTile = kThreads;             // keys staged a tile
constexpr int kCornerRows = 12;             // hi or lo: corner*3 + axis
constexpr int kWords = 3 + 2 * kCornerRows;
constexpr int kPathBits = 54;               // 27 two-bit digits

// quadid.words_dfs_key on one id's words: the root at bits 54-56 and the
// path's digits reversed in place, cut to the id's depth (at most 27)
__device__ __forceinline__ uint64_t dfs_key(int lo, int hi) {
  int depth = (hi >> 23) & 31;
  depth = depth < 27 ? depth : 27;
  uint64_t path = ((uint64_t)((uint32_t)hi & ((1u << (kPathBits - 32)) - 1))
                   << 32) | (uint32_t)lo;
  path &= (1ull << (2 * depth)) - 1;
  path = ((path >> 2) & 0x3333333333333333ull)
       | ((path & 0x3333333333333333ull) << 2);
  path = ((path >> 4) & 0x0F0F0F0F0F0F0F0Full)
       | ((path & 0x0F0F0F0F0F0F0F0Full) << 4);
  path = ((path >> 8) & 0x00FF00FF00FF00FFull)
       | ((path & 0x00FF00FF00FF00FFull) << 8);
  path = ((path >> 16) & 0x0000FFFF0000FFFFull)
       | ((path & 0x0000FFFF0000FFFFull) << 16);
  path = (path >> 32) | (path << 32);
  path = (path >> (64 - kPathBits)) & ((1ull << kPathBits) - 1);
  return ((uint64_t)(((uint32_t)hi >> 28) & 7) << kPathBits) | path;
}

struct Leaves {
  const int *lo, *hi, *depth;
  const float *c_hi, *c_lo;   // (12, cap)
};

struct Ordered {
  int *lo, *hi, *depth;
  float *c_hi, *c_lo;         // (12, render_cap)
  int* n;
  unsigned char* overflowed;
};

__global__ void __launch_bounds__(kThreads)
order_kernel(Leaves in, const int* __restrict__ n_in,
             const unsigned char* __restrict__ over_in, Ordered out, int cap,
             int render_cap) {
  __shared__ uint64_t keys[kTile];
  __shared__ int counts[kParts][kRows];
  __shared__ int rank[kRows];
  const int n_raw = *n_in;
  const int n = n_raw < 0 ? 0 : n_raw > cap ? cap : n_raw;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *out.n = n_raw < render_cap ? n_raw : render_cap;
    *out.overflowed = (*over_in != 0 || n_raw > render_cap) ? 1 : 0;
  }
  const int row0 = blockIdx.x * kRows;
  if (row0 >= n && row0 >= render_cap) return;   // uniform in the block
  const int lane = threadIdx.x % kRows, part = threadIdx.x / kRows;
  const int i = row0 + lane;
  if (row0 < n) {
    const uint64_t own = i < n ? dfs_key(in.lo[i], in.hi[i]) : 0;
    int c = 0;
    for (int base = 0; base < n; base += kTile) {
      __syncthreads();                 // the last tile has been read
      const int j = base + threadIdx.x;
      if (j < n) keys[threadIdx.x] = dfs_key(in.lo[j], in.hi[j]);
      __syncthreads();
      // this part's slice of the tile: keys [kRows part, kRows part + m)
      const int first = base + kRows * part;
      const int m = min(kRows, n - first);
      for (int k = 0; k < m; ++k) {
        const uint64_t key = keys[kRows * part + k];
        c += (key < own) | ((key == own) & (first + k < i));
      }
    }
    counts[part][lane] = c;
    __syncthreads();
    if (part == 0) {
      int r = i;                       // a padding row keeps its index
      if (i < n) {
        r = 0;
        for (int p = 0; p < kParts; ++p) r += counts[p][lane];
      }
      rank[lane] = r;
    }
  } else if (part == 0) {
    rank[lane] = i;
  }
  __syncthreads();
  // the rows ranked below render_cap: word w of row `lane` on part w %
  // kParts, consecutive lanes reading consecutive columns
  const int r = rank[lane];
  if (i >= cap || r >= render_cap) return;
  for (int w = part; w < kWords; w += kParts) {
    if (w < 3) {
      const int* src = w == 0 ? in.lo : w == 1 ? in.hi : in.depth;
      int* dst = w == 0 ? out.lo : w == 1 ? out.hi : out.depth;
      dst[r] = src[i];
    } else {
      const int c = w - 3, lo = c >= kCornerRows;
      const int row = c - kCornerRows * lo;
      const float* src = lo ? in.c_lo : in.c_hi;
      float* dst = lo ? out.c_lo : out.c_hi;
      dst[(size_t)row * render_cap + r] = src[(size_t)row * cap + i];
    }
  }
}

}  // namespace

// lo, hi, depth (cap,) int32 and c_hi, c_lo (12, cap) f32 lane-major DF
// corners: R1's leaves, in level order at [0, n); n () int32 and
// overflowed () bool on the card -> lo, hi, depth (render_cap,) int32,
// c_hi, c_lo (12, render_cap) f32 in DFS order, n_out () int32 (n clamped
// to render_cap), over_out () bool (overflowed or n > render_cap).
extern "C" int planet_dfs_order(const void* lo, const void* hi,
                                const void* depth, const void* c_hi,
                                const void* c_lo, const void* n,
                                const void* overflowed, int cap,
                                int render_cap, void* out_lo, void* out_hi,
                                void* out_depth, void* out_c_hi,
                                void* out_c_lo, void* n_out, void* over_out,
                                void* stream) {
  if (cap <= 0 || render_cap <= 0 || render_cap > cap)
    return (int)cudaErrorInvalidValue;
  const Leaves in{(const int*)lo, (const int*)hi, (const int*)depth,
                  (const float*)c_hi, (const float*)c_lo};
  const Ordered out{(int*)out_lo, (int*)out_hi, (int*)out_depth,
                    (float*)out_c_hi, (float*)out_c_lo, (int*)n_out,
                    (unsigned char*)over_out};
  const int blocks = (cap + kRows - 1) / kRows;
  order_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      in, (const int*)n, (const unsigned char*)overflowed, out, cap,
      render_cap);
  return (int)cudaGetLastError();
}
