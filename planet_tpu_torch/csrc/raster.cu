// Exact-coverage raster kernels: the record gather (K6) and the span (K2)
// and huge (K3) fragment kernels, which min-merge packed
// (21-bit depth << 10 | 10-bit shade) int32 keys into an exact (H, W)
// framebuffer with atomicMin.
//
// Replaces, in planet_tpu/raster/coverage_pallas.py:
//   _tr_kernel (via _transpose_records)       -> gather_records_kernel
//   _raster_class_kernel / _one_triangle      -> span_kernel
//   _huge_class_kernel / _one_huge            -> huge_kernel
// Plain PyTorch versions: planet_tpu_torch/raster/coverage_cuda.py
// (gather_records_plain, raster_span_plain, raster_huge_plain).
//
// Records are coverage.setup_t's 32-float layout, one 128-byte row each:
//   0-8 edge (DX, DY, c) x3 | 9-11 z | 12-14 1/w | 15-23 normal*(1/w)
//   (vertex-major, all inv_area-folded) | 24-27 clamped bbox px0 py0 px1 py1
//   | 28: 0 dead, -1 live, +1/far live far-straddler | 29-31 accept biases.
//
// What bounds the span kernel on the H100: latency and instruction issue,
// not bytes.
// The 1080p LOD scene has ~36k span records whose bboxes hold 189 pixels
// at the median (2035 at p99), 1.15e7 in all, of which 28% pass the three
// edge tests (3.2e6 fragments); the records are 4.6 MB and the
// framebuffer (8.3 MB) stays in the 50 MB L2. Scanning every bbox pixel
// (the first port: a warp a record, an integer divide a pixel) spent its
// time on rejected pixels, with the warp running the shading path whenever
// one lane accepted.
// Design: exact row intervals. Along one bbox row an edge function
// ((DX ry - DY rx) + c) is a monotone function of the column rx — fl(DX ry)
// is fixed, fl(DY rx) is monotone in rx because rounding is monotone, and
// the subtraction and the add are monotone in their varying operand — so
// the columns passing the edge's test form a prefix (DY > 0) or a suffix
// (DY < 0) of the row, or all or none of it (DY = 0), and the pixels passing
// all three tests form one interval. The kernel finds each row's boundaries
// from the line's estimate, settled with the exact f32 test fragment()
// runs (edge_value, fragment.cuh) by probing around it and bisecting, then
// runs the unchanged fragment() on the interval's pixels only: every pixel
// outside fails fragment()'s edge test, so the framebuffer is the bbox
// scan's bit for bit. A record with an edge word that is not finite or is
// at least kEdgeLimit (where a product could overflow and inf - inf give
// NaN) is scanned whole, with the same fragment().
// Traversal: one warp a record at a time, warps striding over the records
// (span_kernel); the grid stops at the caller's blocks an SM
// (coverage_cuda.SPAN_BLOCKS_PER_SM). The warp loads its record as eight
// 16-byte reads (broadcast through L1), takes 32
// rows at a time — a lane a row computes its interval — prefix-sums their
// lengths and strides over the flattened inside pixels, two a lane an
// iteration, each lane finding their rows by binary searches over the
// sums with shuffles (interleaved, so their latencies overlap): no integer
// divide. On the 1080p scene the time splits into the record read (~20
// %), the row intervals (~15 %), the pixel loop and its atomics (~30 %)
// and the fragment math (~35 %). Consecutive records sharing a warp (2, 4
// or 8, lane groups of 16, 8 or 4 chosen on the card from the largest
// bbox) measured slower, more so the more records a warp held: a warp's
// records run one after another, and the large ones near the camera come
// in runs; the stride pairs records far apart instead.
// The huge kernel gives each record a 2-D grid of 16x16 pixel tiles
// (block y strides over the record's bbox tiles), so a screen-filling
// triangle spreads over many SMs. The gather is a 32x32 shared-memory
// transpose tile.
//
// The TPU-only machinery does not come across: no class caps or ladder, no
// _class_fixup window addressing, no per-block flags, no framebuffer
// padding. atomicMin is order-independent, so the image is deterministic.
//
// Fragment math (fragment.cuh, shared with the span cost split in
// bench_span.cu) is coverage._fragments' op order, compiled with
// -fmad=false -prec-div=true -prec-sqrt=true: coverage, depth and shade
// equal the plain version's bit for bit. A rejected fragment's packed key
// is never computed or merged.

#include "fragment.cuh"

namespace {

using namespace raster_core;

constexpr int kSpanThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// edge words below this magnitude keep every product and sum of an edge
// function over a bbox under 2^24 pixels a side finite (2^100 2^24 < 2^128)
constexpr float kEdgeLimit = 0x1p100f;

// The first column b in [0, bw] where edge k (DY = r[3k + 1] != 0) flips
// along row ry: for DY > 0 the edge passes exactly at the columns below b,
// for DY < 0 exactly at b and above. The estimate from the line only
// guides the search; the answer comes from the exact test.
__device__ __forceinline__ int row_boundary(const float* r, int k, float ry,
                                            int bw) {
  const bool pos = r[3 * k + 1] > 0.0f;
  const float bias = r[29 + k];
  // before(x): x lies before the boundary
  auto before = [&](int x) {
    return (edge_value(r, k, (float)x, ry) > bias) == pos;
  };
  float t = __fdividef((r[3 * k] * ry + r[3 * k + 2]) - bias, r[3 * k + 1]);
  t = fminf(fmaxf(t, -0x1p30f), 0x1p30f);        // NaN -> -2^30
  const int g = min(max((int)(pos ? ceilf(t) : floorf(t) + 1.0f), 0), bw);
  int lo = 0, hi = bw;                           // b in [lo, hi]
  if (g > 0) {
    if (before(g - 1)) lo = g; else hi = g - 1;
  }
  if (g < bw && lo == g) {
    if (before(g)) lo = g + 1; else hi = g;
  }
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(mid)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The columns [lo, hi] of row ry whose pixels pass all three edge tests
// (lo > hi when none does).
__device__ __forceinline__ void row_interval(const float* r, int ry, int bw,
                                             int& lo, int& hi) {
  const float fy = (float)ry;
  lo = 0;
  hi = bw - 1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (lo > hi) return;
    const float dy = r[3 * k + 1];
    if (dy > 0.0f) {
      hi = min(hi, row_boundary(r, k, fy, bw) - 1);
    } else if (dy < 0.0f) {
      lo = max(lo, row_boundary(r, k, fy, bw));
    } else if (!(edge_value(r, k, 0.0f, fy) > r[29 + k])) {
      hi = -1;                                   // flat along the row
    }
  }
}

// The rows among the warp's 32 (incl: each row's inclusive prefix sum of
// interval lengths) that hold flattened inside pixels i0 and i1: the
// number of rows whose sum is at most each (two binary searches over the
// lanes, interleaved).
__device__ __forceinline__ void rows_of(int incl, int i0, int i1, int& j0,
                                        int& j1) {
  j0 = 0, j1 = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const int v0 = __shfl_sync(kFull, incl, j0 + step - 1);
    const int v1 = __shfl_sync(kFull, incl, j1 + step - 1);
    if (v0 <= i0) j0 += step;
    if (v1 <= i1) j1 += step;
  }
}

// One record by one warp.
__device__ __forceinline__ void span_record(const float* __restrict__ rec,
                                            int lane, int* __restrict__ fb,
                                            int width, bool wireframe) {
  float r[32];
  const float4* q = reinterpret_cast<const float4*>(rec);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 v = q[k];
    r[4 * k] = v.x, r[4 * k + 1] = v.y, r[4 * k + 2] = v.z,
    r[4 * k + 3] = v.w;
  }
  if (r[28] == 0.0f) return;
  const int px0 = (int)r[24], py0 = (int)r[25];
  const int bw = (int)r[26] - px0 + 1, bh = (int)r[27] - py0 + 1;
  bool scan = false;
#pragma unroll
  for (int k = 0; k < 12; ++k)
    scan |= !(fabsf(r[k < 9 ? k : k + 20]) < kEdgeLimit);
  if (scan) {
    for (int i = lane; i < bw * bh; i += 32) {
      const int ry = i / bw, rx = i - ry * bw;
      fragment<false>(r, px0 + rx, py0 + ry, rx, ry, width, wireframe, fb);
    }
    return;
  }
  for (int row0 = 0; row0 < bh; row0 += 32) {
    int lo = 0, len = 0;
    if (row0 + lane < bh) {
      int hi;
      row_interval(r, row0 + lane, bw, lo, hi);
      len = max(hi - lo + 1, 0);
    }
    int incl = len;                              // inclusive prefix sum
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int excl = incl - len;
    const int total = __shfl_sync(kFull, incl, 31);
    // two pixels a lane an iteration, their row searches interleaved
    for (int base = 0; base < total; base += 64) {
      const int i0 = base + lane, i1 = i0 + 32;
      int j0, j1;
      rows_of(incl, i0, i1, j0, j1);
      const int c0 = __shfl_sync(kFull, lo, j0) + i0
          - __shfl_sync(kFull, excl, j0);
      const int c1 = __shfl_sync(kFull, lo, j1) + i1
          - __shfl_sync(kFull, excl, j1);
      if (i0 < total)
        fragment<false>(r, px0 + c0, py0 + row0 + j0, c0, row0 + j0, width,
                        wireframe, fb);
      if (i1 < total)
        fragment<false>(r, px0 + c1, py0 + row0 + j1, c1, row0 + j1, width,
                        wireframe, fb);
    }
  }
}

// Warp w takes records w, w + W, w + 2W, ... (W the grid's warps): a warp
// done with a small record goes on to its next at once, and records far
// apart in the array (the large ones near the camera come in runs) share
// a warp.
__global__ void __launch_bounds__(kSpanThreads)
span_kernel(const float* __restrict__ recs, int m, int* __restrict__ fb,
            int width, int wireframe) {
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long w = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
       w < m; w += warps)
    span_record(recs + w * 32, threadIdx.x & 31, fb, width, wireframe != 0);
}

constexpr int kTile = 16;
constexpr int kHugeStride = 64;    // blocks per record; each strides tiles

__global__ void __launch_bounds__(kTile * kTile)
huge_kernel(const float* __restrict__ recs, int* __restrict__ fb, int width,
            int wireframe) {
  __shared__ float r[32];
  const int t = threadIdx.y * kTile + threadIdx.x;
  if (t < 32) r[t] = recs[(size_t)blockIdx.x * 32 + t];
  __syncthreads();
  if (r[28] == 0.0f) return;
  const int px0 = (int)r[24], py0 = (int)r[25];
  const int px1 = (int)r[26], py1 = (int)r[27];
  const int ntx = (px1 - px0) / kTile + 1;
  const int nty = (py1 - py0) / kTile + 1;
  for (int tile = blockIdx.y; tile < ntx * nty; tile += gridDim.y) {
    const int rx = (tile % ntx) * kTile + threadIdx.x;
    const int ry = (tile / ntx) * kTile + threadIdx.y;
    if (px0 + rx <= px1 && py0 + ry <= py1)
      fragment<true>(r, px0 + rx, py0 + ry, rx, ry, width, wireframe != 0, fb);
  }
}

// out[j, k] = tm[k, idx[j]] for idx[j] in [0, n), else 0 (a dead record)
__global__ void gather_records_kernel(const float* __restrict__ tm,
                                      const int* __restrict__ idx,
                                      float* __restrict__ out, int m, int n) {
  __shared__ float tile[32][33];
  const int j0 = blockIdx.x * 32;
  const int tx = threadIdx.x;
  const int j = j0 + tx;
  const int src = j < m ? idx[j] : -1;
  for (int k = threadIdx.y; k < 32; k += blockDim.y)
    tile[k][tx] = (src >= 0 && src < n) ? tm[(size_t)k * n + src] : 0.0f;
  __syncthreads();
  for (int jj = threadIdx.y; jj < 32; jj += blockDim.y)
    if (j0 + jj < m) out[(size_t)(j0 + jj) * 32 + tx] = tile[tx][jj];
}

}  // namespace

extern "C" int planet_gather_records(const void* tm, const void* idx,
                                     void* out, int m, int n, void* stream) {
  if (m <= 0) return (int)cudaErrorInvalidValue;
  gather_records_kernel<<<(m + 31) / 32, dim3(32, 8), 0,
                          (cudaStream_t)stream>>>(
      (const float*)tm, (const int*)idx, (float*)out, m, n);
  return (int)cudaGetLastError();
}

// recs must be 16-byte aligned (the wrapper checks). The grid: one warp a
// record up to blocks_per_sm blocks an SM, from the card's SM count
// (metadata, so the launch could be captured); beyond that each warp
// strides over several records. blocks_per_sm 0: one warp a record,
// however many.
extern "C" int planet_raster_span(const void* recs, int m, void* fb, int width,
                                  int height, int wireframe, int blocks_per_sm,
                                  void* stream) {
  (void)height;
  int device = 0, sms = 0;
  if (m <= 0 || blocks_per_sm < 0 || ((size_t)recs & 15) != 0 ||
      cudaGetDevice(&device) != 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          0)
    return (int)cudaErrorInvalidValue;
  const long long one_a_record = ((long long)m * 32 + kSpanThreads - 1) /
                                 kSpanThreads;
  const long long cap = (long long)blocks_per_sm * sms;
  const long long blocks =
      blocks_per_sm == 0 || one_a_record < cap ? one_a_record : cap;
  span_kernel<<<(unsigned)blocks, kSpanThreads, 0, (cudaStream_t)stream>>>(
      (const float*)recs, m, (int*)fb, width, wireframe);
  return (int)cudaGetLastError();
}

extern "C" int planet_raster_huge(const void* recs, int m, void* fb, int width,
                                  int height, int wireframe, void* stream) {
  (void)height;
  if (m <= 0 || m > 0x7fffffff) return (int)cudaErrorInvalidValue;
  huge_kernel<<<dim3((unsigned)m, kHugeStride), dim3(kTile, kTile), 0,
                (cudaStream_t)stream>>>((const float*)recs, (int*)fb, width,
                                        wireframe);
  return (int)cudaGetLastError();
}
