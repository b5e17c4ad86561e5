// Exact-coverage raster kernels: the record route (K6) and the span (K2)
// and huge (K3) fragment kernels, which min-merge packed
// (21-bit depth << 10 | 10-bit shade) int32 keys into an exact (H, W)
// framebuffer with atomicMin.
//
// Replaces, in planet_tpu/raster/coverage_pallas.py:
//   _tr_kernel (via _transpose_records), with the routing of
//   raster_frame_pallas folded in             -> route_offsets_kernel,
//                                                route_scatter_kernel
//                                                (the classes from C1,
//                                                csrc/setup.cu)
//   _raster_class_kernel / _one_triangle      -> span_kernel
//   _huge_class_kernel / _one_huge            -> huge_kernel
// Plain PyTorch versions: planet_tpu_torch/raster/coverage_cuda.py
// (route_records_plain, raster_span_plain, raster_huge_plain).
//
// Records are coverage.setup_t's 32-float layout, one 128-byte row each:
//   0-8 edge (DX, DY, c) x3 | 9-11 z | 12-14 1/w | 15-23 normal*(1/w)
//   (vertex-major, all inv_area-folded) | 24-27 clamped bbox px0 py0 px1 py1
//   | 28: 0 dead, -1 live, +1/far live far-straddler | 29-31 accept biases.
//
// Exact row intervals (K2 and K3). Along one bbox row an edge function
// ((DX ry - DY rx) + c) is a monotone function of the column rx — fl(DX ry)
// is fixed, fl(DY rx) is monotone in rx because rounding is monotone, and
// the subtraction and the add are monotone in their varying operand — so
// the columns passing the edge's test form a prefix (DY > 0) or a suffix
// (DY < 0) of the row, or all or none of it (DY = 0), and the pixels passing
// all three tests form one interval. row_interval finds a row's boundaries
// from the line's estimate, settled with the exact f32 test fragment()
// runs (edge_value, fragment.cuh) by probing around it and bisecting; the
// kernels then run the unchanged fragment() on the interval's pixels only:
// every pixel outside fails fragment()'s edge test, which comes before
// its depth and 1/w tests, so the framebuffer is the bbox scan's bit for
// bit. A record with an edge word that is not finite or is at least
// kEdgeLimit (where a product could overflow and inf - inf give NaN) gets
// its whole bbox row as its interval, with the same fragment().
//
// K2, span_kernel. What bounds it on the H100: latency and instruction
// issue, not bytes (its bound by bytes is 3-9 times below its time on the
// record sets below). Two kinds of record set meet it. The 1080p LOD scene:
// ~36k span records, bboxes of 189 pixels at the median (2035 at p99), 12
// rows and 90 inside pixels on average; the records are 4.6 MB and the
// framebuffer (8.3 MB) stays in the 50 MB L2. The dense and config-3 frames,
// about a triangle a pixel: 430k-570k records of 14-35 bbox pixels at the
// median, 3-5 rows and 6-12 inside pixels, on which one warp a record kept
// 80-90 % of its lanes idle through each record's chain of loads, interval
// searches, scans and fragments. The grid comes from the caller's capacity
// and stops at its blocks an SM (coverage_cuda.SPAN_BLOCKS_PER_SM), and the
// record count is read on the device (warps past it leave), so the launch
// needs no host read. Warp w takes records w, w + W, w + 2W, ... (W the
// grid's warps) up to 32 at a time, a batch: records far apart in the array
// (the large ones near the camera come in runs) share its lanes. The warp
// stages the batch in shared memory (four whole records a 16-byte load, rows
// padded to 33 words); a lane a record finds its rows and whether it is
// scanned whole; a prefix sum flattens the batch's rows, and the lanes take
// them 32 at a time (a pass), a lane a row, each finding its record by a
// binary search over the sums with shuffles and computing its row's exact
// interval; a second prefix sum flattens the pass's inside pixels, and the
// lanes stride over them two a lane an iteration, each finding its pixel's
// row by a search and reading the row's record words into registers before
// fragment() tests them. A batch of one record (every batch when the count
// is at most W, as on the goldens, and a warp's last when one record is left
// over) skips the staging: each lane reads the record from global memory
// (broadcast through L1) and the warp takes its rows 32 at a time. So the
// lanes' work follows the records' sizes: the 1080p scene's batches hold 2-3
// records of about a pass of rows, the dense frame's 25-26 records and ~4
// passes, and the busy share of the lanes' row and pixel slots
// (coverage_cuda.span_batch_stats) rises from 17 and 20 % to 90 and 66 %
// there, from 9 and 9 % to 70 and 56 % on the config-3 flight. Measured
// (tools/kernel_times.py, queued, one warp a record -> batches): dense frame
// 0.267 -> 0.093 ms, config-3 flight 0.339 -> 0.081, 1080p scene 0.044 ->
// 0.048, the goldens within 2 %. Measured and dropped: fragment() reading
// its record's words from shared memory as it tests them (each test then
// waited for its own round trip: 1080p +10 %, near-clip golden +38 %); the
// batch's records with bboxes over 256, 1024 or 4096 pixels taken a warp
// each, as before (70 registers; 1080p 12-17 % slower than one warp a
// record); a pass whose rows are one record's drawn with that record's words
// in registers (70 registers; the dense and config-3 sets 5-6 % slower,
// 1080p 2 %); two neighbouring pixels a lane, sharing one read of their
// record's words (70 registers; 6-13 % slower); 10 and 12 blocks an SM by
// launch bounds (48 and 40 registers with a stack; 4 % faster at best, at 12
// slower). One warp a record measured slower with consecutive records
// sharing a warp and without the stride (on the 1080p scene, before the
// batches).
//
// K3, huge_kernel: the huge class — records whose bbox touches more than
// 16 aligned 8-row blocks, far-straddlers (with the interpolated-1/w
// tests) and clipped near-plane triangles — is few records with large
// bboxes (7 on the near-clip golden, up to the whole screen) or many small
// ones (704 far-straddlers on the far-clip golden). The first port gave
// each record 64 blocks of 16x16 tiles whatever its size and ran
// fragment() on every bbox pixel: ~30 fragments a thread in a row for a
// screen-filling bbox, and 45,056 blocks for the far-clip records, most
// of which found no tile; both go. Now the grid is sized by pixels, a
// block a screen row: it tests the records' bboxes 1024 at a time, four a
// thread, each with one 16-byte read of its bbox words; the records
// holding its row are compacted (a block prefix sum) and staged in shared
// memory, a thread a record computes the row's exact interval, and the
// block's threads stride over the flattened inside pixels of all of
// them, two a thread an iteration (a binary search over the intervals'
// prefix sums in shared memory). So a record's inside pixels spread over
// as many blocks as it has rows, and a small record costs the blocks of
// its own rows only a bbox test. The grid depends on H alone and the
// count is read on the device, so the launch needs no host read either;
// a block reads the bboxes of the first `count` records alone, and with
// a count of 0 it leaves at once (the clip pass of a frame with no
// straddler: planet_tpu skips the pass behind a lax.cond).
// Measured and dropped (PERF.md): several rows a block (slower on
// large records, faster on many small ones), a pass counting each
// record's bbox rows with a fixed grid striding over the flattened rows
// (faster only on the far-clip records), reading the records from global
// memory instead of staging them, and three 4-byte bbox reads (a warp's
// read touches 32 lines each time). What is left on the near-clip
// records: the queued launch's floor (~5 us) and the fragment math; on
// many small records, every block testing every record's bbox.
//
// K6, route_offsets_kernel + route_scatter_kernel: the route and the
// gather of raster_frame in two launches, with the counts left on the
// device. The (32, N) record matrix is column-major and the live columns
// (~8 % at 1080p) are scattered, so a warp's load of one word of 32
// records touches up to 32 sectors and no gather from this layout reads
// fewer; what K6 does away with is the work around the gather: the
// elementwise route over all N candidates, two nonzero() host
// synchronisations, and a gather launch per class. The route itself comes
// from C1 (setup_kernel, csrc/setup.cu): a C1 block is one of K6's tiles of
// 256 candidates, and it writes, from the words it holds in registers, a
// ballot mask a class for every 32 candidates (span class: live, at most
// max_span 8-row blocks tall, not a far-straddler; huge class: the other
// live ones), masks[2 w + c] for word w of class c, and each block's two
// counts after the masks, in the scratch that the wrapper sizes
// (coverage_cuda.route_scratch_ints). The scan, one block of 1024 threads,
// turns the count pairs into each block's two exclusive class offsets in
// place (tiles of 2 pairs a thread, the next tile read while one is
// scanned, a block prefix sum, the running totals carried) and writes the
// two totals. The scatter reads its block's offsets and the next block's
// (their differences are its counts; a block with none leaves there),
// prefix-sums its 8 mask words, lists its live candidates in candidate
// order in shared memory, and gathers them a warp 32 records (a lane a
// record, 32 loads in flight), writing each record as one coalesced
// 128-byte row to its class's buffer through a padded shared-memory
// transpose. The scan is C1's programmatic dependent and the scatter the
// scan's (Hopper's griddepcontrol), so each launch overlaps the tail of
// the one before. Blocks take 256 candidates, not more: the live ones
// cluster (a visible patch's triangles are contiguous), and with 1024 a
// block a few blocks gathered several chunks in a row. Until the scan,
// each scatter block summed the counts of every block before it: B^2
// reads for B blocks, a few us at config 4's 1,680 blocks (430,080
// candidates) but ~4.9 G reads of L2 at config 3's 69,696 (2,048 rows x
// 8,712 candidates), where that pass took 2.2 of the frame's 3.7 busy ms.
// Queued (tools/kernel_times.py, one H100): the whole of K6 0.0147-0.0153
// -> 0.0140-0.0142 ms at 1,680 blocks and 2.344-2.345 -> 0.2374-0.2379 ms
// at 69,696 (565,877 live; bound 0.0912, bytes). Until C1 wrote the
// route, a first pass of K6 (a thread a candidate) read live, span and row
// 28 back for all N candidates, 9 B each, padding rows included, to form
// the same bits: 0.087 of the p64 frame's traced ms and 0.042 of the dense
// frame's. With C1 writing the route, K6 (the scan and the scatter) is
// 0.154-0.157 ms queued at 69,696 blocks and 0.0110-0.0116 at 1,680;
// C1 + K6 0.476-0.480 -> 0.385 ms at config 3's flight. Measured
// and dropped: a decoupled look-back in
// the first pass (blocks in ticket order, status words zero-filled each
// call), 0.0214 and 0.3523 ms; the scatter reading its mask words before
// it knows it is empty, 0.2767 against 0.2535 ms at 69,696 (with an 8-pair
// scan). The first port's index input goes with the route it came from
// (and with it the dead record an out-of-range index gave); its padded
// 32x32 transpose stays, a warp's tile.
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

// Whether a record's rows are scanned whole: an edge word or accept bias
// that is not finite or reaches kEdgeLimit.
__device__ __forceinline__ bool scan_whole(const float* r) {
  bool scan = false;
#pragma unroll
  for (int k = 0; k < 12; ++k)
    scan |= !(fabsf(r[k < 9 ? k : k + 20]) < kEdgeLimit);
  return scan;
}

// Inclusive prefix sum of v over the warp's lanes.
__device__ __forceinline__ int warp_incl(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// The lane that holds flattened item i (incl: each lane's inclusive
// prefix sum of its items): the number of lanes whose sum is at most i,
// by a binary search over the lanes with shuffles (32 when i is past the
// last item).
__device__ __forceinline__ int lane_of(int incl, int i) {
  int j = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (__shfl_sync(kFull, incl, j + step - 1) <= i) j += step;
  return j;
}

// lane_of for two items, the two searches interleaved.
__device__ __forceinline__ void lanes_of(int incl, int i0, int i1, int& j0,
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

// The number of records a launch draws: the device count where the
// caller passes one (at most the capacity), else the capacity.
__device__ __forceinline__ int record_count(const int* count, int cap) {
  return count ? min(*count, cap) : cap;
}

// Words [kLo, kHi) of a staged record into registers, the loads issued
// together: volatile, so that the compiler cannot sink each load to its
// first use, where fragment()'s early-out tests would wait for them one
// shared-memory round trip at a time.
template <int kLo, int kHi>
__device__ __forceinline__ void load_words(const float* src, float* q) {
  const volatile float* v = src;
#pragma unroll
  for (int k = kLo; k < kHi; ++k) q[k] = v[k];
}

// The words fragment<false>() reads (all but 26-28) of a staged record.
__device__ __forceinline__ void load_fragment_words(const float* src,
                                                    float* q) {
  load_words<0, 26>(src, q);
  load_words<29, 32>(src, q);
}

// One record by the whole warp, from global memory (a batch of one):
// each lane reads the record, eight 16-byte reads broadcast through L1;
// its rows 32 at a time, a lane a row, then their inside pixels two a
// lane an iteration.
__device__ __forceinline__ void span_record(const float* __restrict__ rec,
                                            int lane, int* __restrict__ fb,
                                            int width, bool wf) {
  float r[32];
  const float4* q = reinterpret_cast<const float4*>(rec);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 v = q[k];
    r[4 * k] = v.x, r[4 * k + 1] = v.y, r[4 * k + 2] = v.z,
    r[4 * k + 3] = v.w;
  }
  if (r[28] == 0.0f) return;
  const bool whole = scan_whole(r);
  const int px0 = (int)r[24], py0 = (int)r[25];
  const int bw = (int)r[26] - px0 + 1, bh = (int)r[27] - py0 + 1;
  for (int row0 = 0; row0 < bh; row0 += 32) {
    int lo = 0, len = 0;
    if (row0 + lane < bh) {
      int hi = bw - 1;
      if (!whole) row_interval(r, row0 + lane, bw, lo, hi);
      len = max(hi - lo + 1, 0);
    }
    const int incl = warp_incl(len, lane);
    const int col = lo - (incl - len);
    const int total = __shfl_sync(kFull, incl, 31);
    for (int base = 0; base < total; base += 64) {
      const int i0 = base + lane, i1 = i0 + 32;
      int j0, j1;
      lanes_of(incl, i0, i1, j0, j1);
      const int c0 = __shfl_sync(kFull, col, j0) + i0;
      const int c1 = __shfl_sync(kFull, col, j1) + i1;
      if (i0 < total)
        fragment<false>(r, px0 + c0, py0 + row0 + j0, c0, row0 + j0, width,
                        wf, fb);
      if (i1 < total)
        fragment<false>(r, px0 + c1, py0 + row0 + j1, c1, row0 + j1, width,
                        wf, fb);
    }
  }
}

// Warp w takes records w, w + W, w + 2W, ... (W the grid's warps), 32 at
// a time: a batch, staged in shared memory a record a row (slot s: the
// batch's s-th record). The batch's rows are flattened over the lanes, a
// lane a row, 32 at a time (a pass); the inside pixels of a pass's rows
// are flattened over the lanes in turn, two a lane an iteration.
__global__ void __launch_bounds__(kSpanThreads)
span_kernel(const float* __restrict__ recs, const int* __restrict__ count,
            int cap, int* __restrict__ fb, int width, int wireframe) {
  __shared__ float s_rec[kSpanThreads / 32][32][33];   // padded rows
  const int m = record_count(count, cap);
  const int lane = threadIdx.x & 31;
  const bool wf = wireframe != 0;
  float (*batch)[33] = s_rec[threadIdx.x >> 5];
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long first = (blockIdx.x * (long long)blockDim.x + threadIdx.x)
                         >> 5;
       first < m; first += 32 * warps) {
    if (first + warps >= m) {           // a batch of one record
      span_record(recs + first * 32, lane, fb, width, wf);
      break;
    }
    // stage the batch: each load reads four whole records, 16 bytes a lane
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int s = 4 * k + (lane >> 3), q = lane & 7;
      const long long i = first + s * warps;
      if (i < m) {
        const float4 v = reinterpret_cast<const float4*>(recs + i * 32)[q];
        float* d = batch[s] + 4 * q;
        d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
      }
    }
    __syncwarp();
    // slot `lane`'s rows (none when dead or past m) and whether it is
    // scanned whole
    const float* mine = batch[lane];
    int bh = 0;
    bool whole = false;
    if (first + lane * warps < m && mine[28] != 0.0f) {
      bh = max((int)mine[27] - (int)mine[25] + 1, 0);
      whole = scan_whole(mine);
    }
    const int rows_incl = warp_incl(bh, lane);
    const int rows_excl = rows_incl - bh;
    const int rows = __shfl_sync(kFull, rows_incl, 31);
    const unsigned whole_mask = __ballot_sync(kFull, whole);
    for (int row0 = 0; row0 < rows; row0 += 32) {
      // flattened row t: its slot, its offset ry in the slot's bbox and
      // its exact interval
      const int t = row0 + lane;
      const int slot = lane_of(rows_incl, t);
      const int ry = t - __shfl_sync(kFull, rows_excl, slot);
      int lo = 0, len = 0;
      if (t < rows) {
        float r[32];
        load_words<0, 9>(batch[slot], r);
        load_words<24, 27>(batch[slot], r);
        load_words<29, 32>(batch[slot], r);
        const int bw = (int)r[26] - (int)r[24] + 1;
        int hi = bw - 1;
        if (!((whole_mask >> slot) & 1u)) row_interval(r, ry, bw, lo, hi);
        len = max(hi - lo + 1, 0);
      }
      const int incl = warp_incl(len, lane);
      const int total = __shfl_sync(kFull, incl, 31);
      const int col = lo - (incl - len);        // a pixel's column less i
      // two pixels a lane an iteration, their row searches interleaved;
      // each pixel's record words read into registers before its tests
      const int at = ry << 5 | (slot & 31);
      for (int base = 0; base < total; base += 64) {
        const int i0 = base + lane, i1 = i0 + 32;
        int j0, j1;
        lanes_of(incl, i0, i1, j0, j1);
        const int c0 = __shfl_sync(kFull, col, j0) + i0;
        const int c1 = __shfl_sync(kFull, col, j1) + i1;
        const int a0 = __shfl_sync(kFull, at, j0);
        const int a1 = __shfl_sync(kFull, at, j1);
        if (i0 < total) {
          float r[32];
          load_fragment_words(batch[a0 & 31], r);
          fragment<false>(r, (int)r[24] + c0, (int)r[25] + (a0 >> 5), c0,
                          a0 >> 5, width, wf, fb);
        }
        if (i1 < total) {
          float r[32];
          load_fragment_words(batch[a1 & 31], r);
          fragment<false>(r, (int)r[24] + c1, (int)r[25] + (a1 >> 5), c1,
                          a1 >> 5, width, wf, fb);
        }
      }
    }
    __syncwarp();                       // before the next batch is staged
  }
}

constexpr int kHugeThreads = 256;     // also the records staged a pass
constexpr int kHugeScan = 4;          // records a thread tests a pass

// Inclusive prefix sum of v over a huge-kernel block (all its threads
// must call it); total: the block's sum. s_warp holds a word a warp.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = warp_incl(v, lane);
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kHugeThreads / 32; ++w) {
    const int t = s_warp[w];
    before += w < warp ? t : 0;
    all += t;
  }
  __syncthreads();
  total = all;
  return x + before;
}

// Block y draws screen row y.
__global__ void __launch_bounds__(kHugeThreads)
huge_kernel(const float* __restrict__ recs, const int* __restrict__ count,
            int cap, int* __restrict__ fb, int width, int wireframe) {
  __shared__ float s_rec[kHugeThreads][33];        // staged records, padded
  __shared__ int s_hit[kHugeThreads * kHugeScan];  // their indices
  __shared__ int s_incl[kHugeThreads];             // rows' inclusive sums
  __shared__ int s_col[kHugeThreads];              // row's lo - its excl
  __shared__ int s_warp[kHugeThreads / 32];
  const int tid = threadIdx.x;
  const int m = record_count(count, cap);
  // no record to draw (the clip pass of a frame with no straddler, a
  // frame with no huge record): leave at once, as planet_tpu's lax.cond
  // skips the pass
  if (m == 0) return;
  const int y = blockIdx.x;
  const bool wf = wireframe != 0;
  auto draw = [&](int p, int px) {       // staged record p's inside pixel
    const float* r = s_rec[p];
    const int c = s_col[p] + px;
    fragment<true>(r, (int)r[24] + c, y, c, y - (int)r[25], width, wf, fb);
  };
  // the records among the next 1024 whose bbox rows hold y (one 16-byte
  // read of px0 py0 px1 py1 each; dead records are dropped when staged)
  int base = 0;
  do {
    bool hit[kHugeScan];
    int nh = 0;
#pragma unroll
    for (int j = 0; j < kHugeScan; ++j) {
      const int i = base + j * kHugeThreads + tid;
      hit[j] = false;
      if (i < m) {
        const float4 b = reinterpret_cast<const float4*>(recs)[i * 8LL + 6];
        hit[j] = (int)b.y <= y && (int)b.w >= y;
      }
      nh += hit[j];
    }
    int nhit;
    int at = block_scan(nh, s_warp, nhit) - nh;
#pragma unroll
    for (int j = 0; j < kHugeScan; ++j)
      if (hit[j]) s_hit[at++] = base + j * kHugeThreads + tid;
    __syncthreads();
    for (int h0 = 0; h0 < nhit; h0 += kHugeThreads) {
      const int nrec = min(kHugeThreads, nhit - h0);
      for (int k = tid; k < nrec * 32; k += kHugeThreads)
        s_rec[k >> 5][k & 31] = recs[(size_t)s_hit[h0 + (k >> 5)] * 32
                                     + (k & 31)];
      __syncthreads();
      // staged record tid: its exact interval on row y
      const float* r = s_rec[tid];
      int lo = 0, len = 0;
      if (tid < nrec && r[28] != 0.0f) {
        const int bw = (int)r[26] - (int)r[24] + 1;
        int hi = bw - 1;
        if (!scan_whole(r)) row_interval(r, y - (int)r[25], bw, lo, hi);
        len = max(hi - lo + 1, 0);
      }
      int total;
      const int incl = block_scan(len, s_warp, total);
      s_incl[tid] = incl;
      s_col[tid] = lo - (incl - len);
      __syncthreads();
      // the records' flattened inside pixels, two a thread an iteration,
      // each pixel's record found by a binary search over the sums (the
      // two interleaved, as deep as the pass's records need)
      int top = 1;
      while (top < nrec) top <<= 1;
      for (int p0 = 0; p0 < total; p0 += 2 * kHugeThreads) {
        const int a = p0 + tid, b = a + kHugeThreads;
        int pa = 0, pb = 0;              // records whose sum is at most a, b
        for (int step = top >> 1; step > 0; step >>= 1) {
          if (s_incl[pa + step - 1] <= a) pa += step;
          if (s_incl[pb + step - 1] <= b) pb += step;
        }
        if (a < total) draw(pa, a);
        if (b < total) draw(pb, b);
      }
      __syncthreads();                   // before s_rec is staged again
    }
    base += kHugeThreads * kHugeScan;
  } while (base < m);
}

constexpr int kRouteThreads = 256;
// candidates a route block takes: C1's block (csrc/setup.cu kSetupThreads),
// whose class masks and counts it reads
constexpr int kRouteTile = kRouteThreads;
constexpr int kRouteWords = kRouteTile / 32;      // mask words a class
constexpr int kRouteWarps = kRouteThreads / 32;

// The scan between C1 and the scatter, one block: the block counts' pairs in
// tiles of kScanThreads * 2, each thread a run of two pairs (one 16-byte
// read, the next tile's issued before this tile is scanned), a block
// prefix sum of the runs' sums (one barrier a tile), then each pair
// overwritten with its exclusive offsets, the running totals carried to
// the next tile; the two totals go to counts. Runs of 8 and 4 pairs a
// thread measured slower at both of K6's shapes.
constexpr int kScanThreads = 1024;

// A thread's run: pairs first and first + 1 as (s, h, s, h), zeros past
// the last block.
__device__ __forceinline__ int4 load_run(const int* pairs, long long blocks,
                                         long long first) {
  if (first + 2 <= blocks)
    return *reinterpret_cast<const int4*>(pairs + 2 * first);
  if (first < blocks)
    return make_int4(pairs[2 * first], pairs[2 * first + 1], 0, 0);
  return make_int4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kScanThreads)
route_offsets_kernel(long long blocks, int* __restrict__ pairs,
                     int* __restrict__ counts) {
  // the warps' run sums, a buffer a tile parity: one barrier a tile
  __shared__ int s_warp[2][2][kScanThreads / 32];
  // the scatter's blocks may be scheduled now; this block waits for C1
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long step = 2LL * kScanThreads;
  int carry_s = 0, carry_h = 0, parity = 0;
  int4 v = load_run(pairs, blocks, 2LL * tid);
  for (long long base = 0; base < blocks; base += step, parity ^= 1) {
    const long long first = base + 2LL * tid;
    // the next tile's run, read while this one is scanned
    const int4 nv = base + step < blocks
                        ? load_run(pairs, blocks, first + step)
                        : make_int4(0, 0, 0, 0);
    const int ts = v.x + v.z, th = v.y + v.w;
    int is = ts, ih = th;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int us = __shfl_up_sync(kFull, is, d);
      const int uh = __shfl_up_sync(kFull, ih, d);
      if (lane >= d) is += us, ih += uh;
    }
    int (*sw)[kScanThreads / 32] = s_warp[parity];
    if (lane == 31) sw[0][warp] = is, sw[1][warp] = ih;
    __syncthreads();
    // every warp scans the warp sums itself: its offset and the tile's sum
    int ws = sw[0][lane], wh = sw[1][lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int us = __shfl_up_sync(kFull, ws, d);
      const int uh = __shfl_up_sync(kFull, wh, d);
      if (lane >= d) ws += us, wh += uh;
    }
    const int before_s = __shfl_sync(kFull, ws, (warp + 31) & 31);
    const int before_h = __shfl_sync(kFull, wh, (warp + 31) & 31);
    int os = carry_s + is - ts, oh = carry_h + ih - th;
    if (warp > 0) os += before_s, oh += before_h;
    carry_s += __shfl_sync(kFull, ws, 31);
    carry_h += __shfl_sync(kFull, wh, 31);
    const int4 out = make_int4(os, oh, os + v.x, oh + v.y);
    if (first + 2 <= blocks)
      *reinterpret_cast<int4*>(pairs + 2 * first) = out;
    else if (first < blocks)
      pairs[2 * first] = out.x, pairs[2 * first + 1] = out.y;
    v = nv;
  }
  if (tid == 0) counts[0] = carry_s, counts[1] = carry_h;
}

// The scatter: the block's live candidates in candidate order, each class's
// rows written from the class's offset (the scan's pair for this block).
// A block holds at most 256 live candidates, so each warp gathers at most
// one 32-record chunk: the live candidates cluster (a visible patch's
// triangles are contiguous), and larger blocks left a few of them several
// chunks to run in a row.
__global__ void __launch_bounds__(kRouteThreads)
route_scatter_kernel(const float* __restrict__ tm, int n,
                     const unsigned* __restrict__ masks,
                     const int* __restrict__ offsets,
                     const int* __restrict__ totals,
                     float* __restrict__ span_out,
                     float* __restrict__ huge_out) {
  __shared__ float s_tile[kRouteWarps][32][33];
  __shared__ int s_src[kRouteTile];      // candidate of each listed record
  __shared__ int s_dst[kRouteTile];      // its row in its class's buffer
  __shared__ int s_base[2][kRouteWords]; // class rank of each word's first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  // launched as the scan's programmatic dependent: wait for its offsets
  // (it waited for C1, so C1's masks and records are written too)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // the block's class offsets and the next block's (after the last, the
  // totals): their differences are its counts, and a block with none
  // leaves before it reads a mask word
  const int2 first = reinterpret_cast<const int2*>(offsets)[b];
  const int2 next = b + 1 < (int)gridDim.x
                        ? reinterpret_cast<const int2*>(offsets)[b + 1]
                        : make_int2(totals[0], totals[1]);
  const int ns = next.x - first.x, nh = next.y - first.y;
  if (ns + nh == 0) return;
  // this thread's candidate's word (one a warp) and its rank in the block
  const size_t w = (size_t)b * kRouteWords + warp;
  const unsigned ms = masks[2 * w], mh = masks[2 * w + 1];
  if (warp == 0) {                       // the words' ranks in the block
    const int cs = lane < kRouteWords ? __popc(masks[2 * (w + lane)]) : 0;
    const int ch = lane < kRouteWords ? __popc(masks[2 * (w + lane) + 1])
                                      : 0;
    int is = cs, ih = ch;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int vs = __shfl_up_sync(kFull, is, d);
      const int vh = __shfl_up_sync(kFull, ih, d);
      if (lane >= d) is += vs, ih += vh;
    }
    if (lane < kRouteWords)
      s_base[0][lane] = is - cs, s_base[1][lane] = ih - ch;
  }
  __syncthreads();
  const int base_s = first.x, base_h = first.y;
  const unsigned one = 1u << lane, below = one - 1u;
  if (ms & one) {
    const int e = s_base[0][warp] + __popc(ms & below);
    s_src[e] = b * kRouteTile + tid, s_dst[e] = base_s + e;
  } else if (mh & one) {
    const int e = s_base[1][warp] + __popc(mh & below);
    s_src[ns + e] = b * kRouteTile + tid, s_dst[ns + e] = base_h + e;
  }
  __syncthreads();
  // warp w gathers listed records 32w .. 32w + 31: a lane a record reads
  // its 32 words, then the warp writes each record as one 128-byte row
  const int c0 = warp * 32, cnt = min(32, ns + nh - c0);
  if (cnt <= 0) return;
  float (*tile)[33] = s_tile[warp];
  if (lane < cnt) {
    const size_t src = (size_t)s_src[c0 + lane];
#pragma unroll
    for (int k = 0; k < 32; ++k) tile[k][lane] = tm[(size_t)k * n + src];
  }
  __syncwarp();
  for (int j = 0; j < cnt; ++j) {
    float* out = c0 + j < ns ? span_out : huge_out;
    out[(size_t)s_dst[c0 + j] * 32 + lane] = tile[lane][j];
  }
}

// A launch of kernel on stream s as its predecessor's programmatic
// dependent (Hopper's griddepcontrol): it may start during the
// predecessor's tail and waits for its results in griddepcontrol.wait.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned blocks,
                             int threads, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

}  // namespace

// K6: tm (32, n) f32 and the route C1 wrote into scratch (at least
// scratch_ints int32 of the wrapper's, coverage_cuda.route_scratch_ints:
// the mask words, then the block counts, which the scan overwrites with
// the blocks' offsets) -> the span-class and huge-class records as (n, 32)
// rows, the first counts[0] and counts[1] of each written, in candidate
// order.
extern "C" int planet_route_records(const void* tm, int n, void* scratch,
                                    int scratch_ints, void* span_out,
                                    void* huge_out, void* counts,
                                    void* stream) {
  const long long blocks = ((long long)n + kRouteTile - 1) / kRouteTile;
  if (n <= 0 || scratch_ints < blocks * (2 * kRouteWords + 2) ||
      ((size_t)scratch & 15) != 0)
    return (int)cudaErrorInvalidValue;
  unsigned* masks = (unsigned*)scratch;
  int* block_counts = (int*)scratch + blocks * 2 * kRouteWords;
  const cudaStream_t s = (cudaStream_t)stream;
  // the scan and the scatter as programmatic dependents: each launch
  // overlaps the tail of the kernel before it (C1, then the scan) instead
  // of following its end
  cudaError_t err = launch_dependent(route_offsets_kernel, 1, kScanThreads,
                                     s, blocks, block_counts, (int*)counts);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dependent(route_scatter_kernel, (unsigned)blocks,
                               kRouteThreads, s, (const float*)tm, n,
                               (const unsigned*)masks,
                               (const int*)block_counts,
                               (const int*)counts, (float*)span_out,
                               (float*)huge_out);
}

// recs must be 16-byte aligned (the wrapper checks). count: a device int
// (the records drawn, at most m) or null (all m). The grid: one warp a
// record of the capacity m up to blocks_per_sm blocks an SM, from the
// card's SM count (metadata, so the launch could be captured); beyond that
// each warp strides over several records. blocks_per_sm 0: one warp a
// record, however many.
extern "C" int planet_raster_span(const void* recs, const void* count, int m,
                                  void* fb, int width, int height,
                                  int wireframe, int blocks_per_sm,
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
      (const float*)recs, (const int*)count, m, (int*)fb, width, wireframe);
  return (int)cudaGetLastError();
}

// recs 16-byte aligned and count as planet_raster_span's. The grid: a
// block a framebuffer row, whatever the records.
extern "C" int planet_raster_huge(const void* recs, const void* count, int m,
                                  void* fb, int width, int height,
                                  int wireframe, void* stream) {
  if (m <= 0 || width <= 0 || height <= 0 || ((size_t)recs & 15) != 0)
    return (int)cudaErrorInvalidValue;
  huge_kernel<<<height, kHugeThreads, 0, (cudaStream_t)stream>>>(
      (const float*)recs, (const int*)count, m, (int*)fb, width, wireframe);
  return (int)cudaGetLastError();
}
