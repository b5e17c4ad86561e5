// A1, the fused frame's cache stage and generate's prologue as one kernel
// (cache_kernel). planet_tpu runs them as XLA fusions of its one geometry
// jit (engine/device_step.py:164-198 and 200-237 over
// cache/device_pool.py:52-148), not in Pallas, so this kernel replaces no
// TPU kernel: on the card the composed torch ops were some 170 launches a
// frame (PERF.md). Plain PyTorch version:
// planet_tpu_torch/cache/device_pool_cuda.py: cache_stage_plain
// (device_pool.probe, plan, allocate and touch, unchanged), which it
// equals bit for bit in every output and in the pool's keys and ticks over
// [0, capacity); the wrapper is device_pool_cuda.cache_stage.
//
// In planet_tpu's order, for the R rows of one frame (DFS order, the
// first n live):
//   1. probe, twice: each row's id and its parent's (0 at depth 0) against
//      the pool's keys; the slot is the first match (0 for none), found
//      needs the valid bit (hi < 0);
//   2. plan: the exclusive count of live misses in row order against the
//      generation budget;
//   3. protect: hits, crop parents and the parents of planned generations;
//   4. allocate: the stable ascending order of the slots by their
//      eviction key (free -2^31, protected 2^31 - 1, else the tick; ties
//      by slot), the generations' ranks, min(gen_cap, capacity -
//      protected) of them given a slot, whose keys and tick are written;
//   5. the spill to the parent crop, the slot each row samples, the flag
//      of a spill with no cached parent;
//   6. touch (optional: the "cache" rung stops before it, as planet_tpu's
//      does);
//   7. generate's prologue: the k-th generation's DF corners times the DF
//      coord_scale (nums/df.mul's op order), its octaves
//      6 + 12 depth / max_lod and its slot at row k of the gen_cap
//      buffers; zeros, 0 octaves and slot `capacity` past their count.
//
// What bounds it: nothing of size. It reads the pool's keys and ticks
// (12 bytes a slot) and the rows (60 bytes each) once and writes a few
// hundred bytes; its time is its chain of block-wide steps. So it is one
// block of 1024 threads with the keys, ticks and row state in shared
// memory and registers, and no grid-wide step. The probes go through a
// hash table of the pool's keys built in shared memory (open addressing,
// twice the capacity's power of two in entries, so at most half full;
// atomicCAS claims an entry, atomicMin keeps the first slot of a key
// that several slots hold, as the empty key (0, 0) does; the all-ones
// key, the table's empty mark, is tracked apart): a thread a run of
// consecutive rows looks each row and its parent up in a probe or two.
// A warp inserts each key once (__match_any_sync), so the many slots of
// the empty key cost one atomic a warp. The first design, a warp a row
// comparing 128 keys a ballot step, was bound by its instructions on the
// one SM (0.050-0.069 ms queued, PERF.md §6). The scans are a warp scan
// and a scan of the 32 warp sums; the eviction order is a bitonic sort of
// (key, slot) pairs in the table's memory, stable because the slot breaks
// ties, its strides below 32 done by warp shuffles, run only when a
// generation is due (a converged frame has none). Capacity and rows are runtime
// sizes up to 4096 each, in dynamic shared memory above 48 KB. Built with
// -fmad=false, so the DF product rounds as torch's ops do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSize = 4096;            // capacity and rows
constexpr int kRowsPerThread = kMaxSize / kThreads;
constexpr unsigned kHiDepthUnit = 1u << 23;
constexpr unsigned char kFound = 1, kParent = 2, kGen = 4, kCrop = 8;

__device__ __forceinline__ unsigned long long pack(int lo, int hi) {
  return ((unsigned long long)(unsigned)hi << 32) | (unsigned)lo;
}

// geom/quadid.words_parent for depth >= 1 (pos in [0, 60])
__device__ __forceinline__ void words_parent(int lo, int hi, int* plo,
                                             int* phi) {
  const int pos = 2 * (((hi >> 23) & 31) - 1);
  const unsigned lo_mask = (pos >= 0 && pos < 32) ? 3u << pos : 0u;
  const unsigned hi_mask = pos >= 32 ? 3u << (pos - 32) : 0u;
  *plo = (int)((unsigned)lo & ~lo_mask);
  *phi = (int)(((unsigned)hi - kHiDepthUnit) & ~hi_mask);
}

// the hash table's empty mark, and an entry's home for a key
constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ unsigned hash_of(unsigned long long k,
                                            int bits) {
  return (unsigned)((k * 0x9E3779B97F4A7C15ull) >> (64 - bits));
}

// the first slot holding q, -1 for none: the table's entry for q, or for
// the empty mark itself the first slot holding it (`ones`)
__device__ __forceinline__ int lookup(const unsigned long long* tkey,
                                      const int* tslot, int bits, int ones,
                                      unsigned long long q) {
  if (q == kEmpty) return ones == 0x7fffffff ? -1 : ones;
  const unsigned mask = (1u << bits) - 1;
  for (unsigned h = hash_of(q, bits);; h = (h + 1) & mask) {
    const unsigned long long k = tkey[h];
    if (k == q) return tslot[h];
    if (k == kEmpty) return -1;
  }
}

// the block's exclusive prefix sum of v in thread order, and its total;
// every thread calls it (sums: 32 ints of shared memory)
__device__ int block_scan(int v, int* sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  const int before = (warp ? sums[warp - 1] : 0) + x - v;
  *total = sums[kWarps - 1];
  __syncthreads();
  return before;
}

// nums/df.two_prod
__device__ __forceinline__ void two_prod(float a, float b, float* p,
                                         float* err) {
  *p = a * b;
  const float ca = 4097.0f * a, cb = 4097.0f * b;
  const float ahi = ca - (ca - a), bhi = cb - (cb - b);
  const float alo = a - ahi, blo = b - bhi;
  *err = (((ahi * bhi - *p) + ahi * blo) + alo * bhi) + alo * blo;
}

__global__ void __launch_bounds__(kThreads, 1) cache_kernel(
    int* __restrict__ keys_lo, int* __restrict__ keys_hi,
    int* __restrict__ tick, const int* __restrict__ now_p,
    const int* __restrict__ q_lo, const int* __restrict__ q_hi,
    const int* __restrict__ depth, const float* __restrict__ c_hi,
    const float* __restrict__ c_lo, const int* __restrict__ n_p, int rows,
    int cap, int pow2, int bits, int budget, int gen_cap, int max_lod,
    float sh, float sl, int do_touch, int* __restrict__ slot_out,
    int* __restrict__ target_out, unsigned char* __restrict__ generate_out,
    unsigned char* __restrict__ crop_out,
    unsigned char* __restrict__ failed_out, float* __restrict__ gen_hi,
    float* __restrict__ gen_lo, int* __restrict__ gen_oct,
    int* __restrict__ gen_slot, int* __restrict__ n_generated) {
  extern __shared__ unsigned long long smem[];
  const int entries = 1 << bits;
  unsigned long long* key = smem;                 // cap
  unsigned long long* tkey = key + cap;           // entries, then the
  unsigned long long* order = tkey;               // sort's pow2 pairs
  int* tslot = (int*)(tkey + entries);            // entries
  int* tick0 = tslot + entries;                   // cap
  int* sums = tick0 + cap;                        // 32
  int* ones = sums + kWarps;                      // 1
  unsigned char* prot = (unsigned char*)(ones + 1);   // cap

  const int tid = threadIdx.x;
  const int n = *n_p, now = *now_p;
  for (int h = tid; h < entries; h += kThreads) {
    tkey[h] = kEmpty;
    tslot[h] = 0x7fffffff;
  }
  if (tid == 0) *ones = 0x7fffffff;
  for (int s = tid; s < cap; s += kThreads) {
    key[s] = pack(keys_lo[s], keys_hi[s]);
    tick0[s] = tick[s];
    prot[s] = 0;
  }
  __syncthreads();
  // the table: each key's entry keeps the first slot that holds it. A
  // warp inserts a key once, from the lane of its smallest slot: the
  // empty key (0, 0) fills most of a young pool, and hundreds of atomics
  // on its one entry would run one after another
  const unsigned mask = (unsigned)entries - 1;
  for (int base = 0; base < cap; base += kThreads) {
    const int s = base + tid;
    const unsigned act = __ballot_sync(0xffffffffu, s < cap);
    if (s >= cap) continue;
    const unsigned long long k = key[s];
    if ((tid & 31) != __ffs(__match_any_sync(act, k)) - 1) continue;
    if (k == kEmpty) {
      atomicMin(ones, s);
      continue;
    }
    for (unsigned h = hash_of(k, bits);; h = (h + 1) & mask) {
      const unsigned long long prev = atomicCAS(&tkey[h], kEmpty, k);
      if (prev == kEmpty || prev == k) {
        atomicMin(&tslot[h], s);
        break;
      }
    }
  }
  __syncthreads();

  // 1. the probes: thread t owns rows [t k, t k + k)
  const int k = (rows + kThreads - 1) / kThreads;
  const int r0 = tid * k;
  int rs[kRowsPerThread], rps[kRowsPerThread];
  unsigned char f[kRowsPerThread];
  int misses = 0;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = r0 + j;
    rs[j] = rps[j] = 0;
    f[j] = 0;
    if (j >= k || r >= rows) continue;
    const int lo = q_lo[r], hi = q_hi[r], d = depth[r];
    const int m = lookup(tkey, tslot, bits, *ones, pack(lo, hi));
    int plo = 0, phi = 0;
    if (d > 0) words_parent(lo, hi, &plo, &phi);
    const int pm = lookup(tkey, tslot, bits, *ones, pack(plo, phi));
    rs[j] = m < 0 ? 0 : m;
    rps[j] = pm < 0 ? 0 : pm;
    f[j] = (m >= 0 && hi < 0 && r < n ? kFound : 0)
           | (pm >= 0 && phi < 0 && d > 0 ? kParent : 0);
    misses += r < n && !(f[j] & kFound);
  }

  // 2. plan
  int total;
  int before = block_scan(misses, sums, &total);
  int gens = 0;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = r0 + j;
    if (j >= k || r >= rows || r >= n || (f[j] & kFound)) continue;
    const bool gen = !(f[j] & kParent) || before < budget;
    f[j] |= gen ? kGen : kCrop;
    gens += gen;
    ++before;
  }
  int total_gen;
  int rank = block_scan(gens, sums, &total_gen);

  // 3. protect
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (f[j] & kFound) prot[rs[j]] = 1;
    if ((f[j] & (kGen | kCrop)) && (f[j] & kParent)) prot[rps[j]] = 1;
  }
  __syncthreads();
  int mine = 0;
  for (int s = tid; s < cap; s += kThreads) mine += prot[s];
  int n_prot;
  block_scan(mine, sums, &n_prot);
  const int limit = min(gen_cap, cap - n_prot);
  const int n_ok = max(0, min(total_gen, limit));

  // 4. the eviction order, when a generation is due (the table is done
  // with: every lookup ended before the scans' barriers)
  if (n_ok > 0) {
    for (int s = tid; s < pow2; s += kThreads) {
      unsigned long long v = ~0ull;
      if (s < cap) {
        const int ek = prot[s] ? 0x7fffffff
                       : ((long long)key[s] < 0 ? tick0[s]
                                                : (int)0x80000000);
        v = ((unsigned long long)((unsigned)ek ^ 0x80000000u) << 32)
            | (unsigned)s;
      }
      order[s] = v;
    }
    __syncthreads();
    const int rounds = (pow2 + kThreads - 1) / kThreads;
    for (int size = 2; size <= pow2; size <<= 1) {
      int stride = size >> 1;
      for (; stride >= 32; stride >>= 1) {
        for (int i = tid; i < pow2; i += kThreads) {
          const int p = i ^ stride;
          if (p > i) {
            const unsigned long long a = order[i], b = order[p];
            if ((a > b) == ((i & size) == 0)) {
              order[i] = b;
              order[p] = a;
            }
          }
        }
        __syncthreads();
      }
      // the strides below 32 pair the lanes of one warp: shuffles, and no
      // barrier between them (lanes past pow2 carry the largest pair,
      // and their partners lie past pow2 too)
      for (int m = 0; m < rounds; ++m) {
        const int i = tid + m * kThreads;
        unsigned long long v = i < pow2 ? order[i] : ~0ull;
        const bool up = (i & size) == 0;
        for (int st = stride; st > 0; st >>= 1) {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, st);
          v = (((i & st) == 0) == up) ? (v < o ? v : o) : (v < o ? o : v);
        }
        if (i < pow2) order[i] = v;
      }
      __syncthreads();
    }
  }

  // 5-7. allocate, spill, touch and generate's prologue, row by row
  bool failed = false;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = r0 + j;
    if (j >= k || r >= rows) continue;
    const bool gen = f[j] & kGen, parent = f[j] & kParent;
    bool crop = f[j] & kCrop;
    const bool ok = gen && rank < limit;
    const int tgt = ok ? (int)(unsigned)order[rank] : -1;
    crop = crop || (gen && !ok && parent);
    failed = failed || (gen && !ok && !parent);
    const int slot = ok ? tgt : crop ? rps[j] : rs[j];
    slot_out[r] = slot;
    target_out[r] = tgt;
    generate_out[r] = ok;
    crop_out[r] = crop;
    if (ok) {
      keys_lo[tgt] = q_lo[r];
      keys_hi[tgt] = q_hi[r];
      tick[tgt] = now;
      for (int c = 0; c < 12; ++c) {
        const float a0 = c_hi[c * rows + r], a1 = c_lo[c * rows + r];
        float p, e;
        two_prod(a0, sh, &p, &e);
        e = e + (a0 * sl + a1 * sh);
        const float s = p + e;
        gen_hi[rank * 12 + c] = s;
        gen_lo[rank * 12 + c] = e - (s - p);
      }
      gen_oct[rank] = 6 + (12 * depth[r]) / max_lod;
      gen_slot[rank] = tgt;
    }
    if (do_touch && r < n) tick[slot] = now;
    rank += gen;
  }
  failed = __syncthreads_or(failed);
  if (tid == 0) {
    *failed_out = failed;
    *n_generated = n_ok;
  }
  for (int g = n_ok + tid; g < gen_cap; g += kThreads) {
    for (int c = 0; c < 12; ++c) {
      gen_hi[g * 12 + c] = 0.0f;
      gen_lo[g * 12 + c] = 0.0f;
    }
    gen_oct[g] = 0;
    gen_slot[g] = cap;
  }
}

}  // namespace

// The pool (keys_lo, keys_hi, tick (>= cap,) int32, updated in place; now
// () int32), the frame's rows (q_lo, q_hi, depth (rows,) int32, c_hi, c_lo
// (12, rows) f32: corner-major DF corners, row 3 c + a the corner c's
// axis a; n () int32 live rows) -> slot, target (rows,) int32, generate,
// crop (rows,) bool, failed () bool, gen_hi, gen_lo (gen_cap, 12) f32,
// gen_oct, gen_slot (gen_cap,) int32, n_generated () int32.
extern "C" int planet_cache(void* keys_lo, void* keys_hi, void* tick,
                            const void* now, const void* q_lo,
                            const void* q_hi, const void* depth,
                            const void* c_hi, const void* c_lo,
                            const void* n, int rows, int cap, int budget,
                            int gen_cap, int max_lod, float sh, float sl,
                            int do_touch, void* slot, void* target,
                            void* generate, void* crop, void* failed,
                            void* gen_hi, void* gen_lo, void* gen_oct,
                            void* gen_slot, void* n_generated, void* stream) {
  if (rows < 0 || rows > kMaxSize || cap <= 0 || cap > kMaxSize
      || gen_cap < 0 || max_lod <= 0)
    return (int)cudaErrorInvalidValue;
  int pow2 = 1, bits = 1;
  while (pow2 < cap) pow2 <<= 1;
  while ((1 << bits) < 2 * pow2) ++bits;
  // the keys, the table (whose memory the sort's pairs reuse), the ticks,
  // the scan's sums, the empty mark's slot and the protect flags
  const size_t entries = (size_t)1 << bits;
  const size_t smem = 8 * (size_t)cap + 12 * entries + 4 * (size_t)cap
                      + 4 * (kWarps + 1) + (size_t)cap;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        cache_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  cache_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (int*)keys_lo, (int*)keys_hi, (int*)tick, (const int*)now,
      (const int*)q_lo, (const int*)q_hi, (const int*)depth,
      (const float*)c_hi, (const float*)c_lo, (const int*)n, rows, cap, pow2,
      bits, budget, gen_cap, max_lod, sh, sl, do_touch, (int*)slot, (int*)target,
      (unsigned char*)generate, (unsigned char*)crop,
      (unsigned char*)failed, (float*)gen_hi, (float*)gen_lo,
      (int*)gen_oct, (int*)gen_slot, (int*)n_generated);
  return (int)cudaGetLastError();
}
