// Leaf-pair Moller-Trumbore kernel of the breadth-first ray-stream tracer
// on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_make_mt_kernel` of
// platinum_tpu/ops/raystream.py (built by `_build_mt_call`), K15. The
// ray-stream tracer (ops/raystream.py of this package) advances a whole
// wave one level of the 16-wide BVH at a time; at each level it hands this
// kernel the (ray, leaf block) pairs that survived the slab tests, sorted
// by block id. Per pair the kernel tests the ray against the block's 64
// triangles with the accept tests of raystream.py:161-177 (|det| > 1e-12,
// u, v >= 0, u + v <= |det|, t |det| strictly inside (tmin, limit)) and
// returns, in closest mode, the least t with its global slot
// block*64 + slot (ties inside the block to the smallest slot), u and v,
// or t = +inf, slot -1 on a miss; in any-hit mode slot = 1 when some
// triangle is accepted (no division), else -1. A pair with block id -1 is
// padding and misses.
//
// What is computed is the TPU kernel's per-pair function, not its
// schedule. The TPU kernel walks the distinct blocks of a 128-pair chunk
// and multiplies each (10, 256) block with the (10, 128) features of the
// whole chunk on its matrix unit, masking the lanes of other blocks. Here
// (`stream_mt_chunk_kernel`) a 128-thread CTA takes a chunk of 512
// consecutive pairs of the block-sorted list (256 or 128 where a level's
// chunks would not fill the card) and finds its runs (the pairs that
// share a block) by neighbour compares and a block scan. Each
// run's block is staged once in shared memory, in a ring of kSlots slots,
// by cp.async one round ahead of its use, and the run's pairs are cut into
// tasks of R consecutive pairs (2; 4 at "default"), one thread a task, so
// that every coefficient a thread reads from shared memory feeds R rays'
// products (mt_block.cuh `rays_dots`, each ray's sequence of operations
// that of `block_dots` / `block_dots_split`). Tasks go to the threads in
// rounds of up to 128 over at most kSlots - 1 runs; a round of fewer
// tasks splits each task's 64 triangles over g = 2-16 threads (aligned
// lanes of one warp, each every g-th group of four), whose partial
// results are combined by shuffles, the lower slot winning ties, so the
// choice is `block_closest`'s (least t, ties to the smallest slot);
// mt_chunk.cuh holds the task test, the combine and the cp.async helpers,
// which K13 shares. A chunk whose runs average fewer
// than kMinRun pairs (thin waves deep in a render) stages nothing: each
// thread tests its pairs one at a time through the read-only cache, the
// per-pair code. The one-thread-per-pair kernel
// (`stream_mt_kernel`) stays as the reference, behind its own entry
// (`stream_mt_per_pair_launch`).
//
// The pair names its ray by index and the kernel gathers the ray (origin,
// direction, tmin) and its limit, then forms the ten features itself with
// mt_block.cuh's `ray_features`, the packet kernel's own code: the TPU
// kernel is handed the features, formed by XLA on the host side of the
// call, but features formed by separate multiplies and subtractions round
// differently from the packet kernel's FMAs, and then a (ray, triangle)
// pair's t would not be the packet kernel's to the bit. The block test is
// mt_block.cuh's at every tier ("highest" fp32 FMAs, "high" bf16x3,
// "default" one bf16 product); unlike the packet kernel's, the any-hit
// mode runs at the tier too, as raystream.py:156 does.
//
// What bounds it on the card: at "highest" 5,120 FLOP per pair on the CUDA
// cores against 8 B of pair ids, a 32 B ray gather, 16 B of results and
// 10 KB per distinct block: the operations. The one-thread-per-pair kernel
// read its block through the read-only cache, one 16-byte load per four
// FMAs; staging the block once per CTA and blocking R rays per thread cuts
// the loads per FMA R-fold and takes them from shared memory. What is
// left is the accept test, ~16 instructions per (ray, triangle) beside its
// 40 FMAs, and each round's barriers.

#include "mt_chunk.cuh"

namespace {

using namespace mt_block;

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// The chunked kernel: pairs per CTA, pairs each thread scans for run
// boundaries, the ring of staged blocks (40 KB of shared memory with the
// padding that puts two slots' equal offsets in different banks).
constexpr int kChunk = 512;
constexpr int kPerThread = kChunk / kThreads;
constexpr int kSlots = 4;
constexpr int kSlotFloats = kBlockFloats + 4;
constexpr int kMinRun = 32;        // pairs a run on average to stage blocks
constexpr int kResident = 4 * 132;  // CTAs an H100 holds at once (4 an SM)

// Pairs a CTA takes: kChunk, halved (down to kThreads) while the level's
// chunks would not fill the card, so that a small level still spreads
// over every SM.
__host__ __device__ __forceinline__ int chunk_pairs(int n_pairs) {
  int chunk = kChunk;
  while (chunk > kThreads && n_pairs < chunk * kResident) chunk /= 2;
  return chunk;
}
constexpr int kQuads = kBlockFloats / 4;   // float4 loads a block

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// One pair, one thread: the ray against its block through the read-only
// cache, block_any / block_closest's tests; the results are written.
template <bool kAnyHit, int kPrec>
__device__ __forceinline__ void test_pair(
    int i, const float* __restrict__ rays, int n_rays,
    const float* __restrict__ limit, const int* __restrict__ pair_ray,
    const int* __restrict__ pair_block, const float* __restrict__ blocks,
    int n_blocks, float* __restrict__ t_out, int* __restrict__ slot_out,
    float* __restrict__ u_out, float* __restrict__ v_out) {
  const int b = __ldg(pair_block + i);
  const int ray = __ldg(pair_ray + i);
  float t = inf_f(), u = 0.f, v = 0.f;
  int slot = -1;
  if (b >= 0 && b < n_blocks && ray >= 0 && ray < n_rays) {
    float f[10], fh[10], fl[10];
    ray_features(__ldg(rays + ray), __ldg(rays + n_rays + ray),
                 __ldg(rays + 2 * n_rays + ray),
                 __ldg(rays + 3 * n_rays + ray),
                 __ldg(rays + 4 * n_rays + ray),
                 __ldg(rays + 5 * n_rays + ray), f);
    if (kPrec != kHighest) split_features(f, fh, fl);
    const float tmin = __ldg(rays + 6 * n_rays + ray);
    const float lim = __ldg(limit + ray);
    const float* blk = blocks + (size_t)b * kBlockFloats;
    if (kAnyHit) {
      if (block_any<kPrec>(blk, f, fh, fl, tmin, lim)) {
        slot = 1;
        t = 0.f;
      }
    } else {
      float best = lim;
      if (block_closest<kPrec>(blk, b, f, fh, fl, tmin, best, slot, u, v))
        t = best;
    }
  }
  t_out[i] = t;
  slot_out[i] = slot;
  u_out[i] = u;
  v_out[i] = v;
}

// The one-thread-per-pair kernel: the reference of the chunked kernel.
template <bool kAnyHit, int kPrec>
__global__ void __launch_bounds__(kThreads)
stream_mt_kernel(const float* __restrict__ rays, int n_rays,
                 const float* __restrict__ limit,
                 const int* __restrict__ pair_ray,
                 const int* __restrict__ pair_block, int n_pairs,
                 const float* __restrict__ blocks, int n_blocks,
                 float* __restrict__ t_out, int* __restrict__ slot_out,
                 float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_pairs)
    test_pair<kAnyHit, kPrec>(i, rays, n_rays, limit, pair_ray, pair_block,
                              blocks, n_blocks, t_out, slot_out, u_out,
                              v_out);
}

// Exclusive prefix sum of v over the CTA's threads in thread order; *total
// gets the sum. Every thread calls it.
__device__ int cta_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int s = scratch[w];
    before += w < warp ? s : 0;
    sum += s;
  }
  *total = sum;
  __syncthreads();   // scratch is reused by the next scan
  return before + x - v;
}

__device__ __forceinline__ bool valid_block(int b, int n_blocks) {
  return b >= 0 && b < n_blocks;
}

// Issue the copies of runs [r0, r1)'s blocks (those in range) into their
// slots, r % kSlots, 16 bytes a thread at a time; the caller commits them.
__device__ __forceinline__ void stage_runs(float (*slot_blk)[kSlotFloats],
                                           const int* run_block, int r0,
                                           int r1, const float* blocks,
                                           int n_blocks) {
  for (int q = threadIdx.x; q < (r1 - r0) * kQuads; q += kThreads) {
    const int rr = r0 + q / kQuads, e = q - (q / kQuads) * kQuads;
    const int b = run_block[rr];
    if (valid_block(b, n_blocks))
      copy16_async(slot_blk[rr % kSlots] + 4 * e,
                   blocks + (size_t)b * kBlockFloats + 4 * e);
  }
}

template <bool kAnyHit, int kPrec>
__global__ void __launch_bounds__(kThreads)
stream_mt_chunk_kernel(const float* __restrict__ rays, int n_rays,
                       const float* __restrict__ limit,
                       const int* __restrict__ pair_ray,
                       const int* __restrict__ pair_block, int n_pairs,
                       const float* __restrict__ blocks, int n_blocks,
                       float* __restrict__ t_out, int* __restrict__ slot_out,
                       float* __restrict__ u_out, float* __restrict__ v_out) {
  constexpr int R = task_rays<kPrec>();   // pairs a task
  __shared__ __align__(16) float slot_blk[kSlots][kSlotFloats];
  __shared__ int run_start[kChunk + 1];
  __shared__ int run_block[kChunk];
  __shared__ int task_off[kChunk + 1];
  __shared__ int scratch[kThreads / 32];
  const int tid = threadIdx.x;
  const int chunk = chunk_pairs(n_pairs);
  const int c0 = blockIdx.x * chunk;
  const int len = min(chunk, n_pairs - c0);
  const float inf = inf_f();

  // 1. the chunk's runs: pair i starts one where its block differs from
  // pair i - 1's (or i = 0); pairs of a block out of range miss here
  int bid[kPerThread];
  int starts = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = tid * kPerThread + j;
    bid[j] = i < len ? __ldg(pair_block + c0 + i) : -1;
    const int prev = j ? bid[j - 1]
                       : (i > 0 && i <= len ? __ldg(pair_block + c0 + i - 1)
                                            : 0);
    starts += i < len && (i == 0 || bid[j] != prev);
    if (i < len && !valid_block(bid[j], n_blocks)) {
      t_out[c0 + i] = inf;
      slot_out[c0 + i] = -1;
      u_out[c0 + i] = 0.f;
      v_out[c0 + i] = 0.f;
    }
  }
  int n_runs;
  int k = cta_exclusive_scan(starts, scratch, &n_runs);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = tid * kPerThread + j;
    const int prev = j ? bid[j - 1]
                       : (i > 0 && i <= len ? __ldg(pair_block + c0 + i - 1)
                                            : 0);
    if (i < len && (i == 0 || bid[j] != prev)) {
      run_start[k] = i;
      run_block[k] = bid[j];
      ++k;
    }
  }
  if (tid == 0) run_start[n_runs] = len;
  __syncthreads();
  if (n_runs * kMinRun > len) {
    // runs shorter than kMinRun pairs on average: staging a block would
    // serve too few pairs, and rounds of at most kSlots - 1 runs too few
    // tasks; each thread tests its pairs one at a time through the
    // read-only cache, neighbours mostly reading one block
    for (int i = tid; i < len; i += kThreads)
      test_pair<kAnyHit, kPrec>(c0 + i, rays, n_rays, limit, pair_ray,
                                pair_block, blocks, n_blocks, t_out,
                                slot_out, u_out, v_out);
    return;
  }

  // 2. tasks: ceil(run length / R) a run whose block is in range
  int tasks = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int r = tid * kPerThread + j;
    if (r < n_runs && valid_block(run_block[r], n_blocks))
      tasks += (run_start[r + 1] - run_start[r] + R - 1) / R;
  }
  int n_tasks;
  int at = cta_exclusive_scan(tasks, scratch, &n_tasks);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int r = tid * kPerThread + j;
    if (r < n_runs) {
      task_off[r] = at;
      if (valid_block(run_block[r], n_blocks))
        at += (run_start[r + 1] - run_start[r] + R - 1) / R;
    }
  }
  if (tid == 0) task_off[n_runs] = n_tasks;
  __syncthreads();

  // 3. rounds of up to kThreads tasks over the chunk's task list. A round
  // spans at most kSlots - 1 runs; run r's block sits in slot r % kSlots.
  // Each round first issues the copies (cp.async) of the blocks it needs
  // that are not staged yet, then those of the runs after it while their
  // slots are free (their run kSlots before is done), so that the next
  // round's blocks arrive while this one tests
  int ra = 0;        // the run of the round's first task
  int staged = 0;    // runs [0, staged) are staged or on their way
  for (int t0 = 0; t0 < n_tasks;) {
    while (task_off[ra + 1] <= t0) ++ra;
    const int rem = task_off[min(n_runs, ra + kSlots - 1)] - t0;
    // fewer than kThreads tasks: split each task's triangles over g threads
    const int g = split_lanes(rem, kThreads);
    const int count = min(rem, kThreads / g);
    int rb = ra;       // the run of the round's last task
    while (task_off[rb + 1] < t0 + count) ++rb;
    const int ahead = min(n_runs, ra + kSlots);
    stage_runs(slot_blk, run_block, staged, rb + 1, blocks, n_blocks);
    copy_commit();
    stage_runs(slot_blk, run_block, max(staged, rb + 1), ahead, blocks,
               n_blocks);
    copy_commit();
    staged = max(staged, ahead);
    copy_wait<1>();   // every copy but the look-ahead's
    __syncthreads();
    {
      const int part = tid & (g - 1);
      const bool has = tid / g < count;
      const int task = t0 + tid / g;
      int r = ra, first = 0, cnt = 0, b = 0;
      if (has) {
        while (task_off[r + 1] <= task) ++r;
        first = run_start[r] + (task - task_off[r]) * R;
        cnt = min(R, run_start[r + 1] - first);
        b = run_block[r];
      }
      float f[R][10], fh[R][10], fl[R][10], tmin[R], lim[R];
      int ray[R];
      Pick pick[R];
      bool hit[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ray[j] = j < cnt ? __ldg(pair_ray + c0 + first + j) : -1;
        const bool live = ray[j] >= 0 && ray[j] < n_rays;
        const int rr = live ? ray[j] : 0;
        if (live) {
          ray_features(__ldg(rays + rr), __ldg(rays + n_rays + rr),
                       __ldg(rays + 2 * n_rays + rr),
                       __ldg(rays + 3 * n_rays + rr),
                       __ldg(rays + 4 * n_rays + rr),
                       __ldg(rays + 5 * n_rays + rr), f[j]);
          tmin[j] = __ldg(rays + 6 * n_rays + rr);
          lim[j] = __ldg(limit + rr);
        } else {
#pragma unroll
          for (int q = 0; q < 10; ++q) f[j][q] = 0.f;
          tmin[j] = 0.f;
          lim[j] = -inf;
        }
        if (kPrec != kHighest) split_features(f[j], fh[j], fl[j]);
        pick[j] = Pick{inf, 0.f, 0.f, 0.f, -1};
        hit[j] = !live;    // a dead ray stops no any-hit test early
      }
      if (has) {
        test_rays<kAnyHit, kPrec, R>(slot_blk[r % kSlots], 4 * part, 4 * g,
                                     f, fh, fl, tmin, lim, pick, hit);
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool live = ray[j] >= 0 && ray[j] < n_rays;
        if (kAnyHit) hit[j] = hit[j] && live;
      }
      combine_split<kAnyHit, R>(g, pick, hit);
      if (has && part == 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (j >= cnt) break;
          const int i = c0 + first + j;
          float t = inf, u = 0.f, v = 0.f;
          int slot = -1;
          if (kAnyHit) {
            if (hit[j]) {
              t = 0.f;
              slot = 1;
            }
          } else if (pick[j].slot >= 0 && pick[j].tb < lim[j]) {
            const float iad = 1.0f / fmaxf(pick[j].ad, 1e-37f);
            t = pick[j].tb;
            slot = b * kBlockTris + pick[j].slot;
            u = pick[j].us * iad;
            v = pick[j].vs * iad;
          }
          t_out[i] = t;
          slot_out[i] = slot;
          u_out[i] = u;
          v_out[i] = v;
        }
      }
    }
    t0 += count;
    __syncthreads();   // the round's slots may be staged again
  }
  copy_wait<0>();
}

struct Launch {
  cudaStream_t stream;
  const float* rays;
  int n_rays;
  const float* limit;
  const int* pair_ray;
  const int* pair_block;
  int n_pairs;
  const float* blocks;
  int n_blocks;
  float* t_out;
  int* slot_out;
  float* u_out;
  float* v_out;
};

template <bool kAnyHit, int kPrec>
void launch(const Launch& l, bool per_pair) {
  if (per_pair)
    stream_mt_kernel<kAnyHit, kPrec>
        <<<(l.n_pairs + kThreads - 1) / kThreads, kThreads, 0, l.stream>>>(
            l.rays, l.n_rays, l.limit, l.pair_ray, l.pair_block, l.n_pairs,
            l.blocks, l.n_blocks, l.t_out, l.slot_out, l.u_out, l.v_out);
  else
    stream_mt_chunk_kernel<kAnyHit, kPrec>
        <<<(l.n_pairs + chunk_pairs(l.n_pairs) - 1) / chunk_pairs(l.n_pairs),
           kThreads, 0, l.stream>>>(
            l.rays, l.n_rays, l.limit, l.pair_ray, l.pair_block, l.n_pairs,
            l.blocks, l.n_blocks, l.t_out, l.slot_out, l.u_out, l.v_out);
}

template <bool kAnyHit>
int by_precision(int prec, const Launch& l, bool per_pair) {
  switch (prec) {
    case kHighest: launch<kAnyHit, kHighest>(l, per_pair); return 0;
    case kHigh: launch<kAnyHit, kHigh>(l, per_pair); return 0;
    case kDefault: launch<kAnyHit, kDefault>(l, per_pair); return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_mt(const float* rays, int n_rays, const float* limit,
              const int* pair_ray, const int* pair_block, int n_pairs,
              const float* blocks, int n_blocks, int any_hit, int mt_prec,
              float* t_out, int* slot_out, float* u_out, float* v_out,
              void* cuda_stream, bool per_pair) {
  const Launch l{static_cast<cudaStream_t>(cuda_stream), rays, n_rays, limit,
                 pair_ray, pair_block, n_pairs, blocks, n_blocks, t_out,
                 slot_out, u_out, v_out};
  const int rc = any_hit ? by_precision<true>(mt_prec, l, per_pair)
                         : by_precision<false>(mt_prec, l, per_pair);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tests n_pairs (ray, block) pairs on `stream` with the chunked kernel and
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for an
// unknown tier). rays: (8, n_rays) f32 rows [ox, oy, oz, dx, dy, dz,
// tmin, tmax] (tmax is not read); limit: (n_rays,) f32, the t below which
// a hit counts (the ray's best so far; tmax for any hit); pair_ray,
// pair_block: (n_pairs,) i32, sorted by block (any order gives the same
// results, more slowly), block -1 = padding; blocks: (n_blocks, 10, 256)
// f32. Outputs (n_pairs,) each: t, slot (closest: block*64 + slot or -1;
// any hit: 1 or -1), u, v. mt_prec: 0 highest, 1 high, 2 default.
// Allocates nothing and does not synchronise.
int stream_mt_launch(const float* rays, int n_rays, const float* limit,
                     const int* pair_ray, const int* pair_block, int n_pairs,
                     const float* blocks, int n_blocks, int any_hit,
                     int mt_prec, float* t_out, int* slot_out, float* u_out,
                     float* v_out, void* cuda_stream) {
  return launch_mt(rays, n_rays, limit, pair_ray, pair_block, n_pairs,
                   blocks, n_blocks, any_hit, mt_prec, t_out, slot_out,
                   u_out, v_out, cuda_stream, false);
}

// The same through the one-thread-per-pair reference kernel.
int stream_mt_per_pair_launch(const float* rays, int n_rays,
                              const float* limit, const int* pair_ray,
                              const int* pair_block, int n_pairs,
                              const float* blocks, int n_blocks, int any_hit,
                              int mt_prec, float* t_out, int* slot_out,
                              float* u_out, float* v_out, void* cuda_stream) {
  return launch_mt(rays, n_rays, limit, pair_ray, pair_block, n_pairs,
                   blocks, n_blocks, any_hit, mt_prec, t_out, slot_out,
                   u_out, v_out, cuda_stream, true);
}

const char* stream_mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
