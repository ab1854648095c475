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
// whole chunk on its matrix unit, masking the lanes of other blocks; here
// one thread takes one pair and reads its own block, which is the same
// function. Pairs are sorted by block, so the threads of a warp mostly
// read the same 10 KB block (one broadcast load each) and a block is
// fetched from L2 once per run of its pairs.
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
// cores against 8 B of pair ids, a 32 B ray gather and 16 B of results;
// staging each block in shared memory for the 128 pairs that share it and
// forming the products on the tensor cores is later work, for which the
// sorted (ray, block) layout is the starting point.

#include "mt_block.cuh"

namespace {

using namespace mt_block;

constexpr int kThreads = 128;

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
  if (i >= n_pairs) return;
  const float inf = __int_as_float(0x7f800000);
  const int b = __ldg(pair_block + i);
  const int ray = __ldg(pair_ray + i);
  float t = inf, u = 0.f, v = 0.f;
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

struct Launch {
  dim3 grid;
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
void launch(const Launch& l) {
  stream_mt_kernel<kAnyHit, kPrec>
      <<<l.grid, kThreads, 0, l.stream>>>(
          l.rays, l.n_rays, l.limit, l.pair_ray, l.pair_block, l.n_pairs,
          l.blocks, l.n_blocks, l.t_out, l.slot_out, l.u_out, l.v_out);
}

template <bool kAnyHit>
int by_precision(int prec, const Launch& l) {
  switch (prec) {
    case kHighest: launch<kAnyHit, kHighest>(l); return 0;
    case kHigh: launch<kAnyHit, kHigh>(l); return 0;
    case kDefault: launch<kAnyHit, kDefault>(l); return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Tests n_pairs (ray, block) pairs on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for an unknown
// tier). rays: (8, n_rays) f32 rows [ox, oy, oz, dx, dy, dz, tmin, tmax]
// (tmax is not read); limit: (n_rays,) f32, the t below which a hit
// counts (the ray's best so far; tmax for any hit); pair_ray, pair_block:
// (n_pairs,) i32, block -1 = padding; blocks: (n_blocks, 10, 256) f32.
// Outputs (n_pairs,) each: t, slot (closest: block*64 + slot or -1; any
// hit: 1 or -1), u, v. mt_prec: 0 highest, 1 high, 2 default. Allocates
// nothing and does not synchronise.
int stream_mt_launch(const float* rays, int n_rays, const float* limit,
                     const int* pair_ray, const int* pair_block, int n_pairs,
                     const float* blocks, int n_blocks, int any_hit,
                     int mt_prec, float* t_out, int* slot_out, float* u_out,
                     float* v_out, void* cuda_stream) {
  const Launch l{dim3((n_pairs + kThreads - 1) / kThreads),
                 static_cast<cudaStream_t>(cuda_stream), rays, n_rays, limit,
                 pair_ray, pair_block, n_pairs, blocks, n_blocks, t_out,
                 slot_out, u_out, v_out};
  const int rc = any_hit ? by_precision<true>(mt_prec, l)
                         : by_precision<false>(mt_prec, l);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* stream_mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
