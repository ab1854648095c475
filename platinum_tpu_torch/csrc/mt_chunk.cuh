// What the two staged leaf-pair kernels share: K15 (stream_mt.cu
// `stream_mt_chunk_kernel`, the ray-stream tracer) and K13 (bf_stream.cu
// `bf_mt_kernel`, the breadth-first pipeline). Both stage a 64-triangle
// block in shared memory with cp.async ahead of its use, cut the pairs
// that test it into tasks of R rays a thread (`rays_dots`: every
// coefficient read from shared memory feeds R rays' products), and, where
// a round holds too few tasks for the CTA, split each task's triangles
// over g = 2-16 aligned lanes of one warp, lane `part` taking the groups
// of four triangles part, part + g, ... (neighbouring lanes read
// neighbouring 16-byte words, in different banks), and combine the
// partial results by shuffles (`combine_split`), the lower slot winning
// ties. Each ray keeps block_closest's / block_any's sequence of
// operations, its accept test and its lowest-slot tie rule, so the
// outputs are the one-thread-per-pair kernels' in every bit.

#pragma once

#include "mt_block.cuh"

namespace mt_block {

constexpr int kMaxSplit = 16;   // lanes a task's triangles may span

// Rays a task: 4 at "default", where each coefficient's bf16 split serves
// four rays; 2 at "highest" and "high" (on an H100, four rays at
// "highest" took 168 registers, three CTAs an SM, and ran 15-20% slower
// than two rays at 120 registers and four CTAs)
template <int kPrec>
__host__ __device__ constexpr int task_rays() {
  return kPrec == kDefault ? 4 : 2;
}

// Lanes a task's triangles are split over: the largest power of two up to
// kMaxSplit with which `tasks` tasks still fit `threads` threads twice
// over (at most `threads` lanes busy)
__device__ __forceinline__ int split_lanes(int tasks, int threads) {
  int g = 1;
  while (g < kMaxSplit && tasks * g * 2 <= threads) g *= 2;
  return g;
}

// The closest-hit choice of one ray over some triangles of a block:
// block_closest's least t below the limit, ties to the smallest slot.
struct Pick {
  float tb, us, vs, ad;
  int slot;
};

// The groups of four triangles s_first, s_first + s_step, ... of the
// staged block `blk` against the R rays of a task: closest hit folds each
// accepted triangle into pick[r] in ascending slots (strict <), any hit
// sets hit[r] and stops once every ray has one.
template <bool kAnyHit, int kPrec, int R>
__device__ __forceinline__ void test_rays(const float* blk, int s_first,
                                          int s_step, const float (*f)[10],
                                          const float (*fh)[10],
                                          const float (*fl)[10],
                                          const float* tmin, const float* lim,
                                          Pick* pick, bool* hit) {
  for (int s0 = s_first; s0 < kBlockTris; s0 += s_step) {
    float out[R][16];
    rays_dots<kPrec, R, true>(blk, f, fh, fl, s0, out);
    bool all = true;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float det = out[r][j];
        const float s = det >= 0.f ? 1.f : -1.f;
        const float ad = det * s, us = out[r][4 + j] * s,
                    vs = out[r][8 + j] * s, ts = out[r][12 + j] * s;
        if (ad > kDetEps && us >= 0.f && vs >= 0.f && us + vs <= ad &&
            ts > tmin[r] * ad && ts < lim[r] * ad) {
          if (kAnyHit) {
            hit[r] = true;
          } else {
            const float t = ts / fmaxf(ad, 1e-37f);
            if (t < pick[r].tb) {
              pick[r].tb = t; pick[r].slot = s0 + j;
              pick[r].us = us; pick[r].vs = vs; pick[r].ad = ad;
            }
          }
        }
      }
      all = all && hit[r];
    }
    if (kAnyHit && all) break;
  }
}

// Combine the g partial results of each task (g lanes `part` = lane % g
// of one warp, each the least t of its triangles, ties to its lowest
// slot): the least t, ties to the lower slot, so the choice is
// block_closest's; any hit ORs the flags. Every lane of the warp calls it
// with the same g.
template <bool kAnyHit, int R>
__device__ __forceinline__ void combine_split(int g, Pick* pick, bool* hit) {
  const int lane = threadIdx.x & 31;
  for (int m = 1; m < g; m <<= 1) {
    const int src = lane ^ m;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (kAnyHit) {
        hit[j] = __shfl_sync(0xffffffffu, (int)hit[j], src) || hit[j];
      } else {
        const float tb = __shfl_sync(0xffffffffu, pick[j].tb, src);
        const int sl = __shfl_sync(0xffffffffu, pick[j].slot, src);
        const float us = __shfl_sync(0xffffffffu, pick[j].us, src);
        const float vs = __shfl_sync(0xffffffffu, pick[j].vs, src);
        const float ad = __shfl_sync(0xffffffffu, pick[j].ad, src);
        if (tb < pick[j].tb || (tb == pick[j].tb && sl < pick[j].slot))
          pick[j] = Pick{tb, us, vs, ad, sl};
      }
    }
  }
}

// cp.async: 16 bytes from device to shared memory without a register, in
// groups that are committed and waited for. Without __CUDA_ARCH__ (the
// host emulation of the sources) the copy is made at once.
__device__ __forceinline__ void copy16_async(float* smem, const float* gmem) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
#else
  memcpy(smem, gmem, 16);
#endif
}

// the same for 4 bytes (through L1: a gathered word of a ray)
__device__ __forceinline__ void copy4_async(float* smem, const float* gmem) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem) : "memory");
#else
  memcpy(smem, gmem, 4);
#endif
}

__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

}  // namespace mt_block
