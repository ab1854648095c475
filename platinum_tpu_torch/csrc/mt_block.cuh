// Moller-Trumbore test of one ray against one 64-triangle coefficient
// block, at every precision tier: the code the traversal kernels share.
//
// Included by wide_trace.cu (the depth-first packet-tracer port, K1-K9),
// stream_mt.cu (the leaf-pair kernel of the breadth-first ray-stream
// tracer, K15) and bf_stream.cu (the MT kernel of the breadth-first
// pipeline, K13), so that a (ray, triangle) pair gets the same t, to the
// bit, from each: the ray features are formed by `ray_features` with its
// products and FMAs spelled out, and each triangle's dots, accept tests
// and divisions below are one sequence of operations, whether one thread
// tests a whole block (`block_closest`: K15's per-pair code and the
// per-thread walks of wide_trace.cu), one thread several rays at once
// (`rays_dots`: K13, K15) or a warp one ray two triangles a lane
// (`lane_dots_split`, `lane_dots`, `lane_closest`, `lane_any`: the
// warp-wide modes of wide_trace.cu). `rays_dots`' kShared reads the block
// from shared memory (K13 and K15 stage it there) instead of through the
// read-only cache; the arithmetic is the same.
//
// Layout (platinum_tpu/accel/wide.py): a block is (10, 256) f32, columns
// [det x64 | u*det x64 | v*det x64 | t*det x64] of 64 triangles, rows the
// ray features F = [d, o x d, o, 1]; each output is a 10-term dot of a
// column with F. Its pre-split planes (wide_trace.cu `split_planes`) are
// (2, 10, 256) bf16, h = bf16(c) then l = bf16(c - h), the same 10,240 B:
// read as 32-bit words, word k*128 + q*32 + w of a plane holds output q of
// triangles 2w (low half) and 2w + 1 (high half) in row k.
//
// Tiers. "highest": fp32 FMAs on the CUDA cores, no TF32, no tensor cores.
// "high": the TPU kernel's bf16x3 `mt_dot` (pallas_trace.py:187-204,
// raystream.py:111-121): h = bf16(x), l = bf16(x - h) of both sides, the
// products h*h, h*l, l*h summed in three fp32 accumulators and added in
// that order (a product of two bf16 values is exact in fp32). "default":
// h*h alone. "two_phase" adds the magnitude dots |h|*|h| for its error
// bounds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mt_block {

constexpr int kBlockTris = 64;
constexpr int kBlockFloats = 10 * 4 * kBlockTris;  // 2560
constexpr unsigned kBlockBytes = kBlockFloats * 4;  // 10,240
constexpr int kPlaneWords = kBlockFloats / 2;       // one bf16 plane, 1,280
constexpr int kSplitWords = 2 * kPlaneWords;        // h and l, 10,240 B
constexpr float kDetEps = 1e-12f;

// MT precision tiers, the wrappers' codes (ops/packet_trace.py PRECISIONS)
constexpr int kHighest = 0;
constexpr int kHigh = 1;
constexpr int kDefault = 2;
constexpr int kTwoPhase = 3;

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// F = [d, o x d, o, 1]. Each cross term is one rounded product and one
// FMA, written out so that every kernel that includes this header forms
// the same bits whatever the compiler would contract.
__device__ __forceinline__ void ray_features(float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float* f) {
  f[0] = dx; f[1] = dy; f[2] = dz;
  f[3] = fmaf(oy, dz, -__fmul_rn(oz, dy));
  f[4] = fmaf(oz, dx, -__fmul_rn(ox, dz));
  f[5] = fmaf(ox, dy, -__fmul_rn(oy, dx));
  f[6] = ox; f[7] = oy; f[8] = oz; f[9] = 1.f;
}

// h = bf16(x), l = bf16(x - h) for the 10 features (pallas_trace.py:194-197)
__device__ __forceinline__ void split_features(const float* f, float* fh,
                                               float* fl) {
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    fh[k] = bf16_rn(f[k]);
    fl[k] = bf16_rn(f[k] - fh[k]);
  }
}

// Four coefficients of a block: through the read-only cache from device
// memory, or from shared memory (kShared)
template <bool kShared>
__device__ __forceinline__ float4 load_coef(const float* p) {
  if constexpr (kShared) return *reinterpret_cast<const float4*>(p);
  return __ldg(reinterpret_cast<const float4*>(p));
}

// One 64-triangle block's four MT outputs for triangles s0..s0+3, as
// 10-term fp32 dots of the coefficient rows with the features f.
__device__ __forceinline__ void block_dots(const float* __restrict__ blk,
                                           const float* f, int s0,
                                           float4 a[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const float fk = f[k];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 c =
          load_coef<false>(blk + k * 256 + q * kBlockTris + s0);
      a[q].x += c.x * fk; a[q].y += c.y * fk;
      a[q].z += c.z * fk; a[q].w += c.w * fk;
    }
  }
}

// The same outputs at a reduced tier, out[q*4 + j] for output q of
// triangle s0+j, from the features' split (fh, fl) and each coefficient's
// split as it is loaded: kHigh sums h*h, h*l and l*h in three accumulators
// and adds them in that order; kDefault forms h*h alone.
template <int kPrec>
__device__ __forceinline__ void block_dots_split(
    const float* __restrict__ blk, const float* fh, const float* fl, int s0,
    float out[16]) {
  float hh[16], hl[16], lh[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    hh[i] = 0.f; hl[i] = 0.f; lh[i] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const float fhk = fh[k];
    const float flk = kPrec == kDefault ? 0.f : fl[k];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 c =
          load_coef<false>(blk + k * 256 + q * kBlockTris + s0);
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = q * 4 + j;
        const float ch = bf16_rn(cv[j]);
        hh[i] = fmaf(ch, fhk, hh[i]);
        if (kPrec != kDefault) {
          const float cl = bf16_rn(cv[j] - ch);
          hl[i] = fmaf(ch, flk, hl[i]);
          lh[i] = fmaf(cl, fhk, lh[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    out[i] = kPrec == kDefault ? hh[i] : (hh[i] + hl[i]) + lh[i];
}

// The four outputs det, u*det, v*det, t*det of triangles s0..s0+3 at tier
// kPrec (highest, high or default).
template <int kPrec>
__device__ __forceinline__ void block_outputs(
    const float* __restrict__ blk, const float* f, const float* fh,
    const float* fl, int s0, float det[4], float ud[4], float vd[4],
    float td[4]) {
  if (kPrec == kHighest) {
    float4 a[4];
    block_dots(blk, f, s0, a);
    det[0] = a[0].x; det[1] = a[0].y; det[2] = a[0].z; det[3] = a[0].w;
    ud[0] = a[1].x; ud[1] = a[1].y; ud[2] = a[1].z; ud[3] = a[1].w;
    vd[0] = a[2].x; vd[1] = a[2].y; vd[2] = a[2].z; vd[3] = a[2].w;
    td[0] = a[3].x; td[1] = a[3].y; td[2] = a[3].z; td[3] = a[3].w;
  } else {
    float out[16];
    block_dots_split<kPrec>(blk, fh, fl, s0, out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      det[j] = out[j]; ud[j] = out[4 + j];
      vd[j] = out[8 + j]; td[j] = out[12 + j];
    }
  }
}

// block_dots and block_dots_split for R rays at once (the leaf-pair kernel's
// register blocking, stream_mt.cu): each coefficient loaded once feeds the
// R rays' products, and each ray's sums are block_dots' (kHighest) or
// block_dots_split's (kHigh, kDefault) sequence of operations, so a (ray,
// triangle) pair gets the same bits. out[r][q*4 + j] is output q of
// triangle s0+j for ray r; f, fh, fl hold each ray's features.
template <int kPrec, int R, bool kShared>
__device__ __forceinline__ void rays_dots(const float* __restrict__ blk,
                                          const float (*f)[10],
                                          const float (*fh)[10],
                                          const float (*fl)[10], int s0,
                                          float (*out)[16]) {
  if constexpr (kPrec == kHighest) {
    float4 a[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[r][q] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 10; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 c =
            load_coef<kShared>(blk + k * 256 + q * kBlockTris + s0);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float fk = f[r][k];
          a[r][q].x += c.x * fk; a[r][q].y += c.y * fk;
          a[r][q].z += c.z * fk; a[r][q].w += c.w * fk;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        out[r][q * 4] = a[r][q].x; out[r][q * 4 + 1] = a[r][q].y;
        out[r][q * 4 + 2] = a[r][q].z; out[r][q * 4 + 3] = a[r][q].w;
      }
  } else {
    float hh[R][16], hl[R][16], lh[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        hh[r][i] = 0.f; hl[r][i] = 0.f; lh[r][i] = 0.f;
      }
#pragma unroll
    for (int k = 0; k < 10; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 c =
            load_coef<kShared>(blk + k * 256 + q * kBlockTris + s0);
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = q * 4 + j;
          const float ch = bf16_rn(cv[j]);
          const float cl = kPrec == kDefault ? 0.f : bf16_rn(cv[j] - ch);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            hh[r][i] = fmaf(ch, fh[r][k], hh[r][i]);
            if (kPrec != kDefault) {
              hl[r][i] = fmaf(ch, fl[r][k], hl[r][i]);
              lh[r][i] = fmaf(cl, fh[r][k], lh[r][i]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 16; ++i)
        out[r][i] = kPrec == kDefault ? hh[r][i]
                                      : (hh[r][i] + hl[r][i]) + lh[r][i];
  }
}

// Any hit in one block: the division-free accept test. The packet kernel
// asks it at fp32 under every tier (pallas_trace.py:390); the leaf-pair
// kernel at its own tier (raystream.py:156).
template <int kPrec>
__device__ __forceinline__ bool block_any(const float* __restrict__ blk,
                                          const float* f, const float* fh,
                                          const float* fl, float tmin,
                                          float tmax) {
  for (int s0 = 0; s0 < kBlockTris; s0 += 4) {
    float det[4], ud[4], vd[4], td[4];
    block_outputs<kPrec>(blk, f, fh, fl, s0, det, ud, vd, td);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = det[j] >= 0.f ? 1.f : -1.f;
      const float ad = det[j] * s, us = ud[j] * s, vs = vd[j] * s,
                  ts = td[j] * s;
      if (ad > kDetEps && us >= 0.f && vs >= 0.f && us + vs <= ad &&
          ts > tmin * ad && ts < tmax * ad)
        return true;
    }
  }
  return false;
}

// Closest hit in one block at tier kPrec (highest, high or default),
// folded into the running best (strict <). Returns true when it replaced
// the best.
template <int kPrec>
__device__ __forceinline__ bool block_closest(
    const float* __restrict__ blk, int block, const float* f,
    const float* fh, const float* fl, float tmin, float& best, int& sid,
    float& bu, float& bv) {
  const float best0 = best;
  float tb = __int_as_float(0x7f800000);  // +inf
  int slot = -1;
  float sel_us = 0.f, sel_vs = 0.f, sel_ad = 0.f;
  for (int s0 = 0; s0 < kBlockTris; s0 += 4) {
    float det[4], ud[4], vd[4], td[4];
    block_outputs<kPrec>(blk, f, fh, fl, s0, det, ud, vd, td);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = det[j] >= 0.f ? 1.f : -1.f;
      const float ad = det[j] * s, us = ud[j] * s, vs = vd[j] * s,
                  ts = td[j] * s;
      if (ad > kDetEps && us >= 0.f && vs >= 0.f && us + vs <= ad &&
          ts > tmin * ad && ts < best0 * ad) {
        const float t = ts / fmaxf(ad, 1e-37f);
        if (t < tb) {  // ascending slots: ties keep the lowest slot
          tb = t; slot = s0 + j; sel_us = us; sel_vs = vs; sel_ad = ad;
        }
      }
    }
  }
  if (slot >= 0 && tb < best) {
    const float iad = 1.0f / fmaxf(sel_ad, 1e-37f);
    best = tb;
    sid = block * kBlockTris + slot;
    bu = sel_us * iad;
    bv = sel_vs * iad;
    return true;
  }
  return false;
}


// ---------------------------------------------------------------------
// Warp-wide block tests (wide_trace.cu): lane w of a warp forms the dots
// of triangles 2w and 2w + 1 of the block the warp tests, out[q*2 + j] for
// output q of triangle 2w + j. Each dot is the per-thread code's sequence
// of fmaf over k = 0..9, so a triangle's outputs are the same bits either
// way.

__device__ __forceinline__ float bf16_low(unsigned w) {
  return __int_as_float(static_cast<int>(w << 16));
}
__device__ __forceinline__ float bf16_high(unsigned w) {
  return __int_as_float(static_cast<int>(w & 0xffff0000u));
}

// From the pre-split planes `pl` of one block (kSplitWords words): kHigh
// and kTwoPhase sum h*h, h*l, l*h in three accumulators added (hh + hl) +
// lh, kDefault forms h*h alone; kTwoPhase also returns the magnitude dots
// mag = |h|*|h|. Each (row, output) is one 128-byte line of each plane for
// the warp.
template <int kPrec>
__device__ __forceinline__ void lane_dots_split(
    const unsigned* __restrict__ pl, int lane, const float* fh,
    const float* fl, float out[8], float mag[8]) {
  float hh[8], hl[8], lh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    hh[i] = 0.f; hl[i] = 0.f; lh[i] = 0.f;
    if (kPrec == kTwoPhase) mag[i] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const float fhk = fh[k];
    const float flk = kPrec == kDefault ? 0.f : fl[k];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned wh = __ldg(pl + k * 128 + q * 32 + lane);
      const unsigned wl =
          kPrec == kDefault ? 0u
                            : __ldg(pl + kPlaneWords + k * 128 + q * 32 + lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = q * 2 + j;
        const float ch = j ? bf16_high(wh) : bf16_low(wh);
        hh[i] = fmaf(ch, fhk, hh[i]);
        if (kPrec != kDefault) {
          const float cl = j ? bf16_high(wl) : bf16_low(wl);
          hl[i] = fmaf(ch, flk, hl[i]);
          lh[i] = fmaf(cl, fhk, lh[i]);
        }
        if (kPrec == kTwoPhase) mag[i] = fmaf(fabsf(ch), fabsf(fhk), mag[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    out[i] = kPrec == kDefault ? hh[i] : (hh[i] + hl[i]) + lh[i];
}

// From the fp32 block `blk` with fp32 features: block_dots' sums
__device__ __forceinline__ void lane_dots(const float* __restrict__ blk,
                                          int lane, const float* f,
                                          float out[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = 0.f;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const float fk = f[k];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 c = __ldg(reinterpret_cast<const float2*>(
          blk + k * 256 + q * kBlockTris + 2 * lane));
      out[q * 2] += c.x * fk;
      out[q * 2 + 1] += c.y * fk;
    }
  }
}

// block_any's division-free accept test over the lane's two triangles
// (from lane_dots: block_dots' sums, so each accept is the same bit)
__device__ __forceinline__ bool lane_any(const float out[8], float tmin,
                                         float tmax) {
  bool hit = false;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float s = out[j] >= 0.f ? 1.f : -1.f;
    const float a = out[j] * s, u = out[2 + j] * s, v = out[4 + j] * s,
                ts = out[6 + j] * s;
    hit |= a > kDetEps && u >= 0.f && v >= 0.f && u + v <= a &&
           ts > tmin * a && ts < tmax * a;
  }
  return hit;
}

// block_closest's accept test and choice over the lane's two triangles:
// against the best `best0` at the block's start, the least t (ties to the
// lower slot) with its us, vs, ad; slot -1 and t = +inf where neither is
// accepted.
__device__ __forceinline__ void lane_closest(const float out[8], int lane,
                                             float tmin, float best0,
                                             float& tb, int& slot, float& us,
                                             float& vs, float& ad) {
  tb = __int_as_float(0x7f800000);
  slot = -1;
  us = vs = ad = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float s = out[j] >= 0.f ? 1.f : -1.f;
    const float a = out[j] * s, u = out[2 + j] * s, v = out[4 + j] * s,
                ts = out[6 + j] * s;
    if (a > kDetEps && u >= 0.f && v >= 0.f && u + v <= a &&
        ts > tmin * a && ts < best0 * a) {
      const float t = ts / fmaxf(a, 1e-37f);
      if (t < tb) {
        tb = t; slot = 2 * lane + j; us = u; vs = v; ad = a;
      }
    }
  }
}

}  // namespace mt_block
