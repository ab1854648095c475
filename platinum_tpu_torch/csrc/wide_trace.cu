// Closest-hit and any-hit traversal of the 16-wide BVH on Hopper (sm_90a),
// one-level and two-level (instanced), at four Moller-Trumbore precision
// tiers, with leaf blocks tested as found or queued per node (streamed or
// near-first).
//
// Replaces the Pallas TPU kernel `_make_kernel` of
// platinum_tpu/ops/pallas_trace.py (built by `_build_call`) in the modes
// the render paths reach:
//   K1 closest hit and K2 any hit over one tree;
//   K3 both again over the two-level TLAS/BLAS tree of accel/tlas.py
//      (`n_inst > 0`);
//   K4 closest hit at mt_prec="high" (bf16x3) and "default" (1-pass bf16);
//   K5 closest hit at mt_prec="two_phase" (bf16x3 broad phase keeping each
//      ray's top-2 candidate blocks, exact fp32 refine of those blocks);
//   K6 stream=True: leaf blocks queued per node, each block's 10,240 B
//      prefetched into L2 as it is queued, the queue drained oldest first;
//   K7 oct_order: children visited in a per-(node, octant) near-first
//      order (accel.wide.build_octant_orders).
// The layout contract is platinum_tpu/accel/wide.py's:
//   nodes  (N, 16, 8) f32  child records [lo.xyz, hi.xyz, meta, pad]
//   blocks (B, 10, 256) f32 Moller-Trumbore coefficients of 64 triangles,
//          columns [det x64 | u*det x64 | v*det x64 | t*det x64], rows the
//          ray features F = [d, o x d, o, 1]
//   meta   (N*16,) i32     >= 0 inner child row, -1 empty slot,
//                          <= -2 leaf: val = -meta - 2 = first_block*32 + n
//                          (instanced: val = inst<<19 | block<<5 | n)
//   inst_feat (I, 10, 128) f32, instanced only: the instance's 10x10
//          feature transform T in lanes 0..9, F_object = T F_world
//   worder (N*16,) i32, near-first order only: node n, octant o owns words
//          (n*8+o)*2 and +1, eight 4-bit child slots each, farthest first
//
// What is computed is the TPU kernel's contract, not its packet and
// superstep schedule: one thread walks one ray with a private node stack
// (local memory, accel.wide.KERNEL_STACK entries, a bound build_wide_bvh
// asserts every tree fits), slab-tests each popped node's 16 children with
// the TPU kernel's reciprocal guard and hit test, and intersects leaf
// blocks with 10-term dot products on the CUDA cores. Closest hit keeps the
// block's minimum t with ties to the lowest slot and replaces the running
// best only on a strictly smaller t, as the TPU kernel does (an exact-t tie
// across blocks or instances keeps the one visited first); the id returned
// is block*64 + slot. Any hit returns at the first accepted triangle.
//
// Two-level mode (K3). The TLAS rows and every instance's copy of its
// mesh's BLAS rows are world-space node rows of one tree, so the walk and
// its slab tests are K1's, in world space. A leaf names its instance; on
// entering a leaf of another instance than the last, the thread computes
// the 10 object-space features F_obj = T F_world (100 fp32 FMAs) and keeps
// them while the following leaves belong to the same instance. The MT
// blocks are the mesh library's, shared by all instances of a mesh. t is
// invariant under the transform, so the running best culls across
// instances unchanged; closest hit also writes the instance of the hit.
//
// Precision tiers (kPrec). "highest" (K1) forms each dot in fp32, no TF32,
// no tensor cores. "high" (K4) is the TPU kernel's bf16x3 `mt_dot`: every
// feature and coefficient x splits into h = bf16(x), l = bf16(x - h); the
// three products h*h, h*l, l*h are summed in three fp32 accumulators and
// added in that order. A product of two bf16 values is exact in fp32, so
// the CUDA cores form them exactly (FMA contraction changes nothing). The
// features split once per ray (per instance entry in the two-level mode),
// the coefficients as they are loaded. "default" forms h*h alone, the TPU's
// 1-pass bf16. Any hit stays exact fp32 under every tier
// (pallas_trace.py:390), so the any-hit modes are K2's.
// "two_phase" (K5), per ray (pallas_trace.py:416-481, 744-781): each
// visited block gets the bf16x3 dots and the magnitude dots |h|*|h|; error
// bounds e = 1.25e-4 * magnitude give loose and strict accept sets; the
// ray keeps the two blocks of smallest loose t (t1, b1, t2, b2) and a cull
// bound, the least sound upper bound of a strict hit plus 1e-6. Node tests
// cull against that bound widened by 1e-5 relative and 1e-6 absolute. The
// refine then starts from best = tmax and re-tests the distinct
// candidates in ascending (instance, block) order with K1's fp32 block
// code and strict commits. Two slots are not always enough, in the TPU
// kernel too: on a ray that leaves a surface, loose phantoms of the
// surface's own blocks near t = tmin can take both slots and push the
// winner out (pallas_trace.py:174-177 names the case of three blocks
// within the error bound of the winner). So each ray also keeps
// `evicted`, the least sound lower bound of the hits of any block that
// left or never entered the slots; where it does not clear the refined
// best, the ray walks again with K1's exact blocks. t, hit set,
// barycentrics and (outside exact-t ties) the id are then K1's on every
// ray.
//
// Queued walks (kQueue: stream, near-first order, or both). The node's 16
// children are slab-tested first, against the best at the pop; inner hits
// are pushed and leaf hits queued with their entry distance. The queue is
// then drained: oldest first (stream; slot order, as K1 visits leaves), or
// nearest first under the octant order (the order pushes far-to-near, so
// the stack top is the nearest inner child too). A queued leaf whose entry
// distance now exceeds the running best is skipped, and each block is
// tested against the running best with K1's block code. That makes the
// streamed walk visit leaves and blocks in K1's order with K1's culls, so
// its results are K1's bit for bit; it only pushes some inner children K1
// culls, whose own children then all fail their slab tests (a child's box
// lies inside its parent's). The TPU kernel tests its drain against a
// superstep snapshot of the best so that the drained matmuls are
// independent; one thread has no such batch. The queue holds one node's
// leaf children and is drained before the next pop, so 16 entries always
// suffice; the TPU kernel's queue (accel.wide.KERNEL_LEAFQ blocks) spans
// the pops of a superstep. The modes without stream or octant order keep
// the walk that tests each leaf as it is found: timed against it
// (tools/torch_time_waves.py, PERF.md), the queued walk is faster on
// camera and shadow waves but slower on bounce waves, twice as slow on the
// 1M-triangle tree's, so neither walk replaces the other yet.
//
// Streamed blocks (K6). On the TPU the stream mode exists because the
// blocks do not fit VMEM: each enqueue starts an HBM->VMEM copy and the
// drain waits on it. On the card every block is in device memory anyway;
// the counterpart of "start the copy at enqueue, wait at drain" is one
// cp.async.bulk.prefetch.L2 per queued block, issued while the rest of the
// node is expanded, so the block is on its way to L2 before its first
// load. The blocks are read in their (B, 10, 256) layout, unpadded (the
// TPU's 16-row padding is a Mosaic tiling artefact). Block offsets are
// computed in size_t: the 1M-triangle colonnade's 24,501 blocks are
// 250.9 MB.
//
// A counting instantiation (kCount) also writes, per ray, the node pops,
// the (ray, block) MT tests (broad-phase tests for two_phase), the
// instance entries (T F products), the fp32 block tests of two_phase's
// refine and exact re-walk, and whether the ray walked again;
// chip_smoke.py reads them to compute each mode's least possible time. It
// is a separate entry point and never on the render path.
//
// What bounds it on the card: dependent global-memory loads. Every pop reads
// a 512-byte node and every leaf a 10 KB block, and the next load's address
// depends on the last test. The colonnade's ~6,061 blocks are ~62 MB, more
// than the H100's 50 MB L2, so incoherent waves miss to HBM. This version
// relies on the wrapper's octant + Morton ray sort to keep a warp's rays on
// the same nodes (one broadcast load per warp) and on the L1/L2 caches.
// The reduced tiers spend 4-9x K1's arithmetic per block on the CUDA cores
// (splits and three products), where the TPU forms them on its matrix
// unit; staging blocks in shared memory, packet traversal per warp and
// tensor-core products are later work.
//
// Floating point: nvcc's default contraction (--fmad=true) is kept, so the
// feature cross products and the fp32 10-term dots use FMAs where the XLA
// reference rounds each product; results agree to the borderline-certified
// tolerance the tests state. Divisions are IEEE (no fast-math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 16;
constexpr int kBlockTris = 64;
constexpr int kBlockFloats = 10 * 4 * kBlockTris;  // 2560
constexpr unsigned kBlockBytes = kBlockFloats * 4;  // 10,240
constexpr int kStack = 256;         // accel.wide.KERNEL_STACK
constexpr int kMaxPops = 1 << 22;   // guard against malformed trees
constexpr float kDetEps = 1e-12f;
constexpr int kThreads = 128;

// MT precision tiers, the wrapper's codes (ops/packet_trace.py PRECISIONS)
constexpr int kHighest = 0;
constexpr int kHigh = 1;
constexpr int kDefault = 2;
constexpr int kTwoPhase = 3;
// two_phase widening and error-bound constants (pallas_trace.py:179-180,
// 438)
constexpr float kTpRel = 1e-5f;
constexpr float kTpAbs = 1e-6f;
constexpr float kTpK = 1.25e-4f;
constexpr float kTpNone = 3e38f;    // empty candidate slot

__device__ __forceinline__ float guarded_inv(float v) {
  // pallas_trace.py invd: |v| < 1e-20 -> +-1e-20 (sign kept, -0 -> +)
  const float tiny = v < 0.f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(v) < 1e-20f ? tiny : v);
}

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// F_obj = T F: the instance's feature transform, read through the
// read-only cache
__device__ __forceinline__ void object_features(
    const float* __restrict__ inst_feat, int inst, const float* f,
    float* fo) {
  const float* tm = inst_feat + (size_t)inst * 10 * 128;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 10; ++j) acc = fmaf(__ldg(tm + k * 128 + j), f[j], acc);
    fo[k] = acc;
  }
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(__cvta_generic_to_global(p)), "r"(kBlockBytes)
               : "memory");
}

struct Ray {
  float ox, oy, oz, ix, iy, iz, tmin, tmax;
  float f[10];   // fp32 features
  float fh[10];  // their bf16 split (reduced tiers, one-level mode)
  float fl[10];
};

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
      const float4 c = __ldg(reinterpret_cast<const float4*>(
          blk + k * 256 + q * kBlockTris + s0));
      a[q].x += c.x * fk; a[q].y += c.y * fk;
      a[q].z += c.z * fk; a[q].w += c.w * fk;
    }
  }
}

// The same outputs at a reduced tier, out[q*4 + j] for output q of
// triangle s0+j, from the features' split (fh, fl) and each coefficient's
// split as it is loaded: kHigh and kTwoPhase sum h*h, h*l and l*h in
// three accumulators and add them in that order; kDefault forms h*h alone.
// kTwoPhase also returns the magnitude dots mag = |h|*|h| (the 1-pass bf16
// product of |blk| and |feat|, bf16 rounding being symmetric).
template <int kPrec>
__device__ __forceinline__ void block_dots_split(
    const float* __restrict__ blk, const float* fh, const float* fl, int s0,
    float out[16], float mag[16]) {
  float hh[16], hl[16], lh[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    hh[i] = 0.f; hl[i] = 0.f; lh[i] = 0.f;
    if (kPrec == kTwoPhase) mag[i] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const float fhk = fh[k];
    const float flk = kPrec == kDefault ? 0.f : fl[k];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 c = __ldg(reinterpret_cast<const float4*>(
          blk + k * 256 + q * kBlockTris + s0));
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
        if (kPrec == kTwoPhase) mag[i] = fmaf(fabsf(ch), fabsf(fhk), mag[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    out[i] = kPrec == kDefault ? hh[i] : (hh[i] + hl[i]) + lh[i];
}

// Any hit in one block: the division-free accept test, always fp32.
__device__ __forceinline__ bool block_any(const float* __restrict__ blk,
                                          const float* f, float tmin,
                                          float tmax) {
  for (int s0 = 0; s0 < kBlockTris; s0 += 4) {
    float4 a[4];
    block_dots(blk, f, s0, a);
    const float det[4] = {a[0].x, a[0].y, a[0].z, a[0].w};
    const float ud[4] = {a[1].x, a[1].y, a[1].z, a[1].w};
    const float vd[4] = {a[2].x, a[2].y, a[2].z, a[2].w};
    const float td[4] = {a[3].x, a[3].y, a[3].z, a[3].w};
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
    if (kPrec == kHighest) {
      float4 a[4];
      block_dots(blk, f, s0, a);
      det[0] = a[0].x; det[1] = a[0].y; det[2] = a[0].z; det[3] = a[0].w;
      ud[0] = a[1].x; ud[1] = a[1].y; ud[2] = a[1].z; ud[3] = a[1].w;
      vd[0] = a[2].x; vd[1] = a[2].y; vd[2] = a[2].z; vd[3] = a[2].w;
      td[0] = a[3].x; td[1] = a[3].y; td[2] = a[3].z; td[3] = a[3].w;
    } else {
      float out[16], mag[16];
      block_dots_split<kPrec>(blk, fh, fl, s0, out, mag);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        det[j] = out[j]; ud[j] = out[4 + j];
        vd[j] = out[8 + j]; td[j] = out[12 + j];
      }
    }
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

// two_phase broad-phase state of one ray: cull bound, the two candidate
// blocks of smallest loose t with a sound lower bound of their hits' t,
// and the least such bound over the blocks not kept (evicted)
struct Candidates {
  float cull, t1, t2, lo1, lo2, evicted;
  int b1, b2;
};

// Broad phase of one block (pallas_trace.py:416-481): bf16x3 dots, error
// bounds from the magnitude dots, loose and strict accept sets; the
// block's least loose t competes for the two candidate slots (strict <,
// so a tie keeps the earlier block), its least sound strict-hit bound
// tightens the cull bound. Beyond the TPU kernel, the block also carries
// tLo, a sound lower bound of the t of any hit it can hold ((ts - e_t) /
// (ad + e_det) over its loose triangles; -inf where that is not
// positive or the determinant's sign is unreliable), and a block that
// leaves or never enters the two slots lowers `evicted` to its tLo.
__device__ __forceinline__ void block_broad(const float* __restrict__ blk,
                                            int tag, const float* fh,
                                            const float* fl, float tmin,
                                            Candidates& cd) {
  const float inf = __int_as_float(0x7f800000);
  float tL = inf, tS = inf, tLo = inf;
  for (int s0 = 0; s0 < kBlockTris; s0 += 4) {
    float out[16], mag[16];
    block_dots_split<kTwoPhase>(blk, fh, fl, s0, out, mag);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float det = out[j];
      const float s = det >= 0.f ? 1.f : -1.f;
      const float ad = det * s, us = out[4 + j] * s, vs = out[8 + j] * s,
                  ts = out[12 + j] * s;
      const float e_det = kTpK * mag[j], e_u = kTpK * mag[4 + j],
                  e_v = kTpK * mag[8 + j], e_t = kTpK * mag[12 + j];
      const bool unrel = ad <= e_det && mag[j] > 0.f;
      const bool solid = ad > e_det;
      const bool loose =
          unrel || (solid && us >= -e_u && vs >= -e_v &&
                    us + vs <= ad + e_u + e_v + e_det &&
                    ts > tmin * ad - tmin * e_det - e_t - kTpAbs);
      const bool strict = solid && us >= e_u && vs >= e_v &&
                          us + vs <= ad - e_u - e_v - e_det &&
                          ts > tmin * ad + tmin * e_det + e_t + kTpAbs;
      if (loose) {
        tL = fminf(tL, unrel ? 3e36f : ts * (1.0f / fmaxf(ad, 1e-37f)));
        const float num = ts - e_t;
        tLo = fminf(tLo, unrel || num < 0.f ? -inf : num / (ad + e_det));
      }
      if (strict) tS = fminf(tS, (ts + e_t) / fmaxf(ad - e_det, 1e-37f));
    }
  }
  if (tL < 3e37f) {
    if (tL < cd.t1) {
      cd.evicted = fminf(cd.evicted, cd.lo2);
      cd.t2 = cd.t1; cd.b2 = cd.b1; cd.lo2 = cd.lo1;
      cd.t1 = tL; cd.b1 = tag; cd.lo1 = tLo;
    } else if (tL < cd.t2) {
      cd.evicted = fminf(cd.evicted, cd.lo2);
      cd.t2 = tL; cd.b2 = tag; cd.lo2 = tLo;
    } else {
      cd.evicted = fminf(cd.evicted, tLo);
    }
  }
  if (tS < 3e37f) {
    const float newc = tS + kTpAbs;
    if (newc < cd.cull) cd.cull = newc;
  }
}

template <bool kAnyHit, bool kInst, bool kCount, int kPrec, bool kQueue>
__global__ void __launch_bounds__(kThreads)
wide_trace_kernel(const float* __restrict__ rays, int n_rays,
                  const float* __restrict__ nodes,
                  const float* __restrict__ blocks,
                  const int* __restrict__ meta,
                  const float* __restrict__ inst_feat,
                  const int* __restrict__ worder, int prefetch,
                  float* __restrict__ t_out, int* __restrict__ sid_out,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  int* __restrict__ inst_out, int* __restrict__ counts) {
  constexpr bool kSplit = kPrec != kHighest && !kAnyHit;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  r.ox = rays[i];
  r.oy = rays[n_rays + i];
  r.oz = rays[2 * n_rays + i];
  const float dx = rays[3 * n_rays + i];
  const float dy = rays[4 * n_rays + i];
  const float dz = rays[5 * n_rays + i];
  r.tmin = rays[6 * n_rays + i];
  r.tmax = rays[7 * n_rays + i];
  r.ix = guarded_inv(dx);
  r.iy = guarded_inv(dy);
  r.iz = guarded_inv(dz);
  r.f[0] = dx; r.f[1] = dy; r.f[2] = dz;
  r.f[3] = r.oy * dz - r.oz * dy;
  r.f[4] = r.oz * dx - r.ox * dz;
  r.f[5] = r.ox * dy - r.oy * dx;
  r.f[6] = r.ox; r.f[7] = r.oy; r.f[8] = r.oz; r.f[9] = 1.f;
  if (kSplit && !kInst) split_features(r.f, r.fh, r.fl);

  float best = r.tmax, bu = 0.f, bv = 0.f;
  int sid = -1, best_inst = 0;
  bool occluded = false;
  const float inf = __int_as_float(0x7f800000);
  Candidates cd{r.tmax, kTpNone, kTpNone, inf, inf, inf, -1, -1};
  // two_phase: the broad phase, then (for rays whose candidates may miss
  // the winner) an exact fp32 walk
  bool broad = kPrec == kTwoPhase;
  int n_pops = 0, n_tests = 0, n_xforms = 0, n_refine = 0;
  // instanced: object-space features of instance cur_inst (and their split)
  float fo[10], foh[10], fol[10];
  int cur_inst = -1;

  // the node-test bound: the running best (closest), tmax (any hit), or
  // the widened cull bound (two_phase broad phase)
  auto cull_now = [&]() -> float {
    if (kAnyHit) return r.tmax;
    if (kPrec == kTwoPhase && broad) return cd.cull * (1.0f + kTpRel) + kTpAbs;
    return best;
  };

  // test the blocks of leaf `val` (returns early on an any-hit occlusion)
  auto visit_leaf = [&](int val) {
    const int nb = val & 31;
    int b0 = val >> 5;
    int inst = 0;
    const float* f = r.f;
    const float* fh = r.fh;
    const float* fl = r.fl;
    if (kInst) {
      b0 = (val >> 5) & 0x3FFF;
      inst = val >> 19;
      if (inst != cur_inst) {
        object_features(inst_feat, inst, r.f, fo);
        if (kSplit) split_features(fo, foh, fol);
        cur_inst = inst;
        if (kCount) ++n_xforms;
      }
      f = fo; fh = foh; fl = fol;
    }
    for (int j = 0; j < nb; ++j) {
      const int b = b0 + j;
      const float* blk = blocks + (size_t)b * kBlockFloats;
      if (kCount) {
        if (kPrec == kTwoPhase && !broad) ++n_refine; else ++n_tests;
      }
      if (kAnyHit) {
        if (block_any(blk, f, r.tmin, r.tmax)) { occluded = true; return; }
      } else if (kPrec == kTwoPhase) {
        if (broad)
          block_broad(blk, kInst ? (inst << 14 | b) : b, fh, fl, r.tmin, cd);
        else if (block_closest<kHighest>(blk, b, f, fh, fl, r.tmin, best,
                                         sid, bu, bv))
          best_inst = inst;
      } else if (block_closest<kPrec>(blk, b, f, fh, fl, r.tmin, best, sid,
                                      bu, bv)) {
        best_inst = inst;
      }
    }
  };

  const int octant = (dx < 0.f) + 2 * (dy < 0.f) + 4 * (dz < 0.f);
  auto walk = [&]() {
    int stack[kStack];
    int sp = 0;
    stack[sp++] = 0;
    for (int pops = 0; sp > 0 && pops < kMaxPops; ++pops) {
      const int n = stack[--sp];
      if (kCount) ++n_pops;
      const float4* rec = reinterpret_cast<const float4*>(nodes) + n * 2 * kWidth;
      const int* mrow = meta + n * kWidth;
      // queued walks: leaf hits of this node, in the order found
      int qv[kQueue ? kWidth : 1];
      float qt[kQueue ? kWidth : 1];
      int q = 0;
      int w0 = 0, w1 = 0;
      if (kQueue && worder != nullptr) {
        w0 = __ldg(worder + (n * 8 + octant) * 2);
        w1 = __ldg(worder + (n * 8 + octant) * 2 + 1);
      }
      const float cull0 = cull_now();
      for (int j = 0; j < kWidth; ++j) {
        int c = j;
        if (kQueue && worder != nullptr)
          c = ((j < 8 ? w0 : w1) >> (4 * (j & 7))) & 15;
        const int mc = __ldg(mrow + c);
        if (mc == -1) continue;  // empty slot: bounds are placeholders
        const float4 a = __ldg(rec + 2 * c);      // lo.xyz, hi.x
        const float4 b = __ldg(rec + 2 * c + 1);  // hi.yz, meta, pad
        const float t0x = (a.x - r.ox) * r.ix, t1x = (a.w - r.ox) * r.ix;
        const float t0y = (a.y - r.oy) * r.iy, t1y = (b.x - r.oy) * r.iy;
        const float t0z = (a.z - r.oz) * r.iz, t1z = (b.y - r.oz) * r.iz;
        const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                  fminf(t0z, t1z));
        const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                 fmaxf(t0z, t1z));
        if (!(tnear <= tfar && tfar >= r.tmin &&
              tnear <= (kQueue ? cull0 : cull_now())))
          continue;
        if (mc >= 0) {
          stack[sp < kStack ? sp : kStack - 1] = mc;
          sp = sp < kStack ? sp + 1 : kStack;
          continue;
        }
        const int val = -mc - 2;
        if (!kQueue) {
          visit_leaf(val);
          if (kAnyHit && occluded) break;
          continue;
        }
        qv[q] = val;
        qt[q] = tnear;
        ++q;
        if (prefetch) {
          const int b0 = kInst ? (val >> 5) & 0x3FFF : val >> 5;
          for (int k = 0; k < (val & 31); ++k)
            prefetch_l2(blocks + (size_t)(b0 + k) * kBlockFloats);
        }
      }
      if (kQueue) {
        for (int k = 0; k < q; ++k) {
          const int e = worder != nullptr ? q - 1 - k : k;
          if (!(qt[e] <= cull_now())) continue;
          visit_leaf(qv[e]);
          if (kAnyHit && occluded) break;
        }
      }
      if (kAnyHit && occluded) break;
    }
  };

  // A ray with tmax <= tmin (dead lanes carry tmax = tmin - 1) can accept
  // no triangle: skip the walk.
  bool fell_back = false;
  if (r.tmax > r.tmin) walk();

  if (kPrec == kTwoPhase && !kAnyHit && r.tmax > r.tmin) {
    // refine: the distinct candidates in ascending order, exact fp32
    best = r.tmax;
    sid = -1;
    bu = bv = 0.f;
    best_inst = 0;
    const int lo = cd.b1 < cd.b2 ? cd.b1 : cd.b2;
    const int hi = cd.b1 < cd.b2 ? cd.b2 : cd.b1;
    for (int k = 0; k < 2; ++k) {
      const int tag = k == 0 ? lo : hi;
      if (tag < 0 || (k == 1 && tag == lo)) continue;
      int b = tag, inst = 0;
      const float* f = r.f;
      if (kInst) {
        b = tag & 0x3FFF;
        inst = tag >> 14;
        object_features(inst_feat, inst, r.f, fo);
        cur_inst = inst;
        f = fo;
        if (kCount) ++n_xforms;
      }
      if (kCount) ++n_refine;
      if (block_closest<kHighest>(blocks + (size_t)b * kBlockFloats, b, f,
                                  nullptr, nullptr, r.tmin, best, sid, bu,
                                  bv))
        best_inst = inst;
    }
    // A block that left (or never entered) the two slots holds no hit
    // nearer than its lower bound; if that bound falls below the refined
    // best, the winner may be among them (loose phantoms near tmin crowd
    // the slots on rays that leave a surface): walk again with K1's exact
    // blocks, from tmax.
    if (cd.evicted < best) {
      fell_back = true;
      broad = false;
      best = r.tmax;
      sid = -1;
      bu = bv = 0.f;
      best_inst = 0;
      walk();
    }
  }

  t_out[i] = kAnyHit ? r.tmax : best;
  sid_out[i] = kAnyHit ? (occluded ? 1 : -1) : sid;
  u_out[i] = bu;
  v_out[i] = bv;
  if (kInst && !kAnyHit) inst_out[i] = best_inst;
  if (kCount) {
    counts[i] = n_pops;
    counts[n_rays + i] = n_tests;
    counts[2 * n_rays + i] = n_xforms;
    counts[3 * n_rays + i] = n_refine;
    counts[4 * n_rays + i] = fell_back;
  }
}

struct Launch {
  dim3 grid;
  cudaStream_t stream;
  const float* rays;
  int n_rays;
  const float* nodes;
  const float* blocks;
  const int* meta;
  const float* inst_feat;
  const int* worder;
  int prefetch;
  float* t_out;
  int* sid_out;
  float* u_out;
  float* v_out;
  int* inst_out;
  int* counts;
};

template <bool kAnyHit, bool kInst, bool kCount, int kPrec, bool kQueue>
void launch(const Launch& l) {
  wide_trace_kernel<kAnyHit, kInst, kCount, kPrec, kQueue>
      <<<l.grid, kThreads, 0, l.stream>>>(
          l.rays, l.n_rays, l.nodes, l.blocks, l.meta, l.inst_feat,
          l.worder, l.prefetch, l.t_out, l.sid_out, l.u_out, l.v_out,
          l.inst_out, l.counts);
}

template <bool kAnyHit, bool kInst, bool kCount, bool kQueue>
int by_precision(int prec, const Launch& l) {
  if constexpr (kAnyHit) {
    // any hit is exact fp32 under every tier (pallas_trace.py:390)
    launch<true, kInst, kCount, kHighest, kQueue>(l);
  } else {
    switch (prec) {
      case kHighest: launch<false, kInst, kCount, kHighest, kQueue>(l); break;
      case kHigh: launch<false, kInst, kCount, kHigh, kQueue>(l); break;
      case kDefault: launch<false, kInst, kCount, kDefault, kQueue>(l); break;
      case kTwoPhase: launch<false, kInst, kCount, kTwoPhase, kQueue>(l); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return 0;
}

template <bool kAnyHit, bool kInst, bool kCount>
int by_walk(int prec, bool queue, const Launch& l) {
  return queue ? by_precision<kAnyHit, kInst, kCount, true>(prec, l)
               : by_precision<kAnyHit, kInst, kCount, false>(prec, l);
}

template <bool kCount>
int by_mode(int any_hit, int prec, bool queue, const Launch& l) {
  const bool inst = l.inst_feat != nullptr;
  if (any_hit && inst) return by_walk<true, true, kCount>(prec, queue, l);
  if (any_hit) return by_walk<true, false, kCount>(prec, queue, l);
  if (inst) return by_walk<false, true, kCount>(prec, queue, l);
  return by_walk<false, false, kCount>(prec, queue, l);
}

}  // namespace

extern "C" {

// Launches one traversal wave on `stream` and returns cudaGetLastError()
// (0 on success; cudaErrorInvalidValue for an unknown tier or two_phase
// with streamed blocks). rays: (8, n_rays) f32 rows [ox, oy, oz, dx, dy,
// dz, tmin, tmax]; outputs (n_rays,) each. inst_feat non-null selects the
// two-level mode, which also writes inst_out in closest-hit mode. mt_prec:
// 0 highest, 1 high, 2 default, 3 two_phase (closest hit only). worder
// non-null selects the near-first octant order; stream != 0 queues and
// prefetches the leaf blocks. counts non-null selects the counting
// instantiation: (5, n_rays) i32 rows of node pops, MT block tests,
// instance entries, fp32 refine / re-walk block tests and re-walks.
// Allocates nothing and does not synchronise.
int wide_trace_launch(const float* rays, int n_rays, const float* nodes,
                      const float* blocks, const int* meta,
                      const float* inst_feat, const int* worder,
                      int any_hit, int mt_prec, int stream, float* t_out,
                      int* sid_out, float* u_out, float* v_out,
                      int* inst_out, int* counts, void* cuda_stream) {
  if (mt_prec < kHighest || mt_prec > kTwoPhase ||
      (mt_prec == kTwoPhase && stream))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l{dim3((n_rays + kThreads - 1) / kThreads),
                 static_cast<cudaStream_t>(cuda_stream), rays, n_rays, nodes,
                 blocks, meta, inst_feat, worder, stream, t_out, sid_out,
                 u_out, v_out, inst_out, counts};
  const bool queue = worder != nullptr || stream != 0;
  const int rc = counts != nullptr
                     ? by_mode<true>(any_hit, mt_prec, queue, l)
                     : by_mode<false>(any_hit, mt_prec, queue, l);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* wide_trace_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
