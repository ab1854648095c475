// Closest-hit and any-hit traversal of the 16-wide BVH on Hopper (sm_90a),
// one-level and two-level (instanced).
//
// Replaces the Pallas TPU kernel `_make_kernel` of
// platinum_tpu/ops/pallas_trace.py (built by `_build_call`) in the four
// modes on the render paths: closest hit (every path wave, K1) and any hit
// (every NEE shadow wave, K2) over one tree, and both again over the
// two-level TLAS/BLAS tree of accel/tlas.py (K3, `n_inst > 0`). The layout
// contract is platinum_tpu/accel/wide.py's:
//   nodes  (N, 16, 8) f32  child records [lo.xyz, hi.xyz, meta, pad]
//   blocks (B, 10, 256) f32 Moller-Trumbore coefficients of 64 triangles,
//          columns [det x64 | u*det x64 | v*det x64 | t*det x64], rows the
//          ray features F = [d, o x d, o, 1]
//   meta   (N*16,) i32     >= 0 inner child row, -1 empty slot,
//                          <= -2 leaf: val = -meta - 2 = first_block*32 + n
//                          (instanced: val = inst<<19 | block<<5 | n)
//   inst_feat (I, 10, 128) f32, instanced only: the instance's 10x10
//          feature transform T in lanes 0..9, F_object = T F_world
//
// Two-level mode (K3). The TLAS rows and every instance's copy of its
// mesh's BLAS rows are world-space node rows of one tree, so the walk and
// its slab tests are K1's, in world space. A leaf names its instance; on
// entering a leaf of another instance than the last, the thread computes
// the 10 object-space features F_obj = T F_world (100 fp32 FMAs, T read
// through the read-only cache) and keeps them while the following leaves
// belong to the same instance. The MT blocks are the mesh library's,
// shared by all instances of a mesh, tested with F_obj. t is invariant
// under the transform (the direction is transformed unnormalised), so
// the running best t culls across instances unchanged; the closest-hit
// mode also writes the instance of the best hit.
//
// What is computed is the TPU kernel's contract, not its packet and
// superstep schedule: one thread walks one ray with a private node stack
// (local memory, accel.wide.KERNEL_STACK entries, a bound build_wide_bvh
// asserts every tree fits), slab-tests each popped node's 16 children with
// the TPU kernel's reciprocal guard and hit test, and intersects each leaf
// block with 10-term fp32 dot products on the CUDA cores (the "highest"
// tier: no TF32, no tensor cores). Closest hit keeps the block's minimum t
// with ties to the lowest slot and replaces the running best only on a
// strictly smaller t, as the TPU kernel does (the same rule in both
// levels: an exact-t tie across blocks or instances keeps the one visited
// first); the id returned is block*64 + slot. Any hit returns at the first
// accepted triangle.
//
// A counting instantiation (kCount) also writes, per ray, the node pops,
// the (ray, block) MT tests and the instance entries (T F products) it
// made; chip_smoke.py reads them to compute each mode's least possible
// time. It is a separate entry point and never on the render path.
//
// What bounds it on the card: dependent global-memory loads. Every pop reads
// a 512-byte node and every leaf a 10 KB block, and the next load's address
// depends on the last test. The colonnade's ~6,061 blocks are ~62 MB, more
// than the H100's 50 MB L2, so incoherent waves miss to HBM. This first
// version does not address that, because it is meant to be the simple,
// correct baseline that faster variants are measured against: it relies on
// the wrapper's octant + Morton ray sort to keep a warp's rays on the same
// nodes (one broadcast load per warp) and on the L1/L2 caches. Staging
// shared blocks in shared memory, packet traversal per warp and a
// compressed block format are later work.
//
// Floating point: nvcc's default contraction (--fmad=true) is kept, so the
// feature cross products and the 10-term dots use FMAs where the XLA
// reference rounds each product; results agree to the borderline-certified
// tolerance the tests state. Divisions are IEEE (no fast-math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 16;
constexpr int kBlockTris = 64;
constexpr int kBlockFloats = 10 * 4 * kBlockTris;  // 2560
constexpr int kStack = 256;         // accel.wide.KERNEL_STACK
constexpr int kMaxPops = 1 << 22;   // guard against malformed trees
constexpr float kDetEps = 1e-12f;
constexpr int kThreads = 128;

__device__ __forceinline__ float guarded_inv(float v) {
  // pallas_trace.py invd: |v| < 1e-20 -> +-1e-20 (sign kept, -0 -> +)
  const float tiny = v < 0.f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(v) < 1e-20f ? tiny : v);
}

struct Ray {
  float ox, oy, oz, ix, iy, iz, tmin, tmax;
  float f[10];
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

// Any hit in one block: the division-free accept test.
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

// Closest hit in one block, folded into the running best (strict <).
// Returns true when it replaced the best.
__device__ __forceinline__ bool block_closest(const float* __restrict__ blk,
                                              int block, const float* f,
                                              float tmin, float& best,
                                              int& sid, float& bu,
                                              float& bv) {
  const float best0 = best;
  float tb = __int_as_float(0x7f800000);  // +inf
  int slot = -1;
  float sel_us = 0.f, sel_vs = 0.f, sel_ad = 0.f;
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

template <bool kAnyHit, bool kInst, bool kCount>
__global__ void __launch_bounds__(kThreads)
wide_trace_kernel(const float* __restrict__ rays, int n_rays,
                  const float* __restrict__ nodes,
                  const float* __restrict__ blocks,
                  const int* __restrict__ meta,
                  const float* __restrict__ inst_feat,
                  float* __restrict__ t_out, int* __restrict__ sid_out,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  int* __restrict__ inst_out, int* __restrict__ counts) {
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

  float best = r.tmax, bu = 0.f, bv = 0.f;
  int sid = -1, best_inst = 0;
  bool occluded = false;
  int n_pops = 0, n_tests = 0, n_xforms = 0;
  // instanced: object-space features of instance cur_inst
  float fo[10];
  int cur_inst = -1;
  // A ray with tmax <= tmin (dead lanes carry tmax = tmin - 1) can accept
  // no triangle: skip the walk.
  if (r.tmax > r.tmin) {
    int stack[kStack];
    int sp = 0;
    stack[sp++] = 0;
    for (int pops = 0; sp > 0 && pops < kMaxPops; ++pops) {
      const int n = stack[--sp];
      if (kCount) ++n_pops;
      const float4* rec = reinterpret_cast<const float4*>(nodes) + n * 2 * kWidth;
      const int* mrow = meta + n * kWidth;
      for (int c = 0; c < kWidth; ++c) {
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
        if (!(tnear <= tfar && tfar >= r.tmin && tnear <= best)) continue;
        if (mc >= 0) {
          stack[sp < kStack ? sp : kStack - 1] = mc;
          sp = sp < kStack ? sp + 1 : kStack;
          continue;
        }
        const int val = -mc - 2;
        const int nb = val & 31;
        int b0 = val >> 5;
        const float* f = r.f;
        int inst = 0;
        if (kInst) {
          b0 = (val >> 5) & 0x3FFF;
          inst = val >> 19;
          if (inst != cur_inst) {
            const float* tm = inst_feat + (size_t)inst * 10 * 128;
#pragma unroll
            for (int k = 0; k < 10; ++k) {
              float acc = 0.f;
#pragma unroll
              for (int j = 0; j < 10; ++j)
                acc = fmaf(__ldg(tm + k * 128 + j), r.f[j], acc);
              fo[k] = acc;
            }
            cur_inst = inst;
            if (kCount) ++n_xforms;
          }
          f = fo;
        }
        for (int j = 0; j < nb; ++j) {
          const float* blk = blocks + (size_t)(b0 + j) * kBlockFloats;
          if (kCount) ++n_tests;
          if (kAnyHit) {
            if (block_any(blk, f, r.tmin, r.tmax)) { occluded = true; break; }
          } else if (block_closest(blk, b0 + j, f, r.tmin, best, sid, bu,
                                   bv)) {
            best_inst = inst;
          }
        }
        if (kAnyHit && occluded) break;
      }
      if (kAnyHit && occluded) break;
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
  }
}

template <bool kAnyHit, bool kInst, bool kCount>
void launch(const dim3& grid, cudaStream_t s, const float* rays, int n_rays,
            const float* nodes, const float* blocks, const int* meta,
            const float* inst_feat, float* t_out, int* sid_out, float* u_out,
            float* v_out, int* inst_out, int* counts) {
  wide_trace_kernel<kAnyHit, kInst, kCount><<<grid, kThreads, 0, s>>>(
      rays, n_rays, nodes, blocks, meta, inst_feat, t_out, sid_out, u_out,
      v_out, inst_out, counts);
}

template <bool kCount>
void dispatch(int any_hit, bool inst, const dim3& grid, cudaStream_t s,
              const float* rays, int n_rays, const float* nodes,
              const float* blocks, const int* meta, const float* inst_feat,
              float* t_out, int* sid_out, float* u_out, float* v_out,
              int* inst_out, int* counts) {
  if (any_hit && inst)
    launch<true, true, kCount>(grid, s, rays, n_rays, nodes, blocks, meta,
                               inst_feat, t_out, sid_out, u_out, v_out,
                               inst_out, counts);
  else if (any_hit)
    launch<true, false, kCount>(grid, s, rays, n_rays, nodes, blocks, meta,
                                inst_feat, t_out, sid_out, u_out, v_out,
                                inst_out, counts);
  else if (inst)
    launch<false, true, kCount>(grid, s, rays, n_rays, nodes, blocks, meta,
                                inst_feat, t_out, sid_out, u_out, v_out,
                                inst_out, counts);
  else
    launch<false, false, kCount>(grid, s, rays, n_rays, nodes, blocks, meta,
                                 inst_feat, t_out, sid_out, u_out, v_out,
                                 inst_out, counts);
}

}  // namespace

extern "C" {

// Launches one traversal wave on `stream` and returns cudaGetLastError()
// (0 on success). rays: (8, n_rays) f32 rows [ox, oy, oz, dx, dy, dz, tmin,
// tmax]; outputs (n_rays,) each. inst_feat non-null selects the two-level
// mode, which also writes inst_out in closest-hit mode. counts non-null
// selects the counting instantiation: (3, n_rays) i32 rows of node pops,
// MT block tests and instance entries. Allocates nothing and does not
// synchronise.
int wide_trace_launch(const float* rays, int n_rays, const float* nodes,
                      const float* blocks, const int* meta,
                      const float* inst_feat, int any_hit, float* t_out,
                      int* sid_out, float* u_out, float* v_out,
                      int* inst_out, int* counts, void* stream) {
  const dim3 grid((n_rays + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool inst = inst_feat != nullptr;
  if (counts != nullptr)
    dispatch<true>(any_hit, inst, grid, s, rays, n_rays, nodes, blocks, meta,
                   inst_feat, t_out, sid_out, u_out, v_out, inst_out, counts);
  else
    dispatch<false>(any_hit, inst, grid, s, rays, n_rays, nodes, blocks,
                    meta, inst_feat, t_out, sid_out, u_out, v_out, inst_out,
                    counts);
  return static_cast<int>(cudaGetLastError());
}

const char* wide_trace_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
