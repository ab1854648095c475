// Closest-hit and any-hit traversal of the 16-wide BVH on Hopper (sm_90a),
// one-level and two-level (instanced), at four Moller-Trumbore precision
// tiers, with leaf blocks tested as found, queued per node (streamed or
// near-first) or kept in a backlog across nodes (pipelined), a closest-hit
// and an any-hit wave in one launch, and the ablation modes.
//
// Replaces the Pallas TPU kernels `_make_kernel` and `_make_kernel_pipe`
// of platinum_tpu/ops/pallas_trace.py (built by `_build_call`) in every
// mode:
//   K1 closest hit and K2 any hit over one tree;
//   K3 both again over the two-level TLAS/BLAS tree of accel/tlas.py
//      (`n_inst > 0`);
//   K4 closest hit at mt_prec="high" (bf16x3) and "default" (1-pass bf16);
//   K5 closest hit at mt_prec="two_phase" (bf16x3 broad phase keeping each
//      ray's top-2 candidate blocks, exact fp32 refine of those blocks);
//   K6 stream=True: leaf blocks queued per node, each block's 10,240 B
//      prefetched into L2 as it is queued (closest hit), the queue drained
//      oldest first;
//   K7 oct_order: children visited in a per-(node, octant) near-first
//      order (accel.wide.build_octant_orders), each node's leaf queue
//      drained newest first;
//   K8 the paired launch (`trace_paired`): one grid over a closest-hit
//      wave and an any-hit wave, each CTA running for its 128 rays the
//      drain of the unpaired mode that computes its half
//      (wide_trace_paired below);
//   K9 pipe / flat_walk (`_make_kernel_pipe`): the pipelined walk, a
//      backlog of leaf blocks that outlives a node (warp_pipe below);
//   the ablation modes of `profile=` ("empty", "nomt", "fix64", "count":
//      wrong results by design, for splitting a wave's time into launch
//      floor, walk and block tests; kProf).
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
// blocks with 10-term dot products on the CUDA cores (csrc/mt_block.cuh,
// shared with the ray-stream tracer's leaf-pair kernel). Closest hit keeps the
// block's minimum t with ties to the lowest slot and replaces the running
// best only on a strictly smaller t, as the TPU kernel does (an exact-t tie
// across blocks or instances keeps the one visited first); the id returned
// is block*64 + slot. Any hit returns at the first accepted triangle.
//
// Two-level mode (K3). The TLAS rows and every instance's copy of its
// mesh's BLAS rows are world-space node rows of one tree, so the walk and
// its slab tests are K1's, in world space. A leaf names its instance; on
// entering a leaf of another instance than the last, the ray's 10
// object-space features F_obj = T F_world are formed (100 fp32 FMAs; in
// the fp32 drain once per drained lane and instance, by ten lanes) and
// kept while the following leaves belong to the same instance. The MT
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
// features split once per ray (per instance entry in the two-level mode);
// the coefficients are split once per tracer, into the pre-split planes
// (`split_planes` below), which the reduced tiers read in place of the
// fp32 blocks. "default" forms h*h alone, the TPU's 1-pass bf16. Any hit
// stays exact fp32 under every tier (pallas_trace.py:390), so the any-hit
// modes are K2's.
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
// Warp-wide block tests. Taken by closest hit at the reduced tiers (K4,
// K5, and K6 and K7 at those tiers), by fp32 closest hit over one tree
// level or two, with or without the octant order (K1, K3, K6, K7; walk
// kWarpQ, the prefetch flag telling the streamed closest hit apart), by
// fp32 any hit without it (K2, K3 any hit, K6 any hit; kWarpQ too), by
// both halves of the paired launch (K8, each CTA on its half's drain) and
// by the pipelined walk (K9, closest and any hit; kWarpPipe, kWarpFlat).
// One thread per ray that
// tests whole blocks reads each block as 640 scattered 16-byte loads (a
// reduced tier also splits each of its 2,560 coefficients again for every
// ray): lanes on different blocks
// touch 32 lines per load and use 16 bytes of each, and lanes whose leaves
// hold fewer blocks wait for the others. Here the walk stays one ray per
// lane, in the queued form below, and each node's leaf blocks are tested
// by the whole warp: the lanes' queues are drained lane after lane, each
// lane's entries in its own queue order; the drained lane's features are
// broadcast (__shfl_sync), every lane forms the dots of two of the block's
// 64 triangles (per row and output one 128-byte line of each pre-split
// plane, or two of the fp32 block, read once), and a warp
// reduction keeps the least (t, slot), or for the two_phase broad phase
// the least loose t, strict bound and lower bound. The lane that holds the
// winner forms u and v, and the drained lane commits with the strict <
// against the best it had when the block started, so the hit set, t, ids
// and barycentrics are those of the per-thread code, bit for bit. The fp32
// drain (K1, K3, K6, K7, K9, and K5's refine and exact re-walk) uses K1's
// per-triangle code (mt_block.cuh `lane_dots`, block_dots' sum order).
// Under the octant order (K7) each lane's queue is drained newest first,
// the per-thread queued walk's near-first order.
// In the two-level fp32 drain (K3) the drained lane's ray is broadcast and
// lanes 0-9 each form one row of its object features T F, in
// object_features' order, which are then broadcast: ten lanes do the
// instance entry that one thread did. Any hit (K2, K3 any hit, K6 any
// hit; resident and streamed blocks take the same drain, which prefetches
// nothing) tests each block with block_any's accept test over each lane's
// two triangles (`lane_any`); one __any_sync decides, and an occluded
// lane's remaining queue and stack are dropped. Over two levels the
// drained lane enters an instance with K3 closest's ten lanes. Its node
// cull is the constant tmax and expand queues a node's leaves in slot
// order, so it pops the nodes and tests the blocks of the per-thread
// classic walk, in its order, and its flag is that walk's. The pipelined
// drain (K9) keeps the per-thread pipe's schedule lane by lane (see
// warp_pipe). Every lane runs every warp collective: lanes whose ray is
// done or lies past the wave stay in the loops with empty queues.
//
// The per-thread walks stay for the any hit under the octant order (the
// packet tracer never asks it: the JAX kernel orders closest hit only,
// pallas_trace.py:1459) and the ablation modes, which split the
// per-thread walk's time; and as the references the drains are held to,
// reached only through the launch's per-thread flag (`kPerThread`, never
// on a render path): the per-thread pipelined walk (walk_pipe, both
// pushes, closest and any hit, one level and two) for K1, K3, K9 and the
// instanced any hit, the per-thread queued walk under the octant order
// (closest hit, one level and two, resident and streamed) for K7, the
// per-thread classic any-hit walk over one level (resident or streamed
// alike) for K2 and K6 any hit, and the per-thread paired kernel
// (kPaired: each thread takes its mode from its ray index, the any-hit
// half on the classic or queued walk) for K8.

// Queued walks (kQueue: stream or near-first order on the per-thread
// walk; every warp-wide walk). The node's 16 children are slab-tested
// first, against the best at the pop; inner hits are pushed and leaf hits
// queued with their entry distance. The queue is then drained: oldest
// first (slot order, as the classic walk visits leaves), or nearest first
// under the octant order (the order pushes far-to-near, so the stack top
// is the nearest inner child too). A queued leaf whose entry distance now
// exceeds the running best is skipped, and each block is tested against
// the running best with K1's block code. That makes the queued walk visit
// leaves and blocks in the classic walk's order with its culls, so its
// results are the classic walk's bit for bit; it only pushes some inner
// children the classic walk culls, whose own children then all fail their
// slab tests (a child's box lies inside its parent's): its node pops may
// rise a little, its MT block tests do not. The TPU kernel tests its
// drain against a superstep snapshot of the best so that the drained
// matmuls are independent; one thread has no such batch. The queue holds
// one node's leaf children and is drained before the next pop, so 16
// entries always suffice; the TPU kernel's queue (accel.wide.KERNEL_LEAFQ
// blocks) spans the pops of a superstep.
//
// Streamed blocks (K6). On the TPU the stream mode exists because the
// blocks do not fit VMEM: each enqueue starts an HBM->VMEM copy and the
// drain waits on it. On the card every block is in device memory anyway;
// the counterpart of "start the copy at enqueue, wait at drain" is one
// cp.async.bulk.prefetch.L2 per queued block (of its pre-split planes at a
// reduced tier, the h plane alone at "default"), issued while the rest of
// the node is expanded, so the block is on its way to L2 before its first
// load (closest hit; the any-hit drain prefetches nothing, see expand).
// The blocks are read in their (B, 10, 256) layout, unpadded (the
// TPU's 16-row padding is a Mosaic tiling artefact). Block offsets are
// computed in size_t: the 1M-triangle colonnade's 24,501 blocks are
// 250.9 MB.
//
// A counting instantiation (kCount) also writes, per ray, the node pops,
// the (ray, block) MT tests (broad-phase tests for two_phase), the
// instance entries (T F products; in the fp32 drain over two levels, K3
// and its any hit, one per drained lane, instance and round, more than
// the walk's switches of instance), the fp32 block tests of two_phase's
// refine and exact re-walk, and whether the ray walked again; and, on lane
// 0 of each warp, the warp-wide drain rounds that tested a block and the
// distinct blocks they tested (the tensor-core question: how many lanes
// want one block at once). chip_smoke.py reads them to compute each mode's
// least possible time. It is a separate entry point and never on the
// render path.
//
// What bounds it on the card: dependent global-memory loads. Every pop reads
// a 512-byte node and every leaf a 10 KB block, and the next load's address
// depends on the last test. The colonnade's ~6,061 blocks are ~62 MB, more
// than the H100's 50 MB L2, so incoherent waves miss to HBM. This version
// relies on the wrapper's octant + Morton ray sort to keep a warp's rays on
// the same nodes (one broadcast load per warp) and on the L1/L2 caches.
// The reduced tiers form three (two_phase: four) products per term on the
// CUDA cores, where the TPU forms them on its matrix unit; a block staged
// in shared memory for the lanes that share it, and tensor-core products
// over such lanes, are later work.
//
// Floating point: nvcc's default contraction (--fmad=true) is kept, so the
// feature cross products and the fp32 10-term dots use FMAs where the XLA
// reference rounds each product; results agree to the borderline-certified
// tolerance the tests state. Divisions are IEEE (no fast-math).

#include "mt_block.cuh"

namespace {

using namespace mt_block;

constexpr int kWidth = 16;
constexpr int kStack = 256;         // accel.wide.KERNEL_STACK
constexpr int kLeafQ = 64;          // accel.wide.KERNEL_LEAFQ: most blocks
                                    // one node's leaves hold
constexpr int kPipeQ = 256;         // backlog entries of the pipelined walk
constexpr int kPipeDrain = 4;       // its block tests per iteration
constexpr int kMaxPops = 1 << 22;   // guard against malformed trees
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// walks (kWalk)
constexpr int kClassic = 0;   // each leaf tested as it is found (K2's
                              // and K8's references, the ablation modes)
constexpr int kQueued = 1;    // per-node leaf queue (K8's streamed
                              // reference, the any hit under the octant
                              // order, K7's reference; the reduced tiers)
constexpr int kPipe = 2;      // persistent backlog, bounded drain (K9's
                              // per-thread reference)
constexpr int kPipeFlat = 3;  // the same with 16 predicated pushes a node
constexpr int kWarpQ = 4;     // the warp-wide queued walk at fp32 (K1,
                              // K2, K3, K6, K7)
constexpr int kWarpPipe = 5;  // the warp-wide pipelined drain (K9 pipe)
constexpr int kWarpFlat = 6;  // the same with the flat push (K9 flat_walk)
// the walks that drain fp32 blocks warp-wide, each with its own render
// kernel (wide_trace_warp_kernel)
__host__ __device__ constexpr bool fp32_drain(int walk) {
  return walk == kWarpQ || walk == kWarpPipe || walk == kWarpFlat;
}
// the launch's walk code: 0 the default walk, 1 pipe, 2 flat_walk, plus
// kPerThread for the per-thread reference of the mode (wide_trace_launch)
constexpr int kPerThread = 4;
// ablation modes (kProf), the wrapper's codes (ops/packet_trace.py PROFILES)
constexpr int kProfNone = 0;
constexpr int kProfEmpty = 1;   // no walk
constexpr int kProfNoMt = 2;    // the walk with every block test skipped
constexpr int kProfFix64 = 3;   // exactly 64 loop iterations
constexpr int kProfCount = 4;   // the iteration count in place of u
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

__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(__cvta_generic_to_global(p)), "r"(bytes)
               : "memory");
}

// A float's 32-bit key in the floats' order (any non-NaN value), -0 as +0:
// the warp reductions take the least key with one __reduce_min_sync
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x + 0.f);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

struct Ray {
  float ox, oy, oz, ix, iy, iz, tmin, tmax;
  float f[10];   // fp32 features
  float fh[10];  // their bf16 split (reduced tiers, one-level mode)
  float fl[10];
};

// two_phase broad-phase state of one ray: cull bound, the two candidate
// blocks of smallest loose t with a sound lower bound of their hits' t,
// and the least such bound over the blocks not kept (evicted)
struct Candidates {
  float cull, t1, t2, lo1, lo2, evicted;
  int b1, b2;
};

// Broad phase of one block for the lane's two triangles
// (pallas_trace.py:416-481): bf16x3 dots and the magnitude dots, error
// bounds from them, loose and strict accept sets; tL the least loose t,
// tS the least sound upper bound of a strict hit, and, beyond the TPU
// kernel, tLo a sound lower bound of the t of any hit the triangles can
// hold ((ts - e_t) / (ad + e_det) over the loose ones; -inf where that is
// not positive or the determinant's sign is unreliable). The warp then
// takes each one's least over its lanes.
__device__ __forceinline__ void lane_broad(const float out[8],
                                           const float mag[8], float tmin,
                                           float& tL, float& tS, float& tLo) {
  const float inf = __int_as_float(0x7f800000);
  tL = inf; tS = inf; tLo = inf;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float det = out[j];
    const float s = det >= 0.f ? 1.f : -1.f;
    const float ad = det * s, us = out[2 + j] * s, vs = out[4 + j] * s,
                ts = out[6 + j] * s;
    const float e_det = kTpK * mag[j], e_u = kTpK * mag[2 + j],
                e_v = kTpK * mag[4 + j], e_t = kTpK * mag[6 + j];
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

// A block's broad-phase result folded into the ray's candidates: its
// least loose t competes for the two slots (strict <, so a tie keeps the
// earlier block), a block that leaves or never enters them lowers
// `evicted` to its tLo, and its least strict bound tightens the cull bound.
__device__ __forceinline__ void fold_broad(float tL, float tS, float tLo,
                                           int tag, Candidates& cd) {
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

// One instantiation per mode. kAnyHit, kInst, kPrec and kCount as above;
// kWalk picks the walk, kProf an ablation mode of the classic and queued
// walks, and kPaired takes closest or any hit per thread from its ray
// index (K8's per-thread reference): rays below n_split are a closest-hit
// wave, the others an any-hit wave. n_split is a multiple of the block
// size, so no warp holds rays of both waves. Closest hit at a reduced
// tier (kSplit) always takes the warp-wide queued walk; fp32 closest hit,
// with or without the octant order, and fp32 any hit without it take it
// as kWarpQ (K1, K2, K3, K6, K7), over one tree level or two; the
// pipelined walk drains as kWarpPipe and kWarpFlat (K9). The kernels
// below wrap it.
#define WIDE_TRACE_PARAMS                                                 \
  const float* __restrict__ rays, int n_rays, int n_split,                \
      const float* __restrict__ nodes, const float* __restrict__ blocks,  \
      const unsigned* __restrict__ planes, const int* __restrict__ meta,  \
      const float* __restrict__ inst_feat, const int* __restrict__ worder, \
      int prefetch, float* __restrict__ t_out, int* __restrict__ sid_out, \
      float* __restrict__ u_out, float* __restrict__ v_out,               \
      int* __restrict__ inst_out, int* __restrict__ counts
#define WIDE_TRACE_ARGS                                                   \
  rays, n_rays, n_split, nodes, blocks, planes, meta, inst_feat, worder,  \
      prefetch, t_out, sid_out, u_out, v_out, inst_out, counts

template <bool kAnyHit, bool kInst, bool kCount, int kPrec, int kWalk,
          int kProf, bool kPaired>
__device__ __forceinline__ void wide_trace(WIDE_TRACE_PARAMS) {
  constexpr bool kSplit = kPrec != kHighest && !kAnyHit;
  constexpr bool kFp32Drain = fp32_drain(kWalk);
  constexpr bool kWarpPipes = kWalk == kWarpPipe || kWalk == kWarpFlat;
  static_assert(!kFp32Drain || (kPrec == kHighest && kProf == kProfNone &&
                                !kPaired),
                "the fp32 drains are fp32 closest hit and fp32 any hit");
  constexpr bool kWarpWide = kSplit || kFp32Drain;
  constexpr bool kQueue = kWalk == kQueued;
  constexpr bool kSteps = kCount || kProf == kProfCount;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool any_hit = kPaired ? i >= n_split : kAnyHit;
  // the warp-wide modes keep every lane of the warp: one past the wave
  // runs as a dead ray (tmax < tmin); the any-hit half of K8's
  // per-thread reference (kSplit with kPaired) walks one thread per ray
  const bool warp_wide = kWarpWide && (kFp32Drain || !any_hit);
  const bool in_wave = i < n_rays;
  if (!in_wave && !warp_wide) return;
  Ray r;
  float dx = 0.f, dy = 0.f, dz = 0.f;
  r.ox = r.oy = r.oz = 0.f;
  r.tmin = 0.f;
  r.tmax = -1.f;
  if (in_wave) {
    r.ox = rays[i];
    r.oy = rays[n_rays + i];
    r.oz = rays[2 * n_rays + i];
    dx = rays[3 * n_rays + i];
    dy = rays[4 * n_rays + i];
    dz = rays[5 * n_rays + i];
    r.tmin = rays[6 * n_rays + i];
    r.tmax = rays[7 * n_rays + i];
  }
  r.ix = guarded_inv(dx);
  r.iy = guarded_inv(dy);
  r.iz = guarded_inv(dz);
  ray_features(r.ox, r.oy, r.oz, dx, dy, dz, r.f);
  if (kSplit && !kInst) split_features(r.f, r.fh, r.fl);

  float best = r.tmax, bu = 0.f, bv = 0.f;
  int sid = -1, best_inst = 0;
  bool occluded = false;
  const float inf = __int_as_float(0x7f800000);
  Candidates cd{r.tmax, kTpNone, kTpNone, inf, inf, inf, -1, -1};
  // two_phase: the broad phase, then the exact fp32 refine (and, for rays
  // whose candidates may miss the winner, an exact walk); warp-uniform
  bool broad = kPrec == kTwoPhase;
  int n_pops = 0, n_tests = 0, n_xforms = 0, n_refine = 0;
  int n_rounds = 0, n_distinct = 0;   // warp-uniform (kCount)
  // instanced: object-space features of instance cur_inst (and their split)
  float fo[10], foh[10], fol[10];
  int cur_inst = -1;

  // the node-test bound: the running best (closest), tmax (any hit), or
  // the widened cull bound (two_phase broad phase)
  auto cull_now = [&]() -> float {
    if (any_hit) return r.tmax;
    if (kPrec == kTwoPhase && broad) return cd.cull * (1.0f + kTpRel) + kTpAbs;
    return best;
  };

  // test block b of instance inst, one thread (fp32; an any-hit ray sets
  // `occluded`)
  auto visit_block = [&](int inst, int b) {
    if (kProf == kProfNoMt) return;
    const float* f = r.f;
    if (kInst) {
      if (inst != cur_inst) {
        object_features(inst_feat, inst, r.f, fo);
        cur_inst = inst;
        if (kCount) ++n_xforms;
      }
      f = fo;
    }
    const float* blk = blocks + (size_t)b * kBlockFloats;
    if (kCount) ++n_tests;
    if (any_hit) {
      if (block_any<kHighest>(blk, f, nullptr, nullptr, r.tmin, r.tmax))
        occluded = true;
    } else if constexpr (!kSplit) {
      if (block_closest<kHighest>(blk, b, f, nullptr, nullptr, r.tmin, best,
                                  sid, bu, bv))
        best_inst = inst;
    }
  };

  // test the blocks of leaf `val` (returns early on an any-hit occlusion)
  auto visit_leaf = [&](int val) {
    const int nb = val & 31;
    const int b0 = kInst ? (val >> 5) & 0x3FFF : val >> 5;
    const int inst = kInst ? val >> 19 : 0;
    for (int j = 0; j < nb; ++j) {
      visit_block(inst, b0 + j);
      if (any_hit && occluded) return;
    }
  };

  // slab test of child c of a node against the bound `cull`; on a hit,
  // tnear is the entry distance
  auto slab = [&](const float4* rec, int c, float cull, float& tnear) -> bool {
    const float4 a = __ldg(rec + 2 * c);      // lo.xyz, hi.x
    const float4 b = __ldg(rec + 2 * c + 1);  // hi.yz, meta, pad
    const float t0x = (a.x - r.ox) * r.ix, t1x = (a.w - r.ox) * r.ix;
    const float t0y = (a.y - r.oy) * r.iy, t1y = (b.x - r.oy) * r.iy;
    const float t0z = (a.z - r.oz) * r.iz, t1z = (b.y - r.oz) * r.iz;
    tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tfar =
        fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    return tnear <= tfar && tfar >= r.tmin && tnear <= cull;
  };

  const int octant = (dx < 0.f) + 2 * (dy < 0.f) + 4 * (dz < 0.f);

  // Slab-test the 16 children of node n against the bound at the pop: push
  // the inner hits, queue the leaf hits (qv, qt) in the order found
  // (worder: the near-first order), prefetching their blocks if asked.
  auto expand = [&](int n, int* stack, int& sp, int* qv, float* qt,
                    int& q) {
    const float4* rec = reinterpret_cast<const float4*>(nodes) + n * 2 * kWidth;
    const int* mrow = meta + n * kWidth;
    int w0 = 0, w1 = 0;
    if (worder != nullptr) {
      w0 = __ldg(worder + (n * 8 + octant) * 2);
      w1 = __ldg(worder + (n * 8 + octant) * 2 + 1);
    }
    const float cull0 = cull_now();
    for (int j = 0; j < kWidth; ++j) {
      const int c =
          worder != nullptr ? ((j < 8 ? w0 : w1) >> (4 * (j & 7))) & 15 : j;
      const int mc = __ldg(mrow + c);
      if (mc == -1) continue;  // empty slot: bounds are placeholders
      float tnear;
      if (!slab(rec, c, cull0, tnear)) continue;
      if (mc >= 0) {
        stack[sp < kStack ? sp : kStack - 1] = mc;
        sp = sp < kStack ? sp + 1 : kStack;
        continue;
      }
      const int val = -mc - 2;
      qv[q] = val;
      qt[q] = tnear;
      ++q;
      // the any-hit drain prefetches nothing: an occluded lane skips the
      // rest of its queue, and the prefetch of blocks no lane reads cost
      // it a third of its time on the bistro shadow wave (PERF.md §6)
      if (prefetch && !(kAnyHit && kWalk == kWarpQ)) {
        const int b0 = kInst ? (val >> 5) & 0x3FFF : val >> 5;
        for (int k = 0; k < (val & 31); ++k) {
          if (kSplit && !any_hit)   // "default" reads the h plane alone
            prefetch_l2(planes + (size_t)(b0 + k) * kSplitWords,
                        kPrec == kDefault ? kBlockBytes / 2 : kBlockBytes);
          else
            prefetch_l2(blocks + (size_t)(b0 + k) * kBlockFloats,
                        kBlockBytes);
        }
      }
    }
  };

  // The per-thread classic and queued walks: K2's and K8's references,
  // the ablation modes, the any hit under the octant order and K7's
  // reference.
  auto walk = [&]() {
    int stack[kStack];
    int sp = 0;
    stack[sp++] = 0;
    for (int pops = 0;
         kProf == kProfFix64 ? pops < 64 : (sp > 0 && pops < kMaxPops);
         ++pops) {
      if (kProf == kProfFix64 && sp == 0) continue;
      const int n = stack[--sp];
      if (kSteps) ++n_pops;
      if (kQueue) {
        int qv[kWidth];
        float qt[kWidth];
        int q = 0;
        expand(n, stack, sp, qv, qt, q);
        for (int k = 0; k < q; ++k) {
          const int e = worder != nullptr ? q - 1 - k : k;
          if (!(qt[e] <= cull_now())) continue;
          visit_leaf(qv[e]);
          if (any_hit && occluded) break;
        }
      } else {
        const float4* rec =
            reinterpret_cast<const float4*>(nodes) + n * 2 * kWidth;
        const int* mrow = meta + n * kWidth;
        for (int c = 0; c < kWidth; ++c) {
          const int mc = __ldg(mrow + c);
          if (mc == -1) continue;  // empty slot: bounds are placeholders
          float tnear;
          if (!slab(rec, c, cull_now(), tnear)) continue;
          if (mc >= 0) {
            stack[sp < kStack ? sp : kStack - 1] = mc;
            sp = sp < kStack ? sp + 1 : kStack;
            continue;
          }
          visit_leaf(-mc - 2);
          if (any_hit && occluded) break;
        }
      }
      if (any_hit && occluded) {
        if (kProf != kProfFix64) break;
        sp = 0;
      }
    }
  };

  // The pipelined walk (K9). The leaf blocks a node's expansion finds go
  // to a backlog that outlives the node: every iteration pops at most one
  // node, held back while its leaves (at most kLeafQ blocks in a tree of
  // accel.wide; blocks beyond the backlog's room are tested at once)
  // might not fit the backlog, and then tests at most kPipeDrain blocks from the
  // backlog's top, so that the threads of a warp meet again after a
  // bounded amount of block work. Children are culled against `stale`,
  // the bound as it stood at the start of the iteration before (a best t
  // only falls, so a stale bound admits more nodes and loses no hit); a
  // backlog entry whose entry distance has fallen behind the running best
  // is dropped untested, and each block is tested against the running
  // best with K1's block code, so hit set and t are K1's. The flat push
  // (kPipeFlat, kWarpFlat) pushes the 16 children by predicated writes
  // with no inner loop (a write not taken lands in a dump slot past the
  // end), which needs single-block leaves.
  //
  // One pop: node n's children slab-tested against `stale`, the inner
  // hits pushed, each leaf hit's blocks appended to the backlog (lqv, lqt)
  // while it has room. What a leaf cannot place there (only a node whose
  // leaves hold more than kLeafQ blocks: no tree of accel.wide) is handed
  // on as its blocks k..nb-1 to `spill(tag, k, nb, tnear)`; once the
  // backlog is full every later leaf of the node goes there whole. The
  // per-thread walk tests them at once, the warp queues them; a true
  // return (an any-hit occlusion) ends the expansion.
  auto pipe_pop = [&](int n, float stale, int* stack, int& sp, int* lqv,
                      float* lqt, int& lq, auto&& spill) -> bool {
    const float4* rec = reinterpret_cast<const float4*>(nodes) + n * 2 * kWidth;
    const int* mrow = meta + n * kWidth;
    if (kWalk == kPipeFlat || kWalk == kWarpFlat) {
#pragma unroll
      for (int c = 0; c < kWidth; ++c) {
        const int mc = __ldg(mrow + c);
        float tnear;
        const bool take = slab(rec, c, stale, tnear) && mc != -1;
        const bool inner = take && mc >= 0;
        const bool leaf = take && mc <= -2;
        stack[inner ? (sp < kStack ? sp : kStack - 1) : kStack] = mc;
        sp += inner && sp < kStack;
        const int val = -mc - 2;
        const int tag = kInst ? (val >> 19) << 14 | ((val >> 5) & 0x3FFF)
                              : val >> 5;
        lqv[leaf ? lq : kPipeQ] = tag;
        lqt[leaf ? lq : kPipeQ] = tnear;
        lq += leaf;
      }
      return false;
    }
    for (int c = 0; c < kWidth; ++c) {
      const int mc = __ldg(mrow + c);
      if (mc == -1) continue;
      float tnear;
      if (!slab(rec, c, stale, tnear)) continue;
      if (mc >= 0) {
        stack[sp < kStack ? sp : kStack - 1] = mc;
        sp = sp < kStack ? sp + 1 : kStack;
        continue;
      }
      const int val = -mc - 2;
      const int tag = kInst ? (val >> 19) << 14 | ((val >> 5) & 0x3FFF)
                            : val >> 5;
      const int nb = val & 31;
      int k = 0;
      for (; k < nb && lq < kPipeQ; ++k) {
        lqv[lq] = tag + k;
        lqt[lq] = tnear;
        ++lq;
      }
      if (k < nb && spill(tag, k, nb, tnear)) return true;
    }
    return false;
  };

  // The per-thread pipelined walk: the reference the pipelined drain is
  // held to (kPipe, kPipeFlat; reached through kPerThread only)
  auto walk_pipe = [&]() {
    int stack[kStack + 1];
    int lqv[kPipeQ + 1];
    float lqt[kPipeQ + 1];
    int sp = 0, lq = 0;
    stack[sp++] = 0;
    float stale = cull_now();
    // what the backlog cannot take is tested now, so that no block is lost
    auto test_now = [&](int tag, int k, int nb, float tnear) -> bool {
      for (; k < nb; ++k) {
        if (!(tnear <= cull_now())) continue;
        visit_block(kInst ? tag >> 14 : 0, (kInst ? tag & 0x3FFF : tag) + k);
        if (any_hit && occluded) return true;
      }
      return false;
    };
    for (int it = 0; (sp > 0 || lq > 0) && it < kMaxPops; ++it) {
      const float snap = cull_now();
      if (sp > 0 && lq <= kPipeQ - kLeafQ) {
        const int n = stack[--sp];
        if (kCount) ++n_pops;
        if (pipe_pop(n, stale, stack, sp, lqv, lqt, lq, test_now)) return;
      }
      for (int k = 0; k < kPipeDrain && lq > 0; ++k) {
        --lq;
        if (!(lqt[lq] <= cull_now())) continue;
        const int tag = lqv[lq];
        visit_block(kInst ? tag >> 14 : 0, kInst ? tag & 0x3FFF : tag);
        if (any_hit && occluded) return;
      }
      stale = snap;
    }
  };

  // ---- the warp-wide modes (kSplit, and the fp32 drains) ------------
  // Every lambda below is entered by all 32 lanes together, and every
  // branch around a warp collective is warp-uniform: it depends only on
  // values broadcast from one lane or reduced over the warp. `exact`: the
  // block is tested over the fp32 blocks (the fp32 drains, and two_phase's
  // refine and re-walk, `refine`), not over the planes.

  // One block b (of instance inst) tested by the warp for lane L's ray,
  // whose features the lanes hold broadcast (of: the split h, or the fp32
  // features in the exact phase; ofl: the split l), against the bound ob
  // (L's best, which is its tmax in any hit; two_phase's broad phase: L's
  // raw cull bound), which it updates as L's own state is updated. Returns
  // true where the block ends L's walk (an any-hit occlusion).
  auto warp_block = [&](int L, int b, int inst, const float* of,
                        const float* ofl, float o_tmin, float& ob) -> bool {
    const bool refine = kPrec == kTwoPhase && !broad;
    const bool exact = kPrec == kHighest || refine;
    float out[8], mag[8];
    if (exact)
      lane_dots(blocks + (size_t)b * kBlockFloats, lane, of, out);
    else
      lane_dots_split<kPrec>(planes + (size_t)b * kSplitWords, lane, of, ofl,
                             out, mag);
    if (kCount && lane == L) {
      if (refine) ++n_refine; else ++n_tests;
    }
    if constexpr (kAnyHit) {
      if (!__any_sync(kFull, lane_any(out, o_tmin, ob))) return false;
      if (lane == L) occluded = true;
      return true;
    }
    if (kPrec == kTwoPhase && !exact) {
      float tL, tS, tLo;
      lane_broad(out, mag, o_tmin, tL, tS, tLo);
      tL = key_value(__reduce_min_sync(kFull, order_key(tL)));
      tS = key_value(__reduce_min_sync(kFull, order_key(tS)));
      tLo = key_value(__reduce_min_sync(kFull, order_key(tLo)));
      if (lane == L) fold_broad(tL, tS, tLo, kInst ? (inst << 14 | b) : b, cd);
      if (tS < 3e37f && tS + kTpAbs < ob) ob = tS + kTpAbs;
      return false;
    }
    float tl, us, vs, ad;
    int sl;
    lane_closest(out, lane, o_tmin, ob, tl, sl, us, vs, ad);
    const unsigned key = order_key(tl);
    const unsigned least = __reduce_min_sync(kFull, key);
    if (least == order_key(inf)) return false;   // nothing accepted
    // the least t, ties to the lowest slot: the lowest lane holding it
    const int w = __ffs(__ballot_sync(kFull, key == least)) - 1;
    const float tb = __shfl_sync(kFull, tl, w);
    const int slot = __shfl_sync(kFull, sl, w);
    if (!(tb < ob)) return false;
    float ub = 0.f, vb = 0.f;
    if (lane == w) {
      const float iad = 1.0f / fmaxf(ad, 1e-37f);
      ub = us * iad;
      vb = vs * iad;
    }
    ub = __shfl_sync(kFull, ub, w);
    vb = __shfl_sync(kFull, vb, w);
    ob = tb;
    if (lane == L) {
      best = tb;
      sid = b * kBlockTris + slot;
      bu = ub;
      bv = vb;
      best_inst = inst;
    }
    return false;
  };

  // lane L's ray broadcast and its (world-space) fp32 features formed as
  // lane L formed them: six shuffles (the fp32 drains: no lane holds r.f
  // across the walk)
  auto broadcast_ray = [&](int L, float* of) {
    ray_features(__shfl_sync(kFull, r.ox, L), __shfl_sync(kFull, r.oy, L),
                 __shfl_sync(kFull, r.oz, L), __shfl_sync(kFull, dx, L),
                 __shfl_sync(kFull, dy, L), __shfl_sync(kFull, dz, L), of);
  };

  // lane L's current features, broadcast (split, or fp32 in the exact
  // phase; the instance's object features in the two-level mode)
  auto broadcast_features = [&](int L, float* of, float* ofl) {
    if (kFp32Drain) {   // K1, K6, K7, K9
      broadcast_ray(L, of);
      return;
    }
    const bool exact = kPrec == kHighest || (kPrec == kTwoPhase && !broad);
    const float* h = exact ? (kInst ? fo : r.f) : (kInst ? foh : r.fh);
    const float* l = kInst ? fol : r.fl;
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      of[k] = __shfl_sync(kFull, h[k], L);
      if (!exact && kPrec != kDefault) ofl[k] = __shfl_sync(kFull, l[k], L);
    }
  };

  // The fp32 drains over two levels: lane L's ray enters instance inst's
  // object space, its object features of = T F broadcast. Lane k < 10
  // forms row k from the broadcast world features with object_features'
  // fmaf chain (the same bits), and the ten rows are broadcast: ten FMAs
  // and ten loads a lane where one thread did a hundred of each while the
  // warp waited.
  auto warp_object_features = [&](int L, int inst, float* of) {
    float wf[10];
    broadcast_ray(L, wf);
    float row = 0.f;
    if (lane < 10) {
      const float* tm = inst_feat + ((size_t)inst * 10 + lane) * 128;
#pragma unroll
      for (int j = 0; j < 10; ++j) row = fmaf(__ldg(tm + j), wf[j], row);
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) of[k] = __shfl_sync(kFull, row, k);
    if (kCount && lane == L) ++n_xforms;
  };

  // lane L (only) enters instance inst's object space (the reduced tiers
  // and two_phase's exact phases)
  auto enter_instance = [&](int L, int inst) {
    if (lane != L || inst == cur_inst) return;
    object_features(inst_feat, inst, r.f, fo);
    if (!(kPrec == kTwoPhase && !broad)) split_features(fo, foh, fol);
    cur_inst = inst;
    if (kCount) ++n_xforms;
  };

  // whether this lane tested block b in the current drain round (kCount:
  // the distinct blocks of a round)
  auto tested_block = [&](int b, const int* qv, int q, unsigned tested) {
    for (int e = 0; e < q; ++e) {
      if (!((tested >> e) & 1u)) continue;
      const int b0 = kInst ? (qv[e] >> 5) & 0x3FFF : qv[e] >> 5;
      if (b >= b0 && b < b0 + (qv[e] & 31)) return true;
    }
    return false;
  };

  // Drain every lane's queue (q entries qv, qt), lane after lane, each in
  // its own queue order (newest first under the octant order); an entry
  // whose distance exceeds the drained lane's bound is skipped, and an
  // occluded lane's remaining entries too (any hit). With `each_block`
  // the distance is checked again before each block of an entry (the
  // pipelined walk culls block by block).
  auto drain = [&](const int* qv, const float* qt, int q, bool each_block) {
    const bool refine = kPrec == kTwoPhase && !broad;
    const bool wide_cull = kPrec == kTwoPhase && broad;
    unsigned tested = 0;
    int round_tests = 0, round_distinct = 0;
    for (unsigned pend = __ballot_sync(kFull, q > 0); pend;
         pend &= pend - 1) {
      const int L = __ffs(pend) - 1;
      const int nq = __shfl_sync(kFull, q, L);
      const float o_tmin = __shfl_sync(kFull, r.tmin, L);
      float ob = __shfl_sync(kFull, wide_cull ? cd.cull : best, L);
      float of[10], ofl[10];
      int o_inst = -1;
      if (!kInst) broadcast_features(L, of, ofl);
      bool done = false;
      for (int e = 0; e < nq && !done; ++e) {
        const int ee = worder != nullptr ? nq - 1 - e : e;
        const int val = __shfl_sync(kFull, ee < q ? qv[ee] : 0, L);
        const float tn = __shfl_sync(kFull, ee < q ? qt[ee] : 0.f, L);
        const float bound = wide_cull ? ob * (1.0f + kTpRel) + kTpAbs : ob;
        if (!(tn <= bound)) continue;
        if (kCount && lane == L) tested |= 1u << ee;
        const int nb = val & 31;
        const int b0 = kInst ? (val >> 5) & 0x3FFF : val >> 5;
        const int inst = kInst ? val >> 19 : 0;
        if (kInst && inst != o_inst) {
          if (kFp32Drain) {
            warp_object_features(L, inst, of);
          } else {
            enter_instance(L, inst);
            broadcast_features(L, of, ofl);
          }
          o_inst = inst;
        }
        for (int j = 0; j < nb && !done; ++j) {
          if (each_block && !(tn <= ob)) break;
          if (kCount && !refine) {
            const bool seen = __any_sync(
                kFull, lane < L && tested_block(b0 + j, qv, q, tested));
            round_distinct += !seen;
            ++round_tests;
          }
          done = warp_block(L, b0 + j, inst, of, ofl, o_tmin, ob);
        }
      }
    }
    if (kCount && round_tests > 0) {
      ++n_rounds;
      n_distinct += round_distinct;
    }
  };

  // The warp-wide walk: each lane with a ray to walk (`start`) pops one
  // node and queues its leaves, then the warp drains the queues, until no
  // lane has a node left.
  auto warp_walk = [&](bool start) {
    int stack[kStack];
    int sp = 0, pops = 0;
    if (start) stack[sp++] = 0;
    while (__any_sync(kFull, sp > 0 && pops < kMaxPops)) {
      int qv[kWidth];
      float qt[kWidth];
      int q = 0;
      if (sp > 0 && pops < kMaxPops) {
        const int n = stack[--sp];
        ++pops;
        if (kSteps) ++n_pops;
        expand(n, stack, sp, qv, qt, q);
      }
      drain(qv, qt, q, false);
      if (kAnyHit && occluded) sp = 0;
    }
  };

  // The pipelined drain (K9): each lane keeps the per-thread pipe's
  // schedule, its own stack and backlog, and every iteration the lanes
  // with work pop at most one node each, while their backlogs have kLeafQ
  // room, and expand it (pipe_pop, the flat push included); the warp then
  // tests what an overfull node spilled (`drain` with each block culled:
  // the per-thread walk tests those blocks at once, in the same order,
  // before its drain) and drains up to kPipeDrain entries from the top of
  // each lane's backlog, lane after lane (pipe_drain). Each lane sees the
  // per-thread walk's sequence of pops, culls and block tests, so every
  // output and its pops and MT block tests are that walk's; only instance
  // entries (once per drained lane, instance and round) rise. An occluded
  // any-hit lane's backlog and stack are dropped; done lanes stay in every
  // collective with nothing to drain.
  auto pipe_drain = [&](const int* lqv, const float* lqt, int& lq,
                        bool active) {
    int round_tests = 0, round_distinct = 0;
    int mine[kPipeDrain];   // kCount: the blocks this lane tested this round
    int n_mine = 0;
    for (unsigned pend = __ballot_sync(kFull, active && lq > 0); pend;
         pend &= pend - 1) {
      const int L = __ffs(pend) - 1;
      const int nl = __shfl_sync(kFull, lq, L);
      const int take = nl < kPipeDrain ? nl : kPipeDrain;
      const float o_tmin = __shfl_sync(kFull, r.tmin, L);
      float ob = __shfl_sync(kFull, best, L);   // any hit: its tmax
      float of[10];
      int o_inst = -1;
      if (!kInst) broadcast_ray(L, of);
      bool done = false;
      // a skipped stale entry is one of the lane's kPipeDrain, as in
      // walk_pipe
      for (int k = 0; k < take && !done; ++k) {
        const int e = nl - 1 - k;
        const int tag = __shfl_sync(kFull, lane == L ? lqv[e] : 0, L);
        const float tn = __shfl_sync(kFull, lane == L ? lqt[e] : 0.f, L);
        if (!(tn <= ob)) continue;
        const int b = kInst ? tag & 0x3FFF : tag;
        const int inst = kInst ? tag >> 14 : 0;
        if (kInst && inst != o_inst) {
          warp_object_features(L, inst, of);
          o_inst = inst;
        }
        if (kCount) {
          bool had = false;
          for (int m = 0; m < n_mine; ++m) had |= mine[m] == b;
          round_distinct += !__any_sync(kFull, lane < L && had);
          ++round_tests;
          if (lane == L) mine[n_mine++] = b;
        }
        done = warp_block(L, b, inst, of, nullptr, o_tmin, ob);
      }
      if (lane == L) lq = done ? 0 : nl - take;
    }
    if (kCount && round_tests > 0) {
      ++n_rounds;
      n_distinct += round_distinct;
    }
  };

  auto warp_pipe = [&](bool start) {
    int stack[kStack + 1];
    int lqv[kPipeQ + 1];
    float lqt[kPipeQ + 1];
    int sp = 0, lq = 0, it = 0;
    if (start) stack[sp++] = 0;
    float stale = cull_now();
    for (;;) {
      const bool active = (sp > 0 || lq > 0) && it < kMaxPops;
      if (!__any_sync(kFull, active)) break;
      const float snap = cull_now();
      // what an overfull node's leaves could not place in the backlog, as
      // leaf entries (inst << 19 | block << 5 | n) in the order found
      int ov[kWidth];
      float ot[kWidth];
      int no = 0;
      if (active && sp > 0 && lq <= kPipeQ - kLeafQ) {
        const int n = stack[--sp];
        if (kCount) ++n_pops;
        pipe_pop(n, stale, stack, sp, lqv, lqt, lq,
                 [&](int tag, int k, int nb, float tnear) -> bool {
                   const int b = (kInst ? tag & 0x3FFF : tag) + k;
                   ov[no] = (kInst ? (tag >> 14) << 19 : 0) | b << 5 |
                            (nb - k);
                   ot[no] = tnear;
                   ++no;
                   return false;
                 });
      }
      drain(ov, ot, no, true);
      if (kAnyHit && occluded) sp = lq = 0;
      pipe_drain(lqv, lqt, lq, active);
      if (kAnyHit && occluded) sp = 0;
      if (active) {
        ++it;
        stale = snap;
      }
    }
  };

  // two_phase's refine, warp-wide: each lane's distinct candidates in
  // ascending (instance, block) order, exact fp32, from best = tmax
  auto warp_refine = [&](bool has_ray) {
    const int lo = cd.b1 < cd.b2 ? cd.b1 : cd.b2;
    const int hi = cd.b1 < cd.b2 ? cd.b2 : cd.b1;
    const int c0 = has_ray ? lo : -1;
    const int c1 = has_ray && hi != lo ? hi : -1;
    for (unsigned pend = __ballot_sync(kFull, c0 >= 0 || c1 >= 0); pend;
         pend &= pend - 1) {
      const int L = __ffs(pend) - 1;
      const float o_tmin = __shfl_sync(kFull, r.tmin, L);
      float ob = __shfl_sync(kFull, best, L);
      float of[10], ofl[10];
      if (!kInst) broadcast_features(L, of, ofl);
      for (int k = 0; k < 2; ++k) {
        const int tag = __shfl_sync(kFull, k == 0 ? c0 : c1, L);
        if (tag < 0) continue;
        const int b = kInst ? tag & 0x3FFF : tag;
        const int inst = kInst ? tag >> 14 : 0;
        if (kInst) {
          if (lane == L) {
            object_features(inst_feat, inst, r.f, fo);
            cur_inst = inst;
            if (kCount) ++n_xforms;
          }
          broadcast_features(L, of, ofl);
        }
        warp_block(L, b, inst, of, ofl, o_tmin, ob);
      }
    }
  };

  // A ray with tmax <= tmin (dead lanes carry tmax = tmin - 1) can accept
  // no triangle: skip the walk.
  const bool live = kProf != kProfEmpty && r.tmax > r.tmin;
  bool fell_back = false;
  if (warp_wide) {
    if constexpr (kWarpPipes) {
      warp_pipe(live);
    } else if constexpr (kWarpWide) {
      warp_walk(live);
      if (kPrec == kTwoPhase) {
        if (live) {
          best = r.tmax;
          sid = -1;
          bu = bv = 0.f;
          best_inst = 0;
        }
        broad = false;
        warp_refine(live);
        // A block that left (or never entered) the two slots holds no hit
        // nearer than its lower bound; if that bound falls below the
        // refined best, the winner may be among them (loose phantoms near
        // tmin crowd the slots on rays that leave a surface): walk again
        // with K1's exact blocks, from tmax.
        fell_back = live && cd.evicted < best;
        if (fell_back) {
          best = r.tmax;
          sid = -1;
          bu = bv = 0.f;
          best_inst = 0;
        }
        warp_walk(fell_back);
      }
    }
  } else if (live) {
    if constexpr (kWalk == kPipe || kWalk == kPipeFlat) walk_pipe();
    else walk();
  }

  if (!in_wave) return;
  t_out[i] = any_hit ? r.tmax : best;
  sid_out[i] = any_hit ? (occluded ? 1 : -1) : sid;
  u_out[i] = kProf == kProfCount ? static_cast<float>(n_pops) : bu;
  v_out[i] = bv;
  if (kInst && !kAnyHit) inst_out[i] = best_inst;
  if (kCount) {
    counts[i] = n_pops;
    counts[n_rays + i] = n_tests;
    counts[2 * n_rays + i] = n_xforms;
    counts[3 * n_rays + i] = n_refine;
    counts[4 * n_rays + i] = fell_back;
    counts[5 * n_rays + i] = lane == 0 ? n_rounds : 0;
    counts[6 * n_rays + i] = lane == 0 ? n_distinct : 0;
  }
}

template <bool kAnyHit, bool kInst, bool kCount, int kPrec, int kWalk,
          int kProf, bool kPaired>
__global__ void __launch_bounds__(kThreads)
wide_trace_kernel(WIDE_TRACE_PARAMS) {
  wide_trace<kAnyHit, kInst, kCount, kPrec, kWalk, kProf, kPaired>(
      WIDE_TRACE_ARGS);
}

// The render instantiations of the fp32 drains: kWarpQ's K1, K6 and K7
// closest (kInst false), K3 closest, also streamed and octant-ordered
// (kInst), K2 and K6 any hit (kAnyHit), and the instanced any hit, also
// streamed (both); kWarpPipe and kWarpFlat's K9 in the same four modes.
// Left to its default, ptxas fits K1's in 64 registers and spills; asking
// for 6 blocks of 128 threads an SM lets each take up to 85, and each
// keeps 80 without spills. 7 (K3) and 8 (K6 any) blocks fit in 72 and 64
// registers without spills too, and ran slower on the card. The other
// instantiations keep the default: a minimum of blocks makes ptxas take
// as many registers as the limit allows.
template <bool kAnyHit, bool kInst, int kWalk>
__global__ void __launch_bounds__(kThreads, 6)
wide_trace_warp_kernel(WIDE_TRACE_PARAMS) {
  wide_trace<kAnyHit, kInst, false, kHighest, kWalk, kProfNone, false>(
      WIDE_TRACE_ARGS);
}

// K8, the paired launch, on the drains of the unpaired modes. n_split is a
// multiple of the 128-thread CTA, so each CTA's 128 rays lie in one wave:
// a closest-hit CTA runs exactly the unpaired closest-hit mode's code for
// its rays (K1's fp32 drain, which prefetches when the launch streams as
// K6 closest does; K4's drain over the pre-split planes; K5's broad phase,
// refine and exact re-walk), an any-hit CTA K2's any-hit drain (which
// prefetches nothing, as K6 any hit). Any-hit ray j sits at index
// n_split + j, so every warp holds the rays the unpaired launch's warp
// holds, lanes past the wave included: outputs, counts and each warp's
// drain rounds are the unpaired modes', bit for bit. The CTAs keep the
// layout order, closest-hit tiles first; an order that interleaved the
// two halves' tiles (the JAX kernel's mix, pallas_trace.py:1545-1550) was
// within 1% of it on the H100 where the closest-hit wave is coherent
// (camera rays) and 3-23% slower on every other pair timed (PERF.md §6).
template <int kPrec, bool kCount>
__device__ __forceinline__ void wide_trace_paired(WIDE_TRACE_PARAMS) {
  if (static_cast<int>(blockIdx.x) * kThreads >= n_split)
    wide_trace<true, false, kCount, kHighest, kWarpQ, kProfNone, false>(
        WIDE_TRACE_ARGS);
  else
    wide_trace<false, false, kCount, kPrec,
               kPrec == kHighest ? kWarpQ : kQueued, kProfNone, false>(
        WIDE_TRACE_ARGS);
}

// Blocks of 128 threads an SM each paired kernel asks ptxas to fit. Left
// to its default, ptxas gives the union of the two halves' code fewer
// registers than either unpaired kernel takes, and spills (72 registers
// and 28 B of spill stores at "high" and "default"); so each asks for
// about its unpaired closest-hit kernel's occupancy: fp32 6 (K1's and
// K2's drains keep 80 registers), "high" 5 (K4's 95), "default" 6,
// two_phase and the counting instantiation 4 (128 registers).
__host__ __device__ constexpr int paired_min_blocks(int prec, bool count) {
  return count || prec == kTwoPhase ? 4 : prec == kHigh ? 5 : 6;
}

template <int kPrec, bool kCount>
__global__ void __launch_bounds__(kThreads, paired_min_blocks(kPrec, kCount))
wide_trace_paired_kernel(WIDE_TRACE_PARAMS) {
  wide_trace_paired<kPrec, kCount>(WIDE_TRACE_ARGS);
}

// The pre-split planes of the coefficient blocks: h = bf16(c) and
// l = bf16(c - h), round to nearest even, one thread per coefficient, as
// (B, 2, 10, 256) bf16 (the TPU kernel splits the coefficients inside
// `mt_dot` at every block visit, pallas_trace.py:194-197; the split
// depends only on the scene, so it is done once per tracer). Bound by
// bytes: 4 read and 4 written per coefficient.
__global__ void __launch_bounds__(256)
split_planes_kernel(const float* __restrict__ blocks, int n_blocks,
                    unsigned short* __restrict__ planes) {
  const size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (size_t)n_blocks * kBlockFloats) return;
  const size_t b = c / kBlockFloats, k = c % kBlockFloats;
  const float x = blocks[c];
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  const __nv_bfloat16 l = __float2bfloat16_rn(x - __bfloat162float(h));
  planes[b * 2 * kBlockFloats + k] = __bfloat16_as_ushort(h);
  planes[b * 2 * kBlockFloats + kBlockFloats + k] = __bfloat16_as_ushort(l);
}

struct Launch {
  dim3 grid;
  cudaStream_t stream;
  const float* rays;
  int n_rays;
  int n_split;
  const float* nodes;
  const float* blocks;
  const unsigned* planes;
  const int* meta;
  const float* inst_feat;
  const int* worder;
  int prefetch;
  bool per_thread;   // the per-thread reference of the mode (kPerThread)
  float* t_out;
  int* sid_out;
  float* u_out;
  float* v_out;
  int* inst_out;
  int* counts;
};

template <bool kAnyHit, bool kInst, bool kCount, int kPrec, int kWalk,
          int kProf = kProfNone, bool kPaired = false>
void launch(const Launch& l) {
  if constexpr (fp32_drain(kWalk) && !kCount)
    wide_trace_warp_kernel<kAnyHit, kInst, kWalk>
        <<<l.grid, kThreads, 0, l.stream>>>(
        l.rays, l.n_rays, l.n_split, l.nodes, l.blocks, l.planes, l.meta,
        l.inst_feat, l.worder, l.prefetch, l.t_out, l.sid_out, l.u_out,
        l.v_out, l.inst_out, l.counts);
  else
    wide_trace_kernel<kAnyHit, kInst, kCount, kPrec, kWalk, kProf, kPaired>
        <<<l.grid, kThreads, 0, l.stream>>>(
            l.rays, l.n_rays, l.n_split, l.nodes, l.blocks, l.planes, l.meta,
            l.inst_feat, l.worder, l.prefetch, l.t_out, l.sid_out, l.u_out,
            l.v_out, l.inst_out, l.counts);
}

// K8 on the drains
template <int kPrec, bool kCount>
void launch_paired(const Launch& l) {
  wide_trace_paired_kernel<kPrec, kCount><<<l.grid, kThreads, 0, l.stream>>>(
      l.rays, l.n_rays, l.n_split, l.nodes, l.blocks, l.planes, l.meta,
      l.inst_feat, l.worder, l.prefetch, l.t_out, l.sid_out, l.u_out, l.v_out,
      l.inst_out, l.counts);
}

constexpr int kBadMode = static_cast<int>(cudaErrorInvalidValue);

// K1-K7: the classic or queued walk at a tier; closest hit at a reduced
// tier always takes the warp-wide queued walk (one instantiation), and so
// do fp32 closest hit, with or without the octant order, and fp32 any hit
// without it, over one tree level or two (K1, K2, K3, K6, K7; the prefetch
// flag tells the streamed closest hit apart). The per-thread queued walk
// stays for the any hit under the octant order (the packet tracer never
// asks it) and, with `per_thread`, as K7's reference.
template <bool kAnyHit, bool kInst, bool kCount, int kWalk>
int by_precision(int prec, const Launch& l) {
  if constexpr (kAnyHit) {
    // any hit is exact fp32 under every tier (pallas_trace.py:390); the
    // classic walk never has an octant order, so it always drains
    if (kWalk == kClassic || l.worder == nullptr)
      launch<true, kInst, kCount, kHighest, kWarpQ>(l);
    else if constexpr (kWalk == kQueued)
      launch<true, kInst, kCount, kHighest, kQueued>(l);
  } else {
    switch (prec) {
      case kHighest:
        if (l.per_thread)
          launch<false, kInst, kCount, kHighest, kQueued>(l);
        else launch<false, kInst, kCount, kHighest, kWarpQ>(l);
        break;
      case kHigh: launch<false, kInst, kCount, kHigh, kQueued>(l); break;
      case kDefault: launch<false, kInst, kCount, kDefault, kQueued>(l); break;
      case kTwoPhase:
        launch<false, kInst, kCount, kTwoPhase, kQueued>(l);
        break;
      default: return kBadMode;
    }
  }
  return 0;
}

template <bool kAnyHit, bool kInst, bool kCount>
int by_walk(int prec, bool queue, const Launch& l) {
  return queue ? by_precision<kAnyHit, kInst, kCount, kQueued>(prec, l)
               : by_precision<kAnyHit, kInst, kCount, kClassic>(prec, l);
}

template <bool kCount>
int by_mode(int any_hit, int prec, bool queue, const Launch& l) {
  const bool inst = l.inst_feat != nullptr;
  if (any_hit && inst) return by_walk<true, true, kCount>(prec, queue, l);
  if (any_hit) return by_walk<true, false, kCount>(prec, queue, l);
  if (inst) return by_walk<false, true, kCount>(prec, queue, l);
  return by_walk<false, false, kCount>(prec, queue, l);
}

// K8: one launch over a closest-hit and an any-hit wave, one tree level,
// the closest half at any tier, resident or streamed (not two_phase); the
// counting instantiation exists at the fp32 tier. Each CTA runs the drain
// of the unpaired mode of its half (wide_trace_paired_kernel), one
// instantiation per tier: the streamed closest hit differs from the
// resident one by the prefetch flag alone, and any hit ignores it.
template <bool kCount>
int paired(int prec, const Launch& l) {
  switch (prec) {
    case kHighest:
      launch_paired<kHighest, kCount>(l);
      return 0;
    case kHigh:
    case kDefault:
    case kTwoPhase:
      if constexpr (!kCount) {
        if (prec == kHigh) launch_paired<kHigh, false>(l);
        else if (prec == kDefault) launch_paired<kDefault, false>(l);
        else launch_paired<kTwoPhase, false>(l);
        return 0;
      }
      return kBadMode;
  }
  return kBadMode;
}

// K8's per-thread reference (kPerThread): the kernel before the drains,
// one thread per ray, each taking its mode from its ray index; the any-hit
// half (and the fp32 closest half) on the classic or, streamed, the queued
// walk
template <bool kCount, int kWalk>
int paired_per_thread(int prec, const Launch& l) {
  switch (prec) {
    case kHighest:
      launch<false, false, kCount, kHighest, kWalk, kProfNone, true>(l);
      return 0;
    case kHigh:
      if constexpr (!kCount) {
        launch<false, false, false, kHigh, kWalk, kProfNone, true>(l);
        return 0;
      }
      return kBadMode;
    case kDefault:
      if constexpr (!kCount) {
        launch<false, false, false, kDefault, kWalk, kProfNone, true>(l);
        return 0;
      }
      return kBadMode;
    case kTwoPhase:
      if constexpr (!kCount && kWalk == kClassic) {
        launch<false, false, false, kTwoPhase, kClassic, kProfNone, true>(l);
        return 0;
      }
      return kBadMode;
  }
  return kBadMode;
}

// K9: the pipelined walk, fp32, with or without the flat push: the
// pipelined drain (kWarpPipe, kWarpFlat), or its per-thread reference
// (kPipe, kPipeFlat)
template <bool kCount, int kWalk>
int piped(int any_hit, const Launch& l) {
  const bool inst = l.inst_feat != nullptr;
  if (any_hit && inst) launch<true, true, kCount, kHighest, kWalk>(l);
  else if (any_hit) launch<true, false, kCount, kHighest, kWalk>(l);
  else if (inst) launch<false, true, kCount, kHighest, kWalk>(l);
  else launch<false, false, kCount, kHighest, kWalk>(l);
  return 0;
}

// The ablation modes of the per-thread walk, classic (and queued, for
// "empty" and "nomt"): one tree level, fp32. "nomt" and "fix64" have
// counting instantiations.
template <bool kAnyHit, bool kCount, int kWalk>
int profiled(int prof, const Launch& l) {
  switch (prof) {
    case kProfNoMt:
      launch<kAnyHit, false, kCount, kHighest, kWalk, kProfNoMt>(l);
      return 0;
    case kProfEmpty:
      if constexpr (!kCount) {
        launch<kAnyHit, false, false, kHighest, kWalk, kProfEmpty>(l);
        return 0;
      }
      return kBadMode;
    case kProfFix64:
      if constexpr (kWalk == kClassic) {
        launch<kAnyHit, false, kCount, kHighest, kClassic, kProfFix64>(l);
        return 0;
      }
      return kBadMode;
    case kProfCount:
      if constexpr (!kCount && kWalk == kClassic) {
        launch<kAnyHit, false, false, kHighest, kClassic, kProfCount>(l);
        return 0;
      }
      return kBadMode;
  }
  return kBadMode;
}

template <bool kCount>
int dispatch(int any_hit, int prec, int stream, int walk, int prof,
             const Launch& l) {
  const bool inst = l.inst_feat != nullptr;
  const bool queue = l.worder != nullptr || stream != 0;
  if (any_hit == 2) {
    if (inst || l.worder != nullptr || walk != 0 || prof != kProfNone)
      return kBadMode;
    if (!l.per_thread) return paired<kCount>(prec, l);
    return stream ? paired_per_thread<kCount, kQueued>(prec, l)
                  : paired_per_thread<kCount, kClassic>(prec, l);
  }
  if (walk != 0) {
    if (queue || prof != kProfNone || (!any_hit && prec != kHighest))
      return kBadMode;
    if (l.per_thread)
      return walk == 2 ? piped<kCount, kPipeFlat>(any_hit, l)
                       : piped<kCount, kPipe>(any_hit, l);
    return walk == 2 ? piped<kCount, kWarpFlat>(any_hit, l)
                     : piped<kCount, kWarpPipe>(any_hit, l);
  }
  // the per-thread references of the default walk: K2's and K6 any
  // hit's, the classic any-hit walk over one level without the octant
  // order (streamed or not); K7's, fp32 closest hit under the octant order
  if (l.per_thread && any_hit) {
    if (inst || l.worder != nullptr || prof != kProfNone) return kBadMode;
    launch<true, false, kCount, kHighest, kClassic>(l);
    return 0;
  }
  if (l.per_thread && (l.worder == nullptr || prec != kHighest))
    return kBadMode;
  if (prof != kProfNone) {
    if (inst || l.worder != nullptr || (!any_hit && prec != kHighest))
      return kBadMode;
    if (any_hit)
      return queue ? profiled<true, kCount, kQueued>(prof, l)
                   : profiled<true, kCount, kClassic>(prof, l);
    return queue ? profiled<false, kCount, kQueued>(prof, l)
                 : profiled<false, kCount, kClassic>(prof, l);
  }
  return by_mode<kCount>(any_hit, prec, queue, l);
}

}  // namespace

extern "C" {

// Launches one traversal wave on `stream` and returns cudaGetLastError()
// (0 on success; cudaErrorInvalidValue for a mode that does not exist).
// rays: (8, n_rays) f32 rows [ox, oy, oz, dx, dy, dz, tmin, tmax]; outputs
// (n_rays,) each. any_hit: 0 closest, 1 any hit, 2 paired (K8): rays below
// n_split, a multiple of 128, are a closest-hit wave and the others an
// any-hit wave, over one tree level, resident or streamed, each CTA on
// its half's drain. inst_feat non-null selects the two-level mode, which
// also writes inst_out in closest-hit mode. mt_prec: 0 highest, 1 high,
// 2 default, 3 two_phase (closest hit only); closest hit at a tier below
// highest reads the blocks' pre-split planes `planes`
// (wide_trace_split_planes), which must then be given. worder non-null
// selects the near-first octant order; stream != 0 queues and prefetches
// the leaf blocks. walk: 0 the classic or queued walk, 1 the pipelined
// walk (K9), 2 the same with the flat push (single-block leaves only);
// both fp32, without stream or octant order; plus 4 (kPerThread), the
// mode's per-thread reference, never on a render path: with 1 or 2 the
// per-thread pipelined walk, with 0 the per-thread queued walk of fp32
// closest hit under the octant order (worder given), the per-thread
// classic walk of one-level any hit without it, or the per-thread paired
// kernel. profile: 0 none, 1 empty, 2 nomt, 3 fix64, 4 count, on the
// one-level fp32 walk (empty and nomt also with stream).
// counts non-null selects the counting instantiation: (7, n_rays) i32 rows
// of node pops, MT block tests, instance entries, fp32 refine / re-walk
// block tests, re-walks, and on lane 0 of each warp its warp-wide drain
// rounds that tested a block and the distinct blocks of those rounds.
// Allocates nothing and does not synchronise.
int wide_trace_launch(const float* rays, int n_rays, int n_split,
                      const float* nodes, const float* blocks,
                      const void* planes, const int* meta,
                      const float* inst_feat,
                      const int* worder, int any_hit, int mt_prec,
                      int stream, int walk, int profile, float* t_out,
                      int* sid_out, float* u_out, float* v_out,
                      int* inst_out, int* counts, void* cuda_stream) {
  if (mt_prec < kHighest || mt_prec > kTwoPhase ||
      (mt_prec == kTwoPhase && stream) || any_hit < 0 || any_hit > 2 ||
      walk < 0 || (walk & ~kPerThread) > 2 || profile < kProfNone ||
      profile > kProfCount ||
      (any_hit == 2 && (n_split < 0 || n_split > n_rays ||
                        n_split % kThreads != 0)) ||
      (any_hit != 1 && mt_prec != kHighest && planes == nullptr))
    return kBadMode;
  const Launch l{dim3((n_rays + kThreads - 1) / kThreads),
                 static_cast<cudaStream_t>(cuda_stream), rays, n_rays,
                 n_split, nodes, blocks,
                 static_cast<const unsigned*>(planes), meta, inst_feat,
                 worder, stream, (walk & kPerThread) != 0,
                 t_out, sid_out, u_out, v_out, inst_out, counts};
  walk &= ~kPerThread;
  const int rc = counts != nullptr
                     ? dispatch<true>(any_hit, mt_prec, stream, walk, profile, l)
                     : dispatch<false>(any_hit, mt_prec, stream, walk, profile, l);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Writes the (n_blocks, 2, 10, 256) bf16 pre-split planes of the
// (n_blocks, 10, 256) f32 blocks on `stream`; returns cudaGetLastError().
int wide_trace_split_planes(const float* blocks, int n_blocks, void* planes,
                            void* cuda_stream) {
  const size_t n = (size_t)n_blocks * kBlockFloats;
  if (n_blocks < 0) return kBadMode;
  if (n == 0) return 0;
  const dim3 grid((unsigned)((n + 255) / 256));
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  split_planes_kernel<<<grid, 256, 0, stream>>>(
      blocks, n_blocks, static_cast<unsigned short*>(planes));
  return static_cast<int>(cudaGetLastError());
}

const char* wide_trace_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
