// The breadth-first (level-synchronous) traversal of the 16-wide BVH on
// Hopper (sm_90a): the five kernels of the all-kernel pipeline.
//
// Replaces the Pallas TPU kernels of platinum_tpu/ops/bfstream.py:
//   K10 bf_expand_kernel  <- `_make_expand_kernel` (`_build_expand`)
//   K11 bf_prefix_kernel  <- `_make_prefix_kernel` (`_build_prefix`)
//   K12 bf_emit_kernel    <- `_make_emit_kernel`   (`_build_emit`)
//   K13 bf_mt_kernel      <- `_make_mt_kernel`     (`_build_mt`)
//   K14 bf_bwd_kernel     <- `_make_bwd_kernel`    (`_build_bwd`)
// driven per tree level by ops/bfstream.py of this package.
//
// A pair is (ray, node) or (ray, leaf block); pairs sit in 128-lane tiles,
// and a tile holds the pairs of one node or one block ("unit"), because
// every child gets a 128-aligned region in the next level's list. A pair
// carries its ray's index into the wave's (8, R) ray table, -1 in a dead
// lane, where the TPU kernels route the ray's eight floats through
// one-hot products. What each kernel computes is the TPU kernel's, down to
// the integer tables (masks, per-child counts, distinct-node indices,
// regions, unit tables, the MT cursor), which the tests hold bitwise
// against the JAX kernels level by level. The schedule is the card's:
//
// - The TPU grid runs in order and the emit and backward kernels carry a
//   per-(node, child) write cursor from one unit to the next
//   (bfstream.py:492-538, :775-839). Blocks run in no order here, so K11
//   also writes each unit's offset into each child's region, the
//   exclusive prefix of that child's counts over the earlier units of the
//   same node, and K12 / K14 units run independently. Ranks within a tile
//   come from warp ballots and popcounts, not a triangular product.
// - The level's unit count stays on the device (K11's status row): K10
//   launches one 128-thread block per unit of the level's capacity and
//   the blocks past the count return at once; K12, K13 and K14 launch the
//   CTAs the card holds at once (never more than the level's capacity
//   needs), which read the count and take the units below it. A wave
//   needs no host sync until its end.
// - K10 tests a unit's node's children that are not empty slots, once per
//   child for the block, and loads a lane's ray with the node row; K12
//   gives each unit a warp, thread t lanes t + 32k, so that no CTA barrier
//   and no shared table stands between a unit's loads and its stores, and
//   ranks only the children that some lane of the unit has.
// - K11 is a scan over the level in one block of 1024 threads, every item
//   in registers (distinct nodes, per-child prefix sums, then the regions
//   of the children in node order, child by child, with the MT cursor
//   running on across levels), then a fill over the grid: a warp per 32
//   (node, child) entries writes each region's unit-table entries and
//   dead tail lanes, coalesced. It allocates by prefix: children are taken
//   while their regions fit the capacity, and the tiles and pairs the
//   level needs are reported beside what it took, so that the host can
//   size a trace again (ops/bfstream.py never drops a pair). The TPU
//   kernel skips a child that does not fit and goes on; the two agree
//   whenever nothing overflows.
// - K13: the CTAs the card holds take the MT list's tiles in turn. A
//   tile's live lanes (found by ballot: a region's last tile has a dead
//   tail) are cut into tasks of R rays a thread, split over up to 16
//   lanes when they are few, and tested against the tile's block, staged
//   in shared memory by cp.async with the tile's rays while the tiles
//   before are tested (mt_chunk.cuh, K15's task code). Each ray's
//   features are formed by mt_block.cuh's code from the gathered ray, and
//   each (ray, triangle) pair keeps its sequence of operations, so its t
//   is the packet kernel's to the bit.
// - K14 gathers, for each pair, its children's results by the same ranks
//   and offsets and keeps the least (t, slot id) pair: a gather, no
//   atomics, deterministic. It issues every selected child's (t, slot id)
//   loads together, then reduces them in child order, then reads u and v
//   of the winner alone. Level 0's pairs are the segment's rays in
//   order, so its results are the segment's.
// - The kernels before the redesign of K10, K12, K13 and K14 stay as
//   their references, each behind an entry of its own
//   (`bf_expand_per_block_launch`, `bf_emit_per_block_launch`,
//   `bf_mt_per_tile_launch`, `bf_bwd_per_unit_launch`).
//
// What bounds them on this card: K13 does the work (5,120 FLOP per live
// pair at "highest" against a 10 KB block read once per tile; the accept
// test beside the 40 FMAs of a (ray, triangle) pair caps FFMA issue near
// 60%); K10 reads a 512 B node per tile and 32 B per lane and does up
// to 16 slab tests of 12 FLOP per lane (with their 10 min / max and 3-4
// compares at half the FMA rate, the tests bound it on full levels); K12
// and K14 move 4 B and 16 B per pair and child (K14's three dependent
// loads a unit bound it in practice); K11
// moves a few MB (its bound is ~1 us) but its scan is one block whose
// passes are chains of barriers and dependent reads (on an H100 about 20
// us a level, 13 of them the scan, even for a level of one node).

#include "mt_chunk.cuh"

namespace {

using namespace mt_block;

constexpr int kLanes = 128;        // pairs per tile = threads per unit block
constexpr int kChildren = 16;
constexpr int kWarps = kLanes / 32;
constexpr int kMtTag = 1 << 30;    // base-table tag of a leaf child's region
constexpr int kScanThreads = 1024;  // K11's scan block
constexpr int kScanWarps = kScanThreads / 32;
// units a thread holds of its child in phase 2: 64 groups x 16 = a pass
constexpr int kUnitItems = kChildren;
static_assert(kUnitItems * (kScanThreads / kChildren) == kScanThreads,
              "phase 2 covers phase 1's units");
constexpr int kEntryItems = 4;      // (node, child) entries a thread a pass
constexpr int kFillThreads = 256;   // K11's fill blocks
constexpr int kFillBlocks = 264;    // at most: two an SM
constexpr unsigned kFull = 0xffffffffu;

// A level's status row (int32), written by K11 and read on the device by
// the next level's kernels and K13, and by the host once at the end of a
// wave: the next level's unit count, the MT cursor after this level, the
// pairs lost to the capacities, the tiles the next level and the MT list
// need, the live pairs of each, and the level's distinct nodes.
enum { kNext = 0, kMtCur = 1, kLost = 2, kNeedNext = 3, kNeedMt = 4,
       kLiveNext = 5, kLiveMt = 6, kDistinct = 7, kStatWords = 8 };

__device__ __forceinline__ float inv_dir(float v) {
  const float tiny = v < 0.f ? -1e-20f : 1e-20f;
  return 1.f / (fabsf(v) < 1e-20f ? tiny : v);
}

// ---------------------------------------------------------------------------
// K10: a block per unit (a node x a tile of its pairs), a thread per lane:
// each thread slab-tests its lane's ray against the node's children.
// ---------------------------------------------------------------------------

// The slab test of one ray against one child's box (a: lo x, y, z, hi x;
// b: hi y, z, meta); the TPU kernel's operations in its order. Its meta
// test is the caller's, once per child.
__device__ __forceinline__ bool box_hit(float4 a, float4 b, float ox,
                                        float oy, float oz, float ix,
                                        float iy, float iz, float tmin,
                                        float tmax) {
  const float t0x = (a.x - ox) * ix, t1x = (a.w - ox) * ix;
  const float t0y = (a.y - oy) * iy, t1y = (b.x - oy) * iy;
  const float t0z = (a.z - oz) * iz, t1z = (b.y - oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  return tn <= tf && tf >= tmin && tn <= tmax && tmax >= tmin;
}

// On an H100 the slab tests bound K10 on full levels (the min / max and
// compares run at half the FMA rate), so it keeps a thread per lane and the
// occupancy that gives: a warp per unit (four lanes a thread, the CTAs the
// card holds, the next unit's loads ahead) ran 15-50% slower than the
// kernel before on the headline waves and 60-70% slower on a render's thin
// ones, and the CTAs the card holds striding over the units 3% slower on
// the render (PERF.md). What it
// changes: the lane's pair and its ray's eight floats are loaded before
// the node's barrier, with the node row, so a unit waits for one round of
// loads after its unit id; and a unit's node is the same for its 128
// lanes, so the meta test is made once per child (lane c of each warp, a
// ballot) and the block slab-tests only the children that are not empty
// slots (2-16 of 16, 5.2 on average in the headline colonnade's nodes):
// the same masks as testing all 16. A full node takes the unrolled loop.
__global__ void __launch_bounds__(kLanes)
bf_expand_kernel(const int* __restrict__ units, const int* __restrict__ level,
                 const int* __restrict__ pairs,
                 const float* __restrict__ rays, int n_rays,
                 const float* __restrict__ nodes, int n_nodes,
                 int* __restrict__ masks, int* __restrict__ counts) {
  const int u = blockIdx.x;
  if (u >= level[kNext]) return;
  const int lane = threadIdx.x, warp = lane >> 5, wl = lane & 31;
  __shared__ __align__(16) float rec[kChildren * 8];
  __shared__ int warp_count[kWarps][kChildren];
  const int node = min(max(units[u], 0), n_nodes - 1);
  const int r = pairs[(size_t)u * kLanes + lane];
  const bool live = r >= 0 && r < n_rays;
  const float* ray = rays + (live ? r : 0);
  const size_t nr = n_rays;
  float g[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) g[j] = live ? ray[j * nr] : 0.f;
  rec[lane] = nodes[(size_t)node * kLanes + lane];
  __syncthreads();
  const float meta = rec[(wl & (kChildren - 1)) * 8 + 6];
  const unsigned kids =
      __ballot_sync(kFull, wl < kChildren && (meta >= 0.f || meta <= -1.5f));
  int mask = 0;
  if (live) {
    const float ix = inv_dir(g[3]), iy = inv_dir(g[4]), iz = inv_dir(g[5]);
    const float4* q = reinterpret_cast<const float4*>(rec);
    if (kids == (1u << kChildren) - 1u) {
#pragma unroll
      for (int c = 0; c < kChildren; ++c)
        if (box_hit(q[2 * c], q[2 * c + 1], g[0], g[1], g[2], ix, iy, iz,
                    g[6], g[7]))
          mask |= 1 << c;
    } else {
      for (unsigned w = kids; w; w &= w - 1) {
        const int c = __ffs(w) - 1;
        if (box_hit(q[2 * c], q[2 * c + 1], g[0], g[1], g[2], ix, iy, iz,
                    g[6], g[7]))
          mask |= 1 << c;
      }
    }
  }
  masks[(size_t)u * kLanes + lane] = mask;
#pragma unroll
  for (int c = 0; c < kChildren; ++c) {
    const unsigned b = __ballot_sync(kFull, (mask >> c) & 1);
    if (wl == 0) warp_count[warp][c] = __popc(b);
  }
  __syncthreads();
  if (lane < kChildren) {
    int n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) n += warp_count[w][lane];
    counts[(size_t)u * kChildren + lane] = n;
  }
}

// The reference of bf_expand_kernel (the kernel before the redesign): the
// same block per unit, its pair read after the node's barrier and its
// ray after that, all 16 children tested.
__global__ void __launch_bounds__(kLanes)
bf_expand_per_block_kernel(const int* __restrict__ units,
                           const int* __restrict__ level,
                           const int* __restrict__ pairs,
                           const float* __restrict__ rays, int n_rays,
                           const float* __restrict__ nodes, int n_nodes,
                           int* __restrict__ masks, int* __restrict__ counts) {
  const int u = blockIdx.x;
  if (u >= level[kNext]) return;
  const int lane = threadIdx.x, warp = lane >> 5, wl = lane & 31;
  __shared__ float rec[kChildren * 8];
  __shared__ int warp_count[kWarps][kChildren];
  const int node = min(max(units[u], 0), n_nodes - 1);
  rec[lane] = nodes[(size_t)node * kLanes + lane];
  __syncthreads();
  const int r = pairs[(size_t)u * kLanes + lane];
  int mask = 0;
  if (r >= 0 && r < n_rays) {
    const float ox = rays[r], oy = rays[n_rays + r], oz = rays[2 * n_rays + r];
    const float ix = inv_dir(rays[3 * n_rays + r]);
    const float iy = inv_dir(rays[4 * n_rays + r]);
    const float iz = inv_dir(rays[5 * n_rays + r]);
    const float tmin = rays[6 * n_rays + r], tmax = rays[7 * n_rays + r];
#pragma unroll
    for (int c = 0; c < kChildren; ++c) {
      const float* q = rec + c * 8;
      const float t0x = (q[0] - ox) * ix, t1x = (q[3] - ox) * ix;
      const float t0y = (q[1] - oy) * iy, t1y = (q[4] - oy) * iy;
      const float t0z = (q[2] - oz) * iz, t1z = (q[5] - oz) * iz;
      const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fminf(t0z, t1z));
      const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fmaxf(t0z, t1z));
      const float meta = q[6];
      if (tn <= tf && tf >= tmin && tn <= tmax && tmax >= tmin &&
          (meta >= 0.f || meta <= -1.5f))
        mask |= 1 << c;
    }
  }
  masks[(size_t)u * kLanes + lane] = mask;
#pragma unroll
  for (int c = 0; c < kChildren; ++c) {
    const unsigned b = __ballot_sync(kFull, (mask >> c) & 1);
    if (wl == 0) warp_count[warp][c] = __popc(b);
  }
  __syncthreads();
  if (lane < kChildren) {
    int n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) n += warp_count[w][lane];
    counts[(size_t)u * kChildren + lane] = n;
  }
}

// ---------------------------------------------------------------------------
// K11: one block scans the level (bf_prefix_scan_kernel), then the grid
// fills the regions it allocated (bf_prefix_fill_kernel).
// ---------------------------------------------------------------------------

// Exclusive prefix sums of kC channels at once over the block's threads in
// thread order (thread t's v[c] is item t of channel c); total[c] gets each
// channel's sum. Every thread of the block calls it; `scratch` holds
// kScanWarps x kC ints and `tot` kC.
template <int kC>
__device__ __forceinline__ void scan_channels(const int (&v)[kC],
                                              int (&excl)[kC],
                                              int (&total)[kC],
                                              int (*scratch)[kC], int* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    x[c] = v[c];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x[c], o);
      if (lane >= o) x[c] += y;
    }
    if (lane == 31) scratch[warp][c] = x[c];
  }
  __syncthreads();
  for (int c = warp; c < kC; c += kScanWarps) {
    const int w = lane < kScanWarps ? scratch[lane][c] : 0;
    int y = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += z;
    }
    if (lane < kScanWarps) scratch[lane][c] = y - w;
    if (lane == 31) tot[c] = y;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    excl[c] = scratch[warp][c] + x[c] - v[c];
    total[c] = tot[c];
  }
  __syncthreads();   // scratch is reused by the next scan
}

// The scan: one block of kScanThreads threads walks the level in passes
// of kScanThreads units, then kScanThreads * kEntryItems (node, child)
// entries, every item in registers:
//   1. distinct nodes: a unit starts one where its node differs from the
//      unit before; a scan of those flags gives dn[u] and node_id[d]
//   2. per child c, the exclusive prefix of its counts over all units:
//      thread (g, c) holds kUnitItems units' counts of child c, a scan over
//      the groups g gives each its start; node_base[d][c] is the prefix at
//      node d's first unit, uoff[u][c] a unit's prefix minus its node's
//   3. per entry (d, c) with cnt = node_base[d + 1][c] - node_base[d][c]
//      pairs: ceil(cnt / 128) tiles in the next level's list (inner child)
//      or the MT list (leaf child, after the cursor); a scan of the tiles
//      over the entries in order gives each region's first tile, and a
//      region is taken while it fits its list (allocation by prefix):
//      base[e] is its first tile (| kMtTag in the MT list) or -1
// and writes the status row. The tables of the regions taken and their
// dead tail lanes are the fill kernel's. node_id and node_base are written
// and read again by the block, so they are plain pointers (a read through
// the read-only cache would not see the block's own writes).
__global__ void __launch_bounds__(kScanThreads)
bf_prefix_scan_kernel(const int* __restrict__ units,
                      const int* __restrict__ level,
                      const int* __restrict__ counts,
                      const int* __restrict__ meta, int n_nodes, int cap_next,
                      int mt_cap, int* dn, int* base, int* uoff, int* node_id,
                      int* node_base, int* stat_out) {
  __shared__ int scratch[kScanWarps * kChildren];
  __shared__ int tot[kChildren];
  __shared__ int s_new[kScanThreads];
  __shared__ int s_dn[kScanThreads];
  __shared__ int carry[kChildren];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = level[kNext];
  const int mt0 = level[kMtCur];
  const int c = t & (kChildren - 1), g = t >> 4;
  if (t < kChildren) carry[t] = 0;
  int n_distinct = 0;

  for (int u0 = 0; u0 < n; u0 += kScanThreads) {
    // this pass's loads first, so that they overlap: thread (g, c) holds
    // units u0 + g * kUnitItems + i of child c
    int cnt[kUnitItems];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kUnitItems; ++i) {
      const int v = u0 + g * kUnitItems + i;
      cnt[i] = v < n ? counts[(size_t)v * kChildren + c] : 0;
      sum += cnt[i];
    }
    // 1. distinct nodes of this pass's units (unit u0 + t)
    const int u = u0 + t;
    const int unit = u < n ? units[u] : 0;
    int is_new[1] = {u < n && (u == 0 || unit != units[u - 1])};
    int d[1], nd[1];
    scan_channels<1>(is_new, d, nd,
                     reinterpret_cast<int (*)[1]>(scratch), tot);
    const int du = n_distinct + d[0] + is_new[0] - 1;   // unit u's node
    if (u < n) {
      dn[u] = du;
      if (is_new[0]) node_id[du] = unit;
    }
    s_new[t] = is_new[0];
    s_dn[t] = du;
    n_distinct += nd[0];

    // 2. per-child prefixes: the groups' sums of child c, scanned in group
    // order; lanes l and l + 16 of a warp are two groups, the warps'
    // totals a second level
    const int up = __shfl_up_sync(kFull, sum, kChildren);
    const int incl = sum + (lane >= kChildren ? up : 0);
    if (lane >= kChildren) scratch[warp * kChildren + c] = incl;
    __syncthreads();
    if (warp < kChildren) {
      const int w = lane < kScanWarps ? scratch[lane * kChildren + warp] : 0;
      int y = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int z = __shfl_up_sync(kFull, y, o);
        if (lane >= o) y += z;
      }
      if (lane < kScanWarps) scratch[lane * kChildren + warp] = y - w;
      if (lane == 31) tot[warp] = y;
    }
    __syncthreads();
    int run = carry[c] + scratch[warp * kChildren + c] + incl - sum;
    int pre[kUnitItems];
#pragma unroll
    for (int i = 0; i < kUnitItems; ++i) {
      const int k = g * kUnitItems + i;
      pre[i] = run;
      if (u0 + k < n && s_new[k])
        node_base[(size_t)s_dn[k] * kChildren + c] = run;
      run += cnt[i];
    }
    __syncthreads();   // node_base of every node begun so far is written
    if (t < kChildren) carry[t] += tot[t];
    int base_c = 0;
    if (u0 + g * kUnitItems < n)
      base_c = node_base[(size_t)s_dn[g * kUnitItems] * kChildren + c];
#pragma unroll
    for (int i = 0; i < kUnitItems; ++i) {
      const int k = g * kUnitItems + i;
      if (u0 + k < n) {
        if (s_new[k]) base_c = pre[i];
        uoff[(size_t)(u0 + k) * kChildren + c] = pre[i] - base_c;
      }
    }
    __syncthreads();   // s_new, s_dn, scratch and carry are used again
  }
  if (t < kChildren) node_base[(size_t)n_distinct * kChildren + t] = carry[t];
  __syncthreads();

  // 3. the regions of the entries (d, c) in that order
  const int n_entries = n_distinct * kChildren;
  int at_next = 0, at_mt = mt0;
  int sums[5] = {0, 0, 0, 0, 0};   // took next, took mt, lost, live next,
                                   // live mt
  for (int e0 = 0; e0 < n_entries; e0 += kScanThreads * kEntryItems) {
    int cnt[kEntryItems], tiles[kEntryItems], mc[kEntryItems];
    int need[2] = {0, 0};
#pragma unroll
    for (int i = 0; i < kEntryItems; ++i) {
      const int e = e0 + t * kEntryItems + i;
      cnt[i] = 0;
      tiles[i] = 0;
      mc[i] = 0;
      if (e < n_entries) {
        const int de = e >> 4, ce = e & (kChildren - 1);
        cnt[i] = node_base[(size_t)(de + 1) * kChildren + ce] -
                 node_base[(size_t)de * kChildren + ce];
        if (cnt[i] > 0) {
          const int node = min(max(node_id[de], 0), n_nodes - 1);
          mc[i] = meta[(size_t)node * kChildren + ce];
          tiles[i] = (cnt[i] + kLanes - 1) / kLanes;
          if (mc[i] >= 0) need[0] += tiles[i];
          else need[1] += tiles[i];
        }
      }
    }
    int at[2], total[2];
    scan_channels<2>(need, at, total,
                     reinterpret_cast<int (*)[2]>(scratch), tot);
    int p = at_next + at[0], m = at_mt + at[1];
#pragma unroll
    for (int i = 0; i < kEntryItems; ++i) {
      const int e = e0 + t * kEntryItems + i;
      if (e >= n_entries) continue;
      int rec = -1;
      if (cnt[i] > 0) {
        if (mc[i] >= 0) {
          if (p + tiles[i] <= cap_next) {
            rec = p;
            sums[0] += tiles[i];
            sums[3] += cnt[i];
          } else {
            sums[2] += cnt[i];
          }
          p += tiles[i];
        } else {
          if (m + tiles[i] <= mt_cap) {
            rec = kMtTag | m;
            sums[1] += tiles[i];
            sums[4] += cnt[i];
          } else {
            sums[2] += cnt[i];
          }
          m += tiles[i];
        }
      }
      base[e] = rec;
    }
    at_next += total[0];
    at_mt += total[1];
  }
  int unused[5], all[5];
  scan_channels<5>(sums, unused, all,
                   reinterpret_cast<int (*)[5]>(scratch), tot);
  if (t == 0) {
    stat_out[kNext] = all[0];
    stat_out[kMtCur] = mt0 + all[1];
    stat_out[kLost] = all[2];
    stat_out[kNeedNext] = at_next;
    stat_out[kNeedMt] = at_mt;
    stat_out[kLiveNext] = all[3];
    stat_out[kLiveMt] = all[4];
    stat_out[kDistinct] = n_distinct;
  }
}

// The fill: a warp takes 32 entries (d, c) at a time, grid-stride over the
// level's entries; for each entry whose region was taken, the whole warp
// writes the region's unit-table entries (the child's node in the next
// level's list, its block in the MT list) and, in its last tile, the dead
// lanes past the count (-1), one lane a store.
__global__ void __launch_bounds__(kFillThreads)
bf_prefix_fill_kernel(const int* __restrict__ meta, int n_nodes,
                      const int* __restrict__ base,
                      const int* __restrict__ node_id,
                      const int* __restrict__ node_base,
                      const int* __restrict__ stat_out,
                      int* __restrict__ units_next,
                      int* __restrict__ pairs_next,
                      int* __restrict__ mt_units,
                      int* __restrict__ mt_pairs) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kFillThreads / 32);
  const int n_entries = stat_out[kDistinct] * kChildren;
  for (int e0 = (blockIdx.x * (kFillThreads / 32) + (threadIdx.x >> 5)) * 32;
       e0 < n_entries; e0 += warps * 32) {
    const int e = e0 + lane;
    const int rec = e < n_entries ? base[e] : -1;
    int at = 0, tiles = 0, rem = 0, val = 0;
    if (rec >= 0) {
      const int d = e >> 4, c = e & (kChildren - 1);
      const int cnt = node_base[(size_t)(d + 1) * kChildren + c] -
                      node_base[(size_t)d * kChildren + c];
      const int node = min(max(node_id[d], 0), n_nodes - 1);
      const int mc = meta[(size_t)node * kChildren + c];
      at = rec & (kMtTag - 1);
      tiles = (cnt + kLanes - 1) / kLanes;
      rem = cnt - (tiles - 1) * kLanes;
      val = rec < kMtTag ? mc : (-mc - 2) >> 5;
    }
    unsigned work = __ballot_sync(kFull, rec >= 0);
    while (work) {
      const int src = __ffs(work) - 1;
      work &= work - 1;
      const int r_at = __shfl_sync(kFull, at, src);
      const int r_tiles = __shfl_sync(kFull, tiles, src);
      const int r_rem = __shfl_sync(kFull, rem, src);
      const int r_val = __shfl_sync(kFull, val, src);
      const bool inner = __shfl_sync(kFull, rec, src) < kMtTag;
      int* table = inner ? units_next : mt_units;
      for (int k = lane; k < r_tiles; k += 32) table[r_at + k] = r_val;
      int* tail = (inner ? pairs_next : mt_pairs) +
                  (size_t)(r_at + r_tiles - 1) * kLanes;
      for (int l = r_rem + lane; l < kLanes; l += 32) tail[l] = -1;
    }
  }
}

// ---------------------------------------------------------------------------
// K12 and K14 share the routing: lane `lane` of unit u with child c's bit
// set goes to lane base + uoff[u][c] + rank of its child's region, rank =
// the lanes below it in the tile with the same bit.
// ---------------------------------------------------------------------------

// Ranks within the warp from one ballot per child; the warp's per-child
// counts go to cnt[warp] packed, child c in byte c % 4 of word c / 4 (a
// count is at most 32, so three lower warps' words add bytewise without a
// carry). The caller synchronises, then `add_lower_warps` completes the
// ranks: one prefix of the packed counts per tile, not a loop per child.
__device__ __forceinline__ void warp_ranks(int mask, int (&below)[kChildren],
                                           int4* cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < kChildren; ++c) {
    const unsigned b = __ballot_sync(kFull, (mask >> c) & 1);
    below[c] = __popc(b & lower);
    w[c >> 2] |= static_cast<unsigned>(__popc(b)) << (8 * (c & 3));
  }
  if (lane == 0)
    cnt[warp] = make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                          static_cast<int>(w[2]), static_cast<int>(w[3]));
}

__device__ __forceinline__ void add_lower_warps(int (&below)[kChildren],
                                                const int4* cnt) {
  const int warp = threadIdx.x >> 5;
  unsigned s[4] = {0u, 0u, 0u, 0u};
  for (int w = 0; w < warp; ++w) {
    const int4 x = cnt[w];
    s[0] += static_cast<unsigned>(x.x);
    s[1] += static_cast<unsigned>(x.y);
    s[2] += static_cast<unsigned>(x.z);
    s[3] += static_cast<unsigned>(x.w);
  }
#pragma unroll
  for (int c = 0; c < kChildren; ++c)
    below[c] += static_cast<int>((s[c >> 2] >> (8 * (c & 3))) & 0xffu);
}

constexpr int kPerThread = kLanes / 32;   // K12: lanes of a unit a thread

// K12: a warp per unit on the CTAs the card holds (thread t: lanes t +
// 32k). Lanes 0-15 load the unit's 16 offsets and lanes 16-31 its
// distinct node's 16 regions, one coalesced load a unit, into the warp's
// slice of shared memory, read back by broadcast. For each
// child that some lane has (an OR over the warp) and that has a region,
// its four ballots b_0..b_3 rank lane t + 32k at popc(b_k & lanes below
// t) + the popcounts of b_j, j < k: the ranks of warp_ranks and
// add_lower_warps without a barrier. The next unit's masks, pairs and
// distinct node are loaded before this unit's ballots, its two rows while
// this unit's stores go out.
__global__ void __launch_bounds__(kLanes)
bf_emit_kernel(const int* __restrict__ pairs, const int* __restrict__ masks,
               const int* __restrict__ level, const int* __restrict__ dn,
               const int* __restrict__ uoff, const int* __restrict__ base,
               int* __restrict__ pairs_next, int* __restrict__ mt_pairs) {
  __shared__ int s_row[kWarps][2 * kChildren];   // offsets, then regions
  const int t = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int step = gridDim.x * kWarps, n = level[kNext];
  int u = blockIdx.x * kWarps + warp;
  if (u >= n) return;
  const unsigned lower = (1u << t) - 1u;
  int* row = s_row[warp];
  int m[kPerThread], r[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    m[k] = masks[(size_t)u * kLanes + t + 32 * k];
    r[k] = pairs[(size_t)u * kLanes + t + 32 * k];
  }
  int d = dn[u];
  int v = t < kChildren ? uoff[(size_t)u * kChildren + t]
                        : base[(size_t)d * kChildren + t - kChildren];
  for (;;) {
    const int un = u + step;
    const bool more = un < n;
    int mn[kPerThread], rn[kPerThread];
    if (more) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        mn[k] = masks[(size_t)un * kLanes + t + 32 * k];
        rn[k] = pairs[(size_t)un * kLanes + t + 32 * k];
      }
      d = dn[un];
    }
    row[t] = v;
    __syncwarp();       // the unit's rows are in the slice
    // the children some lane has, with a region (the ranks of a child
    // without one matter to no lane)
    for (unsigned w = __reduce_or_sync(kFull, m[0] | m[1] | m[2] | m[3]);
         w; w &= w - 1) {
      const int c = __ffs(w) - 1;
      const int rec = row[kChildren + c];
      if (rec < 0) continue;
      const size_t at = (size_t)(rec & (kMtTag - 1)) * kLanes + row[c];
      int* dst = rec >= kMtTag ? mt_pairs : pairs_next;
      int below = 0;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const bool bit = (m[k] >> c) & 1;
        const unsigned b = __ballot_sync(kFull, bit);
        if (bit) dst[at + below + __popc(b & lower)] = r[k];
        below += __popc(b);
      }
    }
    if (!more) break;
    v = t < kChildren ? uoff[(size_t)un * kChildren + t]
                      : base[(size_t)d * kChildren + t - kChildren];
    __syncwarp();       // every lane has read the slice
    u = un;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      m[k] = mn[k];
      r[k] = rn[k];
    }
  }
}

// The reference of bf_emit_kernel (the kernel before the redesign): one
// block per unit of the capacity, a thread per lane, ranks completed over
// the lower warps' packed counts after a barrier.
__global__ void __launch_bounds__(kLanes)
bf_emit_per_block_kernel(const int* __restrict__ pairs,
                         const int* __restrict__ masks,
                         const int* __restrict__ level,
                         const int* __restrict__ dn,
                         const int* __restrict__ uoff,
                         const int* __restrict__ base,
                         int* __restrict__ pairs_next,
                         int* __restrict__ mt_pairs) {
  const int u = blockIdx.x;
  if (u >= level[kNext]) return;
  const int lane = threadIdx.x;
  __shared__ int4 cnt[kWarps];
  const int mask = masks[(size_t)u * kLanes + lane];
  const int r = pairs[(size_t)u * kLanes + lane];
  int below[kChildren];
  warp_ranks(mask, below, cnt);
  __syncthreads();
  add_lower_warps(below, cnt);
  const int d = dn[u];
#pragma unroll
  for (int c = 0; c < kChildren; ++c) {
    if (!((mask >> c) & 1)) continue;
    const int rec = base[(size_t)d * kChildren + c];
    if (rec < 0) continue;
    const size_t pos = (size_t)(rec & (kMtTag - 1)) * kLanes +
                       uoff[(size_t)u * kChildren + c] + below[c];
    (rec >= kMtTag ? mt_pairs : pairs_next)[pos] = r;
  }
}

// CTAs of `kKernel` (kThreads threads) that the card holds at once, with
// the largest shared-memory carveout: the grid of a persistent kernel,
// asked of the runtime once
template <auto kKernel, int kThreads>
int resident_ctas() {
  static const int ctas = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(kKernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads,
                                                  0);
    return max(1, sms * per_sm);
  }();
  return ctas;
}

// CTAs of kWarps warps that a warp per unit needs for cap_t units
int unit_ctas(int cap_t) { return max(1, (cap_t + kWarps - 1) / kWarps); }

__device__ __forceinline__ int clamp_block(int b, int n_blocks) {
  return min(max(b, 0), n_blocks - 1);
}

// ---------------------------------------------------------------------------
// K13: persistent CTAs, CTA c taking tiles c, c + G, c + 2G, ... of the
// MT list (G the grid), so that each takes a like share of full and
// part-live tiles (on an H100, contiguous ranges of tiles ran 7% faster
// on the headline's bounce wave and 36% slower on a render's thin waves).
// A tile's live lanes are found by ballot and cut into tasks of R rays a
// thread (mt_chunk.cuh `test_rays`), split over g lanes where they are
// few. The loads run ahead of the tests (cp.async): the next tile's rays
// into shared memory, the blocks two tiles ahead into a ring of three
// slots, the pairs and block ids in registers a round or two ahead.
// ---------------------------------------------------------------------------

constexpr int kRing = 3;                        // staged blocks
constexpr int kSlotFloats = kBlockFloats + 4;   // the slots' equal offsets
                                                // in other banks

// Issue the cp.async copies of block b into `dst`, 16 bytes a thread at a
// time; the caller commits them.
__device__ __forceinline__ void stage_block(float* dst,
                                            const float* __restrict__ blocks,
                                            int b) {
  const float* src = blocks + (size_t)b * kBlockFloats;
  for (int q = threadIdx.x; q < kBlockFloats / 4; q += kLanes)
    copy16_async(dst + 4 * q, src + 4 * q);
}

// Issue the cp.async copies of this thread's lane's ray (pair r) into
// column threadIdx.x of `dst` (its eight rows), where the lane is live;
// the caller commits them.
__device__ __forceinline__ void stage_ray(float (*dst)[kLanes], int r,
                                          const float* __restrict__ rays,
                                          int n_rays) {
  if (r < 0 || r >= n_rays) return;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    copy4_async(&dst[k][threadIdx.x], rays + (size_t)k * n_rays + r);
}

template <bool kAnyHit, int kPrec>
__global__ void __launch_bounds__(kLanes)
bf_mt_kernel(const int* __restrict__ mt_pairs, const int* __restrict__ mt_units,
             const int* __restrict__ level, const float* __restrict__ rays,
             int n_rays, const float* __restrict__ blocks, int n_blocks,
             float* __restrict__ t_out, int* __restrict__ sid_out,
             float* __restrict__ u_out, float* __restrict__ v_out) {
  constexpr int R = task_rays<kPrec>();
  __shared__ __align__(16) float blk[kRing][kSlotFloats];
  // a tile's rays by lane, and its live lanes, warp w's at [w * 32, w * 32
  // + count) with each warp's count; two of each, the tile's and the next
  // one's
  __shared__ float s_rays[2][8][kLanes];
  __shared__ int s_lane[2][kLanes];
  __shared__ int s_live[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float inf = __int_as_float(0x7f800000);
  const int n = level[kMtCur], step = gridDim.x, first = blockIdx.x;
  if (first >= n) return;
  // the pipeline as tile u sees it: the pairs of tiles u and u + step, the
  // blocks of tiles u and u + step with their slots, the block id of
  // u + 2 step
  int r0 = mt_pairs[(size_t)first * kLanes + tid];
  int r1 = first + step < n
               ? mt_pairs[(size_t)(first + step) * kLanes + tid] : -1;
  int b0 = clamp_block(mt_units[first], n_blocks);
  int b1 = first + step < n ? clamp_block(mt_units[first + step], n_blocks)
                            : b0;
  int next_id = first + 2 * step < n ? mt_units[first + 2 * step] : 0;
  int s0 = 0, s1 = b1 == b0 ? 0 : 1;
  stage_block(blk[0], blocks, b0);
  stage_ray(s_rays[0], r0, rays, n_rays);
  copy_commit();
  if (s1 != s0) stage_block(blk[s1], blocks, b1);
  copy_commit();
  for (int u = first, it = 0; u < n; u += step, ++it) {
    const int p = it & 1;
    const size_t i = (size_t)u * kLanes + tid;
    const bool live = r0 >= 0 && r0 < n_rays;
    if (!live) {
      t_out[i] = inf;
      sid_out[i] = -1;
      u_out[i] = 0.f;
      v_out[i] = 0.f;
    }
    const unsigned bal = __ballot_sync(kFull, live);
    if (live) s_lane[p][warp * 32 + __popc(bal & ((1u << lane) - 1u))] = tid;
    if (lane == 0) s_live[p][warp] = __popc(bal);
    copy_wait<1>();     // this tile's rays and block
    __syncthreads();    // every thread is past the tile before
    // the next tile's rays, then the block two tiles ahead into the next
    // slot of the ring where it differs from the next tile's (that slot
    // was last read two distinct blocks ago); each a group
    if (u + step < n) stage_ray(s_rays[p ^ 1], r1, rays, n_rays);
    copy_commit();
    int b2 = b1, s2 = s1;
    if (u + 2 * step < n) {
      b2 = clamp_block(next_id, n_blocks);
      if (b2 != b1) {
        s2 = s1 == kRing - 1 ? 0 : s1 + 1;
        stage_block(blk[s2], blocks, b2);
      }
    }
    copy_commit();
    const int r2 =
        u + 2 * step < n ? mt_pairs[(size_t)(u + 2 * step) * kLanes + tid]
                         : -1;
    next_id = u + 3 * step < n ? mt_units[u + 3 * step] : 0;

    const int c0 = s_live[p][0], c1 = s_live[p][1], c2 = s_live[p][2];
    const int n_live = c0 + c1 + c2 + s_live[p][3];
    const int tasks = (n_live + R - 1) / R;
    const int g = split_lanes(tasks, kLanes);
    const int task = tid / g, part = tid & (g - 1);
    const bool has = task < tasks;
    float f[R][10], fh[R][10], fl[R][10], tmin[R], lim[R];
    int dst[R];
    Pick pick[R];
    bool hit[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int k = task * R + j;     // the task's j-th live lane
      dst[j] = -1;
      if (has && k < n_live) {
        const int w = (k >= c0) + (k >= c0 + c1) + (k >= c0 + c1 + c2);
        const int ln = s_lane[p][w * 32 + k - (w > 0 ? c0 : 0) -
                                 (w > 1 ? c1 : 0) - (w > 2 ? c2 : 0)];
        const float(*ray)[kLanes] = s_rays[p];
        dst[j] = ln;
        ray_features(ray[0][ln], ray[1][ln], ray[2][ln], ray[3][ln],
                     ray[4][ln], ray[5][ln], f[j]);
        tmin[j] = ray[6][ln];
        lim[j] = ray[7][ln];
      } else {
#pragma unroll
        for (int q = 0; q < 10; ++q) f[j][q] = 0.f;
        tmin[j] = 0.f;
        lim[j] = -inf;
      }
      if (kPrec != kHighest) split_features(f[j], fh[j], fl[j]);
      pick[j] = Pick{inf, 0.f, 0.f, 0.f, -1};
      hit[j] = dst[j] < 0;     // no ray stops no any-hit test early
    }
    if (has)
      test_rays<kAnyHit, kPrec, R>(blk[s0], 4 * part, 4 * g, f, fh, fl,
                                   tmin, lim, pick, hit);
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (kAnyHit) hit[j] = hit[j] && dst[j] >= 0;
    combine_split<kAnyHit, R>(g, pick, hit);
    if (has && part == 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (dst[j] < 0) break;
        const size_t o = (size_t)u * kLanes + dst[j];
        float t = inf, bu = 0.f, bv = 0.f;
        int sid = -1;
        if (kAnyHit) {
          if (hit[j]) {
            t = 0.f;
            sid = 0;
          }
        } else if (pick[j].slot >= 0 && pick[j].tb < lim[j]) {
          const float iad = 1.0f / fmaxf(pick[j].ad, 1e-37f);
          t = pick[j].tb;
          sid = b0 * kBlockTris + pick[j].slot;
          bu = pick[j].us * iad;
          bv = pick[j].vs * iad;
        }
        t_out[o] = t;
        sid_out[o] = sid;
        u_out[o] = bu;
        v_out[o] = bv;
      }
    }
    r0 = r1;
    r1 = r2;
    b0 = b1;
    b1 = b2;
    s0 = s1;
    s1 = s2;
  }
  copy_wait<0>();
}

// The reference of bf_mt_kernel (the kernel before the redesign): one CTA
// per MT unit of the capacity, the block copied into shared memory, one
// lane one ray through block_closest / block_any.
template <bool kAnyHit, int kPrec>
__global__ void __launch_bounds__(kLanes)
bf_mt_per_tile_kernel(const int* __restrict__ mt_pairs,
                      const int* __restrict__ mt_units,
                      const int* __restrict__ level,
                      const float* __restrict__ rays, int n_rays,
                      const float* __restrict__ blocks, int n_blocks,
                      float* __restrict__ t_out, int* __restrict__ sid_out,
                      float* __restrict__ u_out, float* __restrict__ v_out) {
  const int u = blockIdx.x;
  if (u >= level[kMtCur]) return;
  const int lane = threadIdx.x;
  __shared__ __align__(16) float blk[kBlockFloats];
  const int b = clamp_block(mt_units[u], n_blocks);
  const float4* src =
      reinterpret_cast<const float4*>(blocks + (size_t)b * kBlockFloats);
  for (int i = lane; i < kBlockFloats / 4; i += kLanes)
    reinterpret_cast<float4*>(blk)[i] = __ldg(src + i);
  __syncthreads();
  const size_t i = (size_t)u * kLanes + lane;
  const int r = mt_pairs[i];
  float t = __int_as_float(0x7f800000), bu = 0.f, bv = 0.f;
  int sid = -1;
  if (r >= 0 && r < n_rays) {
    float f[10], fh[10], fl[10];
    ray_features(rays[r], rays[n_rays + r], rays[2 * n_rays + r],
                 rays[3 * n_rays + r], rays[4 * n_rays + r],
                 rays[5 * n_rays + r], f);
    if (kPrec != kHighest) split_features(f, fh, fl);
    const float tmin = rays[6 * n_rays + r], tmax = rays[7 * n_rays + r];
    if (kAnyHit) {
      if (block_any<kPrec, true>(blk, f, fh, fl, tmin, tmax)) {
        t = 0.f;
        sid = 0;
      }
    } else {
      float best = tmax;
      if (block_closest<kPrec, true>(blk, b, f, fh, fl, tmin, best, sid, bu,
                                     bv))
        t = best;
    }
  }
  t_out[i] = t;
  sid_out[i] = sid;
  u_out[i] = bu;
  v_out[i] = bv;
}

// ---------------------------------------------------------------------------
// K14: each lane of a unit keeps the least (t, slot id) of its children's
// results, inner children from the level below, leaf children from K13.
// ---------------------------------------------------------------------------

struct Results {
  const float* t;
  const int* sid;
  const float* u;
  const float* v;
};

// CTAs stride over the level's units, a grid sized to the card. Per unit:
// the ranks (warp_ranks, one barrier, add_lower_warps), the unit's region
// and offset rows in vector loads, then every selected child's (t, sid)
// gathered at once, reduced in child order (strict < on t, then the
// smaller sid: the reference's choice), and u, v gathered for the winner
// alone.
__global__ void __launch_bounds__(kLanes)
bf_bwd_kernel(const int* __restrict__ masks, const int* __restrict__ level,
              const int* __restrict__ dn, const int* __restrict__ uoff,
              const int* __restrict__ base, Results child, Results mt,
              float* __restrict__ t_out, int* __restrict__ sid_out,
              float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ int4 cnt[2][kWarps];   // this unit's and the next one's
  const int lane = threadIdx.x;
  const int n = level[kNext];
  for (int u = blockIdx.x, it = 0; u < n; u += gridDim.x, ++it) {
    const size_t i = (size_t)u * kLanes + lane;
    const int mask = masks[i];
    const int d = dn[u];
    int below[kChildren];
    warp_ranks(mask, below, cnt[it & 1]);
    int rec[kChildren], off[kChildren];
#pragma unroll
    for (int q = 0; q < kChildren / 4; ++q) {
      const int4 x = reinterpret_cast<const int4*>(
          base + (size_t)d * kChildren)[q];
      const int4 y = reinterpret_cast<const int4*>(
          uoff + (size_t)u * kChildren)[q];
      rec[4 * q] = x.x; rec[4 * q + 1] = x.y;
      rec[4 * q + 2] = x.z; rec[4 * q + 3] = x.w;
      off[4 * q] = y.x; off[4 * q + 1] = y.y;
      off[4 * q + 2] = y.z; off[4 * q + 3] = y.w;
    }
    __syncthreads();
    add_lower_warps(below, cnt[it & 1]);
    float tn[kChildren];
    int sn[kChildren], pos[kChildren];
#pragma unroll
    for (int c = 0; c < kChildren; ++c) {
      pos[c] = (rec[c] & (kMtTag - 1)) * kLanes + off[c] + below[c];
      tn[c] = 0.f;
      sn[c] = 0;
      if (((mask >> c) & 1) && rec[c] >= 0) {
        const bool in_mt = rec[c] >= kMtTag;
        tn[c] = __ldg((in_mt ? mt.t : child.t) + pos[c]);
        sn[c] = __ldg((in_mt ? mt.sid : child.sid) + pos[c]);
      }
    }
    float best = __int_as_float(0x7f800000);
    int bs = -1, wpos = 0;
    bool won = false, wmt = false;
#pragma unroll
    for (int c = 0; c < kChildren; ++c) {
      if (!((mask >> c) & 1) || rec[c] < 0) continue;
      if (tn[c] < best || (tn[c] == best && sn[c] < bs)) {
        best = tn[c];
        bs = sn[c];
        wpos = pos[c];
        wmt = rec[c] >= kMtTag;
        won = true;
      }
    }
    float bu = 0.f, bv = 0.f;
    if (won) {
      bu = __ldg((wmt ? mt.u : child.u) + wpos);
      bv = __ldg((wmt ? mt.v : child.v) + wpos);
    }
    t_out[i] = best;
    sid_out[i] = bs;
    u_out[i] = bu;
    v_out[i] = bv;
  }
}

// The reference of bf_bwd_kernel (the kernel before the redesign): one
// CTA per unit of the capacity, the rank of each selected child summed
// over the lower warps, each child's results gathered as the fold
// reaches it.
struct Ranks {
  int below[kChildren];   // lanes of the warp below this one with bit c
};

__device__ __forceinline__ void tile_ranks(int mask, Ranks& rk,
                                           int (*warp_count)[kWarps]) {
  const int lane = threadIdx.x, warp = lane >> 5, wl = lane & 31;
  const unsigned lower = (1u << wl) - 1u;
#pragma unroll
  for (int c = 0; c < kChildren; ++c) {
    const unsigned b = __ballot_sync(kFull, (mask >> c) & 1);
    rk.below[c] = __popc(b & lower);
    if (wl == 0) warp_count[c][warp] = __popc(b);
  }
}

__device__ __forceinline__ int tile_rank(const Ranks& rk,
                                         int (*warp_count)[kWarps], int c) {
  const int warp = threadIdx.x >> 5;
  int rank = rk.below[c];
  for (int w = 0; w < warp; ++w) rank += warp_count[c][w];
  return rank;
}

__global__ void __launch_bounds__(kLanes)
bf_bwd_per_unit_kernel(const int* __restrict__ masks,
                       const int* __restrict__ level,
                       const int* __restrict__ dn,
                       const int* __restrict__ uoff,
                       const int* __restrict__ base, Results child,
                       Results mt, float* __restrict__ t_out,
                       int* __restrict__ sid_out, float* __restrict__ u_out,
                       float* __restrict__ v_out) {
  const int u = blockIdx.x;
  if (u >= level[kNext]) return;
  const int lane = threadIdx.x;
  __shared__ int warp_count[kChildren][kWarps];
  const int mask = masks[(size_t)u * kLanes + lane];
  Ranks rk;
  tile_ranks(mask, rk, warp_count);
  __syncthreads();
  const int d = dn[u];
  float best = __int_as_float(0x7f800000), bu = 0.f, bv = 0.f;
  int bs = -1;
#pragma unroll
  for (int c = 0; c < kChildren; ++c) {
    if (!((mask >> c) & 1)) continue;
    const int rec = base[(size_t)d * kChildren + c];
    if (rec < 0) continue;
    const size_t pos = (size_t)(rec & (kMtTag - 1)) * kLanes +
                       uoff[(size_t)u * kChildren + c] +
                       tile_rank(rk, warp_count, c);
    const Results& src = rec >= kMtTag ? mt : child;
    const float tn = src.t[pos];
    const int sn = src.sid[pos];
    if (tn < best || (tn == best && sn < bs)) {
      best = tn;
      bs = sn;
      bu = src.u[pos];
      bv = src.v[pos];
    }
  }
  const size_t i = (size_t)u * kLanes + lane;
  t_out[i] = best;
  sid_out[i] = bs;
  u_out[i] = bu;
  v_out[i] = bv;
}

struct MtLaunch {
  cudaStream_t stream;
  int mt_cap;
  const int* mt_pairs;
  const int* mt_units;
  const int* level;
  const float* rays;
  int n_rays;
  const float* blocks;
  int n_blocks;
  float* t;
  int* sid;
  float* u;
  float* v;
};

template <bool kAnyHit, int kPrec>
void launch_mt(const MtLaunch& l, bool per_tile) {
  if (per_tile) {
    bf_mt_per_tile_kernel<kAnyHit, kPrec><<<l.mt_cap, kLanes, 0, l.stream>>>(
        l.mt_pairs, l.mt_units, l.level, l.rays, l.n_rays, l.blocks,
        l.n_blocks, l.t, l.sid, l.u, l.v);
  } else {
    const int grid = min(
        l.mt_cap, resident_ctas<bf_mt_kernel<kAnyHit, kPrec>, kLanes>());
    bf_mt_kernel<kAnyHit, kPrec><<<grid, kLanes, 0, l.stream>>>(
        l.mt_pairs, l.mt_units, l.level, l.rays, l.n_rays, l.blocks,
        l.n_blocks, l.t, l.sid, l.u, l.v);
  }
}

template <bool kAnyHit>
int mt_by_precision(int prec, const MtLaunch& l, bool per_tile) {
  switch (prec) {
    case kHighest: launch_mt<kAnyHit, kHighest>(l, per_tile); return 0;
    case kHigh: launch_mt<kAnyHit, kHigh>(l, per_tile); return 0;
    case kDefault: launch_mt<kAnyHit, kDefault>(l, per_tile); return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int mt_launch(const MtLaunch& l, int any_hit, int mt_prec, bool per_tile) {
  const int rc = any_hit ? mt_by_precision<true>(mt_prec, l, per_tile)
                         : mt_by_precision<false>(mt_prec, l, per_tile);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry launches its kernels on `cuda_stream` and returns
// cudaGetLastError() (0 on success); none allocates or synchronises. The
// unit counts stay on the device: `level` points to the status row of the
// level before (kStatWords int32; for level 0 a row holding the tile count
// and MT cursor 0), whose kNext word is this level's unit count and kMtCur
// word the MT cursor so far. K10 and the references of K10 and K12
// launch a block per unit of the capacity and the blocks past the count
// return; K12, K13 and K14 launch the CTAs the card holds at once (at most
// what the capacity needs), which take the units up to the count. Pairs
// are int32 ray indices into rays (8, n_rays) f32 [ox, oy, oz, dx, dy, dz,
// tmin, tmax], -1 in a dead lane.

// K10. units (cap_t,) node ids; pairs (cap_t, 128); nodes (n_nodes, 128)
// f32 rows of 16 children x [lo, hi, meta, pad]. Writes masks (cap_t,
// 128) 16-bit child masks and counts (cap_t, 16) per-child lane counts
// of the level's units.
int bf_expand_launch(const int* units, const int* level, int cap_t,
                     const int* pairs, const float* rays, int n_rays,
                     const float* nodes, int n_nodes, int* masks, int* counts,
                     void* cuda_stream) {
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  bf_expand_kernel<<<cap_t, kLanes, 0, stream>>>(
      units, level, pairs, rays, n_rays, nodes, n_nodes, masks, counts);
  return static_cast<int>(cudaGetLastError());
}

// The same through the reference kernel.
int bf_expand_per_block_launch(const int* units, const int* level, int cap_t,
                               const int* pairs, const float* rays,
                               int n_rays, const float* nodes, int n_nodes,
                               int* masks, int* counts, void* cuda_stream) {
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  bf_expand_per_block_kernel<<<cap_t, kLanes, 0, stream>>>(
      units, level, pairs, rays, n_rays, nodes, n_nodes, masks, counts);
  return static_cast<int>(cudaGetLastError());
}

// K11. Writes this level's status row `stat_out`; dn (cap_t,); base
// (cap_t * 16,) per (distinct node, child): the region's first tile, |
// 1 << 30 in the MT list, -1 for none; uoff (cap_t, 16); units_next
// (cap_next,) and mt_units (mt_cap,) over the regions taken; the dead tail
// lanes of each region in pairs_next / mt_pairs. node_id (cap_t,) and
// node_base ((cap_t + 1) * 16,) are scratch. Two launches: the scan block,
// then the fill, a grid sized for the level's cap_t * 16 entries.
int bf_prefix_launch(const int* units, const int* level, const int* counts,
                     const int* meta, int n_nodes, int cap_t, int cap_next,
                     int mt_cap, int* dn, int* base, int* uoff, int* node_id,
                     int* node_base, int* units_next, int* pairs_next,
                     int* mt_units, int* mt_pairs, int* stat_out,
                     void* cuda_stream) {
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  bf_prefix_scan_kernel<<<1, kScanThreads, 0, stream>>>(
      units, level, counts, meta, n_nodes, cap_next, mt_cap, dn, base, uoff,
      node_id, node_base, stat_out);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  // a warp a 32 entries: enough blocks for the level's cap_t * 16 entries
  const int fill = min(kFillBlocks,
                       max(1, (cap_t * kChildren + kFillThreads - 1) /
                                  kFillThreads));
  bf_prefix_fill_kernel<<<fill, kFillThreads, 0, stream>>>(
      meta, n_nodes, base, node_id, node_base, stat_out, units_next,
      pairs_next, mt_units, mt_pairs);
  return static_cast<int>(cudaGetLastError());
}

// K12. Writes each surviving (ray, child) pair's ray index into its
// child's region of pairs_next or mt_pairs.
int bf_emit_launch(const int* pairs, const int* masks, const int* level,
                   int cap_t, const int* dn, const int* uoff, const int* base,
                   int* pairs_next, int* mt_pairs, void* cuda_stream) {
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  const int grid = min(unit_ctas(cap_t),
                       resident_ctas<bf_emit_kernel, kLanes>());
  bf_emit_kernel<<<grid, kLanes, 0, stream>>>(
      pairs, masks, level, dn, uoff, base, pairs_next, mt_pairs);
  return static_cast<int>(cudaGetLastError());
}

// The same through the reference kernel, a block per unit of the capacity.
int bf_emit_per_block_launch(const int* pairs, const int* masks,
                             const int* level, int cap_t, const int* dn,
                             const int* uoff, const int* base,
                             int* pairs_next, int* mt_pairs,
                             void* cuda_stream) {
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  bf_emit_per_block_kernel<<<cap_t, kLanes, 0, stream>>>(
      pairs, masks, level, dn, uoff, base, pairs_next, mt_pairs);
  return static_cast<int>(cudaGetLastError());
}

// K13. mt_pairs (mt_cap, 128), mt_units (mt_cap,) block ids, `level` the
// last level's status row (its MT cursor); blocks (n_blocks, 10, 256) f32.
// Per pair: closest hit t (+inf on a miss), slot id block*64 + slot (-1),
// u, v; any hit t = 0, slot 0 when occluded. mt_prec: 0 highest, 1 high,
// 2 default.
int bf_mt_launch(const int* mt_pairs, const int* mt_units, const int* level,
                 int mt_cap, const float* rays, int n_rays,
                 const float* blocks, int n_blocks, int any_hit, int mt_prec,
                 float* t, int* sid, float* u, float* v, void* cuda_stream) {
  return mt_launch(MtLaunch{static_cast<cudaStream_t>(cuda_stream), mt_cap,
                            mt_pairs, mt_units, level, rays, n_rays, blocks,
                            n_blocks, t, sid, u, v},
                   any_hit, mt_prec, false);
}

// The same through the reference kernel, a CTA per unit of the capacity.
int bf_mt_per_tile_launch(const int* mt_pairs, const int* mt_units,
                          const int* level, int mt_cap, const float* rays,
                          int n_rays, const float* blocks, int n_blocks,
                          int any_hit, int mt_prec, float* t, int* sid,
                          float* u, float* v, void* cuda_stream) {
  return mt_launch(MtLaunch{static_cast<cudaStream_t>(cuda_stream), mt_cap,
                            mt_pairs, mt_units, level, rays, n_rays, blocks,
                            n_blocks, t, sid, u, v},
                   any_hit, mt_prec, true);
}

// K14. child_*: the results of the level below (any valid pointers where
// the level has no inner child), mt_*: K13's. Writes this level's results
// (cap_t * 128 each) for its units.
int bf_bwd_launch(const int* masks, const int* level, int cap_t,
                  const int* dn, const int* uoff, const int* base,
                  const float* child_t, const int* child_sid,
                  const float* child_u, const float* child_v,
                  const float* mt_t, const int* mt_sid, const float* mt_u,
                  const float* mt_v, float* t, int* sid, float* u, float* v,
                  void* cuda_stream) {
  const Results child{child_t, child_sid, child_u, child_v};
  const Results mt{mt_t, mt_sid, mt_u, mt_v};
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  const int grid = min(cap_t, resident_ctas<bf_bwd_kernel, kLanes>());
  bf_bwd_kernel<<<grid, kLanes, 0, stream>>>(
      masks, level, dn, uoff, base, child, mt, t, sid, u, v);
  return static_cast<int>(cudaGetLastError());
}

// The same through the reference kernel, a block per unit of the capacity.
int bf_bwd_per_unit_launch(const int* masks, const int* level, int cap_t,
                           const int* dn, const int* uoff, const int* base,
                           const float* child_t, const int* child_sid,
                           const float* child_u, const float* child_v,
                           const float* mt_t, const int* mt_sid,
                           const float* mt_u, const float* mt_v, float* t,
                           int* sid, float* u, float* v, void* cuda_stream) {
  const Results child{child_t, child_sid, child_u, child_v};
  const Results mt{mt_t, mt_sid, mt_u, mt_v};
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  bf_bwd_per_unit_kernel<<<cap_t, kLanes, 0, stream>>>(
      masks, level, dn, uoff, base, child, mt, t, sid, u, v);
  return static_cast<int>(cudaGetLastError());
}

// The grids of the persistent kernels on this card: out[0], out[1] K13
// closest and any hit at "highest", out[2] K14, out[3] K12 (each launch
// takes at most the CTAs its capacity needs).
int bf_resident_grids(int* out) {
  out[0] = resident_ctas<bf_mt_kernel<false, kHighest>, kLanes>();
  out[1] = resident_ctas<bf_mt_kernel<true, kHighest>, kLanes>();
  out[2] = resident_ctas<bf_bwd_kernel, kLanes>();
  out[3] = resident_ctas<bf_emit_kernel, kLanes>();
  return static_cast<int>(cudaGetLastError());
}

const char* bf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
