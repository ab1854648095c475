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
// - The level's unit count stays on the device (K11's status row): K10,
//   K12 and K14 launch one 128-thread block per unit of the level's
//   capacity and the blocks past the count return at once, so a wave
//   needs no host sync until its end.
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
// - K13 stages the unit's 64-triangle block in shared memory once and
//   tests each lane's ray against it with mt_block.cuh's block test,
//   forming the features itself from the gathered ray, so that a (ray,
//   triangle) pair's t is the packet kernel's to the bit.
// - K14 gathers, for each pair, its children's results by the same ranks
//   and offsets and keeps the least (t, slot id) pair: a gather, no
//   atomics, deterministic. Level 0's pairs are the segment's rays in
//   order, so its results are the segment's.
//
// What bounds them on this card: K13 does the work (5,120 FLOP per live
// pair at "highest" against a 10 KB block read once per tile); K10 reads
// a 512 B node per tile and 32 B per lane and does 16 slab tests of 12
// FLOP per lane; K12 and K14 move 4 B and 16 B per pair and child; K11
// moves a few MB (its bound is ~1 us) but its scan is one block whose
// passes are chains of barriers and dependent reads (on an H100 about 20
// us a level, 13 of them the scan, even for a level of one node).

#include "mt_block.cuh"

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
// K10: one block per unit (a node x a tile of its pairs); each thread
// slab-tests its lane's ray against the node's 16 children.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kLanes)
bf_expand_kernel(const int* __restrict__ units, const int* __restrict__ level,
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

struct Ranks {
  int below[kChildren];   // lanes of the warp below this one with bit c
};

// Warp ballots of every child bit; the per-warp counts go to `warp_count`
// (the caller synchronises before reading them).
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
bf_emit_kernel(const int* __restrict__ pairs, const int* __restrict__ masks,
               const int* __restrict__ level, const int* __restrict__ dn,
               const int* __restrict__ uoff, const int* __restrict__ base,
               int* __restrict__ pairs_next, int* __restrict__ mt_pairs) {
  const int u = blockIdx.x;
  if (u >= level[kNext]) return;
  const int lane = threadIdx.x;
  __shared__ int warp_count[kChildren][kWarps];
  const int mask = masks[(size_t)u * kLanes + lane];
  const int r = pairs[(size_t)u * kLanes + lane];
  Ranks rk;
  tile_ranks(mask, rk, warp_count);
  __syncthreads();
  const int d = dn[u];
#pragma unroll
  for (int c = 0; c < kChildren; ++c) {
    if (!((mask >> c) & 1)) continue;
    const int rec = base[(size_t)d * kChildren + c];
    if (rec < 0) continue;
    const size_t pos = (size_t)(rec & (kMtTag - 1)) * kLanes +
                       uoff[(size_t)u * kChildren + c] +
                       tile_rank(rk, warp_count, c);
    (rec >= kMtTag ? mt_pairs : pairs_next)[pos] = r;
  }
}

// ---------------------------------------------------------------------------
// K13: one block per MT unit (a leaf block x a tile of its pairs).
// ---------------------------------------------------------------------------

template <bool kAnyHit, int kPrec>
__global__ void __launch_bounds__(kLanes)
bf_mt_kernel(const int* __restrict__ mt_pairs, const int* __restrict__ mt_units,
             const int* __restrict__ level, const float* __restrict__ rays,
             int n_rays, const float* __restrict__ blocks, int n_blocks,
             float* __restrict__ t_out, int* __restrict__ sid_out,
             float* __restrict__ u_out, float* __restrict__ v_out) {
  const int u = blockIdx.x;
  if (u >= level[kMtCur]) return;
  const int lane = threadIdx.x;
  __shared__ __align__(16) float blk[kBlockFloats];
  const int b = min(max(mt_units[u], 0), n_blocks - 1);
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
// K14: one block per unit; each lane keeps the least (t, slot id) of its
// children's results, inner children from the level below, leaf children
// from K13.
// ---------------------------------------------------------------------------

struct Results {
  const float* t;
  const int* sid;
  const float* u;
  const float* v;
};

__global__ void __launch_bounds__(kLanes)
bf_bwd_kernel(const int* __restrict__ masks, const int* __restrict__ level,
              const int* __restrict__ dn, const int* __restrict__ uoff,
              const int* __restrict__ base, Results child, Results mt,
              float* __restrict__ t_out, int* __restrict__ sid_out,
              float* __restrict__ u_out, float* __restrict__ v_out) {
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

template <bool kAnyHit>
int launch_mt(int prec, dim3 grid, cudaStream_t stream, const int* mt_pairs,
              const int* mt_units, const int* level, const float* rays,
              int n_rays, const float* blocks, int n_blocks, float* t,
              int* sid, float* u, float* v) {
  switch (prec) {
    case kHighest:
      bf_mt_kernel<kAnyHit, kHighest><<<grid, kLanes, 0, stream>>>(
          mt_pairs, mt_units, level, rays, n_rays, blocks, n_blocks, t, sid,
          u, v);
      return 0;
    case kHigh:
      bf_mt_kernel<kAnyHit, kHigh><<<grid, kLanes, 0, stream>>>(
          mt_pairs, mt_units, level, rays, n_rays, blocks, n_blocks, t, sid,
          u, v);
      return 0;
    case kDefault:
      bf_mt_kernel<kAnyHit, kDefault><<<grid, kLanes, 0, stream>>>(
          mt_pairs, mt_units, level, rays, n_rays, blocks, n_blocks, t, sid,
          u, v);
      return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Every entry launches one kernel on `cuda_stream` and returns
// cudaGetLastError() (0 on success); none allocates or synchronises. The
// unit counts stay on the device: `level` points to the status row of the
// level before (kStatWords int32; for level 0 a row holding the tile count
// and MT cursor 0), whose kNext word is this level's unit count and kMtCur
// word the MT cursor so far. Grids cover the capacity and blocks past the
// count return. Pairs are int32 ray indices into rays (8, n_rays) f32
// [ox, oy, oz, dx, dy, dz, tmin, tmax], -1 in a dead lane.

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
  bf_emit_kernel<<<cap_t, kLanes, 0, stream>>>(
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
  const dim3 grid(mt_cap);
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  const int rc =
      any_hit ? launch_mt<true>(mt_prec, grid, stream, mt_pairs, mt_units,
                                level, rays, n_rays, blocks, n_blocks, t, sid,
                                u, v)
              : launch_mt<false>(mt_prec, grid, stream, mt_pairs, mt_units,
                                 level, rays, n_rays, blocks, n_blocks, t,
                                 sid, u, v);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
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
  bf_bwd_kernel<<<cap_t, kLanes, 0, stream>>>(
      masks, level, dn, uoff, base, child, mt, t, sid, u, v);
  return static_cast<int>(cudaGetLastError());
}

const char* bf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
