// Native binned-SAH BVH builder.
//
// Host-side counterpart of the Metal acceleration-structure build the
// reference gets for free (renderer_pt.cpp:653-749). Emits the same
// threaded (skip-link, DFS-ordered) flat layout as the numpy oracle in
// accel/bvh.py; the Python side binds via ctypes (accel/native.py).
//
// Copy of platinum_tpu/accel/cpp/bvh_builder.cpp, kept in step with it.
// Build: make -C platinum_tpu_torch/accel/cpp OUT=<dir>/libptbvh.so
// (accel/native.py builds it into platinum_tpu_torch/_build/ at first use)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kNumBins = 16;

struct Vec3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity()};
  Vec3 hi{-std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity()};

  void grow(const AABB& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  float half_area() const {
    float ex = std::max(hi.x - lo.x, 0.f);
    float ey = std::max(hi.y - lo.y, 0.f);
    float ez = std::max(hi.z - lo.z, 0.f);
    return ex * ey + ey * ez + ez * ex;
  }
};

struct Node {
  AABB box;
  int32_t left = -1;    // children are (left, left+? ) — right stored too
  int32_t right = -1;
  int64_t first = -1;   // first item index (leaves)
  int32_t count = 0;    // item count (leaves)
  int64_t subtree = 1;  // subtree node count (filled post-build)
};

struct Builder {
  const float* v0;
  const float* v1;
  const float* v2;
  int64_t n;
  int max_leaf;

  std::vector<AABB> tri_box;
  std::vector<Vec3> centroid;
  std::vector<int64_t> items;  // permutation being partitioned in place
  std::vector<Node> nodes;

  void init() {
    tri_box.resize(n);
    centroid.resize(n);
    items.resize(n);
    for (int64_t i = 0; i < n; i++) {
      Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
      Vec3 b{v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]};
      Vec3 c{v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]};
      tri_box[i].lo = vmin(vmin(a, b), c);
      tri_box[i].hi = vmax(vmax(a, b), c);
      centroid[i] = {(tri_box[i].lo.x + tri_box[i].hi.x) * 0.5f,
                     (tri_box[i].lo.y + tri_box[i].hi.y) * 0.5f,
                     (tri_box[i].lo.z + tri_box[i].hi.z) * 0.5f};
      items[i] = i;
    }
    nodes.reserve(2 * n / std::max(1, max_leaf / 2) + 16);
  }

  AABB range_box(int64_t first, int32_t count) const {
    AABB b;
    for (int64_t i = first; i < first + count; i++) b.grow(tri_box[items[i]]);
    return b;
  }

  int32_t build_range(int64_t first, int64_t count) {
    int32_t me = (int32_t)nodes.size();
    nodes.push_back({});
    nodes[me].box = range_box(first, (int32_t)count);

    if (count <= max_leaf) {
      nodes[me].first = first;
      nodes[me].count = (int32_t)count;
      return me;
    }

    // centroid bounds + widest axis
    Vec3 cmin = centroid[items[first]];
    Vec3 cmax = cmin;
    for (int64_t i = first + 1; i < first + count; i++) {
      cmin = vmin(cmin, centroid[items[i]]);
      cmax = vmax(cmax, centroid[items[i]]);
    }
    float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    int widest = ext[1] > ext[0] ? 1 : 0;
    if (ext[2] > ext[widest]) widest = 2;

    // binned SAH over ALL THREE axes (best (axis, bin) pair wins; the
    // widest-axis-only variant measured ~4-7% more packet node visits
    // on the bench scenes — see PERFORMANCE.md tree-quality note)
    int64_t mid = -1;
    double best_cost = std::numeric_limits<double>::infinity();
    int best_axis = -1, best_bin = -1;
    float best_scale = 0.f;
    for (int axis = 0; axis < 3; axis++) {
      if (ext[axis] <= 1e-12f) continue;
      float scale = kNumBins * (1.0f - 1e-6f) / ext[axis];
      AABB bin_box[kNumBins];
      int64_t bin_n[kNumBins] = {0};
      for (int64_t i = first; i < first + count; i++) {
        int b = (int)((centroid[items[i]][axis] - cmin[axis]) * scale);
        bin_box[b].grow(tri_box[items[i]]);
        bin_n[b]++;
      }
      // prefix/suffix sweeps
      float area_l[kNumBins], area_r[kNumBins];
      int64_t n_l[kNumBins], n_r[kNumBins];
      AABB acc;
      int64_t cnt = 0;
      for (int b = 0; b < kNumBins; b++) {
        acc.grow(bin_box[b]);
        cnt += bin_n[b];
        area_l[b] = acc.half_area();
        n_l[b] = cnt;
      }
      acc = AABB();
      cnt = 0;
      for (int b = kNumBins - 1; b >= 0; b--) {
        acc.grow(bin_box[b]);
        cnt += bin_n[b];
        area_r[b] = acc.half_area();
        n_r[b] = cnt;
      }
      for (int b = 0; b < kNumBins - 1; b++) {
        if (n_l[b] == 0 || n_r[b + 1] == 0) continue;
        double cost =
            (double)area_l[b] * n_l[b] + (double)area_r[b + 1] * n_r[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
          best_scale = scale;
        }
      }
    }
    if (best_axis >= 0) {
      int axis = best_axis;
      float scale = best_scale;
      int best = best_bin;
      auto it = std::partition(
          items.begin() + first, items.begin() + first + count,
          [&](int64_t t) {
            int b = (int)((centroid[t][axis] - cmin[axis]) * scale);
            return b <= best;
          });
      mid = it - items.begin();
      if (mid == first || mid == first + count) mid = -1;
    }
    if (mid < 0) {
      // median fallback on the widest axis
      int axis = widest;
      mid = first + count / 2;
      std::nth_element(items.begin() + first, items.begin() + mid,
                       items.begin() + first + count, [&](int64_t a, int64_t b) {
                         return centroid[a][axis] < centroid[b][axis];
                       });
    }

    int32_t left = build_range(first, mid - first);
    int32_t right = build_range(mid, first + count - mid);
    nodes[me].left = left;
    nodes[me].right = right;
    nodes[me].subtree = 1 + nodes[left].subtree + nodes[right].subtree;
    return me;
  }
};

struct Exported {
  std::vector<float> bounds_lo, bounds_hi;
  std::vector<int32_t> skip, tri_start, tri_count;
  std::vector<int64_t> tri_order;
};

}  // namespace

extern "C" {

// Returns an opaque handle; *out_n_nodes receives the node count.
void* ptbvh_build(const float* v0, const float* v1, const float* v2,
                  int64_t n_tris, int32_t max_leaf, int64_t* out_n_nodes) {
  Builder b{v0, v1, v2, n_tris, max_leaf};
  b.init();
  b.build_range(0, n_tris);

  auto* out = new Exported();
  size_t count = b.nodes.size();
  out->bounds_lo.resize(3 * count);
  out->bounds_hi.resize(3 * count);
  out->skip.resize(count);
  out->tri_start.assign(count, -1);
  out->tri_count.assign(count, 0);
  out->tri_order.resize(n_tris);

  // DFS emit with skip = dfs_index + subtree_size
  std::vector<int32_t> stack{0};
  std::vector<int32_t> dfs_of(count);
  int32_t out_idx = 0;
  int64_t tri_cursor = 0;
  while (!stack.empty()) {
    int32_t node = stack.back();
    stack.pop_back();
    int32_t me = out_idx++;
    dfs_of[node] = me;
    const Node& nd = b.nodes[node];
    out->bounds_lo[3 * me] = nd.box.lo.x;
    out->bounds_lo[3 * me + 1] = nd.box.lo.y;
    out->bounds_lo[3 * me + 2] = nd.box.lo.z;
    out->bounds_hi[3 * me] = nd.box.hi.x;
    out->bounds_hi[3 * me + 1] = nd.box.hi.y;
    out->bounds_hi[3 * me + 2] = nd.box.hi.z;
    out->skip[me] = me + (int32_t)nd.subtree;
    if (nd.count > 0) {
      out->tri_start[me] = (int32_t)tri_cursor;
      out->tri_count[me] = nd.count;
      std::memcpy(&out->tri_order[tri_cursor], &b.items[nd.first],
                  nd.count * sizeof(int64_t));
      tri_cursor += nd.count;
    } else {
      stack.push_back(nd.right);
      stack.push_back(nd.left);
    }
  }

  *out_n_nodes = (int64_t)count;
  return out;
}

void ptbvh_export(void* handle, float* bounds_lo, float* bounds_hi,
                  int32_t* skip, int32_t* tri_start, int32_t* tri_count,
                  int64_t* tri_order) {
  auto* e = static_cast<Exported*>(handle);
  std::memcpy(bounds_lo, e->bounds_lo.data(), e->bounds_lo.size() * 4);
  std::memcpy(bounds_hi, e->bounds_hi.data(), e->bounds_hi.size() * 4);
  std::memcpy(skip, e->skip.data(), e->skip.size() * 4);
  std::memcpy(tri_start, e->tri_start.data(), e->tri_start.size() * 4);
  std::memcpy(tri_count, e->tri_count.data(), e->tri_count.size() * 4);
  std::memcpy(tri_order, e->tri_order.data(), e->tri_order.size() * 8);
}

void ptbvh_free(void* handle) { delete static_cast<Exported*>(handle); }

}  // extern "C"
