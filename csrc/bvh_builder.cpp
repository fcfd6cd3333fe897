// Native BVH builder.
//
// The reference builds its acceleration structure natively (Rust HLBVH with
// Morton encoding across worker threads, bvh.rs:307-751).  This C++ builder
// is the equivalent host-side native component here: a binned-SAH
// recursive build (12 buckets, like the reference's upper-SAH stage)
// emitting the flattened DFS node array the device traversal consumes
// directly:
//
//   interior node i: left child = i+1, right child = offset[i]
//   leaf node i:     primitives prim_order[offset[i] .. offset[i]+n_prims[i])
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).
//
// Build: make -C csrc   (produces libbvh.so)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Bounds {
  Vec3 lo{std::numeric_limits<double>::infinity(),
          std::numeric_limits<double>::infinity(),
          std::numeric_limits<double>::infinity()};
  Vec3 hi{-std::numeric_limits<double>::infinity(),
          -std::numeric_limits<double>::infinity(),
          -std::numeric_limits<double>::infinity()};
  void extend(const Bounds &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void extend(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  double surface_area() const {
    double dx = std::max(hi.x - lo.x, 0.0);
    double dy = std::max(hi.y - lo.y, 0.0);
    double dz = std::max(hi.z - lo.z, 0.0);
    return 2.0 * (dx * dy + dy * dz + dz * dx);
  }
  int max_extent() const {
    double dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
    if (dx >= dy && dx >= dz) return 0;
    return dy >= dz ? 1 : 2;
  }
};

struct Node {
  Bounds b;
  int offset = -1;   // interior: right child; leaf: prim start
  int n_prims = 0;   // 0 for interior
  int axis = 0;
};

constexpr int kBuckets = 12;

struct Builder {
  const double *lo;
  const double *hi;
  int max_leaf;
  std::vector<Vec3> centroid;
  std::vector<Node> nodes;
  std::vector<int> order;

  Bounds prim_bounds(int i) const {
    Bounds b;
    b.lo = {lo[3 * i], lo[3 * i + 1], lo[3 * i + 2]};
    b.hi = {hi[3 * i], hi[3 * i + 1], hi[3 * i + 2]};
    return b;
  }

  static double axis_of(const Vec3 &v, int a) {
    return a == 0 ? v.x : (a == 1 ? v.y : v.z);
  }

  // Iterative build with an explicit stack (no recursion-depth limits).
  struct Task {
    int begin, end;     // range in ids
    int parent;         // node index whose offset needs this subtree root
  };

  std::vector<Task> pending_;

  int emit(std::vector<int> &ids, const Task &t) {
    int n = t.end - t.begin;
    Bounds bounds, cbounds;
    for (int k = t.begin; k < t.end; ++k) {
      bounds.extend(prim_bounds(ids[k]));
      cbounds.extend(centroid[ids[k]]);
    }
    int node_idx = (int)nodes.size();
    nodes.emplace_back();
    nodes[node_idx].b = bounds;

    auto make_leaf = [&]() {
      nodes[node_idx].offset = (int)order.size();
      nodes[node_idx].n_prims = n;
      for (int k = t.begin; k < t.end; ++k) order.push_back(ids[k]);
    };

    if (n <= max_leaf) {
      make_leaf();
      return node_idx;
    }
    int dim = cbounds.max_extent();
    double cmin = axis_of(cbounds.lo, dim), cmax = axis_of(cbounds.hi, dim);
    if (cmax - cmin < 1e-12) {
      // coincident centroids: median-split until leaves fit max_leaf
      // (device traversal statically unrolls max_leaf prim tests; an
      // oversized leaf would silently drop intersections)
      int mid = t.begin + n / 2;
      nodes[node_idx].axis = dim;
      nodes[node_idx].n_prims = 0;
      pending_.push_back({mid, t.end, node_idx});
      pending_.push_back({t.begin, mid, -2 - node_idx});
      return node_idx;
    }

    // binned SAH
    int counts[kBuckets] = {0};
    Bounds bb[kBuckets];
    auto bucket_of = [&](int id) {
      double rel = (axis_of(centroid[id], dim) - cmin) / (cmax - cmin);
      int b = (int)(rel * kBuckets);
      return std::min(b, kBuckets - 1);
    };
    for (int k = t.begin; k < t.end; ++k) {
      int b = bucket_of(ids[k]);
      counts[b]++;
      bb[b].extend(prim_bounds(ids[k]));
    }
    double total_sa = bounds.surface_area();
    double best_cost = std::numeric_limits<double>::infinity();
    int best_split = -1;
    for (int s = 0; s < kBuckets - 1; ++s) {
      int nl = 0, nr = 0;
      Bounds bl, br;
      for (int k = 0; k <= s; ++k) {
        nl += counts[k];
        bl.extend(bb[k]);
      }
      for (int k = s + 1; k < kBuckets; ++k) {
        nr += counts[k];
        br.extend(bb[k]);
      }
      if (nl == 0 || nr == 0) continue;
      double cost =
          0.125 + (nl * bl.surface_area() + nr * br.surface_area()) /
                      std::max(total_sa, 1e-30);
      if (cost < best_cost) {
        best_cost = cost;
        best_split = s;
      }
    }

    int mid;
    if (best_split < 0) {
      // degenerate: median split
      mid = t.begin + n / 2;
      std::nth_element(ids.begin() + t.begin, ids.begin() + mid,
                       ids.begin() + t.end, [&](int a, int b) {
                         return axis_of(centroid[a], dim) <
                                axis_of(centroid[b], dim);
                       });
    } else {
      auto it = std::partition(
          ids.begin() + t.begin, ids.begin() + t.end,
          [&](int id) { return bucket_of(id) <= best_split; });
      mid = (int)(it - ids.begin());
      if (mid == t.begin || mid == t.end) mid = t.begin + n / 2;
    }
    nodes[node_idx].axis = dim;
    nodes[node_idx].n_prims = 0;
    // DFS order: left subtree immediately follows; right root recorded in
    // offset by the task mechanism.  Push right first so left pops first.
    pending_.push_back({mid, t.end, node_idx});
    pending_.push_back({t.begin, mid, -2 - node_idx});  // marker: left child
    return node_idx;
  }
};

}  // namespace

extern "C" {

// Returns number of nodes, or -1 on error.  Output arrays must be sized for
// 2*n_prims nodes and n_prims order entries.
int bvh_build_sah(const double *prim_lo, const double *prim_hi, int n_prims,
                  int max_prims_in_node, float *node_min, float *node_max,
                  int *offset, int *n_prims_out, int *axis_out,
                  int *prim_order) {
  if (n_prims <= 0) return -1;
  Builder b;
  b.lo = prim_lo;
  b.hi = prim_hi;
  b.max_leaf = std::max(1, max_prims_in_node);
  b.centroid.resize(n_prims);
  for (int i = 0; i < n_prims; ++i) {
    b.centroid[i] = {0.5 * (prim_lo[3 * i] + prim_hi[3 * i]),
                     0.5 * (prim_lo[3 * i + 1] + prim_hi[3 * i + 1]),
                     0.5 * (prim_lo[3 * i + 2] + prim_hi[3 * i + 2])};
  }
  b.nodes.reserve(2 * n_prims);
  b.order.reserve(n_prims);

  // DFS order (left subtree contiguous after its parent) requires the left
  // task to pop before the right: emit() fills pending_ = {right, left};
  // forward push puts left on top.  Left children need no offset write
  // (left = parent+1 in the flat layout) — marked with parent <= -2.
  std::vector<int> ids(n_prims);
  for (int i = 0; i < n_prims; ++i) ids[i] = i;

  std::vector<Builder::Task> stack;
  stack.push_back({0, n_prims, -1});
  while (!stack.empty()) {
    Builder::Task t = stack.back();
    stack.pop_back();
    int node_idx = b.emit(ids, t);
    if (t.parent >= 0) b.nodes[t.parent].offset = node_idx;
    for (auto &c : b.pending_) {
      Builder::Task task = c;
      if (task.parent <= -2) task.parent = -1;
      stack.push_back(task);
    }
    b.pending_.clear();
  }

  int m = (int)b.nodes.size();
  for (int i = 0; i < m; ++i) {
    node_min[3 * i] = (float)b.nodes[i].b.lo.x;
    node_min[3 * i + 1] = (float)b.nodes[i].b.lo.y;
    node_min[3 * i + 2] = (float)b.nodes[i].b.lo.z;
    node_max[3 * i] = (float)b.nodes[i].b.hi.x;
    node_max[3 * i + 1] = (float)b.nodes[i].b.hi.y;
    node_max[3 * i + 2] = (float)b.nodes[i].b.hi.z;
    offset[i] = b.nodes[i].offset;
    n_prims_out[i] = b.nodes[i].n_prims;
    axis_out[i] = b.nodes[i].axis;
  }
  std::memcpy(prim_order, b.order.data(), sizeof(int) * n_prims);
  return m;
}
}
