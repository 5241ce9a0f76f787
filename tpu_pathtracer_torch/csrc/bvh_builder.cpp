// Native binned-SAH BVH builder of the PyTorch port.
//
// The port's own copy of native/bvh_builder.cpp: the same source, built
// with the same flags (tpu_pathtracer_torch/native.py), so that both
// packages build the same tree for the same triangle boxes.  The algorithm
// and output contract are those of the numpy builder in
// tpu_pathtracer_torch/scene/bvh.py: 16-bin SAH, COST_NODE=1,
// COST_LEAF_ITEM=1, leaves <= 4 items, flat SoA output (bounds_min/max,
// left, right, count, order).  Exposed through a plain C ABI for ctypes.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int N_BINS = 16;
constexpr int MAX_LEAF_SIZE = 4;
constexpr float COST_NODE = 1.0f;
constexpr float COST_LEAF_ITEM = 1.0f;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

inline double half_area(const Vec3& lo, const Vec3& hi) {
  double dx = std::max(0.0f, hi.x - lo.x);
  double dy = std::max(0.0f, hi.y - lo.y);
  double dz = std::max(0.0f, hi.z - lo.z);
  return dx * dy + dy * dz + dz * dx;
}

inline float axis_of(const Vec3& v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}

struct Builder {
  const Vec3* tri_min;
  const Vec3* tri_max;
  std::vector<Vec3> centroid;
  std::vector<int32_t> order;

  std::vector<Vec3> node_min, node_max;
  std::vector<int32_t> left, right, count;
  int depth = 0;

  int new_node() {
    node_min.push_back({0, 0, 0});
    node_max.push_back({0, 0, 0});
    left.push_back(-1);
    right.push_back(-1);
    count.push_back(0);
    return static_cast<int>(left.size()) - 1;
  }

  struct Task {
    int node, start, end, depth;
  };

  void build(int n) {
    centroid.resize(n);
    order.resize(n);
    for (int i = 0; i < n; ++i) {
      order[i] = i;
      centroid[i] = {0.5f * (tri_min[i].x + tri_max[i].x),
                     0.5f * (tri_min[i].y + tri_max[i].y),
                     0.5f * (tri_min[i].z + tri_max[i].z)};
    }
    int root = new_node();
    std::vector<Task> stack;
    stack.push_back({root, 0, n, 0});

    while (!stack.empty()) {
      Task t = stack.back();
      stack.pop_back();
      depth = std::max(depth, t.depth);
      int n_items = t.end - t.start;

      Vec3 bmin = {std::numeric_limits<float>::infinity(),
                   std::numeric_limits<float>::infinity(),
                   std::numeric_limits<float>::infinity()};
      Vec3 bmax = {-std::numeric_limits<float>::infinity(),
                   -std::numeric_limits<float>::infinity(),
                   -std::numeric_limits<float>::infinity()};
      Vec3 cmin = bmin, cmax = bmax;
      for (int i = t.start; i < t.end; ++i) {
        int id = order[i];
        bmin = vmin(bmin, tri_min[id]);
        bmax = vmax(bmax, tri_max[id]);
        cmin = vmin(cmin, centroid[id]);
        cmax = vmax(cmax, centroid[id]);
      }
      node_min[t.node] = bmin;
      node_max[t.node] = bmax;

      if (n_items <= 1) {
        left[t.node] = t.start;
        count[t.node] = n_items;
        continue;
      }

      // binned SAH over centroid extent, all three axes
      double area_parent = half_area(bmin, bmax);
      double best_cost = std::numeric_limits<double>::infinity();
      int best_axis = -1, best_bin = -1;

      Vec3 extent = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
      int bin_of[3] = {0, 0, 0};  // silence unused warnings
      (void)bin_of;
      std::vector<int> bins(n_items);

      for (int axis = 0; axis < 3; ++axis) {
        float ext = axis_of(extent, axis);
        if (ext <= 1e-12f) continue;
        float scale = N_BINS * (1.0f - 1e-6f) / ext;
        int counts[N_BINS] = {0};
        Vec3 bb_min[N_BINS], bb_max[N_BINS];
        for (int b = 0; b < N_BINS; ++b) {
          bb_min[b] = {std::numeric_limits<float>::infinity(),
                       std::numeric_limits<float>::infinity(),
                       std::numeric_limits<float>::infinity()};
          bb_max[b] = {-std::numeric_limits<float>::infinity(),
                       -std::numeric_limits<float>::infinity(),
                       -std::numeric_limits<float>::infinity()};
        }
        for (int i = 0; i < n_items; ++i) {
          int id = order[t.start + i];
          int b = static_cast<int>((axis_of(centroid[id], axis) -
                                    axis_of(cmin, axis)) * scale);
          b = std::clamp(b, 0, N_BINS - 1);
          counts[b]++;
          bb_min[b] = vmin(bb_min[b], tri_min[id]);
          bb_max[b] = vmax(bb_max[b], tri_max[id]);
        }
        // prefix / suffix sweeps
        Vec3 lmin[N_BINS], lmax[N_BINS], rmin[N_BINS], rmax[N_BINS];
        int lcnt[N_BINS];
        Vec3 acc_min = bb_min[0], acc_max = bb_max[0];
        int acc_cnt = 0;
        for (int b = 0; b < N_BINS; ++b) {
          acc_min = (b == 0) ? bb_min[0] : vmin(acc_min, bb_min[b]);
          acc_max = (b == 0) ? bb_max[0] : vmax(acc_max, bb_max[b]);
          acc_cnt += counts[b];
          lmin[b] = acc_min;
          lmax[b] = acc_max;
          lcnt[b] = acc_cnt;
        }
        acc_min = bb_min[N_BINS - 1];
        acc_max = bb_max[N_BINS - 1];
        for (int b = N_BINS - 1; b >= 0; --b) {
          acc_min = (b == N_BINS - 1) ? bb_min[b] : vmin(acc_min, bb_min[b]);
          acc_max = (b == N_BINS - 1) ? bb_max[b] : vmax(acc_max, bb_max[b]);
          rmin[b] = acc_min;
          rmax[b] = acc_max;
        }
        for (int k = 0; k < N_BINS - 1; ++k) {
          int lc = lcnt[k];
          int rc = n_items - lc;
          if (lc == 0 || rc == 0) continue;
          double cost = COST_NODE + COST_LEAF_ITEM *
              (half_area(lmin[k], lmax[k]) / area_parent * lc +
               half_area(rmin[k + 1], rmax[k + 1]) / area_parent * rc);
          if (cost < best_cost) {
            best_cost = cost;
            best_axis = axis;
            best_bin = k;
          }
        }
      }

      double leaf_cost = COST_LEAF_ITEM * n_items;
      if (best_axis < 0 ||
          (best_cost >= leaf_cost && n_items <= MAX_LEAF_SIZE)) {
        if (best_axis < 0 && n_items > MAX_LEAF_SIZE) {
          // all centroids identical: median split
          int mid = t.start + n_items / 2;
          int l_id = new_node();
          int r_id = new_node();
          left[t.node] = l_id;
          right[t.node] = r_id;
          count[t.node] = 0;
          stack.push_back({l_id, t.start, mid, t.depth + 1});
          stack.push_back({r_id, mid, t.end, t.depth + 1});
          continue;
        }
        left[t.node] = t.start;
        count[t.node] = n_items;
        continue;
      }

      // partition by chosen bin (stable, matching the Python builder)
      int mid;
      {
        float ext = axis_of(extent, best_axis);
        float scale = N_BINS * (1.0f - 1e-6f) / ext;
        std::vector<int32_t> lo, hi;
        lo.reserve(n_items);
        hi.reserve(n_items);
        for (int i = 0; i < n_items; ++i) {
          int id = order[t.start + i];
          int b = static_cast<int>((axis_of(centroid[id], best_axis) -
                                    axis_of(cmin, best_axis)) * scale);
          b = std::clamp(b, 0, N_BINS - 1);
          (b <= best_bin ? lo : hi).push_back(id);
        }
        std::memcpy(&order[t.start], lo.data(), lo.size() * sizeof(int32_t));
        std::memcpy(&order[t.start + lo.size()], hi.data(),
                    hi.size() * sizeof(int32_t));
        mid = t.start + static_cast<int>(lo.size());
        if (mid == t.start || mid == t.end) mid = t.start + n_items / 2;
      }

      int l_id = new_node();
      int r_id = new_node();
      left[t.node] = l_id;
      right[t.node] = r_id;
      count[t.node] = 0;
      stack.push_back({l_id, t.start, mid, t.depth + 1});
      stack.push_back({r_id, mid, t.end, t.depth + 1});
    }
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 if max_nodes was too small.
// Caller allocates bounds_min/bounds_max as (max_nodes, 3) f32 and
// left/right/count as (max_nodes,) i32; order as (n,) i32.
int tpt_build_bvh(const float* tri_min, const float* tri_max, int n,
                  float* bounds_min, float* bounds_max, int32_t* left,
                  int32_t* right, int32_t* count, int32_t* order,
                  int32_t* depth_out, int max_nodes) {
  if (n <= 0) return 0;
  Builder b;
  b.tri_min = reinterpret_cast<const Vec3*>(tri_min);
  b.tri_max = reinterpret_cast<const Vec3*>(tri_max);
  b.build(n);
  int n_nodes = static_cast<int>(b.left.size());
  if (n_nodes > max_nodes) return -1;
  std::memcpy(bounds_min, b.node_min.data(), n_nodes * sizeof(Vec3));
  std::memcpy(bounds_max, b.node_max.data(), n_nodes * sizeof(Vec3));
  std::memcpy(left, b.left.data(), n_nodes * sizeof(int32_t));
  std::memcpy(right, b.right.data(), n_nodes * sizeof(int32_t));
  std::memcpy(count, b.count.data(), n_nodes * sizeof(int32_t));
  std::memcpy(order, b.order.data(), n * sizeof(int32_t));
  *depth_out = b.depth;
  return n_nodes;
}

}  // extern "C"
