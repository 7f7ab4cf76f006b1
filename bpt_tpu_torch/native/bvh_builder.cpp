// Native BVH builder for bpt_tpu.
//
// C-ABI shared library invoked from Python via ctypes
// (bpt_tpu/native/native.py).  Produces exactly the same flat threaded
// (skip-link) BVH layout as the numpy builder in bpt_tpu/accel/build.py:
// preorder nodes, midpoint split on the longest centroid-extent axis,
// leaf size 4 (matching the reference's vendored Fast-BVH behavior,
// reference: externals/bvh.h:121,149-241), miss links = preorder subtree
// end.  The numpy builder remains the correctness reference; this exists
// for large scenes where Python-recursion build time matters.
//
// Build: make -C bpt_tpu/native   (produces libbpt_native.so)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kLeafSize = 4;

struct Builder {
  const float* v0;
  const float* v1;
  const float* v2;
  std::vector<double> lo;        // (T,3) triangle bbox min
  std::vector<double> hi;        // (T,3) triangle bbox max
  std::vector<double> centroid;  // (T,3)
  std::vector<int64_t> order;    // permutation, new -> old

  std::vector<float> bmin, bmax;  // (N,3)
  std::vector<int32_t> miss, start, count;

  explicit Builder(int64_t t, const float* a, const float* b,
                   const float* c)
      : v0(a), v1(b), v2(c), lo(3 * t), hi(3 * t), centroid(3 * t),
        order(t) {
    for (int64_t i = 0; i < t; ++i) {
      order[i] = i;
      for (int k = 0; k < 3; ++k) {
        const double x0 = a[3 * i + k];
        const double x1 = b[3 * i + k];
        const double x2 = c[3 * i + k];
        lo[3 * i + k] = std::min(x0, std::min(x1, x2));
        hi[3 * i + k] = std::max(x0, std::max(x1, x2));
        centroid[3 * i + k] = (x0 + x1 + x2) / 3.0;
      }
    }
  }

  // Iterative preorder build with an explicit frame stack; the miss link
  // of node i is patched to the node count after its subtree is emitted.
  void build(int64_t t) {
    struct Frame {
      int64_t lo_r, hi_r;
      int32_t node;   // -1 = not yet emitted
      bool second;    // children pushed, awaiting miss patch
    };
    std::vector<Frame> stack;
    stack.push_back({0, t, -1, false});
    while (!stack.empty()) {
      Frame f = stack.back();
      stack.pop_back();
      if (f.second) {
        miss[f.node] = static_cast<int32_t>(bmin.size() / 3);
        continue;
      }
      const int32_t node = static_cast<int32_t>(bmin.size() / 3);
      double bl[3] = {1e300, 1e300, 1e300};
      double bh[3] = {-1e300, -1e300, -1e300};
      for (int64_t i = f.lo_r; i < f.hi_r; ++i) {
        const int64_t p = order[i];
        for (int k = 0; k < 3; ++k) {
          bl[k] = std::min(bl[k], lo[3 * p + k]);
          bh[k] = std::max(bh[k], hi[3 * p + k]);
        }
      }
      for (int k = 0; k < 3; ++k) {
        bmin.push_back(static_cast<float>(bl[k]));
        bmax.push_back(static_cast<float>(bh[k]));
      }
      miss.push_back(0);
      start.push_back(0);
      count.push_back(0);

      const int64_t n = f.hi_r - f.lo_r;
      bool leaf = n <= kLeafSize;
      int64_t mid = 0;
      if (!leaf) {
        double cmin[3] = {1e300, 1e300, 1e300};
        double cmax[3] = {-1e300, -1e300, -1e300};
        for (int64_t i = f.lo_r; i < f.hi_r; ++i) {
          const int64_t p = order[i];
          for (int k = 0; k < 3; ++k) {
            cmin[k] = std::min(cmin[k], centroid[3 * p + k]);
            cmax[k] = std::max(cmax[k], centroid[3 * p + k]);
          }
        }
        int axis = 0;
        double ext = cmax[0] - cmin[0];
        for (int k = 1; k < 3; ++k) {
          if (cmax[k] - cmin[k] > ext) {
            ext = cmax[k] - cmin[k];
            axis = k;
          }
        }
        const double split = 0.5 * (cmin[axis] + cmax[axis]);
        auto* base = order.data();
        auto* pivot = std::stable_partition(
            base + f.lo_r, base + f.hi_r,
            [&](int64_t p) { return centroid[3 * p + axis] < split; });
        mid = pivot - base;
        if (mid == f.lo_r || mid == f.hi_r) leaf = true;
      }
      if (leaf) {
        start[node] = static_cast<int32_t>(f.lo_r);
        count[node] = static_cast<int32_t>(n);
        miss[node] = node + 1;
      } else {
        // Patch frame (LIFO): runs after both children complete.
        stack.push_back({0, 0, node, true});
        stack.push_back({mid, f.hi_r, -1, false});
        stack.push_back({f.lo_r, mid, -1, false});
      }
    }
  }
};

Builder* g_last = nullptr;

}  // namespace

extern "C" {

// Builds the BVH; returns the node count.  Call bpt_bvh_export to copy the
// arrays out, then bpt_bvh_free.
int64_t bpt_bvh_build(int64_t n_tris, const float* v0, const float* v1,
                      const float* v2) {
  delete g_last;
  g_last = new Builder(n_tris, v0, v1, v2);
  if (n_tris > 0) g_last->build(n_tris);
  return static_cast<int64_t>(g_last->bmin.size() / 3);
}

void bpt_bvh_export(float* bmin, float* bmax, int32_t* miss, int32_t* start,
                    int32_t* count, int32_t* prim_order) {
  if (!g_last) return;
  const size_t n = g_last->miss.size();
  std::memcpy(bmin, g_last->bmin.data(), 3 * n * sizeof(float));
  std::memcpy(bmax, g_last->bmax.data(), 3 * n * sizeof(float));
  std::memcpy(miss, g_last->miss.data(), n * sizeof(int32_t));
  std::memcpy(start, g_last->start.data(), n * sizeof(int32_t));
  std::memcpy(count, g_last->count.data(), n * sizeof(int32_t));
  for (size_t i = 0; i < g_last->order.size(); ++i)
    prim_order[i] = static_cast<int32_t>(g_last->order[i]);
}

void bpt_bvh_free() {
  delete g_last;
  g_last = nullptr;
}

}  // extern "C"
