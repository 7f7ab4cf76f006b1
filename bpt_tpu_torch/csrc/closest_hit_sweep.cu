// K6: closest hit with one treelet visit order shared by a tile of 128
// consecutive lanes, one block per tile.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_sweep.py::_closest_kernel /
// _closest_body (entry trace_closest_sweep).  What it computes: the tile
// visits the treelets that any of its lanes overlaps (dead lanes
// included) in order of their minimum entry over the tile's lanes, the
// lowest index first on an equal entry; a live lane tests the visited
// treelet only if its own entry, max(tnear, 0), is below its t_best.  The
// triangle rules are K1's (|det| >= EPSILON, t > T_MIN_HIT, min_t <= t <=
// min(t_best, max_t), lowest slot on an equal t within a treelet, strict
// `<` to improve), so the hit's t is K1's; where two triangles of
// different treelets give exactly the same t, K6 keeps the one its tile
// reached first.  A dead lane (max_t < min_t) and a miss return
// (inf, -1, 0, 0).
//
// Design.  Visiting a treelet leaves the other treelets' tile minima as
// they are, so the whole visit order is one sort of the overlapped
// treelets by (tile-minimum entry, index):
//   1. the tile's rays go to shared memory; thread t takes treelets t,
//      t + 128, ..., computes each one's minimum entry over the tile's
//      lanes (no atomics), and the overlapped ones are compacted into a
//      list with a block prefix count;
//   2. each listed treelet's rank in the order is the count of listed
//      treelets with a smaller (entry, index) key;
//   3. the block walks the order; each thread recomputes its own entry
//      for the visited treelet from the box (read through the read-only
//      cache, the same address for every thread) and tests the treelet's
//      K triangles if that entry < t_best.  Before each step the block
//      leaves once no live lane's t_best exceeds the step's tile minimum
//      (__syncthreads_or): every later entry of every lane is at least
//      that large, so nothing the reference tests is skipped.
//
// What bounds it on an H100: the triangle tests (K per visit, as in K1),
// now in lockstep over a tile-wide order, so a lane idles while the tile
// visits treelets it does not need, plus the rank step, O(m^2 / 128)
// compares a thread for a tile union of m treelets.  Shared memory is
// 12 bytes a treelet (key, list, order) plus the tile's rays, so NT <=
// MAX_TREELETS fits the 48 KB static limit.  On an NVIDIA H100 80GB HBM3
// (700 W), 262,144 compacted walk rays of the glass box (incoherent) took
// 1.21 ms against K1's 0.99 ms at 19 treelets and 6.14 against 5.20 ms
// at 923; 131,072 camera rays (coherent) 1.27 against 2.46 ms at 923.
//
// Barriers: every thread of the block reaches every barrier, including
// out-of-range and dead lanes, which skip only the work.
#include "intersect.cuh"

namespace {

using namespace bpt;

__global__ void __launch_bounds__(kThreads)
closest_hit_sweep_kernel(const float* __restrict__ bmin,
                         const float* __restrict__ bmax,
                         const float* __restrict__ block,
                         const int32_t* __restrict__ tri_index, int nt,
                         int k, const float* __restrict__ ray_o,
                         const float* __restrict__ ray_d,
                         const float* __restrict__ min_t,
                         const float* __restrict__ max_t, int b,
                         float* __restrict__ t_out,
                         int32_t* __restrict__ tri_out,
                         float* __restrict__ u_out,
                         float* __restrict__ v_out) {
  extern __shared__ float smem[];
  float* key = smem;                                      // (nt) tile minima
  int* listed = reinterpret_cast<int*>(key + nt);         // (nt) overlapped
  int* order = listed + nt;                               // (nt) visit order
  __shared__ Ray rays[kThreads];
  __shared__ int warp_counts[kThreads / 32];

  const int lane0 = blockIdx.x * kThreads;
  const int lane = lane0 + threadIdx.x;
  const int n_lanes = min(kThreads, b - lane0);
  Ray r;
  bool live = false;
  if (lane < b) {
    r = load_ray(ray_o, ray_d, min_t, max_t, lane);
    live = r.mxt >= r.mnt;
    rays[threadIdx.x] = r;
  }
  __syncthreads();

  // 1. Tile minimum entry of each treelet; the overlapped ones, listed in
  // index order.
  int m = 0;
  for (int j0 = 0; j0 < nt; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    float lo = INFINITY;
    if (j < nt) {
      float box[6];
      load_box(box, bmin, bmax, j);
      for (int i = 0; i < n_lanes; ++i) {
        float e;
        if (slab(box, rays[i], &e) && e < lo) lo = e;
      }
      key[j] = lo;
    }
    int total;
    const bool hit = lo < INFINITY;
    const int before = block_prefix_count(hit, warp_counts, &total);
    if (hit) listed[m + before] = j;
    m += total;
  }
  __syncthreads();

  // 2. Visit order: sort by (tile minimum, index) through ranks.
  for (int c = threadIdx.x; c < m; c += kThreads) {
    const int j = listed[c];
    const float e = key[j];
    int rank = 0;
    for (int c2 = 0; c2 < m; ++c2) {
      const int j2 = listed[c2];
      rank += key_less(key[j2], j2, e, j);
    }
    order[rank] = j;
  }
  __syncthreads();

  // 3. Walk the order.
  Best best;
  for (int s = 0; s < m; ++s) {
    const int j = order[s];
    if (!__syncthreads_or(live && key[j] < best.t)) break;
    if (!live) continue;
    float box[6], e;
    load_box(box, bmin, bmax, j);
    if (slab(box, r, &e) && e < best.t) {
      closest_in_treelet(block, tri_index, k, (size_t)j, r, best);
    }
  }
  if (lane < b) {
    t_out[lane] = best.t;
    tri_out[lane] = best.tri;
    u_out[lane] = best.u;
    v_out[lane] = best.v;
  }
}

}  // namespace

extern "C" int bpt_closest_hit_sweep(const float* bmin, const float* bmax,
                                     const float* block,
                                     const int32_t* tri_index, int nt, int k,
                                     const float* ray_o, const float* ray_d,
                                     const float* min_t, const float* max_t,
                                     int b, float* t_out, int32_t* tri_out,
                                     float* u_out, float* v_out,
                                     void* stream) {
  const int grid = (b + kThreads - 1) / kThreads;
  const size_t smem = (size_t)nt * 3 * sizeof(float);
  closest_hit_sweep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      bmin, bmax, block, tri_index, nt, k, ray_o, ray_d, min_t, max_t, b,
      t_out, tri_out, u_out, v_out);
  return (int)cudaGetLastError();
}
