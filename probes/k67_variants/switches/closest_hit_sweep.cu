// K6: closest hit with one treelet visit order shared by a tile of 128
// consecutive lanes, the visited treelets' packed triangle rows in shared
// memory.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_sweep.py::_closest_kernel
// :263 / _closest_body :318 (entry trace_closest_sweep :458).  What it
// computes: the tile visits the treelets that any of its lanes overlaps
// (dead lanes included) in order of their minimum entry over the tile's
// lanes, the lowest index first on an equal entry (entries compare as
// floats: -0.0 equals +0.0); a live lane tests the visited treelet only
// if its own entry, max(tnear, 0), is below its t_best.  The triangle
// rules are K1's (|det| >= EPSILON, t > T_MIN_HIT, min_t <= t <=
// min(t_best, max_t), lowest slot on an equal t within a treelet, strict
// `<` to improve), so the hit's t is K1's; where two triangles of
// different treelets give exactly the same t, K6 keeps the one its tile
// reached first.  A dead lane (max_t < min_t) and a miss return
// (inf, -1, 0, 0).  Visiting a treelet leaves the other treelets' tile
// minima as they are, so the whole order is one sort of the overlapped
// treelets by (tile-minimum entry, index).  A lane whose t_best is at
// most the next treelet's tile minimum tests no later treelet, so a warp
// leaves the walk once that holds for all its lanes, and the block once
// it holds for all of them.
//
// Design (intersect.cuh, "The tile kernels K6 and K7"): persistent
// blocks of 128 threads take tiles from a counter; the block computes the
// tile minima (a warp a 32 lanes, group boxes first, one warp reduction a
// treelet), lists the overlapped treelets and sorts their (entry bits,
// index) keys with a bitonic sort in shared memory (-0.0 made +0.0
// first, so the bits order as the floats); each warp walks the order; a
// treelet's rows are tested for the warp's lanes that need it, each
// thread over every row or pooled across the warp with a (t, row)
// reduction.  The bench table's rows sit in shared memory for the
// block's life; a larger table's rows go through two stage buffers of
// 256 rows (cp.async), the next chunk of the order loading while the
// current one is tested.
#include "intersect.cuh"

namespace {

using namespace bpt;

__device__ __forceinline__ void store_best(int lane, const Best& best,
                                           float* __restrict__ t_out,
                                           int32_t* __restrict__ tri_out,
                                           float* __restrict__ u_out,
                                           float* __restrict__ v_out) {
  t_out[lane] = best.t;
  tri_out[lane] = best.tri;
  u_out[lane] = best.u;
  v_out[lane] = best.v;
}

__global__ void __launch_bounds__(kThreads, kTileMinBlocks)
closest_hit_sweep_kernel(const float* __restrict__ bmin,
                         const float* __restrict__ bmax,
                         const float4* __restrict__ rows,
                         const int32_t* __restrict__ offsets, int nt,
                         const float* __restrict__ ray_o,
                         const float* __restrict__ ray_d,
                         const float* __restrict__ min_t,
                         const float* __restrict__ max_t, int b,
                         float* __restrict__ t_out,
                         int32_t* __restrict__ tri_out,
                         float* __restrict__ u_out,
                         float* __restrict__ v_out, int* counter) {
  extern __shared__ float4 smem[];
  __shared__ int warp_counts[kThreads / 32];
  __shared__ int slot;
  const FlatTable tab = load_flat_table<false>(smem, bmin, bmax, rows,
                                               offsets, nt, 0);
  const TileShared ts = tile_shared(smem, nt, false);
  const int n_tiles = (b + kThreads - 1) / kThreads;
  TileQueue queue;
  while (true) {
    const int tile = next_tile(queue, counter, n_tiles, &slot);
    if (tile < 0) break;
    const int lane = tile * kThreads + threadIdx.x;
    const bool in = lane < b;
    const bool live = in && max_t[lane] >= min_t[lane];
    Best best;
    if (!__syncthreads_or(live)) {
      if (in) store_best(lane, best, t_out, tri_out, u_out, v_out);
      continue;
    }
    queue.live = true;
    Ray r{};
    if (in) r = load_ray(ray_o, ray_d, min_t, max_t, lane);
    tile_union<false>(tab, nt, r, in, ts.keys);
    const int m = list_union(EntryKey{ts.keys}, nt, ts.list, warp_counts);
    block_sort(ts.list, m);
    // Each warp walks the order until none of its live lanes has a t_best
    // above the next treelet's tile minimum.
    for (int c = 0; c < m; ++c) {
      const uint64_t x = ts.list[c];
      const float key = __uint_as_float((unsigned)(x >> 32));
      if (!__any_sync(kAllLanes, live && key < best.t)) break;
      const int j = list_index(x);
      float e;
      const bool act = live && slab(tab.boxes + j * 6, r, &e) && e < best.t;
      closest_rows(tab.rows, tab.offsets[j], tab.offsets[j + 1], act, r,
                   best);
    }
    if (in) store_best(lane, best, t_out, tri_out, u_out, v_out);
  }
}

}  // namespace

extern "C" int bpt_closest_hit_sweep(const float* bmin, const float* bmax,
                                     const void* rows,
                                     const int32_t* offsets, int nt,
                                     int n_rows, const float* ray_o,
                                     const float* ray_d, const float* min_t,
                                     const float* max_t, int b, float* t_out,
                                     int32_t* tri_out, float* u_out,
                                     float* v_out, int* counter,
                                     void* stream) {
  (void)n_rows;
  const size_t smem = tile_smem_bytes(nt, false);
  int grid = 0;
  const cudaError_t e = grouped_launch_config(closest_hit_sweep_kernel, smem,
                                              b, &grid, kThreads);
  if (e != cudaSuccess) return (int)e;
  closest_hit_sweep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      bmin, bmax, static_cast<const float4*>(rows), offsets, nt, ray_o,
      ray_d, min_t, max_t, b, t_out, tri_out, u_out, v_out, counter);
  return (int)cudaGetLastError();
}
