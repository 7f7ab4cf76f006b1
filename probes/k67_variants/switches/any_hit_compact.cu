// K7: occlusion (any hit) by tiles of 128 consecutive segments, each tile
// testing the union of the treelets its open lanes overlap, with the
// union's packed triangle rows in shared memory.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_trace.py::
// _compact_any_kernel :559 (entry trace_any_compact :686).  What it
// computes is K2's flag (any_hit.cu): a segment is occluded when a
// triangle of a slab-overlapped treelet gives a Moeller-Trumbore hit
// (|det| >= EPSILON, t > T_MIN_HIT) with t in [min_t, max_t]; a dead lane
// (max_t < min_t) is never occluded.  The flag does not depend on the
// order of the tests, and the union is only a filter: each lane still
// slab-tests its own segment against a member before testing its rows.
//
// Design (intersect.cuh, "The tile kernels K6 and K7"): persistent
// blocks of 128 threads take tiles from a counter; the block computes the
// tile's union (a warp a 32 lanes, group boxes first, a warp reduction a
// treelet) and lists it in index order; each warp walks the list on its
// own, leaving once none of its lanes is open; a member's rows are tested
// for the warp's lanes that overlap it, each thread over every row or
// pooled across the warp, and a lane leaves at its first hit.  The bench
// table's rows sit in shared memory for the block's life; a larger
// table's rows go through two stage buffers of 256 rows (cp.async), the
// next chunk of members loading while the current one is tested.
#include "intersect.cuh"

// 1: the tile's union keeps each warp's ballot of every treelet, and the
// walk reads it in place of a second slab test (0: the union keeps one
// flag a treelet and each lane slab-tests each listed member again).
#ifndef BPT_K7_MASKS
#define BPT_K7_MASKS 1
#endif
// 0: no tile union; each warp walks the runs of kFlatGroup treelets and
// their members itself, as K2's lanes do (measured against the union).
#ifndef BPT_K7_UNION
#define BPT_K7_UNION 1
#endif

namespace {

using namespace bpt;

__global__ void __launch_bounds__(kThreads, kTileMinBlocks)
any_hit_compact_kernel(const float* __restrict__ bmin,
                       const float* __restrict__ bmax,
                       const float4* __restrict__ rows,
                       const int32_t* __restrict__ offsets, int nt,
                       const float* __restrict__ ray_o,
                       const float* __restrict__ ray_d,
                       const float* __restrict__ min_t,
                       const float* __restrict__ max_t, int b,
                       uint8_t* __restrict__ occ_out, int* counter) {
  extern __shared__ float4 smem[];
  __shared__ int warp_counts[kThreads / 32];
  __shared__ int slot;
  const FlatTable tab = load_flat_table<false>(smem, bmin, bmax, rows,
                                               offsets, nt, 0);
  const TileShared ts = tile_shared(smem, nt, BPT_K7_MASKS);
  const int n_tiles = (b + kThreads - 1) / kThreads;
  TileQueue queue;
  while (true) {
    const int tile = next_tile(queue, counter, n_tiles, &slot);
    if (tile < 0) break;
    const int lane = tile * kThreads + threadIdx.x;
    Ray r{};
    bool open = false;
    if (lane < b) {
      open = max_t[lane] >= min_t[lane];
      if (open) r = load_ray(ray_o, ray_d, min_t, max_t, lane);
    }
    // A tile of dead lanes costs its loads and its stores.
    if (!__syncthreads_or(open)) {
      if (lane < b) occ_out[lane] = 0;
      continue;
    }
    queue.live = true;
#if !BPT_K7_UNION
    bool occ = false;
    for (int gi = 0; gi < tab.ng && __any_sync(kAllLanes, open); ++gi) {
      float e;
      const bool in = open && slab(tab.gboxes + gi * 6, r, &e);
      if (!__any_sync(kAllLanes, in)) continue;
      const int j1 = min((gi + 1) * kFlatGroup, nt);
      for (int j = gi * kFlatGroup; j < j1 && __any_sync(kAllLanes, open);
           ++j) {
        const bool act = in && open && slab(tab.boxes + j * 6, r, &e);
        if (any_rows(tab.rows, tab.offsets[j], tab.offsets[j + 1], act, r)) {
          occ = true;
          open = false;
        }
      }
    }
    (void)warp_counts;
#else
    const int warp = threadIdx.x >> 5;
#if BPT_K7_MASKS
    tile_masks(tab, nt, r, open, ts.keys);
    const int m = list_union(MaskKey{ts.keys}, nt, ts.list, warp_counts);
#else
    tile_union<true>(tab, nt, r, open, ts.keys);
    const int m = list_union(EntryKey{ts.keys}, nt, ts.list, warp_counts);
#endif
    // Each warp walks the list until none of its lanes is open.
    bool occ = false;
    for (int c = 0; c < m && __any_sync(kAllLanes, open); ++c) {
      const int j = list_index(ts.list[c]);
#if BPT_K7_MASKS
      const bool act =
          open && ((ts.keys[4 * j + warp] >> (threadIdx.x & 31)) & 1u);
#else
      float e;
      const bool act = open && slab(tab.boxes + j * 6, r, &e);
#endif
      if (any_rows(tab.rows, tab.offsets[j], tab.offsets[j + 1], act, r)) {
        occ = true;
        open = false;
      }
    }
#endif
    if (lane < b) occ_out[lane] = occ;
  }
}

}  // namespace

extern "C" int bpt_any_hit_compact(const float* bmin, const float* bmax,
                                   const void* rows, const int32_t* offsets,
                                   int nt, int n_rows, const float* ray_o,
                                   const float* ray_d, const float* min_t,
                                   const float* max_t, int b,
                                   uint8_t* occ_out, int* counter,
                                   void* stream) {
  (void)n_rows;
  const size_t smem = tile_smem_bytes(nt, BPT_K7_MASKS);
  int grid = 0;
  const cudaError_t e = grouped_launch_config(any_hit_compact_kernel, smem,
                                              b, &grid, kThreads);
  if (e != cudaSuccess) return (int)e;
  any_hit_compact_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      bmin, bmax, static_cast<const float4*>(rows), offsets, nt, ray_o,
      ray_d, min_t, max_t, b, occ_out, counter);
  return (int)cudaGetLastError();
}
