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

// 0: each lane slab-tests every listed member (a design step measured
// against the runs' union boxes).
#ifndef BPT_K7_RUNS
#define BPT_K7_RUNS 1
#endif

namespace {

using namespace bpt;

template <bool kResident>
__global__ void __launch_bounds__(kThreads, kTileMinBlocks)
any_hit_compact_kernel(const float* __restrict__ bmin,
                       const float* __restrict__ bmax,
                       const float4* __restrict__ rows,
                       const int32_t* __restrict__ offsets, int nt,
                       int n_rows, const float* __restrict__ ray_o,
                       const float* __restrict__ ray_d,
                       const float* __restrict__ min_t,
                       const float* __restrict__ max_t, int b,
                       uint8_t* __restrict__ occ_out, int* counter) {
  extern __shared__ float4 smem[];
  __shared__ int warp_counts[kThreads / 32];
  __shared__ int slot;
  const FlatTable tab = load_flat_table<kResident>(smem, bmin, bmax, rows,
                                                   offsets, nt, n_rows);
  const TileShared ts = tile_shared(smem, nt, n_rows, kResident);
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
    tile_union<true>(tab, nt, r, open, ts.keys);
    const int m = list_union(ts.keys, nt, ts.list, warp_counts);
    bool occ = false;
    // The list is in index order, so the members of one run of kFlatGroup
    // treelets come together: the warp slab-tests the run's union box
    // once, and skips its members when none of its open lanes enters it.
    int run = -1;
    bool in_run = false, warp_in_run = false;
    tile_walk<kResident>(
        tab, ts, m, [&](int, int j, const float4* rws, int lo, int hi) {
          if (!__any_sync(kAllLanes, open)) return false;
          float e;
#if BPT_K7_RUNS
          if (j / kFlatGroup != run) {
            run = j / kFlatGroup;
            in_run = open && slab(tab.gboxes + run * 6, r, &e);
            warp_in_run = __any_sync(kAllLanes, in_run);
          }
          if (!warp_in_run) return true;
          const bool act = in_run && open && slab(tab.boxes + j * 6, r, &e);
#else
          const bool act = open && slab(tab.boxes + j * 6, r, &e);
#endif
          if (any_rows(rws, lo, hi, act, r)) {
            occ = true;
            open = false;
          }
          return true;
        });
    if (lane < b) occ_out[lane] = occ;
  }
}

template <bool kResident>
int launch(const float* bmin, const float* bmax, const float4* rows,
           const int32_t* offsets, int nt, int n_rows, const float* ray_o,
           const float* ray_d, const float* min_t, const float* max_t, int b,
           uint8_t* occ_out, int* counter, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(nt, n_rows, kResident);
  int grid = 0;
  const cudaError_t e = grouped_launch_config(
      any_hit_compact_kernel<kResident>, smem, b, &grid, kThreads);
  if (e != cudaSuccess) return (int)e;
  any_hit_compact_kernel<kResident><<<grid, kThreads, smem, stream>>>(
      bmin, bmax, rows, offsets, nt, n_rows, ray_o, ray_d, min_t, max_t, b,
      occ_out, counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bpt_any_hit_compact(const float* bmin, const float* bmax,
                                   const void* rows, const int32_t* offsets,
                                   int nt, int n_rows, const float* ray_o,
                                   const float* ray_d, const float* min_t,
                                   const float* max_t, int b,
                                   uint8_t* occ_out, int* counter,
                                   void* stream) {
  const float4* rows4 = static_cast<const float4*>(rows);
  if (tile_rows_resident(nt, n_rows)) {
    return launch<true>(bmin, bmax, rows4, offsets, nt, n_rows, ray_o, ray_d,
                        min_t, max_t, b, occ_out, counter,
                        (cudaStream_t)stream);
  }
  return launch<false>(bmin, bmax, rows4, offsets, nt, n_rows, ray_o, ray_d,
                       min_t, max_t, b, occ_out, counter,
                       (cudaStream_t)stream);
}
