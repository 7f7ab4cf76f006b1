// K2: occlusion (any hit) over a treelet table of at most 2,048 treelets,
// one segment per thread at a time, the triangles of a visit tested by
// the whole warp.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_sweep.py::_any_kernel /
// _any_loop (entry trace_any_sweep).  What it computes is the same: a
// segment is occluded when any triangle of a slab-overlapped treelet gives
// a Moeller-Trumbore hit (|det| >= EPSILON, t > T_MIN_HIT) with t in
// [min_t, max_t]; a dead lane (max_t < min_t) is never occluded.  The flag
// does not depend on the order in which treelets or triangles are tested.
//
// What bounds it on an H100: the FP32 operations of the work the flags
// need (one treelet of an occluded segment, every overlapped treelet of an
// open one, each with its triangles): 0.19 ms for the bench scene's
// 8,257,536-segment connect batch, 30% of it live (chip_smoke.py::
// trace_bound).  The first design (one thread a segment in a full grid,
// all 128 slots of a treelet tested, nine 4-byte loads a triangle) took
// 10.4 ms there and 26.9 ms on the 923-treelet table.  The design,
// against each cost (ms of that batch on the 19- / 923-treelet table, on
// an NVIDIA H100 80GB HBM3 at 700 W; PERF.md,
// probes/k12_old_vs_new.py):
//   * Persistent blocks that load the table once (intersect.cuh::
//     load_flat_table), one treelet a step with a settled thread taking
//     the next segment at once, and the triangles as packed 48-byte rows
//     up to each treelet's count (accel/treelets.py::packed_triangles):
//     no pad slot is tested and a triangle is three 16-byte loads.
//     10.4 -> 3.15, 26.9 -> 21.4.
//   * Rows resident in shared memory when the table fits two blocks to an
//     SM (the bench table: 63 KB), else read through the read-only cache:
//     8% slower while each thread tested its own treelet (3.14 against
//     2.90), 3% faster under the pooled test below (2.15 against 2.22).
//   * Pooled triangle test (any_pooled): the warp takes its threads'
//     visits one at a time, the segment broadcast by shuffle, 32
//     consecutive rows a round, a ballot after each round; a hit ends the
//     visit after the round that found it.  3.15 -> 2.17, 21.4 -> 14.1.
//     Leaving visits of fewer than 48 triangles to their own thread was
//     no better (2.27, 14.3).
//   * Group level, as K4: a segment slab-tests the union box of each run
//     of 32 treelets (computed by the block when it loads the table) and
//     only the members of groups it overlaps.  2.17 -> 2.16, 16.6 -> 3.82.
//   * Segments from the counter in chunks: a warp takes 64 with one
//     atomic, twice as many (up to 2,048) after a chunk without a live
//     one, and hands them to its threads in thread order at the top of a
//     step; a dead one costs its two loads and one store.  One atomic a
//     warp-ask took 2.8 ns each on the one counter, 0.51 ms of it for the
//     5.8M dead lanes alone.  2.16 -> 1.87, 3.81 -> 3.62.
// Tried and dropped: three blocks an SM (4% faster, K1 would spill), the
// treelets in another order than the BVH's (fewest triangles first,
// most first, reversed, by x: 4-21% slower at 19 treelets, up to 2.6x at
// 923, where it breaks up the groups).
#include "intersect.cuh"

namespace {

using namespace bpt;

constexpr unsigned kFullWarp = 0xffffffffu;
// Segments a warp takes from the counter with one atomic: kMinChunk, and
// twice the last chunk, up to kMaxChunk, while chunks hold no live one.
constexpr int kMinChunk = 64;
constexpr int kMaxChunk = 2048;

// The visits of a warp's threads (rows [lo, hi) of one treelet each, none
// when lo == hi), one at a time, 32 triangles a round across the warp;
// true in a thread whose segment hits a triangle of its treelet.  Every
// thread of the warp must call it.
template <bool kResident>
__device__ __forceinline__ bool any_pooled(const float4* rows, int lo, int hi,
                                           const Ray& r) {
  const int lid = threadIdx.x & 31;
  bool hit = false;
  unsigned pending = __ballot_sync(kFullWarp, hi > lo);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    Ray q;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      q.o[a] = __shfl_sync(kFullWarp, r.o[a], src);
      q.d[a] = __shfl_sync(kFullWarp, r.d[a], src);
    }
    q.mnt = __shfl_sync(kFullWarp, r.mnt, src);
    q.mxt = __shfl_sync(kFullWarp, r.mxt, src);
    const int qlo = __shfl_sync(kFullWarp, lo, src);
    const int qhi = __shfl_sync(kFullWarp, hi, src);
    bool any = false;
    for (int s = qlo; s < qhi && !any; s += 32) {
      const int i = s + lid;
      bool h = false;
      if (i < qhi) {
        const TriangleRow w = load_row<kResident>(rows, i);
        float tt, uu, vv;
        h = mt_row(w, q, &tt, &uu, &vv) && (tt >= q.mnt) && (tt <= q.mxt);
      }
      any = __any_sync(kFullWarp, h);
    }
    if (lid == src) hit = any;
  }
  return hit;
}

template <bool kResident>
__global__ void __launch_bounds__(kStreamThreads, 2)
any_hit_kernel(const float* __restrict__ bmin, const float* __restrict__ bmax,
               const float4* __restrict__ rows,
               const int32_t* __restrict__ offsets, int nt, int n_rows,
               const float* __restrict__ ray_o,
               const float* __restrict__ ray_d,
               const float* __restrict__ min_t,
               const float* __restrict__ max_t, int b,
               uint8_t* __restrict__ occ_out, int* counter) {
  extern __shared__ float4 smem[];
  const FlatTable tab = load_flat_table<kResident>(smem, bmin, bmax, rows,
                                                   offsets, nt, n_rows);
  // A step: box tests (the next group box, or the next member of the
  // group being scanned, members [j, j1)) up to the next treelet the
  // segment overlaps, then that treelet's triangles, pooled across the
  // warp.  lane < 0: the thread takes a new segment; done: none is left,
  // and the thread stays for its warp's pooled tests.
  int lane = -1;
  bool done = false;
  Ray r;
  int gi = 0, j = 0, j1 = 0;
  // The warp's chunk of segments [w_next, w_end), the same in its 32
  // threads, and whether it held a live one so far.
  const int lid = threadIdx.x & 31;
  int w_next = 0, w_end = 0, w_chunk = kMinChunk;
  bool w_live = true;
  while (true) {
    // The threads without a segment take the chunk's next ones, in thread
    // order; a dead one gets its flag at once, and its thread asks again.
    while (true) {
      const bool need = lane < 0 && !done;
      const unsigned asking = __ballot_sync(kFullWarp, need);
      if (!asking) break;
      if (w_next >= w_end) {
        w_chunk = w_live ? kMinChunk : min(2 * w_chunk, kMaxChunk);
        int base = 0;
        if (lid == 0) base = atomicAdd(counter, w_chunk);
        base = __shfl_sync(kFullWarp, base, 0);
        if (base >= b) {
          done = done || need;
          break;
        }
        w_next = base;
        w_end = min(base + w_chunk, b);
        w_live = false;
      }
      const int l = w_next + __popc(asking & ((1u << lid) - 1u));
      bool live = false;
      if (need && l < w_end) {
        live = max_t[l] >= min_t[l];
        if (live) {
          r = load_ray(ray_o, ray_d, min_t, max_t, l);
          lane = l;
          gi = j = j1 = 0;
        } else {
          occ_out[l] = 0;
        }
      }
      w_live = w_live || __any_sync(kFullWarp, live);
      w_next = min(w_next + __popc(asking), w_end);
    }
    if (__all_sync(kFullWarp, done)) break;
    int lo = 0, hi = 0;
    if (!done) {
      int cand = -1;
      while (cand < 0 && (j < j1 || gi < tab.ng)) {
        const bool member = j < j1;
        float box[6];
        step_box<true>(box, member, j, gi, tab.gboxes, tab.boxes, nullptr,
                       nullptr);
        float e;
        const bool in = slab(box, r, &e);
        if (member) {
          if (in) cand = j;
          ++j;
        } else {
          if (in) {
            j = gi * kFlatGroup;
            j1 = min(j + kFlatGroup, nt);
          }
          ++gi;
        }
      }
      if (cand < 0) {
        occ_out[lane] = 0;
        lane = -1;
      } else {
        lo = tab.offsets[cand];
        hi = tab.offsets[cand + 1];
      }
    }
    if (any_pooled<kResident>(tab.rows, lo, hi, r)) {
      occ_out[lane] = 1;
      lane = -1;
    }
  }
}

template <bool kResident>
int launch(const float* bmin, const float* bmax, const float4* rows,
           const int32_t* offsets, int nt, int n_rows, const float* ray_o,
           const float* ray_d, const float* min_t, const float* max_t, int b,
           uint8_t* occ_out, int* counter, cudaStream_t stream) {
  const size_t smem = flat_smem_bytes(nt, n_rows, kResident);
  int grid = 0;
  const cudaError_t e =
      grouped_launch_config(any_hit_kernel<kResident>, smem, b, &grid);
  if (e != cudaSuccess) return (int)e;
  any_hit_kernel<kResident><<<grid, kStreamThreads, smem, stream>>>(
      bmin, bmax, rows, offsets, nt, n_rows, ray_o, ray_d, min_t, max_t, b,
      occ_out, counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bpt_any_hit(const float* bmin, const float* bmax,
                           const void* rows, const int32_t* offsets, int nt,
                           int n_rows, const float* ray_o, const float* ray_d,
                           const float* min_t, const float* max_t, int b,
                           uint8_t* occ_out, int* counter, void* stream) {
  const float4* rows4 = static_cast<const float4*>(rows);
  if (rows_resident(nt, n_rows)) {
    return launch<true>(bmin, bmax, rows4, offsets, nt, n_rows, ray_o, ray_d,
                        min_t, max_t, b, occ_out, counter,
                        (cudaStream_t)stream);
  }
  return launch<false>(bmin, bmax, rows4, offsets, nt, n_rows, ray_o, ray_d,
                       min_t, max_t, b, occ_out, counter,
                       (cudaStream_t)stream);
}
