// K7: occlusion (any hit) by tiles of 128 consecutive segments, each tile
// walking the compacted union of the treelets its open lanes overlap; one
// block per tile.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_trace.py::
// _compact_any_kernel (entry trace_any_compact).  What it computes is K2's
// flag (any_hit.cu): a segment is occluded when a triangle of a
// slab-overlapped treelet gives a Moeller-Trumbore hit (|det| >= EPSILON,
// t > T_MIN_HIT) with t in [min_t, max_t]; a dead lane (max_t < min_t) is
// never occluded.  The flag does not depend on the order of the tests.
//
// Design, the TPU kernel's idea: the tile first compacts the treelets
// that any of its open lanes overlaps into a small table, in index order
// and in rounds, and each lane then walks only that table, testing the
// members its own segment overlaps and leaving at its first hit.
//   * Compaction: the tile's segments sit in shared memory; thread t
//     takes treelet j0 + t of each group of 128 treelets, tests its box
//     against the open lanes until one overlaps, and a block prefix count
//     (ballot + popc) gives the member's slot.  Groups are added until the
//     round holds at least 128 members or the table ends (a round holds
//     128 to 255).
//   * Walk: each open thread loops over the round's members, slab-tests
//     its own segment against each (box read through the read-only
//     cache, the same address for every thread) and tests the K
//     triangles of an overlapped member, stopping at its first hit.
//   * A settled lane leaves the union of the next round; the block stops
//     when no lane is open (__syncthreads_or), so a tile of dead lanes
//     costs one barrier.
// K2, by contrast, has every thread scan all NT boxes.
//
// What bounds it on an H100: the triangle tests of the members a lane
// overlaps, as in K2, plus the compaction's slab tests (up to 128 a
// treelet for a treelet no open lane overlaps).  Shared memory holds the
// rays and one round's members, about 7 KB, whatever NT is.  On an
// NVIDIA H100 80GB HBM3 (700 W), the 8,257,536 compacted shadow segments
// of one bench batch (30% live) took 10.41 ms against K2's 10.39 ms at 19
// treelets, and 27.7 against 26.8 ms at 923.
//
// Barriers: every thread of the block reaches every barrier of every
// round, including out-of-range, dead and settled lanes, which skip only
// the work.
#include "intersect.cuh"

namespace {

using namespace bpt;

constexpr int kRound = kThreads;  // members per round, at least

__global__ void __launch_bounds__(kThreads)
any_hit_compact_kernel(const float* __restrict__ bmin,
                       const float* __restrict__ bmax,
                       const float* __restrict__ block, int nt, int k,
                       const float* __restrict__ ray_o,
                       const float* __restrict__ ray_d,
                       const float* __restrict__ min_t,
                       const float* __restrict__ max_t, int b,
                       uint8_t* __restrict__ occ_out) {
  __shared__ Ray rays[kThreads];
  __shared__ bool open_s[kThreads];
  __shared__ int members[kRound + kThreads];
  __shared__ int warp_counts[kThreads / 32];

  const int lane0 = blockIdx.x * kThreads;
  const int lane = lane0 + threadIdx.x;
  const int n_lanes = min(kThreads, b - lane0);
  Ray r;
  bool open = false;
  if (lane < b) {
    r = load_ray(ray_o, ray_d, min_t, max_t, lane);
    open = r.mxt >= r.mnt;
    rays[threadIdx.x] = r;
  }
  bool occ = false;

  int j0 = 0;
  while (true) {
    open_s[threadIdx.x] = open;
    // Also the barrier that keeps the previous round's members in place
    // until every thread has walked them.
    if (!__syncthreads_or(open) || j0 >= nt) break;

    // Compact the next round of the open lanes' union.
    int m = 0;
    while (m < kRound && j0 < nt) {
      const int j = j0 + threadIdx.x;
      bool member = false;
      if (j < nt) {
        float box[6];
        load_box(box, bmin, bmax, j);
        for (int i = 0; i < n_lanes && !member; ++i) {
          float e;
          member = open_s[i] && slab(box, rays[i], &e);
        }
      }
      int total;
      const int before = block_prefix_count(member, warp_counts, &total);
      if (member) members[m + before] = j;
      m += total;
      j0 += kThreads;
    }
    __syncthreads();

    // Walk the round's members this lane overlaps; leave at a hit.
    if (open) {
      for (int c = 0; c < m; ++c) {
        const int j = members[c];
        float box[6], e;
        load_box(box, bmin, bmax, j);
        if (slab(box, r, &e) && any_in_treelet(block, k, (size_t)j, r)) {
          occ = true;
          open = false;
          break;
        }
      }
    }
  }
  if (lane < b) occ_out[lane] = occ;
}

}  // namespace

extern "C" int bpt_any_hit_compact(const float* bmin, const float* bmax,
                                   const float* block, int nt, int k,
                                   const float* ray_o, const float* ray_d,
                                   const float* min_t, const float* max_t,
                                   int b, uint8_t* occ_out, void* stream) {
  const int grid = (b + kThreads - 1) / kThreads;
  any_hit_compact_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      bmin, bmax, block, nt, k, ray_o, ray_d, min_t, max_t, b, occ_out);
  return (int)cudaGetLastError();
}
