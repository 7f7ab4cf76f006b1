// K2: occlusion (any hit) over the treelet table, one thread per segment.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_sweep.py::_any_kernel /
// _any_loop (entry trace_any_sweep).  What it computes is the same: a
// segment is occluded when any triangle gives a Moeller-Trumbore hit
// (|det| >= EPSILON, t > T_MIN_HIT) with t in [min_t, max_t]; a dead lane
// (max_t < min_t) is never occluded.
//
// What bounds it on an H100: the batch is large (about 8.3M segments per
// BDPT sample at the bench configuration, most of them dead) and each
// live segment costs slab tests plus up to K triangle tests per
// overlapped treelet, so the kernel is bound by FP32 work and warp
// divergence, not by memory: the triangle block (~97 KB here) stays in
// L1/L2.  The design: the NT boxes in shared memory (NT <= 2048; larger
// tables go to K4), each thread loops over the treelets its segment's
// slab overlaps, in index order, and stops at the first hit in range
// (intersect.cuh::any_in_boxes); a dead lane costs one compare.  The
// caller's compaction packs the dead lanes into whole dead warps and
// groups live segments by spatial cluster.  The TPU kernel's per-tile
// greedy max-coverage union (J = 8 treelets per iteration) exists to
// amortise Mosaic loop overhead and is not ported.
#include "intersect.cuh"

namespace {

using namespace bpt;

__global__ void __launch_bounds__(kThreads)
any_hit_kernel(const float* __restrict__ bmin, const float* __restrict__ bmax,
               const float* __restrict__ block, int nt, int k,
               const float* __restrict__ ray_o,
               const float* __restrict__ ray_d,
               const float* __restrict__ min_t,
               const float* __restrict__ max_t, int b,
               uint8_t* __restrict__ occ_out) {
  extern __shared__ float boxes[];  // (nt, 6)
  load_boxes(boxes, bmin, bmax, 0, nt);
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b) return;

  const Ray r = load_ray(ray_o, ray_d, min_t, max_t, lane);
  occ_out[lane] =
      (r.mxt >= r.mnt) && any_in_boxes(boxes, 0, nt, block, k, r);
}

}  // namespace

extern "C" int bpt_any_hit(const float* bmin, const float* bmax,
                           const float* block, int nt, int k,
                           const float* ray_o, const float* ray_d,
                           const float* min_t, const float* max_t, int b,
                           uint8_t* occ_out, void* stream) {
  const int grid = (b + kThreads - 1) / kThreads;
  const size_t smem = (size_t)nt * 6 * sizeof(float);
  any_hit_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      bmin, bmax, block, nt, k, ray_o, ray_d, min_t, max_t, b, occ_out);
  return (int)cudaGetLastError();
}
