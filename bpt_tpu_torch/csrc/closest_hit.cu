// K1: closest hit over the treelet table, one thread per ray.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_trace.py::_compact_kernel /
// _compact_body (entry trace_closest_compact).  What it computes is the
// same: for each ray, the nearest triangle hit with Moeller-Trumbore
// (|det| >= EPSILON, t > T_MIN_HIT, t in [min_t, max_t]), visiting the
// ray's slab-overlapped treelets front to back and stopping once the next
// treelet's entry distance cannot beat the best hit.  A dead lane
// (max_t < min_t) and a miss return (inf, -1, 0, 0).
//
// What bounds it on an H100: divergent per-ray control flow and the FP32
// work of the triangle tests (about 40 flops per ray x triangle); the
// (NT, 9, K) triangle block is ~97 KB for the bench scene and stays in
// L1/L2, so device-memory bandwidth is not the limit.  The design answers
// with plain per-thread traversal: the NT boxes sit in shared memory (so
// NT <= 2048, the 48 KB static limit; larger tables go to K3), the next
// treelet is chosen by rescanning them (intersect.cuh::closest_in_boxes),
// and triangle rows are read through the read-only cache.  Warp coherence
// comes from the caller's cluster-keyed compaction.  The Mosaic
// workarounds of the TPU kernel (bf16 3-way split, one-hot fetch, shift
// prefix sums, U-rounds, the 0.99 entry slack) are not ported.
//
// Tie rule, shared with the plain PyTorch version in
// bpt_tpu_torch/ops/trace_closest.py: treelets in (entry, index) order, a
// hit improves only on a strictly smaller t, and within a treelet the
// lowest slot k wins an equal t.
#include "intersect.cuh"

namespace {

using namespace bpt;

__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ bmin,
                   const float* __restrict__ bmax,
                   const float* __restrict__ block,
                   const int32_t* __restrict__ tri_index, int nt, int k,
                   const float* __restrict__ ray_o,
                   const float* __restrict__ ray_d,
                   const float* __restrict__ min_t,
                   const float* __restrict__ max_t, int b,
                   float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ float boxes[];  // (nt, 6)
  load_boxes(boxes, bmin, bmax, 0, nt);
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b) return;

  const Ray r = load_ray(ray_o, ray_d, min_t, max_t, lane);
  Best best;
  if (r.mxt >= r.mnt) {
    closest_in_boxes(boxes, 0, nt, block, tri_index, k, r, best);
  }
  t_out[lane] = best.t;
  tri_out[lane] = best.tri;
  u_out[lane] = best.u;
  v_out[lane] = best.v;
}

}  // namespace

extern "C" int bpt_closest_hit(const float* bmin, const float* bmax,
                               const float* block, const int32_t* tri_index,
                               int nt, int k, const float* ray_o,
                               const float* ray_d, const float* min_t,
                               const float* max_t, int b, float* t_out,
                               int32_t* tri_out, float* u_out, float* v_out,
                               void* stream) {
  const int grid = (b + kThreads - 1) / kThreads;
  const size_t smem = (size_t)nt * 6 * sizeof(float);
  closest_hit_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      bmin, bmax, block, tri_index, nt, k, ray_o, ray_d, min_t, max_t, b,
      t_out, tri_out, u_out, v_out);
  return (int)cudaGetLastError();
}
