// K3: closest hit with the treelet table streamed in chunks, one thread
// per ray.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_sweep.py::
// _closest_stream_kernel / _closest_body (entry trace_closest_stream),
// which the reference routes to when the treelet tables exceed its VMEM
// budget.  What it computes is K1's closest hit (closest_hit.cu), with
// the table taken in chunks of `chunk` treelets in index order: within a
// chunk the treelets are visited in (entry, index) order while entry <
// t_best, and the best hit (t, tri, u, v) carries from chunk to chunk, so
// a chunk behind a found hit costs only its slab tests.
//
// What bounds it on an H100: the same FP32 triangle and slab work as K1,
// plus the boxes.  K1 keeps all NT boxes in shared memory, which caps NT
// at 2048 (48 KB static limit) and makes each visit rescan all NT boxes.
// Here the block loads one chunk of boxes (chunk <= 2048) into shared
// memory at a time and each thread runs K1's rescan over that chunk only,
// so shared memory is bounded and a rescan costs `chunk` slab tests.  The
// (NT, 9, K) triangle rows (17 MB for a 3,656-treelet scene) are read
// from global memory through the read-only cache, as in K1.
//
// Barriers: every thread of the block takes part in every chunk load and
// barrier, out-of-range and dead lanes included; they only skip the
// work.  A block whose lanes are all dead leaves the loop at once
// (__syncthreads_or).
//
// Tie rule, shared with the plain PyTorch version
// bpt_tpu_torch/ops/trace_closest.py::closest_hit_stream_plain: chunks in
// index order; within a chunk (entry, index) order, strict `<` to
// improve, lowest slot on an equal t.
#include "intersect.cuh"

namespace {

using namespace bpt;

__global__ void __launch_bounds__(kThreads)
closest_hit_stream_kernel(const float* __restrict__ bmin,
                          const float* __restrict__ bmax,
                          const float* __restrict__ block,
                          const int32_t* __restrict__ tri_index, int nt,
                          int k, int chunk,
                          const float* __restrict__ ray_o,
                          const float* __restrict__ ray_d,
                          const float* __restrict__ min_t,
                          const float* __restrict__ max_t, int b,
                          float* __restrict__ t_out,
                          int32_t* __restrict__ tri_out,
                          float* __restrict__ u_out,
                          float* __restrict__ v_out) {
  extern __shared__ float boxes[];  // (chunk, 6)
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r;
  bool live = false;
  if (lane < b) {
    r = load_ray(ray_o, ray_d, min_t, max_t, lane);
    live = r.mxt >= r.mnt;
  }
  Best best;
  for (int j0 = 0; j0 < nt; j0 += chunk) {
    // Also the barrier that keeps the previous chunk's boxes in place
    // until every thread has finished with them.
    if (!__syncthreads_or(live)) break;
    const int n = min(chunk, nt - j0);
    load_boxes(boxes, bmin, bmax, j0, n);
    __syncthreads();
    if (live) closest_in_boxes(boxes, j0, n, block, tri_index, k, r, best);
  }
  if (lane < b) {
    t_out[lane] = best.t;
    tri_out[lane] = best.tri;
    u_out[lane] = best.u;
    v_out[lane] = best.v;
  }
}

}  // namespace

extern "C" int bpt_closest_hit_stream(const float* bmin, const float* bmax,
                                      const float* block,
                                      const int32_t* tri_index, int nt,
                                      int k, int chunk, const float* ray_o,
                                      const float* ray_d, const float* min_t,
                                      const float* max_t, int b,
                                      float* t_out, int32_t* tri_out,
                                      float* u_out, float* v_out,
                                      void* stream) {
  const int grid = (b + kThreads - 1) / kThreads;
  const size_t smem = (size_t)chunk * 6 * sizeof(float);
  closest_hit_stream_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      bmin, bmax, block, tri_index, nt, k, chunk, ray_o, ray_d, min_t, max_t,
      b, t_out, tri_out, u_out, v_out);
  return (int)cudaGetLastError();
}
