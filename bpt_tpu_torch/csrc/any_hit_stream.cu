// K4: occlusion (any hit) with the treelet table streamed in chunks, one
// thread per segment.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_sweep.py::_any_stream_kernel
// / _any_loop (entry trace_any_stream), which the reference routes to when
// the any-hit tables exceed its VMEM budget.  What it computes is K2's
// occlusion flag (any_hit.cu): a segment is occluded when a triangle of a
// slab-overlapped treelet gives a hit with t in [min_t, max_t]; dead lanes
// (max_t < min_t) never are.  The table is taken in chunks of `chunk`
// treelets in index order, and a segment settled in one chunk skips the
// rest.
//
// What bounds it on an H100: FP32 slab and triangle work of the open
// segments (8.26M segments per BDPT batch at the bench configuration,
// about 30% live), and warp divergence.  K2 keeps all NT boxes in shared
// memory (NT <= 2048); here the block loads one chunk of boxes (chunk <=
// 2048) at a time, each open thread tests that chunk, and the block stops
// streaming as soon as none of its threads is open (__syncthreads_or), so
// a tile of dead or settled segments reads no more boxes.  Triangle rows
// come from global memory through the read-only cache, as in K2.
//
// Barriers: every thread takes part in every chunk load and barrier,
// out-of-range, dead and settled lanes included; they only skip the work.
#include "intersect.cuh"

namespace {

using namespace bpt;

__global__ void __launch_bounds__(kThreads)
any_hit_stream_kernel(const float* __restrict__ bmin,
                      const float* __restrict__ bmax,
                      const float* __restrict__ block, int nt, int k,
                      int chunk, const float* __restrict__ ray_o,
                      const float* __restrict__ ray_d,
                      const float* __restrict__ min_t,
                      const float* __restrict__ max_t, int b,
                      uint8_t* __restrict__ occ_out) {
  extern __shared__ float boxes[];  // (chunk, 6)
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r;
  bool open = false;
  if (lane < b) {
    r = load_ray(ray_o, ray_d, min_t, max_t, lane);
    open = r.mxt >= r.mnt;
  }
  bool occ = false;
  for (int j0 = 0; j0 < nt; j0 += chunk) {
    // Also the barrier that keeps the previous chunk's boxes in place
    // until every thread has finished with them.
    if (!__syncthreads_or(open)) break;
    const int n = min(chunk, nt - j0);
    load_boxes(boxes, bmin, bmax, j0, n);
    __syncthreads();
    if (open && any_in_boxes(boxes, j0, n, block, k, r)) {
      occ = true;
      open = false;
    }
  }
  if (lane < b) occ_out[lane] = occ;
}

}  // namespace

extern "C" int bpt_any_hit_stream(const float* bmin, const float* bmax,
                                  const float* block, int nt, int k,
                                  int chunk, const float* ray_o,
                                  const float* ray_d, const float* min_t,
                                  const float* max_t, int b,
                                  uint8_t* occ_out, void* stream) {
  const int grid = (b + kThreads - 1) / kThreads;
  const size_t smem = (size_t)chunk * 6 * sizeof(float);
  any_hit_stream_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      bmin, bmax, block, nt, k, chunk, ray_o, ray_d, min_t, max_t, b,
      occ_out);
  return (int)cudaGetLastError();
}
