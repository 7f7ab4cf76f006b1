// K4: occlusion (any hit) over a treelet table of any size, one segment
// per thread at a time, the table taken in groups of g treelets behind
// their union boxes.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_sweep.py::_any_stream_kernel
// / _any_loop (entry trace_any_stream), which the reference routes to when
// the any-hit tables exceed its VMEM budget.  What it computes is K2's
// occlusion flag (any_hit.cu): a segment is occluded when a triangle of a
// slab-overlapped treelet gives a hit with t in [min_t, max_t]; dead lanes
// (max_t < min_t) never are.  The flag does not depend on the order in
// which treelets are tested, so it equals K2's on every segment whatever
// the group size.
//
// What bounds it on an H100: the FP32 operations of the work the flags
// need (one treelet of an occluded segment, every overlapped treelet of an
// open one, each with its triangles): 0.15 ms for the large scene's
// 8,257,536-segment connect batch (chip_smoke.py::trace_bound).  Segments
// need very different work, so a thread that ran one segment to its end
// kept its warp waiting on the slowest of 32.  The design, against each
// cost (times of that batch on an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md, probes/k34_old_vs_new.py):
//   * Group level: a segment slab-tests the NT / g group boxes in index
//     order and only the members of groups it overlaps, so an unoccluded
//     segment that crosses empty space costs about NT / g box tests
//     instead of NT.
//   * Boxes in shared memory (intersect.cuh, kResidentBytes): the group
//     boxes always, the member boxes when the table fits two blocks to an
//     SM, else from global memory through the read-only cache.  Loaded
//     once per block of persistent threads.  Group level, resident boxes
//     and persistent threads together: 47 ms (chunks of 256 boxes, commit
//     be61a0e) -> 27 ms.
//   * Triangle rows (accel/treelets.py::triangle_rows): three 16-byte
//     loads a triangle where K2's block takes nine 4-byte loads; 27 ->
//     25 ms.
//   * One treelet a step: a thread runs its box tests up to the next
//     member its segment overlaps, the threads that found one test its
//     triangles together, and a thread whose segment settled takes the
//     next segment at once while the others of its warp go on; 25 ->
//     9.9 ms.
//   * Triangle counts (accel/treelets.py::triangle_counts): a treelet's
//     test stops at its last triangle, not at its K-th slot; 9.9 -> 8.3 ms.
//   * One slab test a step (intersect.cuh::step_box) for the group box or
//     the member box, where the two were separate branches; 8.3 -> 6.5 ms.
#include "intersect.cuh"

namespace {

using namespace bpt;

template <bool kResident>
__global__ void __launch_bounds__(kStreamThreads, 2)
any_hit_stream_kernel(const float* __restrict__ bmin,
                      const float* __restrict__ bmax,
                      const float* __restrict__ gmin,
                      const float* __restrict__ gmax,
                      const float* __restrict__ rows,
                      const int32_t* __restrict__ counts, int nt, int ng,
                      int g, int k, const float* __restrict__ ray_o,
                      const float* __restrict__ ray_d,
                      const float* __restrict__ min_t,
                      const float* __restrict__ max_t, int b,
                      uint8_t* __restrict__ occ_out, int* counter) {
  extern __shared__ float smem[];
  float* gboxes = smem;           // (ng, 6)
  float* mboxes = smem + ng * 6;  // (nt, 6) when resident
  load_boxes(gboxes, gmin, gmax, 0, ng);
  if (kResident) load_boxes(mboxes, bmin, bmax, 0, nt);
  __syncthreads();
  // A step: box tests up to the next member the segment overlaps, then
  // that member's triangles.  lane < 0: the thread takes a new segment.
  int lane = -1;
  Ray r;
  int gi = 0, j = 0, j1 = 0;
  while (true) {
    if (lane < 0) {
      lane = next_lane(counter);
      if (lane >= b) break;
      r = load_ray(ray_o, ray_d, min_t, max_t, lane);
      gi = r.mxt >= r.mnt ? 0 : ng;  // a dead lane has nothing to test
      j = j1 = 0;
    }
    int cand = -1;
    while (cand < 0 && (j < j1 || gi < ng)) {
      const bool member = j < j1;
      float box[6];
      step_box<kResident>(box, member, j, gi, gboxes, mboxes, bmin, bmax);
      float e;
      const bool in = slab(box, r, &e);
      if (member) {
        if (in) cand = j;
        ++j;
      } else {
        if (in) {
          j = gi * g;
          j1 = min(j + g, nt);
        }
        ++gi;
      }
    }
    if (cand < 0) {
      occ_out[lane] = 0;
      lane = -1;
    } else if (any_in_treelet(rows, k, (size_t)cand, r,
                              __ldg(counts + cand))) {
      occ_out[lane] = 1;
      lane = -1;
    }
  }
}

template <bool kResident>
int launch(const float* bmin, const float* bmax, const float* gmin,
           const float* gmax, const float* rows, const int32_t* counts,
           int nt, int ng, int g, int k, const float* ray_o,
           const float* ray_d, const float* min_t, const float* max_t, int b,
           uint8_t* occ_out, int* counter, cudaStream_t stream) {
  const size_t smem = (size_t)(ng + (kResident ? nt : 0)) * 6 * sizeof(float);
  int grid = 0;
  const cudaError_t e = grouped_launch_config(
      any_hit_stream_kernel<kResident>, smem, b, &grid);
  if (e != cudaSuccess) return (int)e;
  any_hit_stream_kernel<kResident><<<grid, kStreamThreads, smem, stream>>>(
      bmin, bmax, gmin, gmax, rows, counts, nt, ng, g, k, ray_o, ray_d, min_t,
      max_t, b, occ_out, counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bpt_any_hit_stream(const float* bmin, const float* bmax,
                                  const float* gmin, const float* gmax,
                                  const float* rows, const int32_t* counts,
                                  int nt, int ng, int g, int k,
                                  const float* ray_o, const float* ray_d,
                                  const float* min_t, const float* max_t,
                                  int b, uint8_t* occ_out, int* counter,
                                  void* stream) {
  if (members_resident(nt, ng)) {
    return launch<true>(bmin, bmax, gmin, gmax, rows, counts, nt, ng, g, k,
                        ray_o, ray_d, min_t, max_t, b, occ_out, counter,
                        (cudaStream_t)stream);
  }
  return launch<false>(bmin, bmax, gmin, gmax, rows, counts, nt, ng, g, k,
                       ray_o, ray_d, min_t, max_t, b, occ_out, counter,
                       (cudaStream_t)stream);
}

// The message of a CUDA error code, for the wrappers' exceptions.
extern "C" const char* bpt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
