// K1: closest hit over a treelet table of at most 2,048 treelets, one
// thread per ray.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_trace.py::_compact_kernel /
// _compact_body (entry trace_closest_compact).  What it computes is the
// same: for each ray, the nearest triangle hit with Moeller-Trumbore
// (|det| >= EPSILON, t > T_MIN_HIT, t in [min_t, max_t]), visiting the
// ray's slab-overlapped treelets front to back and stopping once the next
// treelet's entry distance cannot beat the best hit.  A dead lane
// (max_t < min_t) and a miss return (inf, -1, 0, 0).
//
// Tie rule, shared with the plain PyTorch version in
// bpt_tpu_torch/ops/trace_closest.py: treelets in (entry, index) order, a
// hit improves only on a strictly smaller t, and within a treelet the
// lowest slot k wins an equal t.
//
// What bounds it on an H100: the FP32 operations of the work the result
// needs (the triangles of every treelet a ray enters below its final t;
// 3.4 treelets and 99 triangles a live ray on the bench table): 0.020 ms
// for the bench scene's walk batch of 262,144 rays (chip_smoke.py::
// trace_bound).  The first design (one thread a ray in a full grid, the
// boxes rescanned at every visit, all 128 slots of a treelet tested, nine
// 4-byte loads a triangle) took 1.00 ms there and 5.14 ms on the
// 923-treelet table.  The design, against each cost (ms of the walk /
// primary batch on the 19-treelet table; walk on the 923-treelet one; an
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md, probes/k12_old_vs_new.py):
//   * Persistent blocks that load the table once (intersect.cuh::
//     load_flat_table); the candidate list of K3 and K5 in place of the
//     rescan (a refill resumes strictly after the last visited key, and a
//     key that a full buffer pushes out comes back in the next one); the
//     triangles as packed 48-byte rows up to each treelet's count
//     (accel/treelets.py::packed_triangles, the slot's tri_index in the
//     row): no pad slot is tested and a triangle is three 16-byte loads.
//     1.00 / 0.39 -> 0.30 / 0.14; 5.14 -> 0.98.
//   * Rows resident in shared memory when the table fits two blocks to an
//     SM (the bench table: 63 KB), else read through the read-only cache.
//     0.30 / 0.14 -> 0.28 / 0.11.
//   * Group level, as K3: a refill slab-tests the union box of each run
//     of 32 treelets (computed by the block when it loads the table) and
//     only the members of groups entered below t_best.  Nothing at 19
//     treelets (one group); 0.98 -> 0.61 at 923.
// Tried and dropped: one refill or one visit a step with a settled thread
// taking the next ray at once (0.33 against 0.29, as on K3: a ray's work
// varies less than a segment's); K2's pooled triangle test (walk 0.27
// against 0.28, but primary 0.18 against 0.11: the primary rays of a warp
// visit the same treelets, so pooling only adds its shuffles; 0.85 against
// 0.98 at 923); 8 candidate keys (walk 0.27 against 0.29, primary at 923
// 0.41 against 0.37).
#include "intersect.cuh"

namespace {

using namespace bpt;

template <bool kResident>
__global__ void __launch_bounds__(kStreamThreads, 2)
closest_hit_kernel(const float* __restrict__ bmin,
                   const float* __restrict__ bmax,
                   const float4* __restrict__ rows,
                   const int32_t* __restrict__ offsets, int nt, int n_rows,
                   const float* __restrict__ ray_o,
                   const float* __restrict__ ray_d,
                   const float* __restrict__ min_t,
                   const float* __restrict__ max_t, int b,
                   float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   int* counter) {
  extern __shared__ float4 smem[];
  const FlatTable tab = load_flat_table<kResident>(smem, bmin, bmax, rows,
                                                   offsets, nt, n_rows);
  while (true) {
    const int lane = next_lane(counter);
    if (lane >= b) return;
    const Ray r = load_ray(ray_o, ray_d, min_t, max_t, lane);
    Best best;
    if (r.mxt >= r.mnt) closest_walk_flat<kResident>(tab, nt, r, best);
    store_best(lane, best, t_out, tri_out, u_out, v_out);
  }
}

template <bool kResident>
int launch(const float* bmin, const float* bmax, const float4* rows,
           const int32_t* offsets, int nt, int n_rows, const float* ray_o,
           const float* ray_d, const float* min_t, const float* max_t, int b,
           float* t_out, int32_t* tri_out, float* u_out, float* v_out,
           int* counter, cudaStream_t stream) {
  const size_t smem = flat_smem_bytes(nt, n_rows, kResident);
  int grid = 0;
  const cudaError_t e =
      grouped_launch_config(closest_hit_kernel<kResident>, smem, b, &grid);
  if (e != cudaSuccess) return (int)e;
  closest_hit_kernel<kResident><<<grid, kStreamThreads, smem, stream>>>(
      bmin, bmax, rows, offsets, nt, n_rows, ray_o, ray_d, min_t, max_t, b,
      t_out, tri_out, u_out, v_out, counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bpt_closest_hit(const float* bmin, const float* bmax,
                               const void* rows, const int32_t* offsets,
                               int nt, int n_rows, const float* ray_o,
                               const float* ray_d, const float* min_t,
                               const float* max_t, int b, float* t_out,
                               int32_t* tri_out, float* u_out, float* v_out,
                               int* counter, void* stream) {
  const float4* rows4 = static_cast<const float4*>(rows);
  if (rows_resident(nt, n_rows)) {
    return launch<true>(bmin, bmax, rows4, offsets, nt, n_rows, ray_o, ray_d,
                        min_t, max_t, b, t_out, tri_out, u_out, v_out,
                        counter, (cudaStream_t)stream);
  }
  return launch<false>(bmin, bmax, rows4, offsets, nt, n_rows, ray_o, ray_d,
                       min_t, max_t, b, t_out, tri_out, u_out, v_out, counter,
                       (cudaStream_t)stream);
}
