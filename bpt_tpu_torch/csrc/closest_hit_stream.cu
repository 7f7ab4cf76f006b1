// K3: closest hit over a treelet table of any size, one thread per ray,
// the table taken in groups of g treelets behind their union boxes.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_sweep.py::
// _closest_stream_kernel / _closest_body (entry trace_closest_stream),
// which the reference routes to when the treelet tables exceed its VMEM
// budget.  What it computes is K1's closest hit (closest_hit.cu), bit for
// bit, on any table size: each ray visits the treelets it overlaps in
// (entry, index) order over the whole table, entry = max(tnear, 0), while
// entry < t_best; a triangle counts with |det| >= EPSILON, t > T_MIN_HIT
// and min_t <= t <= min(t_best, max_t); within a treelet the lowest t and
// then the lowest slot wins, and a hit replaces the best only if strictly
// nearer.  A dead lane (max_t < min_t) and a miss return (inf, -1, 0, 0).
// The group size g does not change the result.
//
// What bounds it on an H100: the FP32 operations of the work the result
// needs (the triangles of every treelet a ray enters below its final t;
// 2.3 treelets and 51 triangles a live ray): 0.010 ms for the large
// scene's walk batch of 262,144 rays (chip_smoke.py::trace_bound).  The
// design, against each cost (times of that batch on an NVIDIA H100 80GB
// HBM3 at 700 W; PERF.md, probes/k34_old_vs_new.py):
//   * Candidate list (as K5, closest_hit_full.cu): a thread keeps its
//     kCandKeys nearest unvisited (entry, index) keys in registers, visits
//     them front to back, and refills with one pass that resumes strictly
//     after the last visited key, instead of rescanning the boxes at
//     every visit.
//   * Group level: a refill pass slab-tests the NT / g group boxes and
//     only the members of groups entered below t_best (and not beyond a
//     full buffer's last key), so a pass costs about NT / g + a few g box
//     tests instead of NT.  The visit order among members is the keys'
//     order, so the result does not depend on the groups.
//   * Boxes in shared memory (intersect.cuh, kResidentBytes): the group
//     boxes always, the member boxes when the whole table fits two blocks
//     to an SM; above that members come from global memory through the
//     read-only cache.  Loaded once per block of persistent threads, which
//     take rays from a counter.  These three: 7.4 ms (chunks of 256 boxes,
//     commit be61a0e) -> 1.55 ms.
//   * Triangle rows (accel/treelets.py::triangle_rows): a slot's v0, e1,
//     e2 in 48 contiguous bytes, read with three 16-byte loads through
//     the read-only cache, where the (NT, 9, K) block of K1 takes nine
//     4-byte loads from nine rows.  No gain here (8% on K4); kept for the
//     one triangle layout of the two kernels.
//   * Triangle counts (accel/treelets.py::triangle_counts): a visit stops
//     at the treelet's last triangle instead of testing its all-zero pad
//     slots (30% of the slots, most of a wall treelet's); 1.55 -> 1.16 ms.
//   * One box a step in a refill (intersect.cuh::step_box): a thread
//     takes the next group box or the next member of its current group,
//     so a warp's threads run one slab test together, each in its own
//     group, instead of the warp running the member loops of every group
//     any of its rays enters; 1.16 -> 0.85 ms.
// Stepping one refill or one visit at a time, with a settled thread taking
// the next ray at once, which cut K4 2.5x, did not pay here (1.55 ->
// 1.65 ms): a ray's work varies less than a segment's.
#include "intersect.cuh"

namespace {

using namespace bpt;

template <bool kResident>
__global__ void __launch_bounds__(kStreamThreads, 2)
closest_hit_stream_kernel(const float* __restrict__ bmin,
                          const float* __restrict__ bmax,
                          const float* __restrict__ gmin,
                          const float* __restrict__ gmax,
                          const float* __restrict__ rows,
                          const int32_t* __restrict__ counts,
                          const int32_t* __restrict__ tri_index, int nt,
                          int ng, int g, int k,
                          const float* __restrict__ ray_o,
                          const float* __restrict__ ray_d,
                          const float* __restrict__ min_t,
                          const float* __restrict__ max_t, int b,
                          float* __restrict__ t_out,
                          int32_t* __restrict__ tri_out,
                          float* __restrict__ u_out,
                          float* __restrict__ v_out, int* counter) {
  extern __shared__ float smem[];
  float* gboxes = smem;           // (ng, 6)
  float* mboxes = smem + ng * 6;  // (nt, 6) when resident
  load_boxes(gboxes, gmin, gmax, 0, ng);
  if (kResident) load_boxes(mboxes, bmin, bmax, 0, nt);
  __syncthreads();
  while (true) {
    const int lane = next_lane(counter);
    if (lane >= b) return;
    const Ray r = load_ray(ray_o, ray_d, min_t, max_t, lane);
    Best best;
    if (r.mxt >= r.mnt) {
      float last_e = -INFINITY;
      int last_j = -1;
      Candidates c;
      do {
        fill_candidates_grouped<kResident>(gboxes, ng, g, mboxes, bmin, bmax,
                                           nt, r, best.t, last_e, last_j, c);
        // Visit the buffer front to back.
        for (int v = 0; v < kCandKeys; ++v) {
          float e;
          int j;
          pop_front(c, &e, &j);
          if (j < 0 || !(e < best.t)) {
            c.more = false;  // every candidate visited, or no nearer
            break;
          }
          closest_in_treelet(rows, tri_index, k, (size_t)j, r, best,
                             __ldg(counts + j));
          last_e = e;
          last_j = j;
        }
      } while (c.more);
    }
    t_out[lane] = best.t;
    tri_out[lane] = best.tri;
    u_out[lane] = best.u;
    v_out[lane] = best.v;
  }
}

template <bool kResident>
int launch(const float* bmin, const float* bmax, const float* gmin,
           const float* gmax, const float* rows, const int32_t* counts,
           const int32_t* tri_index, int nt, int ng, int g, int k,
           const float* ray_o, const float* ray_d, const float* min_t,
           const float* max_t, int b, float* t_out, int32_t* tri_out,
           float* u_out, float* v_out, int* counter, cudaStream_t stream) {
  const size_t smem = (size_t)(ng + (kResident ? nt : 0)) * 6 * sizeof(float);
  int grid = 0;
  const cudaError_t e = grouped_launch_config(
      closest_hit_stream_kernel<kResident>, smem, b, &grid);
  if (e != cudaSuccess) return (int)e;
  closest_hit_stream_kernel<kResident>
      <<<grid, kStreamThreads, smem, stream>>>(
          bmin, bmax, gmin, gmax, rows, counts, tri_index, nt, ng, g, k,
          ray_o, ray_d, min_t, max_t, b, t_out, tri_out, u_out, v_out,
          counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bpt_closest_hit_stream(
    const float* bmin, const float* bmax, const float* gmin,
    const float* gmax, const float* rows, const int32_t* counts,
    const int32_t* tri_index, int nt, int ng, int g, int k,
    const float* ray_o, const float* ray_d, const float* min_t,
    const float* max_t, int b, float* t_out, int32_t* tri_out, float* u_out,
    float* v_out, int* counter, void* stream) {
  if (members_resident(nt, ng)) {
    return launch<true>(bmin, bmax, gmin, gmax, rows, counts, tri_index, nt, ng,
                        g, k, ray_o, ray_d, min_t, max_t, b, t_out, tri_out,
                        u_out, v_out, counter, (cudaStream_t)stream);
  }
  return launch<false>(bmin, bmax, gmin, gmax, rows, counts, tri_index, nt, ng,
                       g, k, ray_o, ray_d, min_t, max_t, b, t_out, tri_out,
                       u_out, v_out, counter, (cudaStream_t)stream);
}
