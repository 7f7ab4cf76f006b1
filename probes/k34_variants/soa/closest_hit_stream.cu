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
// What bounds it on an H100: the FP32 slab and Moeller-Trumbore work of
// the treelets a ray needs (those entered below its final t) is about
// 0.1 ms per walk batch of the 3,656-treelet scene; everything above that
// is box work and divergence.  The design, against each cost:
//   * Candidate list (as K5, closest_hit_full.cu): a thread keeps its
//     kCand nearest unvisited (entry, index) keys in registers, visits
//     them front to back, and refills with one pass that resumes strictly
//     after the last visited key, instead of rescanning the boxes at
//     every visit.
//   * Group level: a refill pass slab-tests the NT / g group boxes and
//     only the members of groups entered below t_best (and not beyond a
//     full buffer's last key), so a pass costs about NT / g + a few g box
//     tests instead of NT.  The visit order among members is the keys'
//     order, so the result does not depend on the groups.
//   * Boxes in shared memory: the group boxes always, the member boxes
//     when the whole table fits two blocks to an SM (intersect.cuh,
//     BPT_STREAM_RESIDENT_BYTES); above that members come from global
//     memory through the read-only cache.  Loaded once per block.
//   * Persistent threads (intersect.cuh::for_each_lane): one grid of as
//     many blocks as fit, whose threads take rays from a counter, so a
//     block loads its boxes once and a thread that finishes early takes
//     the next ray instead of idling.
// The (NT, 9, K) triangle rows (17 MB at 3,656 treelets) are read from
// global memory through the read-only cache and stay in L2.
#include "intersect.cuh"

namespace {

using namespace bpt;

constexpr int kCand = 16;

template <bool kResident>
__device__ __forceinline__ void closest_grouped(
    const float* gboxes, int ng, int g, const float* mboxes,
    const float* __restrict__ bmin, const float* __restrict__ bmax, int nt,
    const float* __restrict__ block, const int32_t* __restrict__ tri_index,
    int k, const Ray& r, Best& best) {
  float last_e = -INFINITY;
  int last_j = -1;
  while (true) {
    // Fill: the kCand smallest keys after (last_e, last_j) with entry <
    // t_best, sorted; (inf, -1) marks an empty slot.  `more`: a key that
    // qualifies did not fit.
    float ce[kCand];
    int cj[kCand];
#pragma unroll
    for (int s = 0; s < kCand; ++s) {
      ce[s] = INFINITY;
      cj[s] = -1;
    }
    bool more = false;
    for (int gi = 0; gi < ng; ++gi) {
      float ge;
      if (!slab(&gboxes[gi * 6], r, &ge) || !(ge < best.t)) continue;
      // Every member's entry is >= ge: past a full buffer's last key,
      // none fits.
      if (ge > ce[kCand - 1]) {
        more = true;
        continue;
      }
      const int j1 = min(gi * g + g, nt);
      for (int j = gi * g; j < j1; ++j) {
        float box[6];
        member_box<kResident>(box, mboxes, bmin, bmax, j);
        float e;
        if (!slab(box, r, &e)) continue;
        if (!(e < best.t) || !key_less(last_e, last_j, e, j)) continue;
        if (!key_less(e, j, ce[kCand - 1], cj[kCand - 1])) {
          more = true;
          continue;
        }
        float ie = e;
        int ij = j;
#pragma unroll
        for (int s = 0; s < kCand; ++s) {
          if (key_less(ie, ij, ce[s], cj[s])) {
            const float te = ce[s];
            const int tj = cj[s];
            ce[s] = ie;
            cj[s] = ij;
            ie = te;
            ij = tj;
          }
        }
        // A full buffer pushed its last key out: it is visited after a
        // refill.
        if (ij >= 0) more = true;
      }
    }
    // Visit the buffer front to back, shifting it down after each take.
    for (int v = 0; v < kCand; ++v) {
      const float e = ce[0];
      const int j = cj[0];
#pragma unroll
      for (int s = 0; s + 1 < kCand; ++s) {
        ce[s] = ce[s + 1];
        cj[s] = cj[s + 1];
      }
      ce[kCand - 1] = INFINITY;
      cj[kCand - 1] = -1;
      if (j < 0) return;          // every candidate has been visited
      if (!(e < best.t)) return;  // the rest are no nearer
      closest_in_treelet(block, tri_index, k, (size_t)j, r, best);
      last_e = e;
      last_j = j;
    }
    if (!more) return;  // the buffer held every candidate
  }
}

template <bool kResident>
__global__ void __launch_bounds__(kStreamThreads, 2)
closest_hit_stream_kernel(const float* __restrict__ bmin,
                          const float* __restrict__ bmax,
                          const float* __restrict__ gmin,
                          const float* __restrict__ gmax,
                          const float* __restrict__ block,
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
  for_each_lane(b, counter, [&](int lane) {
    const Ray r = load_ray(ray_o, ray_d, min_t, max_t, lane);
    Best best;
    if (r.mxt >= r.mnt) {
      closest_grouped<kResident>(gboxes, ng, g, mboxes, bmin, bmax, nt,
                                 block, tri_index, k, r, best);
    }
    t_out[lane] = best.t;
    tri_out[lane] = best.tri;
    u_out[lane] = best.u;
    v_out[lane] = best.v;
  });
}

template <bool kResident>
int launch(const float* bmin, const float* bmax, const float* gmin,
           const float* gmax, const float* block, const int32_t* tri_index,
           int nt, int ng, int g, int k, const float* ray_o,
           const float* ray_d, const float* min_t, const float* max_t, int b,
           float* t_out, int32_t* tri_out, float* u_out, float* v_out,
           int* counter, cudaStream_t stream) {
  const size_t smem = (size_t)(ng + (kResident ? nt : 0)) * 6 * sizeof(float);
  int grid = 0;
  const cudaError_t e = grouped_launch_config(
      closest_hit_stream_kernel<kResident>, smem, b, &grid);
  if (e != cudaSuccess) return (int)e;
  cudaMemsetAsync(counter, 0, sizeof(int), stream);
  closest_hit_stream_kernel<kResident>
      <<<grid, kStreamThreads, smem, stream>>>(
          bmin, bmax, gmin, gmax, block, tri_index, nt, ng, g, k, ray_o,
          ray_d, min_t, max_t, b, t_out, tri_out, u_out, v_out, counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bpt_closest_hit_stream(
    const float* bmin, const float* bmax, const float* gmin,
    const float* gmax, const float* block, const int32_t* tri_index, int nt,
    int ng, int g, int k, const float* ray_o, const float* ray_d,
    const float* min_t, const float* max_t, int b, float* t_out,
    int32_t* tri_out, float* u_out, float* v_out, int* counter,
    void* stream) {
  if (members_resident(nt, ng)) {
    return launch<true>(bmin, bmax, gmin, gmax, block, tri_index, nt, ng, g,
                        k, ray_o, ray_d, min_t, max_t, b, t_out, tri_out,
                        u_out, v_out, counter, (cudaStream_t)stream);
  }
  return launch<false>(bmin, bmax, gmin, gmax, block, tri_index, nt, ng, g,
                       k, ray_o, ray_d, min_t, max_t, b, t_out, tri_out,
                       u_out, v_out, counter, (cudaStream_t)stream);
}
