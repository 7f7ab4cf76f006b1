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
//   * Triangle rows (accel/treelets.py::triangle_rows): a slot's v0, e1,
//     e2 in 48 contiguous bytes, read with three 16-byte loads through
//     the read-only cache, where the (NT, 9, K) block of K1 takes nine
//     4-byte loads from nine rows.  Neighbouring threads test different
//     treelets, so each load touches as many cache lines as the warp has
//     treelets; fewer loads a triangle means fewer such passes.  The rows
//     (23 MB at 3,656 treelets) stay in the 50 MB L2.
#include "intersect.cuh"

namespace {

using namespace bpt;

constexpr int kCand = 16;

// The candidate buffer of one ray: its kCand smallest (entry, index) keys
// after the last visited one with entry < t_best, sorted, (inf, -1) in an
// empty slot; `more` when a key that qualifies did not fit.
struct Candidates {
  float e[kCand];
  int j[kCand];
  bool more;
};

// Fill `c` with one pass over the group boxes and the members of the
// groups the ray enters below t_best.
template <bool kResident>
__device__ __forceinline__ void fill_candidates(
    const float* gboxes, int ng, int g, const float* mboxes,
    const float* __restrict__ bmin, const float* __restrict__ bmax, int nt,
    const Ray& r, float t_best, float last_e, int last_j, Candidates& c) {
#pragma unroll
  for (int s = 0; s < kCand; ++s) {
    c.e[s] = INFINITY;
    c.j[s] = -1;
  }
  c.more = false;
  for (int gi = 0; gi < ng; ++gi) {
    float ge;
    if (!slab(&gboxes[gi * 6], r, &ge) || !(ge < t_best)) continue;
    // Every member's entry is >= ge: past a full buffer's last key, none
    // fits.
    if (ge > c.e[kCand - 1]) {
      c.more = true;
      continue;
    }
    const int j1 = min(gi * g + g, nt);
    for (int j = gi * g; j < j1; ++j) {
      float box[6];
      member_box<kResident>(box, mboxes, bmin, bmax, j);
      float e;
      if (!slab(box, r, &e)) continue;
      if (!(e < t_best) || !key_less(last_e, last_j, e, j)) continue;
      if (!key_less(e, j, c.e[kCand - 1], c.j[kCand - 1])) {
        c.more = true;
        continue;
      }
      float ie = e;
      int ij = j;
#pragma unroll
      for (int s = 0; s < kCand; ++s) {
        if (key_less(ie, ij, c.e[s], c.j[s])) {
          const float te = c.e[s];
          const int tj = c.j[s];
          c.e[s] = ie;
          c.j[s] = ij;
          ie = te;
          ij = tj;
        }
      }
      // A full buffer pushed its last key out: it comes back in a refill.
      if (ij >= 0) c.more = true;
    }
  }
}

// Take the front key of `c` into (e, j) and shift the rest down.
__device__ __forceinline__ void pop_front(Candidates& c, float* e, int* j) {
  *e = c.e[0];
  *j = c.j[0];
#pragma unroll
  for (int s = 0; s + 1 < kCand; ++s) {
    c.e[s] = c.e[s + 1];
    c.j[s] = c.j[s + 1];
  }
  c.e[kCand - 1] = INFINITY;
  c.j[kCand - 1] = -1;
}

template <bool kResident>
__global__ void __launch_bounds__(kStreamThreads, 2)
closest_hit_stream_kernel(const float* __restrict__ bmin,
                          const float* __restrict__ bmax,
                          const float* __restrict__ gmin,
                          const float* __restrict__ gmax,
                          const float* __restrict__ rows,
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
#if BPT_CLOSEST_STEPS
  // One step at a time: a refill pass or the visit of one treelet.  A
  // thread whose ray settled writes it and takes the next ray at once,
  // while the others of its warp go on.
  int lane = -1;
  Ray r;
  Best best;
  Candidates c;
  float last_e = -INFINITY;
  int last_j = -1;
  bool fill = false;
  while (true) {
    if (lane < 0) {
      lane = next_lane(counter);
      if (lane >= b) break;
      r = load_ray(ray_o, ray_d, min_t, max_t, lane);
      best = Best();
      last_e = -INFINITY;
      last_j = -1;
      fill = r.mxt >= r.mnt;  // a dead lane settles as a miss
      c.j[0] = -1;
      c.more = false;
    }
    if (fill) {
      fill_candidates<kResident>(gboxes, ng, g, mboxes, bmin, bmax, nt, r,
                                 best.t, last_e, last_j, c);
      fill = false;
    }
    float e;
    int j;
    pop_front(c, &e, &j);
    if (j >= 0 && e < best.t) {
      closest_in_treelet<true>(rows, tri_index, k, (size_t)j, r, best);
      last_e = e;
      last_j = j;
      if (c.j[0] >= 0 || !c.more) continue;  // settles at the next step
      fill = true;  // the buffer ran out before its keys did
      continue;
    }
    // No candidate left, or the rest are no nearer than the best hit.
    t_out[lane] = best.t;
    tri_out[lane] = best.tri;
    u_out[lane] = best.u;
    v_out[lane] = best.v;
    lane = -1;
  }
#else
  for_each_lane(b, counter, [&](int lane) {
    const Ray r = load_ray(ray_o, ray_d, min_t, max_t, lane);
    Best best;
    if (r.mxt >= r.mnt) {
      float last_e = -INFINITY;
      int last_j = -1;
      Candidates c;
      do {
        fill_candidates<kResident>(gboxes, ng, g, mboxes, bmin, bmax, nt, r,
                                   best.t, last_e, last_j, c);
        // Visit the buffer front to back.
        for (int v = 0; v < kCand; ++v) {
          float e;
          int j;
          pop_front(c, &e, &j);
          if (j < 0 || !(e < best.t)) {
            c.more = false;  // every candidate visited, or no nearer
            break;
          }
          closest_in_treelet<true>(rows, tri_index, k, (size_t)j, r, best);
          last_e = e;
          last_j = j;
        }
      } while (c.more);
    }
    t_out[lane] = best.t;
    tri_out[lane] = best.tri;
    u_out[lane] = best.u;
    v_out[lane] = best.v;
  });
#endif
}

template <bool kResident>
int launch(const float* bmin, const float* bmax, const float* gmin,
           const float* gmax, const float* rows, const int32_t* tri_index,
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
          bmin, bmax, gmin, gmax, rows, tri_index, nt, ng, g, k, ray_o,
          ray_d, min_t, max_t, b, t_out, tri_out, u_out, v_out, counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bpt_closest_hit_stream(
    const float* bmin, const float* bmax, const float* gmin,
    const float* gmax, const float* rows, const int32_t* tri_index, int nt,
    int ng, int g, int k, const float* ray_o, const float* ray_d,
    const float* min_t, const float* max_t, int b, float* t_out,
    int32_t* tri_out, float* u_out, float* v_out, int* counter,
    void* stream) {
  if (members_resident(nt, ng)) {
    return launch<true>(bmin, bmax, gmin, gmax, rows, tri_index, nt, ng, g,
                        k, ray_o, ray_d, min_t, max_t, b, t_out, tri_out,
                        u_out, v_out, counter, (cudaStream_t)stream);
  }
  return launch<false>(bmin, bmax, gmin, gmax, rows, tri_index, nt, ng, g,
                       k, ray_o, ray_d, min_t, max_t, b, t_out, tri_out,
                       u_out, v_out, counter, (cudaStream_t)stream);
}
