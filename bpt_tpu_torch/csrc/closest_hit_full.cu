// K5: closest hit over the full treelet table, one thread per ray, the
// ray's treelet entries computed once into a candidate list.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_trace.py::_kernel (entry
// trace_closest_pallas).  What it computes is K1's closest hit
// (closest_hit.cu), bit for bit: the ray's slab-overlapped treelets are
// visited in (entry, index) order, entry = max(tnear, 0), while entry <
// t_best; a triangle counts with |det| >= EPSILON, t > T_MIN_HIT and
// min_t <= t <= min(t_best, max_t); within a treelet the lowest t and
// then the lowest slot wins, and a hit replaces the best only if strictly
// nearer.  A dead lane (max_t < min_t) and a miss return (inf, -1, 0, 0).
//
// The TPU kernel's own idea is to compute every (ray, treelet) entry once
// and then take the nearest remaining one at each step.  A thread cannot
// hold NT entries, so here each thread keeps a sorted buffer of its
// kCand nearest candidates (entry, index) that come after the last one it
// visited, fills it with one pass over the boxes, visits it front to back
// and refills it only when it runs out: one slab pass per kCand visits,
// where K1 rescans all NT boxes for every visit.  The buffer is kept in
// registers: insertion and removal are unrolled compare-and-swap
// networks with fixed indices.
//
// What bounds it on an H100: the FP32 work of slab tests (NT per pass)
// and triangle tests (K per visit) under divergent per-ray control flow;
// the triangle block is read through the read-only cache and stays in
// L1/L2 at these table sizes.  The candidate list trades K1's repeated
// slab passes for about 2 * kCand registers a thread (78 registers, no
// spills); NT <= MAX_TREELETS (2048) boxes sit in shared memory, as in
// K1.  On an NVIDIA H100 80GB HBM3 (700 W), 262,144 compacted walk rays
// of the glass box took 0.97 ms against K1's 1.00 ms at 19 treelets, and
// 1.53 ms against K1's 5.13 ms at 923, where K1's rescans dominate.
//
// Resuming a refill strictly after the last visited key (entry, index)
// keeps equal entries from being skipped or visited twice; entries are
// compared as floats, so an entry of -0.0 equals one of +0.0.
#include "intersect.cuh"

namespace {

using namespace bpt;

constexpr int kCand = 16;

__device__ __forceinline__ void closest_full(
    const float* boxes, int nt, const float* __restrict__ block,
    const int32_t* __restrict__ tri_index, int k, const Ray& r,
    Best& best) {
  float last_e = -INFINITY;
  int last_j = -1;
  while (true) {
    // Fill: the kCand smallest keys after (last_e, last_j) with entry <
    // t_best, sorted; (inf, -1) marks an empty slot.
    float ce[kCand];
    int cj[kCand];
#pragma unroll
    for (int s = 0; s < kCand; ++s) {
      ce[s] = INFINITY;
      cj[s] = -1;
    }
    int found = 0;
    for (int j = 0; j < nt; ++j) {
      float e;
      if (!slab(&boxes[j * 6], r, &e)) continue;
      if (!(e < best.t) || !key_less(last_e, last_j, e, j)) continue;
      ++found;
      if (!key_less(e, j, ce[kCand - 1], cj[kCand - 1])) continue;
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
      if (j < 0) return;           // every candidate has been visited
      if (!(e < best.t)) return;   // the rest are no nearer
      closest_in_treelet(block, tri_index, k, (size_t)j, r, best);
      last_e = e;
      last_j = j;
    }
    if (found <= kCand) return;    // the buffer held every candidate
  }
}

__global__ void __launch_bounds__(kThreads)
closest_hit_full_kernel(const float* __restrict__ bmin,
                        const float* __restrict__ bmax,
                        const float* __restrict__ block,
                        const int32_t* __restrict__ tri_index, int nt, int k,
                        const float* __restrict__ ray_o,
                        const float* __restrict__ ray_d,
                        const float* __restrict__ min_t,
                        const float* __restrict__ max_t, int b,
                        float* __restrict__ t_out,
                        int32_t* __restrict__ tri_out,
                        float* __restrict__ u_out,
                        float* __restrict__ v_out) {
  extern __shared__ float boxes[];  // (nt, 6)
  load_boxes(boxes, bmin, bmax, 0, nt);
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b) return;

  const Ray r = load_ray(ray_o, ray_d, min_t, max_t, lane);
  Best best;
  if (r.mxt >= r.mnt) {
    closest_full(boxes, nt, block, tri_index, k, r, best);
  }
  t_out[lane] = best.t;
  tri_out[lane] = best.tri;
  u_out[lane] = best.u;
  v_out[lane] = best.v;
}

}  // namespace

extern "C" int bpt_closest_hit_full(const float* bmin, const float* bmax,
                                    const float* block,
                                    const int32_t* tri_index, int nt, int k,
                                    const float* ray_o, const float* ray_d,
                                    const float* min_t, const float* max_t,
                                    int b, float* t_out, int32_t* tri_out,
                                    float* u_out, float* v_out,
                                    void* stream) {
  const int grid = (b + kThreads - 1) / kThreads;
  const size_t smem = (size_t)nt * 6 * sizeof(float);
  closest_hit_full_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      bmin, bmax, block, tri_index, nt, k, ray_o, ray_d, min_t, max_t, b,
      t_out, tri_out, u_out, v_out);
  return (int)cudaGetLastError();
}
