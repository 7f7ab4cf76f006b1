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
// with plain per-thread traversal: the NT boxes sit in shared memory, the
// next treelet is chosen by rescanning them (lexicographic minimum of
// (entry, treelet index) above the last visited one, so no per-lane NT
// array is held), and triangle rows are read through the read-only cache.
// Warp coherence comes from the caller's cluster-keyed compaction.  The
// Mosaic workarounds of the TPU kernel (bf16 3-way split, one-hot fetch,
// shift prefix sums, U-rounds, the 0.99 entry slack) are not ported.
//
// Tie rule, shared with the plain PyTorch version in
// bpt_tpu_torch/ops/trace_closest.py: treelets in (entry, index) order, a
// hit improves only on a strictly smaller t, and within a treelet the
// lowest slot k wins an equal t.  Built with -fmad=false and evaluated in
// the operation order of pallas_sweep.py:_mt_tile, so the kernel and the
// plain version agree bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEpsilon = 1e-8f;
constexpr float kTMinHit = 1e-3f;
constexpr float kTiny = 1e-20f;
constexpr int kThreads = 128;

// torch.maximum / torch.minimum semantics: NaN propagates.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float inv_dir(float c) {
  return (c < 0.f ? -1.f : 1.f) / nan_max(fabsf(c), kTiny);
}

// Slab test of one box (boxes: bmin xyz, bmax xyz per treelet).
__device__ __forceinline__ bool slab(const float* box, const float o[3],
                                     const float inv[3], float mnt,
                                     float mxt, float* entry) {
  float tnear = -INFINITY;
  float tfar = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t1 = (box[a] - o[a]) * inv[a];
    float t2 = (box[3 + a] - o[a]) * inv[a];
    tnear = nan_max(tnear, nan_min(t1, t2));
    tfar = nan_min(tfar, nan_max(t1, t2));
  }
  *entry = nan_max(tnear, 0.f);
  return (tfar >= tnear) && (tnear <= mxt) && (tfar >= mnt);
}

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
  for (int i = threadIdx.x; i < nt * 3; i += blockDim.x) {
    int j = i / 3, a = i % 3;
    boxes[j * 6 + a] = bmin[i];
    boxes[j * 6 + 3 + a] = bmax[i];
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b) return;

  const float mnt = min_t[lane];
  const float mxt = max_t[lane];
  float t_best = INFINITY;
  int32_t tri_best = -1;
  float u_best = 0.f, v_best = 0.f;

  if (mxt >= mnt) {
    const float o[3] = {ray_o[3 * lane], ray_o[3 * lane + 1],
                        ray_o[3 * lane + 2]};
    const float d[3] = {ray_d[3 * lane], ray_d[3 * lane + 1],
                        ray_d[3 * lane + 2]};
    const float inv[3] = {inv_dir(d[0]), inv_dir(d[1]), inv_dir(d[2])};
    const float ox = o[0], oy = o[1], oz = o[2];
    const float dx = d[0], dy = d[1], dz = d[2];

    float prev_e = -INFINITY;
    int prev_j = -1;
    while (true) {
      // Next treelet: the lexicographic minimum of (entry, j) above
      // (prev_e, prev_j) among overlapped boxes with entry < t_best.
      float best_e = INFINITY;
      int best_j = -1;
      for (int j = 0; j < nt; ++j) {
        float e;
        if (!slab(&boxes[j * 6], o, inv, mnt, mxt, &e)) continue;
        if (!(e < t_best)) continue;
        if (e < prev_e || (e == prev_e && j <= prev_j)) continue;
        if (e < best_e) {
          best_e = e;
          best_j = j;
        }
      }
      if (best_j < 0) break;
      prev_e = best_e;
      prev_j = best_j;

      const float* blk = block + (size_t)best_j * 9 * k;
      for (int kk = 0; kk < k; ++kk) {
        const float v0x = __ldg(blk + 0 * k + kk);
        const float v0y = __ldg(blk + 1 * k + kk);
        const float v0z = __ldg(blk + 2 * k + kk);
        const float e1x = __ldg(blk + 3 * k + kk);
        const float e1y = __ldg(blk + 4 * k + kk);
        const float e1z = __ldg(blk + 5 * k + kk);
        const float e2x = __ldg(blk + 6 * k + kk);
        const float e2y = __ldg(blk + 7 * k + kk);
        const float e2z = __ldg(blk + 8 * k + kk);
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        bool ok = fabsf(det) >= kEpsilon;
        const float inv_det = 1.0f / (ok ? det : 1.0f);
        const float tx = ox - v0x;
        const float ty = oy - v0y;
        const float tz = oz - v0z;
        const float uu = (tx * px + ty * py + tz * pz) * inv_det;
        ok = ok && (uu >= 0.f) && (uu <= 1.f);
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float vv = (dx * qx + dy * qy + dz * qz) * inv_det;
        ok = ok && (vv >= 0.f) && (uu + vv <= 1.f);
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        ok = ok && (tt > kTMinHit);
        ok = ok && (tt >= mnt) && (tt <= nan_min(t_best, mxt));
        if (ok && tt < t_best) {
          t_best = tt;
          tri_best = tri_index[(size_t)best_j * k + kk];
          u_best = uu;
          v_best = vv;
        }
      }
    }
  }
  t_out[lane] = t_best;
  tri_out[lane] = tri_best;
  u_out[lane] = u_best;
  v_out[lane] = v_best;
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
