// K2: occlusion (any hit) over the treelet table, one thread per segment.
//
// Replaces the TPU kernel bpt_tpu/ops/pallas_sweep.py::_any_kernel /
// _any_loop (entry trace_any_sweep).  What it computes is the same: a
// segment is occluded when any triangle gives a Moeller-Trumbore hit
// (|det| >= EPSILON, t > T_MIN_HIT) with t in [min_t, max_t]; a dead lane
// (max_t < min_t) is never occluded.
//
// What bounds it on an H100: the batch is large (about 8.3M segments per
// BDPT sample at the bench configuration, most of them dead) and each
// live segment costs slab tests plus up to K triangle tests per
// overlapped treelet, so the kernel is bound by FP32 work and warp
// divergence, not by memory: the triangle block (~97 KB here) stays in
// L1/L2.  The design: boxes in shared memory, each thread loops over the
// treelets its segment's slab overlaps, in index order, and returns at
// the first hit in range; a dead lane costs one compare.  The caller's
// compaction packs the dead lanes into whole dead warps and groups live
// segments by spatial cluster.  The TPU kernel's per-tile greedy
// max-coverage union (J = 8 treelets per iteration) exists to amortise
// Mosaic loop overhead and is not ported.
//
// Built with -fmad=false, in the operation order of
// pallas_sweep.py:_mt_tile, so the flags equal those of the plain
// PyTorch version in bpt_tpu_torch/ops/trace_any.py.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEpsilon = 1e-8f;
constexpr float kTMinHit = 1e-3f;
constexpr float kTiny = 1e-20f;
constexpr int kThreads = 128;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float inv_dir(float c) {
  return (c < 0.f ? -1.f : 1.f) / nan_max(fabsf(c), kTiny);
}

__global__ void __launch_bounds__(kThreads)
any_hit_kernel(const float* __restrict__ bmin, const float* __restrict__ bmax,
               const float* __restrict__ block, int nt, int k,
               const float* __restrict__ ray_o,
               const float* __restrict__ ray_d,
               const float* __restrict__ min_t,
               const float* __restrict__ max_t, int b,
               uint8_t* __restrict__ occ_out) {
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
  uint8_t occ = 0;
  if (mxt >= mnt) {
    const float ox = ray_o[3 * lane], oy = ray_o[3 * lane + 1],
                oz = ray_o[3 * lane + 2];
    const float dx = ray_d[3 * lane], dy = ray_d[3 * lane + 1],
                dz = ray_d[3 * lane + 2];
    const float o[3] = {ox, oy, oz};
    const float inv[3] = {inv_dir(dx), inv_dir(dy), inv_dir(dz)};
    for (int j = 0; j < nt && !occ; ++j) {
      const float* box = &boxes[j * 6];
      float tnear = -INFINITY;
      float tfar = INFINITY;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float t1 = (box[a] - o[a]) * inv[a];
        float t2 = (box[3 + a] - o[a]) * inv[a];
        tnear = nan_max(tnear, nan_min(t1, t2));
        tfar = nan_min(tfar, nan_max(t1, t2));
      }
      if (!((tfar >= tnear) && (tnear <= mxt) && (tfar >= mnt))) continue;

      const float* blk = block + (size_t)j * 9 * k;
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
        ok = ok && (tt > kTMinHit) && (tt >= mnt) && (tt <= mxt);
        if (ok) {
          occ = 1;
          break;
        }
      }
    }
  }
  occ_out[lane] = occ;
}

}  // namespace

extern "C" int bpt_any_hit(const float* bmin, const float* bmax,
                           const float* block, int nt, int k,
                           const float* ray_o, const float* ray_d,
                           const float* min_t, const float* max_t, int b,
                           uint8_t* occ_out, void* stream) {
  const int grid = (b + kThreads - 1) / kThreads;
  const size_t smem = (size_t)nt * 6 * sizeof(float);
  any_hit_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      bmin, bmax, block, nt, k, ray_o, ray_d, min_t, max_t, b, occ_out);
  return (int)cudaGetLastError();
}
