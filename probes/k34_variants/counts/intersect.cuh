// Device code shared by the seven trace kernels (K1 closest_hit.cu, K2
// any_hit.cu, K3 closest_hit_stream.cu, K4 any_hit_stream.cu, K5
// closest_hit_full.cu, K6 closest_hit_sweep.cu, K7 any_hit_compact.cu):
// NaN-propagating min/max, the slab test, Moeller-Trumbore, the triangle
// tests of one treelet, the two traversals of a range of treelets whose
// boxes sit in shared memory, a block-wide prefix count, and the launch
// machinery of the grouped kernels K3 and K4 (box placement, lane
// scheduling, launch geometry).
//
// Every kernel is built with -fmad=false and evaluates in the operation
// order of bpt_tpu/ops/pallas_sweep.py:_slab and _mt_tile, as the plain
// PyTorch versions in bpt_tpu_torch/ops/intersect.py do, so kernel and
// plain version agree bit for bit.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace bpt {

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

struct Ray {
  float o[3];
  float d[3];
  float inv[3];
  float mnt;
  float mxt;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ray_o,
                                        const float* __restrict__ ray_d,
                                        const float* __restrict__ min_t,
                                        const float* __restrict__ max_t,
                                        int lane) {
  Ray r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = ray_o[3 * lane + a];
    r.d[a] = ray_d[3 * lane + a];
    r.inv[a] = inv_dir(r.d[a]);
  }
  r.mnt = min_t[lane];
  r.mxt = max_t[lane];
  return r;
}

// Slab test of one box (bmin xyz, bmax xyz); *entry = max(tnear, 0).
__device__ __forceinline__ bool slab(const float* box, const Ray& r,
                                     float* entry) {
  float tnear = -INFINITY;
  float tfar = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t1 = (box[a] - r.o[a]) * r.inv[a];
    float t2 = (box[3 + a] - r.o[a]) * r.inv[a];
    tnear = nan_max(tnear, nan_min(t1, t2));
    tfar = nan_min(tfar, nan_max(t1, t2));
  }
  *entry = nan_max(tnear, 0.f);
  return (tfar >= tnear) && (tnear <= r.mxt) && (tfar >= r.mnt);
}

// Moeller-Trumbore of one triangle (v0, e1, e2) against a ray.  Returns
// |det| >= EPSILON, u, v inside the triangle and t > T_MIN_HIT; the
// caller applies the ray's window.
__device__ __forceinline__ bool mt_test(float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        const Ray& r, float* t, float* u,
                                        float* v) {
  const float ox = r.o[0], oy = r.o[1], oz = r.o[2];
  const float dx = r.d[0], dy = r.d[1], dz = r.d[2];
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
  *t = tt;
  *u = uu;
  *v = vv;
  return ok && (tt > kTMinHit);
}

// Moeller-Trumbore against slot kk of treelet `row`, read through the
// read-only cache from one of the two layouts of a table's triangles:
//   * kRows false: the (NT, 9, K) block, rows v0xyz, e1xyz, e2xyz; nine
//     4-byte loads from nine rows (K1, K2, K5-K7);
//   * kRows true: the (NT, K, 12) rows of accel/treelets.py::
//     triangle_rows, (v0xyz, e1xyz, e2xyz, 0, 0, 0) per slot; three
//     16-byte loads from one 48-byte slot (K3, K4).
template <bool kRows>
__device__ __forceinline__ bool moller_trumbore(const float* __restrict__ tris,
                                                int k, size_t row, int kk,
                                                const Ray& r, float* t,
                                                float* u, float* v) {
  if (kRows) {
    const float4* p =
        reinterpret_cast<const float4*>(tris) + (row * k + kk) * 3;
    const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    return mt_test(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r, t, u, v);
  }
  const float* blk = tris + row * 9 * k;
  return mt_test(__ldg(blk + 0 * k + kk), __ldg(blk + 1 * k + kk),
                 __ldg(blk + 2 * k + kk), __ldg(blk + 3 * k + kk),
                 __ldg(blk + 4 * k + kk), __ldg(blk + 5 * k + kk),
                 __ldg(blk + 6 * k + kk), __ldg(blk + 7 * k + kk),
                 __ldg(blk + 8 * k + kk), r, t, u, v);
}

// Load boxes [j0, j0 + n) of the (NT, 3) bmin / bmax tables into shared
// memory as (n, 6).  Every thread of the block takes part.
__device__ __forceinline__ void load_boxes(float* boxes,
                                           const float* __restrict__ bmin,
                                           const float* __restrict__ bmax,
                                           int j0, int n) {
  for (int i = threadIdx.x; i < n * 3; i += blockDim.x) {
    const int j = i / 3, a = i % 3;
    boxes[j * 6 + a] = bmin[j0 * 3 + i];
    boxes[j * 6 + 3 + a] = bmax[j0 * 3 + i];
  }
}

// Box j of the (NT, 3) bmin / bmax tables as (bmin xyz, bmax xyz), read
// through the read-only cache.
__device__ __forceinline__ void load_box(float* box,
                                         const float* __restrict__ bmin,
                                         const float* __restrict__ bmax,
                                         int j) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    box[a] = __ldg(bmin + 3 * j + a);
    box[3 + a] = __ldg(bmax + 3 * j + a);
  }
}

// (e1, j1) < (e2, j2), entries compared as floats (so -0.0 equals +0.0):
// the visit order of the closest-hit kernels.
__device__ __forceinline__ bool key_less(float e1, int j1, float e2, int j2) {
  return e1 < e2 || (e1 == e2 && j1 < j2);
}

struct Best {
  float t = INFINITY;
  int32_t tri = -1;
  float u = 0.f;
  float v = 0.f;
};

// The triangles of treelet `row` against one ray, improving `best` in
// place: a hit improves only on a strictly smaller t, so within the
// treelet the lowest slot k wins an equal t.  `tris` is the table's
// block or, with kRows, its rows (moller_trumbore).  Slots [0, n) are
// tested, all K when n < 0: a treelet's slots past its last triangle are
// all-zero pads, which no ray hits (det = 0), so a caller that knows the
// count may stop there.
template <bool kRows = false>
__device__ __forceinline__ void closest_in_treelet(
    const float* __restrict__ tris, const int32_t* __restrict__ tri_index,
    int k, size_t row, const Ray& r, Best& best, int n = -1) {
  const int m = n < 0 ? k : n;
  for (int kk = 0; kk < m; ++kk) {
    float tt, uu, vv;
    bool ok = moller_trumbore<kRows>(tris, k, row, kk, r, &tt, &uu, &vv);
    ok = ok && (tt >= r.mnt) && (tt <= nan_min(best.t, r.mxt));
    if (ok && tt < best.t) {
      best.t = tt;
      best.tri = tri_index[row * k + kk];
      best.u = uu;
      best.v = vv;
    }
  }
}

// Closest hit over treelets [j0, j0 + n), boxes in shared memory,
// improving `best` in place.  Treelets are visited in (entry, index)
// order while entry < best.t: each step rescans the n boxes for the
// lexicographic successor of the last visited (entry, j), so no per-lane
// array is held.
__device__ __forceinline__ void closest_in_boxes(
    const float* boxes, int j0, int n, const float* __restrict__ block,
    const int32_t* __restrict__ tri_index, int k, const Ray& r,
    Best& best) {
  float prev_e = -INFINITY;
  int prev_j = -1;
  while (true) {
    float best_e = INFINITY;
    int best_j = -1;
    for (int j = 0; j < n; ++j) {
      float e;
      if (!slab(&boxes[j * 6], r, &e)) continue;
      if (!(e < best.t)) continue;
      if (!key_less(prev_e, prev_j, e, j)) continue;
      if (e < best_e) {
        best_e = e;
        best_j = j;
      }
    }
    if (best_j < 0) return;
    prev_e = best_e;
    prev_j = best_j;
    closest_in_treelet(block, tri_index, k, (size_t)(j0 + best_j), r, best);
  }
}

// True at the first of treelet `row`'s triangles that the ray hits with
// t in [min_t, max_t].  `tris` and `n` as in closest_in_treelet.
template <bool kRows = false>
__device__ __forceinline__ bool any_in_treelet(
    const float* __restrict__ tris, int k, size_t row, const Ray& r,
    int n = -1) {
  const int m = n < 0 ? k : n;
  for (int kk = 0; kk < m; ++kk) {
    float tt, uu, vv;
    const bool ok =
        moller_trumbore<kRows>(tris, k, row, kk, r, &tt, &uu, &vv);
    if (ok && (tt >= r.mnt) && (tt <= r.mxt)) return true;
  }
  return false;
}

// Occlusion over treelets [j0, j0 + n), boxes in shared memory, in index
// order; true at the first hit with t in [min_t, max_t].
__device__ __forceinline__ bool any_in_boxes(const float* boxes, int j0,
                                             int n,
                                             const float* __restrict__ block,
                                             int k, const Ray& r) {
  for (int j = 0; j < n; ++j) {
    float e;
    if (!slab(&boxes[j * 6], r, &e)) continue;
    if (any_in_treelet(block, k, (size_t)(j0 + j), r)) return true;
  }
  return false;
}

// Exclusive prefix count of `flag` over the kThreads threads of the block
// in thread order; *total gets the block's count.  Every thread of the
// block must call it (it holds two barriers); `warp_counts` is shared
// scratch of kThreads / 32 ints.
__device__ __forceinline__ int block_prefix_count(bool flag,
                                                  int* warp_counts,
                                                  int* total) {
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = __popc(ballot & ((1u << lane) - 1u));
  int sum = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    const int c = warp_counts[w];
    if (w < warp) before += c;
    sum += c;
  }
  __syncthreads();  // warp_counts is free for the next call
  *total = sum;
  return before;
}

// ---- The grouped kernels K3 and K4 -------------------------------------
//
// K3 and K4 take the table in groups of g consecutive treelets, each
// behind its union box (accel/treelets.py::group_boxes), so a ray tests
// a member's box only when it enters the member's group.  The group boxes
// sit in dynamic shared memory; the member boxes too when the table takes
// at most kResidentBytes there, else a thread reads them from global
// memory through the read-only cache (L1, and the 50 MB L2).  Both run
// persistent threads: one grid of as many blocks as fit on the card at
// once, whose threads take lanes from a counter (Aila and Laine,
// "Understanding the Efficiency of Ray Traversal on GPUs", HPG 2009), so
// a block loads its boxes once.  PERF.md has the variants timed on the
// card against this design (probes/k34_old_vs_new.py).

constexpr int kStreamThreads = 384;
// Two blocks of kStreamThreads threads share an SM's 228 KB.
constexpr size_t kResidentBytes = 112 * 1024;

// Whether a table of nt member boxes and ng group boxes keeps its member
// boxes in shared memory.
inline bool members_resident(int nt, int ng) {
  return (size_t)(nt + ng) * 6 * sizeof(float) <= kResidentBytes;
}

// Box j as (bmin xyz, bmax xyz): from the shared-memory copy `sboxes`
// ((n, 6)) when the members are resident, else from the (n, 3) global
// tables.
template <bool kResident>
__device__ __forceinline__ void member_box(float* box, const float* sboxes,
                                           const float* __restrict__ bmin,
                                           const float* __restrict__ bmax,
                                           int j) {
  if (kResident) {
#pragma unroll
    for (int a = 0; a < 6; ++a) box[a] = sboxes[j * 6 + a];
  } else {
    load_box(box, bmin, bmax, j);
  }
}

// The calling thread's next lane from `counter` (0 at the launch), with
// one atomic for the threads of a warp that ask together.
__device__ __forceinline__ int next_lane(int* counter) {
  namespace cg = cooperative_groups;
  cg::coalesced_group asking = cg::coalesced_threads();
  int base = 0;
  if (asking.thread_rank() == 0) {
    base = atomicAdd(counter, (int)asking.size());
  }
  return asking.shfl(base, 0) + (int)asking.thread_rank();
}

// Launch geometry of a grouped kernel that holds `smem` bytes of dynamic
// shared memory: opts in above the 48 KB default and sizes the grid to
// the blocks that fit on the card at once, at most one lane a thread.
// Returns the CUDA error of a refused opt-in (group boxes that do not fit
// in shared memory) after clearing it, so that no later launch reports it
// again.
template <class Kernel>
inline cudaError_t grouped_launch_config(Kernel kernel, size_t smem, int b,
                                         int* grid) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kStreamThreads, smem);
  }
  if (e == cudaSuccess && per_sm == 0) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) cudaGetLastError();
  const int blocks = (b + kStreamThreads - 1) / kStreamThreads;
  *grid = blocks < sms * per_sm ? blocks : sms * per_sm;
  return e;
}

}  // namespace bpt
