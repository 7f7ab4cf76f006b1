// Device code shared by the seven trace kernels (K1 closest_hit.cu, K2
// any_hit.cu, K3 closest_hit_stream.cu, K4 any_hit_stream.cu, K5
// closest_hit_full.cu, K6 closest_hit_sweep.cu, K7 any_hit_compact.cu):
// NaN-propagating min/max, the slab test, Moeller-Trumbore, the triangle
// tests of one treelet, a block-wide prefix count, the candidate buffer
// and the grouped refill of the closest-hit kernels K1 and K3, the
// machinery of the persistent kernels (lane scheduling, launch geometry),
// the box placement of the grouped kernels K3 and K4, the table of K1,
// K2, K6 and K7 (boxes, union boxes, offsets and, when they fit, the
// packed triangles in shared memory), and the tile machinery of K6 and
// K7 (tile scheduling, the tile's treelet union, a block sort, the
// staged walk over the union's packed rows).
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
//     4-byte loads from nine rows (K5-K7);
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

// ---- The candidate buffer of K1 and K3 ---------------------------------

constexpr int kCandKeys = 16;

// The candidate buffer of one ray: its kCandKeys smallest (entry, index) keys
// after the last visited one with entry < t_best, sorted, (inf, -1) in an
// empty slot; `more` when a key that qualifies did not fit.  Kept in
// registers: insertion and removal are unrolled with fixed indices.
struct Candidates {
  float e[kCandKeys];
  int j[kCandKeys];
  bool more;
};

__device__ __forceinline__ void clear_candidates(Candidates& c) {
#pragma unroll
  for (int s = 0; s < kCandKeys; ++s) {
    c.e[s] = INFINITY;
    c.j[s] = -1;
  }
  c.more = false;
}

// Offer key (e, j), which qualifies, to `c`.  A key past a full buffer's
// last one, and the key a full buffer pushes out, set `more`: they come
// back in a refill.
__device__ __forceinline__ void offer_candidate(Candidates& c, float e,
                                                int j) {
  if (!key_less(e, j, c.e[kCandKeys - 1], c.j[kCandKeys - 1])) {
    c.more = true;
    return;
  }
  float ie = e;
  int ij = j;
#pragma unroll
  for (int s = 0; s < kCandKeys; ++s) {
    if (key_less(ie, ij, c.e[s], c.j[s])) {
      const float te = c.e[s];
      const int tj = c.j[s];
      c.e[s] = ie;
      c.j[s] = ij;
      ie = te;
      ij = tj;
    }
  }
  if (ij >= 0) c.more = true;
}

// Take the front key of `c` into (e, j) and shift the rest down.
__device__ __forceinline__ void pop_front(Candidates& c, float* e, int* j) {
  *e = c.e[0];
  *j = c.j[0];
#pragma unroll
  for (int s = 0; s + 1 < kCandKeys; ++s) {
    c.e[s] = c.e[s + 1];
    c.j[s] = c.j[s + 1];
  }
  c.e[kCandKeys - 1] = INFINITY;
  c.j[kCandKeys - 1] = -1;
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

// The box of one step of a grouped walk, into `box`: member j of the
// group being scanned when `member`, else group box gi.  A thread takes
// one box a step, group or member, so that the threads of a warp, each
// in its own group, run the same slab test together.
template <bool kResident>
__device__ __forceinline__ void step_box(float* box, bool member, int j,
                                         int gi, const float* gboxes,
                                         const float* mboxes,
                                         const float* __restrict__ bmin,
                                         const float* __restrict__ bmax) {
  if (member) {
    member_box<kResident>(box, mboxes, bmin, bmax, j);
  } else {
#pragma unroll
    for (int a = 0; a < 6; ++a) box[a] = gboxes[gi * 6 + a];
  }
}

// Fill `c` with one pass over the group boxes and the members of the
// groups the ray enters below t_best, in index order: the keys after
// (last_e, last_j) with entry < t_best (K1, K3).
template <bool kResident>
__device__ __forceinline__ void fill_candidates_grouped(
    const float* gboxes, int ng, int g, const float* mboxes,
    const float* __restrict__ bmin, const float* __restrict__ bmax, int nt,
    const Ray& r, float t_best, float last_e, int last_j, Candidates& c) {
  clear_candidates(c);
  // One box a step: the next group box, or the next member of the group
  // being scanned (members [j, j1)).
  int gi = 0, j = 0, j1 = 0;
  while (j < j1 || gi < ng) {
    const bool member = j < j1;
    float box[6];
    step_box<kResident>(box, member, j, gi, gboxes, mboxes, bmin, bmax);
    float e;
    const bool in = slab(box, r, &e) && e < t_best;
    if (!member) {
      // Every member's entry is >= the group's: past a full buffer's last
      // key, none fits.
      if (in && e > c.e[kCandKeys - 1]) {
        c.more = true;
      } else if (in) {
        j = gi * g;
        j1 = min(j + g, nt);
      }
      ++gi;
      continue;
    }
    const int jj = j++;
    if (!in || !key_less(last_e, last_j, e, jj)) continue;
    offer_candidate(c, e, jj);
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

// Launch geometry of a persistent kernel of `threads` threads a block
// that holds `smem` bytes of dynamic shared memory: opts in above the
// 48 KB default and sizes the grid to the blocks that fit on the card at
// once, at most one lane a thread.
// Returns the CUDA error of a refused opt-in (group boxes that do not fit
// in shared memory) after clearing it, so that no later launch reports it
// again.
template <class Kernel>
inline cudaError_t grouped_launch_config(Kernel kernel, size_t smem, int b,
                                         int* grid,
                                         int threads = kStreamThreads) {
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
                                                      threads, smem);
  }
  if (e == cudaSuccess && per_sm == 0) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) cudaGetLastError();
  const int blocks = (b + threads - 1) / threads;
  *grid = blocks < sms * per_sm ? blocks : sms * per_sm;
  return e;
}

// ---- The resident-table kernels K1 and K2 ------------------------------
//
// K1 and K2 take tables of at most 2,048 treelets and keep all of the
// table in shared memory: every box, the union box of each run of
// kFlatGroup boxes (which a block computes from the boxes it loads, so
// the callers pass no second table), the (NT + 1) offsets of the packed
// triangles (accel/treelets.py::packed_triangles: each treelet's slots up
// to its last triangle as 48-byte rows, the slot's tri_index in the
// row's tenth word), and the rows themselves too when all of it takes at
// most kResidentBytes; else a thread reads rows from global memory
// through the read-only cache.  Persistent blocks, as K3 and K4.

// Treelets a group, as K3 and K4 on the main path (ops/intersect.py
// STREAM_CHUNK).
constexpr int kFlatGroup = 32;

// Floats to the next multiple of four, so that what follows in shared
// memory stays 16-byte aligned.
__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int flat_groups(int nt) {
  return (nt + kFlatGroup - 1) / kFlatGroup;
}

// Shared memory of K1 or K2 on nt treelets and n_rows packed rows.
__host__ __device__ inline size_t flat_smem_bytes(int nt, int n_rows,
                                                  bool resident) {
  return (size_t)(pad4(nt * 6) + pad4(flat_groups(nt) * 6) + pad4(nt + 1)) *
             sizeof(float) +
         (resident ? (size_t)n_rows * 3 * sizeof(float4) : 0);
}

inline bool rows_resident(int nt, int n_rows) {
  return flat_smem_bytes(nt, n_rows, true) <= kResidentBytes;
}

struct FlatTable {
  const float* boxes;   // (nt, 6), shared memory
  const float* gboxes;  // (ng, 6), shared memory
  int ng;
  const int* offsets;   // (nt + 1,), shared memory
  const float4* rows;   // (n_rows, 3): shared memory when resident
};

// Place the table in the block's shared memory `smem`.  Every thread of
// the block takes part; ends with a barrier.
template <bool kResident>
__device__ __forceinline__ FlatTable load_flat_table(
    float4* smem, const float* __restrict__ bmin,
    const float* __restrict__ bmax, const float4* __restrict__ rows,
    const int32_t* __restrict__ offsets, int nt, int n_rows) {
  const int ng = flat_groups(nt);
  float* boxes = reinterpret_cast<float*>(smem);
  float* gboxes = boxes + pad4(nt * 6);
  int* offs = reinterpret_cast<int*>(gboxes + pad4(ng * 6));
  float4* srows = reinterpret_cast<float4*>(offs + pad4(nt + 1));
  load_boxes(boxes, bmin, bmax, 0, nt);
  for (int i = threadIdx.x; i <= nt; i += blockDim.x) offs[i] = offsets[i];
  if (kResident) {
    for (int i = threadIdx.x; i < n_rows * 3; i += blockDim.x) {
      srows[i] = __ldg(rows + i);
    }
  }
  __syncthreads();
  // The union box of each run of kFlatGroup treelets.
  for (int gi = threadIdx.x; gi < ng; gi += blockDim.x) {
    float lo[3] = {INFINITY, INFINITY, INFINITY};
    float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    const int j1 = min((gi + 1) * kFlatGroup, nt);
    for (int j = gi * kFlatGroup; j < j1; ++j) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], boxes[j * 6 + a]);
        hi[a] = fmaxf(hi[a], boxes[j * 6 + 3 + a]);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      gboxes[gi * 6 + a] = lo[a];
      gboxes[gi * 6 + 3 + a] = hi[a];
    }
  }
  __syncthreads();
  FlatTable t;
  t.boxes = boxes;
  t.gboxes = gboxes;
  t.ng = ng;
  t.offsets = offs;
  t.rows = kResident ? srows : rows;
  return t;
}

// Packed row i: v0, e1, e2 and the tri_index of its slot.
struct TriangleRow {
  float4 a, b, c;
  __device__ __forceinline__ int32_t tri() const {
    return __float_as_int(c.y);
  }
};

template <bool kResident>
__device__ __forceinline__ TriangleRow load_row(const float4* rows, int i) {
  const float4* p = rows + (size_t)i * 3;
  TriangleRow w;
  if (kResident) {
    w.a = p[0];
    w.b = p[1];
    w.c = p[2];
  } else {
    w.a = __ldg(p);
    w.b = __ldg(p + 1);
    w.c = __ldg(p + 2);
  }
  return w;
}

__device__ __forceinline__ bool mt_row(const TriangleRow& w, const Ray& r,
                                       float* t, float* u, float* v) {
  return mt_test(w.a.x, w.a.y, w.a.z, w.a.w, w.b.x, w.b.y, w.b.z, w.b.w,
                 w.c.x, r, t, u, v);
}

// closest_in_treelet over packed rows [lo, hi) of one treelet.
template <bool kResident>
__device__ __forceinline__ void closest_in_rows(const float4* rows, int lo,
                                                int hi, const Ray& r,
                                                Best& best) {
  for (int i = lo; i < hi; ++i) {
    const TriangleRow w = load_row<kResident>(rows, i);
    float tt, uu, vv;
    bool ok = mt_row(w, r, &tt, &uu, &vv);
    ok = ok && (tt >= r.mnt) && (tt <= nan_min(best.t, r.mxt));
    if (ok && tt < best.t) {
      best.t = tt;
      best.tri = w.tri();
      best.u = uu;
      best.v = vv;
    }
  }
}

// any_in_treelet over packed rows [lo, hi) of one treelet.
template <bool kResident>
__device__ __forceinline__ bool any_in_rows(const float4* rows, int lo,
                                            int hi, const Ray& r) {
  for (int i = lo; i < hi; ++i) {
    const TriangleRow w = load_row<kResident>(rows, i);
    float tt, uu, vv;
    if (mt_row(w, r, &tt, &uu, &vv) && (tt >= r.mnt) && (tt <= r.mxt)) {
      return true;
    }
  }
  return false;
}

// ---- The tile kernels K6 and K7 ----------------------------------------
//
// K6 and K7 take a tile of kThreads consecutive lanes at a time, one lane
// a thread, in persistent blocks of kThreads threads that load the table
// as K1 and K2 do (load_flat_table) and take tiles from a counter
// (next_tile).  A tile with a live lane:
//   1. finds the union of the treelets its lanes overlap with the whole
//      block (tile_union): each warp slab-tests its 32 lanes against the
//      union box of each run of kFlatGroup treelets and then against the
//      members of the runs one of them enters, and a warp reduction puts
//      the lanes' least entry into the treelet's key;
//   2. lists the union in index order as (key, index) pairs
//      (list_union), which K6 sorts (block_sort);
//   3. walks the list (tile_walk), each warp on its own: where the
//      table's packed rows are not resident, the rows of the next chunk
//      of listed treelets are copied into shared memory (cp.async) while
//      the warps test the current chunk, so the tile reads each member's
//      rows from device memory once;
//   4. tests a member's rows for the lanes of a warp that need it, each
//      thread its own ray over every row, or pooled (the warp takes the
//      lanes one at a time, 32 rows a round) where that takes fewer
//      rounds (use_pool).

constexpr unsigned kAllLanes = 0xffffffffu;
// The key of a treelet that no lane of the tile overlaps: +inf's bits.
constexpr unsigned kNoKey = 0x7f800000u;
// Tiles a block takes from the counter with one atomic: one, and twice
// the last count, up to kMaxTileAsk, while the tiles it took held no
// live lane.
constexpr int kMaxTileAsk = 16;
// Blocks an SM that the tile kernels' launch bounds plan for.
constexpr int kTileMinBlocks = 4;
// A table whose tile kernels' shared memory, rows included, fits in this
// many bytes keeps its rows resident (two blocks an SM at least).
#ifndef BPT_TILE_RESIDENT_KB
#define BPT_TILE_RESIDENT_KB 112
#endif
constexpr size_t kTileResidentBytes = BPT_TILE_RESIDENT_KB * 1024;
// 0: a table whose rows are not resident is read from device memory
// where it is, not staged (a design step measured against staging).
#ifndef BPT_TILE_STAGE
#define BPT_TILE_STAGE 1
#endif

// Rows of one stage buffer, and listed treelets of one chunk, at most.
#ifndef BPT_STAGE_ROWS
#define BPT_STAGE_ROWS 256
#endif
constexpr int kStageRows = BPT_STAGE_ROWS;
constexpr int kChunkMembers = 32;

// 0: each thread tests its own ray over a member's rows; 2: always pooled;
// 1: whichever takes fewer rounds (use_pool).
#ifndef BPT_TILE_POOL
#define BPT_TILE_POOL 1
#endif

// List positions [c0, c1) staged together, and each member's first row
// in its stage buffer.
struct TileChunk {
  int c0, c1;
  int soff[kChunkMembers];
  int pad[2];  // 16-byte size
};

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 2;
  while (p < n) p <<= 1;
  return p;
}

// Shared memory of K6 or K7: the table (flat_smem_bytes), the tile's
// keys and list, and with staged rows three chunk plans and two stage
// buffers.
__host__ __device__ inline size_t tile_smem_bytes(int nt, int n_rows,
                                                  bool resident) {
  size_t s = flat_smem_bytes(nt, n_rows, resident) +
             (size_t)pad4(nt) * sizeof(unsigned) +
             (size_t)pow2_at_least(nt) * sizeof(uint64_t);
  if (!resident && BPT_TILE_STAGE) {
    s += 3 * sizeof(TileChunk) + 2 * (size_t)kStageRows * 3 * sizeof(float4);
  }
  return s;
}

inline bool tile_rows_resident(int nt, int n_rows) {
  return tile_smem_bytes(nt, n_rows, true) <= kTileResidentBytes;
}

struct TileShared {
  unsigned* keys;     // (nt,)
  uint64_t* list;     // (pow2_at_least(nt),)
  TileChunk* chunks;  // (3,), staged rows only
  float4* stage;      // (2 * kStageRows * 3,), staged rows only
};

__device__ __forceinline__ TileShared tile_shared(float4* smem, int nt,
                                                  int n_rows, bool resident) {
  char* p = reinterpret_cast<char*>(smem) +
            flat_smem_bytes(nt, n_rows, resident);
  TileShared t;
  t.keys = reinterpret_cast<unsigned*>(p);
  p += (size_t)pad4(nt) * sizeof(unsigned);
  t.list = reinterpret_cast<uint64_t*>(p);
  p += (size_t)pow2_at_least(nt) * sizeof(uint64_t);
  t.chunks = reinterpret_cast<TileChunk*>(p);
  t.stage = reinterpret_cast<float4*>(p + 3 * sizeof(TileChunk));
  return t;
}

// The tiles a block has taken from the counter, [next, end).
struct TileQueue {
  int next = 0, end = 0, ask = 1;
  bool live = true;  // whether a tile of the last ask held a live lane
};

// The block's next tile, or -1 once none is left.  Every thread of the
// block calls it; `slot` is shared scratch, which thread 0 writes when it
// asks the counter again, after the tile's barriers.
__device__ __forceinline__ int next_tile(TileQueue& q, int* counter,
                                         int n_tiles, int* slot) {
  if (q.next >= q.end) {
    q.ask = q.live ? 1 : min(2 * q.ask, kMaxTileAsk);
    if (threadIdx.x == 0) *slot = atomicAdd(counter, q.ask);
    __syncthreads();
    q.next = *slot;
    q.end = min(q.next + q.ask, n_tiles);
    q.live = false;
    if (q.next >= n_tiles) return -1;
  }
  return q.next++;
}

// An entry as key bits: non-negative floats order as their bits once
// -0.0 is +0.0 (entries compare as floats, key_less).
__device__ __forceinline__ unsigned entry_bits(float e) {
  return e == 0.f ? 0u : __float_as_uint(e);
}

// keys[j]: the least entry_bits of the lanes with `consider` whose ray
// overlaps treelet j (with kFlagOnly 0), kNoKey where none does.  A ray
// that misses a run's union box misses each member's box too (the slab
// bounds are monotone in the box), so a warp skips the members of a run
// none of its lanes enters.  Every thread of the block calls it; ends
// with a barrier.
template <bool kFlagOnly>
__device__ __forceinline__ void tile_union(const FlatTable& tab, int nt,
                                           const Ray& r, bool consider,
                                           unsigned* keys) {
  for (int j = threadIdx.x; j < nt; j += kThreads) keys[j] = kNoKey;
  __syncthreads();
  const int lid = threadIdx.x & 31;
  for (int gi = 0; gi < tab.ng; ++gi) {
    float e;
    const bool in = consider && slab(tab.gboxes + gi * 6, r, &e);
    if (!__any_sync(kAllLanes, in)) continue;
    const int j1 = min((gi + 1) * kFlatGroup, nt);
    for (int j = gi * kFlatGroup; j < j1; ++j) {
      const bool hit = in && slab(tab.boxes + j * 6, r, &e);
      const unsigned v = hit ? (kFlagOnly ? 0u : entry_bits(e)) : kNoKey;
      const unsigned lo = __reduce_min_sync(kAllLanes, v);
      if (lid == 0 && lo != kNoKey) atomicMin(keys + j, lo);
    }
  }
  __syncthreads();
}

// The treelets with a key, in index order, as (key << 32 | index) into
// list; returns their count.  Every thread of the block calls it; ends
// with a barrier.
__device__ __forceinline__ int list_union(const unsigned* keys, int nt,
                                          uint64_t* list, int* warp_counts) {
  int m = 0;
  for (int j0 = 0; j0 < nt; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const unsigned key = j < nt ? keys[j] : kNoKey;
    const bool in = key != kNoKey;
    int total;
    const int before = block_prefix_count(in, warp_counts, &total);
    if (in) list[m + before] = ((uint64_t)key << 32) | (unsigned)j;
    m += total;
  }
  __syncthreads();
  return m;
}

// list[0, m) in ascending order: a bitonic sort over the next power of
// two, padded with ~0.  Every thread of the block calls it; ends with a
// barrier.
__device__ __forceinline__ void block_sort(uint64_t* list, int m) {
  const int p = pow2_at_least(m);
  for (int i = m + threadIdx.x; i < p; i += kThreads) list[i] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int h = k >> 1; h > 0; h >>= 1) {
      for (int i = threadIdx.x; i < p; i += kThreads) {
        const int l = i ^ h;
        if (l > i) {
          const uint64_t a = list[i], c = list[l];
          if ((a > c) == ((i & k) == 0)) {
            list[i] = c;
            list[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int list_index(uint64_t x) {
  return (int)(uint32_t)x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Plan the chunk that starts at list position c0: as many members as fit
// in kStageRows rows, at most kChunkMembers.  A member of more rows than
// a buffer holds (K above kStageRows) makes a chunk of its own, read from
// device memory where it is (soff -1).  The 32 threads of one warp call
// it.
__device__ __forceinline__ void plan_chunk(TileChunk* ch, int c0, int m,
                                           const uint64_t* list,
                                           const int* offsets) {
  const int lid = threadIdx.x & 31;
  const int c = c0 + lid;
  int n = 0;
  if (c < m) {
    const int j = list_index(list[c]);
    n = offsets[j + 1] - offsets[j];
  }
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAllLanes, incl, d);
    if (lid >= d) incl += y;
  }
  const unsigned fits = __ballot_sync(kAllLanes, c < m && incl <= kStageRows);
  const bool alone = fits == 0 && c0 < m;
  ch->soff[lid] = alone ? -1 : incl - n;
  if (lid == 0) {
    ch->c0 = c0;
    ch->c1 = c0 + (alone ? 1 : __popc(fits));
  }
}

// Copy the rows of chunk `ch`'s members into `buf` (cp.async, one commit
// group).  Every thread of the block calls it.
__device__ __forceinline__ void stage_chunk(const TileChunk* ch,
                                            const uint64_t* list,
                                            const int* offsets,
                                            const float4* __restrict__ rows,
                                            float4* buf) {
  for (int c = ch->c0; c < ch->c1; ++c) {
    const int so = ch->soff[c - ch->c0];
    if (so < 0) continue;
    const int j = list_index(list[c]);
    const int lo = offsets[j];
    const int n3 = 3 * (offsets[j + 1] - lo);
    const float4* src = rows + (size_t)lo * 3;
    float4* dst = buf + 3 * so;
    for (int i = threadIdx.x; i < n3; i += kThreads) {
      cp_async16(dst + i, src + i);
    }
  }
  cp_async_commit();
}

// Walk list[0, m) in order: each warp calls visit(c, j, rows, lo, hi) for
// list position c (treelet j, its packed rows [lo, hi) of `rows`, in
// shared memory) until visit returns false, which it must do in all 32
// threads of the warp at once: the warp is done with the tile.  Resident
// rows are read where they sit, and the warps never wait for each other.
// Otherwise the list goes in chunks through two stage buffers: while the
// warps test chunk q, the rows of chunk q + 1 are on their way; one
// barrier a chunk, which also ends the walk once every warp is done.
// Every thread of the block calls it.
template <bool kResident, class Visit>
__device__ __forceinline__ void tile_walk(const FlatTable& tab,
                                          const TileShared& ts, int m,
                                          Visit&& visit) {
  if (kResident || !BPT_TILE_STAGE) {
    for (int c = 0; c < m; ++c) {
      const int j = list_index(ts.list[c]);
      if (!visit(c, j, tab.rows, tab.offsets[j], tab.offsets[j + 1])) break;
    }
    return;
  }
  const int warp = threadIdx.x >> 5;
  if (warp == 0) plan_chunk(ts.chunks, 0, m, ts.list, tab.offsets);
  __syncthreads();
  stage_chunk(ts.chunks, ts.list, tab.offsets, tab.rows, ts.stage);
  bool going = true;
  for (int q = 0;; ++q) {
    const TileChunk* cur = ts.chunks + q % 3;
    TileChunk* nxt = ts.chunks + (q + 1) % 3;
    // Chunk q - 1's plan is still being read, chunk q + 1's is free.
    if (warp == 0) plan_chunk(nxt, cur->c1, m, ts.list, tab.offsets);
    cp_async_wait_all();
    if (!__syncthreads_or(going) || cur->c0 >= m) break;
    // Every warp is past chunk q - 1, whose buffer takes chunk q + 1.
    stage_chunk(nxt, ts.list, tab.offsets, tab.rows,
                ts.stage + ((q + 1) & 1) * kStageRows * 3);
    const float4* buf = ts.stage + (q & 1) * kStageRows * 3;
    for (int c = cur->c0; going && c < cur->c1; ++c) {
      const int j = list_index(ts.list[c]);
      const int so = cur->soff[c - cur->c0];
      const int n = tab.offsets[j + 1] - tab.offsets[j];
      going = so < 0 ? visit(c, j, tab.rows, tab.offsets[j], tab.offsets[j] + n)
                     : visit(c, j, buf, so, so + n);
    }
  }
}

// Whether the warp tests a member of n rows for its p lanes that need it
// pooled: p (ceil(n / 32) + 1) rounds, the one for the lane's ray
// counted, against n rounds of each thread testing its own ray.
__device__ __forceinline__ bool use_pool(int p, int n) {
  if (BPT_TILE_POOL == 0) return false;
  if (BPT_TILE_POOL == 2) return true;
  return p * ((n + 31) / 32 + 1) < n;
}

// Lane src's ray (origin, direction and window) in every thread of the
// warp.
__device__ __forceinline__ Ray shfl_ray(const Ray& r, int src) {
  Ray q;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    q.o[a] = __shfl_sync(kAllLanes, r.o[a], src);
    q.d[a] = __shfl_sync(kAllLanes, r.d[a], src);
    q.inv[a] = 0.f;
  }
  q.mnt = __shfl_sync(kAllLanes, r.mnt, src);
  q.mxt = __shfl_sync(kAllLanes, r.mxt, src);
  return q;
}

// any_in_rows over shared-memory rows [lo, hi) for the threads of the
// warp with `act`: true in such a thread whose ray hits one of them.
// Every thread of the warp calls it.
__device__ __forceinline__ bool any_rows(const float4* rows, int lo, int hi,
                                         bool act, const Ray& r) {
  const unsigned bal = __ballot_sync(kAllLanes, act);
  if (!bal) return false;
  if (!use_pool(__popc(bal), hi - lo)) {
    return act && any_in_rows<true>(rows, lo, hi, r);
  }
  const int lid = threadIdx.x & 31;
  bool hit = false;
  unsigned pending = bal;
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const Ray q = shfl_ray(r, src);
    bool any = false;
    for (int s = lo; s < hi && !any; s += 32) {
      const int i = s + lid;
      bool h = false;
      if (i < hi) {
        const TriangleRow w = load_row<true>(rows, i);
        float tt, uu, vv;
        h = mt_row(w, q, &tt, &uu, &vv) && (tt >= q.mnt) && (tt <= q.mxt);
      }
      any = __any_sync(kAllLanes, h);
    }
    if (lid == src) hit = any;
  }
  return hit;
}

// closest_in_rows over shared-memory rows [lo, hi) for the threads of the
// warp with `act`, improving each one's `best` in place.  Pooled, each
// thread keeps the lowest (t, row) of its rows within the lane's window
// (min_t <= t <= min(t_best, max_t)), the warp reduces them by (t, row),
// and the lane takes the result if t < t_best: as closest_in_rows, the
// lowest slot on an equal t and strict `<` to improve.  Every thread of
// the warp calls it.
__device__ __forceinline__ void closest_rows(const float4* rows, int lo,
                                             int hi, bool act, const Ray& r,
                                             Best& best) {
  const unsigned bal = __ballot_sync(kAllLanes, act);
  if (!bal) return;
  if (!use_pool(__popc(bal), hi - lo)) {
    if (act) closest_in_rows<true>(rows, lo, hi, r, best);
    return;
  }
  const int lid = threadIdx.x & 31;
  unsigned pending = bal;
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const Ray q = shfl_ray(r, src);
    const float t_hi = nan_min(__shfl_sync(kAllLanes, best.t, src), q.mxt);
    float bt = INFINITY, bu = 0.f, bv = 0.f;
    int bi = -1;
    for (int i = lo + lid; i < hi; i += 32) {
      const TriangleRow w = load_row<true>(rows, i);
      float tt, uu, vv;
      if (mt_row(w, q, &tt, &uu, &vv) && (tt >= q.mnt) && (tt <= t_hi) &&
          tt < bt) {
        bt = tt;
        bi = i;
        bu = uu;
        bv = vv;
      }
    }
    // A hit's t is above T_MIN_HIT, so t orders as its bits.
    unsigned kt = __float_as_uint(bt), ki = (unsigned)bi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned ot = __shfl_xor_sync(kAllLanes, kt, off);
      const unsigned oi = __shfl_xor_sync(kAllLanes, ki, off);
      if (ot < kt || (ot == kt && oi < ki)) {
        kt = ot;
        ki = oi;
      }
    }
    if (ki == 0xffffffffu) continue;
    const int win = (int)(ki - (unsigned)lo) & 31;
    const float u = __shfl_sync(kAllLanes, bu, win);
    const float v = __shfl_sync(kAllLanes, bv, win);
    const float t = __uint_as_float(kt);
    if (lid == src && t < best.t) {
      best.t = t;
      best.tri = load_row<true>(rows, (int)ki).tri();
      best.u = u;
      best.v = v;
    }
  }
}

}  // namespace bpt
