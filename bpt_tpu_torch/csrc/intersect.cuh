// Device code shared by the seven trace kernels (K1 closest_hit.cu, K2
// any_hit.cu, K3 closest_hit_stream.cu, K4 any_hit_stream.cu, K5
// closest_hit_full.cu, K6 closest_hit_sweep.cu, K7 any_hit_compact.cu):
// NaN-propagating min/max, the slab test, Moeller-Trumbore, the triangle
// tests of one treelet, a block-wide prefix count, the candidate buffer
// and the grouped refill of the closest-hit kernels K1, K3 and K5, the
// machinery of the persistent kernels (lane scheduling, launch geometry),
// the box placement of the grouped kernels K3 and K4, the table of K1,
// K2, K5, K6 and K7 (boxes, union boxes, offsets and, when they fit, the
// packed triangles in shared memory) and K1's walk over it, and the tile
// machinery of K6 and K7 (tile scheduling, the tile's treelet union, a
// block sort, the staged walk over the union's packed rows).
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

// Moeller-Trumbore against slot kk of treelet `row` of the (NT, K, 12)
// rows of accel/treelets.py::triangle_rows, (v0xyz, e1xyz, e2xyz, 0, 0,
// 0) per slot, read through the read-only cache: three 16-byte loads from
// one 48-byte slot (K3, K4).
__device__ __forceinline__ bool moller_trumbore(const float* __restrict__ tris,
                                                int k, size_t row, int kk,
                                                const Ray& r, float* t,
                                                float* u, float* v) {
  const float4* p =
      reinterpret_cast<const float4*>(tris) + (row * k + kk) * 3;
  const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  return mt_test(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r, t, u, v);
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

// A closest-hit kernel's result for one lane.
__device__ __forceinline__ void store_best(int lane, const Best& best,
                                           float* __restrict__ t_out,
                                           int32_t* __restrict__ tri_out,
                                           float* __restrict__ u_out,
                                           float* __restrict__ v_out) {
  t_out[lane] = best.t;
  tri_out[lane] = best.tri;
  u_out[lane] = best.u;
  v_out[lane] = best.v;
}

// The triangles of treelet `row` against one ray, improving `best` in
// place: a hit improves only on a strictly smaller t, so within the
// treelet the lowest slot k wins an equal t.  `tris` is the table's rows
// (moller_trumbore).  Slots [0, n) are tested, all K when n < 0: a
// treelet's slots past its last triangle are all-zero pads, which no ray
// hits (det = 0), so a caller that knows the count may stop there.
__device__ __forceinline__ void closest_in_treelet(
    const float* __restrict__ tris, const int32_t* __restrict__ tri_index,
    int k, size_t row, const Ray& r, Best& best, int n = -1) {
  const int m = n < 0 ? k : n;
  for (int kk = 0; kk < m; ++kk) {
    float tt, uu, vv;
    bool ok = moller_trumbore(tris, k, row, kk, r, &tt, &uu, &vv);
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
__device__ __forceinline__ bool any_in_treelet(
    const float* __restrict__ tris, int k, size_t row, const Ray& r,
    int n = -1) {
  const int m = n < 0 ? k : n;
  for (int kk = 0; kk < m; ++kk) {
    float tt, uu, vv;
    const bool ok = moller_trumbore(tris, k, row, kk, r, &tt, &uu, &vv);
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

// ---- The resident-table kernels K1, K2 and K5 --------------------------
//
// K1, K2 and K5 take tables of at most 2,048 treelets and keep all of the
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

// Shared memory of the table of K1, K2 or K5 on nt treelets and n_rows
// packed rows.
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

// K1's walk of one live ray over a flat table: its candidate buffer
// filled from the group boxes and the members of the groups it enters
// below t_best (fill_candidates_grouped), visited front to back while
// entry < t_best, and refilled strictly after the last visited key while
// a key that qualifies did not fit.  Every lane of K1; the lanes of K5
// whose list overflows.
template <bool kResident>
__device__ __forceinline__ void closest_walk_flat(const FlatTable& tab,
                                                  int nt, const Ray& r,
                                                  Best& best) {
  float last_e = -INFINITY;
  int last_j = -1;
  Candidates c;
  do {
    fill_candidates_grouped<true>(tab.gboxes, tab.ng, kFlatGroup, tab.boxes,
                                  nullptr, nullptr, nt, r, best.t, last_e,
                                  last_j, c);
    // Visit the buffer front to back.
    for (int v = 0; v < kCandKeys; ++v) {
      float e;
      int j;
      pop_front(c, &e, &j);
      if (j < 0 || !(e < best.t)) {
        c.more = false;  // every candidate visited, or no nearer
        break;
      }
      closest_in_rows<kResident>(tab.rows, tab.offsets[j],
                                 tab.offsets[j + 1], r, best);
      last_e = e;
      last_j = j;
    }
  } while (c.more);
}

// ---- The tile kernels K6 and K7 ----------------------------------------
//
// K6 and K7 take a tile of kThreads consecutive lanes at a time, one lane
// a thread, in persistent blocks of kThreads threads that load the
// table's boxes and offsets as K1 and K2 do (load_flat_table) and take
// tiles from a counter (next_tile).  A tile with a live lane:
//   1. finds the union of the treelets its lanes overlap with the whole
//      block: each warp slab-tests its 32 lanes against the union box of
//      each run of kFlatGroup treelets and then against the members of
//      the runs one of them enters; K6 keeps the lanes' least entry to
//      each treelet (tile_union, a warp reduction), K7 each warp's ballot
//      (tile_masks), both in shared memory;
//   2. lists the union in index order as (key, index) pairs in shared
//      memory (list_union), which K6 sorts (block_sort);
//   3. walks the list, each warp on its own, and tests a member's packed
//      rows for the lanes of the warp that need it: each thread its own
//      ray over every row, or pooled (the warp takes the lanes one at a
//      time, 32 rows a round) where that takes fewer rounds (use_pool).
//      The rows are read from device memory where they are, through L1
//      (load_row with plain loads), which keeps a member's rows for the
//      warps of the SM that test it after the first; staging them in
//      shared memory, or keeping a small table's rows there, was slower
//      (PERF.md, probes/k67_old_vs_new.py).

constexpr unsigned kAllLanes = 0xffffffffu;
// The key of a treelet that no lane of the tile overlaps: +inf's bits.
constexpr unsigned kNoKey = 0x7f800000u;
// Tiles a block takes from the counter with one atomic: one, and twice
// the last count, up to kMaxTileAsk, while the tiles it took held no
// live lane.
constexpr int kMaxTileAsk = 16;
// Blocks an SM that the tile kernels' launch bounds plan for.
constexpr int kTileMinBlocks = 4;

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 2;
  while (p < n) p <<= 1;
  return p;
}

// Shared memory of K6 or K7: the table's boxes, union boxes and offsets
// (flat_smem_bytes), the tile's keys (K6: one word a treelet; K7: one
// a treelet and warp) and its list.
__host__ __device__ inline size_t tile_key_words(int nt, bool masks) {
  return masks ? (size_t)nt * (kThreads / 32) : (size_t)pad4(nt);
}

__host__ __device__ inline size_t tile_smem_bytes(int nt, bool masks) {
  return flat_smem_bytes(nt, 0, false) +
         tile_key_words(nt, masks) * sizeof(unsigned) +
         (size_t)pow2_at_least(nt) * sizeof(uint64_t);
}

struct TileShared {
  unsigned* keys;  // (tile_key_words,)
  uint64_t* list;  // (pow2_at_least(nt),)
};

__device__ __forceinline__ TileShared tile_shared(float4* smem, int nt,
                                                  bool masks) {
  char* p = reinterpret_cast<char*>(smem) + flat_smem_bytes(nt, 0, false);
  TileShared t;
  t.keys = reinterpret_cast<unsigned*>(p);
  t.list = reinterpret_cast<uint64_t*>(
      p + tile_key_words(nt, masks) * sizeof(unsigned));
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
// overlaps treelet j, kNoKey where none does.  A ray that misses a run's
// union box misses each member's box too (the slab bounds are monotone in
// the box), so a warp skips the members of a run none of its lanes
// enters.  Every thread of the block calls it; ends with a barrier.
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
      const unsigned v = hit ? entry_bits(e) : kNoKey;
      const unsigned lo = __reduce_min_sync(kAllLanes, v);
      if (lid == 0 && lo != kNoKey) atomicMin(keys + j, lo);
    }
  }
  __syncthreads();
}

// The warp's 32 lanes against each treelet: masks[4 j + w] = the ballot
// of warp w's lanes with `consider` whose ray overlaps treelet j (bit i
// for lane i), skipping the members of a run none of them enters, as
// tile_union does.  Every thread of the block calls it; ends with a
// barrier.
__device__ __forceinline__ void tile_masks(const FlatTable& tab, int nt,
                                           const Ray& r, bool consider,
                                           unsigned* masks) {
  const int lid = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int gi = 0; gi < tab.ng; ++gi) {
    float e;
    const bool in = consider && slab(tab.gboxes + gi * 6, r, &e);
    const int j0 = gi * kFlatGroup;
    const int j1 = min(j0 + kFlatGroup, nt);
    unsigned mine = 0;
    if (__any_sync(kAllLanes, in)) {
      for (int j = j0; j < j1; ++j) {
        const unsigned bal =
            __ballot_sync(kAllLanes, in && slab(tab.boxes + j * 6, r, &e));
        if (lid == j - j0) mine = bal;
      }
    }
    if (j0 + lid < j1) masks[(j0 + lid) * 4 + warp] = mine;
  }
  __syncthreads();
}

// The key of treelet j: K6's least entry bits (tile_union), or for K7 0
// where a lane of the tile overlaps it (tile_masks).
struct EntryKey {
  const unsigned* keys;
  __device__ unsigned operator()(int j) const { return keys[j]; }
};
struct MaskKey {
  const unsigned* masks;
  __device__ unsigned operator()(int j) const {
    const unsigned* w = masks + 4 * j;
    return (w[0] | w[1] | w[2] | w[3]) ? 0u : kNoKey;
  }
};

// The treelets with a key, in index order, as (key << 32 | index) into
// list; returns their count.  Every thread of the block calls it; ends
// with a barrier.
template <class Key>
__device__ __forceinline__ int list_union(Key key_of, int nt, uint64_t* list,
                                          int* warp_counts) {
  int m = 0;
  for (int j0 = 0; j0 < nt; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const unsigned key = j < nt ? key_of(j) : kNoKey;
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

// Whether the warp tests a member of n rows for its p lanes that need it
// pooled: p (ceil(n / 32) + 1) rounds, the one for the lane's ray
// counted, against n rounds of each thread testing its own ray.
__device__ __forceinline__ bool use_pool(int p, int n) {
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

// any_in_rows over rows [lo, hi) for the threads of the warp with `act`:
// true in such a thread whose ray hits one of them.  Every thread of the
// warp calls it.
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

// closest_in_rows over rows [lo, hi) for the threads of the warp with
// `act`, improving each one's `best` in place.  Pooled, each thread
// keeps the lowest (t, row) of its rows within the lane's window
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
