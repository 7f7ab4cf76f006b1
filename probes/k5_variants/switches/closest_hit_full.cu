// K5 (closest_hit_full.cu) with the switches its design was measured
// with (probes/k5_old_vs_new.py builds it with -D flags and -I pointing
// at bpt_tpu_torch/csrc for intersect.cuh).  Defaults give the package's
// design.
//   BPT_K5_LISTS      1: the warp's entry lists (steps 1-3); 0: step A,
//                     K1's walk on every lane (closest_walk_flat) in K1's
//                     blocks of kStreamThreads, two an SM
//   BPT_K5_KEYS       keys a lane's list holds
//   BPT_K5_OWN        lanes entering a run from which each thread scans
//                     the run for its own ray (33: always spread)
//   BPT_K5_THREADS    threads a block; BPT_K5_MIN_BLOCKS blocks an SM in
//                     the launch bounds
//   BPT_K5_RESIDENT   0: the packed rows never in shared memory
//   BPT_K5_SORT       1: insertion sort, then the list front to back;
//                     0: no sort, each visit takes the least key after
//                     the last visited one
#include "intersect.cuh"

namespace {

using namespace bpt;

#ifndef BPT_K5_LISTS
#define BPT_K5_LISTS 1
#endif
#ifndef BPT_K5_KEYS
#define BPT_K5_KEYS 16
#endif
#ifndef BPT_K5_OWN
#define BPT_K5_OWN 24
#endif
#ifndef BPT_K5_THREADS
#define BPT_K5_THREADS 256
#endif
#ifndef BPT_K5_MIN_BLOCKS
#define BPT_K5_MIN_BLOCKS 2
#endif
#ifndef BPT_K5_RESIDENT
#define BPT_K5_RESIDENT 1
#endif
#ifndef BPT_K5_SORT
#define BPT_K5_SORT 1
#endif

// Keys a lane's list holds.
constexpr int kListKeys = BPT_K5_KEYS;
constexpr int kFullThreads = BPT_K5_LISTS ? BPT_K5_THREADS : kStreamThreads;
// Blocks an SM that the launch bounds plan for: up to 128 registers a
// thread.
constexpr int kFullMinBlocks = BPT_K5_MIN_BLOCKS;
// Lanes of the warp entering a run from which each thread scans the run's
// members for its own ray (step 2 spreads the pairs of a run that fewer
// lanes enter).
constexpr int kOwnScan = BPT_K5_OWN;

// A warp's part of the block's shared memory.  Lane l's list is at
// keys[l * kListStride]: an odd stride, so the threads of the warp reach
// their own lists' i-th keys in distinct banks, and a step's appends to
// one list fall on consecutive words.
constexpr int kListStride = kListKeys + 1;
struct WarpLists {
  uint64_t keys[32 * kListStride];
  float4 rays[2 * 32];  // lane l: (o, min_t), (1 / d, max_t)
  int lanes[32];        // the lanes that enter the run being spread
};

inline size_t full_smem_bytes(int nt, int n_rows, bool resident) {
  return flat_smem_bytes(nt, n_rows, resident) +
         (BPT_K5_LISTS ? (kFullThreads / 32) * sizeof(WarpLists) : 0);
}

__device__ __forceinline__ Ray warp_ray(const WarpLists& w, int l) {
  const float4 a = w.rays[2 * l], c = w.rays[2 * l + 1];
  Ray q;
  q.o[0] = a.x;
  q.o[1] = a.y;
  q.o[2] = a.z;
  q.inv[0] = c.x;
  q.inv[1] = c.y;
  q.inv[2] = c.z;
  q.d[0] = q.d[1] = q.d[2] = 0.f;  // the slab test reads no direction
  q.mnt = a.w;
  q.mxt = c.w;
  return q;
}

// Steps 1 and 2: the keys of every treelet whose box the ray of each live
// lane of the warp overlaps with entry < inf (K1's first fill: t_best is
// inf), into its lane's list in `w`.  Returns the calling lane's number
// of keys, past kListKeys for a list that overflowed (whose keys past it
// are not kept).  Every thread of the warp calls it.
__device__ __forceinline__ int warp_entry_lists(const FlatTable& tab, int nt,
                                                const Ray& r, bool live,
                                                WarpLists& w) {
  const int lid = threadIdx.x & 31;
  uint64_t* mine = w.keys + lid * kListStride;
  int count = 0;
  if (live) {
    w.rays[2 * lid] = make_float4(r.o[0], r.o[1], r.o[2], r.mnt);
    w.rays[2 * lid + 1] = make_float4(r.inv[0], r.inv[1], r.inv[2], r.mxt);
  }
  // Thread t keeps the ballots of runs t and t + 32 (at most 64 runs).
  unsigned runs_lo = 0u, runs_hi = 0u;
  for (int gi = 0; gi < tab.ng; ++gi) {
    float e;
    const bool in =
        live && slab(tab.gboxes + gi * 6, r, &e) && e < INFINITY;
    const unsigned bal = __ballot_sync(kAllLanes, in);
    if (lid == (gi & 31)) {
      if (gi < 32) {
        runs_lo = bal;
      } else {
        runs_hi = bal;
      }
    }
  }
  const unsigned below = (1u << lid) - 1u;
  for (int gi = 0; gi < tab.ng; ++gi) {
    const unsigned m =
        __shfl_sync(kAllLanes, gi < 32 ? runs_lo : runs_hi, gi & 31);
    if (m == 0u) continue;
    const int j0 = gi * kFlatGroup;
    const int s = min(kFlatGroup, nt - j0);
    const bool entered = (m >> lid) & 1u;
    if (__popc(m) >= kOwnScan) {
      // Most lanes enter the run: each thread scans its members for its
      // own ray, as K1 does.
      for (int j = j0; entered && j < j0 + s; ++j) {
        float e;
        if (slab(tab.boxes + j * 6, r, &e) && e < INFINITY) {
          if (count < kListKeys) {
            mine[count] = ((uint64_t)entry_bits(e) << 32) | (unsigned)j;
          }
          ++count;
        }
      }
      continue;
    }
    // Pair f of the run: lane lanes[f / s] against member f % s, 32 a
    // step.  A lane's pairs are consecutive, so each step's threads on one
    // lane are a run [t0, t1) of the warp.
    const int rank = __popc(m & below);
    if (entered) w.lanes[rank] = lid;
    __syncwarp();
    const int total = __popc(m) * s;
    for (int f0 = 0; f0 < total; f0 += 32) {
      const int f = f0 + lid;
      const bool act = f < total;
      int p = 0, l = 0;
      bool in = false;
      uint64_t key = 0;
      if (act) {
        p = s == kFlatGroup ? f / kFlatGroup : f / s;
        l = w.lanes[p];
        const int j = j0 + (f - p * s);
        float e;
        in = slab(tab.boxes + j * 6, warp_ray(w, l), &e) && e < INFINITY;
        key = ((uint64_t)entry_bits(e) << 32) | (unsigned)j;
      }
      const int c = __shfl_sync(kAllLanes, count, l);
      const unsigned seg =
          __ballot_sync(kAllLanes, in) & ~((1u << max(p * s - f0, 0)) - 1u);
      const int pos = c + __popc(seg & below);
      if (in && pos < kListKeys) w.keys[l * kListStride + pos] = key;
      // Lane lid's count, from the last thread of its run in this step.
      const int hi = min(min((rank + 1) * s, total), f0 + 32) - 1 - f0;
      const bool here = entered && hi >= 0 && rank * s < f0 + 32;
      const int after =
          __shfl_sync(kAllLanes, pos + (int)in, here ? hi : lid);
      if (here) count = after;
    }
    __syncwarp();  // the lanes' slots are free for the next run
  }
  __syncwarp();  // every key is in its list
  return count;
}

// Step 3: the n keys of `keys` sorted, and visited in order while entry <
// t_best.  The keys are distinct (their indices are).
template <bool kResident>
__device__ __forceinline__ void walk_list(const FlatTable& tab,
                                          uint64_t* keys, int n, const Ray& r,
                                          Best& best) {
  if (!BPT_K5_SORT) {
    uint64_t last = 0;
    for (int v = 0; v < n; ++v) {
      uint64_t x = ~0ull;
      for (int i = 0; i < n; ++i) {
        const uint64_t y = keys[i];
        if ((v == 0 || y > last) && y < x) x = y;
      }
      if (!(__uint_as_float((unsigned)(x >> 32)) < best.t)) return;
      const int j = (int)(unsigned)x;
      closest_in_rows<kResident>(tab.rows, tab.offsets[j],
                                 tab.offsets[j + 1], r, best);
      last = x;
    }
    return;
  }
  for (int i = 1; i < n; ++i) {
    const uint64_t x = keys[i];
    int k = i - 1;
    while (k >= 0 && keys[k] > x) {
      keys[k + 1] = keys[k];
      --k;
    }
    keys[k + 1] = x;
  }
  for (int i = 0; i < n; ++i) {
    const uint64_t x = keys[i];
    if (!(__uint_as_float((unsigned)(x >> 32)) < best.t)) return;
    const int j = (int)(unsigned)x;
    closest_in_rows<kResident>(tab.rows, tab.offsets[j], tab.offsets[j + 1],
                               r, best);
  }
}

// counter[0] hands out lanes, 32 a warp; counter[1] counts the lanes whose
// list overflowed.
template <bool kResident>
__global__ void __launch_bounds__(kFullThreads, kFullMinBlocks)
closest_hit_full_kernel(const float* __restrict__ bmin,
                        const float* __restrict__ bmax,
                        const float4* __restrict__ rows,
                        const int32_t* __restrict__ offsets, int nt,
                        int n_rows, const float* __restrict__ ray_o,
                        const float* __restrict__ ray_d,
                        const float* __restrict__ min_t,
                        const float* __restrict__ max_t, int b,
                        float* __restrict__ t_out,
                        int32_t* __restrict__ tri_out,
                        float* __restrict__ u_out, float* __restrict__ v_out,
                        int* counter) {
  extern __shared__ float4 smem[];
  const FlatTable tab = load_flat_table<kResident>(smem, bmin, bmax, rows,
                                                   offsets, nt, n_rows);
  if (!BPT_K5_LISTS) {
    while (true) {
      const int lane = next_lane(counter);
      if (lane >= b) return;
      const Ray r = load_ray(ray_o, ray_d, min_t, max_t, lane);
      Best best;
      if (r.mxt >= r.mnt) closest_walk_flat<kResident>(tab, nt, r, best);
      store_best(lane, best, t_out, tri_out, u_out, v_out);
    }
  }
  WarpLists& w = reinterpret_cast<WarpLists*>(
      reinterpret_cast<char*>(smem) +
      flat_smem_bytes(nt, n_rows, kResident))[threadIdx.x >> 5];
  const int lid = threadIdx.x & 31;
  while (true) {
    int base = 0;
    if (lid == 0) base = atomicAdd(counter, 32);
    base = __shfl_sync(kAllLanes, base, 0);
    if (base >= b) return;
    const int lane = base + lid;
    Ray r = {};
    bool live = false;
    if (lane < b) {
      r = load_ray(ray_o, ray_d, min_t, max_t, lane);
      live = r.mxt >= r.mnt;
    }
    const int n = warp_entry_lists(tab, nt, r, live, w);
    Best best;
    if (live && n <= kListKeys) {
      walk_list<kResident>(tab, w.keys + lid * kListStride, n, r, best);
    } else if (live) {
      atomicAdd(counter + 1, 1);
      closest_walk_flat<kResident>(tab, nt, r, best);
    }
    if (lane < b) store_best(lane, best, t_out, tri_out, u_out, v_out);
    __syncwarp();  // the lists are free for the warp's next lanes
  }
}

template <bool kResident>
int launch(const float* bmin, const float* bmax, const float4* rows,
           const int32_t* offsets, int nt, int n_rows, const float* ray_o,
           const float* ray_d, const float* min_t, const float* max_t, int b,
           float* t_out, int32_t* tri_out, float* u_out, float* v_out,
           int* counter, cudaStream_t stream) {
  const size_t smem = full_smem_bytes(nt, n_rows, kResident);
  int grid = 0;
  const cudaError_t e = grouped_launch_config(
      closest_hit_full_kernel<kResident>, smem, b, &grid, kFullThreads);
  if (e != cudaSuccess) return (int)e;
  closest_hit_full_kernel<kResident><<<grid, kFullThreads, smem, stream>>>(
      bmin, bmax, rows, offsets, nt, n_rows, ray_o, ray_d, min_t, max_t, b,
      t_out, tri_out, u_out, v_out, counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bpt_closest_hit_full(const float* bmin, const float* bmax,
                                    const void* rows, const int32_t* offsets,
                                    int nt, int n_rows, const float* ray_o,
                                    const float* ray_d, const float* min_t,
                                    const float* max_t, int b, float* t_out,
                                    int32_t* tri_out, float* u_out,
                                    float* v_out, int* counter,
                                    void* stream) {
  const float4* rows4 = static_cast<const float4*>(rows);
  if (BPT_K5_RESIDENT &&
      full_smem_bytes(nt, n_rows, true) <= kResidentBytes) {
    return launch<true>(bmin, bmax, rows4, offsets, nt, n_rows, ray_o, ray_d,
                        min_t, max_t, b, t_out, tri_out, u_out, v_out,
                        counter, (cudaStream_t)stream);
  }
  return launch<false>(bmin, bmax, rows4, offsets, nt, n_rows, ray_o, ray_d,
                       min_t, max_t, b, t_out, tri_out, u_out, v_out, counter,
                       (cudaStream_t)stream);
}
