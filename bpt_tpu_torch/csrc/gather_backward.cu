// The backward of a row gather from small tables: out_k[r, j] = the sum of
// grad_k[i, j] over the lanes i with ids[i] == r, for up to four (N, C_k)
// lane gradients that share one id vector (ops/gather.py::gather_rows).
//
// Replaces no Pallas kernel.  On the TPU the transpose of JAX's gather (a
// scatter-add) was fused by XLA.  Under PyTorch the default backward of
// `table[ids]` is `index_put_(accumulate=True)`, which on CUDA sorts the
// ids and sums each run of equal ids in indexing_backward_kernel_small_stride
// with one warp per run, three of its 32 lanes busy.  The material and
// emitter tables have a handful of rows, so a run is about 10^6 lanes and
// the whole card sums a few runs serially: 1.997 s of a 2.2 s descent step
// of the config #5 cell at 1024x1024 on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md).
//
// What bounds it on an H100: the bytes of the ids and of the gradients, read
// once (4 or 8 bytes a lane for the id, 4 a gradient element), at 3.35 TB/s;
// the output is a few hundred bytes.  The design, against that:
//   * A persistent grid of a few blocks an SM, each owning a fixed,
//     contiguous range of lanes; every lane of every warp busy.
//   * In a warp, the lanes of one row find each other with __match_any_sync
//     and sum by pointer jumping in rank order (a tree over the group's
//     lanes in lane order, five steps at most, one shuffle a column a step).
//     The group's first lane adds the sum into the warp's own row of a
//     shared (warps, rows, columns) buffer: no atomics anywhere.
//   * The block sums its warps' rows in warp order into its row of a
//     (blocks, rows, columns) partials buffer; a second kernel sums the
//     blocks' partials, one warp an output element, in a fixed order.
//   * Rows are taken in shared tiles of kTileRows; a table of more rows is
//     read once a tile.  Every configured scene fits one tile.
// The result depends on the ids, the gradients and the grid alone, so it is
// bit-identical from run to run on one card.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;
constexpr int kMaxTables = 4;
constexpr int kMaxCols = 4;  // columns of one table
constexpr int kMaxTotal = kMaxTables * kMaxCols;

// Column c of the concatenated gradient: element i is src[c][i * stride[c]];
// its sum for row r goes to out[dst[c] + r * stride[c]].
struct Columns {
  const float* src[kMaxTotal];
  long long dst[kMaxTotal];
  int stride[kMaxTotal];
  int total;
};

template <typename Id>
__global__ void __launch_bounds__(kThreads)
    partial_sums(const Id* __restrict__ ids, int n, int m, int per_block,
                 Columns cols, float* __restrict__ partials) {
  extern __shared__ float rows[];  // (kWarps, tile, cols.total)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int total = cols.total;
  const int lo = blockIdx.x * per_block;
  const int hi = min(n, lo + per_block);
  float* block_out = partials + (size_t)blockIdx.x * m * total;
  for (int r0 = 0; r0 < m; r0 += kTileRows) {
    const int rt = min(kTileRows, m - r0);
    const int warp_elems = rt * total;
    for (int e = threadIdx.x; e < kWarps * warp_elems; e += kThreads) {
      rows[e] = 0.0f;
    }
    __syncthreads();
    float* mine = rows + warp * warp_elems;
    for (int base = lo + warp * 32; base < hi; base += kThreads) {
      const int i = base + lane;
      const bool live = i < hi;
      // The gradients are loaded beside the id, not after it: the lanes of
      // other tiles sum among themselves and are never written.
      const long long id = live ? (long long)ids[i] : -1;
      float v[kMaxTotal];
#pragma unroll
      for (int c = 0; c < kMaxTotal; ++c) {
        v[c] = (c < total && live)
                   ? __ldg(cols.src[c] + (size_t)i * cols.stride[c])
                   : 0.0f;
      }
      const int key = id >= r0 && id < r0 + rt ? (int)(id - r0) : -1;
      const unsigned peers = __match_any_sync(kFullWarp, key);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      // The lane of rank + 1 in the group, then of rank + 2, + 4, ...
      const unsigned above = peers & ~((2u << lane) - 1u);
      int next = above ? __ffs(above) - 1 : -1;
#pragma unroll
      for (int step = 1; step < 32; step <<= 1) {
        if (!__any_sync(kFullWarp, next >= 0)) break;
        // Ranks 0, 2*step, 4*step, ... take the sum held `step` ranks on.
        const bool take = next >= 0 && (rank & (2 * step - 1)) == 0;
        const int src = next >= 0 ? next : lane;
#pragma unroll
        for (int c = 0; c < kMaxTotal; ++c) {
          if (c < total) {
            const float w = __shfl_sync(kFullWarp, v[c], src);
            if (take) v[c] += w;
          }
        }
        const int further = __shfl_sync(kFullWarp, next, src);
        next = next >= 0 ? further : -1;
      }
      if (key >= 0 && rank == 0) {
#pragma unroll
        for (int c = 0; c < kMaxTotal; ++c) {
          if (c < total) mine[key * total + c] += v[c];
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < warp_elems; e += kThreads) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += rows[w * warp_elems + e];
      block_out[(size_t)r0 * total + e] = s;
    }
    __syncthreads();
  }
}

// One warp an output element (row, column): lane l sums the partials of
// blocks l, l + 32, ... in order, then the warp sums the 32 in a butterfly.
__global__ void __launch_bounds__(kThreads)
    final_sums(const float* __restrict__ partials, int blocks, int m,
               Columns cols, float* __restrict__ out) {
  const int e = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int total = cols.total;
  if (e >= m * total) return;  // whole warps
  float s = 0.0f;
  for (int b = lane; b < blocks; b += 32) {
    s += partials[(size_t)b * m * total + e];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullWarp, s, o);
  if (lane == 0) {
    const int r = e / total;
    const int c = e - r * total;
    out[cols.dst[c] + (long long)r * cols.stride[c]] = s;
  }
}

}  // namespace

// grads[k]: (n, cols[k]) float32, contiguous, for the tables k < n_tables
// (at most 4, each of 1-4 columns); out: the tables' sums one after
// another, table k an (m, cols[k]) block; partials: blocks * m * (sum of
// cols) floats.  ids are int64 when ids_64, else int32, each in [0, m).
extern "C" int bpt_gather_rows_backward(const void* ids, int ids_64, int n,
                                        int m, int n_tables,
                                        const void* const* grads,
                                        const int* table_cols, int blocks,
                                        float* partials, float* out,
                                        void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables || m < 1 || n < 0 ||
      (n > 0 && blocks < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Columns cols{};
  long long base = 0;
  for (int k = 0; k < n_tables; ++k) {
    const int ck = table_cols[k];
    if (ck < 1 || ck > kMaxCols) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < ck; ++j) {
      cols.src[cols.total] = static_cast<const float*>(grads[k]) + j;
      cols.dst[cols.total] = base + j;
      cols.stride[cols.total] = ck;
      ++cols.total;
    }
    base += (long long)m * ck;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const int per_block = (n + blocks - 1) / blocks;
    const int tile = m < kTileRows ? m : kTileRows;
    const size_t smem = sizeof(float) * kWarps * tile * cols.total;
    if (ids_64) {
      partial_sums<long long><<<blocks, kThreads, smem, s>>>(
          static_cast<const long long*>(ids), n, m, per_block, cols,
          partials);
    } else {
      partial_sums<int32_t><<<blocks, kThreads, smem, s>>>(
          static_cast<const int32_t*>(ids), n, m, per_block, cols, partials);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  } else {
    blocks = 0;
  }
  const int elems = m * cols.total;
  final_sums<<<(elems + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      partials, blocks, m, cols, out);
  return (int)cudaGetLastError();
}
