// Threefry-2x32 (20 rounds) over a batch of keys, one thread a lane: the
// three RNG calls of core/rng.py (fold_in, uniform1, uniform2) as one
// launch each.
//
// Replaces no Pallas kernel.  On the TPU XLA fused jax.random's threefry
// into one loop over uint32 words.  The port's plain version
// (core/rng.py::threefry2x32) runs the same hash as about 170 int64 tensor
// operations, each a launch of an elementwise kernel, with a 32-bit mask
// after every add and shift: 9,228 of the 15,079 launches of a BDPT sample
// of the caustic cell on an NVIDIA H100 80GB HBM3 (PERF.md).
//
// What bounds it on an H100: the bytes of the keys (16 a lane), of the
// per-lane data (4 or 8, none for a scalar tag) and of the output (16 for a
// key, 4 a float), at 3.35 TB/s; the hash itself is about 130 uint32
// operations in registers.  The design, against that:
//   * The keys and data are read through their strides (a broadcast axis
//     has stride 0), so no expanded copy is made and a call is one launch.
//   * Words are uint32 in registers: JAX's rotations, key schedule and
//     injection constants, with no masks; a value is cut to its low 32 bits
//     as it is read, as `x & 0xFFFFFFFF` does in the plain version.
//   * The output is written once, contiguous, in the dtype and layout of
//     the plain version: int64 (..., 2) keys, float32 (...) or (..., 2)
//     uniforms formed as JAX forms them, bitcast((bits >> 9) | 0x3F800000)
//     minus 1.
// Bit-identical to the plain version on every input: integer arithmetic
// only, and the subtraction of 1 from [1, 2) is exact.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 4;

enum Mode { kFoldIn = 0, kUniform1 = 1, kUniform2 = 2 };
enum DataKind { kScalar = 0, kInt32 = 1, kInt64 = 2 };

// The lanes' index space (row-major over `shape`) and where each lane's key
// words and data lie: key word 0 of lane (c_0, ..., c_{dims-1}) at
// keys[sum c_d key_stride[d]], word 1 key_word further on.
struct Geometry {
  long long shape[kMaxDims];
  long long key_stride[kMaxDims];
  long long data_stride[kMaxDims];
  long long key_word;
  int dims;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The rounds of jax/_src/prng.py's threefry2x32 on the counter (x0, x1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return fmaxf(__uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f, 0.0f);
}

template <int M, int D>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(const long long* __restrict__ keys,
                    const void* __restrict__ data, uint32_t tag, long long n,
                    Geometry g, void* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  long long ko = 0, dof = 0, rem = i;
  // Unrolled with constant indices, so the geometry is read from the
  // kernel's parameters and never copied to a local-memory stack frame.
#pragma unroll
  for (int d = kMaxDims - 1; d > 0; --d) {
    if (d < g.dims) {
      const long long c = rem % g.shape[d];
      rem /= g.shape[d];
      ko += c * g.key_stride[d];
      dof += c * g.data_stride[d];
    }
  }
  if (g.dims > 0) {
    ko += rem * g.key_stride[0];
    dof += rem * g.data_stride[0];
  }
  const uint32_t k0 = (uint32_t)keys[ko];
  const uint32_t k1 = (uint32_t)keys[ko + g.key_word];
  if (M == kFoldIn) {
    uint32_t x1 = tag;
    if (D == kInt32) x1 = (uint32_t)static_cast<const int32_t*>(data)[dof];
    if (D == kInt64) x1 = (uint32_t)static_cast<const long long*>(data)[dof];
    uint32_t x0 = 0;
    threefry2x32(k0, k1, x0, x1);
    long long* o = static_cast<long long*>(out) + 2 * i;
    o[0] = (long long)x0;
    o[1] = (long long)x1;
  } else if (M == kUniform1) {
    uint32_t x0 = 0, x1 = 0;
    threefry2x32(k0, k1, x0, x1);
    static_cast<float*>(out)[i] = bits_to_unit(x0 ^ x1);
  } else {
    float* o = static_cast<float*>(out) + 2 * i;
#pragma unroll
    for (uint32_t c = 0; c < 2; ++c) {
      uint32_t x0 = 0, x1 = c;
      threefry2x32(k0, k1, x0, x1);
      o[c] = bits_to_unit(x0 ^ x1);
    }
  }
}

template <int M, int D>
cudaError_t run(const long long* keys, const void* data, uint32_t tag,
                long long n, const Geometry& g, void* out, cudaStream_t s) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  threefry_kernel<M, D><<<(unsigned)blocks, kThreads, 0, s>>>(keys, data, tag,
                                                              n, g, out);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 fold_in (out int64 (n, 2)), 1 uniform1 (out float32 (n,)), 2
// uniform2 (out float32 (n, 2)).  data_kind: 0 a scalar tag (`tag`, data
// unused), 1 int32 data, 2 int64 data (fold_in only).  geometry: dims
// shapes, dims key strides, dims data strides and the stride between a
// key's two words, in elements; n is the product of the shapes (n > 0).
extern "C" int bpt_threefry(int mode, const void* keys, const void* data,
                            int data_kind, unsigned int tag, long long n,
                            int dims, const long long* geometry, void* out,
                            void* stream) {
  if (n < 1 || dims < 0 || dims > kMaxDims || mode < kFoldIn ||
      mode > kUniform2 || data_kind < kScalar || data_kind > kInt64 ||
      (mode != kFoldIn && data_kind != kScalar) ||
      (n + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g{};
  g.dims = dims;
  for (int d = 0; d < dims; ++d) {
    g.shape[d] = geometry[d];
    g.key_stride[d] = geometry[dims + d];
    g.data_stride[d] = geometry[2 * dims + d];
  }
  g.key_word = geometry[3 * dims];
  const long long* k = static_cast<const long long*>(keys);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kUniform1) return (int)run<kUniform1, kScalar>(k, data, tag, n,
                                                             g, out, s);
  if (mode == kUniform2) return (int)run<kUniform2, kScalar>(k, data, tag, n,
                                                             g, out, s);
  if (data_kind == kInt32) return (int)run<kFoldIn, kInt32>(k, data, tag, n,
                                                            g, out, s);
  if (data_kind == kInt64) return (int)run<kFoldIn, kInt64>(k, data, tag, n,
                                                            g, out, s);
  return (int)run<kFoldIn, kScalar>(k, data, tag, n, g, out, s);
}
