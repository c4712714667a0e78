// Shared helpers of the port's hand-written kernels (sm_90a, plain C
// interface, loaded with ctypes by vwfd_tpu_torch/kernels/_lib.py).
//
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so that the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vwfd {

// dtype codes passed by the wrappers (kernels/_lib.py::DTYPE_CODES)
enum Dtype : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch's cast
}

// Haar sign of band k (LL, LH, HL, HH) at sub-pixel m = 2u + v: the
// Walsh-Hadamard sign (-1)^popcount(k & m), which is exactly
// vwfd_tpu/nets/inn_packed.py::_SIGNS[k][u, v].
__device__ __forceinline__ float haar_sign(int k, int m) {
  return (__popc(k & m) & 1) ? -1.f : 1.f;
}

__device__ __forceinline__ long long global_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

inline unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace vwfd
