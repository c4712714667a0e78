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

#include <initializer_list>

namespace vwfd {

// dtype codes passed by the wrappers (kernels/_lib.py::DTYPE_CODES; kI8
// only where a wrapper says so: K3's int8 detect stem)
enum Dtype : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

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
template <>
__device__ __forceinline__ int8_t from_f32<int8_t>(float v) {
  return (int8_t)(int)v;  // v holds an integer level
}

// The RealNVP affine of a coupling half (vwfd_tpu/nets/inn.py::_e, clamp 1):
// e = exp(2*sigmoid(s) - 1) + 1e-4; out = e*x + t (inverse: (x - t) / e).
// Each operation is one IEEE rounding in the plain version's order (no FMA
// contraction), so that K2 and K13 equal their plain versions.
__device__ __forceinline__ float rnvp_affine(float s, float t, float xv,
                                             int inverse) {
  const float sig = __frcp_rn(__fadd_rn(1.f, expf(-s)));
  const float e = __fadd_rn(expf(__fsub_rn(__fmul_rn(2.f, sig), 1.f)), 1e-4f);
  return inverse ? __fdiv_rn(__fsub_rn(xv, t), e)
                 : __fadd_rn(__fmul_rn(e, xv), t);
}

__device__ __forceinline__ long long global_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

inline unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

// Host side: every pointer on a 16-byte boundary (vector and bulk accesses)
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// 32-bit words <-> f32 values: one f32, or two bf16 (element 0 in the low
// half). The bf16 -> f32 widening is exact; f32 -> bf16 rounds to nearest
// even.
template <typename T>
struct Word;
template <>
struct Word<float> {
  static constexpr int kPer = 1;
  static __device__ __forceinline__ void unpack(uint32_t w, float* v) {
    v[0] = __uint_as_float(w);
  }
  static __device__ __forceinline__ uint32_t pack(const float* v) {
    return __float_as_uint(v[0]);
  }
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr int kPer = 2;
  static __device__ __forceinline__ void unpack(uint32_t w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t pack(const float* v) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[0])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16);
  }
};

template <>
struct Word<int8_t> {  // four integer levels (stored only: store_vec)
  static constexpr int kPer = 4;
  static __device__ __forceinline__ uint32_t pack(const float* v) {
    uint32_t w = 0;
    for (int i = 0; i < 4; ++i)
      w |= (uint32_t)(uint8_t)from_f32<int8_t>(v[i]) << (8 * i);
    return w;
  }
};

// N contiguous values as 8- or 16-byte accesses; p must be aligned to the
// access width (16 bytes when N values fill whole 16-byte words).
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v) {
  constexpr int kWords = N / Word<T>::kPer;
  static_assert(kWords == 2 || kWords % 4 == 0, "8- or 16-byte accesses");
  if constexpr (kWords % 4 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 u = q[i];
      Word<T>::unpack(u.x, v + (4 * i + 0) * Word<T>::kPer);
      Word<T>::unpack(u.y, v + (4 * i + 1) * Word<T>::kPer);
      Word<T>::unpack(u.z, v + (4 * i + 2) * Word<T>::kPer);
      Word<T>::unpack(u.w, v + (4 * i + 3) * Word<T>::kPer);
    }
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    Word<T>::unpack(u.x, v);
    Word<T>::unpack(u.y, v + Word<T>::kPer);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v) {
  constexpr int kWords = N / Word<T>::kPer;
  static_assert(kWords == 2 || kWords % 4 == 0, "8- or 16-byte accesses");
  if constexpr (kWords % 4 == 0) {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      uint4 u;
      u.x = Word<T>::pack(v + (4 * i + 0) * Word<T>::kPer);
      u.y = Word<T>::pack(v + (4 * i + 1) * Word<T>::kPer);
      u.z = Word<T>::pack(v + (4 * i + 2) * Word<T>::kPer);
      u.w = Word<T>::pack(v + (4 * i + 3) * Word<T>::kPer);
      q[i] = u;
    }
  } else {
    uint2 u;
    u.x = Word<T>::pack(v);
    u.y = Word<T>::pack(v + Word<T>::kPer);
    *reinterpret_cast<uint2*>(p) = u;
  }
}

// Shared-memory address of p, and the mbarrier operations the TMA and
// bulk-copy kernels wait on.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@P bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// Makes mbarrier initialisations visible to the async proxy (the copies).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Hopper's 1-D bulk copies (cp.async.bulk), issued by one thread. Row
// lengths and every address are multiples of 16 bytes.
//
// R rows of rb bytes, r_stride apart in global memory, to rs apart in
// shared memory; they complete on the mbarrier `bar`, whose transaction
// count the caller has armed (mbar_expect_tx) for them.
__device__ __forceinline__ void bulk_load_rows(uint8_t* smem, int rs,
                                               const uint8_t* g, int R,
                                               int r_stride, int rb,
                                               uint32_t bar) {
  for (int r = 0; r < R; ++r)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem + r * rs)),
        "l"(g + (long long)r * r_stride), "r"(rb), "r"(bar)
        : "memory");
}

// R1 x R2 staged rows of rb bytes to global memory, as one committed bulk
// group: staged row r1*R2 + r2 at smem + (r1*R2 + r2)*rs, global row at
// g + r1*st1 + r2*st2. Issued after every writer's fence_to_bulk() and a
// barrier; the issuer waits with bulk_wait_read() before the shared memory
// is written again or the block exits.
__device__ __forceinline__ void bulk_store_rows(uint8_t* g,
                                                const uint8_t* smem, int rs,
                                                int R1, int st1, int R2,
                                                int st2, int rb) {
  for (int r1 = 0; r1 < R1; ++r1)
    for (int r2 = 0; r2 < R2; ++r2)
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
              "l"(g + (long long)r1 * st1 + (long long)r2 * st2),
          "r"(smem_u32(smem + (r1 * R2 + r2) * rs)), "r"(rb)
          : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to the bulk copies.
__device__ __forceinline__ void fence_to_bulk() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Waits until every committed bulk store has read its shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The orthonormal DCT-II matrix C[k][i] of ops/dct.py::_dct_matrix_np,
// built in float64 and rounded to float32 (tests/test_torch_attacks.py
// checks these literals bit for bit; K5 and K16 share it). Read with
// indices known at compile time, so each entry is an immediate operand of
// its FMA: no load, and no register holds the matrix.
__device__ __forceinline__ float dct_c(int k, int i) {
  constexpr float kDct[8][8] = {
      {0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
       0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f},
      {0x1.f6297cp-2f, 0x1.a9b662p-2f, 0x1.1c73b4p-2f, 0x1.8f8b84p-4f,
       -0x1.8f8b84p-4f, -0x1.1c73b4p-2f, -0x1.a9b662p-2f, -0x1.f6297cp-2f},
      {0x1.d906bcp-2f, 0x1.87de2ap-3f, -0x1.87de2ap-3f, -0x1.d906bcp-2f,
       -0x1.d906bcp-2f, -0x1.87de2ap-3f, 0x1.87de2ap-3f, 0x1.d906bcp-2f},
      {0x1.a9b662p-2f, -0x1.8f8b84p-4f, -0x1.f6297cp-2f, -0x1.1c73b4p-2f,
       0x1.1c73b4p-2f, 0x1.f6297cp-2f, 0x1.8f8b84p-4f, -0x1.a9b662p-2f},
      {0x1.6a09e6p-2f, -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
       0x1.6a09e6p-2f, -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f},
      {0x1.1c73b4p-2f, -0x1.f6297cp-2f, 0x1.8f8b84p-4f, 0x1.a9b662p-2f,
       -0x1.a9b662p-2f, -0x1.8f8b84p-4f, 0x1.f6297cp-2f, -0x1.1c73b4p-2f},
      {0x1.87de2ap-3f, -0x1.d906bcp-2f, 0x1.d906bcp-2f, -0x1.87de2ap-3f,
       -0x1.87de2ap-3f, 0x1.d906bcp-2f, -0x1.d906bcp-2f, 0x1.87de2ap-3f},
      {0x1.8f8b84p-4f, -0x1.1c73b4p-2f, 0x1.a9b662p-2f, -0x1.f6297cp-2f,
       0x1.f6297cp-2f, -0x1.a9b662p-2f, 0x1.1c73b4p-2f, -0x1.8f8b84p-4f},
  };
  return kDct[k][i];
}

// out[k] = sum_i C[k][i]·in[i] (forward), or sum_i C[i][k]·in[i] (inverse):
// one 8-term FMA chain per output, i ascending
template <bool kInverse>
__device__ __forceinline__ void dct8(const float* in, float* out) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc = fmaf(kInverse ? dct_c(i, k) : dct_c(k, i), in[i], acc);
    out[k] = acc;
  }
}

// 8×8 tile transposes through shared memory, a block's 8 threads (one
// column each) sharing a warp: rows at pitch kTP (9, so that a column's
// writes fall in 8 banks), kTB floats a block (≡ 8 mod 32).
constexpr int kTP = 9;
constexpr int kTB = 8 * kTP;

// Thread c of a block: its column (as 8 rows) into the block's tile, then
// row c of the tile back.
__device__ __forceinline__ void col_to_row(float* t, int c, const float* col,
                                           float* row) {
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k * kTP + c] = col[k];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) row[i] = t[c * kTP + i];
  __syncwarp();
}

__device__ __forceinline__ void row_to_col(float* t, int c, const float* row,
                                           float* col) {
#pragma unroll
  for (int j = 0; j < 8; ++j) t[c * kTP + j] = row[j];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) col[k] = t[k * kTP + c];
  __syncwarp();
}

// a·m0 + b·m1 + c·m2 summed left to right, one rounding an operation (a
// colour map's row as numpy's and torch's matmul of 3 terms round it)
__device__ __forceinline__ float dot3(float a, float b, float c, float m0,
                                      float m1, float m2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, m0), __fmul_rn(b, m1)),
                   __fmul_rn(c, m2));
}

}  // namespace vwfd
