// K14 `haar`: the INN's Haar wavelet squeeze and its exact inverse (NHWC,
// f32 or bf16, f32 arithmetic inside, one rounding per output).
//
// Replaces vwfd_tpu/ops/haar.py::haar_downsample / haar_upsample (:20-50)
// and the same map's conv forms haar_downsample_conv / haar_upsample_conv
// (:100-121), which vwfd_tpu/nets/inn.py runs for every Haar setting and
// vwfd_tpu/nets/inn_packed.py (:236-258) at the unpacked levels past 768
// channels.
//
//   down (N,H,W,C) -> (N,H/2,W/2,4C): with a, b, c, d the pixels (2i,2j),
//     (2i,2j+1), (2i+1,2j), (2i+1,2j+1) of channel ch,
//       y[i,j,ch*4+0] = 0.5*(((a+b)+c)+d)     LL
//       y[i,j,ch*4+1] = 0.5*(((a-b)+c)-d)     LH
//       y[i,j,ch*4+2] = 0.5*(((a+b)-c)-d)     HL
//       y[i,j,ch*4+3] = 0.5*(((a-b)-c)+d)     HH
//   up (transpose): the same four sums of (LL, LH, HL, HH) give a, b, c, d.
// The 4x4 sign matrix is symmetric and S*S = 4I, so up is down's transpose
// and its inverse. The sums run in the reference's left-to-right order and
// the product with 0.5 is exact, so the kernel equals its plain version.
//
// Bound: bytes (4 add/sub and one product per output). Design: one thread
// per (position on the half-resolution side, group of V channels); with V
// = 16 bytes of channels it reads the four pixels' V channels as 16-byte
// loads and writes the 4V band values, contiguous in the c*4+k order, as
// 16-byte stores (up: the reverse). Neighbouring threads take neighbouring
// channel groups, then neighbouring columns. Channel rows of whole 8-byte
// words only (the 12-channel clip in bf16) take 8-byte accesses, others V =
// 1. 64-bit offsets.
#include "common.cuh"

namespace {

using vwfd::from_f32;
using vwfd::to_f32;

// o[k] = 0.5 * (the reference's four-term sum k of (p0, p1, p2, p3))
__device__ __forceinline__ void bands(float p0, float p1, float p2, float p3,
                                      float* o) {
  o[0] = 0.5f * __fadd_rn(__fadd_rn(__fadd_rn(p0, p1), p2), p3);
  o[1] = 0.5f * __fsub_rn(__fadd_rn(__fsub_rn(p0, p1), p2), p3);
  o[2] = 0.5f * __fsub_rn(__fsub_rn(__fadd_rn(p0, p1), p2), p3);
  o[3] = 0.5f * __fadd_rn(__fsub_rn(__fsub_rn(p0, p1), p2), p3);
}

template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float* v) {
  if constexpr (V == 1) {
    v[0] = to_f32(*p);
  } else {
    vwfd::load_vec<T, V>(p, v);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float* v) {
  if constexpr (V == 1) {
    *p = from_f32<T>(v[0]);
  } else {
    vwfd::store_vec<T, V>(p, v);
  }
}

// kUp = false: x (N,H,W,C) -> y (N,H/2,W/2,4C); true: the reverse.
// Thread index over N * (H/2) * (W/2) * (C/V).
template <typename T, int V, bool kUp>
__global__ void __launch_bounds__(vwfd::kThreads)
    haar_kernel(const T* __restrict__ x, T* __restrict__ y, long long total,
                int Hh, int Wh, int C) {
  const long long idx = vwfd::global_index();
  if (idx >= total) return;
  const int groups = C / V;
  const int g = (int)(idx % groups);
  const long long pix = idx / groups;  // (n, i, j) on the half side
  const int j = (int)(pix % Wh);
  const long long ni = pix / Wh;       // n * Hh + i
  const int i = (int)(ni % Hh);
  const long long n = ni / Hh;
  const long long W = 2LL * Wh;
  // full-resolution offsets of a, b, c, d and the half-resolution one
  const long long fa = ((n * 2 * Hh + 2 * i) * W + 2 * j) * C + g * V;
  const long long f[4] = {fa, fa + C, fa + W * C, fa + W * C + C};
  const long long h = pix * 4 * C + (long long)g * V * 4;
  if constexpr (!kUp) {
    float p[4][V];
#pragma unroll
    for (int m = 0; m < 4; ++m) load_v<T, V>(x + f[m], p[m]);
    float o[4 * V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      bands(p[0][v], p[1][v], p[2][v], p[3][v], o + 4 * v);
#pragma unroll
    for (int m = 0; m < 4; ++m) store_v<T, V>(y + h + m * V, o + m * V);
  } else {
    float q[4 * V];
#pragma unroll
    for (int m = 0; m < 4; ++m) load_v<T, V>(x + h + m * V, q + m * V);
    float o[4][V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float r[4];
      bands(q[4 * v], q[4 * v + 1], q[4 * v + 2], q[4 * v + 3], r);
#pragma unroll
      for (int m = 0; m < 4; ++m) o[m][v] = r[m];
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) store_v<T, V>(y + f[m], o[m]);
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, void* y, int N, int H, int W, int C,
                   int up, cudaStream_t s) {
  const long long total = (long long)N * (H / 2) * (W / 2) * (C / V);
  if (total == 0) return cudaSuccess;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (up)
    haar_kernel<T, V, true><<<vwfd::blocks_for(total), vwfd::kThreads, 0,
                              s>>>(xp, yp, total, H / 2, W / 2, C);
  else
    haar_kernel<T, V, false><<<vwfd::blocks_for(total), vwfd::kThreads, 0,
                               s>>>(xp, yp, total, H / 2, W / 2, C);
  return cudaSuccess;
}

}  // namespace

// (N, H, W, C) is the full-resolution side: down reads it from x and writes
// y (N,H/2,W/2,4C); up (transpose = 1) reads x (N,H/2,W/2,4C) and writes
// it. Both contiguous. vec is the access width: 16 or 8 bytes (C times the
// value size a multiple of it, both pointers aligned to it), or 0 for one
// value a thread.
extern "C" int vwfd_haar(const void* x, void* y, int N, int H, int W, int C,
                         int transpose, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int size = dtype == vwfd::kBF16 ? 2 : 4;
  if (H % 2 || W % 2 || (vec != 0 && vec != 8 && vec != 16) ||
      (vec && ((C * size) % vec ||
               reinterpret_cast<uintptr_t>(x) % vec ||
               reinterpret_cast<uintptr_t>(y) % vec)))
    return (int)cudaErrorInvalidValue;
  cudaError_t rc;
  if (dtype == vwfd::kBF16) {
    rc = vec == 16 ? launch<__nv_bfloat16, 8>(x, y, N, H, W, C, transpose, s)
         : vec == 8 ? launch<__nv_bfloat16, 4>(x, y, N, H, W, C, transpose, s)
                    : launch<__nv_bfloat16, 1>(x, y, N, H, W, C, transpose, s);
  } else {
    rc = vec == 16 ? launch<float, 4>(x, y, N, H, W, C, transpose, s)
         : vec == 8 ? launch<float, 2>(x, y, N, H, W, C, transpose, s)
                    : launch<float, 1>(x, y, N, H, W, C, transpose, s);
  }
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
