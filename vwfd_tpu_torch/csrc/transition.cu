// K1 `transition`: the packed INN's fixed orthogonal Haar + packing maps and
// their exact transposes (NHWC, f32 or bf16, f32 arithmetic inside).
//
// Replaces vwfd_tpu/nets/inn_packed.py::_entry_kernel / _p2p_kernel /
// _p2u_kernel evaluated as fixed-weight convolutions (_fixed_conv /
// _fixed_conv_t, inn_packed.py:75-133, :236-257). Every output is a +-0.5 sum
// of four gathered inputs, so this is a gather plus a butterfly, not a conv:
// one thread per output element, signs from the Walsh-Hadamard parity.
//
// Channel orders (c-major packing, g = 2p + q the sub-pixel):
//   entry  (H,W,C)    -> (H/4,W/4,16C): out[i,j,(c*4+k)*4+g] =
//            0.5 * sum_{u,v} S[k][2u+v] * x[4i+2p+u, 4j+2q+v, c]
//   p2p    (r,r,4C)   -> (r/2,r/2,16C): out[i,j,(c*4+k)*4+g2] =
//            0.5 * sum_{g1} S[k][g1] * x[2i+g2/2, 2j+g2%2, c*4+g1]
//   p2u    (r,r,4C)   -> (r,r,4C):      out[i,j,c*4+k] =
//            0.5 * sum_{g} S[k][g] * x[i,j,c*4+g]
// The transposes scatter the same taps back; the maps are orthogonal, so
// each transpose is the exact inverse of its forward map.
#include "common.cuh"

namespace {

using vwfd::haar_sign;
using vwfd::to_f32;

enum Kind : int { kEntry = 0, kP2P = 1, kP2U = 2 };

template <typename T>
__global__ void transition_fwd(const T* __restrict__ x, T* __restrict__ y,
                               int kind, long long total, int Ho, int Wo,
                               int Co, int Hi, int Wi, int Ci) {
  const long long idx = vwfd::global_index();
  if (idx >= total) return;
  const int o = (int)(idx % Co);
  long long r = idx / Co;
  const int j = (int)(r % Wo);
  r /= Wo;
  const int i = (int)(r % Ho);
  const long long n = r / Ho;
  const T* xn = x + n * Hi * (long long)Wi * Ci;
  float acc = 0.f;
  if (kind == kEntry) {
    const int g = o & 3, k = (o >> 2) & 3, c = o >> 4;
    const int p = g >> 1, q = g & 1;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int u = m >> 1, v = m & 1;
      const long long at =
          ((long long)(4 * i + 2 * p + u) * Wi + (4 * j + 2 * q + v)) * Ci + c;
      acc += haar_sign(k, m) * to_f32(xn[at]);
    }
  } else if (kind == kP2P) {
    const int g2 = o & 3, k = (o >> 2) & 3, c = o >> 4;
    const T* px = xn +
                  ((long long)(2 * i + (g2 >> 1)) * Wi + (2 * j + (g2 & 1))) * Ci +
                  c * 4;
#pragma unroll
    for (int m = 0; m < 4; ++m) acc += haar_sign(k, m) * to_f32(px[m]);
  } else {
    const int k = o & 3, c = o >> 2;
    const T* px = xn + ((long long)i * Wi + j) * Ci + c * 4;
#pragma unroll
    for (int m = 0; m < 4; ++m) acc += haar_sign(k, m) * to_f32(px[m]);
  }
  y[idx] = vwfd::from_f32<T>(0.5f * acc);
}

// Transpose: x is the packed side (Hi,Wi,Ci), y the unpacked/finer side
// (Ho,Wo,Co); one thread per element of y.
template <typename T>
__global__ void transition_t(const T* __restrict__ x, T* __restrict__ y,
                             int kind, long long total, int Ho, int Wo, int Co,
                             int Hi, int Wi, int Ci) {
  const long long idx = vwfd::global_index();
  if (idx >= total) return;
  const int o = (int)(idx % Co);
  long long r = idx / Co;
  const int X = (int)(r % Wo);
  r /= Wo;
  const int Y = (int)(r % Ho);
  const long long n = r / Ho;
  const T* xn = x + n * Hi * (long long)Wi * Ci;
  float acc = 0.f;
  if (kind == kEntry) {
    // y[4i+2p+u, 4j+2q+v, c] = 0.5 * sum_k S[k][2u+v] * x[i,j,(c*4+k)*4+g]
    const int g = 2 * ((Y & 3) >> 1) + ((X & 3) >> 1);
    const int m = 2 * (Y & 1) + (X & 1);
    const T* px = xn + ((long long)(Y >> 2) * Wi + (X >> 2)) * Ci + o * 16 + g;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc += haar_sign(k, m) * to_f32(px[k * 4]);
  } else if (kind == kP2P) {
    // y[2i+a, 2j+b, c*4+g1] = 0.5 * sum_k S[k][g1] * x[i,j,(c*4+k)*4+2a+b]
    const int g1 = o & 3, c = o >> 2;
    const int g2 = 2 * (Y & 1) + (X & 1);
    const T* px = xn + ((long long)(Y >> 1) * Wi + (X >> 1)) * Ci + c * 16 + g2;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc += haar_sign(k, g1) * to_f32(px[k * 4]);
  } else {
    // y[i,j,c*4+g] = 0.5 * sum_k S[k][g] * x[i,j,c*4+k]
    const int g = o & 3;
    const T* px = xn + ((long long)Y * Wi + X) * Ci + (o & ~3);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc += haar_sign(k, g) * to_f32(px[k]);
  }
  y[idx] = vwfd::from_f32<T>(0.5f * acc);
}

template <typename T>
void launch(const void* x, void* y, int kind, int transpose, int N, int Hi,
            int Wi, int Ci, int Ho, int Wo, int Co, cudaStream_t stream) {
  const long long total = (long long)N * Ho * Wo * Co;
  if (total == 0) return;
  auto kern = transpose ? transition_t<T> : transition_fwd<T>;
  kern<<<vwfd::blocks_for(total), vwfd::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), kind, total, Ho, Wo, Co,
      Hi, Wi, Ci);
}

}  // namespace

// x: input (N,Hi,Wi,Ci), y: output (N,Ho,Wo,Co), both NHWC-contiguous.
extern "C" int vwfd_transition(const void* x, void* y, int kind, int transpose,
                               int dtype, int N, int Hi, int Wi, int Ci,
                               int Ho, int Wo, int Co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vwfd::kBF16)
    launch<__nv_bfloat16>(x, y, kind, transpose, N, Hi, Wi, Ci, Ho, Wo, Co, s);
  else
    launch<float>(x, y, kind, transpose, N, Hi, Wi, Ci, Ho, Wo, Co, s);
  return (int)cudaGetLastError();
}
