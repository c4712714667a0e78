// K1 `transition`: the packed INN's fixed orthogonal Haar + packing maps and
// their exact transposes (NHWC, f32 or bf16, f32 arithmetic inside).
//
// Replaces vwfd_tpu/nets/inn_packed.py::_entry_kernel / _p2p_kernel /
// _p2u_kernel evaluated as fixed-weight convolutions (_fixed_conv /
// _fixed_conv_t, inn_packed.py:75-133, :236-257).
//
// Channel orders (c-major packing, g = 2p + q the sub-pixel, k the band):
//   entry  (H,W,C)    -> (H/4,W/4,16C): out[i,j,(c*4+k)*4+g] =
//            0.5 * sum_{u,v} S[k][2u+v] * x[4i+2p+u, 4j+2q+v, c]
//   p2p    (r,r,4C)   -> (r/2,r/2,16C): out[i,j,(c*4+k)*4+g2] =
//            0.5 * sum_{g1} S[k][g1] * x[2i+g2/2, 2j+g2%2, c*4+g1]
//   p2u    (r,r,4C)   -> (r,r,4C):      out[i,j,c*4+k] =
//            0.5 * sum_{g} S[k][g] * x[i,j,c*4+g]
// S[k][m] = (-1)^popcount(k & m) is the 4-point Walsh-Hadamard matrix, so
// every group of four outputs is one butterfly (a+-b)+-(c+-d) of four
// inputs. S is symmetric and orthogonal (S*S = 4I): each transpose is the
// same butterfly run from the packed side, and p2u's transpose IS p2u.
//
// Bound: bytes (8 add/sub per 4 outputs). Design: one thread per (position
// on the packed side, channel c) reads its 16 inputs (4 for p2u) once,
// writes its 16 outputs (c*4+k)*4+g as two 16-byte stores (bf16), and the
// c-major order makes neighbouring threads touch neighbouring addresses.
// entry's unpacked side (C = 12 channels, 4 image rows) is staged through
// shared memory with 16-byte coalesced copies, so its strided 2-byte
// accesses stay on chip. Rows of the packed side run over the grid's x,
// (column, channel) over the threads; the channel counts of the flagship
// (12, 48, 192) are template parameters, so no runtime division is left on
// that path (other widths take a runtime-C instantiation). 32-bit indices:
// the wrapper refuses tensors of 2^31 elements or more.
#include <algorithm>

#include "common.cuh"

namespace {

using vwfd::load_vec;
using vwfd::store_vec;
using vwfd::to_f32;

constexpr int kItems = 256;  // threads per block

// o[k] = 0.5 * sum_m S[k][m] * x[m], one f32 rounding per output
__device__ __forceinline__ void wht4(float x0, float x1, float x2, float x3,
                                     float* o, int stride) {
  const float a = x0 + x1, b = x0 - x1, c = x2 + x3, d = x2 - x3;
  o[0] = 0.5f * (a + c);
  o[stride] = 0.5f * (b + d);
  o[2 * stride] = 0.5f * (a - c);
  o[3 * stride] = 0.5f * (b - d);
}

template <int CT>
__device__ __forceinline__ int channels(int c_rt) {
  return CT ? CT : c_rt;
}

// Block-wide copy of n elements; 16-byte words when `vec` (both pointers
// 16-byte aligned and n * sizeof(T) a multiple of 16).
template <typename T>
__device__ __forceinline__ void copy_block(T* __restrict__ dst,
                                           const T* __restrict__ src, int n,
                                           bool vec) {
  if (vec) {
    const int n16 = n * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// entry and its transpose. Block: one packed row (n, i) x `tile` packed
// columns; shared memory holds the 4 unpacked rows under that tile
// (4 * tile * C values each). Grid: (N * Hp, ceil(Wp / tile)).
template <typename T, int CT, bool kT>
__global__ void __launch_bounds__(kItems)
    transition_entry(const T* __restrict__ x, T* __restrict__ y, int Wp,
                     int c_rt, int tile, int vec) {
  const int C = channels<CT>(c_rt);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int row = blockIdx.x;
  const int j0 = blockIdx.y * tile;
  const int tj = min(tile, Wp - j0);
  const int seg = 4 * tile * C;  // smem row stride (elements)
  const int n_seg = 4 * tj * C;  // valid elements per unpacked row
  // unpacked side: image row 4 * row + a, from column 4 * j0
  const int u_row = 4 * Wp * C;
  const int u0 = (4 * row) * u_row + 4 * j0 * C;
  if (!kT) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      copy_block(s + a * seg, x + u0 + a * u_row, n_seg, vec);
    __syncthreads();
  }
  for (int t = threadIdx.x; t < tj * C; t += blockDim.x) {
    const int jl = t / C;
    const int c = t - jl * C;
    const int p_off = ((row * Wp + j0 + jl) * C + c) * 16;
    float v[16], o[16];
    if (!kT) {
      // v[a*4+b] = x[4i+a, 4j+b, c]
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          v[a * 4 + b] = to_f32(s[a * seg + (4 * jl + b) * C + c]);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int p = g >> 1, q = g & 1;
        const float* w = v + (2 * p) * 4 + 2 * q;  // m = 2u+v at w[u*4+v]
        wht4(w[0], w[1], w[4], w[5], o + g, 4);   // o[k*4+g]
      }
      store_vec<T, 16>(y + p_off, o);
    } else {
      load_vec<T, 16>(x + p_off, v);  // v[k*4+g]
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int p = g >> 1, q = g & 1;
        float m[4];
        wht4(v[g], v[4 + g], v[8 + g], v[12 + g], m, 1);
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const int a = 2 * p + (mm >> 1), b = 2 * q + (mm & 1);
          s[a * seg + (4 * jl + b) * C + c] = vwfd::from_f32<T>(m[mm]);
        }
      }
    }
  }
  if (kT) {
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
      copy_block(y + u0 + a * u_row, s + a * seg, n_seg, vec);
  }
}

// p2p and its transpose. Thread: packed position (row, j), channel c; the
// unpacked side is (2 Hp, 2 Wp, 4C) and its four pixels hold 4 adjacent
// channels each (8-byte bf16 accesses). Grid: (N * Hp, ceil(Wp*C / 256)).
template <typename T, int CT, bool kT>
__global__ void __launch_bounds__(kItems)
    transition_p2p(const T* __restrict__ x, T* __restrict__ y, int Wp,
                   int c_rt) {
  const int C = channels<CT>(c_rt);
  const int t = blockIdx.y * kItems + threadIdx.x;
  if (t >= Wp * C) return;
  const int row = blockIdx.x;
  const int j = t / C;
  const int c = t - j * C;
  const int p_off = ((row * Wp + j) * C + c) * 16;
  const int u_row = 2 * Wp * 4 * C;
  const int u0 = (2 * row) * u_row + (2 * j) * 4 * C + 4 * c;
  float v[16], o[16];
  if (!kT) {
#pragma unroll
    for (int g2 = 0; g2 < 4; ++g2) {
      load_vec<T, 4>(x + u0 + (g2 >> 1) * u_row + (g2 & 1) * 4 * C,
                     v + 4 * g2);  // v[g2*4+g1]
      wht4(v[4 * g2], v[4 * g2 + 1], v[4 * g2 + 2], v[4 * g2 + 3], o + g2,
           4);  // o[k*4+g2]
    }
    store_vec<T, 16>(y + p_off, o);
  } else {
    load_vec<T, 16>(x + p_off, v);  // v[k*4+g2]
#pragma unroll
    for (int g2 = 0; g2 < 4; ++g2) {
      wht4(v[g2], v[4 + g2], v[8 + g2], v[12 + g2], o, 1);  // o[g1]
      store_vec<T, 4>(y + u0 + (g2 >> 1) * u_row + (g2 & 1) * 4 * C, o);
    }
  }
}

// p2u (its own transpose): every group of 4 channels is one butterfly.
// kG groups (16 bytes) per thread; a ragged tail goes group by group.
template <typename T>
__global__ void __launch_bounds__(kItems)
    transition_p2u(const T* __restrict__ x, T* __restrict__ y, int groups) {
  constexpr int kG = 16 / (4 * (int)sizeof(T));
  const int g0 = (blockIdx.x * kItems + threadIdx.x) * kG;
  if (g0 >= groups) return;
  float v[4 * kG], o[4 * kG];
  if (g0 + kG <= groups) {
    load_vec<T, 4 * kG>(x + 4 * g0, v);
#pragma unroll
    for (int g = 0; g < kG; ++g)
      wht4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3], o + 4 * g, 1);
    store_vec<T, 4 * kG>(y + 4 * g0, o);
  } else {
    for (int g = g0; g < groups; ++g) {
      load_vec<T, 4>(x + 4 * g, v);
      wht4(v[0], v[1], v[2], v[3], o, 1);
      store_vec<T, 4>(y + 4 * g, o);
    }
  }
}

enum Kind : int { kEntry = 0, kP2P = 1, kP2U = 2 };

// Largest dynamic shared memory an entry block may ask for without opting in.
constexpr int kEntrySmemMax = 48 * 1024;

template <typename T, int CT, bool kT>
cudaError_t launch_entry(const T* x, T* y, int rows, int Wp, int C,
                         cudaStream_t s) {
  const int tile = std::max(1, std::min(Wp, kItems / C));
  const size_t smem = (size_t)16 * tile * C * sizeof(T);
  if (smem > (size_t)kEntrySmemMax) return cudaErrorInvalidValue;
  const T* unpacked = kT ? y : x;
  const int vec = ((reinterpret_cast<uintptr_t>(unpacked) & 15) == 0) &&
                  ((4 * C * sizeof(T)) % 16 == 0);
  dim3 grid(rows, (Wp + tile - 1) / tile);
  transition_entry<T, CT, kT><<<grid, kItems, smem, s>>>(x, y, Wp, C, tile,
                                                         vec);
  return cudaSuccess;
}

template <typename T, int CT, bool kT>
void launch_p2p(const T* x, T* y, int rows, int Wp, int C, cudaStream_t s) {
  dim3 grid(rows, (Wp * C + kItems - 1) / kItems);
  transition_p2p<T, CT, kT><<<grid, kItems, 0, s>>>(x, y, Wp, C);
}

template <typename T, bool kT>
cudaError_t dispatch(int kind, const T* x, T* y, int rows, int Wp, int C,
                     cudaStream_t s) {
  // C: channels per group on the unpacked side (entry: image channels;
  // p2p: packed level width), templated at the flagship's widths.
#define VWFD_TRANSITION_CASE(CV)                                   \
  if (C == CV) {                                                   \
    if (kind == kEntry) return launch_entry<T, CV, kT>(x, y, rows, Wp, C, s); \
    launch_p2p<T, CV, kT>(x, y, rows, Wp, C, s);                   \
    return cudaSuccess;                                            \
  }
  VWFD_TRANSITION_CASE(12)
  VWFD_TRANSITION_CASE(48)
  VWFD_TRANSITION_CASE(192)
#undef VWFD_TRANSITION_CASE
  if (kind == kEntry) return launch_entry<T, 0, kT>(x, y, rows, Wp, C, s);
  launch_p2p<T, 0, kT>(x, y, rows, Wp, C, s);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* xv, void* yv, int kind, int transpose, int N,
                   int Hi, int Wi, int Ci, int Ho, int Wo, int Co,
                   cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  if ((long long)N * Ho * Wo * Co == 0) return cudaSuccess;
  if (kind == kP2U) {
    const int groups = N * Hi * Wi * (Ci / 4);
    constexpr int kG = 16 / (4 * (int)sizeof(T));
    const int threads = (groups + kG - 1) / kG;
    transition_p2u<T><<<(threads + kItems - 1) / kItems, kItems, 0, s>>>(
        x, y, groups);
    return cudaSuccess;
  }
  // packed side: (N, Hp, Wp, 16C); unpacked side: the other tensor
  const int Hp = transpose ? Hi : Ho, Wp = transpose ? Wi : Wo;
  const int Cu = transpose ? Co : Ci;
  const int C = kind == kEntry ? Cu : Cu / 4;
  return transpose ? dispatch<T, true>(kind, x, y, N * Hp, Wp, C, s)
                   : dispatch<T, false>(kind, x, y, N * Hp, Wp, C, s);
}

}  // namespace

// x: input (N,Hi,Wi,Ci), y: output (N,Ho,Wo,Co), both NHWC-contiguous,
// 16-byte aligned, fewer than 2^31 elements each.
extern "C" int vwfd_transition(const void* x, void* y, int kind, int transpose,
                               int dtype, int N, int Hi, int Wi, int Ci,
                               int Ho, int Wo, int Co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      dtype == vwfd::kBF16
          ? launch<__nv_bfloat16>(x, y, kind, transpose, N, Hi, Wi, Ci, Ho,
                                  Wo, Co, s)
          : launch<float>(x, y, kind, transpose, N, Hi, Wi, Ci, Ho, Wo, Co,
                          s);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
