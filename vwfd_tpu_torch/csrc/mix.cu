// K9 `attack_mix`: the flagship attack pool's per-frame α-mix with its 3x3
// gaussian blur and the post-attack epilogue, forward and backward.
//
// Replaces vwfd_tpu/attacks/combined.py:52 (the α-mix of the five attacked
// variants), ops/filters.py:38-45 (the depthwise 3x3, sigma 2 gaussian with
// zero padding) and the epilogue after the pool (models/video_model.py:198
// train: ste_quantize_255(clamp_with_grad(.)); :264 eval and :369 montage:
// clip to [0, 1]). Per frame n of (N, H, W, 3) float32 tensors:
//
//   out = ((a0*A0 + AJ) + a3*A3) + a4*blur(X)
//   blur(X) = ((0 + k00*v00) + k01*v01) + ...   (nine taps, raster order)
//
// X is the spliced clip, A0 the resize round trip, AJ the JPEG pair (K5,
// with a1 and a2 already in it), A3 the median (K6); (a0..a4) = alpha[n].
// The epilogue is none, clamp to [0, 1] (NaN passes, as torch.clamp), or
// clamp then rint(v*255)/255. Every operation is one IEEE rounding in the
// plain version's order (__fmul_rn / __fadd_rn: no FMA contraction; the
// division by 255 is __fdiv_rn, never a reciprocal), so the forward equals
// the plain PyTorch version bit for bit: one ulp before the quantizer would
// move a pixel by a level.
//
// Backward, for the cotangent G of out (both straight-through epilogues
// pass it unchanged): dX = a4*blur^T(G), and the gaussian is symmetric, so
// blur^T is the same zero-padded 3x3; dA0 = a0*G; dA3 = a3*G; AJ takes G
// itself (the wrapper passes G on).
//
// Bound: bytes. Design: one thread per 4 consecutive floats of an image row
// (one float per thread where rows are no whole 16-byte words). The thread
// loads the float4 before, at and after its own in each of the three rows
// of the window (zero outside the image: the padding), which hold every
// neighbour +-3 floats (one pixel) away; the neighbouring threads' loads
// of the same words hit L1. 32-bit indices: the wrapper refuses tensors of
// 2^31 elements or more.
#include "common.cuh"

namespace {

using vwfd::kThreads;

struct Taps {
  float k[9];  // the 3x3 gaussian, raster order
};

enum Epilogue : int { kNone = 0, kClamp = 1, kQuantize = 2 };

__device__ __forceinline__ float clamp01(float v) {
  return v < 0.f ? 0.f : (v > 1.f ? 1.f : v);  // NaN passes through
}

template <int E>
__device__ __forceinline__ float epilogue(float v) {
  if (E != kNone) v = clamp01(v);
  if (E == kQuantize) v = __fdiv_rn(rintf(__fmul_rn(v, 255.f)), 255.f);
  return v;
}

// The V floats of `p` at element e of a row of RW floats, zero outside
// [0, RW) or when the row is outside the image (`in` false).
template <int V>
__device__ __forceinline__ void load_row(const float* __restrict__ p, int e,
                                         int RW, bool in, float* v) {
  if constexpr (V == 4) {
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in && e >= 0 && e < RW)
      f = __ldg(reinterpret_cast<const float4*>(p + e));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    v[0] = (in && e >= 0 && e < RW) ? __ldg(p + e) : 0.f;
  }
}

template <int V>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float* v) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[0] = v[0];
}

// blur of the V floats at element `col` of row y of image `img` (rows of
// RW floats, H rows): nine taps in raster order from zero.
template <int V>
__device__ __forceinline__ void blur(const float* __restrict__ img, int y,
                                     int H, int RW, int col, const Taps& t,
                                     float* out) {
  if constexpr (V == 4) {
    // win[r][j]: element col - 4 + j of row y + r - 1, j in [0, 12)
    float win[3][12];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int yy = y + r - 1;
      const bool in = yy >= 0 && yy < H;
      const float* row = img + (long long)(in ? yy : 0) * RW;
#pragma unroll
      for (int s = 0; s < 3; ++s)
        load_row<4>(row, col + (s - 1) * 4, RW, in, &win[r][s * 4]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)  // element col + u + (dx - 1)*3
          acc = __fadd_rn(acc, __fmul_rn(t.k[dy * 3 + dx],
                                         win[dy][4 + u + (dx - 1) * 3]));
      out[u] = acc;
    }
  } else {
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int yy = y + dy - 1, e = col + (dx - 1) * 3;
        const bool in = yy >= 0 && yy < H;
        float v;
        load_row<1>(img + (long long)(in ? yy : 0) * RW, e, RW, in, &v);
        acc = __fadd_rn(acc, __fmul_rn(t.k[dy * 3 + dx], v));
      }
    out[0] = acc;
  }
}

template <int V, int E>
__global__ void __launch_bounds__(kThreads)
    attack_mix_fwd(const float* __restrict__ x, const float* __restrict__ a0,
                   const float* __restrict__ aj, const float* __restrict__ a3,
                   const float* __restrict__ alpha, float* __restrict__ out,
                   Taps taps, int H, int RW, int total) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= total) return;
  const int per_row = RW / V;
  const int row = q / per_row, col = (q - row * per_row) * V;
  const int n = row / H, y = row - n * H;
  const float* img = x + (long long)n * H * RW;
  float bl[V], v0[V], vj[V], v3[V], o[V];
  blur<V>(img, y, H, RW, col, taps, bl);
  const long long at = (long long)row * RW + col;
  load_row<V>(a0 + at, 0, RW, true, v0);
  load_row<V>(aj + at, 0, RW, true, vj);
  load_row<V>(a3 + at, 0, RW, true, v3);
  const float al0 = __ldg(alpha + 5 * n), al3 = __ldg(alpha + 5 * n + 3),
              al4 = __ldg(alpha + 5 * n + 4);
#pragma unroll
  for (int u = 0; u < V; ++u) {
    float m = __fadd_rn(__fmul_rn(al0, v0[u]), vj[u]);
    m = __fadd_rn(m, __fmul_rn(al3, v3[u]));
    m = __fadd_rn(m, __fmul_rn(al4, bl[u]));
    o[u] = epilogue<E>(m);
  }
  store_row<V>(out + at, o);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    attack_mix_bwd(const float* __restrict__ g,
                   const float* __restrict__ alpha, float* __restrict__ dx,
                   float* __restrict__ da0, float* __restrict__ da3,
                   Taps taps, int H, int RW, int total) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= total) return;
  const int per_row = RW / V;
  const int row = q / per_row, col = (q - row * per_row) * V;
  const int n = row / H, y = row - n * H;
  float bl[V], gv[V], o[V];
  blur<V>(g + (long long)n * H * RW, y, H, RW, col, taps, bl);
  const long long at = (long long)row * RW + col;
  load_row<V>(g + at, 0, RW, true, gv);
  const float al0 = __ldg(alpha + 5 * n), al3 = __ldg(alpha + 5 * n + 3),
              al4 = __ldg(alpha + 5 * n + 4);
#pragma unroll
  for (int u = 0; u < V; ++u) o[u] = __fmul_rn(al4, bl[u]);
  store_row<V>(dx + at, o);
#pragma unroll
  for (int u = 0; u < V; ++u) o[u] = __fmul_rn(gv[u], al0);
  store_row<V>(da0 + at, o);
#pragma unroll
  for (int u = 0; u < V; ++u) o[u] = __fmul_rn(gv[u], al3);
  store_row<V>(da3 + at, o);
}

Taps taps_of(const float* k) {
  Taps t;
  for (int i = 0; i < 9; ++i) t.k[i] = k[i];
  return t;
}

// Rows of whole 16-byte words and every tensor on a 16-byte boundary.
bool vectorizable(int RW, std::initializer_list<const void*> ptrs) {
  return RW % 4 == 0 && vwfd::aligned16(ptrs);
}

template <int V>
int launch_fwd(const void* x, const void* a0, const void* aj, const void* a3,
               const void* alpha, void* out, Taps t, int N, int H, int RW,
               int epi, cudaStream_t s) {
  const int total = N * H * (RW / V);
  const dim3 grid(vwfd::blocks_for(total));
  const auto* xp = static_cast<const float*>(x);
  const auto* a0p = static_cast<const float*>(a0);
  const auto* ajp = static_cast<const float*>(aj);
  const auto* a3p = static_cast<const float*>(a3);
  const auto* alp = static_cast<const float*>(alpha);
  auto* op = static_cast<float*>(out);
  switch (epi) {
    case kNone:
      attack_mix_fwd<V, kNone><<<grid, kThreads, 0, s>>>(
          xp, a0p, ajp, a3p, alp, op, t, H, RW, total);
      break;
    case kClamp:
      attack_mix_fwd<V, kClamp><<<grid, kThreads, 0, s>>>(
          xp, a0p, ajp, a3p, alp, op, t, H, RW, total);
      break;
    case kQuantize:
      attack_mix_fwd<V, kQuantize><<<grid, kThreads, 0, s>>>(
          xp, a0p, ajp, a3p, alp, op, t, H, RW, total);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vwfd_attack_mix_fwd(const void* x, const void* a0,
                                   const void* aj, const void* a3,
                                   const void* alpha, void* out,
                                   const float* taps, int N, int H, int W,
                                   int epilogue, void* stream) {
  const int RW = 3 * W;
  const Taps t = taps_of(taps);
  auto s = static_cast<cudaStream_t>(stream);
  if (vectorizable(RW, {x, a0, aj, a3, out}))
    return launch_fwd<4>(x, a0, aj, a3, alpha, out, t, N, H, RW, epilogue,
                         s);
  return launch_fwd<1>(x, a0, aj, a3, alpha, out, t, N, H, RW, epilogue, s);
}

extern "C" int vwfd_attack_mix_bwd(const void* g, const void* alpha, void* dx,
                                   void* da0, void* da3, const float* taps,
                                   int N, int H, int W, void* stream) {
  const int RW = 3 * W;
  const Taps t = taps_of(taps);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const float*>(g);
  const auto* alp = static_cast<const float*>(alpha);
  auto *dxp = static_cast<float*>(dx), *d0 = static_cast<float*>(da0),
       *d3 = static_cast<float*>(da3);
  if (vectorizable(RW, {g, dx, da0, da3})) {
    const int total = N * H * (RW / 4);
    attack_mix_bwd<4><<<vwfd::blocks_for(total), kThreads, 0, s>>>(
        gp, alp, dxp, d0, d3, t, H, RW, total);
  } else {
    const int total = N * H * RW;
    attack_mix_bwd<1><<<vwfd::blocks_for(total), kThreads, 0, s>>>(
        gp, alp, dxp, d0, d3, t, H, RW, total);
  }
  return (int)cudaGetLastError();
}
