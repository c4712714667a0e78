// K10 `splice`: the embed's epilogue and the splice tamper, forward and
// backward.
//
// Replaces vwfd_tpu/models/video_model.py:186-193 (train) and :146-156,
// :262 (embed, eval): the INN output (B,H,W,T*3) in the compute dtype ->
// _to_frames -> float32 -> clamp_with_grad -> ste_quantize_255 = fwd_video,
// and the splice attacked_fwd = fwd_video*(1 - m) + prev*m, with the mask m
// (B,T,H,W,1) and the previous batch prev (B,T,H,W,3):
//
//   fv  = rint(clamp(v, 0, 1)*255) / 255      (NaN passes the clamp)
//   att = fv*(1 - m) + prev*m
//
// each operation one IEEE rounding in the plain version's order (no FMA
// contraction, __fdiv_rn for the division), so both outputs equal the
// plain PyTorch version bit for bit. Without a mask it writes fv alone (the
// embed).
//
// Backward (both quantizers are straight-through): for the cotangents Gf
// of fv and Ga of att, g = cast(Gf + Ga*(1 - m)) relaid out to (B,H,W,T*3)
// in the INN output's dtype (bfloat16 rounds to nearest even, as torch's
// cast); prev and the mask take no gradient. That is autograd's own sum of
// the two terms, so it is bit-equal too.
//
// Bound: bytes. Design, K3's row tiling: a block takes one image row b, h
// and a chunk of kChunk pixels of it. The forward stages the chunk of the
// INN output row (kChunk*T*3 values, in 16-byte vectors where the chunk is
// whole 16-byte words) in shared memory as float32, then writes the T
// output rows' chunks (kChunk*3 floats each) in float4 where image rows are
// whole 16-byte words; the backward runs the other way round. Indices of a
// row are 32-bit; the wrapper refuses 2^31 elements or more.
#include "common.cuh"

namespace {

using vwfd::load_vec;
using vwfd::store_vec;
using vwfd::to_f32;

constexpr int kChunk = 64;  // pixels of a row per block
constexpr int kRowThreads = 128;

__device__ __forceinline__ float quantize(float v) {
  v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);  // NaN passes through
  return __fdiv_rn(rintf(__fmul_rn(v, 255.f)), 255.f);
}

// The chunk's INN-output values, n = wc*T3 of them at `src`, to shared
// memory as float32 (16-byte loads when the chunk is whole 16-byte words).
template <typename T>
__device__ __forceinline__ void stage_in(const T* __restrict__ src, int n,
                                         float* rows) {
  constexpr int V = 16 / sizeof(T);
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
      (n * (int)sizeof(T)) % 16 == 0) {
    for (int e = threadIdx.x * V; e < n; e += blockDim.x * V)
      load_vec<T, V>(src + e, rows + e);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) rows[e] = to_f32(src[e]);
  }
}

// Block (row b*H + h, chunk c). VO = 4: the output rows are whole 16-byte
// words and every frame-layout tensor is 16-byte aligned.
template <typename T, int VO>
__global__ void __launch_bounds__(kRowThreads)
    splice_fwd(const T* __restrict__ in, const float* __restrict__ mask,
               const float* __restrict__ prev, float* __restrict__ fv,
               float* __restrict__ att, int Tn, int H, int W) {
  __shared__ __align__(16) float rows[kChunk * 3 * 16];  // T <= 16
  const int T3 = Tn * 3, bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int w0 = blockIdx.y * kChunk, wc = min(kChunk, W - w0);
  stage_in<T>(in + ((long long)bh * W + w0) * T3, wc * T3, rows);
  __syncthreads();
  const int n3 = wc * 3, per = n3 / VO;
  for (int q = threadIdx.x; q < Tn * per; q += blockDim.x) {
    const int t = q / per, e = (q - t * per) * VO;
    const long long px = (((long long)b * Tn + t) * H + h) * W + w0;
    const long long o = px * 3 + e;
    float f[VO], a[VO], p[VO];
    if (mask != nullptr) {
      if constexpr (VO == 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(prev + o));
        p[0] = v.x, p[1] = v.y, p[2] = v.z, p[3] = v.w;
      } else {
        p[0] = __ldg(prev + o);
      }
    }
#pragma unroll
    for (int u = 0; u < VO; ++u) {
      const int el = e + u, w = el / 3, c = el - 3 * w;
      f[u] = quantize(rows[w * T3 + t * 3 + c]);
      if (mask != nullptr) {
        const float m = __ldg(mask + px + w);
        a[u] = __fadd_rn(__fmul_rn(f[u], __fsub_rn(1.f, m)),
                         __fmul_rn(p[u], m));
      }
    }
    if constexpr (VO == 4) {
      *reinterpret_cast<float4*>(fv + o) = make_float4(f[0], f[1], f[2], f[3]);
      if (mask != nullptr)
        *reinterpret_cast<float4*>(att + o) =
            make_float4(a[0], a[1], a[2], a[3]);
    } else {
      fv[o] = f[0];
      if (mask != nullptr) att[o] = a[0];
    }
  }
}

template <typename T, int VO>
__global__ void __launch_bounds__(kRowThreads)
    splice_bwd(const float* __restrict__ gf, const float* __restrict__ ga,
               const float* __restrict__ mask, T* __restrict__ gin, int Tn,
               int H, int W) {
  __shared__ __align__(16) float rows[kChunk * 3 * 16];
  const int T3 = Tn * 3, bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int w0 = blockIdx.y * kChunk, wc = min(kChunk, W - w0);
  const int n3 = wc * 3, per = n3 / VO;
  for (int q = threadIdx.x; q < Tn * per; q += blockDim.x) {
    const int t = q / per, e = (q - t * per) * VO;
    const long long px = (((long long)b * Tn + t) * H + h) * W + w0;
    const long long o = px * 3 + e;
    float f[VO], a[VO];
    if constexpr (VO == 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(gf + o));
      f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
      if (ga != nullptr) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(ga + o));
        a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
      }
    } else {
      f[0] = __ldg(gf + o);
      if (ga != nullptr) a[0] = __ldg(ga + o);
    }
#pragma unroll
    for (int u = 0; u < VO; ++u) {
      const int el = e + u, w = el / 3, c = el - 3 * w;
      float g = f[u];
      if (ga != nullptr)
        g = __fadd_rn(g, __fmul_rn(a[u], __fsub_rn(1.f, __ldg(mask + px + w))));
      rows[w * T3 + t * 3 + c] = g;
    }
  }
  __syncthreads();
  T* dst = gin + ((long long)bh * W + w0) * T3;
  const int n = wc * T3;
  constexpr int V = 16 / sizeof(T);
  if (reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
      (n * (int)sizeof(T)) % 16 == 0) {
    for (int e = threadIdx.x * V; e < n; e += blockDim.x * V)
      store_vec<T, V>(dst + e, rows + e);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      dst[e] = vwfd::from_f32<T>(rows[e]);
  }
}

dim3 grid(int B, int H, int W) {  // x: image rows, y: chunks of a row
  return dim3(B * H, (W + kChunk - 1) / kChunk);
}

template <typename T>
int fwd(const void* in, const void* mask, const void* prev, void* fv,
        void* att, int B, int Tn, int H, int W, cudaStream_t s) {
  const auto* ip = static_cast<const T*>(in);
  const auto* mp = static_cast<const float*>(mask);
  const auto* pp = static_cast<const float*>(prev);
  auto *fp = static_cast<float*>(fv), *ap = static_cast<float*>(att);
  if (W % 4 == 0 && vwfd::aligned16({prev, fv, att}))
    splice_fwd<T, 4><<<grid(B, H, W), kRowThreads, 0, s>>>(ip, mp, pp, fp, ap,
                                                          Tn, H, W);
  else
    splice_fwd<T, 1><<<grid(B, H, W), kRowThreads, 0, s>>>(ip, mp, pp, fp, ap,
                                                          Tn, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* gf, const void* ga, const void* mask, void* gin, int B,
        int Tn, int H, int W, cudaStream_t s) {
  const auto* fp = static_cast<const float*>(gf);
  const auto* ap = static_cast<const float*>(ga);
  const auto* mp = static_cast<const float*>(mask);
  auto* gp = static_cast<T*>(gin);
  if (W % 4 == 0 && vwfd::aligned16({gf, ga}))
    splice_bwd<T, 4><<<grid(B, H, W), kRowThreads, 0, s>>>(fp, ap, mp, gp, Tn,
                                                          H, W);
  else
    splice_bwd<T, 1><<<grid(B, H, W), kRowThreads, 0, s>>>(fp, ap, mp, gp, Tn,
                                                          H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// in (B,H,W,T*3) of `dtype`; mask (B,T,H,W,1), prev and att (B,T,H,W,3) may
// be null together (fv alone). T <= 16.
extern "C" int vwfd_splice_fwd(const void* in, const void* mask,
                               const void* prev, void* fv, void* att, int B,
                               int Tn, int H, int W, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (Tn < 1 || Tn > 16) return (int)cudaErrorInvalidValue;
  if (dtype == vwfd::kBF16)
    return fwd<__nv_bfloat16>(in, mask, prev, fv, att, B, Tn, H, W, s);
  return fwd<float>(in, mask, prev, fv, att, B, Tn, H, W, s);
}

// gf, ga (B,T,H,W,3) float32 (ga and mask may be null together); gin
// (B,H,W,T*3) of `dtype`.
extern "C" int vwfd_splice_bwd(const void* gf, const void* ga,
                               const void* mask, void* gin, int B, int Tn,
                               int H, int W, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (Tn < 1 || Tn > 16) return (int)cudaErrorInvalidValue;
  if (dtype == vwfd::kBF16)
    return bwd<__nv_bfloat16>(gf, ga, mask, gin, B, Tn, H, W, s);
  return bwd<float>(gf, ga, mask, gin, B, Tn, H, W, s);
}
