// K22 `ssim_grad`: the gradient of the windowed SSIM's mean with respect to
// its first image.
//
// Replaces the VJP that JAX's autodiff takes of vwfd_tpu/metrics/
// metrics.py::ssim (:65-79) in CLR's loss, 0.1·(1 − ssim(fwd_rgb, img))
// (vwfd_tpu/models/image_model.py:398). K8 computes the forward. With the
// 11-tap gaussian w (σ 1.5; zero "same" padding), per pixel and channel
//   μ1, μ2, E11, E22, E12 = the windowed sums of x1, x2, x1², x2², x1·x2,
//   A1 = 2μ1μ2 + c1, A2 = 2(E12 − μ1μ2) + c2,
//   B1 = μ1² + μ2² + c1, B2 = (E11 − μ1²) + (E22 − μ2²) + c2,
//   S = A1·A2/(B1·B2),
// the map's partial derivatives are
//   α = ∂S/∂μ1  = S·(2μ2/A1 − 2μ2/A2 − 2μ1/B1 + 2μ1/B2),
//   β = ∂S/∂E11 = −S/B2,   γ = ∂S/∂E12 = 2S/A2,
// and, the window being symmetric,
//   dx1[p] = s_n · Σ_q w(q − p)·(α(q) + 2·x1[p]·β(q) + x2[p]·γ(q))
//          = s_n · (Wα + 2·x1·Wβ + x2·Wγ)[p]
// over the q inside the image, s_n the cotangent of the image's share of
// the mean (the wrapper's scale: ḡ/(N·H·W·C) + ḡ_n/(H·W·C)).
//
// Two launches. `ssim_maps` recomputes K8's five windowed sums of a 32×32
// tile of one channel (the tile and a 5-pixel halo of x1 and x2 staged in
// shared memory, zero outside the image; the vertical 11-tap pass into
// shared memory, then the horizontal) and writes α, β, γ as three planes;
// `ssim_apply` stages the three planes' tile with its halo (zero outside
// the image), applies the window to each the same way and combines with x1
// and x2. Sums run in another order than the plain version's 121-term
// chain (and may contract into FMAs), and σ² = E[x²] − μ² cancels where a
// window is flat, so a gradient value may part from the plain version's by
// up to ~1e-4 of its max; chip_smoke.py and the card tests bound it
// against the plain gradient's max.
//
// Bound: the larger of x1 and x2 read and dx written (3 planes: 18.9 MB
// at CLR's (8, 256, 256, 3), 5.6 µs at 3.35 TB/s) and the least
// operations, 346 f32 a value (kernels/ssim_grad.py's OPS: four windowed
// sums for the forward, three for the transpose, the products, the maps;
// this kernel sums five in its forward pass, E[x1²] and E[x2²] apart).
#include "common.cuh"

namespace {

constexpr int kWin = 11, kHalo = 5, kTile = 32;
constexpr int kSpan = kTile + 2 * kHalo;  // 42
constexpr int kThreads = 256;

struct Taps {
  float w[kWin];
};

__device__ __forceinline__ long long at(int n, int y, int x, int c, int H,
                                        int W, int C) {
  return (((long long)n * H + y) * W + x) * C + c;
}

// Stage a (kSpan × kSpan) tile of one channel of `src` into `dst`, zero
// outside the image.
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      float* dst, int n, int c, int y0,
                                      int x0, int H, int W, int C) {
  for (int k = threadIdx.x; k < kSpan * kSpan; k += kThreads) {
    const int y = y0 - kHalo + k / kSpan, x = x0 - kHalo + k % kSpan;
    dst[k] = (y >= 0 && y < H && x >= 0 && x < W)
                 ? src[at(n, y, x, c, H, W, C)]
                 : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    ssim_maps(const float* __restrict__ x1, const float* __restrict__ x2,
              Taps taps, float* __restrict__ alpha, float* __restrict__ beta,
              float* __restrict__ gamma, int H, int W, int C) {
  __shared__ float s1[kSpan * kSpan], s2[kSpan * kSpan];
  __shared__ float v[5][kTile * kSpan];
  const int n = blockIdx.z / C, c = blockIdx.z % C;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  stage(x1, s1, n, c, y0, x0, H, W, C);
  stage(x2, s2, n, c, y0, x0, H, W, C);
  __syncthreads();
  for (int k = threadIdx.x; k < kTile * kSpan; k += kThreads) {
    const int r = k / kSpan, col = k % kSpan;
    float m1 = 0.f, m2 = 0.f, e11 = 0.f, e22 = 0.f, e12 = 0.f;
#pragma unroll
    for (int t = 0; t < kWin; ++t) {
      const float a = s1[(r + t) * kSpan + col], b = s2[(r + t) * kSpan + col];
      const float w = taps.w[t];
      m1 += w * a;
      m2 += w * b;
      e11 += w * (a * a);
      e22 += w * (b * b);
      e12 += w * (a * b);
    }
    v[0][k] = m1;
    v[1][k] = m2;
    v[2][k] = e11;
    v[3][k] = e22;
    v[4][k] = e12;
  }
  __syncthreads();
  const float c1 = 0.01f * 0.01f, c2 = 0.03f * 0.03f;
  for (int k = threadIdx.x; k < kTile * kTile; k += kThreads) {
    const int r = k / kTile, col = k % kTile;
    const int y = y0 + r, x = x0 + col;
    if (y >= H || x >= W) continue;
    float q[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < kWin; ++t) {
      const float w = taps.w[t];
#pragma unroll
      for (int u = 0; u < 5; ++u) q[u] += w * v[u][r * kSpan + col + t];
    }
    const float mu1 = q[0], mu2 = q[1];
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu12 = mu1 * mu2;
    const float a1 = 2.f * mu12 + c1;
    const float a2 = 2.f * (q[4] - mu12) + c2;
    const float b1 = mu1_sq + mu2_sq + c1;
    const float b2 = (q[2] - mu1_sq) + (q[3] - mu2_sq) + c2;
    const float s = (a1 * a2) / (b1 * b2);
    const long long o = at(n, y, x, c, H, W, C);
    alpha[o] = s * (2.f * mu2 / a1 - 2.f * mu2 / a2 - 2.f * mu1 / b1 +
                    2.f * mu1 / b2);
    beta[o] = -s / b2;
    gamma[o] = 2.f * s / a2;
  }
}

__global__ void __launch_bounds__(kThreads)
    ssim_apply(const float* __restrict__ x1, const float* __restrict__ x2,
               const float* __restrict__ alpha,
               const float* __restrict__ beta,
               const float* __restrict__ gamma,
               const float* __restrict__ scale, Taps taps,
               float* __restrict__ dx, int H, int W, int C) {
  __shared__ float sa[kSpan * kSpan], sb[kSpan * kSpan], sg[kSpan * kSpan];
  __shared__ float v[3][kTile * kSpan];
  const int n = blockIdx.z / C, c = blockIdx.z % C;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  stage(alpha, sa, n, c, y0, x0, H, W, C);
  stage(beta, sb, n, c, y0, x0, H, W, C);
  stage(gamma, sg, n, c, y0, x0, H, W, C);
  __syncthreads();
  for (int k = threadIdx.x; k < kTile * kSpan; k += kThreads) {
    const int r = k / kSpan, col = k % kSpan;
    float qa = 0.f, qb = 0.f, qg = 0.f;
#pragma unroll
    for (int t = 0; t < kWin; ++t) {
      const int i = (r + t) * kSpan + col;
      const float w = taps.w[t];
      qa += w * sa[i];
      qb += w * sb[i];
      qg += w * sg[i];
    }
    v[0][k] = qa;
    v[1][k] = qb;
    v[2][k] = qg;
  }
  __syncthreads();
  const float sn = scale[n];
  for (int k = threadIdx.x; k < kTile * kTile; k += kThreads) {
    const int r = k / kTile, col = k % kTile;
    const int y = y0 + r, x = x0 + col;
    if (y >= H || x >= W) continue;
    float qa = 0.f, qb = 0.f, qg = 0.f;
#pragma unroll
    for (int t = 0; t < kWin; ++t) {
      const int i = r * kSpan + col + t;
      const float w = taps.w[t];
      qa += w * v[0][i];
      qb += w * v[1][i];
      qg += w * v[2][i];
    }
    const long long o = at(n, y, x, c, H, W, C);
    dx[o] = sn * ((qa + 2.f * x1[o] * qb) + x2[o] * qg);
  }
}

}  // namespace

extern "C" int vwfd_ssim_grad(const void* x1, const void* x2,
                              const void* scale, const float* taps,
                              void* alpha, void* beta, void* gamma, void* dx,
                              int N, int H, int W, int C, void* stream) {
  if ((long long)N * H * W * C == 0) return (int)cudaSuccess;
  if ((long long)N * C > 65535) return (int)cudaErrorInvalidValue;
  Taps t;
  for (int k = 0; k < kWin; ++k) t.w[k] = taps[k];
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, N * C);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  ssim_maps<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x1), static_cast<const float*>(x2), t,
      static_cast<float*>(alpha), static_cast<float*>(beta),
      static_cast<float*>(gamma), H, W, C);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssim_apply<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x1), static_cast<const float*>(x2),
      static_cast<const float*>(alpha), static_cast<const float*>(beta),
      static_cast<const float*>(gamma), static_cast<const float*>(scale), t,
      static_cast<float*>(dx), H, W, C);
  return (int)cudaGetLastError();
}
