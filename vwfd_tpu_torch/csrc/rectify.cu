// K21 `rectify`: CLR's scale-back rectification before the reverse pass.
//
// Replaces vwfd_tpu/attacks/spatial.py::rectify_crop_pad (:196-201) with
// its bicubic paste_resize (:149-174), as vwfd_tpu/models/image_model.py
// calls it (:354-355 in the train step, :548-549 in the eval step). For
// attacked copy m (of M) and its clean image clean[m mod B]:
//   ideal  = clean·inside
//   paste  = clip(P(attacked), 0, 1)·inside
//   out    = ideal + (paste − ideal)          (the value of JAX's
//            ideal + stop_gradient(paste − ideal))
// where inside is 1 in the window [h0, h1) × [w0, w1) and P resamples the
// full-size copy back to the window at its place: output row i reads
// source row ((i − h0) + ½)·H/(h1 − h0) − ½ (columns likewise), four
// bicubic taps clamped to the image (cubic.cuh), rows first, then columns,
// each product and sum one IEEE rounding in the plain version's order: the
// output EQUALS the plain version's. The clip keeps NaN (jnp.clip's
// maximum and minimum propagate it), and the window enters as products
// and sums, never as a branch, so an Inf or NaN attacked pixel reaches the
// outputs it reaches in JAX (outside the window too, where P is computed
// and multiplied by 0).
//
// The backward, g·inside summed over the copies of each clean image, is
// PyTorch ops in the wrapper's autograd Function (kernels/rectify.py).
//
// Bound: bytes. At CLR's train step (48 copies of 256² RGB against 8
// clean images, f32) it reads attacked (37.7 MB) and clean (6.3 MB) and
// writes 37.7 MB: about 24 µs at 3.35 TB/s.
//
// Design (the first version: simple and right): a thread per output pixel
// (all channels) computes its row and column taps in registers and reads
// its 16 source pixels through the caches.
#include "cubic.cuh"

namespace {

using vwfd::Cubic;
using vwfd::cubic_sum;
using vwfd::cubic_taps;
using vwfd::paste_pos;

constexpr int kThreads = 256;
constexpr int kMaxC = 4;

__device__ __forceinline__ float clip01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.f), 1.f);
}

__global__ void __launch_bounds__(kThreads)
    rectify_kernel(const float* __restrict__ att,
                   const float* __restrict__ clean,
                   const float* __restrict__ apex, float* __restrict__ out,
                   int M, int B, int H, int W, int C) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)M * H * W) return;
  const int j = (int)(p % W);
  const int i = (int)((p / W) % H);
  const int m = (int)(p / ((long long)W * H));
  const float h0 = apex[0], h1 = apex[1], w0 = apex[2], w1 = apex[3];
  const float fi = (float)i, fj = (float)j;
  const float inside =
      (fi >= h0 && fi < h1 && fj >= w0 && fj < w1) ? 1.f : 0.f;
  const Cubic ry = cubic_taps(paste_pos(i, H, h0, h1), 0, H - 1);
  const Cubic cx = cubic_taps(paste_pos(j, W, w0, w1), 0, W - 1);
  const float* an = att + (long long)m * H * W * C;
  const float* cl = clean + (((long long)(m % B) * H + i) * W + j) * C;
  float* o = out + p * C;
  for (int c0 = 0; c0 < C; c0 += kMaxC) {
    const int nc = min(kMaxC, C - c0);
    float tmp[4][kMaxC];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c >= nc) break;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = an[((long long)ry.i[k] * W + cx.i[a]) * C + c0 + c];
        tmp[a][c] = cubic_sum(v, ry.w);
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= nc) break;
      const float v[4] = {tmp[0][c], tmp[1][c], tmp[2][c], tmp[3][c]};
      const float paste = __fmul_rn(clip01(cubic_sum(v, cx.w)), inside);
      const float ideal = __fmul_rn(cl[c0 + c], inside);
      o[c0 + c] = __fadd_rn(ideal, __fsub_rn(paste, ideal));
    }
  }
}

}  // namespace

extern "C" int vwfd_rectify(const void* attacked, const void* clean,
                            const void* apex, void* out, int M, int B, int H,
                            int W, int C, void* stream) {
  const long long n = (long long)M * H * W;
  if (n == 0 || C == 0) return (int)cudaSuccess;
  if (B < 1 || M % B) return (int)cudaErrorInvalidValue;
  const long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rectify_kernel<<<(unsigned int)grid, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(attacked), static_cast<const float*>(clean),
      static_cast<const float*>(apex), static_cast<float*>(out), M, B, H, W,
      C);
  return (int)cudaGetLastError();
}
