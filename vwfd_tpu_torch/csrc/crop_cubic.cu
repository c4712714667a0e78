// K20 `crop_cubic`: crop a window of the image and resample it bicubically
// (a = −0.75) to the output size, forward and backward with respect to the
// image.
//
// Replaces vwfd_tpu/ops/resize.py::crop_resize(method="bicubic") (:135-152)
// with its bicubic _sample_axis (:97-133), as CLR's crop tamper calls it
// (vwfd_tpu/models/image_model.py:230-231, 535-536). The window apex =
// (h0, h1, w0, w1) is read from device memory (one per call, shared by the
// batch), so a drawn apex reaches the kernel with no host sync. Per output
// row i (columns likewise):
//   ys = h0 + ((i + ½)·(h1 − h0))/OH − ½,  b = floor(ys),  t = ys − b,
//   taps clamp(b − 1 … b + 2, h0, h1 − 1) with the cubic weights of t
// (cubic.cuh). Rows first, then columns, as the plain version:
//   tmp[a] = Σ_k wy[k]·x[r_k, q_a]   (the row pass at column q_a)
//   y      = Σ_a wx[a]·tmp[a]
// each product and sum one IEEE rounding in tap order, so the forward is
// EQUAL to the plain version. Every tap multiplies, a weight of 0 too, so
// a NaN or Inf reaches the same outputs as in the plain version.
//
// Bound: bytes. At CLR's (8, 256, 256, 3) f32 the forward reads the window
// (at most 6.3 MB) and writes 6.3 MB; the backward reads g and writes gx:
// about 3.8 µs each way at 3.35 TB/s, near a launch's fixed cost.
//
// Design (the first version: simple and right). Forward: a thread per
// output pixel (all channels) computes its row and column taps in
// registers and reads its 16 source pixels through the caches (a window
// pixel is read by ~16 threads of neighbouring outputs: L1 hits). Backward:
// the separable transpose in two launches through a (N, OH, W, C) scratch
// the wrapper allocates. The first sums, for each output row and input
// column q, g·wx over the output columns j whose taps land on q (found by a
// binary search of the monotone floor(xs[j]); several taps of one j may
// clamp onto q at a window edge, each term kept); the second sums, for
// each input row r, the first's rows i whose taps land on r. Terms are
// added j (or i) ascending, taps in order: deterministic, no atomics, and
// a NaN in g reaches every tap index it reaches under autograd. Outside
// the window the gradient is 0. No shared memory: any width runs.
#include "cubic.cuh"

namespace {

using vwfd::Cubic;
using vwfd::crop_pos;
using vwfd::cubic_sum;
using vwfd::cubic_taps;

constexpr int kThreads = 256;
constexpr int kMaxC = 4;

__global__ void __launch_bounds__(kThreads)
    crop_cubic_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ apex,
                          float* __restrict__ y, int N, int H, int W, int C,
                          int OH, int OW) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)N * OH * OW) return;
  const int j = (int)(p % OW);
  const int i = (int)((p / OW) % OH);
  const int n = (int)(p / ((long long)OW * OH));
  const float h0 = apex[0], h1 = apex[1], w0 = apex[2], w1 = apex[3];
  const Cubic ry = cubic_taps(crop_pos(i, OH, h0, h1), (int)h0,
                              (int)__fsub_rn(h1, 1.f));
  const Cubic cx = cubic_taps(crop_pos(j, OW, w0, w1), (int)w0,
                              (int)__fsub_rn(w1, 1.f));
  const float* xn = x + (long long)n * H * W * C;
  float* out = y + p * C;
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
          v[k] = xn[((long long)ry.i[k] * W + cx.i[a]) * C + c0 + c];
        tmp[a][c] = cubic_sum(v, ry.w);
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= nc) break;
      const float v[4] = {tmp[0][c], tmp[1][c], tmp[2][c], tmp[3][c]};
      out[c0 + c] = cubic_sum(v, cx.w);
    }
  }
}

// The first output index whose tap base floor(pos) is ≥ b (O if none):
// pos is monotone in the output index.
__device__ __forceinline__ int first_base_at_least(int b, int O, float lo,
                                                   float hi) {
  int l = 0, r = O;
  while (l < r) {
    const int m = (l + r) >> 1;
    if ((int)floorf(crop_pos(m, O, lo, hi)) >= b) r = m;
    else l = m + 1;
  }
  return l;
}

// The output indices [first, last] of an axis whose clamped taps land on
// source index q of the window [lo, hi] (integers): unclamped bases in
// [q − 2, q + 1], any base ≤ lo + 1 at q = lo, any base ≥ hi − 2 at q = hi
// (each tap is checked again by the caller).
__device__ __forceinline__ void tapping(int q, int O, float flo, float fhi,
                                        int lo, int hi, int* first,
                                        int* last) {
  if (q < lo || q > hi) {  // outside the window: no output taps q
    *first = 0;
    *last = -1;
    return;
  }
  *first = q == lo ? 0 : first_base_at_least(q - 2, O, flo, fhi);
  *last = (q == hi ? O : first_base_at_least(q + 2, O, flo, fhi)) - 1;
}

// gt[n, i, q, c] = Σ_j Σ_a [cx(j).i[a] == q] g[n, i, j, c]·cx(j).w[a]
__global__ void __launch_bounds__(kThreads)
    crop_cubic_bwd_cols(const float* __restrict__ g,
                        const float* __restrict__ apex,
                        float* __restrict__ gt, int N, int W, int C, int OH,
                        int OW) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)N * OH * W) return;
  const int q = (int)(p % W);
  const long long row = p / W;  // n·OH + i
  const float w0 = apex[2], w1 = apex[3];
  const int lo = (int)w0, hi = (int)__fsub_rn(w1, 1.f);
  int j0, j1;
  tapping(q, OW, w0, w1, lo, hi, &j0, &j1);
  const float* gr = g + row * OW * C;
  for (int c0 = 0; c0 < C; c0 += kMaxC) {
    const int nc = min(kMaxC, C - c0);
    float s[kMaxC] = {0.f, 0.f, 0.f, 0.f};
    for (int j = j0; j <= j1; ++j) {
      const Cubic cx = cubic_taps(crop_pos(j, OW, w0, w1), lo, hi);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (cx.i[a] != q) continue;
#pragma unroll
        for (int c = 0; c < kMaxC; ++c)
          if (c < nc)
            s[c] = __fadd_rn(s[c], __fmul_rn(gr[(long long)j * C + c0 + c],
                                             cx.w[a]));
      }
    }
    for (int c = 0; c < nc; ++c) gt[p * C + c0 + c] = s[c];
  }
}

// gx[n, r, q, c] = Σ_i Σ_k [ry(i).i[k] == r] gt[n, i, q, c]·ry(i).w[k]
__global__ void __launch_bounds__(kThreads)
    crop_cubic_bwd_rows(const float* __restrict__ gt,
                        const float* __restrict__ apex,
                        float* __restrict__ gx, int N, int H, int W, int C,
                        int OH) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)N * H * W) return;
  const int q = (int)(p % W);
  const int r = (int)((p / W) % H);
  const int n = (int)(p / ((long long)W * H));
  const float h0 = apex[0], h1 = apex[1];
  const int lo = (int)h0, hi = (int)__fsub_rn(h1, 1.f);
  int i0, i1;
  tapping(r, OH, h0, h1, lo, hi, &i0, &i1);
  const float* gn = gt + (long long)n * OH * W * C + (long long)q * C;
  for (int c0 = 0; c0 < C; c0 += kMaxC) {
    const int nc = min(kMaxC, C - c0);
    float s[kMaxC] = {0.f, 0.f, 0.f, 0.f};
    for (int i = i0; i <= i1; ++i) {
      const Cubic ry = cubic_taps(crop_pos(i, OH, h0, h1), lo, hi);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (ry.i[k] != r) continue;
#pragma unroll
        for (int c = 0; c < kMaxC; ++c)
          if (c < nc)
            s[c] = __fadd_rn(
                s[c], __fmul_rn(gn[(long long)i * W * C + c0 + c], ry.w[k]));
      }
    }
    for (int c = 0; c < nc; ++c) gx[p * C + c0 + c] = s[c];
  }
}

unsigned int blocks(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int vwfd_crop_cubic_fwd(const void* x, const void* apex, void* y,
                                   int N, int H, int W, int C, int OH, int OW,
                                   void* stream) {
  const long long n = (long long)N * OH * OW;
  if (n == 0 || C == 0) return (int)cudaSuccess;
  if (blocks(n) > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  crop_cubic_fwd_kernel<<<blocks(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(apex),
      static_cast<float*>(y), N, H, W, C, OH, OW);
  return (int)cudaGetLastError();
}

extern "C" int vwfd_crop_cubic_bwd(const void* g, const void* apex,
                                   void* gt, void* gx, int N, int H, int W,
                                   int C, int OH, int OW, void* stream) {
  const long long nt = (long long)N * OH * W, nx = (long long)N * H * W;
  if (nx == 0 || C == 0) return (int)cudaSuccess;
  if (blocks(nt) > 0x7fffffffu || blocks(nx) > 0x7fffffffu)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt > 0) {
    crop_cubic_bwd_cols<<<blocks(nt), kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(apex),
        static_cast<float*>(gt), N, W, C, OH, OW);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  crop_cubic_bwd_rows<<<blocks(nx), kThreads, 0, st>>>(
      static_cast<const float*>(gt), static_cast<const float*>(apex),
      static_cast<float*>(gx), N, H, W, C, OH);
  return (int)cudaGetLastError();
}
