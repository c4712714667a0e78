// K17 `crop_resize`: crop a window of the image and resample it bilinearly
// back to the full size, forward and backward with respect to the image.
//
// Replaces vwfd_tpu/ops/resize.py::crop_resize (:135-152) with its bilinear
// _sample_axis (:97-133), as vwfd_tpu/attacks/spatial.py::crop_attack
// (:70-77) calls it. The window apex = (h0, h1, w0, w1) is read from device
// memory (one per call, shared by the batch), so a drawn apex reaches the
// kernel with no host sync. Per output row i (columns likewise):
//   ys = h0 + (i + ½)·(h1 − h0)/OH − ½,  b = floor(ys),  t = ys − b
//   taps clamp(b, h0, h1 − 1) and clamp(b + 1, h0, h1 − 1), weights 1 − t, t
// (taps clamp to the window, not to the image). H is sampled first, then W:
//   out = (x[r0,q0]·(1−t) + x[r1,q0]·t)·(1−s) + (x[r0,q1]·(1−t) + x[r1,q1]·t)·s
// each product and sum one IEEE rounding in the plain version's order, so
// the forward is EQUAL to it. The backward is the transpose in gather form:
// each input pixel sums, over the output rows i that tap its row, the
// weight times the sum over the output columns j that tap its column of
// weight · g: deterministic, no float atomics; the output ranges that tap
// a row or column are found by binary search (the taps are monotone).
//
// Bound: bytes. At the HiDDeN path's (8, 3, 128, 128) f32 the forward reads
// the window (at most 1.57 MB) and writes 1.57 MB, under a microsecond at
// 3.35 TB/s: below a launch's fixed cost.
//
// Design: one thread per output pixel (forward) or input pixel (backward),
// its channels in a loop; the coordinates are recomputed per thread from the
// apex (a division each way), the four taps gathered through L1.
#include "common.cuh"

namespace {

constexpr int kThr = 256;

struct Taps {
  int i0, i1;
  float w0, w1;
};

// The bilinear taps of output index i of O along an axis whose window is
// [lo, hi), with the plain version's float32 operations.
__device__ __forceinline__ Taps taps(int i, int O, float lo, float hi) {
  const float len = __fsub_rn(hi, lo);
  const float ys = __fsub_rn(
      __fadd_rn(lo, __fdiv_rn(__fmul_rn(__fadd_rn((float)i, 0.5f), len),
                              (float)O)),
      0.5f);
  const float base = floorf(ys);
  const float t = __fsub_rn(ys, base);
  const int b = (int)base, l = (int)lo, h = (int)__fsub_rn(hi, 1.f);
  return {min(max(b, l), h), min(max(b + 1, l), h), __fsub_rn(1.f, t), t};
}

// The output indices that tap input index r: [first i with i1 >= r,
// last i with i0 <= r] (empty when lo > hi).
__device__ __forceinline__ void tapping(int r, int O, float lo, float hi,
                                        int& lo_i, int& hi_i) {
  int a = 0, b = O;  // first i in [0, O) with taps(i).i1 >= r
  while (a < b) {
    const int m = (a + b) >> 1;
    if (taps(m, O, lo, hi).i1 >= r) b = m; else a = m + 1;
  }
  lo_i = a;
  a = 0, b = O;  // first i with taps(i).i0 > r
  while (a < b) {
    const int m = (a + b) >> 1;
    if (taps(m, O, lo, hi).i0 > r) b = m; else a = m + 1;
  }
  hi_i = a - 1;
}

__global__ void __launch_bounds__(kThr)
    crop_resize_fwd(const float* __restrict__ x,
                    const float* __restrict__ apex, float* __restrict__ out,
                    int N, int H, int W, int C, int OH, int OW) {
  const long long idx = (long long)blockIdx.x * kThr + threadIdx.x;
  if (idx >= (long long)N * OH * OW) return;
  const int j = (int)(idx % OW);
  const long long ni = idx / OW;
  const int i = (int)(ni % OH), n = (int)(ni / OH);
  const Taps ty = taps(i, OH, apex[0], apex[1]);
  const Taps tx = taps(j, OW, apex[2], apex[3]);
  const float* r0 = x + ((long long)n * H + ty.i0) * W * C;
  const float* r1 = x + ((long long)n * H + ty.i1) * W * C;
  float* o = out + idx * C;
  for (int c = 0; c < C; ++c) {
    const float a = __fadd_rn(__fmul_rn(r0[tx.i0 * C + c], ty.w0),
                              __fmul_rn(r1[tx.i0 * C + c], ty.w1));
    const float b = __fadd_rn(__fmul_rn(r0[tx.i1 * C + c], ty.w0),
                              __fmul_rn(r1[tx.i1 * C + c], ty.w1));
    o[c] = __fadd_rn(__fmul_rn(a, tx.w0), __fmul_rn(b, tx.w1));
  }
}

__device__ __forceinline__ float weight_at(const Taps& t, int r) {
  return (t.i0 == r ? t.w0 : 0.f) + (t.i1 == r ? t.w1 : 0.f);
}

__global__ void __launch_bounds__(kThr)
    crop_resize_bwd(const float* __restrict__ g,
                    const float* __restrict__ apex, float* __restrict__ gx,
                    int N, int H, int W, int C, int OH, int OW) {
  const long long idx = (long long)blockIdx.x * kThr + threadIdx.x;
  if (idx >= (long long)N * H * W) return;
  const int q = (int)(idx % W);
  const long long nr = idx / W;
  const int r = (int)(nr % H), n = (int)(nr / H);
  const float h0 = apex[0], h1 = apex[1], w0 = apex[2], w1 = apex[3];
  float* o = gx + idx * C;
  int ilo, ihi, jlo, jhi;
  tapping(r, OH, h0, h1, ilo, ihi);
  tapping(q, OW, w0, w1, jlo, jhi);
  const bool inside = r >= (int)h0 && r <= (int)__fsub_rn(h1, 1.f) &&
                      q >= (int)w0 && q <= (int)__fsub_rn(w1, 1.f);
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
    if (inside) {
      for (int i = ilo; i <= ihi; ++i) {
        const float wr = weight_at(taps(i, OH, h0, h1), r);
        const float* gr = g + ((long long)n * OH + i) * OW * C + c;
        float inner = 0.f;
        for (int j = jlo; j <= jhi; ++j)
          inner = __fadd_rn(inner,
                            __fmul_rn(gr[(long long)j * C],
                                      weight_at(taps(j, OW, w0, w1), q)));
        acc = __fadd_rn(acc, __fmul_rn(inner, wr));
      }
    }
    o[c] = acc;
  }
}

}  // namespace

// x: (N, H, W, C) f32 contiguous; apex: 4 f32 on the device, (h0, h1, w0,
// w1) with 0 <= h0 < h1 <= H and 0 <= w0 < w1 <= W, integer-valued; out:
// (N, OH, OW, C).
extern "C" int vwfd_crop_resize_fwd(const void* x, const void* apex,
                                    void* out, int N, int H, int W, int C,
                                    int OH, int OW, void* stream) {
  const long long n = (long long)N * OH * OW;
  if (n == 0) return (int)cudaSuccess;
  crop_resize_fwd<<<(unsigned)((n + kThr - 1) / kThr), kThr, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(apex),
      static_cast<float*>(out), N, H, W, C, OH, OW);
  return (int)cudaGetLastError();
}

// g: (N, OH, OW, C) the output's cotangent; gx: (N, H, W, C).
extern "C" int vwfd_crop_resize_bwd(const void* g, const void* apex, void* gx,
                                    int N, int H, int W, int C, int OH,
                                    int OW, void* stream) {
  const long long n = (long long)N * H * W;
  if (n == 0) return (int)cudaSuccess;
  crop_resize_bwd<<<(unsigned)((n + kThr - 1) / kThr), kThr, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(apex),
      static_cast<float*>(gx), N, H, W, C, OH, OW);
  return (int)cudaGetLastError();
}
