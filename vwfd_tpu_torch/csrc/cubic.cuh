// Bicubic taps (a = −0.75) shared by K20 `crop_cubic` and K21 `rectify`,
// with the plain version's float32 operations in its order
// (vwfd_tpu_torch/ops/resize.py::cubic_weights and _sample_axis; the JAX
// package's vwfd_tpu/ops/resize.py:97-133): each product, sum and fused
// multiply-add one IEEE rounding, as the plain version's (the weights'
// FMAs are the ones XLA:CPU contracts the JAX expression into; no other
// contraction), so that a kernel built on them EQUALS its plain version.
#pragma once

#include "common.cuh"

namespace vwfd {

struct Cubic {
  int i[4];    // source indices of offsets −1, 0, 1, 2, clamped
  float w[4];  // their weights
};

// The weight of offset `off` at fraction t, with the operations XLA:CPU
// compiles the JAX expression to (ops/resize.py::cubic_weights):
// ad = |t − off|, c2 = ad·ad, c3 = c2·ad;
// where(ad ≤ 1, fma(c3, 1.25, −(2.25·c2)) + 1,
//       where(ad < 2, fma(ad, −6, fma(c3, −0.75, 3.75·c2)) + 3, 0)).
__device__ __forceinline__ float cubic_weight(float t, float off) {
  const float ad = fabsf(__fsub_rn(t, off));
  const float c2 = __fmul_rn(ad, ad);
  const float c3 = __fmul_rn(c2, ad);
  const float w1 = __fadd_rn(__fmaf_rn(c3, 1.25f, -__fmul_rn(2.25f, c2)), 1.f);
  const float w2 = __fsub_rn(
      __fmaf_rn(ad, -6.f, __fmaf_rn(c3, -0.75f, __fmul_rn(3.75f, c2))), -3.f);
  return ad <= 1.f ? w1 : (ad < 2.f ? w2 : 0.f);
}

// The taps of source position `pos`, clamped into [lo, hi].
__device__ __forceinline__ Cubic cubic_taps(float pos, int lo, int hi) {
  const float base = floorf(pos);
  const float t = __fsub_rn(pos, base);
  const int b = (int)base;
  Cubic c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.i[k] = min(max(b + k - 1, lo), hi);
    c.w[k] = cubic_weight(t, (float)(k - 1));
  }
  return c;
}

// The crop's source position of output index i of O along an axis whose
// window is [lo, hi): lo + ((i + ½)·(hi − lo))/O − ½ (crop_resize).
__device__ __forceinline__ float crop_pos(int i, int O, float lo, float hi) {
  return __fsub_rn(
      __fadd_rn(lo, __fdiv_rn(__fmul_rn(__fadd_rn((float)i, 0.5f),
                                        __fsub_rn(hi, lo)),
                              (float)O)),
      0.5f);
}

// The paste's source position of output index i of an axis of n pixels
// whose window is [lo, hi): ((i − lo) + ½)·n/(hi − lo) − ½ (paste_resize).
__device__ __forceinline__ float paste_pos(int i, int n, float lo, float hi) {
  return __fsub_rn(
      __fdiv_rn(__fmul_rn(__fadd_rn(__fsub_rn((float)i, lo), 0.5f), (float)n),
                __fsub_rn(hi, lo)),
      0.5f);
}

// The four taps' products summed in tap order: ((p0 + p1) + p2) + p3.
__device__ __forceinline__ float cubic_sum(const float* v, const float* w) {
  float s = __fmul_rn(v[0], w[0]);
#pragma unroll
  for (int k = 1; k < 4; ++k) s = __fadd_rn(s, __fmul_rn(v[k], w[k]));
  return s;
}

}  // namespace vwfd
