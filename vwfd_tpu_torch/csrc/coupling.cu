// K2 `coupling_affine`: the RealNVP affine of one coupling half.
//
// Replaces the affine lines of vwfd_tpu/nets/inn_packed.py::_coupling_fwd /
// _coupling_inv (:201-220) with e(s) of vwfd_tpu/nets/inn.py::_e (:176-179)
// and the head's bias add and (s || t) split (:186-188):
//   s = head[r, c] + bias[c],  t = head[r, C + c] + bias[C + c]
//   e = exp(2 * sigmoid(s) - 1) + 1e-4
//   forward:  out[r, c] = e * x[r, c] + t
//   inverse:  out[r, c] = (x[r, c] - t) / e
// The 1x1 head GEMM itself stays a cuBLAS matmul outside this kernel. Rows r
// run over N*H*W; x and out are channel slices of NHWC tensors (unit channel
// stride, row strides ldx / ldo), so the kernel writes its half straight into
// the coupling's output and no concat is needed. One thread per output
// element; f32 arithmetic with explicit round-to-nearest mul/add/div, so that
// the result matches the plain PyTorch sequence of ops.
#include "common.cuh"

namespace {

using vwfd::to_f32;

template <typename T>
__global__ void coupling_affine(const T* __restrict__ head,
                                const float* __restrict__ bias,
                                const T* __restrict__ x, long long ldx,
                                T* __restrict__ out, long long ldo,
                                long long total, int C, int inverse) {
  const long long idx = vwfd::global_index();
  if (idx >= total) return;
  const int c = (int)(idx % C);
  const long long r = idx / C;
  const T* hr = head + r * 2 * C;
  const float s = __fadd_rn(to_f32(hr[c]), bias[c]);
  const float t = __fadd_rn(to_f32(hr[C + c]), bias[C + c]);
  const float sig = __frcp_rn(__fadd_rn(1.f, expf(-s)));
  const float e = __fadd_rn(expf(__fsub_rn(__fmul_rn(2.f, sig), 1.f)), 1e-4f);
  const float xv = to_f32(x[r * ldx + c]);
  const float y = inverse ? __fdiv_rn(__fsub_rn(xv, t), e)
                          : __fadd_rn(__fmul_rn(e, xv), t);
  out[r * ldo + c] = vwfd::from_f32<T>(y);
}

template <typename T>
void launch(const void* head, const float* bias, const void* x, long long ldx,
            void* out, long long ldo, long long M, int C, int inverse,
            cudaStream_t stream) {
  const long long total = M * C;
  if (total == 0) return;
  coupling_affine<T><<<vwfd::blocks_for(total), vwfd::kThreads, 0, stream>>>(
      static_cast<const T*>(head), bias, static_cast<const T*>(x), ldx,
      static_cast<T*>(out), ldo, total, C, inverse);
}

}  // namespace

// head: (M, 2C) contiguous; bias: (2C,) float32; x/out: (M, C) with row
// strides ldx/ldo and unit channel stride.
extern "C" int vwfd_coupling_affine(const void* head, const void* bias,
                                    const void* x, long long ldx, void* out,
                                    long long ldo, long long M, int C,
                                    int inverse, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == vwfd::kBF16)
    launch<__nv_bfloat16>(head, b, x, ldx, out, ldo, M, C, inverse, s);
  else
    launch<float>(head, b, x, ldx, out, ldo, M, C, inverse, s);
  return (int)cudaGetLastError();
}
