// K12 `qconv_t`: the UNet decoder's int8 2x2 / stride-2 transposed
// convolution with its signed requant, stored depth-to-space.
//
// Replaces vwfd_tpu/nets/unet_int8.py::apply_int8's
// `lax.conv_transpose(zi, up_w, (2, 2), "SAME", preferred_element_type=
// int32)` and `requant(u, up_m, up_b, -127)` (:257-260). A 2x2 kernel at
// stride 2 touches each output pixel once, so the op is one GEMM:
//   acc[(i, j), (p, q, co)] = sum_ci x[i, j, ci] * w[p, q, co, ci]
//   out[2i + p, 2j + q, co] = clip(rint(acc*m[co] + b[co]), -127, 127)
// w is the port's layout, (2, 2, cout, cin) int8, already flipped from
// flax's HWIO kernel (out[2i+p] reads flax's tap 1-p; convert.py
// ::unet_int8_from_jax, once). Epilogue arithmetic as K11's: float(acc)
// nearest even, __fmul_rn then __fadd_rn, rintf; equal to the plain
// version (kernels/qconv_t.py) bit for bit.
//
// Bound: operations (the flagship's four launches, 0.134 G multiply-adds a
// frame each, 64 frames). Design: the 1x1 implicit-GEMM core of qmma.cuh
// with the 4*cout columns as its output columns; the epilogue scatters each
// column to its sub-pixel.
#include "qmma.cuh"

namespace {

using namespace vwfd::qmma;

struct Args {
  Src a;
  const float* m;
  const float* bias;
  int8_t* out;  // (N, 2H, 2W, cout)
  int N, H, W, cout;
};

__global__ void __launch_bounds__(kThreads) qconv_t_kernel(const Args args) {
  __shared__ __align__(16) uint8_t sa[Shape<1>::kABytes];
  __shared__ __align__(16) uint8_t sb[Shape<1>::kBBytes];
  const Geo g = block_geo<1>(args.N, args.H, args.W);
  const int n0 = blockIdx.y * kBN, cols = 4 * args.cout;
  Acc acc;
  accumulate<1>(sa, sb, args.a, g, n0, cols, 0, acc);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + acc_col(j, e);
        int img, y, x;
        if (n >= cols || !out_pixel<1>(g, acc_row(i, e), img, y, x)) continue;
        const int pq = n / args.cout, co = n - pq * args.cout;
        const long long o =
            (((long long)img * 2 * args.H + 2 * y + (pq >> 1)) * 2 * args.W +
             2 * x + (pq & 1)) * args.cout + co;
        args.out[o] = requant(
            __fadd_rn(scaled(acc[i][j][e], args.m[co]), args.bias[co]),
            -127.f);
      }
}

}  // namespace

// x: (N, H, W, cin) int8, contiguous; w: (2, 2, cout, cin) int8; m, b:
// (cout,) float32; out: (N, 2H, 2W, cout) int8.
extern "C" int vwfd_qconv_t(const void* x, const void* w, const float* m,
                            const float* bias, void* out, int N, int H, int W,
                            int cin, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)N * H * W * cout == 0) return (int)cudaGetLastError();
  if (cin < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.a.x = x;
  a.a.w = static_cast<const int8_t*>(w);
  a.a.scale = nullptr;
  a.a.kind = kI8;
  a.a.ld = cin;
  a.a.cin = cin;
  a.a.hin = H;
  a.a.win = W;
  a.a.va = unit_bytes(x, cin, cin, 1);
  a.a.vb = unit_bytes(w, cin, cin, 1);
  a.m = m;
  a.bias = bias;
  a.out = static_cast<int8_t*>(out);
  a.N = N;
  a.H = H;
  a.W = W;
  a.cout = cout;
  const dim3 grid(grid_pixels<1>(N, H, W), (4 * cout + kBN - 1) / kBN);
  qconv_t_kernel<<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
