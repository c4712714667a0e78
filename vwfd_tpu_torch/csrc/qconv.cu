// K11 `qconv`: an int8 3x3 SAME or 1x1 convolution, exact int32 sums on the
// tensor cores, with its requant epilogue and its input prologue fused.
//
// Replaces the int8 convolutions of the JAX package's PTQ serving path:
// vwfd_tpu/nets/unet_int8.py::apply_int8's `qconv` + `requant` and the int8
// 2x2 max-pool (:235-254), the split decoder conv (:261-265) and the head
// (:268-270); vwfd_tpu/nets/inn_int8.py::forward_int8's trunk convs with
// their ELU requant (:241-256). Per output (pixel, channel n):
//   relu   : clip(rint(acc*m[n] + b[n]), 0, 127)               -> int8
//   signed : clip(rint(acc*m[n] + b[n]), -127, 127)            -> int8
//   dual   : clip(rint((acc*m[n] + acc2*m2[n]) + b[n]), 0, 127) -> int8,
//            acc2 the product of a second int8 source (split decoder)
//   elu    : clip(rint(elu(acc*m[n] + b[n]) / s_out), -127, 127) -> int8
//   f32    : acc*m[n] + b[n]                                    -> float32
// with float(acc) rounded to nearest even, every multiply, add and division
// one IEEE rounding in that order (__fmul_rn, __fadd_rn, __fdiv_rn: no FMA
// contraction), rintf half to even and expm1f for the ELU, so that the
// kernel equals its plain version (kernels/qconv.py) bit for bit. Prologues
// (qmma.cuh): the 2x2 max-pool of the input (encoder levels 2-5), or the
// quantization of a float32 / bf16 input, clip(rint(x / s_x), -127, 127)
// (the INN trunk's first conv: the coupling half is quantized on load).
//
// Bound: operations at the flagship shapes (64 frames of 128^2: 7.9 G
// multiply-adds a frame in the detect's twelve launches, the int8 tensor
// cores' 1,979 TOP/s), bytes for enc1's first conv (K = 108) and the head.
// Design: the implicit-GEMM core of qmma.cuh, a block of 128 pixels (8 x 16
// for 3x3) x 64 output channels, mma.sync m16n8k32 s8 from shared-memory
// stages of 32 input channels.
#include "qmma.cuh"

namespace {

using namespace vwfd::qmma;

enum Epi : int { kRelu = 0, kSigned = 1, kElu = 2, kF32 = 3 };

struct Args {
  Src a, b;  // b: the second source of the dual epilogue
  const float* m;
  const float* m2;
  const float* bias;
  const float* out_scale;  // kElu: the device scalar s_out
  void* out;               // (N, H, W, cout) int8, or float32 for kF32
  int N, H, W, cout, epi;
};

template <int KS, bool kDual>
__global__ void __launch_bounds__(kThreads) qconv_kernel(const Args args) {
  __shared__ __align__(16) uint8_t sa[Shape<KS>::kABytes];
  __shared__ __align__(16) uint8_t sb[Shape<KS>::kBBytes];
  const Geo g = block_geo<KS>(args.N, args.H, args.W);
  const int n0 = blockIdx.y * kBN;
  Acc acc, acc2;
  accumulate<KS>(sa, sb, args.a, g, n0, args.cout, 0, acc);
  if (kDual) accumulate<KS>(sa, sb, args.b, g, n0, args.cout, 0, acc2);

  const float lo = args.epi == kRelu ? 0.f : -127.f;
  const float s_out = args.epi == kElu ? *args.out_scale : 1.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + acc_col(j, e);
        int img, y, x;
        if (n >= args.cout || !out_pixel<KS>(g, acc_row(i, e), img, y, x))
          continue;
        const long long o = flat(g, img, y, x) * args.cout + n;
        float v = scaled(acc[i][j][e], args.m[n]);
        if (kDual) v = __fadd_rn(v, scaled(acc2[i][j][e], args.m2[n]));
        v = __fadd_rn(v, args.bias[n]);
        if (args.epi == kF32) {
          static_cast<float*>(args.out)[o] = v;
          continue;
        }
        if (args.epi == kElu)
          v = __fdiv_rn(v > 0.f ? v : expm1f(v), s_out);
        static_cast<int8_t*>(args.out)[o] = requant(v, lo);
      }
}

Src make_src(const void* x, int kind, int ld, int hin, int win,
             const void* w, int cin, const float* scale) {
  Src s;
  s.x = x;
  s.w = static_cast<const int8_t*>(w);
  s.scale = scale;
  s.kind = kind;
  s.ld = ld;
  s.cin = cin;
  s.hin = hin;
  s.win = win;
  const int elem = kind == kQuantF32 ? 4 : kind == kQuantBF16 ? 2 : 1;
  s.va = unit_bytes(x, cin, ld, elem);
  s.vb = unit_bytes(w, cin, cin, 1);
  return s;
}

template <int KS>
cudaError_t run(const Args& a, bool dual, cudaStream_t s) {
  const dim3 grid(grid_pixels<KS>(a.N, a.H, a.W), (a.cout + kBN - 1) / kBN);
  if (dual)
    qconv_kernel<KS, true><<<grid, kThreads, 0, s>>>(a);
  else
    qconv_kernel<KS, false><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: the source (kind: 0 int8, 1 int8 pooled 2x2 from (N, hin, win), 2/3
// float32/bf16 quantized by *x_scale), pixel stride ldx; w: (cout, ks, ks,
// cin) int8. x2, w2 (nullable): the dual epilogue's second int8 source (N,
// H, W) with pixel stride ld2 and (cout, ks, ks, cin2) weights. out: (N, H,
// W, cout) int8, or float32 for epi 3.
extern "C" int vwfd_qconv(const void* x, int kind, int ldx, int hin, int win,
                          const void* w, int cin, const float* x_scale,
                          const void* x2, int ld2, const void* w2, int cin2,
                          const float* m, const float* m2, const float* bias,
                          const float* out_scale, void* out, int N, int H,
                          int W, int cout, int ks, int epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)N * H * W * cout == 0) return (int)cudaGetLastError();
  if ((ks != 1 && ks != 3) || epi < kRelu || epi > kF32 || kind < kI8 ||
      kind > kQuantBF16 || cin < 1 || (x2 && (cin2 < 1 || epi != kRelu)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.a = make_src(x, kind, ldx, hin, win, w, cin, x_scale);
  if (x2) a.b = make_src(x2, kI8, ld2, H, W, w2, cin2, nullptr);
  a.m = m;
  a.m2 = m2;
  a.bias = bias;
  a.out_scale = out_scale;
  a.out = out;
  a.N = N;
  a.H = H;
  a.W = W;
  a.cout = cout;
  a.epi = epi;
  return (int)(ks == 3 ? run<3>(a, x2 != nullptr, s)
                       : run<1>(a, x2 != nullptr, s));
}
