// K13 `qcoupling_head`: the int8 embed's split coupling head and the RealNVP
// affine in one kernel.
//
// Replaces vwfd_tpu/nets/inn_int8.py::forward_int8's split 1x1 head on the
// quantized coupling half `xi` and the trunk output `h1i`, with one
// weight-scale vector shared by both halves (:257-260), and the coupling's
// `y = (e(s)*x + t).astype(dtype)` (:75-82, e of nets/inn.py::_e):
//   xi   = clip(rint(xin / s_x), -127, 127)          (quantized on load)
//   head = (float(xi . W2x)*m2x + float(h1i . W2h)*m2h) + b2   (float32)
//   s, t = head[:, :C], head[:, C:]          (c-major order, as the tree's)
//   out  = round_dtype(e(s)*x + t),  e(s) = exp(2*sigmoid(s) - 1) + 1e-4
// xin, x and out are channel slices of NHWC tensors (unit channel stride,
// uniform pixel strides), so the result lands in the coupling's output and
// `xi` is never written. Every float operation is one IEEE rounding in the
// plain version's order (kernels/qcoupling.py; the affine is K2's,
// common.cuh::rnvp_affine), so the kernel equals its plain version.
//
// Bound: at the flagship shapes (batch 16, 256^2) the level-48 coupling
// (M = 65536, K = 96 + 128, N = 192) and the level-192/768 ones (M = 16384,
// K = 384 + 128, N = 768) read their bf16 half and int8 trunk output and
// write one bf16 half: bytes, like K2. Design: the 1x1 implicit-GEMM core of
// qmma.cuh with two sources; the block's 64 weight rows are the s rows and
// the t rows of 32 channels, arranged so that each thread holds the s and
// the t of the same channels and applies the affine from registers.
#include "qmma.cuh"

namespace {

using namespace vwfd::qmma;

struct Args {
  Src xin, h;
  const float* m2x;
  const float* m2h;
  const float* b2;
  const void* x;  // (M, C) slice, pixel stride ldx
  void* out;      // (M, C) slice, pixel stride ldo
  int ldx, ldo;
  int N, H, W, C;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) qcoupling_kernel(const Args a) {
  __shared__ __align__(16) uint8_t sa[Shape<1>::kABytes];
  __shared__ __align__(16) uint8_t sb[Shape<1>::kBBytes];
  const Geo g = block_geo<1>(a.N, a.H, a.W);
  const int n0 = blockIdx.y * (kBN / 2);  // coupling channels of the block
  Acc ax, ah;
  accumulate<1>(sa, sb, a.xin, g, n0, 2 * a.C, a.C, ax);
  accumulate<1>(sa, sb, a.h, g, n0, 2 * a.C, a.C, ah);
  const int wn = (threadIdx.x >> 5) / kWarpsM, t4 = threadIdx.x & 3;
  const T* xp = static_cast<const T*>(a.x);
  T* op = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)  // s in column tile j, t in j + 2
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = n0 + wn * 16 + j * 8 + 2 * t4 + (e & 1);
        const long long m = g.m0 + acc_row(i, e);
        if (ch >= a.C || m >= g.M) continue;
        const float s = __fadd_rn(__fadd_rn(scaled(ax[i][j][e], a.m2x[ch]),
                                            scaled(ah[i][j][e], a.m2h[ch])),
                                  a.b2[ch]);
        const int ct = a.C + ch;
        const float t =
            __fadd_rn(__fadd_rn(scaled(ax[i][j + 2][e], a.m2x[ct]),
                                scaled(ah[i][j + 2][e], a.m2h[ct])),
                      a.b2[ct]);
        const float xv = vwfd::to_f32(xp[m * a.ldx + ch]);
        op[m * a.ldo + ch] = vwfd::from_f32<T>(vwfd::rnvp_affine(s, t, xv, 0));
      }
}

}  // namespace

// xin: (N, H, W, kx) float32/bf16 (dtype code), pixel stride ldxin, scaled
// by *s_x; h: (N, H, W, f) int8, contiguous; w2x: (2C, kx) and w2h: (2C, f)
// int8; m2x, m2h, b2: (2C,) float32; x, out: (N, H, W, C) of the dtype,
// pixel strides ldx, ldo.
extern "C" int vwfd_qcoupling_head(const void* xin, int ldxin, int kx,
                                   const float* s_x, const void* h, int f,
                                   const void* w2x, const void* w2h,
                                   const float* m2x, const float* m2h,
                                   const float* b2, const void* x, int ldx,
                                   void* out, int ldo, int N, int H, int W,
                                   int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)N * H * W * C == 0) return (int)cudaGetLastError();
  if (kx < 1 || f < 1) return (int)cudaErrorInvalidValue;
  const bool bf = dtype == vwfd::kBF16;
  Args a;
  a.xin.x = xin;
  a.xin.w = static_cast<const int8_t*>(w2x);
  a.xin.scale = s_x;
  a.xin.kind = bf ? kQuantBF16 : kQuantF32;
  a.xin.ld = ldxin;
  a.xin.cin = kx;
  a.xin.hin = H;
  a.xin.win = W;
  a.xin.va = unit_bytes(xin, kx, ldxin, bf ? 2 : 4);
  a.xin.vb = unit_bytes(w2x, kx, kx, 1);
  a.h.x = h;
  a.h.w = static_cast<const int8_t*>(w2h);
  a.h.scale = nullptr;
  a.h.kind = kI8;
  a.h.ld = f;
  a.h.cin = f;
  a.h.hin = H;
  a.h.win = W;
  a.h.va = unit_bytes(h, f, f, 1);
  a.h.vb = unit_bytes(w2h, f, f, 1);
  a.m2x = m2x;
  a.m2h = m2h;
  a.b2 = b2;
  a.x = x;
  a.out = out;
  a.ldx = ldx;
  a.ldo = ldo;
  a.N = N;
  a.H = H;
  a.W = W;
  a.C = C;
  const dim3 grid(grid_pixels<1>(N, H, W), (C + kBN / 2 - 1) / (kBN / 2));
  if (bf)
    qcoupling_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  else
    qcoupling_kernel<float><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
