// K13 `qcoupling_head`: the int8 embed's split coupling head and the RealNVP
// affine in one kernel.
//
// Replaces vwfd_tpu/nets/inn_int8.py::forward_int8's split 1x1 head on the
// quantized coupling half `xi` and the trunk output `h1i`, with one
// weight-scale vector shared by both halves (:257-260), and the coupling's
// `y = (e(s)*x + t).astype(dtype)` (:75-82, e of nets/inn.py::_e):
//   xi   = clip(rint(xin / s_x), -127, 127)   (K11's side output, or here)
//   head = (float(xi . W2x)*m2x + float(h1i . W2h)*m2h) + b2   (float32)
//   s, t = head[:, :C], head[:, C:]          (c-major order, as the tree's)
//   out  = round_dtype(e(s)*x + t),  e(s) = exp(2*sigmoid(s) - 1) + 1e-4
// x and out are channel slices of NHWC tensors (unit channel stride,
// uniform pixel strides), so the result lands in the coupling's output.
// Every float operation is one IEEE rounding in the plain version's order
// (kernels/qcoupling.py; the affine is K2's, common.cuh::rnvp_affine), so
// the kernel equals its plain version.
//
// Bound: at the flagship shapes (batch 16, 256^2) the level-48 coupling
// (M = 65536, K = 96 + 128, N = 192) and the level-192/768 ones (M = 16384,
// K = 384 + 128, N = 768) read an int8 `xi` (or a bf16 half) and an int8
// trunk output and read and write one bf16 half: bytes, like K2. Design:
// the persistent wgmma s8 core of qwgmma.cuh with two 1x1 operands and
// their own accumulators, 128-channel stages: `xi` and `h1i` (and the
// weight rows) by TMA, so that no division is left, or, without `xi`, the
// bf16 half quantized once per value and column slice by the producer's
// threads. A block's 128 weight rows are the s rows and then the t rows of
// 64 channels, so every thread holds the s and the t of the same channels
// (columns j and j + 64) and applies the affine from registers. The
// weight slice stays resident in the ring (a tile's stages divide it).
#include "qwgmma.cuh"

namespace {

using namespace vwfd::qwg;

constexpr int kBN = 128;  // weight rows a block: s and t of 64 channels

struct Args {
  const float* m2x;
  const float* m2h;
  const float* b2;
  const void* x;  // (M, C) slice, pixel stride ldx
  void* out;      // (M, C) slice, pixel stride ldo
  int ldx, ldo, C;
  int pairs;      // channel pairs as one access (even C and strides, aligned)
};

// The block's 64 channels' m2x, m2h, b2 of s and of t in shared memory,
// loaded once; x read as channel pairs where C and the strides are even,
// in bf16 when the tile starts, so that the loads run under the products
// (as K2 does), and otherwise a pixel's values all before any of its
// outputs is stored (x and out may alias for all the compiler knows).
template <typename T>
struct Epilogue {
  const Args& a;
  static constexpr int kCh = kBN / 2;  // channels a block
  static_assert(6 * kCh * 4 <= kParamBytes, "parameters fit");
  static constexpr bool kPre = sizeof(T) == 2;
  // bf16: the thread's x channel pairs of its two pixels, raw, loaded when
  // the tile starts (f32 loads them in the epilogue: registers)
  struct Pre {
    uint32_t w[kPre ? 2 : 1][kCh / 8];
  };

  __device__ __forceinline__ Pre prefetch(const Core& c, const Tile& tl,
                                          int wg) const {
    Pre pre = {};
    if constexpr (kPre) {
      const int q = threadIdx.x & 3;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        int y, x;
        const bool live = a.pairs && acc_pixel(c, tl, wg, hf, y, x);
        const long long pix = (long long)(tl.img * c.H + y) * c.W + x;
#pragma unroll
        for (int j = 0; j < kCh / 8; ++j) {
          const int ch = tl.nb * kCh + 8 * j + 2 * q;
          pre.w[hf][j] = live && ch < a.C
                             ? *reinterpret_cast<const uint32_t*>(
                                   static_cast<const T*>(a.x) + pix * a.ldx +
                                   ch)
                             : 0u;
        }
      }
    }
    return pre;
  }

  __device__ __forceinline__ void init(const Core&, int nb,
                                       float* sp) const {
    for (int i = threadIdx.x; i < kCh; i += 128 * kConsumers) {
      const int ch = nb * kCh + i;
      const bool in = ch < a.C;
      sp[i] = in ? a.m2x[ch] : 0.f;
      sp[kCh + i] = in ? a.m2h[ch] : 0.f;
      sp[2 * kCh + i] = in ? a.b2[ch] : 0.f;
      sp[3 * kCh + i] = in ? a.m2x[a.C + ch] : 0.f;
      sp[4 * kCh + i] = in ? a.m2h[a.C + ch] : 0.f;
      sp[5 * kCh + i] = in ? a.b2[a.C + ch] : 0.f;
    }
  }

  __device__ __forceinline__ void operator()(const Core& c, const Tile& tl,
                                             int wg, const int* ax,
                                             const int* ah, uint8_t*,
                                             const float* sp,
                                             const Pre& pre) const {
    const int q = threadIdx.x & 3;
    const T* xp = static_cast<const T*>(a.x);
    T* op = static_cast<T*>(a.out);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {  // the thread's two pixels in turn
      int y, x;
      if (!acc_pixel(c, tl, wg, hf, y, x)) continue;
      const long long pix = (long long)(tl.img * c.H + y) * c.W + x;
      float xv[kCh / 4];
#pragma unroll
      for (int j = 0; j < kCh / 8; ++j) {
        const int ch = tl.nb * kCh + 8 * j + 2 * q;
        float* v = &xv[2 * j];
        v[0] = v[1] = 0.f;
        if (ch >= a.C) continue;
        const T* src = xp + pix * a.ldx + ch;
        if (a.pairs) {
          if constexpr (kPre) {
            vwfd::Word<T>::unpack(pre.w[hf][j], v);
          } else {
            const float2 f = *reinterpret_cast<const float2*>(src);
            v[0] = f.x;
            v[1] = f.y;
          }
        } else {
          v[0] = vwfd::to_f32(src[0]);
          if (ch + 1 < a.C) v[1] = vwfd::to_f32(src[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kCh / 8; ++j) {  // s in column block j, t in j + 8
        const int ch0 = tl.nb * kCh + 8 * j + 2 * q;
        if (ch0 >= a.C) continue;
        float yv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * j + 2 * q + e;
          const int is = 4 * j + 2 * hf + e, it = is + 4 * (kCh / 8);
          const float s = __fadd_rn(
              __fadd_rn(scaled(ax[is], sp[i]), scaled(ah[is], sp[kCh + i])),
              sp[2 * kCh + i]);
          const float t = __fadd_rn(__fadd_rn(scaled(ax[it], sp[3 * kCh + i]),
                                              scaled(ah[it], sp[4 * kCh + i])),
                                    sp[5 * kCh + i]);
          yv[e] = vwfd::rnvp_affine(s, t, xv[2 * j + e], 0);
        }
        T* dst = op + pix * a.ldo + ch0;
        if (a.pairs) {
          if constexpr (sizeof(T) == 2)
            *reinterpret_cast<uint32_t*>(dst) = vwfd::Word<T>::pack(yv);
          else
            *reinterpret_cast<float2*>(dst) = make_float2(yv[0], yv[1]);
        } else {
          dst[0] = vwfd::from_f32<T>(yv[0]);
          if (ch0 + 1 < a.C) dst[1] = vwfd::from_f32<T>(yv[1]);
        }
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    qcoupling_wgmma(const Args a, const Core c,
                    const __grid_constant__ Maps m) {
  run<1, kBN, 128, true>(c, m, Epilogue<T>{a});
}

}  // namespace

// xin: (N, H, W, kx) float32/bf16 (dtype code), pixel stride ldxin, scaled
// by *s_x, or xi (non-null): its quantization, (N, H, W, kx) int8
// contiguous; h: (N, H, W, f) int8, contiguous; w2x: (2C, kx) and w2h: (2C,
// f) int8; m2x, m2h, b2: (2C,) float32; x, out: (N, H, W, C) of the dtype,
// pixel strides ldx, ldo. The plan (kernels/qcoupling.py::plan): stages
// (ring slots), groups (blocks per 64-channel slice), tma (bit 0: the first
// operand by TMA, 1: w2x, 2: h, 3: w2h), b_resident (the weight slice
// loaded in the ring's first round only).
extern "C" int vwfd_qcoupling_head(const void* xin, int ldxin, int kx,
                                   const float* s_x, const void* xi,
                                   const void* h, int f, const void* w2x,
                                   const void* w2h, const float* m2x,
                                   const float* m2h, const float* b2,
                                   const void* x, int ldx, void* out, int ldo,
                                   int N, int H, int W, int C, int dtype,
                                   int stages, int groups, int tma,
                                   int b_resident, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)N * H * W * C == 0) return (int)cudaGetLastError();
  if (kx < 1 || f < 1) return (int)cudaErrorInvalidValue;
  const bool bf = dtype == vwfd::kBF16;
  const int esize = bf ? 2 : 4;
  const int pairs = C % 2 == 0 && ldx % 2 == 0 && ldo % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % (2 * esize) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % (2 * esize) == 0;
  Args a = {m2x, m2h, b2, x, out, ldx, ldo, C, pairs};
  Core c = {};
  if (xi)
    c.op[0] = make_operand(xi, vwfd::qwg::kI8, kx, H, W, w2x, kx, 2 * C,
                           nullptr, 128, tma);
  else
    c.op[0] = make_operand(xin,
                           bf ? vwfd::qwg::kQuantBF16 : vwfd::qwg::kQuantF32,
                           ldxin, H, W, w2x, kx, 2 * C, s_x, 128, tma);
  c.op[1] = make_operand(h, vwfd::qwg::kI8, f, H, W, w2h, f, 2 * C, nullptr,
                         128, tma >> 2);
  c.st_c = C;
  c.stages = stages;
  c.b_resident = b_resident;
  if (b_resident && stages % (c.op[0].stages + c.op[1].stages))
    return (int)cudaErrorInvalidValue;
  const int grid = geometry<kBN>(c, N, H, W, C, groups);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  const cudaError_t rc =
      bf ? launch<1, kBN, 128>(qcoupling_wgmma<__nv_bfloat16>, a, c, grid, 0,
                               s)
         : launch<1, kBN, 128>(qcoupling_wgmma<float>, a, c, grid, 0, s);
  return (int)rc;
}
