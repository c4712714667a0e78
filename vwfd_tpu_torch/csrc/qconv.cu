// K11 `qconv`: an int8 3x3 SAME or 1x1 convolution, exact int32 sums on the
// tensor cores, with its requant epilogue and its input prologue fused.
//
// Replaces the int8 convolutions of the JAX package's PTQ serving path:
// vwfd_tpu/nets/unet_int8.py::apply_int8's `qconv` + `requant` and the int8
// 2x2 max-pool (:235-254), the split decoder conv (:261-265) and the head
// (:268-270); vwfd_tpu/nets/inn_int8.py::forward_int8's trunk convs with
// their ELU requant (:241-256) and the trunk's `xi` (:248-250). Per output
// (pixel, channel n):
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
// (qwgmma.cuh): the 2x2 max-pool of the input (encoder levels 2-5), or the
// quantization of a float32 / bf16 input, clip(rint(x / s_x), -127, 127)
// (the INN trunk's first conv), whose interior pixels optionally go to the
// side output `xi` for K13.
//
// Bound: operations at the flagship shapes (64 frames of 128^2: 7.9 G
// multiply-adds a frame in the detect's twelve launches, the int8 tensor
// cores' 1,979 TOP/s), bytes for enc1's first conv (K = 108) and the head.
// Design: the persistent wgmma s8 core of qwgmma.cuh, 16 x 8-pixel tiles x
// BN (64 or 128) output columns, fed by TMA (or the producer's cp.async
// and prologue threads) through a ring of 32-channel (3x3) or 128-channel
// (1x1) stages; the host plan (kernels/qconv.py::plan) picks the loaders,
// BN, the stage count and the grid. Int8 outputs are staged in shared
// memory and stored as 16-byte rows.
#include "qwgmma.cuh"

namespace {

using namespace vwfd::qwg;

enum Epi : int { kRelu = 0, kSigned = 1, kElu = 2, kF32 = 3 };

struct Args {
  const float* m;
  const float* m2;
  const float* bias;
  const float* out_scale;  // kElu: the device scalar s_out
  void* out;               // (N, H, W, cout) int8, or float32 for kF32
  int cout, epi;
};

// Per output column of the block: m, b (and m2) in shared memory, loaded
// once; a tile's bytes are all computed before any is stored (no store
// between the loads), then staged and stored as 16-byte rows.
template <int BN, bool kDual>
struct Epilogue {
  const Args& a;
  // Staging: each consumer's 64 pixels x BN bytes, rows kPitch apart.
  static constexpr int kPitch = BN + 16;
  static constexpr int kBytes = kConsumers * 64 * kPitch;
  static_assert(3 * BN * 4 <= kParamBytes, "parameters fit");
  struct Pre {};  // nothing to load ahead

  __device__ __forceinline__ Pre prefetch(const Core&, const Tile&,
                                          int) const {
    return {};
  }

  __device__ __forceinline__ void init(const Core&, int nb,
                                       float* sp) const {
    for (int i = threadIdx.x; i < BN; i += 128 * kConsumers) {
      const int n = nb * BN + i;
      const bool in = n < a.cout;
      sp[i] = in ? a.m[n] : 0.f;
      sp[BN + i] = in ? a.bias[n] : 0.f;
      sp[2 * BN + i] = in && kDual ? a.m2[n] : 0.f;
    }
  }

  __device__ __forceinline__ void operator()(const Core& c, const Tile& tl,
                                             int wg, const int* acc,
                                             const int* acc2,
                                             uint8_t* staging,
                                             const float* sp,
                                             const Pre&) const {
    const int t = threadIdx.x & 127, q = t & 3;
    const int n0 = tl.nb * BN;
    if (a.epi == kF32) {
      float* out = static_cast<float*>(a.out);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        int y, x;
        if (!acc_pixel(c, tl, wg, hf, y, x)) continue;
        const long long o = ((long long)(tl.img * c.H + y) * c.W + x) * a.cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * j + 2 * q + e;
            if (n0 + i >= a.cout) continue;
            float v = scaled(acc[4 * j + 2 * hf + e], sp[i]);
            if (kDual)
              v = __fadd_rn(v,
                            scaled(acc2[4 * j + 2 * hf + e], sp[2 * BN + i]));
            out[o + n0 + i] = __fadd_rn(v, sp[BN + i]);
          }
      }
      return;
    }
    const float lo = a.epi == kRelu ? 0.f : -127.f;
    const float s_out = a.epi == kElu ? *a.out_scale : 1.f;
    uint32_t bytes[BN / 8][2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        bytes[j][hf] = 0u;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * j + 2 * q + e;
          float v = scaled(acc[4 * j + 2 * hf + e], sp[i]);
          if (kDual)
            v = __fadd_rn(v, scaled(acc2[4 * j + 2 * hf + e], sp[2 * BN + i]));
          v = __fadd_rn(v, sp[BN + i]);
          if (a.epi == kElu) v = __fdiv_rn(v > 0.f ? v : expm1f(v), s_out);
          bytes[j][hf] |= (uint32_t)(uint8_t)requant(v, lo) << (8 * e);
        }
      }
    uint8_t* stg = staging + wg * 64 * kPitch;
    const int r0 = 16 * (t >> 5) + ((t & 31) >> 2);
    wg_sync(wg);  // the previous tile's rows are stored
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<uint16_t*>(stg + (r0 + 8 * hf) * kPitch + 8 * j +
                                     2 * q) = (uint16_t)bytes[j][hf];
    wg_sync(wg);
    int8_t* out = static_cast<int8_t*>(a.out);
    const bool vec = a.cout % 16 == 0;
    for (int u = t; u < 64 * (BN / 16); u += 128) {
      const int r = u / (BN / 16), k = u - r * (BN / 16), n = n0 + 16 * k;
      const int y = tl.y0 + wg * 8 + r / 8, x = tl.x0 + r % 8;
      if (y >= c.H || x >= c.W || n >= a.cout) continue;
      int8_t* dst = out + ((long long)(tl.img * c.H + y) * c.W + x) * a.cout +
                    n;
      const uint8_t* src = stg + r * kPitch + 16 * k;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int i = 0; i < 16 && n + i < a.cout; ++i) dst[i] = src[i];
      }
    }
  }
};

template <int KS, int BN, bool kDual>
__global__ void __launch_bounds__(kThreads, 1)
    qconv_wgmma(const Args a, const Core c, const __grid_constant__ Maps m) {
  run<KS, BN, KS == 3 ? 32 : 128, kDual>(c, m, Epilogue<BN, kDual>{a});
}

template <int KS, int BN, bool kDual>
cudaError_t start(const Args& a, Core& c, int grid, cudaStream_t s) {
  constexpr int kKC = KS == 3 ? 32 : 128;
  const int staging = a.epi == kF32 ? 0 : Epilogue<BN, kDual>::kBytes;
  return launch<KS, BN, kKC>(qconv_wgmma<KS, BN, kDual>, a, c, grid, staging,
                             s);
}

}  // namespace

// x: the source (kind: 0 int8, 1 int8 pooled 2x2 from (N, hin, win), 2/3
// float32/bf16 quantized by *x_scale), pixel stride ldx; w: (cout, ks, ks,
// cin) int8. x2, w2 (nullable): the dual epilogue's second int8 source (N,
// H, W) with pixel stride ld2 and (cout, ks, ks, cin2) weights. out: (N, H,
// W, cout) int8, or float32 for epi 3. xi (nullable, kinds 2/3): the
// quantized input, (N, H, W, cin) int8. The plan (kernels/qconv.py::plan):
// bn (64 or 128), stages (ring slots), groups (blocks per column block),
// tma (bit 0: x by TMA, 1: w, 2: x2, 3: w2; else the producer's threads),
// b_resident (the weights loaded in the ring's first round only: a tile's
// stage count divides `stages`).
extern "C" int vwfd_qconv(const void* x, int kind, int ldx, int hin, int win,
                          const void* w, int cin, const float* x_scale,
                          const void* x2, int ld2, const void* w2, int cin2,
                          const float* m, const float* m2, const float* bias,
                          const float* out_scale, void* out, int N, int H,
                          int W, int cout, int ks, int epi, void* xi, int bn,
                          int stages, int groups, int tma, int b_resident,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)N * H * W * cout == 0) return (int)cudaGetLastError();
  const bool dual = x2 != nullptr;
  if ((ks != 1 && ks != 3) || epi < kRelu || epi > kF32 ||
      kind < vwfd::qwg::kI8 || kind > vwfd::qwg::kQuantBF16 || cin < 1 ||
      (dual && (cin2 < 1 || epi != kRelu || ks != 3)) ||
      (xi && kind < vwfd::qwg::kQuantF32) || (bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  Args a = {m, m2, bias, out_scale, out, cout, epi};
  Core c = {};
  const int kc = ks == 3 ? 32 : 128;
  c.op[0] = make_operand(x, kind, ldx, hin, win, w, cin, cout, x_scale, kc,
                         tma);
  c.op[0].xi = static_cast<int8_t*>(xi);
  if (dual)
    c.op[1] = make_operand(x2, vwfd::qwg::kI8, ld2, H, W, w2, cin2, cout,
                           nullptr, kc, tma >> 2);
  c.st_c = 0;
  c.stages = stages;
  c.b_resident = b_resident;
  if (b_resident && stages % (c.op[0].stages + c.op[1].stages))
    return (int)cudaErrorInvalidValue;
  const int grid = bn == 64 ? geometry<64>(c, N, H, W, cout, groups)
                            : geometry<128>(c, N, H, W, cout, groups);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  cudaError_t rc;
  if (ks == 1)
    rc = bn == 64 ? start<1, 64, false>(a, c, grid, s)
                  : start<1, 128, false>(a, c, grid, s);
  else if (dual)
    rc = bn == 64 ? start<3, 64, true>(a, c, grid, s)
                  : start<3, 128, true>(a, c, grid, s);
  else
    rc = bn == 64 ? start<3, 64, false>(a, c, grid, s)
                  : start<3, 128, false>(a, c, grid, s);
  return (int)rc;
}
