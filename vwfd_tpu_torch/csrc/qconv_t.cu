// K12 `qconv_t`: the UNet decoder's int8 2x2 / stride-2 transposed
// convolution with its signed requant, stored depth-to-space.
//
// Replaces vwfd_tpu/nets/unet_int8.py::apply_int8's
// `lax.conv_transpose(zi, up_w, (2, 2), "SAME", preferred_element_type=
// int32)` and `requant(u, up_m, up_b, -127)` (:257-260). A 2x2 kernel at
// stride 2 touches each output pixel once, so the op is one GEMM:
//   acc[(n, i, j), (p, q, co)] = sum_ci x[n, i, j, ci] * w[p, q, co, ci]
//   out[n, 2i + p, 2j + q, co] = clip(rint(acc*m[co] + b[co]), -127, 127)
// w is the port's layout, (2, 2, cout, cin) int8, already flipped from
// flax's HWIO kernel (out[2i+p] reads flax's tap 1-p; convert.py
// ::unet_int8_from_jax, once): read as a matrix it is the core's B, 4*cout
// rows of cin bytes, K-major. Epilogue arithmetic as K11's: float(acc)
// nearest even, __fmul_rn then __fadd_rn, rint half to even, clip; equal
// to the plain version (kernels/qconv_t.py) bit for bit. The two int/float
// conversions, which run at a quarter of the full rate, are adds of
// 1.5 * 2^23 here (exact where |acc| < 2^22, cin <= 256: up2 and up1).
//
// Bound (the flagship's four launches, 64 frames, 0.134 G multiply-adds a
// frame each): operations at up4 and up3 (1,979 TOP/s int8), bytes at up2
// and up1, whose int8 outputs (34 and 67 MB) dominate; 0.062 ms summed.
// Design: the persistent wgmma s8 core of qwgmma.cuh on its 1x1 path (TMA
// rings of 128-channel stages in the 128-byte swizzle, the weights resident
// where a tile's stages divide the ring), the batch stacked as one tall
// image (1, N*H, W): a 1x1 product has no halo, so a 16 x 8 tile may span
// images and up4's 8 x 8 maps fill whole tiles. The 4*cout columns are the
// core's output columns; the consumers take turns at the products (run's
// kOrdered), so that one's epilogue runs under the other's products. The
// epilogue, most of the time at up2 and up1 (PERF.md), stages a consumer's 64
// pixels in shared memory: stacked row r, column j and GEMM column n =
// (p, q, co) land at out_index = ((2r + p)*W + j)*2*cout + n - p*2*cout
// (kernels/qconv_t.py::out_index), contiguous in n inside one sub-pixel
// row p. With cout % 64 == 0 (every flagship launch) a column block of
// 128 lies in one p, and the staged box leaves by one TMA store; else
// 16-byte runs (cout % 8 == 0) or bytes.
#include "qwgmma.cuh"

namespace {

using namespace vwfd::qwg;

struct Args {
  CUtensorMap out_map;  // tma_out: the output as (2*cout, W, 2, N*H) bytes
  const float* m;
  const float* bias;
  int8_t* out;  // (N, 2H, 2W, cout)
  int cout;
  int small;    // |acc| < 2^22 for every input (cin <= 256): magic_float
  int tma_out;  // the staged tile leaves by one TMA store (cout % 64 == 0)
};

// The staged box (128 bytes x 8 columns x 1 sub-pixel row x 8 stacked rows,
// in the 128-byte swizzle) to the output at (c0, x0, p, y0), one committed
// bulk group; out-of-bounds rows and columns are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const uint8_t* src, int c0,
                                             int x0, int p, int y0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(vwfd::smem_u32(src)), "r"(c0), "r"(x0), "r"(p), "r"(y0)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// float(acc) for |acc| < 2^22, exact: the bits of 1.5 * 2^23 + acc read as
// a float, less 1.5 * 2^23 (an integer and a float add at full rate, where
// the I2F conversion runs at a quarter of it).
__device__ __forceinline__ float magic_float(int acc) {
  return __fsub_rn(__int_as_float(0x4B400000 + acc), 12582912.f);
}

// clip(rint(v), -127, 127) in the low byte, bit-equal to requant(v, -127):
// clamping first is the same (both bounds are integers, rint monotonic),
// adding 1.5 * 2^23 rounds to an integer half to even as rintf does, and
// the sum's low byte is that integer's two's-complement byte (no F2I).
__device__ __forceinline__ uint32_t requant_low_byte(float v) {
  const float c = fminf(fmaxf(v, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f));
}

// The flat output element of stacked row r, column j and GEMM column n.
__device__ __forceinline__ long long out_index(int r, int j, int n, int W,
                                               int cout) {
  const int p = n / (2 * cout);
  return ((long long)(2 * r + p) * W + j) * (2 * cout) + n - p * (2 * cout);
}

// Per GEMM column of the block: m and b of its output channel in shared
// memory, loaded once; a tile's bytes are all computed before any is
// stored, then staged and stored: with tma_out, each consumer's 64 pixels
// as one TMA store of 128-byte swizzled rows (its column block lies in one
// sub-pixel row p, 128 contiguous bytes a pixel); else as 16-byte runs
// from rows kPitch apart.
template <int BN>
struct Epilogue {
  const Args& a;
  // Staging: each consumer's 64 pixels x BN bytes, rows kPitch apart (a
  // consumer's region starts on a 1024-byte boundary, as the swizzle needs)
  static constexpr int kPitch = BN + 16;
  static constexpr int kBytes = kConsumers * 64 * kPitch;
  static_assert(2 * BN * 4 <= kParamBytes, "parameters fit");
  static_assert(BN != 128 || 64 * kPitch % 1024 == 0, "swizzle atoms");
  struct Pre {};  // nothing to load ahead

  __device__ __forceinline__ Pre prefetch(const Core&, const Tile&,
                                          int) const {
    return {};
  }

  __device__ __forceinline__ void init(const Core&, int nb,
                                       float* sp) const {
    for (int i = threadIdx.x; i < BN; i += 128 * kConsumers) {
      const int n = nb * BN + i;
      const bool in = n < 4 * a.cout;
      sp[i] = in ? a.m[n % a.cout] : 0.f;
      sp[BN + i] = in ? a.bias[n % a.cout] : 0.f;
    }
  }

  // The thread's bytes of the tile, (float(acc)*m + b) requantized, two
  // columns in the low half-word: bytes[j][hf] holds row hf, columns
  // 8j + 2q (+ 1).
  template <bool kSmall>
  __device__ __forceinline__ void requant_all(const int* acc,
                                              const float* sp, int q,
                                              uint32_t (&bytes)[BN / 8][2])
      const {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * j + 2 * q + e, v = acc[4 * j + 2 * hf + e];
          const float f = kSmall ? magic_float(v) : __int2float_rn(v);
          w[e] = requant_low_byte(__fadd_rn(__fmul_rn(f, sp[i]), sp[BN + i]));
        }
        bytes[j][hf] = __byte_perm(w[0], w[1], 0x0040);  // low bytes
      }
  }

  __device__ __forceinline__ void operator()(const Core& c, const Tile& tl,
                                             int wg, const int* acc,
                                             const int*, uint8_t* staging,
                                             const float* sp,
                                             const Pre&) const {
    const int t = threadIdx.x & 127, q = t & 3;
    const int n0 = tl.nb * BN, cols = 4 * a.cout;
    uint32_t bytes[BN / 8][2];
    if (a.small)
      requant_all<true>(acc, sp, q, bytes);
    else
      requant_all<false>(acc, sp, q, bytes);
    uint8_t* stg = staging + wg * 64 * kPitch;
    const int r0 = 16 * (t >> 5) + ((t & 31) >> 2);
    if (a.tma_out) {
      if (t == 0) vwfd::bulk_wait_read();  // the last store has read stg
      wg_sync(wg);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint16_t*>(
              stg + Ring<1, BN, 128>::sw(r0 + 8 * hf, 8 * j + 2 * q)) =
              (uint16_t)bytes[j][hf];
      vwfd::fence_to_bulk();
      wg_sync(wg);
      if (t == 0) {
        const int p = n0 / (2 * a.cout);
        tma_store_4d(&a.out_map, stg, n0 - p * 2 * a.cout, tl.x0, p,
                     tl.y0 + wg * 8);
        // the block's last tile: the store completes before the block exits
        const int pt = tl.y0 / kTH * c.tiles_x + tl.x0 / kTW;
        if (pt + c.groups >= c.pixel_tiles)
          asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
      }
      return;
    }
    wg_sync(wg);  // the previous tile's rows are stored
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<uint16_t*>(stg + (r0 + 8 * hf) * kPitch + 8 * j +
                                     2 * q) = (uint16_t)bytes[j][hf];
    wg_sync(wg);
    // 16 columns a thread, the same for all its rows (128 % (BN / 16) ==
    // 0); with cout % 8 == 0 they lie in one sub-pixel row p
    constexpr int kChunks = BN / 16, kRows = 128 / kChunks;
    const int k = t % kChunks, n = n0 + 16 * k;
    if (n >= cols) return;
    const int p = n / (2 * a.cout), off = n - p * 2 * a.cout;
    const bool vec = a.cout % 8 == 0;
    for (int r = t / kChunks; r < 64; r += kRows) {
      const int y = tl.y0 + wg * 8 + r / 8, x = tl.x0 + r % 8;
      if (y >= c.H || x >= c.W) continue;
      const uint8_t* src = stg + r * kPitch + 16 * k;
      if (vec) {
        *reinterpret_cast<uint4*>(
            a.out + ((long long)(2 * y + p) * c.W + x) * (2 * a.cout) + off) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int i = 0; i < 16 && n + i < cols; ++i)
          a.out[out_index(y, x, n + i, c.W, a.cout)] = (int8_t)src[i];
      }
    }
  }
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    qconv_t_wgmma(const __grid_constant__ Args a, const Core c,
                  const __grid_constant__ Maps m) {
  run<1, BN, 128, false, true>(c, m, Epilogue<BN>{a});
}

template <int BN>
cudaError_t start(const Args& a, Core& c, int grid, cudaStream_t s) {
  return launch<1, BN, 128>(qconv_t_wgmma<BN>, a, c, grid,
                            Epilogue<BN>::kBytes, s);
}

}  // namespace

// x: (N, H, W, cin) int8, contiguous; w: (2, 2, cout, cin) int8; m, b:
// (cout,) float32; out: (N, 2H, 2W, cout) int8. The plan
// (kernels/qconv_t.py::plan, kernels/qconv.py::plan of the stacked 1x1
// GEMM): bn (64 or 128), stages (ring slots), groups (blocks per column
// block), tma (bit 0: x by TMA, 1: w; else the producer's threads),
// b_resident (the weights loaded in the ring's first round only), tma_out
// (the output by TMA stores: kernels/qconv_t.py::store_route).
extern "C" int vwfd_qconv_t(const void* x, const void* w, const float* m,
                            const float* bias, void* out, int N, int H, int W,
                            int cin, int cout, int bn, int stages, int groups,
                            int tma, int b_resident, int tma_out,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)N * H * W * cout == 0) return (int)cudaGetLastError();
  if (cin < 1 || (bn != 64 && bn != 128)) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.m = m;
  a.bias = bias;
  a.out = static_cast<int8_t*>(out);
  a.cout = cout;
  a.small = 128LL * 128 * cin < (1 << 22);
  // a column block of BN = 128 within one sub-pixel row, 16-byte strides
  if (tma_out && (bn != 128 || cout % 64 ||
                  reinterpret_cast<uintptr_t>(out) % 16))
    return (int)cudaErrorInvalidValue;
  a.tma_out = tma_out;
  if (a.tma_out) {
    const cuuint64_t dims[4] = {(cuuint64_t)2 * cout, (cuuint64_t)W, 2,
                                (cuuint64_t)N * H};
    const cuuint64_t strides[3] = {(cuuint64_t)2 * cout,
                                   (cuuint64_t)2 * cout * W,
                                   (cuuint64_t)4 * cout * W};
    const cuuint32_t box[4] = {128, kTW, 1, 8};
    const cudaError_t rc = encode_i8(&a.out_map, out, 4, dims, strides, box,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc != cudaSuccess) return (int)rc;
  }
  Core c = {};
  // the batch stacked as one image of N*H rows
  c.op[0] = make_operand(x, vwfd::qwg::kI8, cin, N * H, W, w, cin,
                         4 * cout, nullptr, 128, tma);
  c.st_c = 0;
  c.stages = stages;
  c.b_resident = b_resident;
  if (b_resident && stages % c.op[0].stages)
    return (int)cudaErrorInvalidValue;
  const int grid = bn == 64 ? geometry<64>(c, 1, N * H, W, 4 * cout, groups)
                            : geometry<128>(c, 1, N * H, W, 4 * cout, groups);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  return (int)(bn == 64 ? start<64>(a, c, grid, s)
                        : start<128>(a, c, grid, s));
}
