// K16 `zigzag_jpeg`: HiDDeN's JPEG-mask compression with its clip, forward
// and backward with respect to the image, in one pass over 8×8 blocks.
//
// Replaces vwfd_tpu/attacks/jpeg.py::hidden_jpeg_mask_compression
// (:249-258) and the clip of vwfd_tpu/models/hidden_model.py:40-42, with
// vwfd_tpu/ops/color.py::rgb_to_yuv_analog / yuv_to_rgb_analog (:87-94) and
// vwfd_tpu/ops/dct.py::dct8x8 / idct8x8 (:55-90). Per 8×8 block and channel
// (NHWC f32, C = 3, H and W multiples of 8):
//   c = DCT8x8(YUV(x)) · keep,   z = RGB(IDCT8x8(c)),   y = clip01(z)
// with keep the zig-zag mask of channel ch (its first keep[ch] coefficients
// in zig-zag order: 25 / 9 / 9), given as 64 bits a channel (bit 8k + l).
// The two colour matrices are the reference's BT.601 analog constants,
// not each other's inverse. The backward maps g through the transposes:
//   g' = g · clip'(z)   (1 inside (0, 1) and at NaN, ½ where z is 0 or 1,
//                        exactly 0 outside, a NaN g too: the plain
//                        version's torch.minimum / torch.maximum gradient)
//   gx = YUVᵀ(IDCT8x8(DCT8x8(RGBᵀ(g')) · keep))
// since the blockwise DCT is orthonormal (its adjoint is the IDCT). The
// masked coefficients are multiplied by 0, not skipped, so a NaN or Inf
// pixel makes its whole 8×8 block NaN in all three channels, as in the
// plain version (not the whole image, as JAX's dense einsum does: F21).
//
// Bound: bytes. At the HiDDeN path's (8, 128, 128, 3) f32 the forward reads
// and writes 1.57 MB each, about 0.94 µs at 3.35 TB/s, under a launch's
// fixed cost; the arithmetic is about 700 flops a value. What held the
// first version back was its grid: 32 blocks a CTA gave 64 CTAs on 132 SMs,
// each thread issuing 24 scalar loads.
//
// Design (after K5 jpeg_pair's, csrc/jpeg.cu): a CTA owns a unit of 8
// image rows × up to 8 blocks (256 units, two CTAs an SM, at HiDDeN's
// shape), one thread per block column and channel (192 threads: the
// first version's one thread per column ran its three channels one after
// another at one warp a scheduler). Thread 0 moves the unit's rows (x
// forward, g backward) into shared memory with 1-D bulk copies completing
// on an mbarrier, and the result leaves from the same stage by bulk stores.
// A thread maps its column's 8 pixels to its channel of YUV (reading all
// three channels), runs the column pass as 8-term FMA chains on the
// immediate DCT matrix (common.cuh) in registers, turns through its block
// and channel's padded tile (pitch 9) to own row c, runs the row pass,
// masks, runs the inverse row pass, turns back and runs the inverse column
// pass; the column goes to a second stage, and after a barrier the thread
// maps its pixels' three channels there to its channel of RGB, with the
// clip, in place in the first. The colour maps are rounded operation by
// operation in the plain version's order; the DCT sums run in another
// order than torch.matmul's, so the kernel is within a few float32 ulps of
// its plain version (tests: 2e-6).
//
// The forward writes the clip's derivative as a 1-byte code per value (0,
// ½ or 1 as 0, 1, 2), and the backward reads it: it loads g and the codes,
// never x (recomputing z from x instead timed 1.3-1.4 µs slower a backward
// on an H100, PERF.md §6). The bulk copies need the tensors on a 16-byte
// boundary (rows are 96·k bytes); the wrapper copies a view that is not.
#include "common.cuh"

#include <climits>

namespace {

using vwfd::dct8;
using vwfd::smem_u32;

constexpr int kBlk = 8;              // 8×8 blocks per unit
constexpr int kThr = 24 * kBlk;      // one thread per block column and channel
constexpr int kRowF = 24 * kBlk;     // floats per staged unit row
constexpr int kSlotF = 8 * kRowF;    // floats per staged unit (6 KB)
constexpr int kTP = 9;               // tile row pitch
constexpr int kTB = 8 * kTP;         // tile pitch

struct Keep {
  unsigned long long m[3];  // bit 8k + l: coefficient (k, l) kept
};

// Row `ch` of a colour matrix as three floats, picked once per thread (a
// runtime index into a local array would go to local memory).
struct Row3 {
  float m0, m1, m2;
};
__device__ __forceinline__ Row3 pick(int ch, Row3 a, Row3 b, Row3 c) {
  return ch == 0 ? a : (ch == 1 ? b : c);
}
// ch's row of each map (the reference's float32 analog matrices,
// ops/color.py:47-58, each entry the float nearest the double literal)
__device__ __forceinline__ Row3 rgb_to_yuv(int ch) {
  return pick(ch, {(float)0.299, (float)0.587, (float)0.114},
              {(float)-0.14713, (float)-0.28886, (float)0.436},
              {(float)0.615, (float)-0.51499, (float)-0.10001});
}
__device__ __forceinline__ Row3 yuv_to_rgb(int ch) {
  return pick(ch, {1.f, 0.f, (float)1.13983},
              {1.f, (float)-0.39465, (float)-0.58060},
              {1.f, (float)2.03211, 0.f});
}
// the transposes (the backward's colour steps)
__device__ __forceinline__ Row3 yuv_to_rgb_t(int ch) {
  return pick(ch, {1.f, 1.f, 1.f}, {0.f, (float)-0.39465, (float)2.03211},
              {(float)1.13983, (float)-0.58060, 0.f});
}
__device__ __forceinline__ Row3 rgb_to_yuv_t(int ch) {
  return pick(ch, {(float)0.299, (float)-0.14713, (float)0.615},
              {(float)0.587, (float)-0.28886, (float)-0.51499},
              {(float)0.114, (float)0.436, (float)-0.10001});
}

// o = m·v: the three products summed left to right, as numpy's matmul of
// the plain version rounds them
__device__ __forceinline__ float dot3(const Row3& m, const float* v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(v[0], m.m0), __fmul_rn(v[1], m.m1)),
                   __fmul_rn(v[2], m.m2));
}

// Column c of a block's channel (v[i], rows i) → the same column of
// C^T((C v C^T) · keep) C: column pass, turn, row pass, mask, inverse row
// pass, turn back, inverse column pass. `tile` is the block's and
// channel's; `gm` the mask of its 8 lanes.
__device__ __forceinline__ void masked_dct(float* v, float* tile, int c,
                                           unsigned long long keep,
                                           unsigned gm) {
  float a[8], row[8];
  dct8<false>(v, a);  // a[k] = (C B)[k][c]
#pragma unroll
  for (int k = 0; k < 8; ++k) tile[k * kTP + c] = a[k];
  __syncwarp(gm);
#pragma unroll
  for (int m = 0; m < 8; ++m) row[m] = tile[c * kTP + m];
  __syncwarp(gm);
  dct8<false>(row, a);  // a[l] = (C B C^T)[c][l]
#pragma unroll
  for (int l = 0; l < 8; ++l)
    a[l] = __fmul_rn(a[l], (keep >> (8 * c + l)) & 1ull ? 1.f : 0.f);
  dct8<true>(a, row);  // row[m] = (c' C)[c][m]
#pragma unroll
  for (int m = 0; m < 8; ++m) tile[c * kTP + m] = row[m];
  __syncwarp(gm);
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = tile[k * kTP + c];
  __syncwarp(gm);
  dct8<true>(a, v);  // v[i] = (C^T c' C)[i][c]
}

// One channel of one column through a colour map, the masked DCT and a
// second colour map: the column's 8 pixels (at offset `px` of a staged
// unit, rows kRowF apart) of `in` mapped by `m1` to channel `ch` (all
// three channels in), the masked DCT in registers, the result to `mid`;
// after the CTA barrier, the pixels of `mid` mapped by `m2` to channel ch
// of `out` (which may be `in`: every thread has read it before the
// barrier). `mid` is the stage between.
__device__ __forceinline__ void chain(const float* in, float* mid, float* out,
                                      int px, int ch, int c, Row3 m1, Row3 m2,
                                      unsigned long long keep, float* tile,
                                      unsigned gm, bool active) {
  if (active) {
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = dot3(m1, in + r * kRowF + px);
    masked_dct(v, tile, c, keep, gm);
#pragma unroll
    for (int r = 0; r < 8; ++r) mid[r * kRowF + px + ch] = v[r];
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
      out[r * kRowF + px + ch] = dot3(m2, mid + r * kRowF + px);
  }
}

// jnp.clip's value (NaN passes); the plain version's derivative as a code:
// 0 outside [0, 1], 1 (½) at 0 and 1, 2 (1) inside and at NaN. Autograd's
// torch.minimum / torch.maximum backward masks the cotangent to exactly 0
// outside [0, 1] and halves it at the ties.
__device__ __forceinline__ float clip01(float z) {
  return z < 0.f ? 0.f : (z > 1.f ? 1.f : z);
}
__device__ __forceinline__ uint8_t clip01_code(float z) {
  return (z < 0.f || z > 1.f) ? 0 : ((z == 0.f || z == 1.f) ? 1 : 2);
}

// The unit of 8 image rows × up to kBlk blocks that CTA u owns: its first
// pixel and its block count. 32-bit unit indices.
struct Unit {
  long long px0;
  int nblk;
};

__device__ __forceinline__ Unit unit_of(int u, int H, int W) {
  const int wb = W / 8, G = (wb + kBlk - 1) / kBlk, hb = H / 8;
  const int t = u / G, grp = u - t * G;
  const int n = t / hb, band = t - n * hb;
  return {((long long)n * H + 8 * band) * W + 8 * grp * kBlk,
          min(kBlk, wb - grp * kBlk)};
}

template <bool kBwd>
__global__ void __launch_bounds__(kThr)
    zigzag_kernel(const float* __restrict__ src, uint8_t* __restrict__ code,
                  float* __restrict__ out, const Keep keep, int H, int W,
                  int clip) {
  // the unit of x (forward) or g (backward), then of the result
  __shared__ __align__(16) float stage[kSlotF];
  __shared__ __align__(16) float smid[kSlotF];
  __shared__ float tiles[3 * kBlk * kTB];
  __shared__ __align__(8) uint64_t bar;
  const Unit a = unit_of(blockIdx.x, H, W);
  const int rowb = a.nblk * 96;
  if (threadIdx.x == 0) {
    const uint32_t b = smem_u32(&bar);
    vwfd::mbar_init(b, 1);
    vwfd::mbar_fence_init();
    vwfd::mbar_expect_tx(b, 8 * rowb);
    vwfd::bulk_load_rows(reinterpret_cast<uint8_t*>(stage), kRowF * 4,
                         reinterpret_cast<const uint8_t*>(src + a.px0 * 3),
                         8, W * 12, rowb, b);
  }
  // thread (block b, channel ch, column c); a (b, ch)'s 8 lanes share a
  // warp and a tile
  const int b = threadIdx.x / 24, ch = (threadIdx.x >> 3) % 3;
  const int c = threadIdx.x & 7;
  const bool active = b < a.nblk;
  const unsigned gm = 0xffu << (threadIdx.x & 24);
  float* tile = tiles + (threadIdx.x >> 3) * kTB;
  const unsigned long long kp = ch == 0 ? keep.m[0]
                                : ch == 1 ? keep.m[1] : keep.m[2];
  const int px = 3 * (8 * b + c);  // pixel (row 0, column 8b + c)
  // this value's global index at row 0 (row r at + 3·r·W)
  const long long gv = (a.px0 + 8 * b + c) * 3 + ch;
  uint8_t codes[8];  // the backward's clip' codes
  if (kBwd && clip && active) {
#pragma unroll
    for (int r = 0; r < 8; ++r) codes[r] = code[gv + 3ll * r * W];
  }
  __syncthreads();
  vwfd::mbar_wait(smem_u32(&bar), 0);

  if constexpr (!kBwd) {
    // z = RGB(IDCT(DCT(YUV(x))·keep)); y = clip01(z) and its codes
    chain(stage, smid, stage, px, ch, c, rgb_to_yuv(ch), yuv_to_rgb(ch), kp,
          tile, gm, active);
    if (active) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float* p = stage + r * kRowF + px + ch;
        if (code != nullptr) code[gv + 3ll * r * W] = clip01_code(*p);
        if (clip) *p = clip01(*p);
      }
    }
  } else {
    if (clip) {  // g' = g·clip'(z) in place, torch's masked_fill: exactly
                 // 0 outside [0, 1] even where g is NaN
      if (active) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float* p = stage + r * kRowF + px + ch;
          const uint8_t k = codes[r];
          *p = k == 2 ? *p : (k == 1 ? __fmul_rn(*p, 0.5f) : 0.f);
        }
      }
      __syncthreads();
    }
    // gx = YUVᵀ(IDCT(DCT(RGBᵀ(g'))·keep))
    chain(stage, smid, stage, px, ch, c, yuv_to_rgb_t(ch), rgb_to_yuv_t(ch),
          kp, tile, gm, active);
  }
  vwfd::fence_to_bulk();
  __syncthreads();
  if (threadIdx.x == 0) {
    vwfd::bulk_store_rows(reinterpret_cast<uint8_t*>(out + a.px0 * 3),
                          reinterpret_cast<const uint8_t*>(stage), kRowF * 4,
                          8, W * 12, 1, 0, rowb);
    vwfd::bulk_wait_read();
  }
}

}  // namespace

// x: (N, H, W, 3) f32 contiguous, H and W multiples of 8, on a 16-byte
// boundary as out is (forward only);
// g (backward only): the output's cotangent, same shape; out: y (forward)
// or gx (backward). keep0..2: each channel's 64-bit keep mask. code:
// (N, H, W, 3) uint8 clip' codes, written by the forward where not null
// and read by the backward with the clip (required there).
extern "C" int vwfd_zigzag_jpeg(const void* x, const void* g, void* out,
                                void* code, unsigned long long keep0,
                                unsigned long long keep1,
                                unsigned long long keep2, int N, int H, int W,
                                int clip, int backward, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long units =
      (long long)N * (H / 8) * ((W / 8 + kBlk - 1) / kBlk);
  if (units == 0) return (int)cudaSuccess;
  const float* src = static_cast<const float*>(backward ? g : x);
  if (units > INT_MAX || H % 8 || W % 8 || (backward && clip && !code) ||
      !vwfd::aligned16({src, out}))
    return (int)cudaErrorInvalidValue;
  const Keep keep{{keep0, keep1, keep2}};
  uint8_t* cp = static_cast<uint8_t*>(code);
  float* op = static_cast<float*>(out);
  if (backward)
    zigzag_kernel<true><<<(int)units, kThr, 0, s>>>(src, cp, op, keep, H, W,
                                                    clip);
  else
    zigzag_kernel<false><<<(int)units, kThr, 0, s>>>(src, cp, op, keep, H,
                                                     W, clip);
  return (int)cudaGetLastError();
}
