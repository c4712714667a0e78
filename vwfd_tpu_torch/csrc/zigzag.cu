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
//   g' = g · clip'(z)   (1 inside (0, 1), ½ where z is 0 or 1, as jnp.clip,
//                        0 outside; z recomputed from x)
//   gx = YUVᵀ(IDCT8x8(DCT8x8(RGBᵀ(g')) · keep))
// since the blockwise DCT is orthonormal (its adjoint is the IDCT).
//
// Bound: bytes. At the HiDDeN path's (8, 3, 128, 128) f32 the forward reads
// and writes 1.57 MB each, about 0.94 µs at 3.35 TB/s, under a launch's
// fixed cost; the arithmetic is about 700 flops a value.
//
// Design: one thread per column of an 8×8 block, a block's 8 threads in one
// warp, 32 blocks a CTA. A thread holds its column's 8 pixels × 3 channels
// in registers, maps them to YUV, then for each channel runs the column
// pass as 8-term FMA chains on the immediate DCT matrix (common.cuh), turns
// through a padded shared-memory tile (pitch 9) to own row c, runs the row
// pass, masks, runs the inverse row pass, turns back, runs the inverse
// column pass, and maps the pixels back to RGB with the clip. The colour
// maps are rounded operation by operation in the plain version's order;
// the DCT sums run in another order than torch.matmul's, so the kernel is
// within a few float32 ulps of its plain version (tests: 2e-6).
#include "common.cuh"

namespace {

using vwfd::dct8;

constexpr int kBlk = 32;            // 8×8 blocks per CTA
constexpr int kThr = 8 * kBlk;      // one thread per block column
constexpr int kTP = 9;              // tile row pitch
constexpr int kTB = 8 * kTP;        // tile pitch

// The reference's float32 analog matrices (ops/color.py:47-58), each entry
// the float nearest the double literal, as numpy rounds it: o = m·v, the
// three products summed left to right.
__device__ __forceinline__ float dot3(float m0, float m1, float m2,
                                      const float* v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(v[0], m0), __fmul_rn(v[1], m1)),
                   __fmul_rn(v[2], m2));
}

__device__ __forceinline__ void rgb_to_yuv(const float* v, float* o) {
  o[0] = dot3((float)0.299, (float)0.587, (float)0.114, v);
  o[1] = dot3((float)-0.14713, (float)-0.28886, (float)0.436, v);
  o[2] = dot3((float)0.615, (float)-0.51499, (float)-0.10001, v);
}

__device__ __forceinline__ void yuv_to_rgb(const float* v, float* o) {
  o[0] = dot3(1.f, 0.f, (float)1.13983, v);
  o[1] = dot3(1.f, (float)-0.39465, (float)-0.58060, v);
  o[2] = dot3(1.f, (float)2.03211, 0.f, v);
}

// the transposes (the backward's colour steps)
__device__ __forceinline__ void yuv_to_rgb_t(const float* v, float* o) {
  o[0] = dot3(1.f, 1.f, 1.f, v);
  o[1] = dot3(0.f, (float)-0.39465, (float)2.03211, v);
  o[2] = dot3((float)1.13983, (float)-0.58060, 0.f, v);
}

__device__ __forceinline__ void rgb_to_yuv_t(const float* v, float* o) {
  o[0] = dot3((float)0.299, (float)-0.14713, (float)0.615, v);
  o[1] = dot3((float)0.587, (float)-0.28886, (float)-0.51499, v);
  o[2] = dot3((float)0.114, (float)0.436, (float)-0.10001, v);
}

struct Keep {
  unsigned long long m[3];  // bit 8k + l: coefficient (k, l) kept
};

// Column c of a block's channel (v[i], rows i) → the same column of
// C^T((C v C^T) · keep) C: column pass, turn, row pass, mask, inverse row
// pass, turn back, inverse column pass. `tile` is the block's; `gm` the
// mask of the block's 8 lanes.
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

// The forward of one column: its pixels' RGB in px[i][3] → z[i][3].
__device__ __forceinline__ void forward_col(float (*px)[3], float* tile,
                                            int c, const Keep& keep,
                                            unsigned gm) {
  float v[3][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float o[3];
    rgb_to_yuv(px[i], o);
    v[0][i] = o[0], v[1][i] = o[1], v[2][i] = o[2];
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) masked_dct(v[ch], tile, c, keep.m[ch], gm);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float o[3] = {v[0][i], v[1][i], v[2][i]};
    yuv_to_rgb(o, px[i]);
  }
}

// jnp.clip's value (NaN passes) and derivative (½ at the ends)
__device__ __forceinline__ float clip01(float z) {
  return z < 0.f ? 0.f : (z > 1.f ? 1.f : z);
}
__device__ __forceinline__ float clip01_grad(float z) {
  return (z > 0.f && z < 1.f) ? 1.f : ((z == 0.f || z == 1.f) ? 0.5f : 0.f);
}

template <bool kBwd>
__global__ void __launch_bounds__(kThr)
    zigzag_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ out, const Keep keep, int nblocks,
                  int H, int W, int clip) {
  __shared__ float tiles[kBlk * kTB];
  const int b = blockIdx.x * kBlk + (threadIdx.x >> 3);
  const int c = threadIdx.x & 7;
  if (b >= nblocks) return;  // a block's 8 lanes leave together
  const unsigned gm = 0xffu << (threadIdx.x & 24);
  float* tile = tiles + (threadIdx.x >> 3) * kTB;
  const int wb = W / 8, hb = H / 8;
  const int n = b / (hb * wb), rem = b - n * hb * wb;
  const int by = rem / wb, bx = rem - by * wb;
  const long long p0 = ((long long)n * H + 8 * by) * W + 8 * bx + c;

  float px[8][3];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float* p = x + (p0 + (long long)i * W) * 3;
    px[i][0] = p[0], px[i][1] = p[1], px[i][2] = p[2];
  }
  if constexpr (!kBwd) {
    forward_col(px, tile, c, keep, gm);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* p = out + (p0 + (long long)i * W) * 3;
#pragma unroll
      for (int e = 0; e < 3; ++e) p[e] = clip ? clip01(px[i][e]) : px[i][e];
    }
  } else {
    if (clip) forward_col(px, tile, c, keep, gm);  // px now holds z
    float v[3][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* p = g + (p0 + (long long)i * W) * 3;
      float gi[3], o[3];
#pragma unroll
      for (int e = 0; e < 3; ++e)
        gi[e] = clip ? __fmul_rn(p[e], clip01_grad(px[i][e])) : p[e];
      yuv_to_rgb_t(gi, o);
      v[0][i] = o[0], v[1][i] = o[1], v[2][i] = o[2];
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) masked_dct(v[ch], tile, c, keep.m[ch], gm);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float o[3] = {v[0][i], v[1][i], v[2][i]};
      float r[3];
      rgb_to_yuv_t(o, r);
      float* p = out + (p0 + (long long)i * W) * 3;
      p[0] = r[0], p[1] = r[1], p[2] = r[2];
    }
  }
}

}  // namespace

// x: (N, H, W, 3) f32 contiguous, H and W multiples of 8; g (backward
// only) the output's cotangent, same shape; out: y (forward) or gx
// (backward). keep0..2: each channel's 64-bit keep mask.
extern "C" int vwfd_zigzag_jpeg(const void* x, const void* g, void* out,
                                unsigned long long keep0,
                                unsigned long long keep1,
                                unsigned long long keep2, int N, int H, int W,
                                int clip, int backward, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = N * (H / 8) * (W / 8);
  if (nblocks == 0) return (int)cudaSuccess;
  const Keep keep{{keep0, keep1, keep2}};
  const int grid = (nblocks + kBlk - 1) / kBlk;
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  if (backward)
    zigzag_kernel<true><<<grid, kThr, 0, s>>>(xp, gp, op, keep, nblocks, H,
                                              W, clip);
  else
    zigzag_kernel<false><<<grid, kThr, 0, s>>>(xp, gp, op, keep, nblocks, H,
                                               W, clip);
  return (int)cudaGetLastError();
}
