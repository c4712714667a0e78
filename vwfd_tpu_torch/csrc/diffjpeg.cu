// K24 `diffjpeg`: the reference's DiffJPEG (utils/JPEG.py:501-540), forward
// and backward with respect to the image.
//
// Replaces vwfd_tpu/attacks/jpeg.py::diffjpeg (:114-146) with
// vwfd_tpu/ops/color.py::rgb_to_ycbcr_diffjpeg / ycbcr_to_rgb_diffjpeg
// (:77-85), ops/filters.py::avg_pool_2x2 (:133) and ops/dct.py::dct8x8 /
// idct8x8 with center=True (:55-86). Per frame n (NHWC f32, C = 3, H and W
// multiples of 16), per 16×16 macroblock:
//   ycc    = YCbCr(255·x) + (0, 128, 128)
//   Y: four 8×8 blocks; Cb, Cr: the 2×2 means, one 8×8 block each
//   c      = DCT8x8(plane − 128)                 (orthonormal, per block)
//   d      = r0(c/t)·t, t = Tᵀ·factor_n, r0(v) = |v| < ½ ? v³ : v
//   plane' = IDCT8x8(d) + 128; chroma repeated 2×2
//   y      = clip(RGB(ycc' − (0, 128, 128)), 0, 255) / 255
// with Tᵀ the transposed Annex-K tables (Y, and C for both chroma planes)
// and factor_n the frame's quality factor. The backward recomputes the
// forward from x (no plane is saved) and carries g through the transposes:
// /255, the clip's derivative with JAX's tie rule (1 inside, ½ exactly at
// 0 or 255, 0 outside; a NaN passes), RGBᵀ, the repeat's sum, the DCT
// (= IDCTᵀ), the per-coefficient derivative ((g·t)·r0'(v))/t with
// r0' = 3v² or 1 (NaN where c is not finite, as autograd's), the IDCT
// (= DCTᵀ), the means' ¼, YCbCrᵀ, ·255.
//
// Bound: bytes. The forward reads x and writes y (24 bytes a pixel); the
// backward reads x and g and writes gx (36). At the study's single 32²
// image that is 24.6 KB, 7 ns at 3.35 TB/s: the launch's fixed cost (a few
// µs) is all of its time there.
//
// Design (a first version): a CTA of 256 threads takes 4 macroblocks.
// Thread t loads pixel t of each (a 16×16 macroblock has 256), maps it to
// YCbCr in shared memory; the chroma planes are pooled 2×2; then 8 threads
// own each of a macroblock's six 8×8 blocks, one column each: the
// separable passes are 8-term FMA chains in registers (common.cuh's dct8,
// the matrix an immediate) with a padded shared-memory tile for each
// transpose (K5's scheme), the quantisation in between; then thread t
// maps its pixels back to RGB. The colour maps, the means, c/t, the soft
// round and the clip are rounded operation by operation in the plain
// version's order (no FMA contraction); the DCT sums in another order than
// torch.matmul, so a coefficient within rounding of |c/t| = ½ (r0's jump)
// may land on the other side: kernel and plain then part on that
// macroblock (chip_smoke.py counts such macroblocks).
#include "common.cuh"

#include <climits>

namespace {

using vwfd::col_to_row;
using vwfd::dct8;
using vwfd::dot3;
using vwfd::kTB;
using vwfd::kTP;
using vwfd::row_to_col;

constexpr int kMB = 4;          // macroblocks per CTA
constexpr int kThreads = 256;   // a thread per pixel of a macroblock

// the Annex-K tables, transposed as DiffJPEG takes them: kYT[k][l] =
// Y_TABLE[l][k] (vwfd_tpu/attacks/jpeg.py:23-36,110-111)
__constant__ float kYT[64] = {
    16, 12, 14, 14, 18, 24, 49, 72,   11, 12, 13, 17, 22, 35, 64, 92,
    10, 14, 16, 22, 37, 55, 78, 95,   16, 19, 24, 29, 56, 64, 87, 98,
    24, 26, 40, 51, 68, 81, 103, 112, 40, 58, 57, 87, 109, 104, 121, 100,
    51, 60, 69, 80, 103, 113, 120, 103, 61, 55, 56, 62, 77, 92, 101, 99};
__constant__ float kCT[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// the JAX package's float32 DiffJPEG matrices (ops/color.py:35-46), each
// entry the float nearest the double literal; each output channel the
// 3-term sum left to right, one rounding an operation (vwfd::dot3)

__device__ __forceinline__ void to_ycc(const float* v, float* o) {
  o[0] = __fadd_rn(dot3(v[0], v[1], v[2], (float)0.299, (float)0.587,
                        (float)0.114), 0.f);
  o[1] = __fadd_rn(dot3(v[0], v[1], v[2], (float)-0.168736,
                        (float)-0.331264, 0.5f), 128.f);
  o[2] = __fadd_rn(dot3(v[0], v[1], v[2], 0.5f, (float)-0.418688,
                        (float)-0.081312), 128.f);
}

__device__ __forceinline__ void to_rgb(const float* v, float* o) {
  const float a = __fsub_rn(v[0], 0.f), b = __fsub_rn(v[1], 128.f),
              c = __fsub_rn(v[2], 128.f);
  o[0] = dot3(a, b, c, 1.f, 0.f, (float)1.402);
  o[1] = dot3(a, b, c, 1.f, (float)-0.344136, (float)-0.714136);
  o[2] = dot3(a, b, c, 1.f, (float)1.772, 0.f);
}

// the clip to [0, 255] as jnp.clip (max then min; a NaN passes), and its
// derivative as autograd of maximum/minimum gives it: ½ at a tie
__device__ __forceinline__ float clip255(float v) {
  if (v != v) return v;
  return fminf(fmaxf(v, 0.f), 255.f);
}

__device__ __forceinline__ float clip255_grad(float v) {
  if (v != v) return 1.f;
  const float lo = v < 0.f ? 0.f : (v == 0.f ? 0.5f : 1.f);
  return v > 255.f ? 0.f : (v == 255.f ? 0.5f * lo : lo);
}

// shared memory of one macroblock: the Y plane, the full-resolution chroma
// (the backward's gradients there too), the pooled chroma, the six blocks'
// transpose tiles and their soft-round derivatives
struct MB {
  float y[256];
  float cf[2][256];
  float cp[2][64];
  float tile[6][kTB];
  float dr[6][64];
};

struct Geo {
  int n;
  long long px0;  // the macroblock's top-left pixel
  bool live;
};

__device__ __forceinline__ Geo geo(int mb, int N, int H, int W) {
  const int hm = H / 16, wm = W / 16;
  const long long total = (long long)N * hm * wm;
  Geo g{0, 0, mb < total};
  if (!g.live) return g;
  const int per = hm * wm;
  g.n = mb / per;
  const int r = mb - g.n * per, my = r / wm, mx = r - my * wm;
  g.px0 = ((long long)g.n * H + 16 * my) * W + 16 * mx;
  return g;
}

// x's macroblock (pixel t) to YCbCr in shared memory, and the 2×2 means of
// the chroma (thread t: mean t % 64 of macroblock t / 64)
__device__ __forceinline__ void load_ycc(MB* s, const float* x, int mb0,
                                         int N, int H, int W) {
  const int t = threadIdx.x, py = t >> 4, px = t & 15;
#pragma unroll
  for (int m = 0; m < kMB; ++m) {
    const Geo g = geo(mb0 + m, N, H, W);
    if (!g.live) continue;
    const float* p = x + (g.px0 + (long long)py * W + px) * 3;
    const float v[3] = {__fmul_rn(p[0], 255.f), __fmul_rn(p[1], 255.f),
                        __fmul_rn(p[2], 255.f)};
    float o[3];
    to_ycc(v, o);
    s[m].y[t] = o[0];
    s[m].cf[0][t] = o[1];
    s[m].cf[1][t] = o[2];
  }
  __syncthreads();
  const int m = t >> 6, j = t & 63, r = j >> 3, c = j & 7;
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const float* f = s[m].cf[ch] + (2 * r) * 16 + 2 * c;
    const float sum = __fadd_rn(__fadd_rn(__fadd_rn(f[0], f[1]), f[16]),
                                f[17]);
    s[m].cp[ch][j] = __fmul_rn(sum, 0.25f);
  }
  __syncthreads();
}

// the plane and origin of block b of a macroblock: 0-3 Y, 4 Cb, 5 Cr
__device__ __forceinline__ float* block_origin(MB* s, int b, int& pitch) {
  if (b < 4) {
    pitch = 16;
    return s->y + (b >> 1) * 8 * 16 + (b & 1) * 8;
  }
  pitch = 8;
  return s->cp[b - 4];
}

// One block (threads mb·48 + 8b + c): the centred DCT, r0(c/t)·t and the
// IDCT + 128, in place in its plane. With kSave it keeps r0's derivative
// per coefficient (the backward's).
template <bool kSave>
__device__ __forceinline__ void jpeg_block(MB* s, int b, int c, float factor) {
  int pitch;
  float* o = block_origin(s, b, pitch);
  const float* tab = b < 4 ? kYT : kCT;
  float v[8], a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __fsub_rn(o[i * pitch + c], 128.f);
  dct8<false>(v, a);                 // along the column
  col_to_row(s->tile[b], c, a, v);   // row c of C·B
  dct8<false>(v, a);                 // coefficients (c, l)
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const float t = __fmul_rn(tab[c * 8 + l], factor);
    const float q = __fdiv_rn(a[l], t);
    const bool small = fabsf(q) < 0.5f;
    if (kSave)  // NaN where c is not finite, as autograd's where()
      s->dr[b][c * 8 + l] = __fadd_rn(
          small ? __fmul_rn(3.f, __fmul_rn(q, q)) : 1.f, __fmul_rn(0.f, a[l]));
    a[l] = __fmul_rn(small ? __fmul_rn(__fmul_rn(q, q), q) : q, t);
  }
  dct8<true>(a, v);                  // IDCT along row c
  row_to_col(s->tile[b], c, v, a);   // column c
  dct8<true>(a, v);                  // ... and along the column
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i * pitch + c] = __fadd_rn(v[i], 128.f);
}

// The backward of jpeg_block on the gradient g in the block's plane:
// DCT(g), ((g·t)·r0')/t per coefficient, IDCT, in place.
__device__ __forceinline__ void jpeg_block_bwd(MB* s, int b, int c,
                                               float factor) {
  int pitch;
  float* o = block_origin(s, b, pitch);
  const float* tab = b < 4 ? kYT : kCT;
  float v[8], a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = o[i * pitch + c];
  dct8<false>(v, a);
  col_to_row(s->tile[b], c, a, v);
  dct8<false>(v, a);
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const float t = __fmul_rn(tab[c * 8 + l], factor);
    a[l] = __fdiv_rn(__fmul_rn(__fmul_rn(a[l], t), s->dr[b][c * 8 + l]), t);
  }
  dct8<true>(a, v);
  row_to_col(s->tile[b], c, v, a);
  dct8<true>(a, v);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i * pitch + c] = v[i];
}

// the 192 block threads (six whole warps): macroblock t / 48, block
// (t % 48) / 8, column t % 8. A macroblock past the end (the last CTA's)
// is transformed too, on its unused shared memory and never stored: the
// transposes' __syncwarp needs every thread of the warp.
template <int kPass>  // 0 forward, 1 forward keeping r0', 2 backward
__device__ __forceinline__ void blocks(MB* s, int mb0, const float* factor,
                                       int N, int H, int W) {
  const int t = threadIdx.x;
  if (t < kMB * 48) {
    const int m = t / 48, r = t - m * 48, b = r >> 3, c = r & 7;
    const Geo g = geo(mb0 + m, N, H, W);
    const float f = g.live ? __ldg(factor + g.n) : 1.f;
    if (kPass == 2) jpeg_block_bwd(s + m, b, c, f);
    else jpeg_block<kPass == 1>(s + m, b, c, f);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    diffjpeg_fwd(const float* __restrict__ x, float* __restrict__ y,
                 const float* __restrict__ factor, int N, int H, int W) {
  __shared__ MB s[kMB];
  const int mb0 = blockIdx.x * kMB;
  load_ycc(s, x, mb0, N, H, W);
  blocks<0>(s, mb0, factor, N, H, W);
  const int t = threadIdx.x, py = t >> 4, px = t & 15;
  const int ci = (py >> 1) * 8 + (px >> 1);
#pragma unroll
  for (int m = 0; m < kMB; ++m) {
    const Geo g = geo(mb0 + m, N, H, W);
    if (!g.live) continue;
    const float v[3] = {s[m].y[t], s[m].cp[0][ci], s[m].cp[1][ci]};
    float o[3];
    to_rgb(v, o);
    float* p = y + (g.px0 + (long long)py * W + px) * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) p[ch] = __fdiv_rn(clip255(o[ch]), 255.f);
  }
}

__global__ void __launch_bounds__(kThreads)
    diffjpeg_bwd(const float* __restrict__ x, const float* __restrict__ g,
                 float* __restrict__ gx, const float* __restrict__ factor,
                 int N, int H, int W) {
  __shared__ MB s[kMB];
  const int mb0 = blockIdx.x * kMB;
  load_ycc(s, x, mb0, N, H, W);
  blocks<1>(s, mb0, factor, N, H, W);
  const int t = threadIdx.x, py = t >> 4, px = t & 15;
  const int ci = (py >> 1) * 8 + (px >> 1);
  // the output's gradient through /255, the clip and RGBᵀ: Y's in the Y
  // plane, the chroma's at full resolution
#pragma unroll
  for (int m = 0; m < kMB; ++m) {
    const Geo gm = geo(mb0 + m, N, H, W);
    if (!gm.live) continue;
    const float v[3] = {s[m].y[t], s[m].cp[0][ci], s[m].cp[1][ci]};
    float o[3];
    to_rgb(v, o);
    const float* pg = g + (gm.px0 + (long long)py * W + px) * 3;
    float gr[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      gr[ch] = __fmul_rn(__fdiv_rn(pg[ch], 255.f), clip255_grad(o[ch]));
    s[m].y[t] = __fadd_rn(__fadd_rn(gr[0], gr[1]), gr[2]);
    s[m].cf[0][t] = __fadd_rn(__fmul_rn(gr[1], (float)-0.344136),
                              __fmul_rn(gr[2], (float)1.772));
    s[m].cf[1][t] = __fadd_rn(__fmul_rn(gr[0], (float)1.402),
                              __fmul_rn(gr[1], (float)-0.714136));
  }
  __syncthreads();
  {  // the repeat's backward: the four copies' sum into the pooled plane
    const int m = t >> 6, j = t & 63, r = j >> 3, c = j & 7;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      const float* f = s[m].cf[ch] + (2 * r) * 16 + 2 * c;
      s[m].cp[ch][j] = __fadd_rn(__fadd_rn(f[0], f[1]),
                                 __fadd_rn(f[16], f[17]));
    }
  }
  __syncthreads();
  blocks<2>(s, mb0, factor, N, H, W);
#pragma unroll
  for (int m = 0; m < kMB; ++m) {
    const Geo gm = geo(mb0 + m, N, H, W);
    if (!gm.live) continue;
    const float gy = s[m].y[t], gcb = __fmul_rn(s[m].cp[0][ci], 0.25f),
                gcr = __fmul_rn(s[m].cp[1][ci], 0.25f);
    float* p = gx + (gm.px0 + (long long)py * W + px) * 3;
    p[0] = __fmul_rn(dot3(gy, gcb, gcr, (float)0.299, (float)-0.168736, 0.5f),
                     255.f);
    p[1] = __fmul_rn(dot3(gy, gcb, gcr, (float)0.587, (float)-0.331264,
                          (float)-0.418688), 255.f);
    p[2] = __fmul_rn(dot3(gy, gcb, gcr, (float)0.114, 0.5f, (float)-0.081312),
                     255.f);
  }
}

int grid_of(int N, int H, int W, int& grid) {
  const long long mbs = (long long)N * (H / 16) * (W / 16);
  if (mbs > (long long)INT_MAX - kMB) return (int)cudaErrorInvalidValue;
  grid = (int)((mbs + kMB - 1) / kMB);
  return 0;
}

}  // namespace

extern "C" int vwfd_diffjpeg_fwd(const void* x, void* y, const void* factor,
                                 int N, int H, int W, void* stream) {
  if ((long long)N * H * W == 0) return (int)cudaGetLastError();
  if (H % 16 || W % 16) return (int)cudaErrorInvalidValue;
  int grid;
  if (const int e = grid_of(N, H, W, grid)) return e;
  diffjpeg_fwd<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const float*>(factor), N, H, W);
  return (int)cudaGetLastError();
}

extern "C" int vwfd_diffjpeg_bwd(const void* x, const void* g, void* gx,
                                 const void* factor, int N, int H, int W,
                                 void* stream) {
  if ((long long)N * H * W == 0) return (int)cudaGetLastError();
  if (H % 16 || W % 16) return (int)cudaErrorInvalidValue;
  int grid;
  if (const int e = grid_of(N, H, W, grid)) return e;
  diffjpeg_bwd<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(gx), static_cast<const float*>(factor), N, H, W);
  return (int)cudaGetLastError();
}
