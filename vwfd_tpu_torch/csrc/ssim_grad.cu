// K22 `ssim_grad`: the gradient of the windowed SSIM's mean with respect to
// its first image.
//
// Replaces the VJP that JAX's autodiff takes of vwfd_tpu/metrics/
// metrics.py::ssim (:65-79) in CLR's loss, 0.1·(1 − ssim(fwd_rgb, img))
// (vwfd_tpu/models/image_model.py:398). K8 computes the forward. With the
// 11-tap gaussian w (σ 1.5; zero "same" padding), per pixel and channel
//   μ1, μ2, Q, E12 = the windowed sums of x1, x2, x1² + x2², x1·x2,
//   A1 = 2μ1μ2 + c1, A2 = 2(E12 − μ1μ2) + c2,
//   B1 = μ1² + μ2² + c1, B2 = (Q − (μ1² + μ2²)) + c2,
//   D = 1/(B1·B2), S = A1·A2·D,
// the map's partial derivatives are
//   α = ∂S/∂μ1  = 2μ2·D·(A2 − A1) + 2μ1·S·(1/B2 − 1/B1),
//   β = ∂S/∂E11 = −S/B2,   γ = ∂S/∂E12 = 2·A1·D
// (E[x1²] enters B2 alone; no quotient by A1 or A2, so a window where A2
// is 0 gives the plain version's finite values), and, the window being
// symmetric,
//   dx1[p] = s_n · Σ_q w(q − p)·(α(q) + 2·x1[p]·β(q) + x2[p]·γ(q))
//          = s_n · (Wα + 2·x1·Wβ + x2·Wγ)[p]
// over the q inside the image, s_n the cotangent of the image's share of
// the mean (the wrapper's scale: ḡ/(N·H·W·C) + ḡ_n/(H·W·C)).
//
// Bound: the larger of x1 and x2 read and dx written (3 planes: 18.9 MB
// at CLR's (8, 256, 256, 3), 5.6 µs at 3.35 TB/s) and the least
// operations, 346 f32 a value (kernels/ssim_grad.py's OPS: four windowed
// sums for the forward, three for the transpose, the products, the maps):
// 8.1 µs at 67 TFLOP/s.
//
// Design: one launch, K8's structure (csrc/ssim.cu) run twice over, α, β
// and γ never leaving the CTA. A CTA of 256 threads takes a strip of 64
// output columns, all three channels interleaved, and `rows` output rows
// of one image (kernels/ssim_grad.py plan: rows = 13·chunks − 10, the grid
// cut in height to fill the SMs, one CTA each). It walks down the strip 13
// rows a chunk; each chunk:
// - V1: thread t owns element t of the x span (the strip and a 10-pixel
//   halo each side: 252 elements), keeps the four products of the last 10
//   rows in registers and writes the four vertical sums of each new row to
//   shared memory (44 FMA a row); the chunk's raw rows came by cp.async
//   (16-byte copies when W % 4 == 0 and the bases are aligned, else one
//   float a thread; zero off the image) while the last chunk ran;
// - H1: a thread takes one row and 4 adjacent pixels (12 outputs) of the α
//   span (the strip and a 5-pixel halo: 222 elements), reads the 44
//   vertical sums of each quantity as 11 float4 and forms the four window
//   sums, then α, β, γ (two reciprocals, __fdividef; NaN stays NaN), zero
//   off the image, into shared memory;
// - V2: thread t owns element t of the α span, keeps α, β, γ of the last
//   10 rows in registers and writes the three transposed vertical sums of
//   the output row 5 above (33 FMA a row);
// - H2: a thread takes one output row and 12 outputs, reads 11 float4 of
//   each vertical sum, combines with x1 and x2 (the rows staged for V1 a
//   chunk back, kept in a ring of three chunks) and writes dx as float4.
// So the backward lags the forward by 5 rows and the forward the staging
// by 5: a segment walks its rows plus 10 above and 10 below (the first 10
// only to fill the windows), and its strip plus 10 columns each side. Four
// barriers a chunk; 166 KB of shared memory. One CTA an SM: the two
// windows (70 registers a thread) and H1's 48 sums need more than the 128
// registers ptxas allows at two CTAs an SM (such a build spills). Sums run
// in another order than the plain version's 121-term chain (and contract
// into FMAs), and σ² = E[x²] − μ² cancels where a window is flat, so a
// gradient value may part from the plain version's by up to ~1e-4 of its
// max; chip_smoke.py and the card tests bound it against the plain
// gradient's max. Fixed order, no atomics: bit-identical over calls.
#include "common.cuh"

namespace {

constexpr int kWin = 11, kHalo = 5, kC = 3;
// One CTA of 8 warps an SM: at two CTAs an SM ptxas caps a thread at 128
// registers, and the two rolling windows (70 registers) and H1's 48 sums
// do not fit in that (such a build spills).
constexpr int kTW = 64;                            // output pixels a strip
constexpr int kBlock = 256;
constexpr int kRC = 13;                            // rows a chunk
#ifndef VWFD_SSIMG_CUT
#define VWFD_SSIMG_CUT 0
#endif
// phases cut out for timing (port_tools/ablate_clr_kernels.py): 1 V1, 2
// H1, 4 V2, 8 H2
constexpr int kCut = VWFD_SSIMG_CUT;
constexpr int kOutE = kC * kTW;                    // output elements
constexpr int kAE = kC * (kTW + 2 * kHalo);        // α span
constexpr int kXE = kC * (kTW + 4 * kHalo);        // x span
constexpr int kOut = 12;                           // outputs of a group
constexpr int kGA = (kAE + kOut - 1) / kOut;       // groups (α span)
constexpr int kGO = kOutE / kOut;                  // groups (outputs)
constexpr int kLoad = kOut + kC * (kWin - 1) + 2;  // 44: whole float4s
constexpr int kRawStride = kBlock;                 // slot s + 2: x span s
constexpr int kVecs = kRawStride / 4;              // 16-byte copies a row
constexpr int kCopies = (2 * kRC * kVecs + kBlock - 1) / kBlock;
constexpr int kVStride = kOut * (kGA - 1) + kLoad; // a vertical-sum row
constexpr int kAStride = kGA * kOut;               // an α row
constexpr int kRawFloats = 2 * kRC * kRawStride;  // a chunk's x1, x2 rows
// three chunks' raw rows, so that H2 reads its output rows' x1 and x2
// (staged with the last chunk or this one) from shared memory
constexpr int kRawBufs = 3;
constexpr int kVFloats = 4 * kRC * kVStride;       // V1's sums, then V2's
constexpr int kSmemFloats =
    kRawBufs * kRawFloats + kVFloats + 3 * kRC * kAStride;
static_assert(kXE + 2 <= kRawStride && kXE <= kBlock, "a thread an x elem");
static_assert(kVStride >= kRawStride && kVStride % 4 == 0, "float4 rows");
static_assert(kBlock % kVecs == 0, "whole rows of copies a pass");
static_assert(kOutE % kOut == 0 && (kC * kTW) % 4 == 0, "float4 strips");
static_assert(kSmemFloats * 4 <= 227 * 1024, "smem");
static_assert(kRC >= 2 * kHalo, "H2's rows staged this chunk or the last");

struct Taps {
  float g[kWin];
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   vwfd::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   vwfd::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 12 adjacent outputs of one row of `src` (a row of vertical sums, the
// group's first output at element 0): Σ_k g[k]·src[o + 3k].
__device__ __forceinline__ void hsum12(const float* src, const Taps& taps,
                                       float* m) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float v[kLoad];
#pragma unroll
  for (int j = 0; j < kLoad / 4; ++j) {
    const float4 f = s4[j];
    v[4 * j + 0] = f.x;
    v[4 * j + 1] = f.y;
    v[4 * j + 2] = f.z;
    v[4 * j + 3] = f.w;
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) m[o] = taps.g[0] * v[o];
#pragma unroll
  for (int k = 1; k < kWin; ++k)
#pragma unroll
    for (int o = 0; o < kOut; ++o)
      m[o] = fmaf(taps.g[k], v[o + kC * k], m[o]);
}

// α, β, γ of the map at one value from its four window sums
__device__ __forceinline__ void map_grad(float mu1, float mu2, float sq,
                                         float xy, float& al, float& be,
                                         float& ga) {
  constexpr float c1 = (float)(0.01 * 0.01), c2 = (float)(0.03 * 0.03);
  const float mu12 = mu1 * mu2;
  const float msq = fmaf(mu1, mu1, mu2 * mu2);
  const float a1 = fmaf(2.f, mu12, c1);
  const float a2 = fmaf(2.f, xy - mu12, c2);
  const float rb1 = __fdividef(1.f, msq + c1);
  const float rb2 = __fdividef(1.f, (sq - msq) + c2);
  const float d = rb1 * rb2;
  const float s = a1 * a2 * d;
  al = 2.f * fmaf(mu2 * d, a2 - a1, mu1 * s * (rb2 - rb1));
  be = -s * rb2;
  ga = 2.f * a1 * d;
}

// grid (strips, segments, N); CTA (x, s, n) writes columns [kTW·x,
// kTW·x + kTW) and rows [rows·s, rows·s + rows) of image n. x1, x2, dx:
// (N, H, W, 3) float32; vec: W % 4 == 0 and the three bases 16-byte
// aligned.
__global__ void __launch_bounds__(kBlock, 1)
    ssim_grad_kernel(const float* __restrict__ x1,
                     const float* __restrict__ x2,
                     const float* __restrict__ scale,
                     const __grid_constant__ Taps taps,
                     float* __restrict__ dx, int H, int W, int rows,
                     int vec) {
  extern __shared__ float4 smem4[];
  // [kRawBufs][2][kRC][kRawStride]: chunk c's rows in buffer c % kRawBufs
  float* raw0 = reinterpret_cast<float*>(smem4);
  float* vs = raw0 + kRawBufs * kRawFloats;      // [4][kRC][kVStride]
  float* vb = vs;  // [3][kRC][kVStride]: V2's sums where V1's were
  float* ab = vs + kVFloats;                     // [3][kRC][kAStride]
  const int t = threadIdx.x;
  const int n = blockIdx.z, x0 = blockIdx.x * kTW;
  const int r0 = blockIdx.y * rows, r1 = min(H, r0 + rows);
  const int chunks = (r1 - r0 + 2 * kHalo + kRC - 1) / kRC;
  const long long row_elems = (long long)kC * W;
  const long long img = (long long)n * H * row_elems;
  const float* xi = x1 + img;
  const float* yi = x2 + img;

  // this thread's x-span element (pixel x0 − 10 + t/3, channel t%3)
  const long long e = (long long)kC * x0 - 2 * kC * kHalo + t;
  const bool col_in = t < kXE && e >= 0 && e < row_elems;

  // x rows r0 + kRC·c .. r0 + kRC·c + kRC − 1 of the span: kVecs 16-byte
  // copies a row from element 3·x0 − 32 (slot 0), each wholly inside or
  // outside the row (thread t copies vector t % kVecs of staged rows
  // t / kVecs + (kBlock / kVecs)·k, x1's rows then x2's); else one element
  // a thread
  const int vj = t % kVecs, vr = t / kVecs;
  const long long el = (long long)kC * x0 - 32 + 4 * vj;
  const bool el_in = el >= 0 && el < row_elems;
  auto stage = [&](int c) {
    const int y0 = r0 + kRC * c;
    float* raw = raw0 + (c % kRawBufs) * kRawFloats;
    if (vec) {
#pragma unroll
      for (int k = 0; k < kCopies; ++k) {
        const int rr = vr + k * (kBlock / kVecs);
        if (rr >= 2 * kRC) break;
        const int gy = y0 + (rr < kRC ? rr : rr - kRC);
        const bool ok = el_in && gy >= 0 && gy < H;
        const float* src = rr < kRC ? xi : yi;
        cp_async16(raw + rr * kRawStride + 4 * vj,
                   src + (ok ? gy * row_elems + el : 0), ok);
      }
    } else if (t < kXE) {
#pragma unroll
      for (int i = 0; i < kRC; ++i) {
        const int gy = y0 + i;
        const bool ok = col_in && gy >= 0 && gy < H;
        const long long off = ok ? gy * row_elems + e : 0;
        cp_async4(raw + i * kRawStride + t + 2, xi + off, ok);
        cp_async4(raw + (kRC + i) * kRawStride + t + 2, yi + off, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  float win2[3][kWin - 1];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int k = 0; k < kWin - 1; ++k) win2[q][k] = 0.f;
  stage(0);  // in flight while the window's first rows load
  // the products of x rows r0 − 10 .. r0 − 1: the window above α row
  // r0 − 5
  float win[4][kWin - 1];
#pragma unroll
  for (int k = 0; k < kWin - 1; ++k) {
    const int gy = r0 - 2 * kHalo + k;
    float a = 0.f, b = 0.f;
    if (col_in && gy >= 0 && gy < H) {
      a = __ldg(xi + gy * row_elems + e);
      b = __ldg(yi + gy * row_elems + e);
    }
    win[0][k] = a;
    win[1][k] = b;
    win[2][k] = fmaf(b, b, a * a);
    win[3][k] = a * b;
  }

  const float sn = scale[n];
  for (int c = 0; c < chunks; ++c) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // raw staged; the last chunk's vb read
    // V1: the forward's vertical sums of α rows r0 − 5 + kRC·c + i
    if (t < kXE && !(kCut & 1)) {
      const float* raw = raw0 + (c % kRawBufs) * kRawFloats;
#pragma unroll
      for (int i = 0; i < kRC; ++i) {
        const float a = raw[i * kRawStride + t + 2];
        const float b = raw[(kRC + i) * kRawStride + t + 2];
        const float cur[4] = {a, b, fmaf(b, b, a * a), a * b};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float m = taps.g[0] * win[q][0];
#pragma unroll
          for (int k = 1; k < kWin - 1; ++k)
            m = fmaf(taps.g[k], win[q][k], m);
          m = fmaf(taps.g[kWin - 1], cur[q], m);
          vs[(q * kRC + i) * kVStride + t] = m;
#pragma unroll
          for (int k = 0; k < kWin - 2; ++k) win[q][k] = win[q][k + 1];
          win[q][kWin - 2] = cur[q];
        }
      }
    }
    __syncthreads();  // vs written; raw read
    if (c + 1 < chunks) stage(c + 1);
    // H1: α, β, γ of α row r0 − 5 + kRC·c + i, span elements 12g ..
    // 12g + 11
    for (int task = t; task < kGA * kRC && !(kCut & 2);
         task += kBlock) {
      const int i = task / kGA, g = task % kGA;
      const int ar = r0 - kHalo + kRC * c + i;
      const bool row_in = ar >= 0 && ar < H;
      float m[4][kOut];
      if (row_in) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hsum12(vs + (q * kRC + i) * kVStride + kOut * g, taps, m[q]);
      }
      float4* al =
          reinterpret_cast<float4*>(ab + i * kAStride + kOut * g);
      float4* be = al + kRC * kAStride / 4;
      float4* ga = be + kRC * kAStride / 4;
      // the group's 4 pixels in the image (zero α, β, γ off it)
      const int p0 = x0 - kHalo + kOut * g / kC;
      bool pin[kOut / kC];
#pragma unroll
      for (int k = 0; k < kOut / kC; ++k)
        pin[k] = row_in && p0 + k >= 0 && p0 + k < W;
#pragma unroll
      for (int j = 0; j < kOut / 4; ++j) {
        float r[3][4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int u = 4 * j + w;
          const bool in = pin[u / kC] && kOut * g + u < kAE;
          map_grad(m[0][u], m[1][u], m[2][u], m[3][u], r[0][w], r[1][w],
                   r[2][w]);
#pragma unroll
          for (int q = 0; q < 3; ++q) r[q][w] = in ? r[q][w] : 0.f;
        }
        al[j] = make_float4(r[0][0], r[0][1], r[0][2], r[0][3]);
        be[j] = make_float4(r[1][0], r[1][1], r[1][2], r[1][3]);
        ga[j] = make_float4(r[2][0], r[2][1], r[2][2], r[2][3]);
      }
    }
    __syncthreads();  // ab written; vs read
    // V2: the transposed vertical sums of output row r0 − 10 + kRC·c
    // + i
    if (t < kAE && !(kCut & 4)) {
#pragma unroll
      for (int i = 0; i < kRC; ++i) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float cur = ab[(q * kRC + i) * kAStride + t];
          float m = taps.g[0] * win2[q][0];
#pragma unroll
          for (int k = 1; k < kWin - 1; ++k)
            m = fmaf(taps.g[k], win2[q][k], m);
          m = fmaf(taps.g[kWin - 1], cur, m);
          vb[(q * kRC + i) * kVStride + t] = m;
#pragma unroll
          for (int k = 0; k < kWin - 2; ++k) win2[q][k] = win2[q][k + 1];
          win2[q][kWin - 2] = cur;
        }
      }
    }
    __syncthreads();  // vb written
    // H2: dx of output row r0 − 10 + kRC·c + i, pixels x0 + 4g .. x0 +
    // 4g + 3
    for (int task = t; task < kGO * kRC && !(kCut & 8);
         task += kBlock) {
      const int i = task / kGO, g = task % kGO;
      const int o = r0 - 2 * kHalo + kRC * c + i;
      const int px = x0 + 4 * g;
      if (o >= r0 && o < r1 && px < W) {
        const long long off = o * row_elems + (long long)kC * px;
        const int valid = min(kOut, kC * (W - px));
        float m[3][kOut];
#pragma unroll
        for (int q = 0; q < 3; ++q)
          hsum12(vb + (q * kRC + i) * kVStride + kOut * g, taps, m[q]);
        // x1 and x2 at the outputs, staged: x row o is row d % kRC of chunk
        // d / kRC, d = o − r0 (this chunk's or the last)
        const int d = o - r0;
        const float* xs = raw0 + (d / kRC % kRawBufs) * kRawFloats +
                          (d % kRC) * kRawStride + 32 + kOut * g;
        if (vec && valid == kOut) {
          float4 a4[kOut / 4], b4[kOut / 4];
#pragma unroll
          for (int j = 0; j < kOut / 4; ++j) {
            a4[j] = reinterpret_cast<const float4*>(xs)[j];
            b4[j] = reinterpret_cast<const float4*>(xs + kRC * kRawStride)[j];
          }
          float4* d4 = reinterpret_cast<float4*>(dx + img + off);
#pragma unroll
          for (int j = 0; j < kOut / 4; ++j) {
            const float xa[4] = {a4[j].x, a4[j].y, a4[j].z, a4[j].w};
            const float xb[4] = {b4[j].x, b4[j].y, b4[j].z, b4[j].w};
            float r[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int k = 4 * j + u;
              r[u] = sn * ((m[0][k] + 2.f * xa[u] * m[1][k]) +
                           xb[u] * m[2][k]);
            }
            d4[j] = make_float4(r[0], r[1], r[2], r[3]);
          }
        } else {
          for (int k = 0; k < valid; ++k) {
            dx[img + off + k] =
                sn * ((m[0][k] + 2.f * xs[k] * m[1][k]) +
                      xs[kRC * kRawStride + k] * m[2][k]);
          }
        }
      }
    }
  }
}

}  // namespace

// x1, x2, dx: (N, H, W, 3) float32, contiguous; scale: float32 (N) on the
// device; taps: the 11 float32 weights of the 1-D window, in host memory;
// segments, rows: the row split of each image (rows = kRC·chunks − 10,
// segments·rows >= H > (segments − 1)·rows; kernels/ssim_grad.py plan).
extern "C" int vwfd_ssim_grad(const void* x1, const void* x2,
                              const void* scale, const float* taps, void* dx,
                              int N, int H, int W, int segments, int rows,
                              void* stream) {
  if ((long long)N * H * W == 0) return (int)cudaSuccess;
  if (N > 65535 || segments < 1 || segments > 65535 ||
      rows < 1 || (rows + 2 * kHalo) % kRC ||
      (long long)segments * rows < H || (long long)(segments - 1) * rows >= H)
    return (int)cudaErrorInvalidValue;
  const int smem = kSmemFloats * (int)sizeof(float);
  const cudaError_t rc = cudaFuncSetAttribute(
      ssim_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  Taps tp;
  for (int k = 0; k < kWin; ++k) tp.g[k] = taps[k];
  const int vec = (W % 4 == 0 && vwfd::aligned16({x1, x2, dx})) ? 1 : 0;
  const dim3 grid((W + kTW - 1) / kTW, segments, N);
  ssim_grad_kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x1), static_cast<const float*>(x2),
      static_cast<const float*>(scale), tp, static_cast<float*>(dx), H, W,
      rows, vec);
  return (int)cudaGetLastError();
}
