// K21 `rectify`: CLR's scale-back rectification before the reverse pass,
// forward and backward.
//
// Replaces vwfd_tpu/attacks/spatial.py::rectify_crop_pad (:191-201) with
// its bicubic paste_resize (:149-174), as the port's image model calls it
// (vwfd_tpu_torch/models/image_model.py:429 in the train step, :535 in the
// eval step). For attacked copy m (of M) and its clean image clean[m mod B]:
//   ideal  = clean·inside
//   paste  = clip(P(attacked), 0, 1)·inside
//   out    = ideal + (paste − ideal)          (the value of JAX's
//            ideal + stop_gradient(paste − ideal))
// where inside is 1 in the window [h0, h1) × [w0, w1) and P resamples the
// full-size copy back to the window at its place: output row i reads
// source row ((i − h0) + ½)·H/(h1 − h0) − ½ (columns likewise), four
// bicubic taps clamped to the image (cubic.cuh), rows first, then columns,
// each product and sum one IEEE rounding in the plain version's order: the
// output EQUALS the plain version's. The clip keeps NaN (jnp.clip's
// maximum and minimum propagate it), and the window enters as products
// and sums, never as a branch, so an Inf or NaN attacked pixel reaches the
// outputs it reaches in JAX (outside the window too, where P is computed
// and multiplied by 0). The backward is the transpose of JAX's tile:
// dclean[b] = Σ_r g[r·B + b]·inside, r ascending, no gradient into the
// attacked copies.
//
// Bound: bytes. At CLR's train step (48 copies of 256² RGB against 8 clean
// images, f32) the forward reads attacked (37.7 MB) and clean (6.3 MB) and
// writes 37.7 MB: about 24 µs at 3.35 TB/s; the backward reads g (37.7
// MB) and writes dclean (6.3 MB): about 13 µs.
//
// Design. The forward is separable, and bit-identical to the plain
// version's order by construction: the plain version forms, for each of
// an output pixel's four column taps q, the row sum Σ_k wy[k]·x[r_k, q]
// before the column sum, and that row sum depends on the output row and q
// alone. A CTA takes one copy and a band of output rows, every column and
// channel, each image row one contiguous run of W·C floats:
// - the row pass reads the four source rows of the output row's taps,
//   consecutive threads on consecutive floats (float4 when W·C % 4 == 0
//   and the bases are 16-byte aligned, else one float a thread), and
//   writes the W·C row sums R to shared memory once (4 products and 3 sums
//   a value, not the 16 and 12 of a thread that redoes the row pass for
//   each column tap); source rows that neighbouring output rows share come
//   from L1 and L2;
// - the column pass, a thread per output pixel, reads its four column taps'
//   R values from shared memory and writes clip(·)·inside to a second row
//   P in shared memory; the column taps of a thread's first two pixels
//   stay in registers for the band (computed once per CTA), the row taps
//   of the band sit in shared memory (computed once per row);
// - the combine reads P and the clean row, forms ideal + (paste − ideal)
//   and writes the output row, coalesced like the row pass; it runs in
//   the next row's row-pass phase.
// Two barriers a row. Where a row is float4s and at most 512 of them (the
// CLR shapes), each thread issues its loads of the next row (four source
// rows, the clean row) right after the first barrier, into registers, so
// that they travel while the column pass runs; 4 CTAs of 256 threads an
// SM (64 registers), 3 where a row holds over 256 float4s. Elsewhere the
// loads are issued in the phase that uses them. The backward is a thread
// per float4 of dclean (one per float where the vector path does not
// hold) summing the copies' products in a fixed order: no atomics,
// bit-identical over calls, and a NaN or Inf cotangent outside the window
// gives NaN where g·inside does.
#include "cubic.cuh"

namespace {

using vwfd::Cubic;
using vwfd::cubic_sum;
using vwfd::cubic_taps;
using vwfd::paste_pos;

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // CTAs an SM: 64 registers a thread
#ifndef VWFD_RECT_PREFETCH
#define VWFD_RECT_PREFETCH 1  // 0: the loads in the phase that uses them
#endif
#ifndef VWFD_RECT_CUT
#define VWFD_RECT_CUT 0
#endif
// phases cut out for timing (port_tools/ablate_clr_kernels.py): 1 the
// column pass, 2 the row pass's loads, 4 the combine (outputs wrong)
constexpr int kCut = VWFD_RECT_CUT;
constexpr int kCachedPix = 2;  // column taps held in registers: j = t, t+256
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float clip01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.f), 1.f);
}

__device__ __forceinline__ float in_window(float v, float lo, float hi) {
  return (v >= lo && v < hi) ? 1.f : 0.f;
}

// ideal + (paste − ideal), ideal = clean·inside (paste holds clip·inside)
__device__ __forceinline__ float combine(float paste, float cl, float in) {
  const float ideal = __fmul_rn(cl, in);
  return __fadd_rn(ideal, __fsub_rn(paste, ideal));
}

// The four taps' row sums of channel c of pixel j, summed over the columns
// (the plain version's column pass), clipped and windowed.
__device__ __forceinline__ void paste_pixel(const float* R, float* P, int j,
                                            int C, const Cubic& cx,
                                            float inside) {
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float v[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) v[a] = R[cx.i[a] * C + c];
    P[j * C + c] = __fmul_rn(clip01(cubic_sum(v, cx.w)), inside);
  }
}

// grid (bands, M); a CTA takes output rows [band·blockIdx.x,
// band·blockIdx.x + band) of copy blockIdx.y, one row a step. Dynamic
// shared memory: the band's row taps (32 B each), then R and P (W·C floats
// each, rounded up to whole float4s). PRE > 0: the float4 path with a row
// of at most PRE·kThreads float4s, each thread's loads of the next row
// issued before the column pass of this one (registers: PRE float4s of
// four source rows and of the clean row); PRE = 0: the loads in the phase
// that uses them, any row.
template <int CT, int PRE>
__global__ void __launch_bounds__(kThreads, PRE > 1 ? 3 : kMinBlocks)
    rectify_kernel(const float* __restrict__ att,
                   const float* __restrict__ clean,
                   const float* __restrict__ apex, float* __restrict__ out,
                   int B, int H, int W, int c_arg, int band, int vec) {
  const int C = CT > 0 ? CT : c_arg;
  const int WC = W * C;
  const int WC4 = (WC + 3) / 4;
  extern __shared__ float4 smem4[];
  Cubic* rtap = reinterpret_cast<Cubic*>(smem4);  // [band]
  float* R = reinterpret_cast<float*>(smem4 + 2 * band);
  float* P = R + 4 * WC4;
  const int t = threadIdx.x;
  const int m = blockIdx.y;
  const int i0 = blockIdx.x * band, i1 = min(H, i0 + band);
  const float h0 = apex[0], h1 = apex[1], w0 = apex[2], w1 = apex[3];
  const long long plane = (long long)H * WC;
  const float* an = att + (long long)m * plane;
  const float* cl = clean + (long long)(m % B) * plane;
  float* on = out + (long long)m * plane;

  for (int r = t; r < i1 - i0; r += kThreads)
    rtap[r] = cubic_taps(paste_pos(i0 + r, H, h0, h1), 0, H - 1);
  Cubic cx[kCachedPix];
  float cin[kCachedPix];
#pragma unroll
  for (int k = 0; k < kCachedPix; ++k) {
    const int j = t + k * kThreads;
    cx[k] = cubic_taps(paste_pos(min(j, W - 1), W, w0, w1), 0, W - 1);
    cin[k] = in_window((float)j, w0, w1);
  }
  __syncthreads();

  // column pass of row i: R → P
  auto column_pass = [&](int i) {
    if (kCut & 1) return;
    const float rin = in_window((float)i, h0, h1);
#pragma unroll
    for (int k = 0; k < kCachedPix; ++k) {
      const int j = t + k * kThreads;
      if (j < W) paste_pixel(R, P, j, C, cx[k], rin * cin[k]);
    }
    for (int j = t + kCachedPix * kThreads; j < W; j += kThreads)
      paste_pixel(R, P, j, C, cubic_taps(paste_pos(j, W, w0, w1), 0, W - 1),
                  rin * in_window((float)j, w0, w1));
  };
  // the combine of one float4 of row i: P and the clean row → out
  auto combine4 = [&](int i, int v, float4 q) {
    const float rin = in_window((float)i, h0, h1);
    const float4 p = reinterpret_cast<const float4*>(P)[v];
    const int e = 4 * v;
    auto in = [&](int u) {
      return rin * in_window((float)((e + u) / C), w0, w1);
    };
    reinterpret_cast<float4*>(on + (long long)i * WC)[v] = make_float4(
        combine(p.x, q.x, in(0)), combine(p.y, q.y, in(1)),
        combine(p.z, q.z, in(2)), combine(p.w, q.w, in(3)));
  };
  // the row pass of one float4: four source rows' values → R
  auto rowsum4 = [&](int v, const float4* a, const float* w) {
    const float vx[4] = {a[0].x, a[1].x, a[2].x, a[3].x};
    const float vy[4] = {a[0].y, a[1].y, a[2].y, a[3].y};
    const float vz[4] = {a[0].z, a[1].z, a[2].z, a[3].z};
    const float vw[4] = {a[0].w, a[1].w, a[2].w, a[3].w};
    reinterpret_cast<float4*>(R)[v] =
        make_float4(cubic_sum(vx, w), cubic_sum(vy, w), cubic_sum(vz, w),
                    cubic_sum(vw, w));
  };

  if constexpr (PRE > 0) {
    float4 src[PRE][4], cq[PRE];
    float wy[4];
    // source rows of output row i → src (and its weights → wy)
    auto load_rows = [&](int i) {
      const Cubic ry = rtap[i - i0];
#pragma unroll
      for (int k = 0; k < 4; ++k) wy[k] = ry.w[k];
#pragma unroll
      for (int u = 0; u < PRE; ++u) {
        const int v = t + u * kThreads;
        if (v >= WC4) break;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          src[u][k] = (kCut & 2) ? make_float4(0.f, 0.f, 0.f, 0.f)
                                 : __ldg(reinterpret_cast<const float4*>(
                                             an + (long long)ry.i[k] * WC) +
                                         v);
      }
    };
    if (i0 < i1) load_rows(i0);
    for (int i = i0; i <= i1; ++i) {
      // row pass of row i from the registers, combine of row i − 1
#pragma unroll
      for (int u = 0; u < PRE; ++u) {
        const int v = t + u * kThreads;
        if (v >= WC4) break;
        if (i < i1) rowsum4(v, src[u], wy);
        if (i > i0 && !(kCut & 4)) combine4(i - 1, v, cq[u]);
      }
      __syncthreads();  // R of row i written; P of row i − 1 read
      if (i + 1 < i1) load_rows(i + 1);
#pragma unroll
      for (int u = 0; u < PRE; ++u) {
        const int v = t + u * kThreads;
        if (i < i1 && v < WC4 && !(kCut & 4))
          cq[u] = __ldg(reinterpret_cast<const float4*>(
                            cl + (long long)i * WC) + v);
      }
      if (i < i1) column_pass(i);
      __syncthreads();  // P of row i written; R of row i read
    }
  } else {
    for (int i = i0; i <= i1; ++i) {
      // combine of row i − 1 and row pass of row i in one loop: both rows'
      // loads in flight
      const bool do_c = i > i0 && !(kCut & 4), do_r = i < i1;
      const long long crow = (long long)(i - 1) * WC;
      const Cubic ry = rtap[do_r ? i - i0 : 0];
      const float* s[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) s[k] = an + (long long)ry.i[k] * WC;
      if (vec) {
        for (int v = t; v < WC4; v += kThreads) {
          float4 a[4], q = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            a[k] = do_r && !(kCut & 2)
                       ? __ldg(reinterpret_cast<const float4*>(s[k]) + v)
                       : q;
          if (do_c) q = __ldg(reinterpret_cast<const float4*>(cl + crow) + v);
          if (do_r) rowsum4(v, a, ry.w);
          if (do_c) combine4(i - 1, v, q);
        }
      } else {
        const float rin = in_window((float)(i - 1), h0, h1);
        for (int e = t; e < WC; e += kThreads) {
          if (do_r) {
            const float v[4] = {__ldg(s[0] + e), __ldg(s[1] + e),
                                __ldg(s[2] + e), __ldg(s[3] + e)};
            R[e] = cubic_sum(v, ry.w);
          }
          if (do_c)
            on[crow + e] = combine(P[e], __ldg(cl + crow + e),
                                   rin * in_window((float)(e / C), w0, w1));
        }
      }
      __syncthreads();  // R of row i written; P of row i − 1 read
      if (i < i1) column_pass(i);
      __syncthreads();  // P of row i written; R of row i read
    }
  }
}

// dclean[b] = Σ_r g[r·B + b]·inside: a thread per float4 of dclean (vec)
// or per float.
template <int CT>
__global__ void __launch_bounds__(kThreads)
    rectify_bwd_kernel(const float* __restrict__ g,
                       const float* __restrict__ apex,
                       float* __restrict__ dclean, int reps, int B, int H,
                       int W, int c_arg, int vec) {
  const int C = CT > 0 ? CT : c_arg;
  const long long WC = (long long)W * C;
  const long long n = (long long)B * H * WC;  // clean elements
  const int per = vec ? 4 : 1;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx * per >= n) return;
  const float h0 = apex[0], h1 = apex[1], w0 = apex[2], w1 = apex[3];
  const long long e0 = idx * per;
  const long long row = e0 / WC;
  const int col = (int)(e0 - row * WC);
  const float rin = in_window((float)(row % H), h0, h1);
  if (vec) {
    float in[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      in[u] = rin * in_window((float)((col + u) / C), w0, w1);
    const float4* g4 = reinterpret_cast<const float4*>(g) + idx;
    const long long step = n / 4;
    float4 acc = __ldg(g4);
    acc = make_float4(__fmul_rn(acc.x, in[0]), __fmul_rn(acc.y, in[1]),
                      __fmul_rn(acc.z, in[2]), __fmul_rn(acc.w, in[3]));
#pragma unroll 8
    for (int r = 1; r < reps; ++r) {
      const float4 v = __ldg(g4 + r * step);
      acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, in[0]));
      acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, in[1]));
      acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, in[2]));
      acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, in[3]));
    }
    reinterpret_cast<float4*>(dclean)[idx] = acc;
  } else {
    const float in = rin * in_window((float)(col / C), w0, w1);
    float acc = __fmul_rn(__ldg(g + e0), in);
#pragma unroll 8
    for (int r = 1; r < reps; ++r)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(g + r * n + e0), in));
    dclean[e0] = acc;
  }
}

int smem_bytes(int band, int W, int C) {
  return 32 * band + 2 * 16 * ((W * C + 3) / 4);
}

}  // namespace

// attacked, out: (M, H, W, C) float32; clean: (B, H, W, C); apex: (4,)
// float32 on the device; band: output rows a CTA (kernels/rectify.py
// plan).
extern "C" int vwfd_rectify(const void* attacked, const void* clean,
                            const void* apex, void* out, int M, int B, int H,
                            int W, int C, int band, void* stream) {
  if ((long long)M * H * W == 0 || C == 0) return (int)cudaSuccess;
  if (B < 1 || M % B || band < 1 || M > 65535 || (long long)W * C > (1 << 24))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(band, W, C);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int vec =
      (W * C) % 4 == 0 && vwfd::aligned16({attacked, clean, out}) ? 1 : 0;
  const dim3 grid((H + band - 1) / band, M);
  const int WC4 = (W * C + 3) / 4;
  auto kernel = C != 3                        ? rectify_kernel<0, 0>
                : !vec || WC4 > 2 * kThreads ||
                        !VWFD_RECT_PREFETCH  ? rectify_kernel<3, 0>
                : WC4 > kThreads             ? rectify_kernel<3, 2>
                                             : rectify_kernel<3, 1>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(attacked), static_cast<const float*>(clean),
      static_cast<const float*>(apex), static_cast<float*>(out), B, H, W, C,
      band, vec);
  return (int)cudaGetLastError();
}

// g: (reps·B, H, W, C) float32; dclean: (B, H, W, C).
extern "C" int vwfd_rectify_bwd(const void* g, const void* apex,
                                void* dclean, int reps, int B, int H, int W,
                                int C, void* stream) {
  const long long n = (long long)B * H * W * C;
  if (n == 0) return (int)cudaSuccess;
  if (reps < 1) return (int)cudaErrorInvalidValue;
  const int vec = (W * C) % 4 == 0 && vwfd::aligned16({g, dclean}) ? 1 : 0;
  const long long threads = vec ? n / 4 : n;
  const long long grid = (threads + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const float*>(g);
  const auto* ap = static_cast<const float*>(apex);
  auto* d = static_cast<float*>(dclean);
  if (C == 3)
    rectify_bwd_kernel<3><<<(unsigned int)grid, kThreads, 0, st>>>(
        gp, ap, d, reps, B, H, W, C, vec);
  else
    rectify_bwd_kernel<0><<<(unsigned int)grid, kThreads, 0, st>>>(
        gp, ap, d, reps, B, H, W, C, vec);
  return (int)cudaGetLastError();
}
