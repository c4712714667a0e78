// K19 `canny_soft`: the image family's differentiable edge map, forward and
// backward.
//
// Replaces vwfd_tpu/ops/canny.py::canny_soft (:39-72), which the image
// model's reverse pass applies, with its gradient, to every attacked copy
// (vwfd_tpu/models/image_model.py:362-364, :550). Per image of (N, H, W, 3)
// float32:
//   gray = x·(0.299, 0.587, 0.114)
//   smooth = 5×5 gaussian (σ = 1) of gray reflect-padded by 2
//   gx, gy = Sobel of smooth reflect-padded by 1
//   mag0 = sqrt(gx² + gy² + 1e-12), M = max over the image of mag0,
//   mag = mag0 / (M + 1e-12)
//   c, s = (gx, gy) / sqrt(gx² + gy² + 1e-8); the neighbours along ±(c, s)
//   of the zero-padded mag picked by c ≥ 0 and s ≥ 0, weighted by |c|, |s|
//   edge = mag·σ(20(mag − n1/d))·σ(20(mag − n2/d)), d = |c| + |s| + 1e-12
//   y = σ(20(edge − 0.1))·clip(edge / 0.2, 0, 1)
// Every sum is taken in the plain version's order (the JAX form), without
// FMA contraction but where XLA contracts (gray), so the forward is the
// plain version's up to the last bits of expf.
//
// Bound: bytes. At the image step's (48, 256, 256, 3) the forward reads x
// (37.7 MB) and writes y (12.6 MB), about 0.015 ms at 3.35 TB/s; the
// backward reads x's shape of nothing (the chain is linear up to mag0) but
// the cotangent (12.6 MB) and writes dx (37.7 MB); counted with x as the
// forward's input it is 88.1 MB, 0.026 ms. About 100 operations a pixel
// forward and 200 backward: bytes bound both.
//
// Design (a first version: simple, deterministic, above its bound). Forward,
// two launches: (1) a CTA per 32×32 tile stages the gray image of its ±3
// halo in shared memory (the reflect map applied to image coordinates, so
// that the edge tiles read the reflected values the plain version reads),
// the gaussian of its ±1 halo, then writes gx, gy and mag0 and takes the
// per-image max with atomicMax on the float's bits (mag0 ≥ 0; a NaN is
// given the largest bits, so that it wins as it does in torch.amax);
// (2) a thread a pixel computes the soft NMS and the threshold from mag0
// at the pixel and its four neighbours, gx, gy and M. Backward, four
// launches: (1) a thread a pixel recomputes (2) and writes the cotangent of
// mag at the pixel itself, the four cotangents it sends to its picked
// neighbours, and those of gx, gy through c and s; (2) a thread a pixel
// gathers its neighbours' cotangents (no atomics) and writes dmag, with
// per-CTA partials of Σ dmag·mag0 (the max's cotangent) and of the count of
// pixels tied at the max; (3) a CTA an image reduces its partials in a
// fixed order; (4) a CTA per 32×32 tile forms dgx, dgy on its ±3 halo
// (the max's cotangent shared evenly among the tied pixels, as jnp.max's
// and torch.amax's gradients are, and multiplied in everywhere so that a
// NaN reaches every pixel as it does there), the transposed Sobel with the
// reflected rows and columns folded back (±2 halo), the transposed
// gaussian with its folds, and gray's transpose into dx.
//
// The border (F24): gx on the first and last columns and gy on the first
// and last rows are identically 0 under the reflect pad (their taps read
// the same values twice with opposite signs). Their float32 values are the
// residue of cancelling sums, at a corner both are, so c, s and d there
// are rounding noise and the cotangents that reach gx, gy reach 1e9 and
// cancel in the pad's transpose, leaving noise of up to 2 % of the
// gradient's max in the plain version and in JAX. The kernel sends them
// nothing, the exact derivative; the plain version does the same with
// exact_border=True, which is what it is held to on the card.
#include "common.cuh"

namespace {

constexpr int kT = 32;          // outputs a tile side
constexpr int kG = kT + 6;      // gray / cotangent tile side: the ±3 halo
constexpr int kSm = kT + 2;     // forward smooth tile: the ±1 halo
constexpr int kDs = kT + 4;     // backward dsmooth tile: the ±2 halo
constexpr int kBlock = 256;
constexpr float kW0 = 0.299f, kW1 = 0.587f, kW2 = 0.114f;

struct Gauss {
  float k[25];  // the 5×5 σ = 1 gaussian, raster order
};

// numpy's reflect (the edge value not repeated), one reflection
__device__ __forceinline__ int refl(int t, int n) {
  return t < 0 ? -t : (t > n - 1 ? 2 * (n - 1) - t : t);
}

__device__ __forceinline__ float sigm(float a) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-a)));
}

// jnp.clip(v, 0, 1): NaN stays NaN
__device__ __forceinline__ float clip01(float v) {
  return v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
}

// XLA's CPU dot for img @ (0.299, 0.587, 0.114): a chain of fused
// multiply-adds, each rounded once (the plain version emulates it)
__device__ __forceinline__ float gray_of(const float* p) {
  return __fmaf_rn(p[2], kW2, __fmaf_rn(p[1], kW1, __fmul_rn(p[0], kW0)));
}

__device__ __forceinline__ float sq_sum(float gx, float gy, float eps) {
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), eps);
}

// ----------------------------------------------------------------- forward

__global__ void __launch_bounds__(kBlock)
canny_grad_kernel(const float* __restrict__ x, float* __restrict__ gx_out,
                  float* __restrict__ gy_out, float* __restrict__ mag0_out,
                  unsigned int* __restrict__ mbits, int H, int W, Gauss g) {
  __shared__ float gr[kG][kG + 1];
  __shared__ float sm[kSm][kSm + 1];
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * kT, c0 = blockIdx.x * kT;
  const float* xi = x + (size_t)n * H * W * 3;
  const int tid = threadIdx.x;
  // gray on image rows and columns [r0 − 3, r0 + kT + 3)
  for (int i = tid; i < kG * kG; i += kBlock) {
    const int rr = r0 - 3 + i / kG, cc = c0 - 3 + i % kG;
    float v = 0.f;
    if (rr >= 0 && rr < H && cc >= 0 && cc < W)
      v = gray_of(xi + ((size_t)rr * W + cc) * 3);
    gr[i / kG][i % kG] = v;
  }
  __syncthreads();
  // the gaussian at image rows and columns [r0 − 1, r0 + kT + 1) that lie
  // in the image: Σ k[u][v]·gray(refl(a+u−2), refl(b+v−2)), raster order
  for (int i = tid; i < kSm * kSm; i += kBlock) {
    const int a = r0 - 1 + i / kSm, b = c0 - 1 + i % kSm;
    float acc = 0.f;
    if (a >= 0 && a < H && b >= 0 && b < W) {
#pragma unroll
      for (int u = 0; u < 5; ++u) {
        const int gr_r = refl(a + u - 2, H) - (r0 - 3);
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          const int gr_c = refl(b + v - 2, W) - (c0 - 3);
          acc = __fadd_rn(acc, __fmul_rn(g.k[u * 5 + v], gr[gr_r][gr_c]));
        }
      }
    }
    sm[i / kSm][i % kSm] = acc;
  }
  __syncthreads();
  unsigned int best = 0u;
  for (int i = tid; i < kT * kT; i += kBlock) {
    const int r = r0 + i / kT, c = c0 + i % kT;
    if (r >= H || c >= W) continue;
    const int ru = refl(r - 1, H) - r0 + 1, rm = r - r0 + 1,
              rd = refl(r + 1, H) - r0 + 1;
    const int cl = refl(c - 1, W) - c0 + 1, cm = c - c0 + 1,
              cr = refl(c + 1, W) - c0 + 1;
    float gx = sm[ru][cr];
    gx = __fadd_rn(gx, __fmul_rn(2.f, sm[rm][cr]));
    gx = __fadd_rn(gx, sm[rd][cr]);
    gx = __fsub_rn(gx, sm[ru][cl]);
    gx = __fsub_rn(gx, __fmul_rn(2.f, sm[rm][cl]));
    gx = __fsub_rn(gx, sm[rd][cl]);
    float gy = sm[rd][cl];
    gy = __fadd_rn(gy, __fmul_rn(2.f, sm[rd][cm]));
    gy = __fadd_rn(gy, sm[rd][cr]);
    gy = __fsub_rn(gy, sm[ru][cl]);
    gy = __fsub_rn(gy, __fmul_rn(2.f, sm[ru][cm]));
    gy = __fsub_rn(gy, sm[ru][cr]);
    const float m0 = __fsqrt_rn(sq_sum(gx, gy, 1e-12f));
    const size_t o = ((size_t)n * H + r) * W + c;
    gx_out[o] = gx;
    gy_out[o] = gy;
    mag0_out[o] = m0;
    const unsigned int bits = isnan(m0) ? 0xffffffffu : __float_as_uint(m0);
    best = bits > best ? bits : best;
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if ((tid & 31) == 0) atomicMax(mbits + n, best);
}

// The soft NMS at one pixel: every forward quantity the backward needs.
struct Nms {
  float mag, c, s, gn, mr, ml, md, mu, a1, a2, b1, b2, n1, n2, d, s1, s2,
      keep, e;
};

__device__ __forceinline__ float max_value(unsigned int bits) {
  return bits == 0xffffffffu ? __uint_as_float(0x7fffffffu)
                             : __uint_as_float(bits);
}

__device__ __forceinline__ Nms nms_at(const float* __restrict__ mag0,
                                      size_t o, int r, int c, int H, int W,
                                      float D, float gx, float gy) {
  Nms q;
  q.mag = __fdiv_rn(mag0[o], D);
  q.mr = c + 1 < W ? __fdiv_rn(mag0[o + 1], D) : 0.f;
  q.ml = c > 0 ? __fdiv_rn(mag0[o - 1], D) : 0.f;
  q.md = r + 1 < H ? __fdiv_rn(mag0[o + W], D) : 0.f;
  q.mu = r > 0 ? __fdiv_rn(mag0[o - W], D) : 0.f;
  q.gn = __fsqrt_rn(sq_sum(gx, gy, 1e-8f));
  q.c = __fdiv_rn(gx, q.gn);
  q.s = __fdiv_rn(gy, q.gn);
  const bool cp = q.c >= 0.f, sp = q.s >= 0.f;
  q.a1 = cp ? q.mr : q.ml;
  q.a2 = cp ? q.ml : q.mr;
  q.b1 = sp ? q.md : q.mu;
  q.b2 = sp ? q.mu : q.md;
  const float ac = fabsf(q.c), as = fabsf(q.s);
  q.n1 = __fadd_rn(__fmul_rn(ac, q.a1), __fmul_rn(as, q.b1));
  q.n2 = __fadd_rn(__fmul_rn(ac, q.a2), __fmul_rn(as, q.b2));
  q.d = __fadd_rn(__fadd_rn(ac, as), 1e-12f);
  q.s1 = sigm(__fmul_rn(20.f, __fsub_rn(q.mag, __fdiv_rn(q.n1, q.d))));
  q.s2 = sigm(__fmul_rn(20.f, __fsub_rn(q.mag, __fdiv_rn(q.n2, q.d))));
  q.keep = __fmul_rn(q.s1, q.s2);
  q.e = __fmul_rn(q.mag, q.keep);
  return q;
}

__global__ void __launch_bounds__(kBlock)
canny_map_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                 const float* __restrict__ mag0,
                 const unsigned int* __restrict__ mbits,
                 float* __restrict__ y, int H, int W) {
  const int n = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= H * W) return;
  const int r = p / W, c = p % W;
  const size_t o = (size_t)n * H * W + p;
  const float D = __fadd_rn(max_value(mbits[n]), 1e-12f);
  const Nms q = nms_at(mag0, o, r, c, H, W, D, gx[o], gy[o]);
  const float s3 = sigm(__fmul_rn(20.f, __fsub_rn(q.e, 0.1f)));
  y[o] = __fmul_rn(s3, clip01(__fdiv_rn(q.e, 0.2f)));
}

// ---------------------------------------------------------------- backward

// planes of the backward's scratch, each N·H·W floats
enum Plane { kDmagLocal, kDAp, kDAm, kDBp, kDBm, kDgxC, kDgyC, kDmag,
             kPlanes };

__global__ void __launch_bounds__(kBlock)
canny_local_bwd_kernel(const float* __restrict__ gout,
                       const float* __restrict__ gx,
                       const float* __restrict__ gy,
                       const float* __restrict__ mag0,
                       const unsigned int* __restrict__ mbits,
                       float* __restrict__ scratch, int H, int W,
                       size_t plane) {
  const int n = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= H * W) return;
  const int r = p / W, c = p % W;
  const size_t o = (size_t)n * H * W + p;
  const float D = __fadd_rn(max_value(mbits[n]), 1e-12f);
  const float gxv = gx[o], gyv = gy[o];
  const Nms q = nms_at(mag0, o, r, c, H, W, D, gxv, gyv);
  const float g = gout[o];
  // y = σ3·clip(e/0.2): clip's derivative ½ where e/0.2 is exactly 0 or 1
  const float s3 = sigm(20.f * (q.e - 0.1f));
  const float t = q.e / 0.2f;
  const float qv = clip01(t);
  const float dclip = (t > 0.f && t < 1.f) ? 1.f
                      : ((t == 0.f || t == 1.f) ? 0.5f : 0.f);
  const float de = (g * qv) * (s3 * (1.f - s3)) * 20.f + (g * s3) * dclip / 0.2f;
  // e = mag·keep, keep = σ1·σ2, σi = σ(20(mag − ni/d))
  const float dkeep = de * q.mag;
  const float dt1 = dkeep * q.s2 * (q.s1 * (1.f - q.s1)) * 20.f;
  const float dt2 = dkeep * q.s1 * (q.s2 * (1.f - q.s2)) * 20.f;
  const float dmag_local = de * q.keep + dt1 + dt2;
  const float dn1 = -dt1 / q.d, dn2 = -dt2 / q.d;
  const float dd = dt1 * (q.n1 / q.d) / q.d + dt2 * (q.n2 / q.d) / q.d;
  const float ac = fabsf(q.c), as = fabsf(q.s);
  const float da1 = dn1 * ac, da2 = dn2 * ac, db1 = dn1 * as, db2 = dn2 * as;
  const float dac = dn1 * q.a1 + dn2 * q.a2 + dd;
  const float das = dn1 * q.b1 + dn2 * q.b2 + dd;
  // |·| with jnp.abs's gradient: +1 at 0 (and −1 at NaN, the plain
  // version's where(v ≥ 0, v, −v))
  const float sc = q.c >= 0.f ? 1.f : -1.f;
  const float ss = q.s >= 0.f ? 1.f : -1.f;
  const float dc = dac * sc, ds = das * ss;
  // c = gx/gn, s = gy/gn, gn = sqrt(gx² + gy² + 1e-8)
  const float dgn = -(dc * q.c + ds * q.s) / q.gn;
  const float dgx = dc / q.gn + dgn * (gxv / q.gn);
  const float dgy = ds / q.gn + dgn * (gyv / q.gn);
  const bool cp = q.c >= 0.f, sp = q.s >= 0.f;
  scratch[kDmagLocal * plane + o] = dmag_local;
  scratch[kDAp * plane + o] = cp ? da1 : da2;  // to (r, c + 1)
  scratch[kDAm * plane + o] = cp ? da2 : da1;  // to (r, c − 1)
  scratch[kDBp * plane + o] = sp ? db1 : db2;  // to (r + 1, c)
  scratch[kDBm * plane + o] = sp ? db2 : db1;  // to (r − 1, c)
  scratch[kDgxC * plane + o] = dgx;
  scratch[kDgyC * plane + o] = dgy;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = kBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kBlock)
canny_gather_bwd_kernel(const float* __restrict__ mag0,
                        const unsigned int* __restrict__ mbits,
                        float* __restrict__ scratch,
                        float* __restrict__ partials, int H, int W,
                        size_t plane) {
  __shared__ float red[kBlock];
  const int n = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  float sum = 0.f, ties = 0.f;
  if (p < H * W) {
    const int r = p / W, c = p % W;
    const size_t o = (size_t)n * H * W + p;
    float dm = scratch[kDmagLocal * plane + o];
    if (c > 0) dm += scratch[kDAp * plane + o - 1];
    if (c + 1 < W) dm += scratch[kDAm * plane + o + 1];
    if (r > 0) dm += scratch[kDBp * plane + o - W];
    if (r + 1 < H) dm += scratch[kDBm * plane + o + W];
    scratch[kDmag * plane + o] = dm;
    const float m0 = mag0[o];
    sum = dm * m0;
    ties = m0 == max_value(mbits[n]) ? 1.f : 0.f;
  }
  sum = block_sum(sum, red);
  ties = block_sum(ties, red);
  if (threadIdx.x == 0) {
    float* part = partials + 2 * ((size_t)n * gridDim.x + blockIdx.x);
    part[0] = sum;
    part[1] = ties;
  }
}

__global__ void __launch_bounds__(kBlock)
canny_reduce_bwd_kernel(const float* __restrict__ partials, int blocks,
                        float* __restrict__ totals) {
  __shared__ float red[kBlock];
  const int n = blockIdx.x;
  float sum = 0.f, ties = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kBlock) {
    sum += partials[2 * ((size_t)n * blocks + i)];
    ties += partials[2 * ((size_t)n * blocks + i) + 1];
  }
  sum = block_sum(sum, red);
  ties = block_sum(ties, red);
  if (threadIdx.x == 0) {
    totals[2 * n] = sum;
    totals[2 * n + 1] = ties;
  }
}

// the rows t ∈ [−pad, n − 1 + pad] that refl(·, n) maps onto a: a itself,
// −a above, 2(n − 1) − a below
__device__ __forceinline__ int preimages(int a, int n, int pad, int* t) {
  int k = 0;
  t[k++] = a;
  if (a > 0 && a <= pad) t[k++] = -a;
  if (a < n - 1 && a >= n - 1 - pad) t[k++] = 2 * (n - 1) - a;
  return k;
}

__global__ void __launch_bounds__(kBlock)
canny_input_bwd_kernel(const float* __restrict__ gx,
                       const float* __restrict__ gy,
                       const float* __restrict__ mag0,
                       const unsigned int* __restrict__ mbits,
                       const float* __restrict__ scratch,
                       const float* __restrict__ totals,
                       float* __restrict__ dx, int H, int W, size_t plane,
                       Gauss g) {
  __shared__ float dgx[kG][kG + 1];
  __shared__ float dgy[kG][kG + 1];
  __shared__ float dsm[kDs][kDs + 1];
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * kT, c0 = blockIdx.x * kT;
  const int tid = threadIdx.x;
  const float M = max_value(mbits[n]);
  const float D = __fadd_rn(M, 1e-12f);
  // the max's cotangent, −Σ dmag·mag0 / D², shared by the tied pixels
  const float share = (-totals[2 * n] / (D * D)) / totals[2 * n + 1];
  // dgx, dgy on image rows and columns [r0 − 3, r0 + kT + 3)
  for (int i = tid; i < kG * kG; i += kBlock) {
    const int rr = r0 - 3 + i / kG, cc = c0 - 3 + i % kG;
    float vx = 0.f, vy = 0.f;
    if (rr >= 0 && rr < H && cc >= 0 && cc < W) {
      const size_t o = ((size_t)n * H + rr) * W + cc;
      const float m0 = mag0[o];
      const float dm0 = scratch[kDmag * plane + o] / D
                        + share * (m0 == M ? 1.f : 0.f);
      // gx on the first and last columns and gy on the first and last
      // rows are identically 0 under the reflect pad: no gradient (F24)
      if (cc > 0 && cc < W - 1)
        vx = scratch[kDgxC * plane + o] + dm0 * (gx[o] / m0);
      if (rr > 0 && rr < H - 1)
        vy = scratch[kDgyC * plane + o] + dm0 * (gy[o] / m0);
    }
    dgx[i / kG][i % kG] = vx;
    dgy[i / kG][i % kG] = vy;
  }
  __syncthreads();
  // dsmooth on image rows and columns [r0 − 2, r0 + kT + 2): the Sobel
  // taps transposed, the reflect pad's rows and columns folded back
  for (int i = tid; i < kDs * kDs; i += kBlock) {
    const int a = r0 - 2 + i / kDs, b = c0 - 2 + i % kDs;
    float acc = 0.f;
    if (a >= 0 && a < H && b >= 0 && b < W) {
      int tr[3], tc[3];
      const int nr = preimages(a, H, 1, tr), nc = preimages(b, W, 1, tc);
      for (int ir = 0; ir < nr; ++ir)
        for (int ic = 0; ic < nc; ++ic)
#pragma unroll
          for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
            for (int dxo = -1; dxo <= 1; ++dxo) {
              // gx's tap at (dy, dxo): ±1 in the outer columns, ×2 in the
              // middle row; gy's the same with rows and columns swapped
              const float wx = (float)dxo * (dy == 0 ? 2.f : 1.f);
              const float wy = (float)dy * (dxo == 0 ? 2.f : 1.f);
              if (wx == 0.f && wy == 0.f) continue;
              const int pr = tr[ir] - dy, pc = tc[ic] - dxo;
              if (pr < 0 || pr >= H || pc < 0 || pc >= W) continue;
              const int lr = pr - (r0 - 3), lc = pc - (c0 - 3);
              acc += wx * dgx[lr][lc] + wy * dgy[lr][lc];
            }
    }
    dsm[i / kDs][i % kDs] = acc;
  }
  __syncthreads();
  // dgray on the tile: the gaussian's taps transposed with the pad-2 folds,
  // then gray's transpose
  for (int i = tid; i < kT * kT; i += kBlock) {
    const int a = r0 + i / kT, b = c0 + i % kT;
    if (a >= H || b >= W) continue;
    int tr[3], tc[3];
    const int nr = preimages(a, H, 2, tr), nc = preimages(b, W, 2, tc);
    float acc = 0.f;
    for (int ir = 0; ir < nr; ++ir)
      for (int ic = 0; ic < nc; ++ic)
#pragma unroll
        for (int u = 0; u < 5; ++u)
#pragma unroll
          for (int v = 0; v < 5; ++v) {
            const int pr = tr[ir] - u + 2, pc = tc[ic] - v + 2;
            if (pr < 0 || pr >= H || pc < 0 || pc >= W) continue;
            acc += g.k[u * 5 + v] * dsm[pr - (r0 - 2)][pc - (c0 - 2)];
          }
    float* d = dx + (((size_t)n * H + a) * W + b) * 3;
    d[0] = acc * kW0;
    d[1] = acc * kW1;
    d[2] = acc * kW2;
  }
}

}  // namespace

// x (N, H, W, 3) f32 contiguous, H, W ≥ 3; gx, gy, mag0 (N, H, W) f32 and
// mbits (N) uint32, zeroed by the caller, are written for the backward; y
// (N, H, W) f32. gauss: 25 host floats.
extern "C" int vwfd_canny_fwd(const void* x, void* gx, void* gy, void* mag0,
                              void* mbits, void* y, int N, int H, int W,
                              const float* gauss, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H < 3 || W < 3 || N < 1 || N > 65535)
    return (int)cudaErrorInvalidValue;
  Gauss g;
  for (int i = 0; i < 25; ++i) g.k[i] = gauss[i];
  const dim3 tiles((W + kT - 1) / kT, (H + kT - 1) / kT, N);
  canny_grad_kernel<<<tiles, kBlock, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(gx),
      static_cast<float*>(gy), static_cast<float*>(mag0),
      static_cast<unsigned int*>(mbits), H, W, g);
  const dim3 pixels((H * W + kBlock - 1) / kBlock, N);
  canny_map_kernel<<<pixels, kBlock, 0, s>>>(
      static_cast<const float*>(gx), static_cast<const float*>(gy),
      static_cast<const float*>(mag0),
      static_cast<const unsigned int*>(mbits), static_cast<float*>(y), H, W);
  return (int)cudaGetLastError();
}

// gout (N, H, W) f32; gx, gy, mag0, mbits the forward's; scratch 8·N·H·W
// f32; partials 2·N·ceil(H·W/256) f32; totals 2·N f32; dx (N, H, W, 3).
extern "C" int vwfd_canny_bwd(const void* gout, const void* gx,
                              const void* gy, const void* mag0,
                              const void* mbits, void* scratch,
                              void* partials, void* totals, void* dx, int N,
                              int H, int W, const float* gauss,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H < 3 || W < 3 || N < 1 || N > 65535)
    return (int)cudaErrorInvalidValue;
  Gauss g;
  for (int i = 0; i < 25; ++i) g.k[i] = gauss[i];
  const size_t plane = (size_t)N * H * W;
  const int blocks = (H * W + kBlock - 1) / kBlock;
  const dim3 pixels(blocks, N);
  const unsigned int* mb = static_cast<const unsigned int*>(mbits);
  float* sc = static_cast<float*>(scratch);
  canny_local_bwd_kernel<<<pixels, kBlock, 0, s>>>(
      static_cast<const float*>(gout), static_cast<const float*>(gx),
      static_cast<const float*>(gy), static_cast<const float*>(mag0), mb,
      sc, H, W, plane);
  canny_gather_bwd_kernel<<<pixels, kBlock, 0, s>>>(
      static_cast<const float*>(mag0), mb, sc,
      static_cast<float*>(partials), H, W, plane);
  canny_reduce_bwd_kernel<<<N, kBlock, 0, s>>>(
      static_cast<const float*>(partials), blocks,
      static_cast<float*>(totals));
  const dim3 tiles((W + kT - 1) / kT, (H + kT - 1) / kT, N);
  canny_input_bwd_kernel<<<tiles, kBlock, 0, s>>>(
      static_cast<const float*>(gx), static_cast<const float*>(gy),
      static_cast<const float*>(mag0), mb, sc,
      static_cast<const float*>(totals), static_cast<float*>(dx), H, W,
      plane, g);
  return (int)cudaGetLastError();
}
