// K18 window_attention: SUNet's shifted-window attention, forward and
// backward, second version (kernels/window_attention.py has the plain
// version and the design notes).
//
// qkv is the qkv Dense's output on the map, (B, Hm, Wm, 3, H, D): no roll,
// no window partition. Window (b, wy, wx) of ws x ws tokens, token
// n = (r, c), is read from and written to map position
//
//   ((wy ws + r + shift) mod Hm, (wx ws + c + shift) mod Wm),
//
// which is where the JAX block's roll by -shift, window_partition,
// window_reverse and roll back put it. Per (window, head) problem, with
// q, k, v (N x D, N = ws^2):
//
//   S = q k^T * scale + B[idx] (+ M),   P = softmax_rows(S),   O = P v
//
// written at the tokens' own map positions, (B, Hm, Wm, H * D). B is the
// (2 ws - 1)^2 x H relative-position table gathered through idx(i, j) =
// (ri - rj + ws - 1)(2 ws - 1) + ci - cj + ws - 1; M, for a shifted block,
// is -100 where the two tokens' positions in the rolled map lie in
// different regions (3 x 3 regions: rows [0, Hm - ws), [Hm - ws, Hm -
// shift), [Hm - shift, Hm), columns alike). The backward recomputes S and
// P, then
//
//   dP = dO v^T,  dS = P (dP - rowsum(P dP)),  dV = P^T dO,
//   dQ = scale dS k,  dK = scale dS^T q,  dB[r] = sum of dS over idx = r
//
// and writes dQ, dK, dV in the qkv layout.
//
// Bound: bytes (q, k, v and dO read once, out or dqkv written once).
// Common to both kernel families below:
// * Products to float32 accuracy on the tensor cores (3xTF32): every
//   operand x is split as hi = tf32_rna(x), lo = tf32_rna(x - hi), lo
//   being 0 where hi is not finite, and hi.hi + hi.lo + lo.hi is summed in
//   float32 accumulators (lo.lo dropped).
// * Persistent CTAs of one warpgroup, as many as the card holds; problems
//   ordered head by head, window by window; CTA c takes the fixed run
//   [c P / G, (c + 1) P / G). The CTA splits each problem's operands once,
//   for all four warps; one warp holds 16 query rows (N padded to 64, or
//   to a multiple of 16: padded columns are -inf, padded rows zeros that
//   are never stored), S, P, dP and dS in its registers.
// * The table's gradient without float atomics: each CTA sums dS over its
//   problems of one head in registers, in its fixed order; where the head
//   changes and at its end it bins that sum ((2 ws - 1)^2 bins, fixed
//   order) into one scratch row (H, G, bins). The last CTA to finish a
//   head (an integer ticket) sums that head's rows in CTA order: one
//   launch, and two calls give the same bits.
// d = 32, the main path (namespace tc): wgmma m64nNk8 .tf32 with the
// operands in the 128-byte swizzle, q, k, v (dO) copied by cp.async into
// their raw tiles, each region taking the next problem's copies once the
// current one is done with it (tc:: has the details). d = 16 and 64:
// mma.sync.m16n8k8 .tf32 from XOR-swizzled split tiles, the next problem
// staged while the current one computes; there the cross terms take hi as
// 0 where it is not finite.
#include "common.cuh"

namespace {

constexpr int kThr = 128;        // four warps
constexpr int kMaxN = 64;        // ws <= 8
constexpr int kMaxBins = 225;    // (2 * 8 - 1)^2
constexpr int kBinsPad = 228;    // keeps the arrays after it 16-byte aligned
static_assert(kBinsPad >= kMaxBins && kBinsPad % 4 == 0, "table column");
constexpr int kLP = kMaxN + 12;  // P / dS tile row stride: float2 stores and
                                 // the transposed fragment reads both free
                                 // of bank conflicts

// An N x D tile: rows of D floats, each row's 16-byte chunks permuted by
// an XOR with the row's low bits, so that the fragment reads (a quad's
// four columns of eight rows, or eight columns of a quad's rows 2t) and the
// 16-byte copies are free of bank conflicts without padding.
template <int D>
struct Tile {
  static constexpr int kFloats = kMaxN * D;
  static constexpr int kSw = (D / 4 < 8 ? D / 4 : 8) - 1;
};
// offset of (row, col) in a tile; r7 = row & 7
template <int D>
__device__ __forceinline__ int sw(int row, int col, int r7) {
  return row * D + (((col >> 2) ^ (r7 & Tile<D>::kSw)) << 2) + (col & 3);
}

// Shared memory of a CTA: a working set and a staging set.
// * Staging: the copies of the next problem land here as they arrive (NT
//   tiles: q, k, v, and dO in the backward; the head's table column, each
//   token's map row and its (bias coordinate << 4 | region)).
// * Working: each tile split into its hi part and, kT floats on, its lo
//   part, and the small arrays, copied from staging. The backward's P / dS
//   tile lies over v and what follows it: v is done with once dP = dO v^T
//   is.
template <int D, int NT>
struct Smem {
  static constexpr int kT = Tile<D>::kFloats;
  static constexpr int kQ = 0, kK = 2 * kT, kG = 4 * kT;
  static constexpr int kRow = 6 * kT;
  static constexpr int kV = NT == 3 ? 4 * kT : kRow + kMaxN;
  static constexpr int kB = NT == 3 ? kRow + kMaxN : kV + 2 * kT;
  static constexpr int kInfo = kB + kBinsPad;
  static constexpr int kP = kV;
  static constexpr int kWork =
      NT == 4 && kP + kMaxN * kLP > kInfo + kMaxN ? kP + kMaxN * kLP
                                                  : kInfo + kMaxN;
  static constexpr int kS = (kWork + 3) / 4 * 4;  // staging tiles
  static constexpr int kSRow = kS + NT * kT, kSB = kSRow + kMaxN;
  static constexpr int kSInfo = kSB + kBinsPad;
  static constexpr int kBytes = 4 * (kSInfo + kMaxN);
  // working offset of tile s (0 q, 1 k, 2 v, 3 dO)
  static __device__ __forceinline__ int work(int s) {
    return s == 0 ? kQ : s == 1 ? kK : s == 2 ? kV : kG;
  }
};

struct Geo {
  int Hm, Wm, ws, shift, H, N, NP, nWw, nWin, W, P, nb, G, off;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   vwfd::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   vwfd::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 3xTF32 operand: hi, lo (0 where hi is not finite), and hi where finite
// (0 elsewhere) for the mma.sync kernels' cross terms.
struct Op {
  uint32_t hi, lo, hf;
};
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ bool finite_bits(uint32_t h) {
  return (h & 0x7f800000u) != 0x7f800000u;
}
__device__ __forceinline__ Op split(float x) {
  const uint32_t h = tf32(x);
  const uint32_t l = tf32(x - __uint_as_float(h));
  const bool fin = finite_bits(h);
  return {h, fin ? l : 0u, fin ? h : 0u};
}
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// a b to float32 accuracy: hi.hi into c, the cross terms into x (summed
// into c once the product is done: two independent chains)
__device__ __forceinline__ void mma3(float (&c)[4], float (&x)[4],
                                     const Op (&a)[4], const Op (&b)[2]) {
  mma(x, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hf, b[1].hf);
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
  mma(x, a[0].hf, a[1].hf, a[2].hf, a[3].hf, b[0].lo, b[1].lo);
}

template <int M>
__device__ __forceinline__ void zero(float (&c)[M][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int k = 0; k < 4; ++k) c[m][k] = 0.f;
}
template <int M>
__device__ __forceinline__ void fold(float (&c)[M][4], const float (&x)[M][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int k = 0; k < 4; ++k) c[m][k] += x[m][k];
}

// Element i of a split tile: the hi part at i, the lo part kT floats on
template <int D>
__device__ __forceinline__ Op top(const float* hi, int i) {
  const uint32_t h = __float_as_uint(hi[i]);
  const uint32_t l = __float_as_uint(hi[i + Tile<D>::kFloats]);
  return {h, l, finite_bits(h) ? h : 0u};
}

// C[16 x NP] = A[i0 .. i0 + 16) B^T, A and B split row-major N x D tiles
template <int D>
__device__ __forceinline__ void nt_product(const float* A, const float* B,
                                           float (&c)[8][4], int NP, int i0,
                                           int g, int t) {
  float x[8][4];
  zero(c);
  zero(x);
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const int c0 = sw<D>(0, ks * 8 + t, g), c1 = sw<D>(0, ks * 8 + 4 + t, g);
    const int ia = (i0 + g) * D;
    const Op af[4] = {top<D>(A, ia + c0), top<D>(A, ia + 8 * D + c0),
                      top<D>(A, ia + c1),
                      top<D>(A, ia + 8 * D + c1)};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      if (nb * 8 >= NP) break;
      const int ib = (nb * 8 + g) * D;
      const Op bf[2] = {top<D>(B, ib + c0), top<D>(B, ib + c1)};
      mma3(c[nb], x[nb], af, bf);
    }
  }
  fold(c, x);
}

// C[16 x D] = P X, P a warp's 16 x NP C fragments (k permuted), X a split
// row-major N x D tile
template <int D>
__device__ __forceinline__ void pv_product(const float (&p)[8][4],
                                           const float* X, float (&c)[D / 8][4],
                                           int NP, int g, int t) {
  float x[D / 8][4];
  zero(c);
  zero(x);
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    if (kb * 8 >= NP) break;
    const Op af[4] = {split(p[kb][0]), split(p[kb][2]),
                      split(p[kb][1]), split(p[kb][3])};
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int ib = (kb * 8 + 2 * t) * D;
      const Op bf[2] = {top<D>(X, ib + sw<D>(0, nd * 8 + g, 2 * t)),
                        top<D>(X, ib + D + sw<D>(0, nd * 8 + g,
                                                     2 * t + 1))};
      mma3(c[nd], x[nd], af, bf);
    }
  }
  fold(c, x);
}

// C[16 x D] = T^T X for the 16 columns j0 .. j0 + 16 of T, T an NP x NP
// tile (row stride kLP, not split) in shared memory, X a split row-major
// N x D tile
template <int D>
__device__ __forceinline__ void tn_product(const float* T, const float* X,
                                           float (&c)[D / 8][4], int NP,
                                           int j0, int g, int t) {
  float x[D / 8][4];
  zero(c);
  zero(x);
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    if (kb * 8 >= NP) break;
    const float* a = T + (kb * 8 + 2 * t) * kLP + j0 + g;
    const Op af[4] = {split(a[0]), split(a[8]), split(a[kLP]),
                      split(a[kLP + 8])};
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int ib = (kb * 8 + 2 * t) * D;
      const Op bf[2] = {top<D>(X, ib + sw<D>(0, nd * 8 + g, 2 * t)),
                        top<D>(X, ib + D + sw<D>(0, nd * 8 + g,
                                                     2 * t + 1))};
      mma3(c[nd], x[nd], af, bf);
    }
  }
  fold(c, x);
}
// S fragments -> P: scale, bias (sB offset so that sB[u_i - u_j] is row
// idx(i, j)), mask, softmax over the row (a quad holds a row). Columns
// past N are -inf (weight 0). A NaN in a row makes the row's sum, and so
// the row, NaN.
__device__ __forceinline__ void softmax_rows(float (&s)[8][4],
                                             const float* sB, const int* info,
                                             const Geo& g, int i0, int gi,
                                             int t) {
  const int ra = min(i0 + gi, g.N - 1), rb = min(i0 + gi + 8, g.N - 1);
  const int ia = info[ra], ib = info[rb];
  const int ua = ia >> 4, ub = ib >> 4;
  // loads at clamped (valid) indices, no branch around them
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = nb * 8 + 2 * t + e < g.N;
      const int ij = info[min(nb * 8 + 2 * t + e, g.N - 1)];
      // (q.k) * scale + bias, then + mask: each one rounding, in order
      float va = __fadd_rn(__fmul_rn(s[nb][e], g.scale), sB[ua - (ij >> 4)]);
      float vb = __fadd_rn(__fmul_rn(s[nb][2 + e], g.scale),
                           sB[ub - (ij >> 4)]);
      if (g.shift) {
        const int lj = ij & 15;
        va = __fadd_rn(va, (ia & 15) != lj ? -100.f : 0.f);
        vb = __fadd_rn(vb, (ib & 15) != lj ? -100.f : 0.f);
      }
      s[nb][e] = in ? va : -INFINITY;
      s[nb][2 + e] = in ? vb : -INFINITY;
      ma = fmaxf(ma, s[nb][e]);
      mb = fmaxf(mb, s[nb][2 + e]);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
  }
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = nb * 8 + 2 * t + e < g.N;
      s[nb][e] = in ? __expf(s[nb][e] - ma) : 0.f;
      s[nb][2 + e] = in ? __expf(s[nb][2 + e] - mb) : 0.f;
      sa += s[nb][e];
      sb += s[nb][2 + e];
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, o);
    sb += __shfl_xor_sync(0xffffffffu, sb, o);
  }
  const float inva = 1.f / sa, invb = 1.f / sb;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    s[nb][0] *= inva;
    s[nb][1] *= inva;
    s[nb][2] *= invb;
    s[nb][3] *= invb;
  }
}

// rows i0 + gi and i0 + gi + 8 of a 16 x D result, times mul, to the
// tokens' map rows: dst + row * stride
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           long long stride,
                                           const int* rowidx,
                                           const float (&c)[D / 8][4], int N,
                                           int i0, int gi, int t, float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + gi + 8 * half;
    if (i >= N) continue;
    float* d = dst + (long long)rowidx[i] * stride + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(d + nd * 8) =
          make_float2(c[nd][2 * half] * mul, c[nd][2 * half + 1] * mul);
  }
}

// a warp's 16 x NP fragments into the P / dS tile (row stride kLP)
__device__ __forceinline__ void store_tile(float* T, const float (&c)[8][4],
                                           int NP, int i0, int gi, int t) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    if (nb * 8 >= NP) break;
    float* d = T + (i0 + gi) * kLP + nb * 8 + 2 * t;
    *reinterpret_cast<float2*>(d) = make_float2(c[nb][0], c[nb][1]);
    *reinterpret_cast<float2*>(d + 8 * kLP) = make_float2(c[nb][2], c[nb][3]);
  }
}

// Problem p's tiles, table column and token rows into the staging set, as
// cp.async copies (zero-filled rows N .. NP); the caller commits them.
template <int D, int NT>
__device__ __forceinline__ void load(const Geo& g,
                                     const float* __restrict__ qkv,
                                     const float* __restrict__ gout,
                                     const float* __restrict__ table,
                                     float* sm, int p) {
  using S = Smem<D, NT>;
  constexpr int kC = D / 4;  // 16-byte chunks of a row
  constexpr int kStride = kThr / kC, kRows = kMaxN / kStride;
  int* rowidx = reinterpret_cast<int*>(sm + S::kSRow);
  int* info = reinterpret_cast<int*>(sm + S::kSInfo);
  const int h = p / g.W, wi = p - h * g.W;
  const int b = wi / g.nWin, w = wi - b * g.nWin;
  const int wy = w / g.nWw, wx = w - wy * g.nWw;
  const long long HD = (long long)g.H * D;
  const int c = threadIdx.x % kC, n0 = threadIdx.x / kC;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int n = n0 + k * kStride;
    if (n >= g.NP) break;
    int row = 0, bytes = 0;
    if (n < g.N) {
      const int r = n / g.ws, cc = n - r * g.ws;
      const int yy = wy * g.ws + r, xx = wx * g.ws + cc;
      int y = yy + g.shift, x = xx + g.shift;
      if (y >= g.Hm) y -= g.Hm;
      if (x >= g.Wm) x -= g.Wm;
      row = (b * g.Hm + y) * g.Wm + x;
      bytes = 16;
      if (c == 0) {
        int lab = 0;
        if (g.shift) {
          const int ry = yy < g.Hm - g.ws ? 0 : (yy < g.Hm - g.shift ? 1 : 2);
          const int rx = xx < g.Wm - g.ws ? 0 : (xx < g.Wm - g.shift ? 1 : 2);
          lab = 3 * ry + rx;
        }
        rowidx[n] = row;
        info[n] = ((r * (2 * g.ws - 1) + cc) << 4) | lab;
      }
    }
    const float* src = qkv + (long long)row * 3 * HD + h * D + 4 * c;
    float* at = sm + S::kS + sw<D>(n, 4 * c, n);
    cp_async16(at, src, bytes);
    cp_async16(at + S::kT, src + HD, bytes);
    cp_async16(at + 2 * S::kT, src + 2 * HD, bytes);
    if constexpr (NT == 4)
      cp_async16(at + 3 * S::kT, gout + (long long)row * HD + h * D + 4 * c,
                 bytes);
  }
  for (int r = threadIdx.x; r < g.nb; r += kThr)
    cp_async4(sm + S::kSB + r, table + r * g.H + h);
}

// The staged problem into the working set: each tile's rows 0 .. NP split
// into hi and lo once, for all four warps; the small arrays copied; then a
// barrier.
template <int D, int NT>
__device__ __forceinline__ void split_tiles(float* sm, int NP, int nb) {
  using S = Smem<D, NT>;
#pragma unroll
  for (int s = 0; s < NT; ++s)
    for (int i = threadIdx.x; i < NP * D / 4; i += kThr) {
      float4 v = *reinterpret_cast<const float4*>(sm + S::kS + s * S::kT +
                                                  4 * i),
             lo;
      float *e = &v.x, *l = &lo.x;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const Op o = split(e[q]);
        e[q] = __uint_as_float(o.hi);
        l[q] = __uint_as_float(o.lo);
      }
      float* hi = sm + S::work(s) + 4 * i;
      *reinterpret_cast<float4*>(hi) = v;
      *reinterpret_cast<float4*>(hi + S::kT) = lo;
    }
  for (int i = threadIdx.x; i < kMaxN; i += kThr) {
    sm[S::kRow + i] = sm[S::kSRow + i];
    sm[S::kInfo + i] = sm[S::kSInfo + i];
  }
  for (int i = threadIdx.x; i < nb; i += kThr) sm[S::kB + i] = sm[S::kSB + i];
  __syncthreads();
}

template <int D>
__device__ __forceinline__ void fwd_problem(const float* sm,
                                            float* __restrict__ out,
                                            const Geo& g, int h, int i0,
                                            int gi, int t) {
  using S = Smem<D, 3>;
  const int* rowidx = reinterpret_cast<const int*>(sm + S::kRow);
  const int* info = reinterpret_cast<const int*>(sm + S::kInfo);
  float s[8][4];
  nt_product<D>(sm + S::kQ, sm + S::kK, s, g.NP, i0, gi, t);
  softmax_rows(s, sm + S::kB + g.off, info, g, i0, gi, t);
  float o[D / 8][4];
  pv_product<D>(s, sm + S::kV, o, g.NP, gi, t);
  store_rows<D>(out + h * D, (long long)g.H * D, rowidx, o, g.N, i0, gi, t,
                1.f);
}

template <int D>
__global__ void __launch_bounds__(kThr, 3)
    window_attention_fwd(const float* __restrict__ qkv,
                         const float* __restrict__ table,
                         float* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x / 32, gi = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4, i0 = 16 * warp;
  const int p0 = (int)((long long)blockIdx.x * g.P / g.G);
  const int p1 = (int)((long long)(blockIdx.x + 1) * g.P / g.G);
  load<D, 3>(g, qkv, nullptr, table, sm, p0);
  cp_async_commit();
  for (int p = p0; p < p1; ++p) {
    cp_async_wait_all();
    __syncthreads();  // p staged; the last problem's reads are done
    split_tiles<D, 3>(sm, g.NP, g.nb);
    if (p + 1 < p1) {  // staging is free: the next problem's copies
      load<D, 3>(g, qkv, nullptr, table, sm, p + 1);
      cp_async_commit();
    }
    if (i0 >= g.NP) continue;
    fwd_problem<D>(sm, out, g, p / g.W, i0, gi, t);
  }
}

// the CTA whose run [c P / G, (c + 1) P / G) holds problem p
__device__ __forceinline__ int cta_of(long long p, int P, int G) {
  return (int)(((p + 1) * G - 1) / P);
}

// The CTA's dS sum of head h, binned through the index, to its scratch row
// part[h][c]. The last CTA of those whose runs meet head h (an integer
// ticket counts them) then sums the head's rows, c ascending, into
// dtable[.][h] and puts the ticket back to 0: the order is fixed whichever
// CTA it is, so two calls give the same bits.
__device__ __forceinline__ void flush_bins(
    float* sT, const float (&acc)[8][4], float* __restrict__ part,
    int* __restrict__ tickets, float* __restrict__ dtable, const Geo& g,
    int h, int i0, int gi, int t) {
  __shared__ int last;
  if (i0 < g.NP) store_tile(sT, acc, g.NP, i0, gi, t);
  __syncthreads();
  const int ws = g.ws, w2 = 2 * ws - 1;
  for (int r = threadIdx.x; r < g.nb; r += kThr) {
    const int oy = r / w2 - (ws - 1), ox = r % w2 - (ws - 1);
    float s = 0.f;
    for (int ri = max(0, oy); ri < min(ws, ws + oy); ++ri)
      for (int ci = max(0, ox); ci < min(ws, ws + ox); ++ci)
        s += sT[(ri * ws + ci) * kLP + (ri - oy) * ws + (ci - ox)];
    part[((long long)h * g.G + blockIdx.x) * g.nb + r] = s;
  }
  const int c0 = cta_of((long long)h * g.W, g.P, g.G);
  const int c1 = cta_of((long long)(h + 1) * g.W - 1, g.P, g.G);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + h, 1) == c1 - c0;
  __syncthreads();
  if (last) {
    __threadfence();
    for (int r = threadIdx.x; r < g.nb; r += kThr) {
      float s = 0.f;
#pragma unroll 8
      for (int c = c0; c <= c1; ++c)
        s += __ldcg(part + ((long long)h * g.G + c) * g.nb + r);
      dtable[r * g.H + h] = s;
    }
    if (threadIdx.x == 0) tickets[h] = 0;
  }
  __syncthreads();
}

// One backward problem: S, P, dP, dS in registers; dS added to acc; dq, dk,
// dv to their map rows. Every thread calls it (it holds barriers); act is
// false for a warp past the padded rows.
template <int D>
__device__ __forceinline__ void bwd_problem(float* sm,
                                            float* __restrict__ dqkv,
                                            float (&acc)[8][4], const Geo& g,
                                            int h, bool act, int i0, int gi,
                                            int t) {
  using S = Smem<D, 4>;
  const float *sQ = sm + S::kQ, *sK = sm + S::kK, *sV = sm + S::kV,
              *sG = sm + S::kG;
  float* sT = sm + S::kP;
  const int* rowidx = reinterpret_cast<const int*>(sm + S::kRow);
  const int* info = reinterpret_cast<const int*>(sm + S::kInfo);
  const long long HD = (long long)g.H * D;
  float* dst = dqkv + h * D;
  float s[8][4], ds[8][4];
  if (act) {
    nt_product<D>(sQ, sK, s, g.NP, i0, gi, t);
    softmax_rows(s, sm + S::kB + g.off, info, g, i0, gi, t);
    nt_product<D>(sG, sV, ds, g.NP, i0, gi, t);  // dP = dO v^T
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float delta = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (nb * 8 + 2 * t + e < g.N)
            delta = fmaf(s[nb][2 * half + e], ds[nb][2 * half + e], delta);
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
        delta += __shfl_xor_sync(0xffffffffu, delta, o);
      const bool row_in = i0 + gi + 8 * half < g.N;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 2 * half + e;
          const bool in = nb * 8 + 2 * t + e < g.N;
          ds[nb][k] = in ? s[nb][k] * (ds[nb][k] - delta) : 0.f;
          acc[nb][k] += ds[nb][k];
          if (!row_in) s[nb][k] = 0.f;
        }
    }
  }
  __syncthreads();  // every warp's dP is done: the P tile may cover v
  if (act) store_tile(sT, s, g.NP, i0, gi, t);
  __syncthreads();
  float c[D / 8][4];
  if (act) {  // dV = P^T dO, this warp's 16 keys
    tn_product<D>(sT, sG, c, g.NP, i0, gi, t);
    store_rows<D>(dst + 2 * HD, 3 * HD, rowidx, c, g.N, i0, gi, t, 1.f);
  }
  __syncthreads();
  if (act) {  // dQ = scale dS k, this warp's 16 queries
    store_tile(sT, ds, g.NP, i0, gi, t);
    pv_product<D>(ds, sK, c, g.NP, gi, t);
    store_rows<D>(dst, 3 * HD, rowidx, c, g.N, i0, gi, t, g.scale);
  }
  __syncthreads();
  if (act) {  // dK = scale dS^T q, this warp's 16 keys
    tn_product<D>(sT, sQ, c, g.NP, i0, gi, t);
    store_rows<D>(dst + HD, 3 * HD, rowidx, c, g.N, i0, gi, t, g.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThr, 2)
    window_attention_bwd(const float* __restrict__ qkv,
                         const float* __restrict__ table,
                         const float* __restrict__ gout,
                         float* __restrict__ dqkv, float* __restrict__ part,
                         int* __restrict__ tickets,
                         float* __restrict__ dtable, Geo g) {
  extern __shared__ __align__(16) float sm[];
  float* sT = sm + Smem<D, 4>::kP;  // P, then dS, then the binned sums
  const int warp = threadIdx.x / 32, gi = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4, i0 = 16 * warp;
  const bool act = i0 < g.NP;
  const int p0 = (int)((long long)blockIdx.x * g.P / g.G);
  const int p1 = (int)((long long)(blockIdx.x + 1) * g.P / g.G);
  float acc[8][4];  // this CTA's dS summed over its problems of head hc
  zero(acc);
  int hc = p0 / g.W;
  load<D, 4>(g, qkv, gout, table, sm, p0);
  cp_async_commit();
  for (int p = p0; p < p1; ++p) {
    const int h = p / g.W;
    cp_async_wait_all();
    __syncthreads();  // p staged; the last problem's reads are done
    if (h != hc) {
      flush_bins(sT, acc, part, tickets, dtable, g, hc, i0, gi, t);
      zero(acc);
      hc = h;
    }
    split_tiles<D, 4>(sm, g.NP, g.nb);
    if (p + 1 < p1) {  // staging is free: the next problem's copies
      load<D, 4>(g, qkv, gout, table, sm, p + 1);
      cp_async_commit();
    }
    bwd_problem<D>(sm, dqkv, acc, g, h, act, i0, gi, t);
  }
  __syncthreads();
  flush_bins(sT, acc, part, tickets, dtable, g, hc, i0, gi, t);
}

// ------------------------------------------------- d = 32 on wgmma
//
// The main path's shape (SUNet: d = 32 at every stage) runs on Hopper's
// warpgroup MMA: the CTA is one warpgroup, and every product is an
// asynchronous wgmma m64nNk8 .tf32 (three of them for 3xTF32). B, and A
// where it is not in registers, is read by the tensor cores straight from
// shared memory, once for the warpgroup: no warp loads fragments of it.
// Operands are K-major in the 128-byte swizzle (rows of 32 floats, 8-row
// atoms of 1 KB): the token-major tiles as the copies write them, and
// d-major ("transposed") tiles that the split writes for the products
// whose reduction runs over tokens. Windows are padded to 64 tokens (one
// wgmma M). Non-finite inputs need no second path: lo is 0 where hi is
// not finite, so an Inf or NaN reaches each sum through hi.hi and the
// cross terms with it.
namespace tc {

constexpr int kT = 64 * 32;  // floats of a token-major tile (8 KB)
constexpr int kH = 32 * 32;  // floats of a 32-row half tile (4 KB)

// offset (floats) of (row, col) in a tile of 128-byte rows, 128-byte swizzle
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 32 + ((((col >> 2) ^ row) & 7) << 2) + (col & 3);
}
// a d-major tile over 64 tokens: two halves of 32 tokens; (d, token slot)
__device__ __forceinline__ int swt(int e, int slot) {
  return (slot >> 5) * kH + sw128(e, slot & 31);
}
// a (64 x 64) P^T / dS^T tile: halves over i; (j, i)
__device__ __forceinline__ int swp(int j, int i) {
  return (i >> 5) * kT + sw128(j, i & 31);
}
// token n's slot in a tile read against A fragments taken straight from
// C fragments (the k permutation: slot s < 4 holds token 2s of its 8, slot
// s >= 4 token 2(s - 4) + 1)
__device__ __forceinline__ int perm(int n) {
  return (n & ~7) | ((n & 1) << 2) | ((n & 7) >> 1);
}

// K-major, 128-byte swizzle: start address, the (ignored) leading byte
// offset 1, 1 KB to the next 8 rows; a k8 step adds 32 bytes.
__device__ __forceinline__ uint64_t desc(const float* p) {
  const uint32_t a = vwfd::smem_u32(p);
  return (uint64_t)((a & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the waits
template <int M>
__device__ __forceinline__ void pin(float (&c)[M][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+f"(c[m][k])::"memory");
}

// c (64 x 64) += A B^T: A in registers (this warp's 16 rows, the m16n8k8
// A layout), B a token-major tile
__device__ __forceinline__ void rs64(float (&c)[8][4], const uint32_t (&a)[4],
                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),
        "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),
        "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
// c (64 x 32) += A B^T, A in registers
__device__ __forceinline__ void rs32(float (&c)[4][4], const uint32_t (&a)[4],
                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
// c (64 x 32) += A B^T, A in shared memory
__device__ __forceinline__ void ss32(float (&c)[4][4], uint64_t da,
                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3])
      : "l"(da), "l"(db));
}

// A fragments (hi, lo) of a warp's 16 rows of a token-major raw tile, k8
// step ks
__device__ __forceinline__ void a_rows(const float* t, int i0, int g, int tq,
                                       int ks, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int r = i0 + g, c = ks * 8 + tq;
  const float v[4] = {t[sw128(r, c)], t[sw128(r + 8, c)], t[sw128(r, c + 4)],
                      t[sw128(r + 8, c + 4)]};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const Op o = split(v[q]);
    hi[q] = o.hi;
    lo[q] = o.lo;
  }
}
// A fragments (hi, lo) of C fragments p, key block kb, k permuted
__device__ __forceinline__ void a_frag(const float (&p)[8][4], int kb,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float v[4] = {p[kb][0], p[kb][2], p[kb][1], p[kb][3]};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const Op o = split(v[q]);
    hi[q] = o.hi;
    lo[q] = o.lo;
  }
}

// A fragments (hi, lo) of this warp's 16 rows of a raw token-major tile,
// the four k8 steps of d = 32
struct Rows {
  uint32_t hi[4][4], lo[4][4];
};
__device__ __forceinline__ void a_tile(Rows& r, const float* a, int i0,
                                       int g, int tq) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) a_rows(a, i0, g, tq, ks, r.hi[ks], r.lo[ks]);
}

// c (64 x 64) += A B^T over d = 32 in 3xTF32: A's fragments in registers,
// B token-major hi and lo tiles; the caller fences before and commits
__device__ __forceinline__ void product_s(float (&c)[8][4], const Rows& a,
                                          const float* bh, const float* bl) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    rs64(c, a.lo[ks], desc(bh + 8 * ks));
    rs64(c, a.hi[ks], desc(bl + 8 * ks));
    rs64(c, a.hi[ks], desc(bh + 8 * ks));
  }
}

// c (64 x 32) = P X over 64 keys: P this warp's C fragments, X d-major hi
// and lo tiles in the permuted token order
__device__ __forceinline__ void product_pv(float (&c)[4][4],
                                           const float (&p)[8][4],
                                           const float* xh, const float* xl) {
  uint32_t ah[8][4], al[8][4];
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) a_frag(p, kb, ah[kb], al[kb]);
  zero(c);
  fence();
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    const int o = (kb >> 2) * kH + 8 * (kb & 3);
    rs32(c, al[kb], desc(xh + o));
    rs32(c, ah[kb], desc(xl + o));
    rs32(c, ah[kb], desc(xh + o));
  }
  commit();
}

// c (64 x 32) = T X over 64 rows i: T a (j x i) hi / lo tile pair, X d-major
// hi and lo tiles in token order
__device__ __forceinline__ void product_tn(float (&c)[4][4], const float* th,
                                           const float* tl, const float* xh,
                                           const float* xl) {
  zero(c);
  fence();
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    const int oa = (kb >> 2) * kT + 8 * (kb & 3);
    const int ob = (kb >> 2) * kH + 8 * (kb & 3);
    ss32(c, desc(tl + oa), desc(xh + ob));
    ss32(c, desc(th + oa), desc(xl + ob));
    ss32(c, desc(th + oa), desc(xh + ob));
  }
  commit();
}

// Shared memory, floats from a 1 KB-aligned base.
// Backward: raw token-major tiles as copied (k and v then split in place:
// their hi), the lo of k and v, and the d-major hi / lo tiles k^T
// (permuted), dO^T and q^T; the small arrays twice (this problem's, and the
// next one's as its copies land). Each region takes the next problem's
// copies as soon as it is done with: q and dO once their A fragments are
// in registers, k and v once dV and dQ are. P^T lies over k and v (hi over
// their hi, lo over their lo) from dP to dV; dS^T over k^T and dO^T from
// dQ and dV to dK; the table gradient's flush tile over k^T between
// problems.
struct SmB {
  static constexpr int kQ = 0, kK = kT, kV = 2 * kT, kG = 3 * kT;
  static constexpr int kLK = 4 * kT, kLV = 5 * kT;
  static constexpr int kXK = 6 * kT, kXG = 8 * kT, kXQ = 10 * kT;
  static constexpr int kMisc = 12 * kT, kSlot = 360;  // two slots of:
  static constexpr int kRow = 0, kInfo = kMaxN, kB = 2 * kMaxN;
  static constexpr int kPh = kK, kPl = kLK, kDh = kXK, kDl = kXG;
  static constexpr int kFlush = kXK;
  static constexpr int kBytes = 4 * (kMisc + 2 * kSlot) + 1024;
  static_assert(kB + kBinsPad <= kSlot && kFlush + kMaxN * kLP <= kXQ,
                "layout");
};
// Forward: a staging set the copies of the next problem land in (raw q,
// k, v and the small arrays) and a working set: k's hi / lo, v^T's
// (permuted) hi / lo and the small arrays.
struct SmF {
  static constexpr int kQ = 0, kK = kT, kV = 2 * kT;  // staging
  static constexpr int kRow = 3 * kT, kInfo = kRow + kMaxN;
  static constexpr int kB = kInfo + kMaxN;
  static constexpr int kWK = 4 * kT, kWLK = 5 * kT, kWX = 6 * kT;  // working
  static constexpr int kWRow = 8 * kT, kWInfo = kWRow + kMaxN;
  static constexpr int kWB = kWInfo + kMaxN;
  static constexpr int kBytes = 4 * (kWB + kBinsPad) + 1024;
  static_assert(kB + kBinsPad <= kWK, "staging fits");
};

__device__ __forceinline__ float* align1k(float* raw) {
  const uint32_t a = vwfd::smem_u32(raw);
  return raw + (((1024u - (a & 1023u)) & 1023u) >> 2);
}

// cp.async copies of problem p: the token rows of the tiles in `tiles`
// (0 q, 1 k, 2 v, 3 dO: bit t of the mask), each to its raw tile at
// `at[t]` (floats from sm); with `misc` >= 0 also the table column and the
// token rows and labels to the small-array slot there. Committed; waited
// for if wait_all.
// This thread's four token rows n = threadIdx.x / 8 + 16 k as (row, col)
// in the window, or -1 past N: fixed for the kernel.
struct Tok {
  int r[4], c[4];
  __device__ __forceinline__ Tok(const Geo& g) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = threadIdx.x / 8 + 16 * k;
      r[k] = n < g.N ? n / g.ws : -1;
      c[k] = n < g.N ? n - r[k] * g.ws : 0;
    }
  }
};

__device__ __forceinline__ void load(const Geo& g, const Tok& tok,
                                     const float* __restrict__ qkv,
                                     const float* __restrict__ gout,
                                     const float* __restrict__ table,
                                     float* sm, int p, int tiles,
                                     const int (&at)[4], int misc,
                                     bool wait_all) {
  const int h = p / g.W, wi = p - h * g.W;
  const int b = wi / g.nWin, w = wi - b * g.nWin;
  const int wy = w / g.nWw, wx = w - wy * g.nWw;
  const long long HD = (long long)g.H * 32;
  const int c = threadIdx.x % 8, n0 = threadIdx.x / 8;
  int* rowidx = reinterpret_cast<int*>(sm + misc);
  int* info = rowidx + kMaxN;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int n = n0 + 16 * k;
    int row = 0, bytes = 0;
    if (tok.r[k] >= 0) {
      const int r = tok.r[k], cc = tok.c[k];
      const int yy = wy * g.ws + r, xx = wx * g.ws + cc;
      int y = yy + g.shift, x = xx + g.shift;
      if (y >= g.Hm) y -= g.Hm;
      if (x >= g.Wm) x -= g.Wm;
      row = (b * g.Hm + y) * g.Wm + x;
      bytes = 16;
      if (c == 0 && misc >= 0) {
        int lab = 0;
        if (g.shift) {
          const int ry = yy < g.Hm - g.ws ? 0 : (yy < g.Hm - g.shift ? 1 : 2);
          const int rx = xx < g.Wm - g.ws ? 0 : (xx < g.Wm - g.shift ? 1 : 2);
          lab = 3 * ry + rx;
        }
        rowidx[n] = row;
        info[n] = ((r * (2 * g.ws - 1) + cc) << 4) | lab;
      }
    }
    const float* src = qkv + (long long)row * 3 * HD + h * 32 + 4 * c;
    const int o = sw128(n, 4 * c);
#pragma unroll
    for (int t = 0; t < 3; ++t)
      if (tiles & (1 << t)) cp_async16(sm + at[t] + o, src + t * HD, bytes);
    if (tiles & 8)
      cp_async16(sm + at[3] + o, gout + (long long)row * HD + h * 32 + 4 * c,
                 bytes);
  }
  if (misc >= 0)
    for (int r = threadIdx.x; r < g.nb; r += kThr)
      cp_async4(sm + misc + 2 * kMaxN + r, table + r * g.H + h);
  cp_async_commit();
  if (wait_all) cp_async_wait_all();
}

// hi and lo of 4 values of token n at d = e0 .. e0 + 3 into a d-major tile
// pair at token slot `slot`
__device__ __forceinline__ void put_t(float* th, const float (&hi)[4],
                                      const float (&lo)[4], int e0, int slot) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = swt(e0 + q, slot);
    th[o] = hi[q];
    th[o + 2 * kH] = lo[q];
  }
}

// hi and lo of the 4 values of a raw tile's 16-byte chunk at src
__device__ __forceinline__ void cut(const float* src, float (&hi)[4],
                                    float (&lo)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const Op o = split(e[q]);
    hi[q] = __uint_as_float(o.hi);
    lo[q] = __uint_as_float(o.lo);
  }
}
__device__ __forceinline__ void keep(float* dh, float* dl, const float (&hi)[4],
                                     const float (&lo)[4]) {
  *reinterpret_cast<float4*>(dh) = make_float4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<float4*>(dl) = make_float4(lo[0], lo[1], lo[2], lo[3]);
}

// The backward's split, once a problem: k and v into hi in place and lo;
// k^T (permuted), q^T and dO^T as hi and lo. Fenced for the async proxy,
// then a barrier.
__device__ __forceinline__ void split_bwd(float* sm) {
  using S = SmB;
#pragma unroll
  for (int i = threadIdx.x; i < 64 * 8; i += kThr) {
    // a warp takes one chunk of 32 tokens: conflict-free d-major stores
    const int n = i & 63, e0 = 4 * (i >> 6), c = 32 * n + 4 * ((i >> 6) ^ (n & 7));
    float hi[4], lo[4];
    cut(sm + S::kK + c, hi, lo);  // k: S's B, and k^T for dQ
    keep(sm + S::kK + c, sm + S::kLK + c, hi, lo);
    put_t(sm + S::kXK, hi, lo, e0, perm(n));
    cut(sm + S::kV + c, hi, lo);  // v: dP's B
    keep(sm + S::kV + c, sm + S::kLV + c, hi, lo);
    cut(sm + S::kQ + c, hi, lo);  // q^T for dK
    put_t(sm + S::kXQ, hi, lo, e0, n);
    cut(sm + S::kG + c, hi, lo);  // dO^T for dV
    put_t(sm + S::kXG, hi, lo, e0, n);
  }
  vwfd::fence_to_bulk();
  __syncthreads();
}

// The forward's split: the staged k into the working hi / lo, the staged v
// into v^T (permuted) hi / lo, the small arrays copied. Fenced for the
// async proxy, then a barrier (after which the staging set is free).
__device__ __forceinline__ void split_fwd(float* sm, int nb) {
  using S = SmF;
#pragma unroll
  for (int i = threadIdx.x; i < 64 * 8; i += kThr) {
    const int n = i & 63, e0 = 4 * (i >> 6), c = 32 * n + 4 * ((i >> 6) ^ (n & 7));
    float hi[4], lo[4];
    cut(sm + S::kK + c, hi, lo);
    keep(sm + S::kWK + c, sm + S::kWLK + c, hi, lo);
    cut(sm + S::kV + c, hi, lo);
    put_t(sm + S::kWX, hi, lo, e0, perm(n));
  }
  for (int i = threadIdx.x; i < kMaxN; i += kThr) {
    sm[S::kWRow + i] = sm[S::kRow + i];
    sm[S::kWInfo + i] = sm[S::kInfo + i];
  }
  for (int i = threadIdx.x; i < nb; i += kThr) sm[S::kWB + i] = sm[S::kB + i];
  vwfd::fence_to_bulk();
  __syncthreads();
}

// P (or dS) C fragments to the (j x i) hi / lo tile pair: row j, column i
__device__ __forceinline__ void put_pt(float* th, float* tl,
                                       const float (&c)[8][4], int i0, int g,
                                       int tq) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = nb * 8 + 2 * tq + (k & 1), i = i0 + g + 8 * (k >> 1);
      const Op o = split(c[nb][k]);
      th[swp(j, i)] = __uint_as_float(o.hi);
      tl[swp(j, i)] = __uint_as_float(o.lo);
    }
}

__global__ void __launch_bounds__(kThr, 3)
    window_attention_fwd_tc(const float* __restrict__ qkv,
                            const float* __restrict__ table,
                            float* __restrict__ out, Geo g) {
  using S = SmF;
  extern __shared__ __align__(16) float raw[];
  float* sm = align1k(raw);
  const int warp = threadIdx.x / 32, gi = (threadIdx.x % 32) / 4,
            tq = threadIdx.x % 4, i0 = 16 * warp;
  const int p0 = (int)((long long)blockIdx.x * g.P / g.G);
  const int p1 = (int)((long long)(blockIdx.x + 1) * g.P / g.G);
  const int* rowidx = reinterpret_cast<const int*>(sm + S::kWRow);
  const int* info = reinterpret_cast<const int*>(sm + S::kWInfo);
  const Tok tok(g);
  constexpr int kAt[4] = {S::kQ, S::kK, S::kV, 0};
  load(g, tok, qkv, nullptr, table, sm, p0, 7, kAt, S::kRow, false);
  for (int p = p0; p < p1; ++p) {
    cp_async_wait_all();
    __syncthreads();  // p staged; the last problem's reads are done
    Rows qa;
    a_tile(qa, sm + S::kQ, i0, gi, tq);
    split_fwd(sm, g.nb);
    if (p + 1 < p1)  // the staging set is free: the next problem's copies
      load(g, tok, qkv, nullptr, table, sm, p + 1, 7, kAt, S::kRow, false);
    float s[8][4];
    zero(s);
    fence();
    product_s(s, qa, sm + S::kWK, sm + S::kWLK);
    commit();
    wait<0>();
    pin(s);
    softmax_rows(s, sm + S::kWB + g.off, info, g, i0, gi, tq);
    float o[4][4];
    product_pv(o, s, sm + S::kWX, sm + S::kWX + 2 * kH);
    wait<0>();
    pin(o);
    store_rows<32>(out + (p / g.W) * 32, (long long)g.H * 32, rowidx, o, g.N,
                   i0, gi, tq, 1.f);
  }
}

__global__ void __launch_bounds__(kThr, 2)
    window_attention_bwd_tc(const float* __restrict__ qkv,
                            const float* __restrict__ table,
                            const float* __restrict__ gout,
                            float* __restrict__ dqkv,
                            float* __restrict__ part,
                            int* __restrict__ tickets,
                            float* __restrict__ dtable, Geo g) {
  using S = SmB;
  extern __shared__ __align__(16) float raw[];
  float* sm = align1k(raw);
  const int warp = threadIdx.x / 32, gi = (threadIdx.x % 32) / 4,
            tq = threadIdx.x % 4, i0 = 16 * warp;
  const int p0 = (int)((long long)blockIdx.x * g.P / g.G);
  const int p1 = (int)((long long)(blockIdx.x + 1) * g.P / g.G);
  constexpr int kAt[4] = {S::kQ, S::kK, S::kV, S::kG};
  const Tok tok(g);
  const long long HD = (long long)g.H * 32;
  float acc[8][4];  // this CTA's dS summed over its problems of head hc
  zero(acc);
  int hc = p0 / g.W;
  load(g, tok, qkv, gout, table, sm, p0, 15, kAt, S::kMisc, false);
  for (int p = p0; p < p1; ++p) {
    const int h = p / g.W;
    const int misc = S::kMisc + ((p - p0) & 1) * S::kSlot;
    const int* rowidx = reinterpret_cast<const int*>(sm + misc + S::kRow);
    const int* info = reinterpret_cast<const int*>(sm + misc + S::kInfo);
    cp_async_wait_all();
    __syncthreads();  // p's copies landed; the last problem is done
    if (h != hc) {
      flush_bins(sm + S::kFlush, acc, part, tickets, dtable, g, hc, i0, gi,
                 tq);
      zero(acc);
      hc = h;
    }
    split_bwd(sm);
    float s[8][4], ds[8][4];
    {
      Rows qa, ga;  // both A sets first: no register an issued wgmma reads
      a_tile(qa, sm + S::kQ, i0, gi, tq);  // is written until the wait
      a_tile(ga, sm + S::kG, i0, gi, tq);
      __syncthreads();  // raw q and dO read: they take the next problem's
      if (p + 1 < p1)
        load(g, tok, qkv, gout, table, sm, p + 1, 9, kAt,
             S::kMisc + ((p + 1 - p0) & 1) * S::kSlot, false);
      zero(s);
      zero(ds);
      fence();
      product_s(s, qa, sm + S::kK, sm + S::kLK);
      product_s(ds, ga, sm + S::kV, sm + S::kLV);  // dP = dO v^T
      commit();
      wait<0>();
    }
    pin(s);
    pin(ds);
    softmax_rows(s, sm + misc + S::kB + g.off, info, g, i0, gi, tq);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float delta = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (nb * 8 + 2 * tq + e < g.N)
            delta = fmaf(s[nb][2 * half + e], ds[nb][2 * half + e], delta);
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
        delta += __shfl_xor_sync(0xffffffffu, delta, o);
      const bool row_in = i0 + gi + 8 * half < g.N;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 2 * half + e;
          const bool in = nb * 8 + 2 * tq + e < g.N;
          ds[nb][k] = in ? s[nb][k] * (ds[nb][k] - delta) : 0.f;
          acc[nb][k] += ds[nb][k];
          if (!row_in) s[nb][k] = 0.f;
        }
    }
    __syncthreads();  // every warp's S and dP are done: P^T may cover k, v
    put_pt(sm + S::kPh, sm + S::kPl, s, i0, gi, tq);
    vwfd::fence_to_bulk();
    __syncthreads();
    float dv[4][4], dq[4][4], dk[4][4];
    product_tn(dv, sm + S::kPh, sm + S::kPl, sm + S::kXG,
               sm + S::kXG + 2 * kH);  // dV = P^T dO
    product_pv(dq, ds, sm + S::kXK, sm + S::kXK + 2 * kH);  // dQ = dS k
    wait<0>();
    pin(dv);
    pin(dq);
    __syncthreads();  // dV and dQ done: k, v take the next problem's copies,
    if (p + 1 < p1)   // dS^T covers k^T and dO^T
      load(g, tok, qkv, gout, table, sm, p + 1, 6, kAt, -1, false);
    put_pt(sm + S::kDh, sm + S::kDl, ds, i0, gi, tq);
    vwfd::fence_to_bulk();
    __syncthreads();
    product_tn(dk, sm + S::kDh, sm + S::kDl, sm + S::kXQ,
               sm + S::kXQ + 2 * kH);  // dK = dS^T q
    float* dst = dqkv + h * 32;
    store_rows<32>(dst + 2 * HD, 3 * HD, rowidx, dv, g.N, i0, gi, tq, 1.f);
    store_rows<32>(dst, 3 * HD, rowidx, dq, g.N, i0, gi, tq, g.scale);
    wait<0>();
    pin(dk);
    store_rows<32>(dst + HD, 3 * HD, rowidx, dk, g.N, i0, gi, tq, g.scale);
  }
  __syncthreads();
  flush_bins(sm + S::kFlush, acc, part, tickets, dtable, g, hc, i0, gi, tq);
}

}  // namespace tc

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int D>
int launch_fwd(const float* qkv, const float* table, float* out,
               const Geo& g, cudaStream_t st) {
  if constexpr (D == 32) {
    constexpr int kBytes = tc::SmF::kBytes;
    const cudaError_t e = allow_smem(tc::window_attention_fwd_tc, kBytes);
    if (e != cudaSuccess) return (int)e;
    tc::window_attention_fwd_tc<<<g.G, kThr, kBytes, st>>>(qkv, table, out,
                                                           g);
  } else {
    constexpr int kBytes = Smem<D, 3>::kBytes;
    const cudaError_t e = allow_smem(window_attention_fwd<D>, kBytes);
    if (e != cudaSuccess) return (int)e;
    window_attention_fwd<D><<<g.G, kThr, kBytes, st>>>(qkv, table, out, g);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const float* qkv, const float* table, const float* gout,
               float* dqkv, float* part, int* tickets, float* dtable,
               const Geo& g, cudaStream_t st) {
  if constexpr (D == 32) {
    constexpr int kBytes = tc::SmB::kBytes;
    const cudaError_t e = allow_smem(tc::window_attention_bwd_tc, kBytes);
    if (e != cudaSuccess) return (int)e;
    tc::window_attention_bwd_tc<<<g.G, kThr, kBytes, st>>>(
        qkv, table, gout, dqkv, part, tickets, dtable, g);
  } else {
    constexpr int kBytes = Smem<D, 4>::kBytes;
    const cudaError_t e = allow_smem(window_attention_bwd<D>, kBytes);
    if (e != cudaSuccess) return (int)e;
    window_attention_bwd<D><<<g.G, kThr, kBytes, st>>>(
        qkv, table, gout, dqkv, part, tickets, dtable, g);
  }
  return (int)cudaGetLastError();
}

template <typename K>
int resident(K kernel, int smem, int* n) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, kThr, smem);
  return (int)e;
}

// the geometry of a call, or false if the kernel does not take it
bool geometry(Geo* g, int B, int Hm, int Wm, int WS, int shift, int H, int D,
              int G, float scale, std::initializer_list<const void*> ptrs) {
  if (!(B > 0 && WS >= 1 && WS * WS <= kMaxN && H >= 1 &&
        (D == 16 || D == 32 || D == 64) && Hm >= WS && Wm >= WS &&
        Hm % WS == 0 && Wm % WS == 0 && shift >= 0 && shift < WS &&
        vwfd::aligned16(ptrs)))
    return false;
  const long long W = (long long)B * (Hm / WS) * (Wm / WS);
  if (W * H > 0x7fffffff || (long long)B * Hm * Wm > 0x7fffffff) return false;
  g->Hm = Hm;
  g->Wm = Wm;
  g->ws = WS;
  g->shift = shift;
  g->H = H;
  g->N = WS * WS;
  g->NP = (g->N + 15) / 16 * 16;
  g->nWw = Wm / WS;
  g->nWin = (Hm / WS) * (Wm / WS);
  g->W = (int)W;
  g->P = (int)(W * H);
  g->nb = (2 * WS - 1) * (2 * WS - 1);
  g->G = G;
  g->off = (WS - 1) * (2 * WS - 1) + WS - 1;
  g->scale = scale;
  return G >= 1 && G <= g->P;
}

}  // namespace

// CTAs of one launch that the card holds at once (per-SM occupancy times
// the SM count) for head dim D, forward (0) or backward (1): the wrappers'
// persistent grid. Returns the count, or minus a cudaError_t.
extern "C" int vwfd_window_attention_ctas(int D, int backward) {
  int dev = 0, sms = 0, n = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  int rc;
  if (D == 32)
    rc = backward ? resident(tc::window_attention_bwd_tc, tc::SmB::kBytes, &n)
                  : resident(tc::window_attention_fwd_tc, tc::SmF::kBytes, &n);
  else if (D == 16)
    rc = backward ? resident(window_attention_bwd<16>, Smem<16, 4>::kBytes, &n)
                  : resident(window_attention_fwd<16>, Smem<16, 3>::kBytes, &n);
  else if (D == 64)
    rc = backward ? resident(window_attention_bwd<64>, Smem<64, 4>::kBytes, &n)
                  : resident(window_attention_fwd<64>, Smem<64, 3>::kBytes, &n);
  else
    return -(int)cudaErrorInvalidValue;
  if (rc != 0) return -rc;
  return n * sms;
}

// qkv: (B, Hm, Wm, 3, H, D) f32 contiguous; table: ((2 WS - 1)^2, H);
// out: (B, Hm, Wm, H * D). Windows of WS x WS tokens, the map read as
// rolled by -shift (shift 0 adds no mask); G persistent CTAs, 1 <= G <=
// the problem count B (Hm / WS) (Wm / WS) H.
extern "C" int vwfd_window_attention_fwd(const void* qkv, const void* table,
                                         void* out, int B, int Hm, int Wm,
                                         int WS, int shift, int H, int D,
                                         int G, float scale, void* stream) {
  Geo g;
  if (!geometry(&g, B, Hm, Wm, WS, shift, H, D, G, scale, {qkv, out}))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(qkv);
  auto t = static_cast<const float*>(table);
  auto o = static_cast<float*>(out);
  switch (D) {
    case 16:
      return launch_fwd<16>(q, t, o, g, st);
    case 32:
      return launch_fwd<32>(q, t, o, g, st);
    default:
      return launch_fwd<64>(q, t, o, g, st);
  }
}

// gout: (B, Hm, Wm, H * D); dqkv: (B, Hm, Wm, 3, H, D), every entry
// written; part: H * G * (2 WS - 1)^2 floats of scratch; tickets: H ints,
// 0 on entry and left 0; dtable: ((2 WS - 1)^2, H), every entry written.
extern "C" int vwfd_window_attention_bwd(const void* qkv, const void* table,
                                         const void* gout, void* dqkv,
                                         void* part, void* tickets,
                                         void* dtable, int B, int Hm, int Wm,
                                         int WS, int shift, int H, int D,
                                         int G, float scale, void* stream) {
  Geo g;
  if (!geometry(&g, B, Hm, Wm, WS, shift, H, D, G, scale,
                {qkv, gout, dqkv}))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(qkv);
  auto t = static_cast<const float*>(table);
  auto gg = static_cast<const float*>(gout);
  auto dq = static_cast<float*>(dqkv);
  auto p = static_cast<float*>(part);
  auto tk = static_cast<int*>(tickets);
  auto dt = static_cast<float*>(dtable);
  switch (D) {
    case 16:
      return launch_bwd<16>(q, t, gg, dq, p, tk, dt, g, st);
    case 32:
      return launch_bwd<32>(q, t, gg, dq, p, tk, dt, g, st);
    default:
      return launch_bwd<64>(q, t, gg, dq, p, tk, dt, g, st);
  }
}
