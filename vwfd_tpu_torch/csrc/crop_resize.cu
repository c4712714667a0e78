// K17 `crop_resize`: crop a window of the image and resample it bilinearly
// back to the full size, forward and backward with respect to the image.
//
// Replaces vwfd_tpu/ops/resize.py::crop_resize (:135-152) with its bilinear
// _sample_axis (:97-133), as vwfd_tpu/attacks/spatial.py::crop_attack
// (:70-77) calls it. The window apex = (h0, h1, w0, w1) is read from device
// memory (one per call, shared by the batch), so a drawn apex reaches the
// kernel with no host sync. Per output row i (columns likewise):
//   ys = h0 + (i + ½)·(h1 − h0)/OH − ½,  b = floor(ys),  t = ys − b
//   taps clamp(b, h0, h1 − 1) and clamp(b + 1, h0, h1 − 1), weights 1 − t, t
// (taps clamp to the window, not to the image). H is sampled first, then W:
//   out = (x[r0,q0]·(1−t) + x[r1,q0]·t)·(1−s) + (x[r0,q1]·(1−t) + x[r1,q1]·t)·s
// each product and sum one IEEE rounding in the plain version's order, so
// the forward is EQUAL to it. Every tap multiplies, a weight of 0 too, so a
// NaN or Inf reaches the same outputs as in the plain version (and JAX's
// `gathered * w`).
//
// Bound: bytes. At the HiDDeN path's (8, 128, 128, 3) f32 the forward reads
// the window (at most 1.57 MB) and writes 1.57 MB, the backward reads g and
// writes gx (3.1 MB): 0.5-0.9 µs at 3.35 TB/s, under a launch's fixed cost.
// So the design keeps every CTA's loads in flight at once and does no
// division, search or strided global access per pixel.
//
// Design (both directions): a CTA owns a band of rows of one image (256
// threads forward, 512 backward). One thread reads the apex and shares it
// through shared memory; the CTA computes the tap tables (i0, i1, 1 − t,
// t) of the rows and columns it needs once, with the plain version's
// float32 operations (`taps`), into shared memory.
// - Forward: the band is R output rows. Thread 0 derives the contiguous run
//   of window rows they tap from two taps, and one 1-D bulk copy
//   (cp.async.bulk, completing on an mbarrier) moves that run, full width,
//   into shared memory while the tables are built. A thread per output
//   pixel gathers its four taps from shared memory; one bulk store writes
//   the band.
// - Backward: the band is R input rows; gx is the separable transpose in
//   autograd's order. From the monotone row table each band row finds the
//   output rows that tap it (a thread per output row writes where a run
//   starts and ends; no search, no division), and from the column table
//   each input column the output columns that may tap it (a thread per
//   output column writes its stretch of the inverse). Those output rows of
//   g are one contiguous run; it moves by bulk copy in chunks of KI rows
//   (one chunk at the HiDDeN path's windows), and for each chunk
//     T[i][q][c]  = Σ_j wc(j,q)·g[i][j][c]       (j ascending)
//     gx[r][q][c] += Σ_i wr(i,r)·T[i][q][c]      (i ascending)
//   with the next chunk's copy in flight during the second sum. Each sum
//   keeps the terms of the first tap and of the second tap apart, added
//   last, as autograd's two index_adds do: the tapping sets are kept by
//   index, not by weight, so a NaN in g reaches the pixels it reaches in
//   the plain version. No float atomics: deterministic. One bulk store
//   writes the band; rows and columns outside the window come out 0.
//   RGB (C = 3) takes unrolled channels (independent chains); a thread
//   steps over its (row, column) grid without a division.
// - Rows whose byte length is not a multiple of 16, or tensors not on a
//   16-byte boundary, take the same kernels with element-wise copies in
//   place of the bulk copies.
// - Size: a CTA holds whole rows, so the width is bounded. Bands shrink to
//   one row (and one staged g row) before a CTA asks for more than 110 KB
//   (two an SM); past that it takes up to the card's 227 KB a CTA (one an
//   SM), which holds RGB rows up to 2,234 pixels square (the backward's
//   `bwd_smem`; 1920 × 1080 fits). Larger rows are refused
//   (cudaErrorInvalidValue); the wrapper states the limit first.
#include "common.cuh"

namespace {

using vwfd::smem_u32;

constexpr int kThrF = 256;            // threads a CTA, forward
constexpr int kThrB = 512;            // and backward
constexpr int kSmemMax = 110 * 1024;  // two CTAs an SM
constexpr int kSmemCta = 227 * 1024;  // sm_90's most a CTA (one an SM)
constexpr int kBand = 4;              // rows a CTA owns (fewer if too large)
constexpr int kChunk = 16;            // g rows staged at once (backward)
constexpr int kHead = 64;             // apex, mbarrier, run bounds

struct Taps {
  int i0, i1;
  float w0, w1;
};

// The bilinear taps of output index i of O along an axis whose window is
// [lo, hi), with the plain version's float32 operations.
__device__ __forceinline__ Taps taps(int i, int O, float lo, float hi) {
  const float len = __fsub_rn(hi, lo);
  const float ys = __fsub_rn(
      __fadd_rn(lo, __fdiv_rn(__fmul_rn(__fadd_rn((float)i, 0.5f), len),
                              (float)O)),
      0.5f);
  const float base = floorf(ys);
  const float t = __fsub_rn(ys, base);
  const int b = (int)base, l = (int)lo, h = (int)__fsub_rn(hi, 1.f);
  return {min(max(b, l), h), min(max(b + 1, l), h), __fsub_rn(1.f, t), t};
}

__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }

// s[c] += v[j·vs + c]·w[j·ws] over j = a..b ascending, for kC channels at
// once (independent chains), each product and sum one IEEE rounding.
template <int kC>
__device__ __forceinline__ void tap_sums(const float* v, int vs,
                                         const float* w, int ws, int a,
                                         int b, float* s) {
  for (int j = a; j <= b; ++j) {
    const float wj = w[j * ws];
    const float* p = v + j * vs;
#pragma unroll
    for (int c = 0; c < kC; ++c) s[c] = __fadd_rn(s[c], __fmul_rn(p[c], wj));
  }
}

// Shared memory of the forward: header, column and row tables, the staged
// input rows (KX of W·C floats) and the output band (R of OW·C).
__host__ __device__ inline int fwd_smem(int R, int KX, int W, int C,
                                        int OW) {
  return kHead + (OW + R) * (int)sizeof(Taps) + KX * W * C * 4 +
         R * OW * C * 4;
}

// Shared memory of the backward: header, row and column tables, the
// column and band-row inverses, the column weights, the output band (R of
// W·C), the staged g chunk (KI of OW·C), the chunk's W transpose (KI of
// W·C) and the second-tap sums (R of W·C).
__host__ __device__ inline int bwd_smem(int R, int KI, int W, int C, int OH,
                                        int OW) {
  return kHead + (OH + OW + W + R) * 16 + align16(2 * OW * 4) +
         (2 * R * W * C + KI * OW * C + KI * W * C) * 4;
}

template <bool kBulk>
__global__ void __launch_bounds__(kThrF)
    crop_resize_fwd(const float* __restrict__ x,
                    const float* __restrict__ apex, float* __restrict__ out,
                    int H, int W, int C, int OH, int OW, int R, int KX) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* sapex = reinterpret_cast<float*>(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 16);
  int* srun = reinterpret_cast<int*>(smem + 32);  // first row, rows
  Taps* ctab = reinterpret_cast<Taps*>(smem + kHead);
  Taps* rtab = ctab + OW;
  float* xs = reinterpret_cast<float*>(rtab + R);
  const int WC = W * C, OWC = OW * C;
  float* ys = xs + KX * WC;
  const int bands = (OH + R - 1) / R;
  const int n = blockIdx.x / bands;
  const int i_first = (blockIdx.x - n * bands) * R;
  const int nr = min(R, OH - i_first);
  const float* xn = x + (long long)n * H * WC;

  if (threadIdx.x == 0) {
    const float h0 = apex[0], h1 = apex[1];
    sapex[0] = h0, sapex[1] = h1, sapex[2] = apex[2], sapex[3] = apex[3];
    // the window rows the band taps: from its first row's first tap to its
    // last row's second tap (the taps are monotone)
    const int r_lo = min(max(taps(i_first, OH, h0, h1).i0, 0), H - 1);
    const int rows = min(min(taps(i_first + nr - 1, OH, h0, h1).i1 - r_lo
                             + 1, KX), H - r_lo);
    srun[0] = r_lo, srun[1] = rows;
    if constexpr (kBulk) {
      const uint32_t b = smem_u32(bar);
      vwfd::mbar_init(b, 1);
      vwfd::mbar_fence_init();
      vwfd::mbar_expect_tx(b, rows * WC * 4);
      vwfd::bulk_load_rows(reinterpret_cast<uint8_t*>(xs), 0,
                           reinterpret_cast<const uint8_t*>(
                               xn + (long long)r_lo * WC),
                           1, 0, rows * WC * 4, b);
    }
  }
  __syncthreads();
  const float h0 = sapex[0], h1 = sapex[1], w0 = sapex[2], w1 = sapex[3];
  const int r_lo = srun[0], rows = srun[1];
  if constexpr (!kBulk) {
    const float* src = xn + (long long)r_lo * WC;
    for (int e = threadIdx.x; e < rows * WC; e += kThrF) xs[e] = src[e];
  }
  // the tables: columns as offsets i·C into a row, rows as offsets into
  // the staged run
  for (int t = threadIdx.x; t < OW + nr; t += kThrF) {
    if (t < OW) {
      Taps c = taps(t, OW, w0, w1);
      c.i0 *= C, c.i1 *= C;
      ctab[t] = c;
    } else {
      Taps r = taps(i_first + t - OW, OH, h0, h1);
      r.i0 = min(max(r.i0 - r_lo, 0), rows - 1) * WC;
      r.i1 = min(max(r.i1 - r_lo, 0), rows - 1) * WC;
      rtab[t - OW] = r;
    }
  }
  __syncthreads();
  if constexpr (kBulk) vwfd::mbar_wait(smem_u32(bar), 0);

  float* dst = kBulk ? ys : out + ((long long)n * OH + i_first) * OWC;
  for (int p = threadIdx.x; p < nr * OW; p += kThrF) {
    const int k = p / OW;
    const Taps ty = rtab[k], tx = ctab[p - k * OW];
    const float* r0 = xs + ty.i0;
    const float* r1 = xs + ty.i1;
    float* o = dst + p * C;
    auto bilinear = [&](int c) {
      const float a = __fadd_rn(__fmul_rn(r0[tx.i0 + c], ty.w0),
                                __fmul_rn(r1[tx.i0 + c], ty.w1));
      const float b = __fadd_rn(__fmul_rn(r0[tx.i1 + c], ty.w0),
                                __fmul_rn(r1[tx.i1 + c], ty.w1));
      o[c] = __fadd_rn(__fmul_rn(a, tx.w0), __fmul_rn(b, tx.w1));
    };
    if (C == 3) {  // HiDDeN's RGB: the channels unrolled
      bilinear(0), bilinear(1), bilinear(2);
    } else {
      for (int c = 0; c < C; ++c) bilinear(c);
    }
  }
  if constexpr (kBulk) {
    vwfd::fence_to_bulk();
    __syncthreads();
    if (threadIdx.x == 0) {
      vwfd::bulk_store_rows(
          reinterpret_cast<uint8_t*>(out + ((long long)n * OH + i_first) *
                                               OWC),
          reinterpret_cast<const uint8_t*>(ys), 0, 1, 0, 1, 0,
          nr * OWC * 4);
      vwfd::bulk_wait_read();
    }
  }
}

template <bool kBulk>
__global__ void __launch_bounds__(kThrB)
    crop_resize_bwd(const float* __restrict__ g,
                    const float* __restrict__ apex, float* __restrict__ gx,
                    int H, int W, int C, int OH, int OW, int R, int KI) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* sapex = reinterpret_cast<float*>(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 16);
  Taps* rtab = reinterpret_cast<Taps*>(smem + kHead);
  Taps* ctab = rtab + OH;
  // per input column q, the output columns whose first tap is q and those
  // whose second tap is q: [x, y] and [z, w] (each contiguous: the taps
  // are monotone)
  int4* crange = reinterpret_cast<int4*>(ctab + OW);
  int* rrange = reinterpret_cast<int*>(crange + W);  // the same per band row
  float* cw0 = reinterpret_cast<float*>(rrange + 4 * R);  // column weights
  float* cw1 = cw0 + OW;
  const int WC = W * C, OWC = OW * C;
  float* os = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(cw0) +
                                       align16(2 * OW * 4));
  float* gs = os + R * WC;
  float* ts = gs + KI * OWC;
  float* acc1 = ts + KI * WC;
  const int bands = (H + R - 1) / R;
  const int n = blockIdx.x / bands;
  const int ra = (blockIdx.x - n * bands) * R;
  const int nr = min(R, H - ra);
  const float* gn = g + (long long)n * OH * OWC;

  if (threadIdx.x == 0) {
    sapex[0] = apex[0], sapex[1] = apex[1], sapex[2] = apex[2],
    sapex[3] = apex[3];
    for (int k = 0; k < R; ++k)
      rrange[4 * k] = rrange[4 * k + 2] = OH,
      rrange[4 * k + 1] = rrange[4 * k + 3] = -1;
    if constexpr (kBulk) {
      vwfd::mbar_init(smem_u32(bar), 1);
      vwfd::mbar_fence_init();
    }
  }
  __syncthreads();
  const float h0 = sapex[0], h1 = sapex[1], w0 = sapex[2], w1 = sapex[3];
  for (int t = threadIdx.x; t < OH + OW; t += kThrB) {
    if (t < OH) {
      rtab[t] = taps(t, OH, h0, h1);
    } else {
      const Taps c = taps(t - OH, OW, w0, w1);
      ctab[t - OH] = c;
      cw0[t - OH] = c.w0, cw1[t - OH] = c.w1;
    }
  }
  __syncthreads();
  // The inverses, from the monotone tables (no search, no division): for
  // each tap, output i is the first to tap r = ra + k when its tap is ≥ r
  // and its predecessor's < r, the last when its tap is ≤ r and its
  // successor's > r; output column j writes the stretch of input columns
  // that it is first and last to tap.
  for (int i = threadIdx.x; i < OH; i += kThrB) {
    const Taps t = rtab[i];
    const Taps tp = i ? rtab[i - 1] : Taps{-1, -1, 0.f, 0.f};
    const Taps tn = i + 1 < OH ? rtab[i + 1] : Taps{H, H, 0.f, 0.f};
    for (int k = 0; k < nr; ++k) {
      const int r = ra + k;
      if (t.i0 >= r && tp.i0 < r) rrange[4 * k] = i;
      if (t.i0 <= r && tn.i0 > r) rrange[4 * k + 1] = i;
      if (t.i1 >= r && tp.i1 < r) rrange[4 * k + 2] = i;
      if (t.i1 <= r && tn.i1 > r) rrange[4 * k + 3] = i;
    }
  }
  int* cr = reinterpret_cast<int*>(crange);
  for (int j = threadIdx.x; j < OW; j += kThrB) {
    const Taps t = ctab[j];
    const bool first = j == 0, last = j + 1 == OW;
    const int p0 = first ? -1 : ctab[j - 1].i0;
    const int p1 = first ? -1 : ctab[j - 1].i1;
    const int n0 = last ? W : ctab[j + 1].i0, n1 = last ? W : ctab[j + 1].i1;
    // first j with tap ≥ q: q in (p, t]; the last output past them: OW
    for (int q = p0 + 1; q <= min(last ? W - 1 : t.i0, W - 1); ++q)
      cr[4 * q] = q <= t.i0 ? j : OW;
    for (int q = p1 + 1; q <= min(last ? W - 1 : t.i1, W - 1); ++q)
      cr[4 * q + 2] = q <= t.i1 ? j : OW;
    // last j with tap ≤ q: q in [t, n); the first output before them: -1
    for (int q = first ? 0 : t.i0; q < min(n0, W); ++q)
      cr[4 * q + 1] = q >= t.i0 ? j : -1;
    for (int q = first ? 0 : t.i1; q < min(n1, W); ++q)
      cr[4 * q + 3] = q >= t.i1 ? j : -1;
  }
  __syncthreads();
  const int i_lo = rrange[2], i_hi = rrange[4 * (nr - 1) + 1];  // the run
  if (i_lo > i_hi) {  // no output taps the band: it is 0
    for (int e = threadIdx.x; e < nr * WC; e += kThrB) os[e] = 0.f;
  } else if (kBulk && threadIdx.x == 0) {
    const int rows = min(KI, i_hi - i_lo + 1);
    vwfd::mbar_expect_tx(smem_u32(bar), rows * OWC * 4);
    vwfd::bulk_load_rows(reinterpret_cast<uint8_t*>(gs), 0,
                         reinterpret_cast<const uint8_t*>(
                             gn + (long long)i_lo * OWC),
                         1, 0, rows * OWC * 4, smem_u32(bar));
  }
  const int di = kThrB / W, dq = kThrB - di * W;  // the grid steps
  for (int c0 = i_lo, chunk = 0; c0 <= i_hi; c0 += KI, ++chunk) {
    const int rows = min(KI, i_hi - c0 + 1);
    if constexpr (kBulk) {
      vwfd::mbar_wait(smem_u32(bar), chunk & 1);
    } else {
      const float* src = gn + (long long)c0 * OWC;
      for (int e = threadIdx.x; e < rows * OWC; e += kThrB) gs[e] = src[e];
      __syncthreads();
    }
    // b. the W transpose of the chunk, a thread per (row, input column),
    // stepped over the grid without a division: the first taps' terms,
    // then the second taps', j ascending
    for (int i = threadIdx.x / W, q = threadIdx.x - i * W; i < rows;
         q += dq, i += di + (q >= W), q -= q >= W ? W : 0) {
      const int4 rq = crange[q];
      const float* gr = gs + i * OWC;
      float* tq = ts + (i * W + q) * C;
      if (C == 3) {
        float s0[3] = {}, s1[3] = {};
        tap_sums<3>(gr, 3, cw0, 1, rq.x, rq.y, s0);
        tap_sums<3>(gr, 3, cw1, 1, rq.z, rq.w, s1);
        for (int c = 0; c < 3; ++c) tq[c] = __fadd_rn(s0[c], s1[c]);
      } else {
        for (int c = 0; c < C; ++c) {
          float s0 = 0.f, s1 = 0.f;
          tap_sums<1>(gr + c, C, cw0, 1, rq.x, rq.y, &s0);
          tap_sums<1>(gr + c, C, cw1, 1, rq.z, rq.w, &s1);
          tq[c] = __fadd_rn(s0, s1);
        }
      }
    }
    __syncthreads();  // gs is free: the next chunk's copy overlaps c.
    if (kBulk && threadIdx.x == 0 && c0 + KI <= i_hi) {
      const int next = min(KI, i_hi - c0 - KI + 1);
      vwfd::mbar_expect_tx(smem_u32(bar), next * OWC * 4);
      vwfd::bulk_load_rows(reinterpret_cast<uint8_t*>(gs), 0,
                           reinterpret_cast<const uint8_t*>(
                               gn + (long long)(c0 + KI) * OWC),
                           1, 0, next * OWC * 4, smem_u32(bar));
    }
    // c. the H transpose into the band, a thread per (band row, column);
    // the two taps' sums carried from chunk to chunk in os and acc1, and
    // added after the last
    const bool first = c0 == i_lo, last = c0 + KI > i_hi;
    const float* wr0 = &rtab[c0].w0;  // row weights, a Taps apart
    const float* wr1 = &rtab[c0].w1;
    constexpr int kWs = sizeof(Taps) / 4;
    for (int k = threadIdx.x / W, q = threadIdx.x - k * W; k < nr;
         q += dq, k += di + (q >= W), q -= q >= W ? W : 0) {
      const int* rr = rrange + 4 * k;
      const int a0 = max(rr[0], c0) - c0, b0 = min(rr[1], c0 + rows - 1) - c0;
      const int a1 = max(rr[2], c0) - c0, b1 = min(rr[3], c0 + rows - 1) - c0;
      const int e = (k * W + q) * C;
      const float* tq = ts + q * C;  // row i of the chunk at + i·W·C
      auto sums = [&](int nc, int c, float* s0, float* s1) {
        for (int d = 0; d < nc; ++d)
          s0[d] = first ? 0.f : os[e + c + d],
          s1[d] = first ? 0.f : acc1[e + c + d];
        if (nc == 3) {
          tap_sums<3>(tq, WC, wr0, kWs, a0, b0, s0);
          tap_sums<3>(tq, WC, wr1, kWs, a1, b1, s1);
        } else {
          tap_sums<1>(tq + c, WC, wr0, kWs, a0, b0, s0);
          tap_sums<1>(tq + c, WC, wr1, kWs, a1, b1, s1);
        }
        for (int d = 0; d < nc; ++d) {
          if (last) {
            os[e + c + d] = __fadd_rn(s0[d], s1[d]);
          } else {
            os[e + c + d] = s0[d];
            acc1[e + c + d] = s1[d];
          }
        }
      };
      if (C == 3) {
        float s0[3], s1[3];
        sums(3, 0, s0, s1);
      } else {
        for (int c = 0; c < C; ++c) {
          float s0[1], s1[1];
          sums(1, c, s0, s1);
        }
      }
    }
    __syncthreads();  // ts is free; after the last chunk, os is complete
  }
  if constexpr (kBulk) {
    vwfd::fence_to_bulk();
    __syncthreads();
    if (threadIdx.x == 0) {
      vwfd::bulk_store_rows(
          reinterpret_cast<uint8_t*>(gx + ((long long)n * H + ra) * WC),
          reinterpret_cast<const uint8_t*>(os), 0, 1, 0, 1, 0, nr * WC * 4);
      vwfd::bulk_wait_read();
    }
  } else {
    __syncthreads();
    float* dst = gx + ((long long)n * H + ra) * WC;
    for (int e = threadIdx.x; e < nr * WC; e += kThrB) dst[e] = os[e];
  }
}

// Dynamic shared memory above 48 KB (the attribute belongs to the current
// device: set on every launch, which costs no measurable time).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes <= 48 * 1024
             ? cudaSuccess
             : cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// x: (N, H, W, C) f32 contiguous; apex: 4 f32 on the device, (h0, h1, w0,
// w1) with 0 <= h0 < h1 <= H and 0 <= w0 < w1 <= W, integer-valued; out:
// (N, OH, OW, C).
extern "C" int vwfd_crop_resize_fwd(const void* x, const void* apex,
                                    void* out, int N, int H, int W, int C,
                                    int OH, int OW, void* stream) {
  if ((long long)N * OH * OW * C == 0) return (int)cudaSuccess;
  // R output rows a CTA; the rows they tap, bounded from the largest
  // window (the image): (R − 1)·H/OH + 3
  int R = kBand, KX = 0;
  for (;; R /= 2) {
    KX = min(H, ((R - 1) * H + OH - 1) / OH + 3);
    if (fwd_smem(R, KX, W, C, OW) <= kSmemMax || R == 1) break;
  }
  if (fwd_smem(R, KX, W, C, OW) > kSmemCta)
    return (int)cudaErrorInvalidValue;  // rows too wide
  const bool bulk = (W * C * 4) % 16 == 0 && (OW * C * 4) % 16 == 0 &&
                    vwfd::aligned16({x, out});
  const long long grid = (long long)N * ((OH + R - 1) / R);
  const int smem = fwd_smem(R, KX, W, C, OW);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto kernel = bulk ? crop_resize_fwd<true> : crop_resize_fwd<false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, kThrF, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(apex),
      static_cast<float*>(out), H, W, C, OH, OW, R, KX);
  return (int)cudaGetLastError();
}

// g: (N, OH, OW, C) the output's cotangent; gx: (N, H, W, C).
extern "C" int vwfd_crop_resize_bwd(const void* g, const void* apex, void* gx,
                                    int N, int H, int W, int C, int OH,
                                    int OW, void* stream) {
  if ((long long)N * H * W * C == 0) return (int)cudaSuccess;
  int R = kBand, KI = min(OH, kChunk);
  while (bwd_smem(R, KI, W, C, OH, OW) > kSmemMax && (KI > 1 || R > 1)) {
    if (KI > 1) KI = (KI + 1) / 2;
    else R /= 2;
  }
  if (bwd_smem(R, KI, W, C, OH, OW) > kSmemCta)
    return (int)cudaErrorInvalidValue;  // rows too wide
  const bool bulk = (W * C * 4) % 16 == 0 && (OW * C * 4) % 16 == 0 &&
                    vwfd::aligned16({g, gx});
  const long long grid = (long long)N * ((H + R - 1) / R);
  const int smem = bwd_smem(R, KI, W, C, OH, OW);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto kernel = bulk ? crop_resize_bwd<true> : crop_resize_bwd<false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, kThrB, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(apex),
      static_cast<float*>(gx), H, W, C, OH, OW, R, KI);
  return (int)cudaGetLastError();
}
