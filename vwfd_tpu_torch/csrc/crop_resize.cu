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
// - Size: the kernels above hold whole rows. Bands shrink to one row (and
//   one staged g row) before a CTA asks for more than 110 KB (two an SM);
//   past that it takes up to the card's 227 KB a CTA (one an SM), which
//   holds RGB rows up to 2,234 pixels square (the backward's `bwd_smem`;
//   1920 × 1080 fits).
// - Column tiles (F22): wider rows take the `_tiled` kernels, whose grid
//   has a second dimension of column tiles, each tile's tables and index
//   ranges limited to the tile. The forward CTA owns a band of R output
//   rows × a run of TW output columns and stages only the input columns
//   its taps reach: the tables are monotone, so they are one run, at most
//   (TW − 1)·W/OW + 3 columns. The backward CTA owns a band of R input
//   rows × a run of TQ input columns; a first small kernel writes the
//   whole tap tables to global memory, and the CTA finds the output rows
//   and columns that tap its tile by binary search of those monotone
//   tables (no division in the kernel) and walks them in chunks of KI rows × KJ columns
//   with the sums of each tap carried across chunks, j and i ascending:
//   the same terms summed in the same order as the whole-row kernel, so
//   the result is bit-identical to it, and the same NaN footprint.
//   Copies are element-wise (coalesced within a row). A tile of one
//   column stages 3 × 3 pixels, so no width or height is refused; only a
//   pixel of more than about 6,000 channels (3 × 3 of it past 227 KB) is.
//   The wrapper (`kernels/crop_resize.py::tiles`) passes the tile widths:
//   a width at least the row's launches the whole-row kernel.
#include "common.cuh"

namespace {

using vwfd::smem_u32;

constexpr int kThrF = 256;            // threads a CTA, forward
constexpr int kThrB = 512;            // and backward
constexpr int kSmemMax = 110 * 1024;  // two CTAs an SM
constexpr int kSmemCta = 227 * 1024;  // sm_90's most a CTA (one an SM)
constexpr int kBand = 4;              // rows a CTA owns (fewer if too large)
constexpr int kChunk = 16;            // g rows staged at once (backward)
constexpr int kChunkTiled = 8;        // and in the tiled backward
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

// The whole tap tables of both axes, OH rows then OW columns, into global
// memory (a thread an entry): the tiled backward reads them and divides
// nothing itself.
__global__ void crop_resize_taps(const float* __restrict__ apex,
                                 Taps* __restrict__ tab, int OH, int OW) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < OH) tab[t] = taps(t, OH, apex[0], apex[1]);
  else if (t < OH + OW) tab[t] = taps(t - OH, OW, apex[2], apex[3]);
}

// The first index in [0, O) of the monotone table whose tap (kTap 0: the
// first, 1: the second) is at least v, O if none: a binary search.
template <int kTap>
__device__ __forceinline__ int first_tapping(const Taps* tab, int v, int O) {
  int a = 0, b = O;
  while (a < b) {
    const int m = (a + b) >> 1;
    if ((kTap ? tab[m].i1 : tab[m].i0) >= v) b = m;
    else a = m + 1;
  }
  return a;
}

// The output indices whose first / second tap is v: [x, y] and [z, w]
// (empty where x > y), one of the four searches per call (`which`).
__device__ __forceinline__ int tapping(const Taps* tab, int which, int v,
                                       int O) {
  switch (which) {
    case 0: return first_tapping<0>(tab, v, O);
    case 1: return first_tapping<0>(tab, v + 1, O) - 1;
    case 2: return first_tapping<1>(tab, v, O);
    default: return first_tapping<1>(tab, v + 1, O) - 1;
  }
}

// Shared memory of the tiled forward: header, the tile's column and the
// band's row tables, KX staged rows of KWC floats.
__host__ __device__ inline int fwd_tiled_smem(int R, int KX, int TW,
                                              int KWC) {
  return kHead + (TW + R) * (int)sizeof(Taps) + KX * KWC * 4;
}

// Shared memory of the tiled backward: header, the band rows' and the tile
// columns' output ranges, a chunk's row taps and column weights, the g
// chunk (KI × KJ·C), the W transpose's two tap sums (KI × TQ·C each) and
// the band's two (R × TQ·C each).
__host__ __device__ inline int bwd_tiled_smem(int R, int KI, int TQ, int KJ,
                                              int C) {
  return kHead + (R + TQ + KI) * 16 + align16(2 * KJ * 4) +
         (KI * KJ + 2 * KI * TQ + 2 * R * TQ) * C * 4;
}

__global__ void __launch_bounds__(kThrF)
    crop_resize_fwd_tiled(const float* __restrict__ x,
                          const float* __restrict__ apex,
                          float* __restrict__ out, int H, int W, int C,
                          int OH, int OW, int R, int KX, int TW, int KWC) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* sapex = reinterpret_cast<float*>(smem);
  int* srun = reinterpret_cast<int*>(smem + 16);  // r_lo, rows, e_lo, sw
  Taps* ctab = reinterpret_cast<Taps*>(smem + kHead);
  Taps* rtab = ctab + TW;
  float* xs = reinterpret_cast<float*>(rtab + R);
  const int WC = W * C;
  const int bands = (OH + R - 1) / R;
  const int n = blockIdx.x / bands;
  const int i_first = (blockIdx.x - n * bands) * R;
  const int nr = min(R, OH - i_first);
  const int ja = blockIdx.y * TW, nw = min(TW, OW - ja);
  const float* xn = x + (long long)n * H * WC;

  if (threadIdx.x == 0) {
    const float h0 = apex[0], h1 = apex[1], w0 = apex[2], w1 = apex[3];
    sapex[0] = h0, sapex[1] = h1, sapex[2] = w0, sapex[3] = w1;
    const int r_lo = min(max(taps(i_first, OH, h0, h1).i0, 0), H - 1);
    srun[0] = r_lo;
    srun[1] = min(min(taps(i_first + nr - 1, OH, h0, h1).i1 - r_lo + 1, KX),
                  H - r_lo);
    // the tile's run of input columns, as floats of a row
    const int c_lo = min(max(taps(ja, OW, w0, w1).i0, 0), W - 1);
    const int c_hi = min(max(taps(ja + nw - 1, OW, w0, w1).i1, c_lo), W - 1);
    srun[2] = c_lo * C;
    srun[3] = min((c_hi - c_lo + 1) * C, KWC);
  }
  __syncthreads();
  const float h0 = sapex[0], h1 = sapex[1], w0 = sapex[2], w1 = sapex[3];
  const int r_lo = srun[0], rows = srun[1], e_lo = srun[2], sw = srun[3];
  for (int r = 0; r < rows; ++r) {
    const float* src = xn + (long long)(r_lo + r) * WC + e_lo;
    for (int e = threadIdx.x; e < sw; e += kThrF) xs[r * sw + e] = src[e];
  }
  for (int t = threadIdx.x; t < nw + nr; t += kThrF) {
    if (t < nw) {
      Taps c = taps(ja + t, OW, w0, w1);
      c.i0 = min(max(c.i0 * C - e_lo, 0), sw - C);
      c.i1 = min(max(c.i1 * C - e_lo, 0), sw - C);
      ctab[t] = c;
    } else {
      Taps r = taps(i_first + t - nw, OH, h0, h1);
      r.i0 = min(max(r.i0 - r_lo, 0), rows - 1) * sw;
      r.i1 = min(max(r.i1 - r_lo, 0), rows - 1) * sw;
      rtab[t - nw] = r;
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < nr * nw; p += kThrF) {
    const int k = p / nw, j = p - k * nw;
    const Taps ty = rtab[k], tx = ctab[j];
    const float* r0 = xs + ty.i0;
    const float* r1 = xs + ty.i1;
    float* o = out + (((long long)n * OH + i_first + k) * OW + ja + j) * C;
    for (int c = 0; c < C; ++c) {
      const float a = __fadd_rn(__fmul_rn(r0[tx.i0 + c], ty.w0),
                                __fmul_rn(r1[tx.i0 + c], ty.w1));
      const float b = __fadd_rn(__fmul_rn(r0[tx.i1 + c], ty.w0),
                                __fmul_rn(r1[tx.i1 + c], ty.w1));
      o[c] = __fadd_rn(__fmul_rn(a, tx.w0), __fmul_rn(b, tx.w1));
    }
  }
}

__global__ void __launch_bounds__(kThrB)
    crop_resize_bwd_tiled(const float* __restrict__ g,
                          const Taps* __restrict__ tab,
                          float* __restrict__ gx, int H, int W, int C,
                          int OH, int OW, int R, int KI, int TQ, int KJ) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* rrange = reinterpret_cast<int*>(smem + kHead);  // 4 a band row
  int4* crange = reinterpret_cast<int4*>(rrange + 4 * R);  // a tile column
  Taps* rtaps = reinterpret_cast<Taps*>(crange + TQ);     // a chunk row
  float* cw0 = reinterpret_cast<float*>(rtaps + KI);      // a chunk column
  float* cw1 = cw0 + KJ;
  const int WC = W * C, OWC = OW * C, TQC = TQ * C, KJC = KJ * C;
  float* gs = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(cw0) +
                                       align16(2 * KJ * 4));
  float* t0 = gs + KI * KJC;  // the W transpose: first taps' sums, then T
  float* t1 = t0 + KI * TQC;  // second taps' sums
  float* os = t1 + KI * TQC;  // the band: first taps' sums, then gx
  float* acc1 = os + R * TQC;
  const int bands = (H + R - 1) / R;
  const int n = blockIdx.x / bands;
  const int ra = (blockIdx.x - n * bands) * R;
  const int nr = min(R, H - ra);
  const int qa = blockIdx.y * TQ, nq = min(TQ, W - qa);
  const float* gn = g + (long long)n * OH * OWC;
  const Taps* ctab = tab + OH;  // the column table after the rows'
  int* cr = reinterpret_cast<int*>(crange);
  for (int t = threadIdx.x; t < 4 * (nr + nq); t += kThrB) {
    if (t < 4 * nr) rrange[t] = tapping(tab, t & 3, ra + (t >> 2), OH);
    else cr[t - 4 * nr] = tapping(ctab, t & 3, qa + ((t - 4 * nr) >> 2), OW);
  }
  __syncthreads();
  // the output rows and columns that tap the tile: from the first whose
  // second tap reaches its first row (column) to the last whose first tap
  // reaches its last
  const int i_lo = rrange[2], i_hi = rrange[4 * (nr - 1) + 1];
  const int j_lo = crange[0].z, j_hi = crange[nq - 1].y;
  if (i_lo > i_hi || j_lo > j_hi) {
    for (int e = threadIdx.x; e < nr * TQC; e += kThrB) os[e] = 0.f;
  }
  const int di = kThrB / nq, dq = kThrB - di * nq;  // the grid steps
  for (int c0 = i_lo; c0 <= i_hi && j_lo <= j_hi; c0 += KI) {
    const int rows = min(KI, i_hi - c0 + 1);
    for (int t = threadIdx.x; t < rows; t += kThrB) rtaps[t] = tab[c0 + t];
    for (int jc = j_lo; jc <= j_hi; jc += KJ) {
      const int cols = min(KJ, j_hi - jc + 1);
      for (int r = 0; r < rows; ++r) {
        const float* src = gn + (long long)(c0 + r) * OWC + jc * C;
        for (int e = threadIdx.x; e < cols * C; e += kThrB)
          gs[r * KJC + e] = src[e];
      }
      for (int t = threadIdx.x; t < cols; t += kThrB) {
        const Taps c = ctab[jc + t];
        cw0[t] = c.w0, cw1[t] = c.w1;
      }
      __syncthreads();
      // the W transpose of the chunk, a thread per (row, tile column), each
      // tap's terms apart, j ascending, carried from column chunk to chunk
      const bool first = jc == j_lo, last = jc + KJ > j_hi;
      for (int i = threadIdx.x / nq, q = threadIdx.x - i * nq; i < rows;
           q += dq, i += di + (q >= nq), q -= q >= nq ? nq : 0) {
        const int4 rq = crange[q];
        const int a0 = max(rq.x, jc) - jc, b0 = min(rq.y, jc + cols - 1) - jc;
        const int a1 = max(rq.z, jc) - jc, b1 = min(rq.w, jc + cols - 1) - jc;
        const float* gr = gs + i * KJC;
        const int e = (i * TQ + q) * C;
        for (int c = 0; c < C; ++c) {
          float s0 = first ? 0.f : t0[e + c], s1 = first ? 0.f : t1[e + c];
          tap_sums<1>(gr + c, C, cw0, 1, a0, b0, &s0);
          tap_sums<1>(gr + c, C, cw1, 1, a1, b1, &s1);
          if (last) {
            t0[e + c] = __fadd_rn(s0, s1);
          } else {
            t0[e + c] = s0;
            t1[e + c] = s1;
          }
        }
      }
      __syncthreads();
    }
    // the H transpose into the band, a thread per (band row, tile column),
    // the two taps' sums carried from row chunk to chunk, i ascending
    const bool first = c0 == i_lo, last = c0 + KI > i_hi;
    constexpr int kWs = sizeof(Taps) / 4;
    for (int k = threadIdx.x / nq, q = threadIdx.x - k * nq; k < nr;
         q += dq, k += di + (q >= nq), q -= q >= nq ? nq : 0) {
      const int* rr = rrange + 4 * k;
      const int a0 = max(rr[0], c0) - c0, b0 = min(rr[1], c0 + rows - 1) - c0;
      const int a1 = max(rr[2], c0) - c0, b1 = min(rr[3], c0 + rows - 1) - c0;
      const int e = (k * TQ + q) * C;
      for (int c = 0; c < C; ++c) {
        float s0 = first ? 0.f : os[e + c], s1 = first ? 0.f : acc1[e + c];
        tap_sums<1>(t0 + q * C + c, TQC, &rtaps[0].w0, kWs, a0, b0, &s0);
        tap_sums<1>(t0 + q * C + c, TQC, &rtaps[0].w1, kWs, a1, b1, &s1);
        if (last) {
          os[e + c] = __fadd_rn(s0, s1);
        } else {
          os[e + c] = s0;
          acc1[e + c] = s1;
        }
      }
    }
    __syncthreads();
  }
  __syncthreads();
  for (int k = 0; k < nr; ++k) {
    float* dst = gx + ((long long)n * H + ra + k) * WC + qa * C;
    for (int e = threadIdx.x; e < nq * C; e += kThrB) dst[e] = os[k * TQC + e];
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
// (N, OH, OW, C). TW: the output columns a CTA owns; TW >= OW launches the
// whole-row kernel.
extern "C" int vwfd_crop_resize_fwd(const void* x, const void* apex,
                                    void* out, int N, int H, int W, int C,
                                    int OH, int OW, int TW, void* stream) {
  if ((long long)N * OH * OW * C == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // R output rows a CTA; the rows they tap, bounded from the largest
  // window (the image): (R − 1)·H/OH + 3
  int R = kBand, KX = 0;
  auto rows_of = [&](int r) {
    return min(H, ((r - 1) * H + OH - 1) / OH + 3);
  };
  if (TW < OW) {  // column tiles
    if (TW < 1) return (int)cudaErrorInvalidValue;
    const int KWC = min(W, ((TW - 1) * W + OW - 1) / OW + 3) * C;
    while (fwd_tiled_smem(R, rows_of(R), TW, KWC) > kSmemMax && R > 1) R /= 2;
    KX = rows_of(R);
    const int smem = fwd_tiled_smem(R, KX, TW, KWC);
    const long long grid = (long long)N * ((OH + R - 1) / R);
    const int tiles = (OW + TW - 1) / TW;
    if (smem > kSmemCta || grid > 0x7fffffff || tiles > 65535)
      return (int)cudaErrorInvalidValue;
    const cudaError_t e = allow_smem(crop_resize_fwd_tiled, smem);
    if (e != cudaSuccess) return (int)e;
    crop_resize_fwd_tiled<<<dim3((unsigned)grid, tiles), kThrF, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(apex),
        static_cast<float*>(out), H, W, C, OH, OW, R, KX, TW, KWC);
    return (int)cudaGetLastError();
  }
  for (;; R /= 2) {
    KX = rows_of(R);
    if (fwd_smem(R, KX, W, C, OW) <= kSmemMax || R == 1) break;
  }
  if (fwd_smem(R, KX, W, C, OW) > kSmemCta)
    return (int)cudaErrorInvalidValue;  // whole rows do not fit: tiles do
  const bool bulk = (W * C * 4) % 16 == 0 && (OW * C * 4) % 16 == 0 &&
                    vwfd::aligned16({x, out});
  const long long grid = (long long)N * ((OH + R - 1) / R);
  const int smem = fwd_smem(R, KX, W, C, OW);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto kernel = bulk ? crop_resize_fwd<true> : crop_resize_fwd<false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, kThrF, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(apex),
      static_cast<float*>(out), H, W, C, OH, OW, R, KX);
  return (int)cudaGetLastError();
}

// g: (N, OH, OW, C) the output's cotangent; gx: (N, H, W, C). TQ: the
// input columns a CTA owns; TQ >= W launches the whole-row kernel, and
// otherwise `tables`, 16·(OH + OW) bytes on the device, receives the tap
// tables first.
extern "C" int vwfd_crop_resize_bwd(const void* g, const void* apex, void* gx,
                                    void* tables, int N, int H, int W, int C,
                                    int OH, int OW, int TQ, void* stream) {
  if ((long long)N * H * W * C == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (TQ < W) {  // column tiles
    if (TQ < 1) return (int)cudaErrorInvalidValue;
    const int R = kBand, KI = min(OH, kChunkTiled);
    const int KJ = min(OW, 2 * TQ + 8);
    const int smem = bwd_tiled_smem(R, KI, TQ, KJ, C);
    const long long grid = (long long)N * ((H + R - 1) / R);
    const int tiles = (W + TQ - 1) / TQ;
    if (smem > kSmemCta || grid > 0x7fffffff || tiles > 65535 || !tables)
      return (int)cudaErrorInvalidValue;
    const cudaError_t e = allow_smem(crop_resize_bwd_tiled, smem);
    if (e != cudaSuccess) return (int)e;
    Taps* tab = static_cast<Taps*>(tables);
    crop_resize_taps<<<(OH + OW + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(apex), tab, OH, OW);
    crop_resize_bwd_tiled<<<dim3((unsigned)grid, tiles), kThrB, smem, st>>>(
        static_cast<const float*>(g), tab, static_cast<float*>(gx), H, W, C,
        OH, OW, R, KI, TQ, KJ);
    return (int)cudaGetLastError();
  }
  int R = kBand, KI = min(OH, kChunk);
  while (bwd_smem(R, KI, W, C, OH, OW) > kSmemMax && (KI > 1 || R > 1)) {
    if (KI > 1) KI = (KI + 1) / 2;
    else R /= 2;
  }
  if (bwd_smem(R, KI, W, C, OH, OW) > kSmemCta)
    return (int)cudaErrorInvalidValue;  // whole rows do not fit: tiles do
  const bool bulk = (W * C * 4) % 16 == 0 && (OW * C * 4) % 16 == 0 &&
                    vwfd::aligned16({g, gx});
  const long long grid = (long long)N * ((H + R - 1) / R);
  const int smem = bwd_smem(R, KI, W, C, OH, OW);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto kernel = bulk ? crop_resize_bwd<true> : crop_resize_bwd<false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, kThrB, smem, st>>>(
      static_cast<const float*>(g), static_cast<const float*>(apex),
      static_cast<float*>(gx), H, W, C, OH, OW, R, KI);
  return (int)cudaGetLastError();
}
