// K20 `crop_cubic`: crop a window of the image and resample it bicubically
// (a = −0.75) to the output size, forward and backward with respect to the
// image.
//
// Replaces vwfd_tpu/ops/resize.py::crop_resize(method="bicubic") (:135-152)
// with its bicubic _sample_axis (:97-133), as CLR's crop tamper calls it
// (vwfd_tpu/models/image_model.py:230-231, 535-536). The window apex =
// (h0, h1, w0, w1) is read from device memory (one per call, shared by the
// batch), so a drawn apex reaches the kernel with no host sync; the grid
// and the shared memory depend on shapes only. Per output row i (columns
// likewise):
//   ys = h0 + ((i + ½)·(h1 − h0))/OH − ½,  b = floor(ys),  t = ys − b,
//   taps clamp(b − 1 … b + 2, h0, h1 − 1) with the cubic weights of t
// (cubic.cuh). Rows first, then columns, as the plain version:
//   R[q]  = Σ_k wy[k]·x[r_k, q]      (the row sum at source column q)
//   y     = Σ_a wx[a]·R[q_a]
// each product and sum one IEEE rounding in tap order.
//
// Bound: bytes. At CLR's (8, 256, 256, 3) f32 the forward reads the window
// (at most 6.3 MB) and writes 6.3 MB; the backward reads g and writes gx:
// about 3.5 µs each way at 3.35 TB/s, near a launch's fixed cost.
//
// Design. A CTA of 256 threads takes one image, a band of rows and a column
// tile of up to 256 pixels (a thread a pixel, every channel); `plan` in
// kernels/crop_cubic.py sizes bands and tiles from the shapes and the SM
// count, the launchers here size the shared memory with the same formulas.
// - Forward (separable, as K21's): per output row the row pass reads the
//   row's four source rows over the tile's source columns as float4 runs
//   and writes the row sums R to shared memory once; the column pass, its
//   column taps in registers (computed once per CTA), reads each pixel's
//   four R values and writes the output row. R at source column q is the
//   very sum the plain version forms before its column sum, so the output
//   EQUALS the plain version by construction, NaN and Inf included (every
//   tap multiplies, a weight of 0 too). The next row's loads are issued
//   before the column pass, into registers (VWFD_CROP_PREFETCH).
// - Backward, one launch, no scratch plane: a CTA takes a band of input
//   rows. Two lanes find the output rows [ia, ib] whose clamped taps land
//   on it (the closed form's estimate stepped to the exact index; the tap
//   bases are monotone); the CTA tabulates the taps of the output columns
//   that reach its tile and of its output rows, once. Each thread lists
//   its pixel q's column terms (j, a): j ascending, taps in order, those
//   whose clamped tap is q, and keeps them in registers. It then walks
//   i = ia … ib: gt = Σ g[i, j]·wx over its terms (g read through L1, the
//   first kHoist terms' loads issued together), and wy·gt into four
//   accumulators in registers, the rows wb … wb + 3: the rows an output
//   row taps move down with it, so the four roll down the band and a row
//   no later output row taps is stored to gx; the walk starts at the
//   band's first row in the window and ends at its last, so that rows
//   no output row taps (a downsampling out_hw skips rows) are stored as
//   0. Terms are added j ascending, taps in order, then i ascending,
//   taps in order: the first version's order, so the gradient is
//   bit-equal to it; deterministic, no float atomics, each tap's term
//   kept apart (a NaN in g reaches every index autograd's does), 0
//   outside the window. Output rows that neighbouring bands share are
//   formed again by each (from L2). A pixel with more than kTerms terms
//   (a window narrower than about 0.44 of the output's width; CLR draws
//   0.5 and wider) is heavy: the CTA forms its gt in shared memory, a
//   thread a heavy pixel and output row of a chunk (the pixel's terms in
//   the same order), so that a one-pixel window's 1,024 terms a row are
//   not summed by one thread for every row. Forming every pixel's gt so
//   (-DVWFD_CROP_SMEM_GT=1) takes 1.8–2.1 times the backward's time at
//   CLR's windows on an H100 (PERF.md): hence the two paths.
#include "cubic.cuh"

namespace {

using vwfd::Cubic;
using vwfd::crop_pos;
using vwfd::cubic_sum;
using vwfd::cubic_taps;

#ifndef VWFD_CROP_PREFETCH
#define VWFD_CROP_PREFETCH 1  // 0: the loads in the phase that uses them
#endif
#ifndef VWFD_CROP_SMEM_GT
#define VWFD_CROP_SMEM_GT 0  // 1: every pixel's gt formed by the CTA in
                             // shared memory, none in registers (timing)
#endif
#ifndef VWFD_CROP_CUT
#define VWFD_CROP_CUT 0
#endif
// phases cut out for timing (port_tools/ablate_clr_kernels.py; the outputs
// are wrong): 1 the forward row pass's loads, 2 the forward column pass,
// 4 the backward column transpose (gt, with its loads of g), 8 the
// backward row transpose (the accumulation; the column transpose, whose
// result nothing then reads, goes with it)
constexpr int kThreads = 256;  // a CTA; one pixel of a column tile a thread
constexpr int kFwdBlocks = 3;  // forward CTAs an SM: 80 registers a thread
constexpr int kBwdBlocks = 3;  // backward CTAs an SM
constexpr int kFwdPre = 1;     // float4s of a source row a thread prefetches
constexpr int kCtab = 512;     // output columns a backward CTA tabulates
constexpr int kTerms = 10;     // column terms a pixel holds in registers
constexpr int kHoist = 6;      // of them, those whose loads issue together
constexpr int kHeavy = 4;      // heavy pixels' gt a CTA holds a row of
                               // a chunk of 256 output rows
constexpr int kSpanPad = 6;    // source columns of a tile: see fwd_span
constexpr int kMaxSmem = 227 * 1024;
constexpr int kCut = VWFD_CROP_CUT;
constexpr bool kSmemGt = VWFD_CROP_SMEM_GT;

// The first and last clamped tap of source position `pos` (cubic_taps'
// i[0] and i[3]).
__device__ __forceinline__ int tap_first(float pos, int lo, int hi) {
  return min(max((int)floorf(pos) - 1, lo), hi);
}
__device__ __forceinline__ int tap_last(float pos, int lo, int hi) {
  return min(max((int)floorf(pos) + 2, lo), hi);
}

// The first j in [lo, end) where the monotone predicate holds (end if
// none), stepped from the estimate `guess`.
template <typename P>
__device__ __forceinline__ int first_true(int lo, int end, int guess,
                                          P holds) {
  int j = min(max(guess, lo), end);
  while (j > lo && holds(j - 1)) --j;
  while (j < end && !holds(j)) ++j;
  return j;
}

// The first output index of O whose tap base floor(crop_pos) is ≥ b (O if
// none): the closed form's estimate, stepped to the exact index (crop_pos
// is monotone in the index, so the steps find the first version's binary
// search's answer).
__device__ int first_base_at_least(int b, int O, float lo, float hi) {
  const float len = __fsub_rn(hi, lo);
  const float e = ((float)b + 0.5f - lo) * (float)O / len - 0.5f;
  const int guess = !(len > 0.f) || e <= 0.f ? 0
                    : e >= (float)O           ? O
                                              : (int)ceilf(e);
  return first_true(0, O, guess, [&](int j) {
    return (int)floorf(crop_pos(j, O, lo, hi)) >= b;
  });
}

// The output indices [first, last] of an axis whose clamped taps may land
// on source index q of the window [lo, hi]: unclamped bases in [q − 2,
// q + 1], any base ≤ lo + 1 at q = lo, any base ≥ hi − 2 at q = hi (each
// tap is checked again by the caller).
__device__ void tapping(int q, int O, float flo, float fhi, int lo, int hi,
                        int* first, int* last) {
  if (q < lo || q > hi) {  // outside the window: no output taps q
    *first = 0;
    *last = -1;
    return;
  }
  *first = q == lo ? 0 : first_base_at_least(q - 2, O, flo, fhi);
  *last = (q == hi ? O : first_base_at_least(q + 2, O, flo, fhi)) - 1;
}

// The four taps' row sums of one float4 of a row.
__device__ __forceinline__ float4 rowsum4(const float4* a, const float* w) {
  const float vx[4] = {a[0].x, a[1].x, a[2].x, a[3].x};
  const float vy[4] = {a[0].y, a[1].y, a[2].y, a[3].y};
  const float vz[4] = {a[0].z, a[1].z, a[2].z, a[3].z};
  const float vw[4] = {a[0].w, a[1].w, a[2].w, a[3].w};
  return make_float4(cubic_sum(vx, w), cubic_sum(vy, w), cubic_sum(vz, w),
                     cubic_sum(vw, w));
}

// 1-D grid: CTA b takes image b / (bands·tiles), rows [band·k, band·k +
// band) of k = (b / tiles) mod bands, and column tile b mod tiles of `tw`
// output pixels. Dynamic shared memory: the band's row taps (32 B each),
// then R (fwd_smem). vec: W·C % 4 == 0 and x 16-byte aligned, so each
// source row is read as float4s from the float4 boundary at or below the
// tile's first source column.
template <int CT>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
    crop_cubic_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ apex,
                          float* __restrict__ y, int H, int W, int c_arg,
                          int OH, int OW, int band, int tw, int vec) {
  const int C = CT > 0 ? CT : c_arg;
  extern __shared__ float4 smem4[];
  Cubic* rtap = reinterpret_cast<Cubic*>(smem4);  // [band]
  float4* R4 = smem4 + 2 * band;
  const float* R = reinterpret_cast<const float*>(R4);
  const int t = threadIdx.x;
  const int tiles = (OW + tw - 1) / tw, bands = (OH + band - 1) / band;
  const int tile = blockIdx.x % tiles;
  const int i0 = (blockIdx.x / tiles) % bands * band;
  const int n = blockIdx.x / (tiles * bands);
  const int i1 = min(OH, i0 + band);
  const int j0 = tile * tw, j1 = min(OW, j0 + tw);
  const float h0 = apex[0], h1 = apex[1], w0 = apex[2], w1 = apex[3];
  const int hlo = (int)h0, hhi = (int)__fsub_rn(h1, 1.f);
  const int wlo = (int)w0, whi = (int)__fsub_rn(w1, 1.f);

  for (int r = t; r < i1 - i0; r += kThreads)
    rtap[r] = cubic_taps(crop_pos(i0 + r, OH, h0, h1), hlo, hhi);
  const int j = j0 + t;
  const bool has = j < j1;
  const Cubic cx = cubic_taps(crop_pos(has ? j : j0, OW, w0, w1), wlo, whi);
  // the tile's source columns [qa, qb]; R holds them from float e_lo of
  // the row on
  const int qa = tap_first(crop_pos(j0, OW, w0, w1), wlo, whi);
  const int qb = tap_last(crop_pos(j1 - 1, OW, w0, w1), wlo, whi);
  const long long WC = (long long)W * C;
  const int e_lo = vec ? (qa * C) & ~3 : qa * C;
  const int ne = (qb + 1) * C - e_lo;
  const int n4 = (ne + 3) >> 2;
  int off[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) off[a] = cx.i[a] * C - e_lo;
  const float* xn = x + (long long)n * H * WC + e_lo;
  float* yn = y + ((long long)n * OH * OW + j) * C;
  __syncthreads();

  // column pass of row i: R → y
  auto column_pass = [&](int i) {
    if (kCut & 2) return;
    if (!has) return;
    float* out = yn + (long long)i * OW * C;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float v[4] = {R[off[0] + c], R[off[1] + c], R[off[2] + c],
                          R[off[3] + c]};
      out[c] = cubic_sum(v, cx.w);
    }
  };
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  if (VWFD_CROP_PREFETCH && vec && n4 <= kFwdPre * kThreads) {
    float4 src[kFwdPre][4];
    float wy[4];
    // source rows of output row i → src (and its weights → wy)
    auto load_rows = [&](int i) {
      const Cubic ry = rtap[i - i0];
#pragma unroll
      for (int k = 0; k < 4; ++k) wy[k] = ry.w[k];
#pragma unroll
      for (int u = 0; u < kFwdPre; ++u) {
        const int v = t + u * kThreads;
        if (v >= n4) break;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          src[u][k] = (kCut & 1) ? zero
                                 : __ldg(reinterpret_cast<const float4*>(
                                             xn + ry.i[k] * WC) + v);
      }
    };
    load_rows(i0);
    for (int i = i0; i < i1; ++i) {
#pragma unroll
      for (int u = 0; u < kFwdPre; ++u) {
        const int v = t + u * kThreads;
        if (v < n4) R4[v] = rowsum4(src[u], wy);
      }
      __syncthreads();  // R of row i written
      if (i + 1 < i1) load_rows(i + 1);
      column_pass(i);
      __syncthreads();  // R of row i read
    }
  } else {
    float* Rw = reinterpret_cast<float*>(R4);
    for (int i = i0; i < i1; ++i) {
      const Cubic ry = rtap[i - i0];
      const float* s[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) s[k] = xn + ry.i[k] * WC;
      if (vec) {
        for (int v = t; v < n4; v += kThreads) {
          float4 a[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            a[k] = (kCut & 1)
                       ? zero
                       : __ldg(reinterpret_cast<const float4*>(s[k]) + v);
          R4[v] = rowsum4(a, ry.w);
        }
      } else {
        for (int e = t; e < ne; e += kThreads) {
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] = (kCut & 1) ? 0.f : __ldg(s[k] + e);
          Rw[e] = cubic_sum(v, ry.w);
        }
      }
      __syncthreads();  // R of row i written
      column_pass(i);
      __syncthreads();  // R of row i read
    }
  }
}

// 1-D grid: CTA b takes image b / (bands·tiles), input rows [r0, r0 +
// band) of k = (b / tiles) mod bands, and the column tile b mod tiles of
// `tq` input pixels, a thread a pixel. Dynamic shared memory (kBwdSmem):
// the row taps of kThreads output rows, the column taps of up to kCtab
// output columns, the pixels' column terms as they are listed (kTerms a
// thread: offset of g in its row, weight), the two ends of the CTA's
// output rows and its count of heavy pixels, each heavy pixel's q, ja, jb,
// and the heavy pixels' gt at a chunk's output rows. A light pixel's terms
// then sit in registers, g is read through L1 (a warp's pixels read
// neighbouring runs of a g row), and the pixel's band rows are summed in
// registers: the rows an output row taps move down monotonically with it,
// so four accumulators (the rows wb … wb + 3) roll down the band and each
// row, once no later output row taps it, is stored to gx.
template <int CT>
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
    crop_cubic_bwd_kernel(const float* __restrict__ g,
                          const float* __restrict__ apex,
                          float* __restrict__ gx, int H, int W, int c_arg,
                          int OH, int OW, int band, int tq) {
  constexpr int kG = CT > 0 ? CT : 4;  // channels a walk over the rows
  const int C = CT > 0 ? CT : c_arg;
  extern __shared__ float4 smem4[];
  Cubic* rtab = reinterpret_cast<Cubic*>(smem4);        // [kThreads]
  Cubic* ctab = rtab + kThreads;                        // [kCtab]
  int2* terms = reinterpret_cast<int2*>(ctab + kCtab);  // [kTerms][kThreads]
  int* range = reinterpret_cast<int*>(terms + kTerms * kThreads);  // [4]
  int* heavy = range + 4;  // [kThreads][3]: a heavy pixel's q, ja, jb
  float* hgt = reinterpret_cast<float*>(heavy + 3 * kThreads);
  // hgt: [kHeavy·kThreads][kG], the heavy pixels' gt at a chunk's rows
  const int t = threadIdx.x;
  const int tiles = (W + tq - 1) / tq, bands = (H + band - 1) / band;
  const int tile = blockIdx.x % tiles;
  const int r0 = (blockIdx.x / tiles) % bands * band;
  const int n = blockIdx.x / (tiles * bands);
  const int r1 = min(H, r0 + band), q0 = tile * tq, q1 = min(W, q0 + tq);
  const float h0 = apex[0], h1 = apex[1], w0 = apex[2], w1 = apex[3];
  const int hlo = (int)h0, hhi = (int)__fsub_rn(h1, 1.f);
  const int wlo = (int)w0, whi = (int)__fsub_rn(w1, 1.f);

  // the output rows [ia, ib] that tap the band, exactly (one end a lane),
  // and a range [JA, JB] of the output columns holding those that tap the
  // tile (the closed form's, widened by 2; each pixel's own is exact)
  if (t == 2) range[2] = 0;  // the heavy pixels
  if (t < 2) {
    const int qa = max(r0, hlo), qb = min(r1 - 1, hhi);
    int v;
    if (qa > qb)
      v = t ? -1 : 0;
    else if (!t)
      v = qa == hlo ? 0 : first_base_at_least(qa - 2, OH, h0, h1);
    else
      v = (qb == hhi ? OH : first_base_at_least(qb + 2, OH, h0, h1)) - 1;
    range[t] = v;
  }
  const float wlen = __fsub_rn(w1, w0);
  // the output column whose position is about source column b
  auto col_guess = [&](int b) {
    return __fdividef(((float)b + 0.5f - w0) * (float)OW, wlen) - 0.5f;
  };
  int JA = 0, JB = -1;
  {
    const int qa = max(q0, wlo), qb = min(q1 - 1, whi);
    if (qa <= qb) {
      const bool est = wlen > 0.f;
      JA = qa == wlo || !est
               ? 0
               : (int)fmaxf(0.f, fminf(floorf(col_guess(qa - 2)) - 2.f,
                                       (float)OW));
      JB = qb == whi || !est
               ? OW - 1
               : (int)fminf((float)(OW - 1),
                            fmaxf(ceilf(col_guess(qb + 2)) + 2.f, -1.f));
    }
  }
  const bool tabled = JB - JA < kCtab;
  if (tabled)
    for (int k = t; k <= JB - JA; k += kThreads)
      ctab[k] = cubic_taps(crop_pos(JA + k, OW, w0, w1), wlo, whi);
  __syncthreads();
  const int ia = range[0], ib = range[1];
  // row taps of output rows [i, i + kThreads)
  auto build_rtab = [&](int i) {
    if (i + t <= ib)
      rtab[t] = cubic_taps(crop_pos(i + t, OH, h0, h1), hlo, hhi);
  };
  build_rtab(ia);

  // this pixel's output columns [ja, jb] and its column terms, j
  // ascending, taps in order
  const int q = q0 + t;
  const bool has = q < q1;
  int ja = 0, jb = -1;
  if (has && q >= wlo && q <= whi) {
    if (tabled) {
      // the first j whose last tap is ≥ q, the last whose first is ≤ q:
      // the closed form's estimate, stepped on the table
      auto guess = [&](int b) {
        const float e = col_guess(b);
        return wlen > 0.f && e > (float)JA ? (int)fminf(ceilf(e), JB + 1.f)
                                           : JA;
      };
      ja = first_true(JA, JB + 1, guess(q - 2),
                      [&](int j) { return ctab[j - JA].i[3] >= q; });
      jb = first_true(JA, JB + 1, guess(q + 2),
                      [&](int j) { return ctab[j - JA].i[0] > q; }) - 1;
    } else {
      tapping(q, OW, w0, w1, wlo, whi, &ja, &jb);
    }
  }
  auto col_taps = [&](int j) {
    return tabled ? ctab[j - JA]
                  : cubic_taps(crop_pos(j, OW, w0, w1), wlo, whi);
  };
  int cnt = 0;
  for (int j = ja; j <= jb && cnt <= kTerms; ++j) {
    const Cubic cx = col_taps(j);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (cx.i[a] != q) continue;
      if (cnt < kTerms)
        terms[cnt * kThreads + t] =
            make_int2(j * C, __float_as_int(cx.w[a]));
      ++cnt;
    }
  }
  // a pixel with more terms than registers hold is heavy: its gt is
  // formed by the CTA, a thread an output row and heavy pixel
  int slot = -1;
  if (cnt > kTerms || (kSmemGt && cnt > 0)) {
    slot = atomicAdd(&range[2], 1);  // which slot: no bearing on values
    heavy[3 * slot] = q;
    heavy[3 * slot + 1] = ja;
    heavy[3 * slot + 2] = jb;
  }
  int toff[kTerms];
  float tw[kTerms];
#pragma unroll
  for (int m = 0; m < kTerms; ++m) {
    const int2 v = m < cnt ? terms[m * kThreads + t] : make_int2(0, 0);
    toff[m] = v.x;
    tw[m] = __int_as_float(v.y);
  }
  __syncthreads();  // the row taps and the heavy pixels written
  const int nheavy = range[2];
  // output rows a chunk: the heavy pixels' gt at them fill hgt (a power of
  // two, so that a chunk of row taps holds whole chunks, and a mask finds
  // a chunk's first row)
  int L = kThreads;
  while (L > 1 && nheavy * L > kHeavy * kThreads) L >>= 1;
  const int lmask = L - 1;

  // pixel q's column of gx; band rows no output row taps are 0
  float* gxq = gx + ((long long)n * H * W + q) * C;
  const long long WC = (long long)W * C;
  if (has)
    for (int r = r0; r < r1; ++r)
      if (ia > ib || r < hlo || r > hhi)
        for (int c = 0; c < C; ++c) gxq[r * WC + c] = 0.f;

  const long long OWC = (long long)OW * C;
  const float* gn = g + (long long)n * OH * OWC;
  for (int c0 = 0; c0 < C; c0 += kG) {
    const int nc = min(kG, C - c0);
    float A[4][kG];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < kG; ++c) A[k][c] = 0.f;
    int wb = 0;  // the row of A[0]; a row is stored where the band has it
    for (int i = ia; i <= ib; ++i) {
      const int di = i - ia;
      if ((di & lmask) == 0) {  // a chunk of output rows
        if (i > ia) {
          __syncthreads();  // the last chunk's row taps and gt read
          if ((di & (kThreads - 1)) == 0) build_rtab(i);
        }
        // the heavy pixels' gt at output rows i … i + L − 1, their terms in
        // order (g loaded before the taps are compared, two columns in
        // flight); neighbouring threads take neighbouring pixels of a row
        for (int p = t; p < nheavy * L; p += kThreads) {
          const int row = i + p / nheavy, h = p % nheavy;
          if (row > ib) break;
          const float* gr = gn + row * OWC + c0;
          const int hq = heavy[3 * h];
          float s[kG];
#pragma unroll
          for (int c = 0; c < kG; ++c) s[c] = 0.f;
#pragma unroll 2
          for (int j = heavy[3 * h + 1]; j <= heavy[3 * h + 2]; ++j) {
            float v[kG];
#pragma unroll
            for (int c = 0; c < kG; ++c) v[c] = c < nc ? gr[j * C + c] : 0.f;
            const Cubic cx = col_taps(j);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              if (cx.i[a] != hq) continue;
#pragma unroll
              for (int c = 0; c < kG; ++c)
                if (c < nc) s[c] = __fadd_rn(s[c], __fmul_rn(v[c], cx.w[a]));
            }
          }
#pragma unroll
          for (int c = 0; c < kG; ++c) hgt[p * kG + c] = s[c];
        }
        if (i > ia || nheavy > 0) __syncthreads();
      }
      // output row i: gt = Σ g[i, j]·wx over the pixel's terms (all code
      // here, none in a lambda or through an index that is not constant,
      // so that A, toff and tw stay in registers)
      const float* gr = gn + i * OWC + c0;
      float s[kG];
#pragma unroll
      for (int c = 0; c < kG; ++c) s[c] = 0.f;
      if (kCut & 4) {
      } else if (slot >= 0) {  // heavy: formed by the CTA at this chunk
#pragma unroll
        for (int c = 0; c < kG; ++c)
          s[c] = hgt[((di & lmask) * nheavy + slot) * kG + c];
      } else {
        // the first kHoist terms' loads issued together (an unused term
        // reads offset 0, in the row; no channel past C is read), their
        // products taken by selects
        float gv[kHoist][kG];
#pragma unroll
        for (int m = 0; m < kHoist; ++m)
#pragma unroll
          for (int c = 0; c < kG; ++c)
            gv[m][c] = c < nc ? gr[toff[m] + c] : 0.f;
#pragma unroll
        for (int m = 0; m < kHoist; ++m)
#pragma unroll
          for (int c = 0; c < kG; ++c) {
            const float v = __fadd_rn(s[c], __fmul_rn(gv[m][c], tw[m]));
            s[c] = m < cnt && c < nc ? v : s[c];
          }
#pragma unroll
        for (int m = kHoist; m < kTerms; ++m) {
          if (m >= cnt) break;
#pragma unroll
          for (int c = 0; c < kG; ++c)
            if (c < nc)
              s[c] = __fadd_rn(s[c], __fmul_rn(gr[toff[m] + c], tw[m]));
        }
      }
      // wy·gt into the accumulators of its rows, rows no later output row
      // taps first stored; the walk starts at the band's first row in the
      // window, so that rows above the first output row's taps are stored
      // (as 0) too
      const Cubic ry = rtab[di & (kThreads - 1)];
      if (i == ia) wb = min(ry.i[0], max(r0, hlo));
      for (; wb < ry.i[0]; ++wb) {
        if (has && wb >= r0 && wb < r1)
#pragma unroll
          for (int c = 0; c < kG; ++c)
            if (c < nc) gxq[wb * WC + c0 + c] = A[0][c];
#pragma unroll
        for (int c = 0; c < kG; ++c) {
          A[0][c] = A[1][c];
          A[1][c] = A[2][c];
          A[2][c] = A[3][c];
          A[3][c] = 0.f;
        }
      }
      if (kCut & 8) continue;
      if (ry.i[3] == wb + 3) {  // four rows, unclamped: tap k is A[k]
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < kG; ++c)
            A[k][c] = __fadd_rn(A[k][c], __fmul_rn(s[c], ry.w[k]));
      } else {  // taps clamped onto one row at a window edge: each slot
                // takes its taps' terms in tap order (selects, not
                // branches, so that no index into A is computed)
#pragma unroll
        for (int slot = 0; slot < 4; ++slot)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const bool hit = ry.i[k] - wb == slot;
#pragma unroll
            for (int c = 0; c < kG; ++c) {
              const float v =
                  __fadd_rn(A[slot][c], __fmul_rn(s[c], ry.w[k]));
              A[slot][c] = hit ? v : A[slot][c];
            }
          }
      }
    }
    // the last four rows, then the band's rows in the window below the
    // last output row's taps (0)
    if (has && ia <= ib) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = wb + k;
        if (r <= hhi && r >= r0 && r < r1)
#pragma unroll
          for (int c = 0; c < kG; ++c)
            if (c < nc) gxq[r * WC + c0 + c] = A[k][c];
      }
      for (int r = max(wb + 4, r0); r <= min(r1 - 1, hhi); ++r)
#pragma unroll
        for (int c = 0; c < kG; ++c)
          if (c < nc) gxq[r * WC + c0 + c] = 0.f;
    }
    if (ib - ia >= kThreads || nheavy > 0) {  // before the next channels'
      __syncthreads();                         // row taps and heavy gt
      build_rtab(ia);
      __syncthreads();
    }
  }
}

// Shared memory of the forward's CTA: the band's row taps and R, whose
// floats are at most fwd_span(tw)·C + 3 (the float4 boundary below the
// first source column) in whole float4s. A tile of tw output columns taps
// at most min(W, ⌊(tw − 1)·W/OW⌋ + kSpanPad) source columns: the bases of
// its ends differ by at most ⌊(tw − 1)·W/OW⌋ + 2 (the window is at most W
// wide; two float32 positions' floors) and the taps reach 1 below and 2
// above.
long long fwd_span(int tw, int W, int OW) {
  const long long s = (long long)(tw - 1) * W / OW + kSpanPad;
  return s < W ? s : W;
}
long long fwd_smem(int band, int tw, int W, int C, int OW) {
  return 32LL * band + 16LL * ((fwd_span(tw, W, OW) * C + 6) / 4);
}
constexpr int kBwdSmem = (32 + 8 * kTerms) * kThreads + 32 * kCtab + 16 +
                         12 * kThreads + 16 * kHeavy * kThreads;

template <typename... P, typename... A>
int launch(void (*kernel)(P...), long long grid, long long smem,
           cudaStream_t st, A... args) {
  if (smem > kMaxSmem || grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned int)grid, kThreads, (int)smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, H, W, C) float32; y: (N, OH, OW, C); apex: (4,) float32 on the
// device; band (output rows a CTA) and tw (output columns a tile): the
// forward of kernels/crop_cubic.py plan.
extern "C" int vwfd_crop_cubic_fwd(const void* x, const void* apex, void* y,
                                   int N, int H, int W, int C, int OH,
                                   int OW, int band, int tw, void* stream) {
  if ((long long)N * OH * OW == 0 || C == 0) return (int)cudaSuccess;
  if (band < 1 || tw < 1 || (long long)W * C > (1 << 28))
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)N * ((OH + band - 1) / band) *
                         ((OW + tw - 1) / tw);
  const int vec = (W * C) % 4 == 0 && vwfd::aligned16({x}) ? 1 : 0;
  const auto* xp = static_cast<const float*>(x);
  const auto* ap = static_cast<const float*>(apex);
  auto* yp = static_cast<float*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
  const long long smem = fwd_smem(band, tw, W, C, OW);
  return C == 3 ? launch(crop_cubic_fwd_kernel<3>, grid, smem, st, xp, ap,
                         yp, H, W, C, OH, OW, band, tw, vec)
                : launch(crop_cubic_fwd_kernel<0>, grid, smem, st, xp, ap,
                         yp, H, W, C, OH, OW, band, tw, vec);
}

// g: (N, OH, OW, C) float32; gx: (N, H, W, C), every element written;
// band (input rows a CTA) and tq (input columns a tile): the backward of
// kernels/crop_cubic.py plan.
extern "C" int vwfd_crop_cubic_bwd(const void* g, const void* apex,
                                   void* gx, int N, int H, int W, int C,
                                   int OH, int OW, int band, int tq,
                                   void* stream) {
  if ((long long)N * H * W == 0 || C == 0) return (int)cudaSuccess;
  if (band < 1 || tq < 1 || (long long)OW * C > (1 << 28))
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)N * ((H + band - 1) / band) *
                         ((W + tq - 1) / tq);
  const auto* gp = static_cast<const float*>(g);
  const auto* ap = static_cast<const float*>(apex);
  auto* dp = static_cast<float*>(gx);
  const auto st = static_cast<cudaStream_t>(stream);
  return C == 3 ? launch(crop_cubic_bwd_kernel<3>, grid, kBwdSmem, st, gp,
                         ap, dp, H, W, C, OH, OW, band, tq)
                : launch(crop_cubic_bwd_kernel<0>, grid, kBwdSmem, st, gp,
                         ap, dp, H, W, C, OH, OW, band, tq);
}
