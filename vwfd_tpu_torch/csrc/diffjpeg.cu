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
// backward reads x and g and writes gx (36): 0.0751 ms at 64 frames of
// 256² at 3.35 TB/s. At the JPEG-vs-adversarial study's single 32² image
// the bytes take 7 ns: there the chain of dependent steps of one
// macroblock is the time.
//
// Design: two routes, chosen on the host by kernels/diffjpeg.py::plan,
// which passes the route and the grid.
//
// - The bytes route (a batch): persistent CTAs (kernels/diffjpeg.py::
//   CTAS_PER_SM, 4 forward, 2 backward, as shared memory allows) walk a
//   contiguous range of units, a unit being 16 rows × up to 128 pixels of
//   one frame (8 macroblocks; 4:2:0 ties a 16×16 macroblock together). A
//   producer warp moves each unit's rows (and g's) with 1-D bulk copies
//   into a ring of two shared-memory stages, completing on an mbarrier,
//   so unit k+1 loads while unit k transforms, and stores the results from
//   the stage with bulk copies. Sixteen consumer threads own a macroblock,
//   thread q its pixel column q: it maps the column to YCbCr in place in
//   the stage (interleaved rows; no global load of its own), then thread
//   (h, c) = (q / 8, q % 8) runs column c of three 8×8 blocks: the Y block
//   above and the one below its column, and column c of chroma plane h,
//   whose 2×2 means it takes from the stage, as K5's per-thread chain (an
//   8-term FMA chain per value, the matrix an immediate, a padded tile for
//   each transpose); then thread q maps its column back to RGB in place.
//   The macroblock's threads share a warp, so __syncwarp orders them; the
//   backward keeps r0' of its three coefficient rows in registers. Every
//   consumer thread runs every unit whole, a ragged last unit's idle
//   columns on stale shared memory that is never stored, so every thread
//   reaches every __syncwarp and mbarrier.
// - The latency route (too few macroblocks to fill the card, as the
//   study's 4): a CTA of 384 threads a macroblock (grid-stride), a thread
//   per value of each pass: thread (b, r, s) computes output (r, s) of
//   block b of each of the four passes as the same 8-term fmaf chain over
//   i ascending as the per-thread chain does (its row and column of the
//   DCT matrix in registers: which row varies by thread), one
//   __syncthreads between passes; r0' of its coefficient stays in a
//   register for the backward. x (and g) move as coalesced 16-byte loads,
//   the results as 16-byte stores from shared memory.
//
// Both routes compute each value with the operations, operands and order of
// the first version (one route, a CTA of 256 threads over 4 macroblocks):
// the colour maps, the means, c/t (correctly rounded), the soft round, the
// clip and /255 rounded operation by operation in the plain version's
// order, the DCT sums as fmaf chains over i ascending. So they are meant
// to be bit-identical to it and to each other: port_tools/k24_identity.py
// --compare holds this build against the first on the card.
// The DCT sums in another order than torch.matmul, so a coefficient within
// rounding of |c/t| = ½ (r0's jump) may land on the other side: kernel and
// plain then part on that macroblock (kernels/diffjpeg.py::tie_macroblocks).
// No tensor cores: TF32 would move coefficients across that jump.
#include "common.cuh"

#include <climits>

namespace {

using vwfd::col_to_row;
using vwfd::dct8;
using vwfd::dct_c;
using vwfd::dot3;
using vwfd::kTB;
using vwfd::row_to_col;
using vwfd::smem_u32;

enum Route : int { kBytes = 0, kLatency = 1 };  // kernels/diffjpeg.py::ROUTES

// the Annex-K tables, transposed as DiffJPEG takes them: Y (kTab[k*8 + l]
// = Y_TABLE[l][k]) then chroma (vwfd_tpu/attacks/jpeg.py:23-36,110-111)
__constant__ float kTab[128] = {
    16, 12, 14, 14, 18, 24, 49, 72,   11, 12, 13, 17, 22, 35, 64, 92,
    10, 14, 16, 22, 37, 55, 78, 95,   16, 19, 24, 29, 56, 64, 87, 98,
    24, 26, 40, 51, 68, 81, 103, 112, 40, 58, 57, 87, 109, 104, 121, 100,
    51, 60, 69, 80, 103, 113, 120, 103, 61, 55, 56, 62, 77, 92, 101, 99,
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

// 255·x of one pixel to YCbCr, in place
__device__ __forceinline__ void pixel_ycc(float* p) {
  const float v[3] = {__fmul_rn(p[0], 255.f), __fmul_rn(p[1], 255.f),
                      __fmul_rn(p[2], 255.f)};
  to_ycc(v, p);
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

// The 2×2 mean of a chroma plane: ((f00 + f01) + f10) + f11, times ¼
__device__ __forceinline__ float mean4(float f00, float f01, float f10,
                                       float f11) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(f00, f01), f10), f11),
                   0.25f);
}

// The repeat's backward: the four copies' sum (f00 + f01) + (f10 + f11)
__device__ __forceinline__ float sum4(float f00, float f01, float f10,
                                      float f11) {
  return __fadd_rn(__fadd_rn(f00, f01), __fadd_rn(f10, f11));
}

// The output's gradient g of a pixel through /255, the clip (at the
// pre-clip value o) and RGBᵀ: Y's, then Cb's and Cr's at full resolution
__device__ __forceinline__ void grad_in(const float* o, const float* g,
                                        float* d) {
  float gr[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    gr[ch] = __fmul_rn(__fdiv_rn(g[ch], 255.f), clip255_grad(o[ch]));
  d[0] = __fadd_rn(__fadd_rn(gr[0], gr[1]), gr[2]);
  d[1] = __fadd_rn(__fmul_rn(gr[1], (float)-0.344136),
                   __fmul_rn(gr[2], (float)1.772));
  d[2] = __fadd_rn(__fmul_rn(gr[0], (float)1.402),
                   __fmul_rn(gr[1], (float)-0.714136));
}

// The input's gradient of a pixel from Y's and the pooled chroma's
// (before their ¼): YCbCrᵀ, ·255
__device__ __forceinline__ void grad_out(float gy, float gcb4, float gcr4,
                                         float* p) {
  const float gcb = __fmul_rn(gcb4, 0.25f), gcr = __fmul_rn(gcr4, 0.25f);
  p[0] = __fmul_rn(dot3(gy, gcb, gcr, (float)0.299, (float)-0.168736, 0.5f),
                   255.f);
  p[1] = __fmul_rn(dot3(gy, gcb, gcr, (float)0.587, (float)-0.331264,
                        (float)-0.418688), 255.f);
  p[2] = __fmul_rn(dot3(gy, gcb, gcr, (float)0.114, 0.5f, (float)-0.081312),
                   255.f);
}

// r0(c/t)·t of one coefficient, and with kSave r0' (NaN where c is not
// finite, as autograd's where())
template <bool kSave>
__device__ __forceinline__ float quantize(float c, float t, float* dr) {
  const float q = __fdiv_rn(c, t);
  const bool small = fabsf(q) < 0.5f;
  if (kSave)
    *dr = __fadd_rn(small ? __fmul_rn(3.f, __fmul_rn(q, q)) : 1.f,
                    __fmul_rn(0.f, c));
  return __fmul_rn(small ? __fmul_rn(__fmul_rn(q, q), q) : q, t);
}

// the backward of quantize at the coefficient's gradient a: ((a·t)·r0')/t
__device__ __forceinline__ float quantize_bwd(float a, float t, float dr) {
  return __fdiv_rn(__fmul_rn(__fmul_rn(a, t), dr), t);
}

// ------------------------------------------------------------ bytes route

constexpr int kUnitMB = 8;                  // macroblocks per unit
constexpr int kCols = 16 * kUnitMB;         // pixels per unit row (128)
constexpr int kRowF = 3 * kCols;            // floats per staged row (384)
constexpr int kSlotF = 16 * kRowF;          // floats per staged unit (24 KB)
constexpr int kStages = 2;
constexpr int kConsumers = 16 * kUnitMB;    // a thread per pixel column
constexpr int kThreadsB = kConsumers + 32;  // and one producer warp
constexpr int kTiles = kConsumers / 8;      // a transpose tile per 8 threads
constexpr int kCtasFwd = 4, kCtasBwd = 2;   // per SM: kernels/diffjpeg.py

// One 8×8 block, its thread c holding column c in v (the plane − 128): the
// DCT, r0(c/t)·t on row c of the coefficients (t = tab[c][l]·f), the IDCT;
// v gets column c back. With kSave, r0' of row c goes to dr.
template <bool kSave>
__device__ __forceinline__ void block_fwd(float* tile, int c,
                                          const float* tab, float f,
                                          float* v, float* dr) {
  float a[8], t[8];
  const float4* tr = reinterpret_cast<const float4*>(tab + c * 8);
  const float4 t0 = tr[0], t1 = tr[1];
  t[0] = t0.x, t[1] = t0.y, t[2] = t0.z, t[3] = t0.w;
  t[4] = t1.x, t[5] = t1.y, t[6] = t1.z, t[7] = t1.w;
  dct8<false>(v, a);                 // along the column
  col_to_row(tile, c, a, v);         // row c of C·B
  dct8<false>(v, a);                 // coefficients (c, l)
#pragma unroll
  for (int l = 0; l < 8; ++l)
    a[l] = quantize<kSave>(a[l], __fmul_rn(t[l], f), dr + l);
  dct8<true>(a, v);                  // IDCT along row c
  row_to_col(tile, c, v, a);         // column c
  dct8<true>(a, v);                  // ... and along the column
}

// Its backward on the gradient's column c in v: DCT, quantize_bwd, IDCT.
__device__ __forceinline__ void block_bwd(float* tile, int c,
                                          const float* tab, float f,
                                          float* v, const float* dr) {
  float a[8], t[8];
  const float4* tr = reinterpret_cast<const float4*>(tab + c * 8);
  const float4 t0 = tr[0], t1 = tr[1];
  t[0] = t0.x, t[1] = t0.y, t[2] = t0.z, t[3] = t0.w;
  t[4] = t1.x, t[5] = t1.y, t[6] = t1.z, t[7] = t1.w;
  dct8<false>(v, a);
  col_to_row(tile, c, a, v);
  dct8<false>(v, a);
#pragma unroll
  for (int l = 0; l < 8; ++l)
    a[l] = quantize_bwd(a[l], __fmul_rn(t[l], f), dr[l]);
  dct8<true>(a, v);
  row_to_col(tile, c, v, a);
  dct8<true>(a, v);
}

// One unit: 16 rows × pixels [128·grp, 128·grp + cols) of frame n, as a
// run of 16 rows starting at pixel px0. Unit indices are 32-bit.
struct Unit {
  int n;
  long long px0;
  int bytes;  // of one row: cols · 12
};

__device__ __forceinline__ Unit unit_of(int u, int H, int W) {
  const int G = (W + kCols - 1) / kCols, hm = H / 16;
  const int t = u / G, grp = u - t * G;
  const int n = t / hm, band = t - n * hm;
  return {n, ((long long)n * H + 16 * band) * W + (long long)grp * kCols,
          min(kCols, W - grp * kCols) * 12};
}

// The producer (one thread): loads unit u into stage (u - u0) % 2 once the
// stage's previous unit is stored, x's rows (and g's for the backward);
// stores each unit from its x stage once its consumers are done.
template <bool kBwd>
__device__ void produce(float* sx, float* sg, uint64_t* full, uint64_t* done,
                        const float* x, const float* g, float* out, int u0,
                        int u1, int H, int W) {
  const int rowb = W * 12;
  for (int k = 0; k < u1 - u0 + kStages; ++k) {
    const int u = u0 + k, s = k % kStages;
    if (k >= kStages) {  // unit u - 2 computed: store it, free its stage
      vwfd::mbar_wait(smem_u32(&done[s]), (k / kStages - 1) & 1);
      const Unit d = unit_of(u - kStages, H, W);
      vwfd::bulk_store_rows(reinterpret_cast<uint8_t*>(out + d.px0 * 3),
                            reinterpret_cast<uint8_t*>(sx + s * kSlotF),
                            kRowF * 4, 16, rowb, 1, 0, d.bytes);
      vwfd::bulk_wait_read();
    }
    if (u >= u1) continue;
    const Unit a = unit_of(u, H, W);
    const uint32_t bar = smem_u32(&full[s]);
    vwfd::mbar_expect_tx(bar, 16 * a.bytes * (kBwd ? 2 : 1));
    vwfd::bulk_load_rows(reinterpret_cast<uint8_t*>(sx + s * kSlotF),
                         kRowF * 4,
                         reinterpret_cast<const uint8_t*>(x + a.px0 * 3), 16,
                         rowb, a.bytes, bar);
    if (kBwd)
      vwfd::bulk_load_rows(reinterpret_cast<uint8_t*>(sg + s * kSlotF),
                           kRowF * 4,
                           reinterpret_cast<const uint8_t*>(g + a.px0 * 3),
                           16, rowb, a.bytes, bar);
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared memory: the stages of x (and g), the tables, the transpose tiles,
// the barriers.
template <bool kBwd>
constexpr int smem_bytes() {
  return ((kBwd ? 2 : 1) * kStages * kSlotF + 128 + kTiles * kTB) * 4 +
         2 * kStages * 8;
}

struct Layout {
  float *sx, *sg, *tab, *tiles;
  uint64_t *full, *done;
};

template <bool kBwd>
__device__ __forceinline__ Layout layout(float* smem) {
  Layout l;
  l.sx = smem;
  l.sg = smem + kStages * kSlotF;
  l.tab = smem + (kBwd ? 2 : 1) * kStages * kSlotF;
  l.tiles = l.tab + 128;
  l.full = reinterpret_cast<uint64_t*>(l.tiles + kTiles * kTB);
  l.done = l.full + kStages;
  return l;
}

// Barriers and tables, then this CTA's contiguous range [u0, u1) of the
// units.
__device__ __forceinline__ void setup(const Layout& l, int N, int H, int W,
                                      int& u0, int& u1) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      vwfd::mbar_init(smem_u32(&l.full[s]), 1);
      vwfd::mbar_init(smem_u32(&l.done[s]), kConsumers);
    }
    vwfd::mbar_fence_init();
  }
  if (threadIdx.x < 128) l.tab[threadIdx.x] = kTab[threadIdx.x];
  __syncthreads();
  const int U = N * (H / 16) * ((W + kCols - 1) / kCols);
  const int q = U / (int)gridDim.x, r = U - q * (int)gridDim.x;
  const int b = blockIdx.x;
  u0 = b * q + min(b, r);
  u1 = u0 + q + (b < r ? 1 : 0);
}

// The chroma of pixel column q's consumer (h, c): plane h (channel 1 + h)
// at pixel column 2c of its macroblock, row 0 of the stage.
__device__ __forceinline__ float* chroma_of(float* mb, int h, int c) {
  return mb + 6 * c + 1 + h;
}

// Column q's pixels to YCbCr in place, then (h, c)'s pooled chroma column
// (the means of plane h at pixel columns 2c, 2c + 1) in v.
__device__ __forceinline__ void unit_ycc(float* col, const float* chr,
                                         float* v) {
#pragma unroll
  for (int r = 0; r < 16; ++r) pixel_ycc(col + r * kRowF);
  __syncwarp();  // the means read the neighbours' columns
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float* p = chr + 2 * i * kRowF;
    v[i] = mean4(p[0], p[3], p[kRowF], p[kRowF + 3]);
  }
}

// The forward's three blocks of consumer (h, c) = (q / 8, q % 8) of a
// macroblock: column q of the Y blocks above and below, and column c of
// chroma plane h (its pooled column in cv), in place in the stage (the
// chroma repeated 2×2); with kSave their r0' rows in dr[0..2].
template <bool kSave>
__device__ __forceinline__ void unit_blocks(float* col, float* chr,
                                            float* tile, const float* tab,
                                            int c, float f, float* cv,
                                            float (*dr)[8]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v[8];
    float* o = col + 8 * half * kRowF;
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fsub_rn(o[i * kRowF], 128.f);
    block_fwd<kSave>(tile, c, tab, f, v, dr[half]);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i * kRowF] = __fadd_rn(v[i], 128.f);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = __fsub_rn(cv[i], 128.f);
  block_fwd<kSave>(tile, c, tab + 64, f, cv, dr[2]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* p = chr + 2 * i * kRowF;
    p[0] = p[3] = p[kRowF] = p[kRowF + 3] = __fadd_rn(cv[i], 128.f);
  }
}

__global__ void __launch_bounds__(kThreadsB, kCtasFwd)
    diffjpeg_fwd_bytes(const float* __restrict__ x, float* __restrict__ y,
                       const float* __restrict__ factor, int N, int H,
                       int W) {
  extern __shared__ __align__(16) float smem[];
  const Layout l = layout<false>(smem);
  int u0, u1;
  setup(l, N, H, W, u0, u1);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      produce<false>(l.sx, nullptr, l.full, l.done, x, nullptr, y, u0, u1,
                     H, W);
    return;
  }
  const int m = threadIdx.x >> 4, q = threadIdx.x & 15, h = q >> 3,
            c = q & 7;
  float* tile = l.tiles + (threadIdx.x >> 3) * kTB;
  for (int u = u0; u < u1; ++u) {
    const int k = u - u0, s = k % kStages;
    const float f = __ldg(factor + unit_of(u, H, W).n);
    vwfd::mbar_wait(smem_u32(&l.full[s]), (k / kStages) & 1);
    float* mb = l.sx + s * kSlotF + 48 * m;
    float* col = mb + 3 * q;
    float* chr = chroma_of(mb, h, c);
    float cv[8], dr[3][8];
    unit_ycc(col, chr, cv);
    unit_blocks<false>(col, chr, tile, l.tab, c, f, cv, dr);
    __syncwarp();  // column q's chroma is its neighbours'
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float* p = col + r * kRowF;
      const float v[3] = {p[0], p[1], p[2]};
      float o[3];
      to_rgb(v, o);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) p[ch] = __fdiv_rn(clip255(o[ch]), 255.f);
    }
    vwfd::fence_to_bulk();
    vwfd::mbar_arrive(smem_u32(&l.done[s]));
  }
}

__global__ void __launch_bounds__(kThreadsB, kCtasBwd)
    diffjpeg_bwd_bytes(const float* __restrict__ x,
                       const float* __restrict__ g, float* __restrict__ gx,
                       const float* __restrict__ factor, int N, int H,
                       int W) {
  extern __shared__ __align__(16) float smem[];
  const Layout l = layout<true>(smem);
  int u0, u1;
  setup(l, N, H, W, u0, u1);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      produce<true>(l.sx, l.sg, l.full, l.done, x, g, gx, u0, u1, H, W);
    return;
  }
  const int m = threadIdx.x >> 4, q = threadIdx.x & 15, h = q >> 3,
            c = q & 7;
  float* tile = l.tiles + (threadIdx.x >> 3) * kTB;
  for (int u = u0; u < u1; ++u) {
    const int k = u - u0, s = k % kStages;
    const float f = __ldg(factor + unit_of(u, H, W).n);
    vwfd::mbar_wait(smem_u32(&l.full[s]), (k / kStages) & 1);
    float* mb = l.sx + s * kSlotF + 48 * m;
    float* mg = l.sg + s * kSlotF + 48 * m;
    float* col = mb + 3 * q;
    float* gcol = mg + 3 * q;
    float* chr = chroma_of(mb, h, c);
    float* gchr = chroma_of(mg, h, c);
    // the forward from x, keeping r0' of the three coefficient rows
    float cv[8], dr[3][8];
    unit_ycc(col, chr, cv);
    unit_blocks<true>(col, chr, tile, l.tab, c, f, cv, dr);
    __syncwarp();
    // g through /255, the clip and RGBᵀ, in place in g's stage
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* p = col + r * kRowF;
      const float v[3] = {p[0], p[1], p[2]};
      float o[3], d[3];
      to_rgb(v, o);
      float* pg = gcol + r * kRowF;
      grad_in(o, pg, d);
      pg[0] = d[0], pg[1] = d[1], pg[2] = d[2];
    }
    __syncwarp();
    // the repeat's sum into (h, c)'s pooled column, then the three blocks'
    // backward; the chroma's result at pixel (2i, 2c) of plane h
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* p = gchr + 2 * i * kRowF;
      cv[i] = sum4(p[0], p[3], p[kRowF], p[kRowF + 3]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v[8];
      float* o = gcol + 8 * half * kRowF;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = o[i * kRowF];
      block_bwd(tile, c, l.tab, f, v, dr[half]);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i * kRowF] = v[i];
    }
    block_bwd(tile, c, l.tab + 64, f, cv, dr[2]);
#pragma unroll
    for (int i = 0; i < 8; ++i) gchr[2 * i * kRowF] = cv[i];
    __syncwarp();
    // gx over x, in place: pixel column q's chroma from (0, q/2), (1, q/2)
    const float* gq = mg + 6 * (q >> 1);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* pc = gq + (r & ~1) * kRowF;
      grad_out(gcol[r * kRowF], pc[1], pc[2], col + r * kRowF);
    }
    vwfd::fence_to_bulk();
    vwfd::mbar_arrive(smem_u32(&l.done[s]));
  }
}

// ---------------------------------------------------------- latency route

constexpr int kLatThreads = 384;  // a thread per value of a pass: 6 × 64

// Shared memory of a macroblock: its rows of x as loaded (then of the
// output), of g, the Y plane, the full-resolution chroma (the backward's
// gradients there too), the pooled chroma, the passes' two planes a block,
// the tables and the DCT matrix.
struct Lat {
  float xs[16 * 48];
  float gs[16 * 48];
  float y[256];
  float cf[2][256];
  float cp[2][64];
  float pass[2][6][64];
  float tab[128];
  float C[64];
};

// Thread (b, r, s)'s vectors of the DCT matrix: row r, row s, column s,
// column r (the four passes' operands in that order).
struct Mat {
  float rr[8], rs[8], cs[8], cr[8];
};

__device__ __forceinline__ void lat_init(Lat& L, Mat& M, int r, int s) {
  const int t = threadIdx.x;
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int i = 0; i < 8; ++i) L.C[k * 8 + i] = dct_c(k, i);
  }
  if (t < 128) L.tab[t] = kTab[t];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    M.rr[i] = L.C[r * 8 + i];
    M.rs[i] = L.C[s * 8 + i];
    M.cs[i] = L.C[i * 8 + s];
    M.cr[i] = L.C[i * 8 + r];
  }
}

// Σ_i m[i]·in[i] as dct8 sums it: one fmaf chain over i ascending from 0
__device__ __forceinline__ float chain8(const float* m, const float* in) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = fmaf(m[i], in[i], acc);
  return acc;
}

struct Geo {
  int n;
  long long px0;  // the macroblock's top-left pixel
};

__device__ __forceinline__ Geo geo(long long mb, int H, int W) {
  const long long per = (long long)(H / 16) * (W / 16);
  const long long n = mb / per, r = mb - n * per;
  const int wm = W / 16, my = (int)(r / wm), mx = (int)(r - (long long)my * wm);
  return {(int)n, (n * H + 16 * my) * (long long)W + 16 * mx};
}

// the macroblock's 16 rows of 48 floats, a float4 a thread (i < 192)
__device__ __forceinline__ void lat_load(float* s, const float* src,
                                         long long px0, int W, int i) {
  if (i >= 0 && i < 192) {
    const int r = i / 12, k = i - r * 12;
    reinterpret_cast<float4*>(s)[i] = __ldg(
        reinterpret_cast<const float4*>(src + (px0 + (long long)r * W) * 3) +
        k);
  }
}

__device__ __forceinline__ void lat_store(float* dst, const float* s,
                                          long long px0, int W, int i) {
  if (i < 192) {
    const int r = i / 12, k = i - r * 12;
    reinterpret_cast<float4*>(dst + (px0 + (long long)r * W) * 3)[k] =
        reinterpret_cast<const float4*>(s)[i];
  }
}

// x's rows to YCbCr (pixel t), then the chroma's 2×2 means (thread t: mean
// t % 64 of plane t / 64)
__device__ __forceinline__ void lat_ycc(Lat& L, int t) {
  if (t < 256) {
    float* p = L.xs + (t >> 4) * 48 + (t & 15) * 3;
    pixel_ycc(p);
    L.y[t] = p[0], L.cf[0][t] = p[1], L.cf[1][t] = p[2];
  }
  __syncthreads();
  if (t < 128) {
    const int ch = t >> 6, j = t & 63, r = j >> 3, c = j & 7;
    const float* f = L.cf[ch] + (2 * r) * 16 + 2 * c;
    L.cp[ch][j] = mean4(f[0], f[1], f[16], f[17]);
  }
  __syncthreads();
}

// The four passes of block b (0-3 Y, 4 Cb, 5 Cr) for output (r, s), one
// __syncthreads after each: kPass 0 the forward, 1 the forward keeping r0'
// of coefficient (r, s) in dr, 2 the backward on the gradient planes
// with that r0'. The block's plane holds its values before and after.
template <int kPass>
__device__ __forceinline__ void lat_passes(Lat& L, const Mat& M, int b,
                                           int r, int s, float f,
                                           float& dr) {
  int pitch;
  float* pl;
  if (b < 4) {
    pitch = 16;
    pl = L.y + (b >> 1) * 128 + (b & 1) * 8;
  } else {
    pitch = 8;
    pl = L.cp[b - 4];
  }
  float* p0 = L.pass[0][b];
  float* p1 = L.pass[1][b];
  float in[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    in[i] = kPass == 2 ? pl[i * pitch + s] : __fsub_rn(pl[i * pitch + s],
                                                       128.f);
  p0[r * 8 + s] = chain8(M.rr, in);   // (C·B)[r][s]
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) in[i] = p0[r * 8 + i];
  const float coef = chain8(M.rs, in);  // coefficient (r, s)
  const float t = __fmul_rn(L.tab[(b < 4 ? 0 : 64) + r * 8 + s], f);
  p1[r * 8 + s] = kPass == 2 ? quantize_bwd(coef, t, dr)
                             : quantize<kPass == 1>(coef, t, &dr);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) in[i] = p1[r * 8 + i];
  p0[r * 8 + s] = chain8(M.cs, in);   // (d·C)[r][s]
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 8; ++k) in[k] = p0[k * 8 + s];
  const float out = chain8(M.cr, in);  // (Cᵀ·d·C)[r][s]
  pl[r * pitch + s] = kPass == 2 ? out : __fadd_rn(out, 128.f);
  __syncthreads();
}

__global__ void __launch_bounds__(kLatThreads)
    diffjpeg_fwd_latency(const float* __restrict__ x, float* __restrict__ y,
                         const float* __restrict__ factor, int N, int H,
                         int W) {
  __shared__ __align__(16) Lat L;
  const int t = threadIdx.x, b = t >> 6, r = (t >> 3) & 7, s = t & 7;
  Mat M;
  lat_init(L, M, r, s);
  const long long mbs = (long long)N * (H / 16) * (W / 16);
  for (long long mb = blockIdx.x; mb < mbs; mb += gridDim.x) {
    const Geo g = geo(mb, H, W);
    const float f = __ldg(factor + g.n);
    lat_load(L.xs, x, g.px0, W, t);
    __syncthreads();
    lat_ycc(L, t);
    float dr;
    lat_passes<0>(L, M, b, r, s, f, dr);
    if (t < 256) {
      const int ci = (t >> 5) * 8 + ((t & 15) >> 1);
      const float v[3] = {L.y[t], L.cp[0][ci], L.cp[1][ci]};
      float o[3];
      to_rgb(v, o);
      float* p = L.xs + (t >> 4) * 48 + (t & 15) * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) p[ch] = __fdiv_rn(clip255(o[ch]), 255.f);
    }
    __syncthreads();
    lat_store(y, L.xs, g.px0, W, t);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kLatThreads)
    diffjpeg_bwd_latency(const float* __restrict__ x,
                         const float* __restrict__ g, float* __restrict__ gx,
                         const float* __restrict__ factor, int N, int H,
                         int W) {
  __shared__ __align__(16) Lat L;
  const int t = threadIdx.x, b = t >> 6, r = (t >> 3) & 7, s = t & 7;
  Mat M;
  lat_init(L, M, r, s);
  const long long mbs = (long long)N * (H / 16) * (W / 16);
  for (long long mb = blockIdx.x; mb < mbs; mb += gridDim.x) {
    const Geo gm = geo(mb, H, W);
    const float f = __ldg(factor + gm.n);
    lat_load(L.xs, x, gm.px0, W, t);
    lat_load(L.gs, g, gm.px0, W, t - 192);
    __syncthreads();
    lat_ycc(L, t);
    float dr;
    lat_passes<1>(L, M, b, r, s, f, dr);
    const int ci = (t >> 5) * 8 + ((t & 15) >> 1);
    if (t < 256) {  // the output's gradient: Y's, the chroma's full-size
      const float v[3] = {L.y[t], L.cp[0][ci], L.cp[1][ci]};
      float o[3], d[3];
      to_rgb(v, o);
      grad_in(o, L.gs + (t >> 4) * 48 + (t & 15) * 3, d);
      L.y[t] = d[0], L.cf[0][t] = d[1], L.cf[1][t] = d[2];
    }
    __syncthreads();
    if (t < 128) {  // the repeat's backward into the pooled planes
      const int ch = t >> 6, j = t & 63, rr = j >> 3, c = j & 7;
      const float* fp = L.cf[ch] + (2 * rr) * 16 + 2 * c;
      L.cp[ch][j] = sum4(fp[0], fp[1], fp[16], fp[17]);
    }
    __syncthreads();
    lat_passes<2>(L, M, b, r, s, f, dr);
    if (t < 256)
      grad_out(L.y[t], L.cp[0][ci], L.cp[1][ci],
               L.xs + (t >> 4) * 48 + (t & 15) * 3);
    __syncthreads();
    lat_store(gx, L.xs, gm.px0, W, t);
    __syncthreads();
  }
}

// ------------------------------------------------------------- launchers

// What both routes refuse: H or W not a multiple of 16, more macroblocks
// than INT_MAX, a route other than the two, no CTA, a tensor off the
// 16-byte grid (the bulk copies and the 16-byte accesses).
bool refused(int N, int H, int W, int route, int grid,
             std::initializer_list<const void*> ptrs) {
  return H % 16 || W % 16 ||
         (long long)N * (H / 16) * (W / 16) > INT_MAX ||
         (route != kBytes && route != kLatency) || grid < 1 ||
         !vwfd::aligned16(ptrs);
}

}  // namespace

extern "C" int vwfd_diffjpeg_fwd(const void* x, void* y, const void* factor,
                                 int N, int H, int W, int route, int grid,
                                 void* stream) {
  if ((long long)N * H * W == 0) return (int)cudaGetLastError();
  if (refused(N, H, W, route, grid, {x, y}))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto px = static_cast<const float*>(x);
  const auto f = static_cast<const float*>(factor);
  if (route == kBytes) {
    constexpr int smem = smem_bytes<false>();
    const cudaError_t e = cudaFuncSetAttribute(
        diffjpeg_fwd_bytes, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    diffjpeg_fwd_bytes<<<grid, kThreadsB, smem, st>>>(
        px, static_cast<float*>(y), f, N, H, W);
  } else {
    diffjpeg_fwd_latency<<<grid, kLatThreads, 0, st>>>(
        px, static_cast<float*>(y), f, N, H, W);
  }
  return (int)cudaGetLastError();
}

extern "C" int vwfd_diffjpeg_bwd(const void* x, const void* g, void* gx,
                                 const void* factor, int N, int H, int W,
                                 int route, int grid, void* stream) {
  if ((long long)N * H * W == 0) return (int)cudaGetLastError();
  if (refused(N, H, W, route, grid, {x, g, gx}))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto px = static_cast<const float*>(x);
  const auto pg = static_cast<const float*>(g);
  const auto f = static_cast<const float*>(factor);
  if (route == kBytes) {
    constexpr int smem = smem_bytes<true>();
    const cudaError_t e = cudaFuncSetAttribute(
        diffjpeg_bwd_bytes, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    diffjpeg_bwd_bytes<<<grid, kThreadsB, smem, st>>>(
        px, pg, static_cast<float*>(gx), f, N, H, W);
  } else {
    diffjpeg_bwd_latency<<<grid, kLatThreads, 0, st>>>(
        px, pg, static_cast<float*>(gx), f, N, H, W);
  }
  return (int)cudaGetLastError();
}
