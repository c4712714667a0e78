// The first-version int8 implicit-GEMM core of K12 `qconv_t` (qconv_t.cu),
// and the prologue loads (Src, load_a: int8 copy, 2x2 max-pool, quantize)
// and epilogue helpers that K11 and K13's wgmma core (qwgmma.cuh) reuses.
// Its 3x3, dual-source and split-row paths served K11 and K13 before they
// moved to qwgmma.cuh; they go when K12 moves too and this file is retired
// (ROADMAP).
//
// One block computes exact int32 products of kBM output pixels x kBN output
// columns: A is the im2col view of an int8 NHWC activation (3x3 SAME or
// 1x1), B an int8 weight matrix of rows (output columns) x (ks*ks*cin),
// K contiguous in (tap, input channel) order (OHWI). With two sources
// (DUAL) the block keeps one accumulator set per source, because the two
// operands carry their own scales (the split decoder conv, the split
// coupling head).
//
// Per stage of kKC = 32 input channels the block stages, in shared memory:
// * A: for 3x3, the zero-padded halo of its kTH x kTW pixel tile, (kTH+2) x
//   (kTW+2) pixels; for 1x1, its kBM flat pixels. Pixels sit kAPix = 48 bytes
//   apart, so that the eight rows of a fragment load hit distinct banks.
//   The loader applies the source's prologue: a plain int8 copy, the 2x2
//   max-pool of an int8 input (byte-wise signed max), or the quantization of
//   a float32 / bf16 input, clip(rint(x / s), -127, 127) with an IEEE
//   division (__fdiv_rn), as the plain version's division by a 0-dim tensor.
// * B: the kBN weight rows of the stage's channels, all taps, kBRow bytes
//   apart (again conflict-free fragment loads).
// Padding pixels, channels past cin and rows past the matrix stage as 0,
// which is what SAME zero padding contributes.
//
// Products: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, fragments read
// from shared memory with 32-bit loads; 8 warps as 4 (pixels) x 2 (columns),
// each a 32 x 32 tile (2 x 4 mma tiles). The sums are exact int32 (|acc| <
// 127^2 * 9 * cin < 2^31 for cin < 14,800), so every kernel built on this
// core equals a plain version that sums in float64 bit for bit.
//
// First version, simple and right: one stage buffer, the loads through
// registers, two barriers a stage.
#pragma once

#include "common.cuh"

namespace vwfd {
namespace qmma {

constexpr int kWarpsM = 4, kWarpsN = 2;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kBM = 32 * kWarpsM;  // output pixels a block
constexpr int kBN = 32 * kWarpsN;  // output columns a block
constexpr int kKC = 32;            // input channels a stage (one mma depth)
constexpr int kTH = 8, kTW = 16;   // 3x3: the block's pixel tile
constexpr int kAPix = kKC + 16;    // bytes between staged pixels
static_assert(kTH * kTW == kBM, "a 3x3 tile is kBM pixels");
static_assert(kTW == 16, "a 16-row fragment is one row of the pixel tile");

template <int KS>
struct Shape {
  static constexpr int kAPixels = KS == 3 ? (kTH + 2) * (kTW + 2) : kBM;
  static constexpr int kBRow = KS * KS * kKC + 16;  // bytes between B rows
  static constexpr int kABytes = kAPixels * kAPix;
  static constexpr int kBBytes = kBN * kBRow;
};

// What a source's loader applies to its input (kernels/qconv.py::_KINDS).
enum Kind : int { kI8 = 0, kI8Pool = 1, kQuantF32 = 2, kQuantBF16 = 3 };

struct Src {
  const void* x;       // NHWC activations: pixel stride ld, channel stride 1
  const int8_t* w;     // (rows, ks*ks*cin) int8, K contiguous
  const float* scale;  // kQuant*: the device scalar s of x / s
  int kind;
  int ld;              // elements between pixels of x
  int cin;
  int hin, win;        // x's spatial size (kI8Pool: pooled to H x W)
  int va, vb;          // bytes a load unit of A / B: 16, 4 or 1 (host picks)
};

// Output geometry of a launch and the block's place in it.
struct Geo {
  int N, H, W;         // output (= the conv's input after pooling) size
  long long M;         // N*H*W
  int img, y0, x0;     // 3x3: the block's tile origin
  long long m0;        // 1x1: the block's first flat pixel
};

template <int KS>
__device__ __forceinline__ Geo block_geo(int N, int H, int W) {
  Geo g;
  g.N = N;
  g.H = H;
  g.W = W;
  g.M = (long long)N * H * W;
  if (KS == 3) {
    const int tx = (W + kTW - 1) / kTW, ty = (H + kTH - 1) / kTH;
    const int b = blockIdx.x, img = b / (tx * ty), r = b - img * tx * ty;
    g.img = img;
    g.y0 = (r / tx) * kTH;
    g.x0 = (r % tx) * kTW;
    g.m0 = 0;
  } else {
    g.img = g.y0 = g.x0 = 0;
    g.m0 = (long long)blockIdx.x * kBM;
  }
  return g;
}

template <int KS>
__host__ inline unsigned int grid_pixels(int N, int H, int W) {
  if (KS == 3)
    return (unsigned int)N * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  return (unsigned int)(((long long)N * H * W + kBM - 1) / kBM);
}

// Staged A pixel p -> the conv-input pixel (img, y, x); false for padding.
template <int KS>
__device__ __forceinline__ bool staged_pixel(const Geo& g, int p, int& img,
                                             int& y, int& x) {
  if (KS == 3) {
    const int r = p / (kTW + 2), c = p - r * (kTW + 2);
    img = g.img;
    y = g.y0 - 1 + r;
    x = g.x0 - 1 + c;
    return y >= 0 && y < g.H && x >= 0 && x < g.W;
  }
  const long long f = g.m0 + p;
  if (f >= g.M) return false;
  const long long t = f / g.W;
  x = (int)(f - t * g.W);
  img = (int)(t / g.H);
  y = (int)(t - (long long)img * g.H);
  return true;
}

// Output row r of the block (0..kBM) -> (img, y, x) of the output grid.
template <int KS>
__device__ __forceinline__ bool out_pixel(const Geo& g, int r, int& img,
                                          int& y, int& x) {
  if (KS == 3) {
    img = g.img;
    y = g.y0 + r / kTW;
    x = g.x0 + r % kTW;
    return y < g.H && x < g.W;
  }
  return staged_pixel<1>(g, r, img, y, x);
}

// Flat index of an output pixel.
__device__ __forceinline__ long long flat(const Geo& g, int img, int y,
                                          int x) {
  return ((long long)img * g.H + y) * g.W + x;
}

__device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
  return __vmaxs4(a, b);
}
__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                    __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}
__device__ __forceinline__ uint8_t vmax(uint8_t a, uint8_t b) {
  return (int8_t)a > (int8_t)b ? a : b;
}

template <int V>
struct Unit;
template <>
struct Unit<16> {
  using T = uint4;
  static __device__ __forceinline__ T zero() { return make_uint4(0, 0, 0, 0); }
};
template <>
struct Unit<4> {
  using T = uint32_t;
  static __device__ __forceinline__ T zero() { return 0u; }
};
template <>
struct Unit<1> {
  using T = uint8_t;
  static __device__ __forceinline__ T zero() { return 0; }
};

// clip(rint(v / s), -127, 127) as a byte (jnp.round / torch.round: half to
// even).
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

// V channels (c .. c+V-1, all < cin) of the conv-input pixel (img, y, x).
template <int V>
__device__ __forceinline__ typename Unit<V>::T load_a(const Src& s, int img,
                                                      int y, int x, int c) {
  using T = typename Unit<V>::T;
  if (s.kind == kI8) {
    const long long pix = ((long long)img * s.hin + y) * s.win + x;
    return *reinterpret_cast<const T*>(
        static_cast<const int8_t*>(s.x) + pix * s.ld + c);
  }
  if (s.kind == kI8Pool) {  // the max of input pixels (2y|2y+1, 2x|2x+1)
    const int8_t* p = static_cast<const int8_t*>(s.x) +
                      (((long long)img * s.hin + 2 * y) * s.win + 2 * x) *
                          s.ld + c;
    const long long down = (long long)s.win * s.ld;
    const T v00 = *reinterpret_cast<const T*>(p);
    const T v01 = *reinterpret_cast<const T*>(p + s.ld);
    const T v10 = *reinterpret_cast<const T*>(p + down);
    const T v11 = *reinterpret_cast<const T*>(p + down + s.ld);
    return vmax(vmax(v00, v01), vmax(v10, v11));
  }
  const long long off =
      (((long long)img * s.hin + y) * s.win + x) * s.ld + c;
  const float sc = *s.scale;
  uint32_t w[(V + 3) / 4] = {};
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float v =
        s.kind == kQuantF32
            ? static_cast<const float*>(s.x)[off + i]
            : __bfloat162float(static_cast<const __nv_bfloat16*>(s.x)[off + i]);
    w[i / 4] |= quant_byte(v, sc) << (8 * (i % 4));
  }
  T out;
  if constexpr (V == 16)
    out = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (V == 4)
    out = w[0];
  else
    out = (uint8_t)w[0];
  return out;
}

template <int KS, int V>
__device__ __forceinline__ void stage_a(uint8_t* sa, const Src& s,
                                        const Geo& g, int c0) {
  using T = typename Unit<V>::T;
  constexpr int kUnits = kKC / V;
  for (int u = threadIdx.x; u < Shape<KS>::kAPixels * kUnits;
       u += kThreads) {
    const int p = u / kUnits, c = c0 + (u - p * kUnits) * V;
    int img, y, x;
    T v = Unit<V>::zero();
    if (c < s.cin && staged_pixel<KS>(g, p, img, y, x))
      v = load_a<V>(s, img, y, x, c);
    *reinterpret_cast<T*>(sa + p * kAPix + (c - c0)) = v;
  }
}

// Block row r (0..kBN) -> weight row, or -1 for none. st_c == 0: rows
// n0 + r of `rows`. st_c > 0 (K13): the block covers coupling channels n0 ..
// n0+31 of st_c; warp column wn's 32 rows are the s rows (ch) of its 16
// channels, then their t rows (st_c + ch), so that every thread holds the
// s and the t of the same channels (mma column tiles j and j + 2).
__device__ __forceinline__ int weight_row(int r, int n0, int rows, int st_c) {
  if (st_c == 0) {
    const int row = n0 + r;
    return row < rows ? row : -1;
  }
  const int w = r & 31, ch = n0 + (r >> 5) * 16 + (w & 15);
  if (ch >= st_c) return -1;
  return w < 16 ? ch : st_c + ch;
}

template <int KS, int V>
__device__ __forceinline__ void stage_b(uint8_t* sb, const Src& s, int n0,
                                        int rows, int st_c, int c0) {
  using T = typename Unit<V>::T;
  constexpr int kPerTap = kKC / V, kPerRow = KS * KS * kPerTap;
  const long long ldw = (long long)KS * KS * s.cin;
  for (int u = threadIdx.x; u < kBN * kPerRow; u += kThreads) {
    const int r = u / kPerRow, rem = u - r * kPerRow, t = rem / kPerTap;
    const int c = c0 + (rem - t * kPerTap) * V;
    const int row = weight_row(r, n0, rows, st_c);
    T v = Unit<V>::zero();
    if (row >= 0 && c < s.cin)
      v = *reinterpret_cast<const T*>(s.w + row * ldw + t * s.cin + c);
    *reinterpret_cast<T*>(sb + r * Shape<KS>::kBRow + t * kKC + (c - c0)) = v;
  }
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][j][e]: the warp's 16-row tile i and 8-column tile j; element e is
// row g + 8*(e >> 1), column 2*t4 + (e & 1) of it (g = lane / 4, t4 = lane
// % 4), the mma's C fragment.
using Acc = int[2][4][4];

template <int KS>
__device__ __forceinline__ void mma_stage(const uint8_t* sa,
                                          const uint8_t* sb, Acc& acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int tap = 0; tap < KS * KS; ++tap) {
    const int dy = tap / KS, dx = tap % KS;
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm * 32 + i * 16 + g;  // rows r, r + 8
      int p0, p1;
      if (KS == 3) {  // row r of the tile: pixel (r / kTW, r % kTW)
        p0 = (r / kTW + dy) * (kTW + 2) + r % kTW + dx;
        p1 = p0 + 8;
      } else {
        p0 = r;
        p1 = r + 8;
      }
      const uint8_t* q0 = sa + p0 * kAPix + 4 * t4;
      const uint8_t* q1 = sa + p1 * kAPix + 4 * t4;
      a[i][0] = lds32(q0);
      a[i][1] = lds32(q1);
      a[i][2] = lds32(q0 + 16);
      a[i][3] = lds32(q1 + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* q =
          sb + (wn * 32 + j * 8 + g) * Shape<KS>::kBRow + tap * kKC + 4 * t4;
      const uint32_t b0 = lds32(q), b1 = lds32(q + 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b0, b1);
    }
  }
}

template <int KS>
__device__ __forceinline__ void stage(uint8_t* sa, uint8_t* sb, const Src& s,
                                      const Geo& g, int n0, int rows,
                                      int st_c, int c0) {
  if (s.va == 16)
    stage_a<KS, 16>(sa, s, g, c0);
  else if (s.va == 4)
    stage_a<KS, 4>(sa, s, g, c0);
  else
    stage_a<KS, 1>(sa, s, g, c0);
  if (s.vb == 16)
    stage_b<KS, 16>(sb, s, n0, rows, st_c, c0);
  else if (s.vb == 4)
    stage_b<KS, 4>(sb, s, n0, rows, st_c, c0);
  else
    stage_b<KS, 1>(sb, s, n0, rows, st_c, c0);
}

// All of one source's stages into acc (zeroed here).
template <int KS>
__device__ __forceinline__ void accumulate(uint8_t* sa, uint8_t* sb,
                                           const Src& s, const Geo& g, int n0,
                                           int rows, int st_c, Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  for (int c0 = 0; c0 < s.cin; c0 += kKC) {
    __syncthreads();  // the previous stage's fragments are read
    stage<KS>(sa, sb, s, g, n0, rows, st_c, c0);
    __syncthreads();
    mma_stage<KS>(sa, sb, acc);
  }
}

// The block's row and column of accumulator element (i, j, e).
__device__ __forceinline__ int acc_row(int i, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp % kWarpsM) * 32 + i * 16 + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int j, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp / kWarpsM) * 32 + j * 8 + 2 * (lane & 3) + (e & 1);
}

// float(acc) * m, rounded (no contraction with a following add).
__device__ __forceinline__ float scaled(int acc, float m) {
  return __fmul_rn(__int2float_rn(acc), m);
}

// clip(rint(y), lo, 127) as an int8.
__device__ __forceinline__ int8_t requant(float y, float lo) {
  return (int8_t)(int)fminf(fmaxf(rintf(y), lo), 127.f);
}

// Host side: the widest load unit (16, 4 or 1 bytes) that divides cin, the
// pixel stride and the address; for a float input, elements (4 or 1).
inline int unit_bytes(const void* p, int cin, int ld, int elem) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (elem > 1) return (cin % 4 == 0 && ld % 4 == 0) ? 4 : 1;
  for (int v : {16, 4})
    if (cin % v == 0 && ld % v == 0 && a % v == 0) return v;
  return 1;
}

}  // namespace qmma
}  // namespace vwfd
