// K6 `median3`: the attack pool's 3×3 median filter, forward and backward.
//
// Replaces vwfd_tpu/ops/filters.py::_median3 (:48-114): the median of the
// nine views of the reflect-padded neighbourhood (edge pixel not repeated:
// index -1 reads 1, index H reads H-2) by the Paeth network _PAETH_SWAPS,
// 19 min/max, which only reorders values, so the result is bit-exact. The
// min/max propagate NaN (PTX min.NaN / max.NaN), as jnp.minimum/maximum and
// torch.minimum/maximum do, so NaN outputs fall where the network puts them.
// The backward routes each output cotangent to the input pixel of the FIRST
// of the nine views, in raster order (dy, then dx), whose value equals the
// median, followed through the reflect padding (filters.py:86-111); an
// output no view equals (a NaN median) routes nothing.
//
// Bound: bytes. Forward: x read once, y written once (100.7 MB at the
// training shape, 64 frames of 256²×3 f32). Backward: x and g read, gx
// written (151 MB). What held the first design back: 32×8 tiles, whose
// halo is 1.69× the tile and whose recomputed output ring is 1.33× it,
// staged by scalar loads through reflect arithmetic, and nine
// shared-memory loads per output.
//
// Design: a CTA takes a 32×32 tile; its input halo (1.13× forward, 1.27×
// backward) is staged in shared memory as channel planes, the 32 body
// columns of each row as 8 groups of 4 pixels (three 16-byte loads each;
// the reflect map is applied per row and to the halo columns only; a tile
// off the 16-byte grid or ragged on the right takes a scalar path). Each
// thread owns a column of 4 outputs and slides its 3×3 window down it: per
// output it loads one new row (3 values) and sorts it once (the network's
// first nine swaps sort each row of the window, so a sorted row serves
// three windows); the network's last ten swaps give the median. Outputs
// leave through shared memory as 16-byte vectors.
//
// The backward is a deterministic gather, no float atomics. The CTA
// recomputes, for each output of its tile (sliding as the forward does)
// and of a one-pixel ring around it (1.13× in all), which of the 3×3
// sources supplied the median -- a code 0..8 of the source's offset from
// the output, 255 for none -- by an unrolled select chain (registers only;
// away from the frame's edge the code is the view's index), and keeps it
// beside the output's cotangent as one 8-byte pair. Each input pixel then
// adds, sliding down its column, the cotangents of the outputs that chose
// it, visiting its neighbours in raster order from (-1,-1) to (1,1) -- the
// plain version's order, so both sums are bit-identical. What is left
// above the bound is the staging of x and g, which nothing overlaps within
// a CTA, and the recomputed codes (PERF.md §6).
#include "common.cuh"

namespace {

constexpr int kTile = 32;                      // outputs a side
constexpr int kRows = 4;                       // outputs a thread, down a column
constexpr int kThreads = kTile * kTile / kRows;  // 256: 8 warps of 32 columns
constexpr int kC = 3;
constexpr int kVecs = kTile * kC / 4;          // float4 in a tile row (24)
constexpr int kGroups = kTile / 4;             // 4-pixel groups in a tile row
constexpr uint32_t kNone = 255;                // no view equals the median

static_assert(kThreads == 256, "one warp per 4-row band of the tile");

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

#define SW(a, b)                       \
  {                                    \
    const float lo = min_nan(a, b);    \
    const float hi = max_nan(a, b);    \
    a = lo;                            \
    b = hi;                            \
  }

// One window row, sorted by the network's swaps on it: views (3r, 3r+1,
// 3r+2) take (1,2), (0,1), (1,2) in _PAETH_SWAPS' first nine.
struct Row {
  float a, b, c;
};

__device__ __forceinline__ Row sort_row(float a, float b, float c) {
  SW(b, c) SW(a, b) SW(b, c)
  return {a, b, c};
}

// _PAETH_SWAPS' last ten on three sorted rows (views 0-2, 3-5, 6-8)
__device__ __forceinline__ float paeth_tail(Row t, Row m, Row u) {
  float v0 = t.a, v1 = t.b, v2 = t.c, v3 = m.a, v4 = m.b, v5 = m.c,
        v6 = u.a, v7 = u.b, v8 = u.c;
  SW(v0, v3) SW(v5, v8) SW(v4, v7) SW(v3, v6) SW(v1, v4) SW(v2, v5)
  SW(v4, v7) SW(v4, v2) SW(v6, v4) SW(v4, v2)
  return v4;
}
#undef SW

// reflect padding by one (and a clamp for extents below 3)
__device__ __forceinline__ int refl(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);
}

// The first of the nine views of a window (raster order) equal to their
// median, kNone for none: an unrolled select chain, so the views stay in
// registers.
__device__ __forceinline__ uint32_t first_match(const float* v, float med) {
  uint32_t k = kNone;
#pragma unroll
  for (int j = 8; j >= 0; --j) k = v[j] == med ? (uint32_t)j : k;
  return k;
}

// The code of the output at (oy, ox) whose first match is view k: the
// offset (sy+1)·3 + sx+1 of that view's source pixel, followed through the
// reflect padding; kNone when k is, or when the output is off the image.
// Away from the frame's edge the code is k itself.
__device__ __forceinline__ uint32_t code_of(uint32_t k, int oy, int ox, int H,
                                            int W) {
  if (k == kNone || oy < 0 || oy >= H || ox < 0 || ox >= W) return kNone;
  if (oy > 0 && oy < H - 1 && ox > 0 && ox < W - 1) return k;  // unreflected
  const int ky = (int)k / 3, kx = (int)k - 3 * ky;
  const int sy = refl(oy + ky - 1, H) - oy, sx = refl(ox + kx - 1, W) - ox;
  return (uint32_t)((sy + 1) * 3 + sx + 1);
}

// 4 pixels (12 floats) of a 16-byte aligned row, as three 16-byte loads
__device__ __forceinline__ void load4px(const float* p, float* e) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  e[0] = a.x, e[1] = a.y, e[2] = a.z, e[3] = a.w;
  e[4] = b.x, e[5] = b.y, e[6] = b.z, e[7] = b.w;
  e[8] = c.x, e[9] = c.y, e[10] = c.z, e[11] = c.w;
}

// Stages rows y0-P .. y0+31+P × columns x0-P .. x0+31+P of frame n,
// reflected into the image, as planes s[ch][ly][lx] of pitch 32+2P. With
// `vec` (16-byte aligned rows) and a whole tile, the 32 body columns of a
// row move as 8 groups of 4 pixels (three 16-byte loads each, so every
// value's channel is known at compile time); the 2P halo columns are
// scalar.
template <int P>
__device__ __forceinline__ void stage_x(float* s, const float* __restrict__ x,
                                        int n, int y0, int x0, int H, int W,
                                        bool vec) {
  constexpr int NY = kTile + 2 * P, NX = kTile + 2 * P;
  const long long frame = (long long)n * H;
  if (vec && x0 + kTile <= W) {
    for (int i = threadIdx.x; i < NY * kGroups; i += kThreads) {
      const int ly = i / kGroups, q = i - ly * kGroups;
      const int gy = refl(y0 - P + ly, H);
      float e[12];
      load4px(x + ((frame + gy) * W + x0 + 4 * q) * kC, e);
#pragma unroll
      for (int k = 0; k < 12; ++k)
        s[((k % kC) * NY + ly) * NX + P + 4 * q + k / kC] = e[k];
    }
    for (int i = threadIdx.x; i < NY * 2 * P * kC; i += kThreads) {
      const int ly = i / (2 * P * kC), r = i - ly * 2 * P * kC;
      const int j = r / kC, ch = r - j * kC;
      const int lx = j < P ? j : kTile + j;
      const int gy = refl(y0 - P + ly, H), gx = refl(x0 - P + lx, W);
      s[(ch * NY + ly) * NX + lx] = x[((frame + gy) * W + gx) * kC + ch];
    }
  } else {
    for (int i = threadIdx.x; i < NY * NX * kC; i += kThreads) {
      const int ly = i / (NX * kC), r = i - ly * NX * kC;
      const int lx = r / kC, ch = r - lx * kC;
      const int gy = refl(y0 - P + ly, H), gx = refl(x0 - P + lx, W);
      s[(ch * NY + ly) * NX + lx] = x[((frame + gy) * W + gx) * kC + ch];
    }
  }
}

// Thread's results (rows r0.. r0+3 of column tx, 3 channels) to the tile's
// rows in o (pitch 96 floats, NHWC order), then the tile to frame n.
// Called with every thread's reads of the staging buffer behind a barrier.
__device__ __forceinline__ void store_tile(float* o, float (*res)[kC],
                                           float* __restrict__ y, int n,
                                           int y0, int x0, int H, int W,
                                           bool vec) {
  const int tx = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRows;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int ch = 0; ch < kC; ++ch)
      o[(r0 + i) * kTile * kC + tx * kC + ch] = res[i][ch];
  __syncthreads();
  const int rows = min(kTile, H - y0), cols = min(kTile, W - x0);
  const long long base = ((long long)n * H + y0) * W + x0;
  if (vec) {  // cols * 3 is a multiple of 4: W and x0 are
    const int nv = cols * kC / 4;
    for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
      const int ly = i / kVecs, v = i - ly * kVecs;
      if (v < nv)
        reinterpret_cast<float4*>(y + (base + (long long)ly * W) * kC)[v] =
            reinterpret_cast<const float4*>(o + ly * kTile * kC)[v];
    }
  } else {
    for (int i = threadIdx.x; i < rows * kTile * kC; i += kThreads) {
      const int ly = i / (kTile * kC), f = i - ly * kTile * kC;
      if (f < cols * kC) y[(base + (long long)ly * W) * kC + f] = o[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    median3_fwd(const float* __restrict__ x, float* __restrict__ y, int H,
                int W, int vec) {
  constexpr int NY = kTile + 2, NX = kTile + 2;
  __shared__ __align__(16) float s[kC * NY * NX];  // reused for the outputs
  const int n = blockIdx.z, y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  stage_x<1>(s, x, n, y0, x0, H, W, vec);
  __syncthreads();
  const int tx = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRows;
  float res[kRows][kC];
#pragma unroll
  for (int ch = 0; ch < kC; ++ch) {
    const float* p = s + (ch * NY + r0) * NX + tx;
    Row t = sort_row(p[0], p[1], p[2]);
    Row m = sort_row(p[NX], p[NX + 1], p[NX + 2]);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float* q = p + (i + 2) * NX;
      const Row u = sort_row(q[0], q[1], q[2]);
      res[i][ch] = paeth_tail(t, m, u);
      t = m;
      m = u;
    }
  }
  __syncthreads();
  store_tile(s, res, y, n, y0, x0, H, W, vec);
}

__global__ void __launch_bounds__(kThreads)
    median3_bwd(const float* __restrict__ x, const float* __restrict__ g,
                float* __restrict__ gx, int H, int W, int vec) {
  // inputs: the tile and a two-pixel ring; outputs: a one-pixel ring
  constexpr int IY = kTile + 4, IX = kTile + 4, OY = kTile + 2,
                OX = kTile + 2;
  __shared__ __align__(16) float s[kC * IY * IX];  // reused for gx
  __shared__ float2 pr[kC * OY * OX];              // (cotangent, code)
  const int n = blockIdx.z, y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const long long frame = (long long)n * H;
  stage_x<2>(s, x, n, y0, x0, H, W, vec);
  // cotangents of the outputs (0 off the image) into pr[].x
  if (vec && x0 + kTile <= W) {
    for (int i = threadIdx.x; i < OY * kGroups; i += kThreads) {
      const int ly = i / kGroups, q = i - ly * kGroups, oy = y0 - 1 + ly;
      float e[12] = {};
      if (oy >= 0 && oy < H)
        load4px(g + ((frame + oy) * W + x0 + 4 * q) * kC, e);
#pragma unroll
      for (int k = 0; k < 12; ++k)
        pr[((k % kC) * OY + ly) * OX + 1 + 4 * q + k / kC].x = e[k];
    }
    for (int i = threadIdx.x; i < OY * 2 * kC; i += kThreads) {
      const int ly = i / (2 * kC), r = i - ly * 2 * kC;
      const int j = r / kC, ch = r - j * kC, lx = j ? OX - 1 : 0;
      const int oy = y0 - 1 + ly, ox = x0 - 1 + lx;
      const bool in = oy >= 0 && oy < H && ox >= 0 && ox < W;
      pr[(ch * OY + ly) * OX + lx].x =
          in ? g[((frame + oy) * W + ox) * kC + ch] : 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < OY * OX * kC; i += kThreads) {
      const int ly = i / (OX * kC), r = i - ly * OX * kC;
      const int lx = r / kC, ch = r - lx * kC;
      const int oy = y0 - 1 + ly, ox = x0 - 1 + lx;
      const bool in = oy >= 0 && oy < H && ox >= 0 && ox < W;
      pr[(ch * OY + ly) * OX + lx].x =
          in ? g[((frame + oy) * W + ox) * kC + ch] : 0.f;
    }
  }
  __syncthreads();

  // codes of the tile's outputs: thread (tx, band) slides down its 4 rows
  // as the forward does; window of output (r, tx): s rows r+1.., columns
  // tx+1..; its pair at pr (r+1, tx+1)
  const int tx = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRows;
  // the thread's 4 outputs lie off the frame's edge: code = first match
  const bool inner = x0 + tx >= 1 && x0 + tx <= W - 2 && y0 + r0 >= 1 &&
                     y0 + r0 + kRows <= H - 1;
#pragma unroll
  for (int ch = 0; ch < kC; ++ch) {
    const float* p = s + (ch * IY + r0 + 1) * IX + tx + 1;
    float v[9];
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = p[(k / 3) * IX + k % 3];
    Row t = sort_row(v[0], v[1], v[2]), m = sort_row(v[3], v[4], v[5]);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) v[6 + k] = p[(i + 2) * IX + k];
      const Row u = sort_row(v[6], v[7], v[8]);
      const uint32_t k = first_match(v, paeth_tail(t, m, u));
      pr[(ch * OY + r0 + i + 1) * OX + tx + 1].y = __uint_as_float(
          inner ? k : code_of(k, y0 + r0 + i, x0 + tx, H, W));
#pragma unroll
      for (int k = 0; k < 6; ++k) v[k] = v[k + 3];
      t = m;
      m = u;
    }
  }
  // ... and of the one-pixel ring around it: rows 0 and 33, then columns
  // 0 and 33 of rows 1..32, one output a thread
  constexpr int kRing = 4 * OX - 4;
  for (int i = threadIdx.x; i < kC * kRing; i += kThreads) {
    const int ch = i / kRing, j = i - ch * kRing;
    int ly, lx;
    if (j < 2 * OX) {
      ly = j < OX ? 0 : OY - 1;
      lx = j < OX ? j : j - OX;
    } else {
      ly = 1 + ((j - 2 * OX) >> 1);
      lx = (j & 1) ? OX - 1 : 0;
    }
    const float* p = s + (ch * IY + ly) * IX + lx;
    float v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = p[(k / 3) * IX + k % 3];
    const float med = paeth_tail(sort_row(v[0], v[1], v[2]),
                                 sort_row(v[3], v[4], v[5]),
                                 sort_row(v[6], v[7], v[8]));
    pr[(ch * OY + ly) * OX + lx].y = __uint_as_float(
        code_of(first_match(v, med), y0 - 1 + ly, x0 - 1 + lx, H, W));
  }
  __syncthreads();

  // gather: thread (tx, band) slides down its column of 4 input pixels
  float res[kRows][kC];
#pragma unroll
  for (int ch = 0; ch < kC; ++ch) {
    const float2* p = pr + (ch * OY + r0) * OX + tx;
    float2 w[3][3];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) w[r][c] = p[r * OX + c];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) w[2][c] = p[(i + 2) * OX + c];
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < 9; ++d) {
        // output = input + (dy, dx); it chose this pixel when its source
        // offset is (-dy, -dx)
        const int dy = d / 3 - 1, dx = d % 3 - 1;
        const float2 o = w[dy + 1][dx + 1];
        if (__float_as_uint(o.y) == (uint32_t)((1 - dy) * 3 + 1 - dx))
          acc += o.x;
      }
      res[i][ch] = acc;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        w[0][c] = w[1][c];
        w[1][c] = w[2][c];
      }
    }
  }
  __syncthreads();
  store_tile(s, res, gx, n, y0, x0, H, W, vec);
}

inline dim3 grid(int N, int H, int W) {
  return dim3((unsigned)((W + kTile - 1) / kTile),
              (unsigned)((H + kTile - 1) / kTile), (unsigned)N);
}

// 16-byte vectors: every row start aligned (W % 4 == 0) and every tensor
inline bool vectorizable(int W, std::initializer_list<const void*> ptrs) {
  return W % 4 == 0 && vwfd::aligned16(ptrs);
}

}  // namespace

extern "C" int vwfd_median3_fwd(const void* x, void* y, int N, int H, int W,
                                void* stream) {
  median3_fwd<<<grid(N, H, W), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), H, W,
      vectorizable(W, {x, y}));
  return (int)cudaGetLastError();
}

extern "C" int vwfd_median3_bwd(const void* x, const void* g, void* gx, int N,
                                int H, int W, void* stream) {
  median3_bwd<<<grid(N, H, W), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(gx), H, W, vectorizable(W, {x, g, gx}));
  return (int)cudaGetLastError();
}
