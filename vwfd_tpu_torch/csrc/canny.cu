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
// Every forward sum is taken in the plain version's order (the JAX form:
// the 25-tap gaussian in raster order, the Sobel's taps in its order),
// without FMA contraction but where XLA contracts (gray), so the forward is
// the plain version's up to the last bits of expf. The backward recomputes
// the stencils and mag0 with the same code and the NMS as below, so its
// decisions (the NMS's picks, the clip's ½, the pixels tied at the max)
// are the forward's.
//
// Bound: bytes. At the image step's (48, 256, 256, 3) the forward reads x
// (37.7 MB) and writes y (12.6 MB), the backward reads x and the cotangent
// and writes dx: 88.1 MB, 0.026 ms at 3.35 TB/s, about 100 operations a
// pixel forward and 200 backward.
//
// Design. A per-image max sits between the stencils and the NMS, and a
// per-image sum (the max's cotangent) between the NMS's transpose and the
// stencils': each direction takes two launches, and the stencils' and the
// NMS's intermediates stay in shared memory. A CTA of 192 threads owns a
// tile of 32 × 90 outputs (90 = three warps of 30 columns, see the sweep)
// and recomputes what it needs from x on a halo:
//   forward  (1) canny_max_kernel: gray on the tile ±3, the gaussian ±1, the
//                Sobel and mag0 on the tile; the tile's max into its own
//                slot (no atomics, no memset);
//            (2) canny_map_kernel: gray ±4 and the gaussian ±2 (which need
//                nothing of (1)), then its image's slots (M), mag = mag0 / D
//                ±1, the NMS and the thresholds on the tile; writes y.
//   backward (1) canny_local_kernel: gray ±5, the gaussian ±3, mag ±2; a
//                sweep of the NMS and its local backward over the tile ±1
//                gathers dmag on the tile in registers (below) and writes
//                two planes, dgx_part = dgx_c + (dmag / D)·gx/mag0 and
//                dgy_part, and per tile Σ dmag·mag0, the count of pixels
//                tied at M and a list of up to 16 of them with (gx, gy)/mag0;
//            (2) canny_input_kernel: the planes on the tile ±3; its image's
//                slots summed in a fixed order (the max's cotangent, shared
//                evenly among the ties), added at the listed ties of the
//                tiles within one of it (where a list overflowed, as on a
//                flat image, gx, gy and mag0 are recomputed on the ±3 halo
//                from gray ±6 instead); the Sobel's and the gaussian's
//                transposes and gray's; writes dx.
// The forward saves x and the slots only. The backward's planes (2·N·H·W
// floats, 25 MB at the step's shape) stand in for recomputing the sweep, the
// backward's largest phase, on the tile ±4 in (2): 1.3 times the tile's
// sweep again, against 25 MB written and read back through L2.
//
// Each direction's second kernel is launched as the programmatic dependent
// of the first and waits only for its own image's tiles of it (per-image
// counts, below): its CTAs fill the SMs the first's last wave leaves idle.
//
// The sweep recomputes the NMS with fast square root, division and exp;
// its decisions are the forward's (the picks are signs; e is 0 only where
// mag is; where e / 0.2 lies within 1e-3 of 1 it takes the exact NMS), so
// the gradient differs from the plain version's by those values' few ulp.
//
// The stencils: a thread owns one column of half a region's rows and slides
// the 5×5 (or 3×3) window down it in registers, so that a row of output
// costs one row of shared-memory loads; the taps are compile-time constants
// (immediates). The NMS sweep: a warp owns 32 consecutive columns (30 of
// them outputs) and walks down 16 rows; a pixel's cotangents to its left and
// right neighbours travel by shuffle and those to the rows above and below
// stay in the thread's registers, so dmag is gathered without planes or
// atomics, each pixel's terms added in one fixed order.
//
// The image's edges. A tile whose halo lies inside the image runs straight
// code. One that reaches an edge stages gray at the reflected pixels, copies
// the gaussian onto the one-wide ring the Sobel's pad reads, masks what lies
// outside the image, and in the backward folds the transposes' reflected
// rows and columns back onto the ≤ 4 rows and columns they reach, after
// the straight pass.
//
// Where the time goes (port_tools/ablate_canny.py, PERF.md): the first
// kernel of each direction reads x at the rate of device memory; the map
// kernel's NMS and the local kernel's sweep issue an instruction every cycle
// they can.
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

constexpr int kTH = 32;        // output rows a tile
constexpr int kTW = 90;        // output columns a tile: three sweeps of 30
constexpr int kThreads = 192;  // six warps: 3 column blocks × 2 row strips
constexpr int kWarps = kThreads / 32;
constexpr int kSweep = 30;     // output columns of a sweeping warp
constexpr int kTies = 16;      // a tile's list of pixels tied at the max
constexpr float kW0 = 0.299f, kW1 = 0.587f, kW2 = 0.114f;

// the 5×5 σ = 1 gaussian in raster order, float32
// (vwfd_tpu_torch/ops/filters.py::gaussian_kernel_2d(5, 1.0))
#define VWFD_GAUSS_TAPS                                                  \
  {0x1.8527acp-9f, 0x1.b40494p-7f, 0x1.676f9cp-6f, 0x1.b40494p-7f,       \
   0x1.8527acp-9f, 0x1.b40494p-7f, 0x1.e8862ep-5f, 0x1.92b856p-4f,       \
   0x1.e8862ep-5f, 0x1.b40494p-7f, 0x1.676f9cp-6f, 0x1.92b856p-4f,       \
   0x1.4bfc90p-3f, 0x1.92b856p-4f, 0x1.676f9cp-6f, 0x1.b40494p-7f,       \
   0x1.e8862ep-5f, 0x1.92b856p-4f, 0x1.e8862ep-5f, 0x1.b40494p-7f,       \
   0x1.8527acp-9f, 0x1.b40494p-7f, 0x1.676f9cp-6f, 0x1.b40494p-7f,       \
   0x1.8527acp-9f}

// A tile grown by h on every side, row-major in shared memory.
template <int h>
struct Region {
  static constexpr int W = kTW + 2 * h, H = kTH + 2 * h, size = W * H;
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Shared-memory floats of each kernel (kernels/canny.py::plan mirrors
// them): two areas, each reused by the stages in turn.
constexpr int kSmemMax = Region<3>::size + Region<1>::size;
constexpr int kSmemMap = cmax(Region<4>::size, Region<1>::size) +
                         Region<2>::size;
constexpr int kSmemLocal = cmax(Region<5>::size, Region<2>::size) +
                           Region<3>::size;
constexpr int kSmemInput =
    cmax(cmax(2 * Region<3>::size, Region<6>::size), Region<0>::size) +
    cmax(Region<4>::size, Region<2>::size);

// numpy's reflect (the edge value not repeated), one reflection
__device__ __forceinline__ int refl(int t, int n) {
  return t < 0 ? -t : (t > n - 1 ? 2 * (n - 1) - t : t);
}

__device__ __forceinline__ float sigm(float a) {
  return __frcp_rn(__fadd_rn(1.f, expf(-a)));  // = 1 / (1 + e^−a)
}

// the sigmoid where only the backward uses it: fast exp and division
__device__ __forceinline__ float sigm_fast(float a) {
  return __fdividef(1.f, 1.f + __expf(-a));
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

__device__ __forceinline__ float mag0_of(float gx, float gy) {
  return __fsqrt_rn(sq_sum(gx, gy, 1e-12f));
}

// a tile max's bits: mag0 ≥ 0 orders as its bits; NaN gets the largest,
// so that it wins as it does in torch.amax
__device__ __forceinline__ unsigned int max_bits(float m0) {
  return isnan(m0) ? 0xffffffffu : __float_as_uint(m0);
}

__device__ __forceinline__ float max_value(unsigned int bits) {
  return bits == 0xffffffffu ? __uint_as_float(0x7fffffffu)
                             : __uint_as_float(bits);
}

struct Tile {
  int n, ty, tx, r0, c0, H, W, slots;
  __device__ Tile(int H_, int W_, int tiles_y, int tiles_x)
      : n(blockIdx.z), ty(blockIdx.y), tx(blockIdx.x), r0(ty * kTH),
        c0(tx * kTW), H(H_), W(W_), slots(tiles_y * tiles_x) {}
  // whether the tile grown by h reaches past the image
  __device__ bool edge(int h) const {
    return r0 < h || c0 < h || r0 + kTH + h > H || c0 + kTW + h > W;
  }
  __device__ bool in_image(int r, int c) const {
    return (unsigned)r < (unsigned)H && (unsigned)c < (unsigned)W;
  }
  __device__ size_t pixel(int r, int c) const {
    return ((size_t)n * H + r) * W + c;
  }
  // this tile's slot among the image's
  __device__ int slot() const { return n * slots + ty * gridDim.x + tx; }
};

// Each direction's two kernels overlap. The first lets the second launch
// once all its CTAs have started (programmatic dependent launch, sm_90), so
// that the second's CTAs fill the SMs the first's last wave leaves idle.
// What the second reads of the first's is per image: a CTA of the first
// counts itself done for its image once its writes are visible, a CTA of
// the second waits for its own image's count (never for a CTA that has not
// started, so it cannot deadlock) and reads through L2, and the last CTA of
// the second for an image sets both of that image's counts back to 0 (the
// wrapper keeps them zeroed between calls).
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void count_done(int* done, int n) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(done + n, 1);
}

__device__ __forceinline__ void wait_image(const int* done, int n,
                                           int count) {
  if (threadIdx.x == 0) {
    // a count that never comes (a broken launch) traps after ~1 s: an
    // error, not a hung card
    for (unsigned int spins = 0;; ++spins) {
      int v;
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                   : "=r"(v) : "l"(done + n) : "memory");
      if (v >= count) break;
      if (spins > (1u << 24)) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void release_image(int* done, int* used, int n,
                                              int count) {
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(used + n, 1) == count - 1) {
    done[n] = 0;
    used[n] = 0;
  }
}

// ------------------------------------------------------- block reductions

__device__ __forceinline__ unsigned int block_max(unsigned int v,
                                                  unsigned int* red) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned int out = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) out = red[w] > out ? red[w] : out;
  __syncthreads();
  return out;
}

// a sum in one fixed order: each lane's, a butterfly over the warp (every
// lane ends with the same bits), the warps in turn
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float out = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) out += red[w];
  __syncthreads();
  return out;
}

__device__ __forceinline__ int block_count(int v, int* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int out = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) out += red[w];
  __syncthreads();
  return out;
}

// M: the max of the image's tile maxima
__device__ float image_max(const unsigned int* __restrict__ mslot,
                           const Tile& tl) {
  __shared__ unsigned int red[kWarps];
  unsigned int b = 0u;
  for (int i = threadIdx.x; i < tl.slots; i += kThreads) {
    const unsigned int v = __ldcg(mslot + tl.n * tl.slots + i);
    b = v > b ? v : b;
  }
  return max_value(block_max(b, red));
}

// ------------------------------------------------------ forward stencils

// gray on Region<h>; at an edge tile the reflected pixels within 2 of the
// image (the gaussian's pad), 0 beyond (never read for an image pixel).
// Each thread issues kBatch pixels' loads before it uses any.
constexpr int kBatch = 4;

template <int h, bool kEdge>
__device__ void stage_gray(const float* __restrict__ x, const Tile& tl,
                           float* G) {
  using R = Region<h>;
  const float* xi = x + (size_t)tl.n * tl.H * tl.W * 3;
  for (int i0 = threadIdx.x; i0 < R::size; i0 += kBatch * kThreads) {
    float v[kBatch][3];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads;
      const int lr = i / R::W, lc = i - lr * R::W;
      const int r = tl.r0 - h + lr, c = tl.c0 - h + lc;
      const float* src = nullptr;
      if (i < R::size) {
        if (!kEdge)
          src = xi + ((size_t)r * tl.W + c) * 3;
        else if (r >= -2 && r <= tl.H + 1 && c >= -2 && c <= tl.W + 1)
          src = xi + ((size_t)refl(r, tl.H) * tl.W + refl(c, tl.W)) * 3;
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) v[k][ch] = src ? __ldg(src + ch) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads;
      if (i < R::size) G[i] = gray_of(v[k]);
    }
  }
}

// the gaussian on Region<h> from gray on Region<h + 2>: Σ k[u][v]·g, the
// plain version's raster order, each product and sum rounded once. A thread
// owns a column of half the rows and slides the 5×5 window down it.
template <int h>
__device__ void stage_smooth(const float* G, float* S) {
  using R = Region<h>;
  using RG = Region<h + 2>;
  constexpr int L = R::H / 2;
  constexpr float k[25] = VWFD_GAUSS_TAPS;
  for (int item = threadIdx.x; item < 2 * R::W; item += kThreads) {
    const int half = item / R::W, j = item - half * R::W;
    const float* g = G + half * L * RG::W + j;
    float* out = S + half * L * R::W + j;
    float w[5][5];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 5; ++v) w[u][v] = g[u * RG::W + v];
#pragma unroll
    for (int t = 0; t < L; ++t) {
#pragma unroll
      for (int v = 0; v < 5; ++v) w[(t + 4) % 5][v] = g[(t + 4) * RG::W + v];
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < 5; ++u)
#pragma unroll
        for (int v = 0; v < 5; ++v)
          acc = __fadd_rn(acc, __fmul_rn(k[u * 5 + v], w[(t + u) % 5][v]));
      out[t * R::W] = acc;
    }
  }
}

// gray on Region<h + 2> (G) and the gaussian on Region<h> (S); ends with a
// barrier
template <int h, bool kEdge>
__device__ void stage_gray_smooth(const float* __restrict__ x,
                                  const Tile& tl, float* G, float* S) {
  stage_gray<h + 2, kEdge>(x, tl, G);
  __syncthreads();
  stage_smooth<h>(G, S);
  __syncthreads();
}

// at an edge tile, the gaussian on the one-wide ring outside the image that
// the Sobel's reflect pad reads: S(r, c) = S(refl r, refl c)
template <int h>
__device__ void mirror_smooth(const Tile& tl, float* S) {
  using R = Region<h>;
  const int br = tl.r0 - h, bc = tl.c0 - h;  // image position of S[0]
  for (int i = threadIdx.x; i < 2 * (R::W + R::H); i += kThreads) {
    int r, c;
    if (i < 2 * R::W) {
      r = i < R::W ? -1 : tl.H;
      c = bc + i % R::W;
    } else {
      const int k = i - 2 * R::W;
      c = k < R::H ? -1 : tl.W;
      r = br + k % R::H;
    }
    if (r < -1 || r > tl.H || c < -1 || c > tl.W) continue;
    const int lr = r - br, lc = c - bc;
    if (lr < 0 || lr >= R::H || lc < 0 || lc >= R::W) continue;
    S[lr * R::W + lc] =
        S[(refl(r, tl.H) - br) * R::W + refl(c, tl.W) - bc];
  }
}

struct Grad {
  float gx, gy;
};

// the Sobel of a 3×3 window (rows above, at, below; columns left, centre,
// right) in the plain version's tap order
__device__ __forceinline__ Grad sobel(const float* a, const float* m,
                                      const float* d) {
  float gx = a[2];
  gx = __fadd_rn(gx, __fmul_rn(2.f, m[2]));
  gx = __fadd_rn(gx, d[2]);
  gx = __fsub_rn(gx, a[0]);
  gx = __fsub_rn(gx, __fmul_rn(2.f, m[0]));
  gx = __fsub_rn(gx, d[0]);
  float gy = d[0];
  gy = __fadd_rn(gy, __fmul_rn(2.f, d[1]));
  gy = __fadd_rn(gy, d[2]);
  gy = __fsub_rn(gy, a[0]);
  gy = __fsub_rn(gy, __fmul_rn(2.f, a[1]));
  gy = __fsub_rn(gy, a[2]);
  return {gx, gy};
}

// the Sobel on Region<h> from the gaussian on Region<hs> (hs > h), a
// thread a column of half the rows with the 3×3 window slid down it;
// f(lr, lc, g) for each position
template <int h, int hs, typename F>
__device__ __forceinline__ void stage_sobel(const float* S, F&& f) {
  using R = Region<h>;
  using RS = Region<hs>;
  constexpr int L = R::H / 2, o = hs - h - 1;
  for (int item = threadIdx.x; item < 2 * R::W; item += kThreads) {
    const int half = item / R::W, j = item - half * R::W;
    const float* src = S + (half * L + o) * RS::W + j + o;
    float w[3][3];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 3; ++v) w[u][v] = src[u * RS::W + v];
#pragma unroll
    for (int t = 0; t < L; ++t) {
#pragma unroll
      for (int v = 0; v < 3; ++v) w[(t + 2) % 3][v] = src[(t + 2) * RS::W + v];
      f(half * L + t, j, sobel(w[t % 3], w[(t + 1) % 3], w[(t + 2) % 3]));
    }
  }
}

// mag = mag0 / D (0 outside the image: the NMS's zero pad) on Region<h>
// from the gaussian on Region<h + 1>
template <int h, bool kEdge>
__device__ void stage_mag(const Tile& tl, const float* S, float D,
                          float* MG) {
  using R = Region<h>;
  stage_sobel<h, h + 1>(S, [&](int lr, int lc, Grad g) {
    const bool in = !kEdge || tl.in_image(tl.r0 - h + lr, tl.c0 - h + lc);
    MG[lr * R::W + lc] = in ? __fdiv_rn(mag0_of(g.gx, g.gy), D) : 0.f;
  });
}

// ------------------------------------------------------------------- NMS

// The soft NMS at one pixel: every forward quantity the backward needs.
struct Nms {
  float mag, c, s, inv_gn, a1, a2, b1, b2, inv_d, r1, r2, s1, s2, keep, e;
};

__device__ __forceinline__ Nms nms(float gx, float gy, float mag, float mr,
                                   float ml, float md, float mu) {
  Nms q;
  q.mag = mag;
  const float gn = __fsqrt_rn(sq_sum(gx, gy, 1e-8f));
  q.inv_gn = __frcp_rn(gn);
  q.c = __fdiv_rn(gx, gn);
  q.s = __fdiv_rn(gy, gn);
  const bool cp = q.c >= 0.f, sp = q.s >= 0.f;
  q.a1 = cp ? mr : ml;
  q.a2 = cp ? ml : mr;
  q.b1 = sp ? md : mu;
  q.b2 = sp ? mu : md;
  const float ac = fabsf(q.c), as = fabsf(q.s);
  const float n1 = __fadd_rn(__fmul_rn(ac, q.a1), __fmul_rn(as, q.b1));
  const float n2 = __fadd_rn(__fmul_rn(ac, q.a2), __fmul_rn(as, q.b2));
  const float d = __fadd_rn(__fadd_rn(ac, as), 1e-12f);
  q.inv_d = __frcp_rn(d);
  q.r1 = __fdiv_rn(n1, d);
  q.r2 = __fdiv_rn(n2, d);
  q.s1 = sigm(__fmul_rn(20.f, __fsub_rn(q.mag, q.r1)));
  q.s2 = sigm(__fmul_rn(20.f, __fsub_rn(q.mag, q.r2)));
  q.keep = __fmul_rn(q.s1, q.s2);
  q.e = __fmul_rn(q.mag, q.keep);
  return q;
}

// The NMS for the backward alone, with fast square root, division and exp
// (each a few ulp). Its decisions are the exact one's: the picks are the
// signs of gx and gy; e is 0 exactly where mag is (keep > 0), so the clip's
// corner at 0 is the forward's; and the caller takes the exact NMS where
// e / 0.2 lies within 1e-3 of the corner at 1 (or is not finite).
__device__ __forceinline__ Nms nms_fast(float gx, float gy, float mag,
                                        float mr, float ml, float md,
                                        float mu) {
  Nms q;
  q.mag = mag;
  q.inv_gn = rsqrtf(gx * gx + gy * gy + 1e-8f);
  q.c = gx * q.inv_gn;
  q.s = gy * q.inv_gn;
  const bool cp = q.c >= 0.f, sp = q.s >= 0.f;
  q.a1 = cp ? mr : ml;
  q.a2 = cp ? ml : mr;
  q.b1 = sp ? md : mu;
  q.b2 = sp ? mu : md;
  const float ac = fabsf(q.c), as = fabsf(q.s);
  q.inv_d = __fdividef(1.f, ac + as + 1e-12f);
  q.r1 = (ac * q.a1 + as * q.b1) * q.inv_d;
  q.r2 = (ac * q.a2 + as * q.b2) * q.inv_d;
  q.s1 = sigm_fast(20.f * (q.mag - q.r1));
  q.s2 = sigm_fast(20.f * (q.mag - q.r2));
  q.keep = q.s1 * q.s2;
  q.e = q.mag * q.keep;
  return q;
}

__device__ __forceinline__ float threshold(float e) {
  const float s3 = sigm(__fmul_rn(20.f, __fsub_rn(e, 0.1f)));
  return __fmul_rn(s3, clip01(__fdiv_rn(e, 0.2f)));
}

// The NMS's local backward at one pixel with cotangent g: the cotangent of
// mag at the pixel, those it sends to its right, left, lower and upper
// neighbours' mag, and those of gx, gy through c and s.
struct Local {
  float dmag, to_r, to_l, to_d, to_u, dgx, dgy;
};

__device__ __forceinline__ Local local_bwd(const Nms& q, float g,
                                           bool exact) {
  // y = σ3·clip(e/0.2): clip's derivative ½ where e/0.2 is exactly 0 or 1
  // (the forward's quotient where q is exact; else e lies away from 0.2)
  const float s3 = sigm_fast(20.f * (q.e - 0.1f));
  const float t = exact ? __fdiv_rn(q.e, 0.2f) : 5.f * q.e;
  const float qv = clip01(t);
  const float dclip = (t > 0.f && t < 1.f) ? 1.f
                      : ((t == 0.f || t == 1.f) ? 0.5f : 0.f);
  const float de = (g * qv) * (s3 * (1.f - s3)) * 20.f +
                   (g * s3) * dclip * 5.f;
  // e = mag·keep, keep = σ1·σ2, σi = σ(20(mag − ni/d))
  const float dkeep = de * q.mag;
  const float dt1 = dkeep * q.s2 * (q.s1 * (1.f - q.s1)) * 20.f;
  const float dt2 = dkeep * q.s1 * (q.s2 * (1.f - q.s2)) * 20.f;
  const float dn1 = -dt1 * q.inv_d, dn2 = -dt2 * q.inv_d;
  const float dd = (dt1 * q.r1 + dt2 * q.r2) * q.inv_d;
  const float ac = fabsf(q.c), as = fabsf(q.s);
  const float da1 = dn1 * ac, da2 = dn2 * ac, db1 = dn1 * as, db2 = dn2 * as;
  const float dac = dn1 * q.a1 + dn2 * q.a2 + dd;
  const float das = dn1 * q.b1 + dn2 * q.b2 + dd;
  // |·| with jnp.abs's gradient: +1 at 0 (and −1 at NaN, the plain
  // version's where(v ≥ 0, v, −v))
  const float dc = q.c >= 0.f ? dac : -dac;
  const float ds = q.s >= 0.f ? das : -das;
  // c = gx/gn, s = gy/gn, gn = sqrt(gx² + gy² + 1e-8)
  const float dgn = -(dc * q.c + ds * q.s) * q.inv_gn;
  const bool cp = q.c >= 0.f, sp = q.s >= 0.f;
  Local l;
  l.dmag = de * q.keep + dt1 + dt2;
  l.to_r = cp ? da1 : da2;
  l.to_l = cp ? da2 : da1;
  l.to_d = sp ? db1 : db2;
  l.to_u = sp ? db2 : db1;
  l.dgx = dc * q.inv_gn + dgn * q.c;
  l.dgy = ds * q.inv_gn + dgn * q.s;
  return l;
}

// ------------------------------------------------------------- forward

template <bool kEdge>
__device__ void max_body(const float* __restrict__ x,
                         unsigned int* __restrict__ mslot, const Tile& tl,
                         float* sm) {
  __shared__ unsigned int red[kWarps];
  float* G = sm;
  float* S = sm + Region<3>::size;
  stage_gray_smooth<1, kEdge>(x, tl, G, S);
  if (kEdge) {
    mirror_smooth<1>(tl, S);
    __syncthreads();
  }
  unsigned int best = 0u;
  stage_sobel<0, 1>(S, [&](int lr, int lc, Grad g) {
    if (!kEdge || tl.in_image(tl.r0 + lr, tl.c0 + lc)) {
      const unsigned int b = max_bits(mag0_of(g.gx, g.gy));
      best = b > best ? b : best;
    }
  });
  best = block_max(best, red);
  if (threadIdx.x == 0) mslot[tl.slot()] = best;
}

__global__ void __launch_bounds__(kThreads, 8)
canny_max_kernel(const float* __restrict__ x,
                 unsigned int* __restrict__ mslot, int* __restrict__ done,
                 int H, int W, int tiles_y, int tiles_x) {
  extern __shared__ float sm[];
  let_next_start();
  Tile tl(H, W, tiles_y, tiles_x);
  // the images last to first: the map kernel takes them first to last and
  // so finds the x of its first CTAs' images, read last here, still in L2
  tl.n = gridDim.z - 1 - tl.n;
  if (tl.edge(3))
    max_body<true>(x, mslot, tl, sm);
  else
    max_body<false>(x, mslot, tl, sm);
  count_done(done, tl.n);
}

template <bool kEdge>
__device__ void map_body(const float* __restrict__ x,
                         const unsigned int* __restrict__ mslot,
                         const int* __restrict__ done, float* __restrict__ y,
                         const Tile& tl, float* sm) {
  using RM = Region<1>;
  float* MG = sm;
  float* S = sm + cmax(Region<4>::size, RM::size);
  stage_gray_smooth<2, kEdge>(x, tl, MG, S);
  if (kEdge) mirror_smooth<2>(tl, S);
  // all above needs nothing of canny_max_kernel: wait for its slots now
  wait_image(done, tl.n, tl.slots);
  const float D = __fadd_rn(image_max(mslot, tl), 1e-12f);  // syncs
  stage_mag<1, kEdge>(tl, S, D, MG);
  __syncthreads();
  using RS = Region<2>;
#pragma unroll 1
  for (int i = threadIdx.x; i < Region<0>::size; i += kThreads) {
    const int lr = i / kTW, lc = i - lr * kTW;
    const int r = tl.r0 + lr, c = tl.c0 + lc;
    if (kEdge && !tl.in_image(r, c)) continue;
    const float* w = S + (lr + 1) * RS::W + lc + 1;
    const Grad g = sobel(w, w + RS::W, w + 2 * RS::W);
    const int o = (lr + 1) * RM::W + lc + 1;
    const Nms q = nms(g.gx, g.gy, MG[o], MG[o + 1], MG[o - 1],
                      MG[o + RM::W], MG[o - RM::W]);
    y[tl.pixel(r, c)] = threshold(q.e);
  }
}

__global__ void __launch_bounds__(kThreads, 6)
canny_map_kernel(const float* __restrict__ x,
                 const unsigned int* __restrict__ mslot,
                 int* __restrict__ done, float* __restrict__ y, int H, int W,
                 int tiles_y, int tiles_x) {
  extern __shared__ float sm[];
  const Tile tl(H, W, tiles_y, tiles_x);
  if (tl.edge(4))
    map_body<true>(x, mslot, done, y, tl, sm);
  else
    map_body<false>(x, mslot, done, y, tl, sm);
  release_image(done, done + gridDim.z, tl.n, tl.slots);
}

// ------------------------------------------------------------ backward

// The sweep of canny_local_kernel: warp w owns the tile columns
// [30·(w % 3) − 1, 30·(w % 3) + 31) (its lanes 1–30 are outputs) and rows
// [16·(w / 3) − 1, 16·(w / 3) + 17). At each row it computes the NMS and its
// local backward, takes its left and right neighbours' cotangents by
// shuffle, and finishes dmag of the row above with the cotangent sent up
// from this one: dmag = local + from left + from right + from above + from
// below, in that order. Then dgx_part, dgy_part, Σ dmag·mag0 and the ties.
template <bool kEdge>
__device__ void sweep(const Tile& tl, const float* MG, const float* S,
                      const float* __restrict__ gout,
                      float D, float M, float* __restrict__ px,
                      float* __restrict__ py, float& psum, int& pcnt,
                      int* tie_n, int* __restrict__ tie_pos,
                      float* __restrict__ tie_g) {
  using RP = Region<2>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tc = kSweep * (warp % 3) + lane - 1;  // −1 … kTW
  const int c = tl.c0 + tc;
  const bool out_lane = lane >= 1 && lane <= kSweep;
  const int tr0 = (kTH / 2) * (warp / 3) - 1;
  const float inv_D = __frcp_rn(D);
  auto load_g = [&](int tr) {
    const int r = tl.r0 + tr;
    return (!kEdge || tl.in_image(r, c)) ? __ldg(gout + tl.pixel(r, c))
                                         : 0.f;
  };
  float g_next = load_g(tr0);
  // the gaussian's 3×3 window around (tr, tc), slid down the column
  using RS = Region<3>;
  const float* src = S + (tr0 + 2) * RS::W + tc + 2;
  float wa[3], wm[3], wd[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    wm[v] = src[v];
    wd[v] = src[RS::W + v];
  }
  float part_p = 0.f, to_d_p = 0.f, gx_p = 0.f, gy_p = 0.f, dgx_p = 0.f,
        dgy_p = 0.f;
#pragma unroll 1
  for (int k = 0; k < kTH / 2 + 2; ++k) {
    const int tr = tr0 + k, r = tl.r0 + tr;
    const float g = g_next;
    if (k + 1 < kTH / 2 + 2) g_next = load_g(tr + 1);
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      wa[v] = wm[v];
      wm[v] = wd[v];
      wd[v] = src[(k + 2) * RS::W + v];
    }
    const Grad gr = sobel(wa, wm, wd);
    const float gxv = gr.gx, gyv = gr.gy;
    const int o = (tr + 2) * RP::W + tc + 2;
    Local l{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (!kEdge || tl.in_image(r, c)) {
      const float mc = MG[o], mr = MG[o + 1], ml = MG[o - 1],
                  md = MG[o + RP::W], mu = MG[o - RP::W];
      Nms q = nms_fast(gxv, gyv, mc, mr, ml, md, mu);
      // e is 0 exactly where mag is, in both; near e / 0.2 = 1 (or not
      // finite) the clip's derivative needs the exact e
      const bool exact = !(fabsf(5.f * q.e - 1.f) > 1e-3f);
      if (exact) q = nms(gxv, gyv, mc, mr, ml, md, mu);
      l = local_bwd(q, g, exact);
    }
    const float from_l = __shfl_up_sync(0xffffffffu, l.to_r, 1);
    const float from_r = __shfl_down_sync(0xffffffffu, l.to_l, 1);
    const float part = l.dmag + from_l + from_r + to_d_p;
    const int rp = r - 1;
    if (k >= 2 && out_lane && (!kEdge || tl.in_image(rp, c))) {
      const float dmag = part_p + l.to_u;
      const float m0 = mag0_of(gx_p, gy_p);
      psum += dmag * m0;
      const float dm = dmag * inv_D, inv_m0 = __fdividef(1.f, m0);
      // gx on the first and last columns and gy on the first and last
      // rows are identically 0 under the reflect pad: no gradient (F24)
      const size_t p = tl.pixel(rp, c);
      px[p] = (c > 0 && c < tl.W - 1) ? dgx_p + dm * (gx_p * inv_m0) : 0.f;
      py[p] = (rp > 0 && rp < tl.H - 1) ? dgy_p + dm * (gy_p * inv_m0) : 0.f;
      if (m0 == M) {  // the max's term, for the input kernel to add
        ++pcnt;
        const int e = atomicAdd(tie_n, 1);
        if (e < kTies) {
          const int t = tl.slot() * kTies + e;
          tie_pos[t] = rp * tl.W + c;
          tie_g[2 * t] = __fdiv_rn(gx_p, m0);
          tie_g[2 * t + 1] = __fdiv_rn(gy_p, m0);
        }
      }
    }
    part_p = part;
    to_d_p = l.to_d;
    gx_p = gxv;
    gy_p = gyv;
    dgx_p = l.dgx;
    dgy_p = l.dgy;
  }
}

template <bool kEdge>
__device__ void local_body(const float* __restrict__ x,
                           const float* __restrict__ gout, const Tile& tl,
                           float D, float M, float* __restrict__ px,
                           float* __restrict__ py, float& psum, int& pcnt,
                           int* tie_n, int* __restrict__ tie_pos,
                           float* __restrict__ tie_g, float* sm) {
  float* MG = sm;
  float* S = sm + cmax(Region<5>::size, Region<2>::size);
  stage_gray_smooth<3, kEdge>(x, tl, MG, S);
  if (kEdge) {
    mirror_smooth<3>(tl, S);
    __syncthreads();
  }
  stage_mag<2, kEdge>(tl, S, D, MG);
  __syncthreads();
  sweep<kEdge>(tl, MG, S, gout, D, M, px, py, psum, pcnt, tie_n, tie_pos,
               tie_g);
}

__global__ void __launch_bounds__(kThreads, 5)
canny_local_kernel(const float* __restrict__ x,
                   const float* __restrict__ gout,
                   const unsigned int* __restrict__ mslot,
                   float* __restrict__ psum_out, int* __restrict__ pcnt_out,
                   int* __restrict__ tie_pos, float* __restrict__ tie_g,
                   float* __restrict__ px, float* __restrict__ py,
                   int* __restrict__ done, int H, int W, int tiles_y,
                   int tiles_x) {
  extern __shared__ float sm[];
  __shared__ float redf[kWarps];
  __shared__ int redi[kWarps];
  __shared__ int tie_n;
  let_next_start();
  const Tile tl(H, W, tiles_y, tiles_x);
  if (threadIdx.x == 0) tie_n = 0;  // image_max's barrier publishes it
  const float M = image_max(mslot, tl);
  const float D = __fadd_rn(M, 1e-12f);
  float psum = 0.f;
  int pcnt = 0;
  if (tl.edge(5))
    local_body<true>(x, gout, tl, D, M, px, py, psum, pcnt, &tie_n, tie_pos,
                     tie_g, sm);
  else
    local_body<false>(x, gout, tl, D, M, px, py, psum, pcnt, &tie_n,
                      tie_pos, tie_g, sm);
  psum = block_sum(psum, redf);
  pcnt = block_count(pcnt, redi);
  if (threadIdx.x == 0) {
    psum_out[tl.slot()] = psum;
    pcnt_out[tl.slot()] = pcnt;
  }
  count_done(done, tl.n);
}

// dgx, dgy on Region<3>: the planes, 0 outside the image and on F24's
// border; with kTies, plus the max's term share·tie·(g/mag0) at every tie,
// gx, gy and mag0 recomputed from the gaussian S on Region<4> (where a tile
// within one of this one holds more ties than its list)
template <bool kEdge, bool kTies>
__device__ void load_dgrad(const Tile& tl, const float* __restrict__ px,
                           const float* __restrict__ py, const float* S,
                           float share, float M, float* DX, float* DY) {
  using R = Region<3>;
  using RS = Region<4>;
  constexpr int kPlanes = 8;  // positions whose loads a thread issues at once
  for (int i0 = threadIdx.x; i0 < R::size; i0 += kPlanes * kThreads) {
    float vx[kPlanes], vy[kPlanes];
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      const int i = i0 + k * kThreads;
      const int lr = i / R::W, lc = i - lr * R::W;
      const int r = tl.r0 - 3 + lr, c = tl.c0 - 3 + lc;
      const bool in = i < R::size && (!kEdge || tl.in_image(r, c));
      const size_t p = in ? tl.pixel(r, c) : 0;
      vx[k] = in && c > 0 && c < tl.W - 1 ? __ldcg(px + p) : 0.f;
      vy[k] = in && r > 0 && r < tl.H - 1 ? __ldcg(py + p) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      const int i = i0 + k * kThreads;
      if (i >= R::size) continue;
      if (kTies) {
        const int lr = i / R::W, lc = i - lr * R::W;
        const int r = tl.r0 - 3 + lr, c = tl.c0 - 3 + lc;
        if (!kEdge || tl.in_image(r, c)) {
          const float* s = S + lr * RS::W + lc;
          const Grad g = sobel(s, s + RS::W, s + 2 * RS::W);
          const float m0 = mag0_of(g.gx, g.gy);
          const float st = share * (m0 == M ? 1.f : 0.f);
          if (c > 0 && c < tl.W - 1) vx[k] += st * __fdiv_rn(g.gx, m0);
          if (r > 0 && r < tl.H - 1) vy[k] += st * __fdiv_rn(g.gy, m0);
        }
      }
      DX[i] = vx[k];
      DY[i] = vy[k];
    }
  }
}

// where the max's cotangent is not finite, share·0 (NaN) at every image
// position off F24's border, as the plain version's amax gradient; a
// finite share·0 adds nothing
__device__ void add_nonfinite(const Tile& tl, float z, float* DX,
                              float* DY) {
  using R = Region<3>;
  for (int i = threadIdx.x; i < R::size; i += kThreads) {
    const int lr = i / R::W, lc = i - lr * R::W;
    const int r = tl.r0 - 3 + lr, c = tl.c0 - 3 + lc;
    if (!tl.in_image(r, c)) continue;
    if (c > 0 && c < tl.W - 1) DX[i] += z;
    if (r > 0 && r < tl.H - 1) DY[i] += z;
  }
}

// the max's term at the ties the lists of the tiles within one of this one
// hold, where they fall on Region<3>: share·(gx, gy)/mag0, cut on F24's
// border (every tie a distinct pixel: no two threads add to one place)
__device__ void add_ties(const Tile& tl, const int* __restrict__ pcnt,
                         const int* __restrict__ tie_pos,
                         const float* __restrict__ tie_g, int tiles_y,
                         int tiles_x, float share, float* DX, float* DY) {
  using R = Region<3>;
  static_assert(9 * kTies <= kThreads, "one list entry a thread");
  const int nb = threadIdx.x / kTies, e = threadIdx.x % kTies;
  if (nb >= 9) return;
  const int ty = tl.ty + nb / 3 - 1, tx = tl.tx + nb % 3 - 1;
  if (ty < 0 || ty >= tiles_y || tx < 0 || tx >= tiles_x) return;
  const int slot = tl.n * tl.slots + ty * tiles_x + tx;
  if (e >= __ldcg(pcnt + slot)) return;
  const int t = slot * kTies + e;
  const int pos = __ldcg(tie_pos + t);
  const int r = pos / tl.W, c = pos - r * tl.W;
  const int lr = r - (tl.r0 - 3), lc = c - (tl.c0 - 3);
  if (lr < 0 || lr >= R::H || lc < 0 || lc >= R::W) return;
  if (c > 0 && c < tl.W - 1)
    DX[lr * R::W + lc] += share * __ldcg(tie_g + 2 * t);
  if (r > 0 && r < tl.H - 1)
    DY[lr * R::W + lc] += share * __ldcg(tie_g + 2 * t + 1);
}

// the Sobel's transpose on Region<2> from dgx, dgy on Region<3>, straight
// (the reflect pad's folds come after, at edge tiles): a thread a column of
// half the rows, the three rows it reads slid down in registers
__device__ void stage_sobel_t(const float* DX, const float* DY, float* dS) {
  using R = Region<2>;
  using RD = Region<3>;
  constexpr int L = R::H / 2;
  for (int item = threadIdx.x; item < 2 * R::W; item += kThreads) {
    const int half = item / R::W, j = item - half * R::W;
    const float* ax = DX + half * L * RD::W + j;
    const float* ay = DY + half * L * RD::W + j;
    float* out = dS + half * L * R::W + j;
    // per row: dgx at columns j, j + 2, dgy at j, j + 1, j + 2
    float w[3][5];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      w[u][0] = ax[u * RD::W];
      w[u][1] = ax[u * RD::W + 2];
      w[u][2] = ay[u * RD::W];
      w[u][3] = ay[u * RD::W + 1];
      w[u][4] = ay[u * RD::W + 2];
    }
#pragma unroll
    for (int t = 0; t < L; ++t) {
      const int a = t % 3, m = (t + 1) % 3, d = (t + 2) % 3;
      w[d][0] = ax[(t + 2) * RD::W];
      w[d][1] = ax[(t + 2) * RD::W + 2];
      w[d][2] = ay[(t + 2) * RD::W];
      w[d][3] = ay[(t + 2) * RD::W + 1];
      w[d][4] = ay[(t + 2) * RD::W + 2];
      out[t * R::W] =
          ((w[a][0] + 2.f * w[m][0] + w[d][0]) -
           (w[a][1] + 2.f * w[m][1] + w[d][1])) +
          ((w[a][2] + 2.f * w[a][3] + w[a][4]) -
           (w[d][2] + 2.f * w[d][3] + w[d][4]));
    }
  }
}

// dgx, dgy on Region<3> at (lr, lc), 0 off the array (outside the image)
__device__ __forceinline__ float at3(const float* A, int lr, int lc) {
  using R = Region<3>;
  return (lr >= 0 && lr < R::H && lc >= 0 && lc < R::W) ? A[lr * R::W + lc]
                                                         : 0.f;
}

// the Sobel's transpose at one image position (t, s), inside the image or
// on the reflect pad's ring: the straight pass's sum, gathered
__device__ float sobel_t_at(const Tile& tl, const float* DX, const float* DY,
                            int t, int s) {
  const int i = t - (tl.r0 - 3), j = s - (tl.c0 - 3);
  return ((at3(DX, i - 1, j - 1) + 2.f * at3(DX, i, j - 1) +
           at3(DX, i + 1, j - 1)) -
          (at3(DX, i - 1, j + 1) + 2.f * at3(DX, i, j + 1) +
           at3(DX, i + 1, j + 1))) +
         ((at3(DY, i - 1, j - 1) + 2.f * at3(DY, i - 1, j) +
           at3(DY, i - 1, j + 1)) -
          (at3(DY, i + 1, j - 1) + 2.f * at3(DY, i + 1, j) +
           at3(DY, i + 1, j + 1)));
}

// the positions of the reflect pad of `pad` (t ∈ [−pad, n − 1 + pad])
// other than a that map onto a: −a near the start, 2(n − 1) − a near the
// end; at(0) is a itself
struct Mirrors {
  int a, n, t1, t2;
  __device__ Mirrors(int a_, int size, int pad) : a(a_), n(0), t1(0), t2(0) {
    if (a >= 1 && a <= pad) t1 = -a, n = 1;
    if (a >= size - 1 - pad && a <= size - 2) {
      if (n) t2 = 2 * (size - 1) - a;
      else t1 = 2 * (size - 1) - a;
      ++n;
    }
  }
  __device__ int at(int i) const { return i == 0 ? a : (i == 1 ? t1 : t2); }
};

// The lines (rows or columns) of [lo, hi) that the reflect pad of `pad`
// folds others onto: [1, pad] and [n − 1 − pad, n − 2], in the image. Kept
// in shared memory by one thread, read by all after a barrier.
struct FoldLines {
  int n, at[4];
  __device__ void find(int lo, int hi, int size, int pad) {
    n = 0;
    for (int a = 1; a <= pad; ++a)
      if (a >= lo && a < hi && a < size) at[n++] = a;
    for (int a = size - 1 - pad; a <= size - 2; ++a)
      if (a >= 0 && a >= lo && a < hi && !(a >= 1 && a <= pad)) at[n++] = a;
  }
};

// Each position (a, b) of [r0, r0 + rows) × [c0, c0 + cols) that a fold
// reaches — on a fold row (every column) or a fold column (the other rows)
// — once: f(a, b).
template <typename F>
__device__ void for_fold_targets(const FoldLines& fr, const FoldLines& fc,
                                 int r0, int rows, int c0, int cols, F&& f) {
  const int n_row_items = fr.n * cols;
  for (int i = threadIdx.x; i < n_row_items + fc.n * rows; i += kThreads) {
    int a, b;
    if (i < n_row_items) {
      a = fr.at[i / cols];
      b = c0 + i % cols;
    } else {
      const int k = i - n_row_items;
      b = fc.at[k / rows];
      a = r0 + k % rows;
      bool on_row = false;
      for (int j = 0; j < fr.n; ++j) on_row |= fr.at[j] == a;
      if (on_row) continue;
    }
    f(a, b);
  }
}

// at an edge tile: dS made 0 outside the image on Region<2> (the gaussian's
// transpose reads image positions only), then the Sobel's reflect folds
// added onto its image positions (rows 1 and H − 2, columns 1 and W − 2
// take the ring's)
__device__ void fold_sobel_t(const Tile& tl, const float* DX, const float* DY,
                             float* dS, FoldLines* lines) {
  using R = Region<2>;
  if (threadIdx.x == 0) {
    lines[0].find(tl.r0 - 2, tl.r0 + kTH + 2, tl.H, 1);
    lines[1].find(tl.c0 - 2, tl.c0 + kTW + 2, tl.W, 1);
  }
  for (int i = threadIdx.x; i < R::size; i += kThreads) {
    const int lr = i / R::W, lc = i - lr * R::W;
    if (!tl.in_image(tl.r0 - 2 + lr, tl.c0 - 2 + lc)) dS[i] = 0.f;
  }
  __syncthreads();
  for_fold_targets(lines[0], lines[1], tl.r0 - 2, R::H, tl.c0 - 2, R::W,
                   [&](int a, int b) {
    if (!tl.in_image(a, b)) return;
    const Mirrors mr(a, tl.H, 1), mc(b, tl.W, 1);
    const int i = (a - tl.r0 + 2) * R::W + b - tl.c0 + 2;
    float acc = dS[i];
    for (int ir = 0; ir <= mr.n; ++ir)
      for (int ic = 0; ic <= mc.n; ++ic)
        if (ir || ic) acc += sobel_t_at(tl, DX, DY, mr.at(ir), mc.at(ic));
    dS[i] = acc;
  });
}

// the gaussian's transpose (its taps are symmetric: the same correlation)
// on the tile from dS on Region<2>; f(lr, lc, value) for each position
template <typename F>
__device__ __forceinline__ void stage_gauss_t(const float* dS, F&& f) {
  using R = Region<0>;
  using RS = Region<2>;
  constexpr int L = R::H / 2;
  constexpr float k[25] = VWFD_GAUSS_TAPS;
  for (int item = threadIdx.x; item < 2 * R::W; item += kThreads) {
    const int half = item / R::W, j = item - half * R::W;
    const float* g = dS + half * L * RS::W + j;
    float w[5][5];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 5; ++v) w[u][v] = g[u * RS::W + v];
#pragma unroll
    for (int t = 0; t < L; ++t) {
#pragma unroll
      for (int v = 0; v < 5; ++v) w[(t + 4) % 5][v] = g[(t + 4) * RS::W + v];
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < 5; ++u)
#pragma unroll
        for (int v = 0; v < 5; ++v)
          acc = fmaf(k[u * 5 + v], w[(t + u) % 5][v], acc);
      f(half * L + t, j, acc);
    }
  }
}

// the gaussian's transpose at one position (t, s) of the reflect pad's
// ring, from dS's image positions (all within Region<2> of an image
// position of the tile: those are the only ones read)
__device__ float gauss_t_at(const Tile& tl, const float* dS, int t, int s) {
  using R = Region<2>;
  constexpr float k[25] = VWFD_GAUSS_TAPS;
  bool col_in[5];
#pragma unroll
  for (int v = 0; v < 5; ++v)
    col_in[v] = (unsigned)(s + v - 2) < (unsigned)tl.W;
  const float* base = dS + (t - tl.r0) * R::W + s - tl.c0;  // (t−2, s−2)
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < 5; ++u) {
    if ((unsigned)(t + u - 2) >= (unsigned)tl.H) continue;
#pragma unroll
    for (int v = 0; v < 5; ++v)
      if (col_in[v]) acc = fmaf(k[u * 5 + v], base[u * R::W + v], acc);
  }
  return acc;
}

__device__ __forceinline__ void store_dx(float* __restrict__ dx,
                                         const Tile& tl, int r, int c,
                                         float v) {
  float* d = dx + tl.pixel(r, c) * 3;
  d[0] = v * kW0;
  d[1] = v * kW1;
  d[2] = v * kW2;
}

template <bool kEdge>
__device__ void input_body(const float* __restrict__ x,
                           const unsigned int* __restrict__ mslot,
                           const float* __restrict__ psum,
                           const int* __restrict__ pcnt,
                           const int* __restrict__ tie_pos,
                           const float* __restrict__ tie_g,
                           const float* __restrict__ px,
                           const float* __restrict__ py,
                           float* __restrict__ dx, const Tile& tl,
                           int tiles_y, int tiles_x, float* sm) {
  __shared__ float redf[kWarps];
  __shared__ int redi[kWarps];
  float* DX = sm;
  float* DY = sm + Region<3>::size;
  float* Q = sm + cmax(cmax(2 * Region<3>::size, Region<6>::size),
                       Region<0>::size);
  load_dgrad<kEdge, false>(tl, px, py, nullptr, 0.f, 0.f, DX, DY);
  // the max's cotangent, −Σ dmag·mag0 / D², shared by the tied pixels:
  // the image's slots summed in one fixed order by every CTA (their reads
  // overlap the planes')
  // one pass over the image's slots: M; the sum and the ties, in one fixed
  // order; whether a tile within one of this one (the ±3 halo reaches no
  // further) holds more ties than its list (then recompute gx, gy, mag0 —
  // gray ±6, the gaussian ±4 — and reload the planes with the max's term
  // at every tie)
  unsigned int mb = 0u;
  float sum = 0.f;
  int cnt = 0, over = 0;
  for (int i = threadIdx.x; i < tl.slots; i += kThreads) {
    const int o = tl.n * tl.slots + i, k = __ldcg(pcnt + o);
    const unsigned int b = __ldcg(mslot + o);
    mb = b > mb ? b : mb;
    sum += __ldcg(psum + o);
    cnt += k;
    const int ty = i / tiles_x, tx = i - ty * tiles_x;
    if (k > kTies && abs(ty - tl.ty) <= 1 && abs(tx - tl.tx) <= 1) over = 1;
  }
  mb = __reduce_max_sync(0xffffffffu, mb);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  over = __reduce_or_sync(0xffffffffu, over);
  __shared__ unsigned int red_m[kWarps];
  __shared__ int red_o[kWarps];
  if ((threadIdx.x & 31) == 0) {
    red_m[threadIdx.x >> 5] = mb;
    redf[threadIdx.x >> 5] = sum;
    redi[threadIdx.x >> 5] = cnt;
    red_o[threadIdx.x >> 5] = over;
  }
  __syncthreads();  // also publishes the planes
  mb = red_m[0];
  sum = redf[0];
  cnt = redi[0];
  over = red_o[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    mb = red_m[w] > mb ? red_m[w] : mb;
    sum += redf[w];
    cnt += redi[w];
    over |= red_o[w];
  }
  const float M = max_value(mb);
  const float D = __fadd_rn(M, 1e-12f);
  const float share = (-sum / (D * D)) / (float)cnt;
  const bool recompute = over != 0;
  if (recompute) {
    if (tl.edge(6))
      stage_gray_smooth<4, true>(x, tl, DX, Q);
    else
      stage_gray_smooth<4, false>(x, tl, DX, Q);
    if (tl.edge(6)) {
      mirror_smooth<4>(tl, Q);
      __syncthreads();
    }
    load_dgrad<kEdge, true>(tl, px, py, Q, share, M, DX, DY);
    __syncthreads();
  } else {
    const float z = share * 0.f;
    if (z != 0.f) {
      add_nonfinite(tl, z, DX, DY);
      __syncthreads();
    }
    add_ties(tl, pcnt, tie_pos, tie_g, tiles_y, tiles_x, share, DX, DY);
    __syncthreads();
  }
  float* dS = Q;
  stage_sobel_t(DX, DY, dS);
  __syncthreads();
  if (!kEdge) {
    stage_gauss_t(dS, [&](int lr, int lc, float v) {
      store_dx(dx, tl, tl.r0 + lr, tl.c0 + lc, v);
    });
    return;
  }
  __shared__ FoldLines lines[2];
  fold_sobel_t(tl, DX, DY, dS, lines);
  __syncthreads();
  float* dG = DX;  // dgx, dgy are read no more
  stage_gauss_t(dS, [&](int lr, int lc, float v) { dG[lr * kTW + lc] = v; });
  if (threadIdx.x == 0) {
    lines[0].find(tl.r0, tl.r0 + kTH, tl.H, 2);
    lines[1].find(tl.c0, tl.c0 + kTW, tl.W, 2);
  }
  __syncthreads();
  // the gaussian's reflect folds onto the tile, then dx
  for_fold_targets(lines[0], lines[1], tl.r0, kTH, tl.c0, kTW,
                   [&](int a, int b) {
    if (!tl.in_image(a, b)) return;
    const Mirrors mr(a, tl.H, 2), mc(b, tl.W, 2);
    float& v = dG[(a - tl.r0) * kTW + b - tl.c0];
    for (int ir = 0; ir <= mr.n; ++ir)
      for (int ic = 0; ic <= mc.n; ++ic)
        if (ir || ic) v += gauss_t_at(tl, dS, mr.at(ir), mc.at(ic));
  });
  __syncthreads();
  for (int i = threadIdx.x; i < Region<0>::size; i += kThreads) {
    const int lr = i / kTW, lc = i - lr * kTW;
    const int a = tl.r0 + lr, b = tl.c0 + lc;
    if (tl.in_image(a, b)) store_dx(dx, tl, a, b, dG[i]);
  }
}

__global__ void __launch_bounds__(kThreads, 5)
canny_input_kernel(const float* __restrict__ x,
                   const unsigned int* __restrict__ mslot,
                   const float* __restrict__ psum,
                   const int* __restrict__ pcnt,
                   const int* __restrict__ tie_pos,
                   const float* __restrict__ tie_g,
                   const float* __restrict__ px,
                   const float* __restrict__ py, float* __restrict__ dx,
                   int* __restrict__ done, int H, int W, int tiles_y,
                   int tiles_x) {
  extern __shared__ float sm[];
  const Tile tl(H, W, tiles_y, tiles_x);
  // canny_local_kernel's slots, lists and planes of this image
  wait_image(done, tl.n, tl.slots);
  if (tl.edge(4))
    input_body<true>(x, mslot, psum, pcnt, tie_pos, tie_g, px, py, dx, tl,
                     tiles_y, tiles_x, sm);
  else
    input_body<false>(x, mslot, psum, pcnt, tie_pos, tie_g, px, py, dx, tl,
                      tiles_y, tiles_x, sm);
  release_image(done, done + gridDim.z, tl.n, tl.slots);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// launch `kernel` as the programmatic dependent of the one before it on `s`
template <typename... P, typename... A>
cudaError_t launch_dependent(void (*kernel)(P...), dim3 grid, int smem,
                             cudaStream_t s, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// the host plan's geometry (kernels/canny.py::plan) against the kernels'
bool plan_ok(int N, int H, int W, int tiles_y, int tiles_x) {
  return H >= 3 && W >= 3 && N >= 1 && N <= 65535 &&
         tiles_y == (H + kTH - 1) / kTH && tiles_x == (W + kTW - 1) / kTW &&
         tiles_y <= 65535;
}

}  // namespace

// The kernels' geometry, for the host plan to check against: tile rows,
// columns, threads, a tile's tie list, then the shared-memory bytes of the
// max, map, local and input kernels.
extern "C" int vwfd_canny_geometry(int* out) {
  out[0] = kTH;
  out[1] = kTW;
  out[2] = kThreads;
  out[3] = kTies;
  out[4] = kSmemMax * 4;
  out[5] = kSmemMap * 4;
  out[6] = kSmemLocal * 4;
  out[7] = kSmemInput * 4;
  return 8;
}

// x (N, H, W, 3) f32 contiguous, H, W ≥ 3; mslot N·tiles_y·tiles_x uint32,
// each written by the max kernel (kept for the backward); y (N, H, W) f32;
// done 2·N int32, zero (and left zero).
extern "C" int vwfd_canny_fwd(const void* x, void* mslot, void* y,
                              void* done, int N, int H, int W, int tiles_y,
                              int tiles_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!plan_ok(N, H, W, tiles_y, tiles_x)) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(canny_map_kernel, kSmemMap * 4);
  if (e == cudaSuccess) e = allow_smem(canny_max_kernel, kSmemMax * 4);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(tiles_x, tiles_y, N);
  canny_max_kernel<<<grid, kThreads, kSmemMax * 4, s>>>(
      static_cast<const float*>(x), static_cast<unsigned int*>(mslot),
      static_cast<int*>(done), H, W, tiles_y, tiles_x);
  e = launch_dependent(canny_map_kernel, grid, kSmemMap * 4, s,
                       static_cast<const float*>(x),
                       static_cast<const unsigned int*>(mslot),
                       static_cast<int*>(done), static_cast<float*>(y), H, W,
                       tiles_y, tiles_x);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// gout (N, H, W) f32; x, mslot the forward's; psum (f32) and pcnt (int32)
// N·tiles_y·tiles_x, tie_pos (int32, 16 a tile) and tie_g (f32, 32 a
// tile), px, py (N, H, W) f32, each written by the local kernel where the
// input kernel reads it; dx (N, H, W, 3); done 2·N int32, zero (and left
// zero).
extern "C" int vwfd_canny_bwd(const void* x, const void* gout,
                              const void* mslot, void* psum, void* pcnt,
                              void* tie_pos, void* tie_g, void* px, void* py,
                              void* dx, void* done, int N, int H, int W,
                              int tiles_y, int tiles_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!plan_ok(N, H, W, tiles_y, tiles_x)) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(canny_local_kernel, kSmemLocal * 4);
  if (e == cudaSuccess) e = allow_smem(canny_input_kernel, kSmemInput * 4);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(tiles_x, tiles_y, N);
  canny_local_kernel<<<grid, kThreads, kSmemLocal * 4, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(gout),
      static_cast<const unsigned int*>(mslot), static_cast<float*>(psum),
      static_cast<int*>(pcnt), static_cast<int*>(tie_pos),
      static_cast<float*>(tie_g), static_cast<float*>(px),
      static_cast<float*>(py), static_cast<int*>(done), H, W, tiles_y,
      tiles_x);
  e = launch_dependent(
      canny_input_kernel, grid, kSmemInput * 4, s,
      static_cast<const float*>(x), static_cast<const unsigned int*>(mslot),
      static_cast<const float*>(psum), static_cast<const int*>(pcnt),
      static_cast<const int*>(tie_pos), static_cast<const float*>(tie_g),
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<float*>(dx), static_cast<int*>(done), H, W, tiles_y,
      tiles_x);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
