// K6 `median3`: the attack pool's 3×3 median filter, forward and backward.
//
// Replaces vwfd_tpu/ops/filters.py::_median3 (:48-114): the median of the
// nine views of the reflect-padded neighbourhood (edge pixel not repeated:
// index -1 reads 1, index H reads H-2) by the Paeth network _PAETH_SWAPS,
// 19 min/max, which only reorders values, so the result is bit-exact. The
// backward routes each output cotangent to the input pixel of the FIRST of
// the nine views, in raster order (dy, then dx), whose value equals the
// median, followed through the reflect padding (filters.py:86-111).
//
// Bound: bytes. Forward: x read once, y written once (100.7 MB at the
// training shape, 64 frames of 256²×3 f32). Backward: x and g read, gx
// written (151 MB). Design: a CTA takes a tile of 32×8 pixels and stages
// its reflect-padded halo in shared memory with coalesced loads (a warp
// reads a contiguous span of the NHWC row); one thread per pixel runs the
// network for the three channels. The backward is a deterministic gather,
// no float atomics: the CTA recomputes, for each output of its tile and a
// one-pixel ring around it, which of the 3×3 sources supplied the median
// (a code 0..8 of the source's offset from the output), then each input
// pixel adds the cotangents of the outputs that chose it, visiting its
// neighbours in raster order from (-1,-1) to (1,1) -- the plain version's
// order, so both sums are bit-identical.
#include "common.cuh"

namespace {

constexpr int kTx = 32, kTy = 8, kThreads = kTx * kTy;
constexpr int kC = 3;

// vwfd_tpu/ops/filters.py::_PAETH_SWAPS
__device__ __forceinline__ float paeth9(float* v) {
#define SW(i, j)                          \
  {                                       \
    const float lo = fminf(v[i], v[j]);   \
    const float hi = fmaxf(v[i], v[j]);   \
    v[i] = lo;                            \
    v[j] = hi;                            \
  }
  SW(1, 2) SW(4, 5) SW(7, 8) SW(0, 1) SW(3, 4) SW(6, 7) SW(1, 2) SW(4, 5)
  SW(7, 8) SW(0, 3) SW(5, 8) SW(4, 7) SW(3, 6) SW(1, 4) SW(2, 5) SW(4, 7)
  SW(4, 2) SW(6, 4) SW(4, 2)
#undef SW
  return v[4];
}

// reflect padding by one (and a clamp for extents below 3)
__device__ __forceinline__ int refl(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);
}

// stage rows [ya, ya + ny) × cols [xa, xa + nx) of frame n, reflected
// into the image, as s[ch][ly][lx] (pitch nx)
__device__ __forceinline__ void stage(float* s, const float* __restrict__ x,
                                      int n, int ya, int ny, int xa, int nx,
                                      int H, int W) {
  const int per_row = nx * kC;
  for (int i = threadIdx.x; i < ny * per_row; i += kThreads) {
    const int ly = i / per_row, rem = i % per_row;
    const int lx = rem / kC, ch = rem % kC;
    const int gy = refl(ya + ly, H), gx = refl(xa + lx, W);
    s[(ch * ny + ly) * nx + lx] =
        x[(((long long)n * H + gy) * W + gx) * kC + ch];
  }
}

__global__ void __launch_bounds__(kThreads)
    median3_fwd(const float* __restrict__ x, float* __restrict__ y, int H,
                int W) {
  constexpr int NY = kTy + 2, NX = kTx + 2;
  __shared__ float s[kC * NY * NX];
  const int n = blockIdx.z, y0 = blockIdx.y * kTy, x0 = blockIdx.x * kTx;
  stage(s, x, n, y0 - 1, NY, x0 - 1, NX, H, W);
  __syncthreads();
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int py = y0 + ty, px = x0 + tx;
  if (py >= H || px >= W) return;
  float* out = y + (((long long)n * H + py) * W + px) * kC;
#pragma unroll
  for (int ch = 0; ch < kC; ++ch) {
    float v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      v[k] = s[(ch * NY + ty + k / 3) * NX + tx + k % 3];
    out[ch] = paeth9(v);
  }
}

__global__ void __launch_bounds__(kThreads)
    median3_bwd(const float* __restrict__ x, const float* __restrict__ g,
                float* __restrict__ gx, int H, int W) {
  // outputs: the tile and a one-pixel ring; inputs: a two-pixel ring
  constexpr int OY = kTy + 2, OX = kTx + 2, IY = kTy + 4, IX = kTx + 4;
  __shared__ float s[kC * IY * IX];
  __shared__ float sg[kC * OY * OX];
  __shared__ unsigned char code[kC * OY * OX];
  const int n = blockIdx.z, y0 = blockIdx.y * kTy, x0 = blockIdx.x * kTx;
  stage(s, x, n, y0 - 2, IY, x0 - 2, IX, H, W);
  for (int i = threadIdx.x; i < OY * OX * kC; i += kThreads) {
    const int ly = i / (OX * kC), rem = i % (OX * kC);
    const int lx = rem / kC, ch = rem % kC;
    const int oy = y0 - 1 + ly, ox = x0 - 1 + lx;
    const bool in = oy >= 0 && oy < H && ox >= 0 && ox < W;
    sg[(ch * OY + ly) * OX + lx] =
        in ? g[(((long long)n * H + oy) * W + ox) * kC + ch] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kC * OY * OX; i += kThreads) {
    const int ch = i / (OY * OX), rem = i % (OY * OX);
    const int ly = rem / OX, lx = rem % OX;
    const int oy = y0 - 1 + ly, ox = x0 - 1 + lx;
    unsigned char cd = 255;  // no output here
    if (oy >= 0 && oy < H && ox >= 0 && ox < W) {
      float v[9], m[9];
#pragma unroll
      for (int k = 0; k < 9; ++k)
        m[k] = v[k] = s[(ch * IY + ly + k / 3) * IX + lx + k % 3];
      const float med = paeth9(m);
      int k = 0;
      while (k < 8 && v[k] != med) ++k;
      // the chosen view's source, relative to the output (-1, 0 or 1)
      const int sy = refl(oy + k / 3 - 1, H) - oy;
      const int sx = refl(ox + k % 3 - 1, W) - ox;
      cd = (unsigned char)((sy + 1) * 3 + sx + 1);
    }
    code[i] = cd;
  }
  __syncthreads();
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int py = y0 + ty, px = x0 + tx;
  if (py >= H || px >= W) return;
  float* out = gx + (((long long)n * H + py) * W + px) * kC;
#pragma unroll
  for (int ch = 0; ch < kC; ++ch) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < 9; ++d) {
      const int dy = d / 3 - 1, dx = d % 3 - 1;  // output = input + (dy, dx)
      const int o = (ch * OY + ty + 1 + dy) * OX + tx + 1 + dx;
      // the output chose this pixel when its source offset is (-dy, -dx)
      if (code[o] == (unsigned char)((1 - dy) * 3 + 1 - dx)) acc += sg[o];
    }
    out[ch] = acc;
  }
}

inline dim3 grid(int N, int H, int W) {
  return dim3((unsigned)((W + kTx - 1) / kTx), (unsigned)((H + kTy - 1) / kTy),
              (unsigned)N);
}

}  // namespace

extern "C" int vwfd_median3_fwd(const void* x, void* y, int N, int H, int W,
                                void* stream) {
  median3_fwd<<<grid(N, H, W), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), H, W);
  return (int)cudaGetLastError();
}

extern "C" int vwfd_median3_bwd(const void* x, const void* g, void* gx, int N,
                                int H, int W, void* stream) {
  median3_bwd<<<grid(N, H, W), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(gx), H, W);
  return (int)cudaGetLastError();
}
