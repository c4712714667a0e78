// K8 `ssim`: windowed SSIM of two NHWC RGB batches, reduced to the mean of
// each image and the mean of all, in one launch.
//
// Replaces vwfd_tpu/metrics/metrics.py:41-79 (`_ssim_window`,
// `_depthwise_same_conv` five times, the SSIM map and its mean): with the
// 11x11 gaussian window (sigma 1.5) and zero padding,
//   mu1, mu2, E[x1^2], E[x2^2], E[x1 x2] = window sums around each value
//   map = ((2 mu1 mu2 + c1)(2 s12 + c2))
//         / ((mu1^2 + mu2^2 + c1)(s1 + s2 + c2))
// with s1 = E[x1^2] - mu1^2, s2 = E[x2^2] - mu2^2, s12 = E[x1 x2] - mu1 mu2,
// c1 = 0.01^2, c2 = 0.03^2, per channel; then the mean of the map per image
// and over the batch.
//
// Bound: operations (at the flagship eval step, 64 frames of 256²x3 f32:
// about 243 f32 flops a value, 3.1 GFLOP, 0.046 ms at 67 TFLOP/s, against
// 0.030 ms for the 100.7 MB of the two inputs). Design: the window is
// separable (outer product of the 1-D gaussian), so each of the five sums is
// an 11-tap horizontal pass followed by an 11-tap vertical pass, 22
// multiply-adds a sum instead of 121. A CTA takes a 32x32 tile of one image,
// all three channels: it stages both inputs' tile plus a 5-pixel zero halo
// in shared memory (each row of the span as 32 16-byte loads when W % 4 == 0
// and the bases are 16-byte aligned, else one value a thread). A thread owns
// one column of one channel and 16 output rows: it walks the 26 staged rows
// once, keeps the last 11 rows' horizontal sums (5 each) in registers, and
// takes the vertical sums from them as soon as a window is complete. The
// map is summed per thread in double, then per warp and per block; each
// block writes its sum to a partial, and the last block (an integer
// ticket, no float atomics) adds the partials of each image in tile order
// and the images in order, so the means repeat bit for bit. That block also
// resets the ticket, so the wrapper keeps the scratch from call to call.
#include "common.cuh"

namespace {

constexpr int kWin = 11;
constexpr int kHalo = kWin / 2;
constexpr int kC = 3;                        // channels (RGB)
constexpr int kTile = 32;                    // output tile: kTile x kTile
constexpr int kSpan = kTile + 2 * kHalo;     // staged rows and columns
constexpr int kRows = 16;                    // output rows a thread takes
constexpr int kBlock = kTile * kC * (kTile / kRows);
constexpr int kRowVecs = 32;  // 16-byte vectors covering a staged row's span

struct Taps {
  float g[kWin];
};

__device__ __forceinline__ float ssim_value(const float* m) {
  constexpr float c1 = (float)(0.01 * 0.01), c2 = (float)(0.03 * 0.03);
  const float mu1 = m[0], mu2 = m[1];
  const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu12 = mu1 * mu2;
  const float s1 = m[2] - mu1_sq, s2 = m[3] - mu2_sq, s12 = m[4] - mu12;
  const float num = (2.f * mu12 + c1) * (2.f * s12 + c2);
  const float den = (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2);
  return __fdiv_rn(num, den);
}

// grid (ceil(W/kTile), ceil(H/kTile), N); x, y: (N, H, W, 3) float32.
__global__ void __launch_bounds__(kBlock, 3)
    ssim_tiles(const float* __restrict__ x, const float* __restrict__ y,
               int H, int W, Taps taps, int vec, double* __restrict__ partial,
               double* __restrict__ img_sum, unsigned int* ticket,
               float* __restrict__ means, float* __restrict__ mean) {
  __shared__ float s[2][kC][kSpan][kSpan];
  __shared__ double warp_sum[kBlock / 32];
  __shared__ bool last;
  const int n = blockIdx.z, x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const long long row_elems = (long long)kC * W;
  const long long img0 = (long long)n * H;

  // staged value (img, c, r, col) = input img at (y0 - 5 + r, x0 - 5 + col, c)
  if (vec) {
    // a row's span is elements [3·x0 - 15, 3·x0 + 111) of the image row;
    // the vectors cover [3·x0 - 16, 3·x0 + 112), 16-byte aligned, each wholly
    // inside or outside the row (3W % 4 == 0)
    for (int i = threadIdx.x; i < 2 * kSpan * kRowVecs; i += kBlock) {
      const int img = i / (kSpan * kRowVecs);
      const int r = (i / kRowVecs) % kSpan, v = i % kRowVecs;
      const int gy = y0 - kHalo + r;
      const long long e = (long long)kC * x0 - 16 + 4 * v;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H && e >= 0 && e < row_elems)
        q = __ldg(reinterpret_cast<const float4*>(
            (img ? y : x) + (img0 + gy) * row_elems + e));
      const float vals[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int le = 4 * v + k - 1;  // element of the span
        if (le >= 0 && le < kSpan * kC) s[img][le % kC][r][le / kC] = vals[k];
      }
    }
  } else {
    for (int i = threadIdx.x; i < 2 * kSpan * kSpan * kC; i += kBlock) {
      const int img = i / (kSpan * kSpan * kC);
      const int r = (i / (kSpan * kC)) % kSpan, le = i % (kSpan * kC);
      const int gy = y0 - kHalo + r, gx = x0 - kHalo + le / kC;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __ldg((img ? y : x) + (img0 + gy) * row_elems +
                  (long long)gx * kC + le % kC);
      s[img][le % kC][r][le / kC] = v;
    }
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int j = t % kTile, c = (t / kTile) % kC;
  const int r0 = (t / (kTile * kC)) * kRows;  // first output row
  const bool col_in = x0 + j < W;
  float ring[kWin][5];  // horizontal sums of the last kWin staged rows
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < kRows + 2 * kHalo; ++i) {
    const float* ax = &s[0][c][r0 + i][j];
    const float* ay = &s[1][c][r0 + i][j];
    float h[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      const float a = ax[k], b = ay[k];
      const float ga = taps.g[k] * a, gb = taps.g[k] * b;
      h[0] += ga;
      h[1] += gb;
      h[2] = fmaf(ga, a, h[2]);
      h[3] = fmaf(gb, b, h[3]);
      h[4] = fmaf(ga, b, h[4]);
    }
#pragma unroll
    for (int q = 0; q < 5; ++q) ring[i % kWin][q] = h[q];
    if (i >= 2 * kHalo) {  // the window of output row r0 + o is complete
      const int o = i - 2 * kHalo;
      float m[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kWin; ++k)
#pragma unroll
        for (int q = 0; q < 5; ++q)
          m[q] = fmaf(taps.g[k], ring[(o + k) % kWin][q], m[q]);
      const float val = ssim_value(m);
      if (col_in && y0 + r0 + o < H) acc += (double)val;
    }
  }

  // the block's sum: warps in a __shfl_xor tree, then in warp order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((t & 31) == 0) warp_sum[t >> 5] = acc;
  __syncthreads();
  const int tiles = gridDim.x * gridDim.y;
  if (t == 0) {
    double sum = 0.0;
    for (int w = 0; w < kBlock / 32; ++w) sum += warp_sum[w];
    partial[(long long)n * tiles + blockIdx.y * gridDim.x + blockIdx.x] = sum;
    __threadfence();  // the partial before the ticket
    const unsigned int total = (unsigned int)tiles * gridDim.z;
    last = atomicAdd(ticket, 1u) == total - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: each image's partials in tile order, then the images
  const int N = gridDim.z;
  const double per_image = (double)H * W * kC;
  for (int im = t; im < N; im += kBlock) {
    double sum = 0.0;
    for (int k = 0; k < tiles; ++k)
      sum += __ldcg(partial + (long long)im * tiles + k);
    img_sum[im] = sum;
    means[im] = (float)(sum / per_image);
  }
  __threadfence();
  __syncthreads();
  if (t == 0) {
    double tot = 0.0;
    for (int im = 0; im < N; ++im) tot += __ldcg(img_sum + im);
    *mean = (float)(tot / (per_image * N));
    *ticket = 0u;  // ready for the next call on this stream
  }
}

}  // namespace

// x, y: (N, H, W, 3) float32, contiguous; taps: the 11 float32 weights of
// the 1-D window, in host memory; partial: double (N * ceil(H/32) *
// ceil(W/32)) and img_sum: double (N), scratch; ticket: u32, 0 on entry and
// left 0; means: float32 (N); mean: float32 (1).
extern "C" int vwfd_ssim(const void* x, const void* y, int N, int H, int W,
                         const float* taps, void* partial, void* img_sum,
                         void* ticket, void* means, void* mean,
                         void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  Taps tp;
  for (int k = 0; k < kWin; ++k) tp.g[k] = taps[k];
  const int vec = (W % 4 == 0 && vwfd::aligned16({x, y})) ? 1 : 0;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, N);
  ssim_tiles<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), H, W, tp,
      vec, static_cast<double*>(partial), static_cast<double*>(img_sum),
      static_cast<unsigned int*>(ticket), static_cast<float*>(means),
      static_cast<float*>(mean));
  return (int)cudaGetLastError();
}
