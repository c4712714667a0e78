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
// about 243 f32 flops a value for the five sums, 3.1 GFLOP, 0.046 ms at
// 67 TFLOP/s, against 0.030 ms for the 100.7 MB of the two inputs).
//
// Design. The map needs s1 + s2 only as a sum, so four window sums do:
// mu1, mu2, E[x1^2 + x2^2] and E[x1 x2] (88 multiply-adds a value, not
// 110). The window is separable, so each sum is an 11-tap vertical pass and
// then an 11-tap horizontal pass, each done once per value:
// - A CTA of 224 threads walks a strip of 64 columns (all three channels)
//   down `rows` output rows, 14 rows a chunk. Thread t owns interleaved
//   element t of the strip's 222-element span (64 pixels + a 5-pixel halo on
//   each side, x 3 channels), keeps the four products of the last 10 staged
//   rows in registers and forms the four vertical sums of each output row
//   from them (44 FMA), writing them to shared memory. The raw rows of the
//   next chunk arrive meanwhile by cp.async, zero-filled off the image: as
//   16-byte copies shared by the block when W % 4 == 0 and both bases are
//   16-byte aligned (the flagship), else one 4-byte copy a thread, so any
//   shape runs and the staging overlaps the horizontal pass.
// - Then each thread takes one output row of the chunk and 4 adjacent
//   pixels (12 interleaved outputs, stride-3 taps): it reads the 44 staged
//   vertical sums of each quantity it needs as 11 float4 (conflict-free),
//   issues 4 x 11 x 12 FMAs and forms 12 map values, the division as a
//   reciprocal multiply (__fdividef; NaN stays NaN).
// The halo costs 74/64 of the vertical pass and (rows + 10)/rows of its
// rows; nothing else is recomputed. A thread adds its group's 12 map values
// in a fixed float tree (at most 11 roundings of a sum of values in
// [-1, 1]: far below the 1e-5 tolerance on the means) and those sums in
// double, then per warp and per block in double; each block writes its sum
// to a partial, and the last block (an integer ticket, no float atomics)
// adds the partials of each image in strip order and the images in order,
// so the means repeat bit for bit. That block also resets the ticket, so
// the wrapper keeps the scratch from call to call.
#include "common.cuh"

namespace {

constexpr int kWin = 11;
constexpr int kHalo = kWin / 2;
constexpr int kC = 3;                             // channels (RGB)
constexpr int kTW = 64;                           // output columns of a CTA
constexpr int kSpan = kC * (kTW + 2 * kHalo);     // staged elements a row
constexpr int kStride = 224;                      // a staged row in smem
constexpr int kBlock = 224;                       // a thread per element
constexpr int kCtasPerSm = 2;                     // ssim.py _CTAS_PER_SM
constexpr int kRC = 14;                           // output rows of a chunk
constexpr int kGroups = kTW / 4;                  // 4-pixel groups of a row
constexpr int kQ = 4;                             // mu1, mu2, E[x²+y²], E[xy]
constexpr int kOut = 4 * kC;                      // outputs of a group
constexpr int kLoad = kOut + kC * (kWin - 1) + 2; // 44: whole float4s
constexpr int kVecs = kStride / 4;                // 16-byte copies a row
constexpr int kCopies = 2 * kRC * kVecs / kBlock;  // of them a thread
constexpr int kSmemFloats = (kQ + 2) * kRC * kStride;
static_assert(kRC * kGroups == kBlock, "one group per thread and chunk");
static_assert(kSpan <= kBlock && kBlock <= kStride, "a thread per element");
static_assert(kSpan + 2 <= kStride, "span elements -1 .. kSpan in a row");
static_assert(kBlock % kVecs == 0 && kCopies * kBlock == 2 * kRC * kVecs,
              "whole rows of copies a pass");
static_assert(kStride % 4 == 0 && kLoad % 4 == 0, "float4 rows");
static_assert(kOut * (kGroups - 1) + kLoad <= kStride, "loads in the row");

struct Taps {
  float g[kWin];
};

__device__ __forceinline__ float ssim_value(float mu1, float mu2, float sq,
                                            float xy) {
  constexpr float c1 = (float)(0.01 * 0.01), c2 = (float)(0.03 * 0.03);
  const float mu12 = mu1 * mu2;
  const float msq = fmaf(mu1, mu1, mu2 * mu2);
  const float num = fmaf(2.f, mu12, c1) * fmaf(2.f, xy - mu12, c2);
  const float den = (msq + c1) * ((sq - msq) + c2);
  return __fdividef(num, den);
}

// 4 or 16 bytes global -> shared, asynchronous; zeros when !ok (the
// source is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   vwfd::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   vwfd::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// grid (ceil(W/kTW), splits, N); CTA (x, s, n) takes columns
// [kTW·x, kTW·x + kTW) and rows [rows·s, rows·s + rows) of image n.
// x, y: (N, H, W, 3) float32; vec: W % 4 == 0 and both bases 16-byte
// aligned (the rows are staged as 16-byte copies).
__global__ void __launch_bounds__(kBlock, kCtasPerSm)
    ssim_strips(const float* __restrict__ x, const float* __restrict__ y,
                int H, int W, int rows, int vec,
                const __grid_constant__ Taps taps,
                double* __restrict__ partial, double* __restrict__ img_sum,
                unsigned int* ticket, float* __restrict__ means,
                float* __restrict__ mean) {
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);  // [kQ][kRC][kStride]
  // [2][kRC][kStride]: x, y; span element t at slot t + 1
  float* raw = vs + kQ * kRC * kStride;
  __shared__ double warp_sum[kBlock / 32];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int n = blockIdx.z, x0 = blockIdx.x * kTW, y0 = blockIdx.y * rows;
  const int y1 = min(H, y0 + rows);
  const long long row_elems = (long long)kC * W;
  const float* xi = x + (long long)n * H * row_elems;
  const float* yi = y + (long long)n * H * row_elems;
  // this thread's element of an image row (pixel x0 - 5 + t/3, channel t%3)
  const long long e = (long long)kC * (x0 - kHalo) + t;
  const bool col_in = t < kSpan && e >= 0 && e < row_elems;
  // its raw slot (threads past the span read one they do not use)
  const int slot = min(t, kSpan) + 1;

  // the products of staged rows y0-5 .. y0+4: the window above row y0
  float win[kQ][kWin - 1];
#pragma unroll
  for (int k = 0; k < kWin - 1; ++k) {
    const int gy = y0 - kHalo + k;
    float a = 0.f, b = 0.f;
    if (col_in && gy >= 0 && gy < H) {
      a = __ldg(xi + gy * row_elems + e);
      b = __ldg(yi + gy * row_elems + e);
    }
    win[0][k] = a;
    win[1][k] = b;
    win[2][k] = fmaf(b, b, a * a);
    win[3][k] = a * b;
  }
  // raw rows r0 + 5 .. r0 + 5 + kRC - 1 of the span: as kVecs 16-byte
  // copies a row from element 3·x0 - 16 (slot 0), each wholly inside or
  // outside the row, shared by the block (thread t copies vector t % kVecs
  // of staged rows t / kVecs + 4k); else one element a thread
  const int vj = t % kVecs, vr = t / kVecs;
  const long long el = (long long)kC * x0 - 16 + 4 * vj;
  const bool el_in = el >= 0 && el < row_elems;
  auto stage = [&](int r0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < kCopies; ++k) {
        const int rr = vr + k * (kBlock / kVecs);  // x rows, then y rows
        const int gy = r0 + kHalo + (rr < kRC ? rr : rr - kRC);
        const bool ok = el_in && gy < H;
        const float* src = rr < kRC ? xi : yi;
        cp_async16(raw + rr * kStride + 4 * vj,
                   src + (ok ? gy * row_elems + el : 0), ok);
      }
    } else if (t < kSpan) {
#pragma unroll
      for (int i = 0; i < kRC; ++i) {
        const int gy = r0 + kHalo + i;
        const bool ok = col_in && gy < H;
        const long long off = ok ? gy * row_elems + e : 0;
        cp_async4(raw + i * kStride + t + 1, xi + off, ok);
        cp_async4(raw + (kRC + i) * kStride + t + 1, yi + off, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(y0);

  const int row = t / kGroups, grp = t % kGroups;  // the horizontal task
  const int px = x0 + 4 * grp;                     // its first pixel
  const int valid = min(kOut, kC * (W - px));      // its outputs in the frame
  double acc = 0.0;
  for (int r0 = y0; r0 < y1; r0 += kRC) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // raw staged; the last chunk's vs read
    // vertical sums of output rows r0 .. r0 + kRC - 1 at element t
#pragma unroll
    for (int i = 0; i < kRC; ++i) {
      const float a = raw[i * kStride + slot];
      const float b = raw[(kRC + i) * kStride + slot];
      const float cur[kQ] = {a, b, fmaf(b, b, a * a), a * b};
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        float m = taps.g[0] * win[q][0];
#pragma unroll
        for (int k = 1; k < kWin - 1; ++k) m = fmaf(taps.g[k], win[q][k], m);
        m = fmaf(taps.g[kWin - 1], cur[q], m);
        vs[(q * kRC + i) * kStride + t] = m;
#pragma unroll
        for (int k = 0; k < kWin - 2; ++k) win[q][k] = win[q][k + 1];
        win[q][kWin - 2] = cur[q];
      }
    }
    __syncthreads();  // vs written; raw read
    if (r0 + kRC < y1) stage(r0 + kRC);

    // horizontal sums and the map of row r0 + row, pixels px .. px + 3
    if (r0 + row < y1) {
      float m[kQ][kOut];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4* src = reinterpret_cast<const float4*>(
            vs + (q * kRC + row) * kStride + kOut * grp);
        float v[kLoad];
#pragma unroll
        for (int j = 0; j < kLoad / 4; ++j) {
          const float4 f = src[j];
          v[4 * j + 0] = f.x;
          v[4 * j + 1] = f.y;
          v[4 * j + 2] = f.z;
          v[4 * j + 3] = f.w;
        }
#pragma unroll
        for (int o = 0; o < kOut; ++o) m[q][o] = taps.g[0] * v[o];
#pragma unroll
        for (int k = 1; k < kWin; ++k)
#pragma unroll
          for (int o = 0; o < kOut; ++o)
            m[q][o] = fmaf(taps.g[k], v[o + kC * k], m[q][o]);
      }
      // the group's map values in a fixed float tree (at most 11 roundings
      // of a sum of 12 values in [-1, 1]), the groups' sums in double
      float val[kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o)
        val[o] = o < valid
                     ? ssim_value(m[0][o], m[1][o], m[2][o], m[3][o])
                     : 0.f;
#pragma unroll
      for (int w = 1; w < kOut; w *= 2)
#pragma unroll
        for (int o = 0; o + w < kOut; o += 2 * w) val[o] += val[o + w];
      acc += (double)val[0];
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

  // the last block: each image's partials in strip order, then the images
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

// x, y: (N, H, W, 3) float32, contiguous; splits, rows: the row split of
// each image (rows a multiple of 14, splits·rows >= H > (splits-1)·rows);
// taps: the 11 float32 weights of the 1-D window, in host memory; partial:
// double (N · splits · ceil(W/64)) and img_sum: double (N), scratch;
// ticket: u32, 0 on entry and left 0; means: float32 (N); mean: float32 (1).
extern "C" int vwfd_ssim(const void* x, const void* y, int N, int H, int W,
                         int splits, int rows, const float* taps,
                         void* partial, void* img_sum, void* ticket,
                         void* means, void* mean, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || splits < 1 || splits > 65535 ||
      rows < kRC || rows % kRC || (long long)splits * rows < H ||
      (long long)(splits - 1) * rows >= H)
    return (int)cudaErrorInvalidValue;
  const cudaError_t rc = cudaFuncSetAttribute(
      ssim_strips, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemFloats * (int)sizeof(float));
  if (rc != cudaSuccess) return (int)rc;
  Taps tp;
  for (int k = 0; k < kWin; ++k) tp.g[k] = taps[k];
  const int vec = (W % 4 == 0 && vwfd::aligned16({x, y})) ? 1 : 0;
  dim3 grid((W + kTW - 1) / kTW, splits, N);
  ssim_strips<<<grid, kBlock, kSmemFloats * sizeof(float),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), H, W, rows,
      vec, tp, static_cast<double*>(partial), static_cast<double*>(img_sum),
      static_cast<unsigned int*>(ticket), static_cast<float*>(means),
      static_cast<float*>(mean));
  return (int)cudaGetLastError();
}
