// K7 `f1_sweep`: the confusion counts of a tamper-mask prediction against
// its ground truth at every threshold of the F1 sweep, in one read.
//
// Replaces vwfd_tpu/metrics/metrics.py:96-140 (`mask_confusion`, vmapped
// over the nine thresholds of `f1_sweep`). Per pixel, exactly as written
// there (F8):
//   pl = trunc(p * 255.0f), gl = trunc(g * 255.0f)   (float32 multiplies)
//   on at level t:  pl > t,  gl > t                 (NaN is never on)
// and per level: tp = #(p & g), fp = #(p & !g), fn = #(!p & g). tn is the
// pixel count less the three, which the wrapper takes.
//
// Bound: bytes (pred and gt read once; 33.5 MB at the flagship eval step,
// 64 frames of 256²). Design: a grid-stride loop over 16-byte vectors (four
// pixels of each input) when both bases are 16-byte aligned, then the
// ragged tail one pixel a thread. Each thread keeps, per level, the count
// of p on, of g on and of both, in registers (32-bit: a thread sees far
// fewer than 2^32 pixels); a warp adds them with __reduce_add_sync, the
// warps of a block in shared memory, and one thread per counter adds the
// block's sum to the 64-bit output with one integer atomic. Integer sums are
// exact and do not depend on their order, so the counts repeat exactly.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kBlock = 256;

struct Levels {
  float t[kMaxLevels];
};

struct Counts {
  unsigned int p[kMaxLevels], g[kMaxLevels], pg[kMaxLevels];
};

__device__ __forceinline__ void count(float p, float g, const Levels& lv,
                                      int nl, Counts& c) {
  // __fmul_rn: no contraction into anything else, as the reference
  const float pl = truncf(__fmul_rn(p, 255.f));
  const float gl = truncf(__fmul_rn(g, 255.f));
#pragma unroll
  for (int k = 0; k < kMaxLevels; ++k) {
    if (k >= nl) break;
    const bool pon = pl > lv.t[k], gon = gl > lv.t[k];
    c.p[k] += pon;
    c.g[k] += gon;
    c.pg[k] += pon && gon;
  }
}

__global__ void __launch_bounds__(kBlock)
    f1_sweep_counts(const float* __restrict__ pred,
                    const float* __restrict__ gt, long long n, Levels lv,
                    int nl, int vec, unsigned long long* __restrict__ out) {
  Counts c;
#pragma unroll
  for (int k = 0; k < kMaxLevels; ++k) c.p[k] = c.g[k] = c.pg[k] = 0u;

  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    const float4* p4 = reinterpret_cast<const float4*>(pred);
    const float4* g4 = reinterpret_cast<const float4*>(gt);
    for (long long i = vwfd::global_index(); i < nv; i += stride) {
      const float4 p = __ldg(p4 + i), g = __ldg(g4 + i);
      count(p.x, g.x, lv, nl, c);
      count(p.y, g.y, lv, nl, c);
      count(p.z, g.z, lv, nl, c);
      count(p.w, g.w, lv, nl, c);
    }
    done = nv * 4;
  }
  for (long long i = done + vwfd::global_index(); i < n; i += stride)
    count(__ldg(pred + i), __ldg(gt + i), lv, nl, c);

  __shared__ unsigned int blk[3 * kMaxLevels];
  if (threadIdx.x < 3 * kMaxLevels) blk[threadIdx.x] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kMaxLevels; ++k) {
    if (k >= nl) break;
    const unsigned int sp = __reduce_add_sync(0xffffffffu, c.p[k]);
    const unsigned int sg = __reduce_add_sync(0xffffffffu, c.g[k]);
    const unsigned int spg = __reduce_add_sync(0xffffffffu, c.pg[k]);
    if (lane == 0) {
      atomicAdd(&blk[3 * k + 0], sp);
      atomicAdd(&blk[3 * k + 1], sg);
      atomicAdd(&blk[3 * k + 2], spg);
    }
  }
  __syncthreads();
  if (threadIdx.x < nl) {  // (tp, fp, fn) of level k from (p, g, both)
    const int k = threadIdx.x;
    const unsigned long long both = blk[3 * k + 2];
    atomicAdd(out + 3 * k + 0, both);
    atomicAdd(out + 3 * k + 1, (unsigned long long)blk[3 * k + 0] - both);
    atomicAdd(out + 3 * k + 2, (unsigned long long)blk[3 * k + 1] - both);
  }
}

}  // namespace

// pred, gt: n float32 values each (any shape, contiguous); levels: nl
// (1..16) threshold levels, float32 in host memory; out: int64 (nl, 3) =
// (tp, fp, fn) per level, zero on entry; blocks: the grid size (>= 1).
extern "C" int vwfd_f1_sweep(const void* pred, const void* gt, long long n,
                             const float* levels, int nl, void* out,
                             int blocks, void* stream) {
  if (nl < 1 || nl > kMaxLevels || blocks < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int k = 0; k < kMaxLevels; ++k)
    lv.t[k] = k < nl ? levels[k] : 0.f;
  if (n > 0) {
    const int vec = vwfd::aligned16({pred, gt}) ? 1 : 0;
    f1_sweep_counts<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pred), static_cast<const float*>(gt), n, lv,
        nl, vec, static_cast<unsigned long long*>(out));
  }
  return (int)cudaGetLastError();
}
