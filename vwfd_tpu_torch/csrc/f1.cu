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
// 64 frames of 256²). Design:
// - The level count is a template parameter: 9 (`f1_sweep`'s thresholds)
//   and 16, the generic path for any other count, its unused levels +inf
//   (never exceeded, so they count nothing). The compares and counts unroll
//   with no runtime bound.
// - One CTA an SM, one wave: 768 threads (512 at 16 levels, whose 48
//   counters need more registers). Each thread keeps 4 (2 at 16 levels)
//   16-byte loads of each input in flight before it counts (both bases
//   16-byte aligned; else one value at a time), then the ragged tail.
// - Per level a thread counts p on, g on and both in 32-bit registers; a warp
//   adds them with __reduce_add_sync, the warps of a block in shared memory
//   in order, and the block writes its 3L sums to a partial (64-bit). The
//   last block (an integer ticket) adds the partials, one warp a counter,
//   and writes (tp, fp, fn) to the output itself: no memset, no atomics on
//   the counts. Integer sums are exact and do not depend on their order, so
//   the counts repeat exactly. The last block resets the ticket.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 16;

// threads of the CTA (one an SM; kernels/f1.py _block) and 16-byte loads of
// each input in flight a thread, by level count
template <int L>
struct Shape {
  static constexpr int kBlock = L > 9 ? 512 : 768;
  static constexpr int kU = L > 9 ? 2 : 4;
};

struct Levels {
  float t[kMaxLevels];
};

template <int L>
struct Counts {
  unsigned int p[L], g[L], pg[L];
};

template <int L>
__device__ __forceinline__ void count(float p, float g, const Levels& lv,
                                      Counts<L>& c) {
  // __fmul_rn: no contraction into anything else, as the reference
  const float pl = truncf(__fmul_rn(p, 255.f));
  const float gl = truncf(__fmul_rn(g, 255.f));
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const bool pon = pl > lv.t[k], gon = gl > lv.t[k];
    c.p[k] += pon;
    c.g[k] += gon;
    c.pg[k] += pon && gon;
  }
}

template <int L>
__device__ __forceinline__ void count4(const float4& p, const float4& g,
                                       const Levels& lv, Counts<L>& c) {
  count<L>(p.x, g.x, lv, c);
  count<L>(p.y, g.y, lv, c);
  count<L>(p.z, g.z, lv, c);
  count<L>(p.w, g.w, lv, c);
}

// partial: u64 [3L][gridDim.x] (p, g, both of each level); out: int64
// (nl, 3) = (tp, fp, fn) of the first nl levels.
template <int L>
__global__ void __launch_bounds__(Shape<L>::kBlock, 1)
    f1_sweep_counts(const float* __restrict__ pred,
                    const float* __restrict__ gt, long long n,
                    const __grid_constant__ Levels lv, int nl, int vec,
                    unsigned long long* __restrict__ partial,
                    unsigned int* ticket, long long* __restrict__ out) {
  constexpr int kU = Shape<L>::kU;
  Counts<L> c;
#pragma unroll
  for (int k = 0; k < L; ++k) c.p[k] = c.g[k] = c.pg[k] = 0u;

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = vwfd::global_index();
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    const float4* p4 = reinterpret_cast<const float4*>(pred);
    const float4* g4 = reinterpret_cast<const float4*>(gt);
    long long i = tid;
    for (; i + (kU - 1) * stride < nv; i += kU * stride) {
      float4 p[kU], g[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        p[u] = __ldg(p4 + i + u * stride);
        g[u] = __ldg(g4 + i + u * stride);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) count4<L>(p[u], g[u], lv, c);
    }
    for (; i < nv; i += stride) count4<L>(__ldg(p4 + i), __ldg(g4 + i), lv, c);
    done = nv * 4;
  }
  for (long long i = done + tid; i < n; i += stride)
    count<L>(__ldg(pred + i), __ldg(gt + i), lv, c);

  // the block's sums: warps by __reduce_add_sync, then in warp order
  constexpr int kWarps = Shape<L>::kBlock / 32;
  __shared__ unsigned int warp_c[kWarps][3 * L];
  __shared__ unsigned long long tot[3 * L];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const unsigned int sp = __reduce_add_sync(0xffffffffu, c.p[k]);
    const unsigned int sg = __reduce_add_sync(0xffffffffu, c.g[k]);
    const unsigned int spg = __reduce_add_sync(0xffffffffu, c.pg[k]);
    if (lane == 0) {
      warp_c[w][3 * k + 0] = sp;
      warp_c[w][3 * k + 1] = sg;
      warp_c[w][3 * k + 2] = spg;
    }
  }
  __syncthreads();
  const int B = gridDim.x;
  if (threadIdx.x < 3 * L) {
    unsigned long long s = 0;
    for (int v = 0; v < kWarps; ++v) s += warp_c[v][threadIdx.x];
    partial[(long long)threadIdx.x * B + blockIdx.x] = s;
    __threadfence();  // the partial before the ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == (unsigned int)B - 1;
  __syncthreads();
  if (!last) return;

  // the last block: counter j's partials summed by warp j (mod kWarps)
  for (int j = w; j < 3 * L; j += kWarps) {
    unsigned long long s = 0;
    for (int b = lane; b < B; b += 32)
      s += __ldcg(partial + (long long)j * B + b);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) tot[j] = s;
  }
  __syncthreads();
  if (threadIdx.x < nl) {  // (tp, fp, fn) of level k from (p, g, both)
    const int k = threadIdx.x;
    const unsigned long long both = tot[3 * k + 2];
    out[3 * k + 0] = (long long)both;
    out[3 * k + 1] = (long long)(tot[3 * k + 0] - both);
    out[3 * k + 2] = (long long)(tot[3 * k + 1] - both);
  }
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next call
}

template <int L>
void launch(const void* pred, const void* gt, long long n, const Levels& lv,
            int nl, int vec, int blocks, void* partial, void* ticket,
            void* out, cudaStream_t s) {
  f1_sweep_counts<L><<<blocks, Shape<L>::kBlock, 0, s>>>(
      static_cast<const float*>(pred), static_cast<const float*>(gt), n, lv,
      nl, vec, static_cast<unsigned long long*>(partial),
      static_cast<unsigned int*>(ticket), static_cast<long long*>(out));
}

}  // namespace

// pred, gt: n float32 values each (any shape, contiguous); levels: nl
// (1..16) threshold levels, float32 in host memory; variant: the levels the
// kernel is compiled for (9 when nl == 9, else 16); blocks:
// the grid size (>= 1); partial: u64 (3 · variant · blocks) and ticket: u32,
// scratch, the ticket 0 on entry and left 0; out: int64 (nl, 3) = (tp, fp,
// fn) per level, written whole.
extern "C" int vwfd_f1_sweep(const void* pred, const void* gt, long long n,
                             const float* levels, int nl, int variant,
                             int blocks, void* partial, void* ticket,
                             void* out, void* stream) {
  const bool fits = variant == kMaxLevels ? nl >= 1 && nl <= kMaxLevels
                                          : variant == 9 && nl == 9;
  if (!fits || blocks < 1 || n < 0) return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int k = 0; k < kMaxLevels; ++k) lv.t[k] = k < nl ? levels[k] : INFINITY;
  const int vec = vwfd::aligned16({pred, gt}) ? 1 : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 9)
    launch<9>(pred, gt, n, lv, nl, vec, blocks, partial, ticket, out, s);
  else
    launch<kMaxLevels>(pred, gt, n, lv, nl, vec, blocks, partial, ticket, out,
                       s);
  return (int)cudaGetLastError();
}
