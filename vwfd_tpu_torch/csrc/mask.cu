// K4 `mask_pack`: detect epilogue — packed head logits to the bit-packed
// tamper mask and the per-clip tamper fraction, in one launch.
//
// Replaces UNetTPU's d2s head + sigmoid (vwfd_tpu/nets/unet.py:298-309) and
// the serving epilogue of vwfd_tpu/serving.py (:82-88 _pack_mask_bits,
// :157-161 _mask_u8, :414-425 threshold + per-clip mean):
//   p(n, Y, X) = sigmoid(logits[n, Y/s, X/s, (Y%s)*s + X%s])   (f32)
//   packed: out[b, t, Y, xb] = sum_e (p(Y, 8xb+e) > thr) << (7 - e)  (MSB first)
//   u8:     out[b, t, Y, X]  = p > thr ? 255 : 0             (W % 8 != 0)
//   frac[b] = mean over (t, Y, X) of p
// The sigmoid is __frcp_rn(__fadd_rn(1, expf(-z))), so the bits match the
// plain version away from the threshold.
//
// Bound: bytes (logits read once, bits written once). Design, the fast path
// (s = 2, W % 8 == 0, 16-byte aligned logits rows): one warp per logits
// row (n, i), i.e. image rows Y = 2i and 2i+1. Lane j reads logits pixels
// 4j..4j+3 (16 values, 16-byte loads), which hold X = 8j..8j+7 of both
// rows (channels 0,1 -> Y = 2i, channels 2,3 -> Y = 2i+1), and writes one
// byte of each row: the warp's stores are 32 contiguous bytes a row. Each
// warp takes `rpw` consecutive rows of one clip; grid (G, B). Sums go in a
// fixed order: per lane, then a __shfl_xor tree, then the block's warps in
// order; the last block of a clip (integer ticket, no float atomics) adds
// the G block partials in index order, so the mean is deterministic. That
// block also resets its ticket to 0, so the wrapper keeps the ticket and
// partial scratch from call to call and fills nothing. Other shapes take
// the general path: one thread per output byte (mask_pack_bytes).
#include "common.cuh"

namespace {

using vwfd::load_vec;
using vwfd::to_f32;

constexpr int kWarps = 8;  // warps per block on the fast path

__device__ __forceinline__ float sigmoid(float z) {
  return __frcp_rn(__fadd_rn(1.f, expf(-z)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Thread 0 of each block: publishes the block's partial `sum` and takes a
// ticket; the clip's last block adds the G partials in index order, writes
// the clip's mean and resets the ticket. The ticket is an acquire-release
// atomic: its release orders this block's partial before it, its acquire
// makes every earlier block's partial visible to the last one.
__device__ __forceinline__ void finish_clip(float sum, float* partial,
                                            unsigned int* ticket, float* frac,
                                            int G, float count) {
  if (threadIdx.x != 0) return;
  const int b = blockIdx.y;
  float* pb = partial + b * G;
  pb[blockIdx.x] = sum;
  unsigned int taken;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n"
               : "=r"(taken) : "l"(ticket + b) : "memory");
  if (taken != (unsigned int)(G - 1)) return;
  float tot = 0.f;
  for (int g = 0; g < G; ++g) tot += __ldcg(pb + g);
  frac[b] = tot / count;
  ticket[b] = 0u;  // ready for the next call on this stream
}

// Fast path. logits (B*Tn, H/2, W/2, 4); rows_per_clip = Tn*H/2 logits
// rows; out u8 (B, Tn, H, W/8).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    mask_pack_rows(const T* __restrict__ logits, uint8_t* __restrict__ out,
                   float* __restrict__ partial, unsigned int* ticket,
                   float* __restrict__ frac, int rows_per_clip, int W,
                   float thr, int rpw, int G, float count) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Wb = W / 8;  // bytes per image row = pixel quads per logits row
  const int r0 = (blockIdx.x * kWarps + warp) * rpw;
  const int r1 = min(r0 + rpw, rows_per_clip);
  float sum = 0.f;
  for (int r = r0; r < r1; ++r) {
    const int row = blockIdx.y * rows_per_clip + r;  // n * H/2 + i
    const T* src = logits + row * (2 * W);
    uint8_t* dst = out + row * (2 * Wb);  // image rows 2i, 2i+1 of frame n
    for (int j = lane; j < Wb; j += 32) {
      float v[16];  // v[4u + c]: pixel 4j + u, channel c = 2p + q
      load_vec<T, 16>(src + 16 * j, v);
      unsigned int top = 0, bot = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {  // X = 8j + e: pixel e/2, q = e%2
        const float p0 = sigmoid(v[4 * (e >> 1) + (e & 1)]);
        const float p1 = sigmoid(v[4 * (e >> 1) + 2 + (e & 1)]);
        sum += p0;
        sum += p1;
        top = (top << 1) | (p0 > thr ? 1u : 0u);
        bot = (bot << 1) | (p1 > thr ? 1u : 0u);
      }
      dst[j] = (uint8_t)top;
      dst[Wb + j] = (uint8_t)bot;
    }
  }
  __shared__ float warp_part[kWarps];
  sum = warp_sum(sum);
  if (lane == 0) warp_part[warp] = sum;
  __syncthreads();
  float blk = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) blk += warp_part[w];
  finish_clip(blk, partial, ticket, frac, G, count);
}

// General path: one thread per output byte (8 pixels, or 1 in the u8
// mode); G blocks per clip reduce in a fixed tree order.
template <typename T>
__global__ void mask_pack_bytes(const T* __restrict__ logits,
                                uint8_t* __restrict__ out,
                                float* __restrict__ partial,
                                unsigned int* ticket, float* __restrict__ frac,
                                int Tn, int H, int W, int s, float thr,
                                int packed, int G) {
  const int b = blockIdx.y;
  const int ppb = packed ? 8 : 1;  // pixels per output byte
  const int Wb = W / ppb;
  const long long clip_bytes = (long long)Tn * H * Wb;
  const long long per_block = (clip_bytes + G - 1) / G;
  const long long start = blockIdx.x * per_block;
  const long long end = min(start + per_block, clip_bytes);
  const int Hs = H / s, Ws = W / s, S2 = s * s;

  float sum = 0.f;
  for (long long k = start + threadIdx.x; k < end; k += blockDim.x) {
    const int xb = (int)(k % Wb);
    const long long r = k / Wb;
    const int Y = (int)(r % H);
    const long long n = (long long)b * Tn + r / H;
    const T* row = logits + (n * Hs + Y / s) * (long long)Ws * S2 + (Y % s) * s;
    unsigned int byte = 0;
    for (int e = 0; e < ppb; ++e) {
      const int X = xb * ppb + e;
      const float p = sigmoid(to_f32(row[(X / s) * S2 + X % s]));
      sum += p;
      byte = (byte << 1) | (p > thr ? 1u : 0u);
    }
    out[b * clip_bytes + k] = (uint8_t)(packed ? byte : (byte ? 255u : 0u));
  }

  __shared__ float red[vwfd::kThreads];
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int w = vwfd::kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  finish_clip(red[0], partial, ticket, frac, G,
              (float)((long long)Tn * H * W));
}

template <typename T>
void launch(const void* logits, uint8_t* o, float* pt, unsigned int* tk,
            float* fr, int B, int Tn, int H, int W, int s, float thr,
            int packed, int G, int rpw, cudaStream_t st) {
  const T* x = static_cast<const T*>(logits);
  dim3 grid(G, B);
  if (rpw > 0)
    mask_pack_rows<T><<<grid, kWarps * 32, 0, st>>>(
        x, o, pt, tk, fr, Tn * H / 2, W, thr, rpw, G,
        (float)((long long)Tn * H * W));
  else
    mask_pack_bytes<T><<<grid, vwfd::kThreads, 0, st>>>(
        x, o, pt, tk, fr, Tn, H, W, s, thr, packed, G);
}

}  // namespace

// logits: (B*Tn, H/s, W/s, s*s) NHWC; out: u8 (B,Tn,H,W/8) if packed else
// (B,Tn,H,W); partial: f32 (B*G) scratch; ticket: u32 (B), 0 on entry and
// left 0 on exit; frac: f32 (B). rpw > 0 takes the fast path (s = 2,
// packed, 16-byte aligned rows) with rpw logits rows per warp and
// G * kWarps * rpw >= Tn*H/2; rpw == 0 the general path.
extern "C" int vwfd_mask_pack(const void* logits, void* out, void* partial,
                              void* ticket, void* frac, int B, int Tn, int H,
                              int W, int s, float thr, int packed, int G,
                              int rpw, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rpw > 0 && (s != 2 || !packed || W % 8 ||
                  (long long)G * kWarps * rpw < (long long)Tn * H / 2))
    return (int)cudaErrorInvalidValue;
  uint8_t* o = static_cast<uint8_t*>(out);
  float* pt = static_cast<float*>(partial);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  float* fr = static_cast<float*>(frac);
  if (B > 0) {
    if (dtype == vwfd::kBF16)
      launch<__nv_bfloat16>(logits, o, pt, tk, fr, B, Tn, H, W, s, thr,
                            packed, G, rpw, st);
    else
      launch<float>(logits, o, pt, tk, fr, B, Tn, H, W, s, thr, packed, G,
                    rpw, st);
  }
  return (int)cudaGetLastError();
}
