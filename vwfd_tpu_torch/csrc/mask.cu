// K4 `mask_pack`: detect epilogue — packed head logits to the bit-packed
// tamper mask and the per-clip tamper fraction, in one launch.
//
// Replaces UNetTPU's d2s head + sigmoid (vwfd_tpu/nets/unet.py:298-309) and
// the serving epilogue of vwfd_tpu/serving.py (:82-88 _pack_mask_bits,
// :157-161 _mask_u8, :420-425 threshold + per-clip mean):
//   p(n, Y, X) = sigmoid(logits[n, Y/s, X/s, (Y%s)*s + X%s])   (f32)
//   packed: out[b, t, Y, xb] = sum_e (p(Y, 8xb+e) > thr) << (7 - e)  (MSB first)
//   u8:     out[b, t, Y, X]  = p > thr ? 255 : 0             (W % 8 != 0)
//   frac[b] = mean over (t, Y, X) of p
// One thread per output byte. Grid (G, B): G blocks share one clip; each
// block reduces its partial sum in a fixed tree order, and the last block of
// the clip (integer ticket, no float atomics) adds the G partials in index
// order, so the mean is deterministic.
#include "common.cuh"

namespace {

using vwfd::to_f32;

template <typename T>
__global__ void mask_pack(const T* __restrict__ logits, uint8_t* __restrict__ out,
                          float* __restrict__ partial,
                          unsigned int* __restrict__ ticket,
                          float* __restrict__ frac, int Tn, int H, int W, int s,
                          float thr, int packed, int G) {
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
      const float z = to_f32(row[(X / s) * S2 + X % s]);
      const float p = __frcp_rn(__fadd_rn(1.f, expf(-z)));
      sum += p;
      byte = (byte << 1) | (p > thr ? 1u : 0u);
    }
    out[b * clip_bytes + k] = (uint8_t)(packed ? byte : (byte ? 255u : 0u));
  }

  __shared__ float red[vwfd::kThreads];
  __shared__ bool last;
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int w = vwfd::kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partial[(long long)b * G + blockIdx.x] = red[0];
    __threadfence();  // publish the partial before taking a ticket
    last = atomicAdd(&ticket[b], 1u) == (unsigned int)(G - 1);
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const volatile float* pb = partial + (long long)b * G;
    float tot = 0.f;
    for (int g = 0; g < G; ++g) tot += pb[g];
    frac[b] = tot / (float)((long long)Tn * H * W);
  }
}

}  // namespace

// logits: (B*Tn, H/s, W/s, s*s) NHWC; out: u8 (B,Tn,H,W/8) if packed else
// (B,Tn,H,W); partial: f32 (B*G) scratch; ticket: u32 (B) zeroed by the
// caller; frac: f32 (B).
extern "C" int vwfd_mask_pack(const void* logits, void* out, void* partial,
                              void* ticket, void* frac, int B, int Tn, int H,
                              int W, int s, float thr, int packed, int G,
                              int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  float* pt = static_cast<float*>(partial);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  float* fr = static_cast<float*>(frac);
  if (B > 0) {
    dim3 grid(G, B);
    if (dtype == vwfd::kBF16)
      mask_pack<__nv_bfloat16><<<grid, vwfd::kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(logits), o, pt, tk, fr, Tn, H, W,
          s, thr, packed, G);
    else
      mask_pack<float><<<grid, vwfd::kThreads, 0, st>>>(
          static_cast<const float*>(logits), o, pt, tk, fr, Tn, H, W, s, thr,
          packed, G);
  }
  return (int)cudaGetLastError();
}
