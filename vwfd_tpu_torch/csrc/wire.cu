// K3 `wire`: the serving path's uint8 wire format, fused with its relayouts.
//
// Replaces the uint8 decode/encode of vwfd_tpu/serving.py::_embed_u8 /
// _detect_u8 (:377-398, :400-401) together with the layout moves around them:
// models/video_model.py::_to_channels / _to_frames (:43-52, :146-156), the
// clamp + 8-bit quantize of ops/quantize.py (:12-25) and the detect stem's
// space-to-depth (nets/unet.py:220-223). One thread per output element.
//   (a) u8 (B,T,H,W,3)   -> dtype (B,H,W,3T):   v / 255        (_to_channels)
//   (b) dtype (B,H,W,3T) -> u8 (B,T,H,W,3):     rint(clamp(v, 0, 1) * 255)
//   (c) u8 (N,H,W,3)     -> dtype (N,H/s,W/s,s*s*3): v / 255, channel
//       (p*s + q)*3 + c holds pixel (s*i + p, s*j + q)   (UNetTPU stem)
// (b) rounds half to even (rintf), as jnp.round / torch.round do.
#include "common.cuh"

namespace {

using vwfd::from_f32;
using vwfd::to_f32;

template <typename T>
__global__ void u8_to_channels(const uint8_t* __restrict__ in,
                               T* __restrict__ out, long long total, int Tn,
                               int H, int W) {
  const long long idx = vwfd::global_index();
  if (idx >= total) return;
  const int tc = 3 * Tn;
  const int ch = (int)(idx % tc);
  long long r = idx / tc;
  const int x = (int)(r % W);
  r /= W;
  const int y = (int)(r % H);
  const long long b = r / H;
  const int t = ch / 3, c = ch % 3;
  const uint8_t v = in[(((b * Tn + t) * H + y) * (long long)W + x) * 3 + c];
  out[idx] = from_f32<T>(__fdiv_rn((float)v, 255.f));
}

template <typename T>
__global__ void channels_to_u8(const T* __restrict__ in,
                               uint8_t* __restrict__ out, long long total,
                               int Tn, int H, int W) {
  const long long idx = vwfd::global_index();
  if (idx >= total) return;
  const int c = (int)(idx % 3);
  long long r = idx / 3;
  const int x = (int)(r % W);
  r /= W;
  const int y = (int)(r % H);
  r /= H;
  const int t = (int)(r % Tn);
  const long long b = r / Tn;
  float v = to_f32(in[((b * H + y) * (long long)W + x) * (3 * Tn) + t * 3 + c]);
  v = fminf(fmaxf(v, 0.f), 1.f);
  out[idx] = (uint8_t)rintf(__fmul_rn(v, 255.f));
}

template <typename T>
__global__ void u8_to_s2d(const uint8_t* __restrict__ in, T* __restrict__ out,
                          long long total, int H, int W, int s) {
  const long long idx = vwfd::global_index();
  if (idx >= total) return;
  const int Ho = H / s, Wo = W / s, Co = s * s * 3;
  const int ch = (int)(idx % Co);
  long long r = idx / Co;
  const int j = (int)(r % Wo);
  r /= Wo;
  const int i = (int)(r % Ho);
  const long long n = r / Ho;
  const int c = ch % 3, pq = ch / 3;
  const int p = pq / s, q = pq % s;
  const uint8_t v =
      in[((n * H + (s * i + p)) * (long long)W + (s * j + q)) * 3 + c];
  out[idx] = from_f32<T>(__fdiv_rn((float)v, 255.f));
}

}  // namespace

// (a) in: u8 (B,T,H,W,3); out: (B,H,W,3T)
extern "C" int vwfd_wire_to_channels(const void* in, void* out, int B, int Tn,
                                     int H, int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * H * W * 3 * Tn;
  const uint8_t* src = static_cast<const uint8_t*>(in);
  if (total > 0) {
    if (dtype == vwfd::kBF16)
      u8_to_channels<__nv_bfloat16>
          <<<vwfd::blocks_for(total), vwfd::kThreads, 0, s>>>(
              src, static_cast<__nv_bfloat16*>(out), total, Tn, H, W);
    else
      u8_to_channels<float><<<vwfd::blocks_for(total), vwfd::kThreads, 0, s>>>(
          src, static_cast<float*>(out), total, Tn, H, W);
  }
  return (int)cudaGetLastError();
}

// (b) in: (B,H,W,3T); out: u8 (B,T,H,W,3)
extern "C" int vwfd_wire_to_u8(const void* in, void* out, int B, int Tn, int H,
                               int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * Tn * H * W * 3;
  uint8_t* dst = static_cast<uint8_t*>(out);
  if (total > 0) {
    if (dtype == vwfd::kBF16)
      channels_to_u8<__nv_bfloat16>
          <<<vwfd::blocks_for(total), vwfd::kThreads, 0, s>>>(
              static_cast<const __nv_bfloat16*>(in), dst, total, Tn, H, W);
    else
      channels_to_u8<float><<<vwfd::blocks_for(total), vwfd::kThreads, 0, s>>>(
          static_cast<const float*>(in), dst, total, Tn, H, W);
  }
  return (int)cudaGetLastError();
}

// (c) in: u8 (N,H,W,3); out: (N,H/s,W/s,s*s*3)
extern "C" int vwfd_wire_to_s2d(const void* in, void* out, int N, int H, int W,
                                int sf, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)N * H * W * 3;
  const uint8_t* src = static_cast<const uint8_t*>(in);
  if (total > 0) {
    if (dtype == vwfd::kBF16)
      u8_to_s2d<__nv_bfloat16><<<vwfd::blocks_for(total), vwfd::kThreads, 0, s>>>(
          src, static_cast<__nv_bfloat16*>(out), total, H, W, sf);
    else
      u8_to_s2d<float><<<vwfd::blocks_for(total), vwfd::kThreads, 0, s>>>(
          src, static_cast<float*>(out), total, H, W, sf);
  }
  return (int)cudaGetLastError();
}
