// K3 `wire`: the serving path's uint8 wire format, fused with its relayouts.
//
// Replaces the uint8 decode/encode of vwfd_tpu/serving.py::_embed_u8 /
// _detect_u8 (:377-401) together with the layout moves around them:
// models/video_model.py::_to_channels / _to_frames (:43-52, :146-156), the
// clamp + 8-bit quantize of ops/quantize.py (:12-25), the detect stem's
// space-to-depth (nets/unet.py:220-223), and for (d) the roundtrip's
// embed -> detect hand-over (serving.py:427-434):
//   (a) u8 (B,T,H,W,3)   -> dtype (B,H,W,3T):   v / 255        (_to_channels)
//   (b) dtype (B,H,W,3T) -> u8 (B,T,H,W,3):     rint(clamp(v, 0, 1) * 255)
//   (c) u8 (N,H,W,3)     -> dtype (N,H/s,W/s,s*s*3): v / 255, channel
//       (p*s + q)*3 + c holds pixel (s*i + p, s*j + q)   (UNetTPU stem)
//   (d) (b) and (c) of its output in one pass: the u8 clip AND the detect
//       stem's input (B*T,H/s,W/s,3s^2), decoded from the same bytes q, so
//       detect(watermarked) sees exactly the wire's bytes.
// (b) rounds half to even (rintf), as jnp.round / torch.round do; the
// division by 255 is the IEEE __fdiv_rn, as the plain version's tensor
// division, so every output is bit-equal to the plain version.
// (c) and (d) also write the int8 detect stem (dtype kI8) of the int8
// extractor (vwfd_tpu/serving.py:401 + nets/unet_int8.py:244-245): level
// clip(rint(f32(v / 255) * 127), 0, 127), the quotient in float32 as the
// JAX int8 detect feeds apply_int8 a float32 clip.
//
// Bound: bytes (a few operations per element). Design, the tiled path: one
// block per output row (or per s input rows for (d)). The block stages the
// uint8 side of its rows in shared memory, whole image rows at a time (every
// row is a multiple of 16 bytes), with Hopper's 1-D bulk copies
// (cp.async.bulk; loads complete on an mbarrier), which measured faster
// than 16-byte loads and stores by every thread. It walks the dtype side in
// 16-byte vectors. The per-element layout map is one table of
// source offsets per output channel (`koff`), filled once per block, so no
// integer division is left per element and all indices are 32-bit (the
// wrapper refuses 2^31 elements). The decode reads v/255 from a 256-entry
// table of __fdiv_rn quotients that each block fills once: a division per
// element left the decoding maps bound by arithmetic (PERF.md §6). Each
// launch opts in to the dynamic shared memory it asks for, which the static
// tables do not count against. kernels/wire.py::tiled alone picks the path:
// shapes whose rows are no multiple of 16 bytes, or do not fit the shared
// memory, take the general path, one thread per output element
// (u8_to_channels ...). The entry points check only what the tiled kernels
// need to run safely (see tileable).
#include <type_traits>

#include "common.cuh"

namespace {

using vwfd::from_f32;
using vwfd::load_vec;
using vwfd::store_vec;
using vwfd::to_f32;

// ------------------------------------------------------------ tiled path

constexpr int kRowThreads = 128;
constexpr int kMaxK = 64;    // channels of one pixel on the dtype side
constexpr int kRowPad = 16;  // bytes between staged rows (bank spread)

__device__ __forceinline__ uint8_t quantize(float v) {
  v = fminf(fmaxf(v, 0.f), 1.f);
  return (uint8_t)rintf(__fmul_rn(v, 255.f));
}

// Source offsets of the K channels of one dtype-side pixel j: channel
// k = (r*m + q)*3 + c reads staged row r, pixel m*j + q, colour c, i.e. the
// staged byte koff[k] + 3*m*j with koff[k] = r*rs + 3*q + c.
__device__ __forceinline__ void fill_koff(int* koff, int K, int m, int rs) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int g = k / 3;
    koff[k] = (g / m) * rs + (g % m) * 3 + k % 3;
  }
}

// What the decode writes for byte v, as a float: v / 255, or for the int8
// stem the level clip(rint((v / 255) * 127), 0, 127).
template <typename T>
__device__ __forceinline__ float decode_value(int v) {
  const float q = __fdiv_rn((float)v, 255.f);
  if constexpr (std::is_same<T, int8_t>::value)
    return fminf(fmaxf(rintf(__fmul_rn(q, 127.f)), 0.f), 127.f);
  return q;
}

// The 256 decoded values the tiled decode reads.
template <typename T>
__device__ __forceinline__ void fill_tab(float* tab) {
  for (int v = threadIdx.x; v < 256; v += blockDim.x)
    tab[v] = decode_value<T>(v);
}

// One dtype row of n = Wo*K elements from staged bytes: element (j, k) =
// tab[byte[koff[k] + m3*j]] = byte / 255. n * sizeof(T) % 16 == 0.
template <typename T>
__device__ __forceinline__ void decode_row(T* __restrict__ out,
                                           const uint8_t* rows,
                                           const int* koff, const float* tab,
                                           int K, int m3, int n) {
  constexpr int V = 16 / sizeof(T);
  for (int e = threadIdx.x * V; e < n; e += blockDim.x * V) {
    int j = e / K, k = e - j * K;
    float f[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      f[u] = tab[rows[koff[k] + m3 * j]];
      if (++k == K) k = 0, ++j;
    }
    store_vec<T, V>(out + e, f);
  }
}

// One dtype row of n = W*K elements to staged bytes: element (x, k) ->
// byte[koff[k] + 3*x] = quantize(v). n * sizeof(T) % 16 == 0.
template <typename T>
__device__ __forceinline__ void encode_row(const T* __restrict__ in,
                                           uint8_t* rows, const int* koff,
                                           int K, int n) {
  constexpr int V = 16 / sizeof(T);
  for (int e = threadIdx.x * V; e < n; e += blockDim.x * V) {
    int x = e / K, k = e - x * K;
    float f[V];
    load_vec<T, V>(in + e, f);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      rows[koff[k] + 3 * x] = quantize(f[u]);
      if (++k == K) k = 0, ++x;
    }
  }
}

// (a) and (c). Block b: one dtype output row of Wo*K elements, from R
// staged u8 rows of rb bytes; image b / per_img, row b % per_img; the
// staged rows start at in + img*img_stride + row*row_step, r_stride apart.
// (a): per_img = H, R = T rows H*W*3 apart, m = 1, K = 3T.
// (c): per_img = H/s, R = s rows W*3 apart, m = s, K = 3s^2.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    wire_decode_rows(const uint8_t* __restrict__ in, T* __restrict__ out,
                     int per_img, int img_stride, int row_step, int r_stride,
                     int R, int rb, int m, int K) {
  extern __shared__ __align__(16) uint8_t rows[];
  __shared__ int koff[kMaxK];
  __shared__ float tab[256];
  __shared__ uint64_t bar;
  const int rs = rb + kRowPad;
  const int b = blockIdx.x, img = b / per_img;
  if (threadIdx.x == 0) {  // stage the rows; the others wait on `bar`
    const uint32_t bb = vwfd::smem_u32(&bar);
    vwfd::mbar_init(bb, 1);
    vwfd::mbar_fence_init();
    vwfd::mbar_expect_tx(bb, R * rb);
    vwfd::bulk_load_rows(
        rows, rs, in + img * img_stride + (b - img * per_img) * row_step, R,
        r_stride, rb, bb);
  }
  fill_koff(koff, K, m, rs);
  fill_tab<T>(tab);
  __syncthreads();
  vwfd::mbar_wait(vwfd::smem_u32(&bar), 0);
  const int n = rb / (3 * m) * K;
  decode_row<T>(out + b * n, rows, koff, tab, K, 3 * m, n);
}

// (b) and, with kS2D, (d). Block (bb, i): the P input rows P*i + p of clip
// bb of (B,H,W,3T) are quantized into staged rows (t, p), written to the u8
// clip (B,T,H,W,3) and, with kS2D (P = s), decoded again into the T stem
// rows (bb*T + t, i) of (B*T,H/s,W/s,3s^2), of type S.
template <typename T, typename S, bool kS2D>
__global__ void __launch_bounds__(kRowThreads)
    wire_encode_rows(const T* __restrict__ in, uint8_t* __restrict__ out,
                     S* __restrict__ s2d, int Tn, int H, int W, int P) {
  extern __shared__ __align__(16) uint8_t rows[];
  __shared__ int koff_q[kMaxK], koff_s[kMaxK];
  __shared__ float tab[kS2D ? 256 : 1];
  const int rb = 3 * W, rs = rb + kRowPad, K = 3 * Tn, Hb = H / P;
  const int bb = blockIdx.x / Hb, i = blockIdx.x - bb * Hb;
  fill_koff(koff_q, K, 1, P * rs);  // staged row t*P + p
  if (kS2D) {
    fill_koff(koff_s, 3 * P * P, P, rs);
    fill_tab<S>(tab);
  }
  __syncthreads();
  for (int p = 0; p < P; ++p)
    encode_row<T>(in + (bb * H + P * i + p) * W * K, rows + p * rs, koff_q, K,
                  W * K);
  vwfd::fence_to_bulk();
  __syncthreads();
  if (threadIdx.x == 0)
    vwfd::bulk_store_rows(out + (bb * Tn * H + P * i) * rb, rows, rs, Tn,
                          H * rb, P, rb, rb);
  if (kS2D) {
    const int n = 3 * W * P;  // (W/s) * 3s^2
    for (int t = 0; t < Tn; ++t)
      decode_row<S>(s2d + ((bb * Tn + t) * Hb + i) * n, rows + t * P * rs,
                    koff_s, tab, 3 * P * P, 3 * P, n);
  }
  if (threadIdx.x == 0) vwfd::bulk_wait_read();
}

template <typename T>
cudaError_t decode(const void* in, void* out, int blocks, int per_img,
                   int img_stride, int row_step, int r_stride, int R, int rb,
                   int m, int K, cudaStream_t s) {
  const int smem = R * (rb + kRowPad);
  const cudaError_t e = cudaFuncSetAttribute(
      wire_decode_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  wire_decode_rows<T><<<blocks, kRowThreads, smem, s>>>(
      static_cast<const uint8_t*>(in), static_cast<T*>(out), per_img,
      img_stride, row_step, r_stride, R, rb, m, K);
  return cudaGetLastError();
}

template <typename T, typename S, bool kS2D>
cudaError_t encode(const void* in, void* out, void* s2d, int B, int Tn,
                   int H, int W, int P, cudaStream_t s) {
  const int smem = Tn * P * (3 * W + kRowPad);
  const cudaError_t e = cudaFuncSetAttribute(
      wire_encode_rows<T, S, kS2D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  wire_encode_rows<T, S, kS2D><<<B * (H / P), kRowThreads, smem, s>>>(
      static_cast<const T*>(in), static_cast<uint8_t*>(out),
      static_cast<S*>(s2d), Tn, H, W, P);
  return cudaGetLastError();
}

// ---------------------------------------------------------- general path

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
  out[idx] = from_f32<T>(decode_value<T>(v));
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
  out[idx] = quantize(
      to_f32(in[((b * H + y) * (long long)W + x) * (3 * Tn) + t * 3 + c]));
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
  out[idx] = from_f32<T>(decode_value<T>(v));
}

// What the tiled kernels need to run safely: 16-byte aligned tensors, u8
// rows of whole 16-byte words (the bulk copies), and at most kMaxK channels
// a pixel (the offset tables). An oversized shared-memory request is refused
// by the opt-in instead.
bool tileable(const void* a, const void* b, int W, int K) {
  return vwfd::aligned16({a, b}) && (3 * W) % 16 == 0 && K <= kMaxK;
}

}  // namespace

// (a) in: u8 (B,T,H,W,3); out: (B,H,W,3T)
extern "C" int vwfd_wire_to_channels(const void* in, void* out, int B, int Tn,
                                     int H, int W, int dtype, int tiled,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * H * W * 3 * Tn;
  if (total == 0) return (int)cudaGetLastError();
  if (tiled) {
    if (!tileable(in, out, W, 3 * Tn)) return (int)cudaErrorInvalidValue;
    const int rb = 3 * W;
    return (int)(dtype == vwfd::kBF16
                     ? decode<__nv_bfloat16>(in, out, B * H, H, Tn * H * rb,
                                             rb, H * rb, Tn, rb, 1, 3 * Tn, s)
                     : decode<float>(in, out, B * H, H, Tn * H * rb, rb,
                                     H * rb, Tn, rb, 1, 3 * Tn, s));
  }
  const uint8_t* src = static_cast<const uint8_t*>(in);
  if (dtype == vwfd::kBF16)
    u8_to_channels<__nv_bfloat16>
        <<<vwfd::blocks_for(total), vwfd::kThreads, 0, s>>>(
            src, static_cast<__nv_bfloat16*>(out), total, Tn, H, W);
  else
    u8_to_channels<float><<<vwfd::blocks_for(total), vwfd::kThreads, 0, s>>>(
        src, static_cast<float*>(out), total, Tn, H, W);
  return (int)cudaGetLastError();
}

// (b) in: (B,H,W,3T); out: u8 (B,T,H,W,3)
extern "C" int vwfd_wire_to_u8(const void* in, void* out, int B, int Tn, int H,
                               int W, int dtype, int tiled, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * Tn * H * W * 3;
  if (total == 0) return (int)cudaGetLastError();
  if (tiled) {
    if (!tileable(in, out, W, 3 * Tn)) return (int)cudaErrorInvalidValue;
    return (int)(dtype == vwfd::kBF16
                     ? encode<__nv_bfloat16, __nv_bfloat16, false>(
                           in, out, nullptr, B, Tn, H, W, 1, s)
                     : encode<float, float, false>(in, out, nullptr, B, Tn,
                                                   H, W, 1, s));
  }
  uint8_t* dst = static_cast<uint8_t*>(out);
  if (dtype == vwfd::kBF16)
    channels_to_u8<__nv_bfloat16>
        <<<vwfd::blocks_for(total), vwfd::kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(in), dst, total, Tn, H, W);
  else
    channels_to_u8<float><<<vwfd::blocks_for(total), vwfd::kThreads, 0, s>>>(
        static_cast<const float*>(in), dst, total, Tn, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
cudaError_t to_s2d(const void* in, void* out, int N, int H, int W, int sf,
                   int tiled, cudaStream_t s) {
  if (tiled) {
    if (!tileable(in, out, W, 3 * sf * sf)) return cudaErrorInvalidValue;
    const int rb = 3 * W;
    return decode<T>(in, out, N * (H / sf), H / sf, H * rb, sf * rb, rb, sf,
                     rb, sf, 3 * sf * sf, s);
  }
  const long long total = (long long)N * H * W * 3;
  u8_to_s2d<T><<<vwfd::blocks_for(total), vwfd::kThreads, 0, s>>>(
      static_cast<const uint8_t*>(in), static_cast<T*>(out), total, H, W,
      sf);
  return cudaGetLastError();
}

// (c) in: u8 (N,H,W,3); out: (N,H/s,W/s,s*s*3) of dtype f32, bf16 or the
// int8 stem (kI8)
extern "C" int vwfd_wire_to_s2d(const void* in, void* out, int N, int H, int W,
                                int sf, int dtype, int tiled, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)N * H * W == 0) return (int)cudaGetLastError();
  switch (dtype) {
    case vwfd::kBF16:
      return (int)to_s2d<__nv_bfloat16>(in, out, N, H, W, sf, tiled, s);
    case vwfd::kI8:
      return (int)to_s2d<int8_t>(in, out, N, H, W, sf, tiled, s);
    default:
      return (int)to_s2d<float>(in, out, N, H, W, sf, tiled, s);
  }
}

// (d) in: (B,H,W,3T); out: u8 (B,T,H,W,3); s2d: (B*T,H/s,W/s,3s^2), of
// in's dtype. The tiled path only, so no `tiled` flag: for other shapes the
// wrapper runs (b) then (c).
extern "C" int vwfd_wire_to_u8_s2d(const void* in, void* out, void* s2d, int B,
                                   int Tn, int H, int W, int sf, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)B * Tn * H * W == 0) return (int)cudaGetLastError();
  if (!tileable(in, out, W, 3 * (Tn > sf * sf ? Tn : sf * sf)) ||
      !vwfd::aligned16({s2d}) || H % sf || W % sf)
    return (int)cudaErrorInvalidValue;
  return (int)(dtype == vwfd::kBF16
                   ? encode<__nv_bfloat16, __nv_bfloat16, true>(
                         in, out, s2d, B, Tn, H, W, sf, s)
                   : encode<float, float, true>(in, out, s2d, B, Tn, H, W, sf,
                                                s));
}

// (d) with the int8 stem: in: (B,H,W,3T) of dtype; out: u8 (B,T,H,W,3);
// s2d: int8 (B*T,H/s,W/s,3s^2). The tiled path only, as (d).
extern "C" int vwfd_wire_to_u8_s2d_i8(const void* in, void* out, void* s2d,
                                      int B, int Tn, int H, int W, int sf,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)B * Tn * H * W == 0) return (int)cudaGetLastError();
  if (!tileable(in, out, W, 3 * (Tn > sf * sf ? Tn : sf * sf)) ||
      !vwfd::aligned16({s2d}) || H % sf || W % sf)
    return (int)cudaErrorInvalidValue;
  return (int)(dtype == vwfd::kBF16
                   ? encode<__nv_bfloat16, int8_t, true>(in, out, s2d, B, Tn,
                                                         H, W, sf, s)
                   : encode<float, int8_t, true>(in, out, s2d, B, Tn, H, W,
                                                 sf, s));
}
