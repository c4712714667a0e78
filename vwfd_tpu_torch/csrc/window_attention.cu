// K18 window_attention: SUNet's shifted-window attention, forward and
// backward (kernels/window_attention.py has the plain version and the
// design notes).
//
// Per (window, head) problem, with q, k, v (N x D) read from the qkv Dense's
// output in its own layout (BW, N, 3, H, D):
//
//   S = q k^T * scale + B[idx] (+ M),   P = softmax_rows(S),   O = P v
//
// written as (BW, N, H * D). B is the (2 ws - 1)^2 x H relative-position
// table gathered through idx(i, j) = (ri - rj + ws - 1)(2 ws - 1) + ci - cj
// + ws - 1; M, for a shifted block, is -100 where the two tokens lie in
// different regions of the rolled map (3 x 3 regions: rows [0, Hm - ws),
// [Hm - ws, Hm - shift), [Hm - shift, Hm), columns alike), computed here
// from the window's position in its image (windows ordered image, row,
// column). The backward recomputes S and P, then
//
//   dP = dO v^T,  dS = P (dP - rowsum(P dP)),  dV = P^T dO,
//   dQ = scale dS k,  dK = scale dS^T q,  dB[r] = sum of dS over idx = r
//
// and writes dQ, dK, dV in the qkv layout. The table's gradient is summed
// deterministically: each CTA sums its problem's dS into the (2 ws - 1)^2
// bins in a fixed order and writes them to a scratch (H, bins, BW); a
// second kernel reduces each (head, bin) over the windows with a fixed tree.
// No float atomics: two calls give the same bits.
//
// One CTA of 128 threads a problem; q, k, v (and dO) in shared memory, rows
// padded by one float; thread (ty, tx) = (tid / 8, tid % 8) holds rows
// ty + 16 a (a < 4) and columns tx + 8 b of each N x N or N x D product.
// Float32 arithmetic throughout.
#include "common.cuh"

namespace {

constexpr int kThr = 128;
constexpr int kMaxN = 64;      // ws <= 8
constexpr int kMaxBins = 225;  // (2 * 8 - 1)^2
constexpr int kSP = kMaxN + 1;  // padded row of an N x N tile

template <int D>
struct Smem {
  static constexpr int kRow = D + 1;
  static constexpr int kMat = kMaxN * kRow;  // one N x D tile, floats
  static constexpr int kNN = kMaxN * kSP;    // one N x N tile, floats
  // forward: q, k, v, P, bias column, labels
  static constexpr int kFwd = (3 * kMat + kNN + kMaxBins) * 4 + kMaxN * 4;
  // backward: q, k, v, dO, P, dS, bias column, labels
  static constexpr int kBwd = (4 * kMat + 2 * kNN + kMaxBins) * 4 + kMaxN * 4;
};

// q, k, v (s = 0, 1, 2) of problem (bw, h) into shared memory, float4 loads
template <int D>
__device__ __forceinline__ void load_qkv(const float* __restrict__ qkv,
                                         float* dst, int s, int bw, int h,
                                         int N, int H) {
  constexpr int kV = D / 4;
  for (int t = threadIdx.x; t < N * kV; t += kThr) {
    const int n = t / kV, c = t % kV;
    const float4 v = *reinterpret_cast<const float4*>(
        qkv + ((long long)(bw * N + n) * 3 + s) * H * D + h * D + 4 * c);
    float* row = dst + n * Smem<D>::kRow + 4 * c;
    row[0] = v.x;
    row[1] = v.y;
    row[2] = v.z;
    row[3] = v.w;
  }
}

// the region label of each token of window (bw mod nW) in the rolled map
__device__ __forceinline__ void labels(int* lab, int bw, int N, int WS,
                                       int nWh, int nWw, int shift) {
  const int w = bw % (nWh * nWw);
  const int Hm = nWh * WS, Wm = nWw * WS;
  for (int n = threadIdx.x; n < N; n += kThr) {
    const int y = (w / nWw) * WS + n / WS, x = (w % nWw) * WS + n % WS;
    const int ry = y < Hm - WS ? 0 : (y < Hm - shift ? 1 : 2);
    const int rx = x < Wm - WS ? 0 : (x < Wm - shift ? 1 : 2);
    lab[n] = 3 * ry + rx;
  }
}

__device__ __forceinline__ int rel_index(int i, int j, int WS) {
  return (i / WS - j / WS + WS - 1) * (2 * WS - 1) + (i % WS - j % WS) + WS -
         1;
}

// S rows of this thread -> P, in registers and in sP. Columns past N are
// -inf (weight 0). A NaN in a row makes the row's sum, and so the row, NaN.
template <int D>
__device__ __forceinline__ void scores_softmax(
    const float* sQ, const float* sK, const float* sB, const int* lab,
    float* sP, float (&p)[4][8], int N, int WS, int shift, float scale) {
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  constexpr int R = Smem<D>::kRow;
  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int e = 0; e < D; ++e) {
    float qa[4], kb[8];
#pragma unroll
    for (int a = 0; a < 4; ++a) qa[a] = sQ[min(ty + 16 * a, N - 1) * R + e];
#pragma unroll
    for (int b = 0; b < 8; ++b) kb[b] = sK[min(tx + 8 * b, N - 1) * R + e];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(qa[a], kb[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    float m = -INFINITY;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = tx + 8 * b;
      float s = -INFINITY;
      if (i < N && j < N) {
        // (q.k) * scale + bias, then + mask: each one rounding, in order
        s = __fadd_rn(__fmul_rn(acc[a][b], scale), sB[rel_index(i, j, WS)]);
        if (shift) s = __fadd_rn(s, lab[i] != lab[j] ? -100.f : 0.f);
      }
      acc[a][b] = s;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = tx + 8 * b;
      const float ev = j < N ? expf(acc[a][b] - m) : 0.f;
      acc[a][b] = ev;
      sum += ev;
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.f / sum;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      p[a][b] = acc[a][b] * inv;
      if (i < N) sP[i * kSP + tx + 8 * b] = p[a][b];
    }
  }
}

// C (N x D) = A^T-or-A (N x N tile, row stride kSP) times X (N x D tile):
// C[i][e] = sum_j A(i, j) X[j][e], A(i, j) = A[i][j] (trans 0) or A[j][i]
// (trans 1); this thread's rows ty + 16 a, columns tx + 8 c.
template <int D, bool kTrans>
__device__ __forceinline__ void nn_times_nd(const float* A, const float* X,
                                            float (&c)[4][D / 8], int N) {
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  constexpr int R = Smem<D>::kRow;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < D / 8; ++q) c[a][q] = 0.f;
#pragma unroll 4
  for (int j = 0; j < N; ++j) {
    float av[4], xv[D / 8];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = min(ty + 16 * a, N - 1);
      av[a] = kTrans ? A[j * kSP + i] : A[i * kSP + j];
    }
#pragma unroll
    for (int q = 0; q < D / 8; ++q) xv[q] = X[j * R + tx + 8 * q];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < D / 8; ++q) c[a][q] = fmaf(av[a], xv[q], c[a][q]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThr)
    window_attention_fwd(const float* __restrict__ qkv,
                         const float* __restrict__ table,
                         float* __restrict__ out, int N, int WS, int H,
                         int nWh, int nWw, int shift, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + Smem<D>::kMat;
  float* sV = sK + Smem<D>::kMat;
  float* sP = sV + Smem<D>::kMat;
  float* sB = sP + Smem<D>::kNN;
  int* lab = reinterpret_cast<int*>(sB + kMaxBins);
  const int bw = blockIdx.x / H, h = blockIdx.x % H;
  const int nb = (2 * WS - 1) * (2 * WS - 1);
  load_qkv<D>(qkv, sQ, 0, bw, h, N, H);
  load_qkv<D>(qkv, sK, 1, bw, h, N, H);
  load_qkv<D>(qkv, sV, 2, bw, h, N, H);
  for (int r = threadIdx.x; r < nb; r += kThr) sB[r] = table[r * H + h];
  if (shift) labels(lab, bw, N, WS, nWh, nWw, shift);
  __syncthreads();
  float p[4][8];
  scores_softmax<D>(sQ, sK, sB, lab, sP, p, N, WS, shift, scale);
  __syncthreads();
  float o[4][D / 8];
  nn_times_nd<D, false>(sP, sV, o, N);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    if (i >= N) continue;
    float* dst = out + (long long)(bw * N + i) * H * D + h * D;
#pragma unroll
    for (int q = 0; q < D / 8; ++q) dst[tx + 8 * q] = o[a][q];
  }
}

// one gradient tile (N x D) into the qkv gradient's slot s
template <int D>
__device__ __forceinline__ void store_grad(float* __restrict__ dqkv,
                                           const float (&c)[4][D / 8], int s,
                                           int bw, int h, int N, int H,
                                           float mul) {
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int n = ty + 16 * a;
    if (n >= N) continue;
    float* dst = dqkv + ((long long)(bw * N + n) * 3 + s) * H * D + h * D;
#pragma unroll
    for (int q = 0; q < D / 8; ++q) dst[tx + 8 * q] = c[a][q] * mul;
  }
}

template <int D>
__global__ void __launch_bounds__(kThr)
    window_attention_bwd(const float* __restrict__ qkv,
                         const float* __restrict__ table,
                         const float* __restrict__ gout,
                         float* __restrict__ dqkv, float* __restrict__ part,
                         int BW, int N, int WS, int H, int nWh, int nWw,
                         int shift, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + Smem<D>::kMat;
  float* sV = sK + Smem<D>::kMat;
  float* sG = sV + Smem<D>::kMat;
  float* sP = sG + Smem<D>::kMat;
  float* sS = sP + Smem<D>::kNN;
  float* sB = sS + Smem<D>::kNN;
  int* lab = reinterpret_cast<int*>(sB + kMaxBins);
  const int bw = blockIdx.x / H, h = blockIdx.x % H;
  const int nb = (2 * WS - 1) * (2 * WS - 1);
  constexpr int R = Smem<D>::kRow;
  load_qkv<D>(qkv, sQ, 0, bw, h, N, H);
  load_qkv<D>(qkv, sK, 1, bw, h, N, H);
  load_qkv<D>(qkv, sV, 2, bw, h, N, H);
  constexpr int kV = D / 4;
  for (int t = threadIdx.x; t < N * kV; t += kThr) {  // dO (BW, N, H * D)
    const int n = t / kV, c = t % kV;
    const float4 v = *reinterpret_cast<const float4*>(
        gout + (long long)(bw * N + n) * H * D + h * D + 4 * c);
    float* row = sG + n * R + 4 * c;
    row[0] = v.x;
    row[1] = v.y;
    row[2] = v.z;
    row[3] = v.w;
  }
  for (int r = threadIdx.x; r < nb; r += kThr) sB[r] = table[r * H + h];
  if (shift) labels(lab, bw, N, WS, nWh, nWw, shift);
  __syncthreads();
  float p[4][8];
  scores_softmax<D>(sQ, sK, sB, lab, sP, p, N, WS, shift, scale);

  // dP = dO v^T on this thread's (row, column) pairs, then dS
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  float dp[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) dp[a][b] = 0.f;
#pragma unroll 4
  for (int e = 0; e < D; ++e) {
    float ga[4], vb[8];
#pragma unroll
    for (int a = 0; a < 4; ++a) ga[a] = sG[min(ty + 16 * a, N - 1) * R + e];
#pragma unroll
    for (int b = 0; b < 8; ++b) vb[b] = sV[min(tx + 8 * b, N - 1) * R + e];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) dp[a][b] = fmaf(ga[a], vb[b], dp[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    float delta = 0.f;
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (tx + 8 * b < N) delta = fmaf(p[a][b], dp[a][b], delta);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      delta += __shfl_xor_sync(0xffffffffu, delta, o);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = tx + 8 * b;
      if (i < N && j < N) sS[i * kSP + j] = p[a][b] * (dp[a][b] - delta);
    }
  }
  __syncthreads();

  float c[4][D / 8];
  nn_times_nd<D, true>(sP, sG, c, N);  // dV = P^T dO
  store_grad<D>(dqkv, c, 2, bw, h, N, H, 1.f);
  nn_times_nd<D, false>(sS, sK, c, N);  // dQ = dS k
  store_grad<D>(dqkv, c, 0, bw, h, N, H, scale);
  nn_times_nd<D, true>(sS, sQ, c, N);  // dK = dS^T q
  store_grad<D>(dqkv, c, 1, bw, h, N, H, scale);

  // this problem's table gradient: each bin's pairs in a fixed order
  for (int r = threadIdx.x; r < nb; r += kThr) {
    const int oy = r / (2 * WS - 1) - (WS - 1), ox = r % (2 * WS - 1) - (WS - 1);
    float s = 0.f;
    for (int ri = max(0, oy); ri < min(WS, WS + oy); ++ri)
      for (int ci = max(0, ox); ci < min(WS, WS + ox); ++ci)
        s += sS[(ri * WS + ci) * kSP + (ri - oy) * WS + (ci - ox)];
    part[((long long)h * nb + r) * BW + bw] = s;
  }
}

// dtable[r][h] = sum over bw of part[h][r][bw], one CTA a (h, r): strided
// partial sums and a fixed tree
__global__ void __launch_bounds__(kThr)
    window_attention_bias_grad(const float* __restrict__ part,
                               float* __restrict__ dtable, int BW, int H,
                               int nb) {
  __shared__ float red[kThr];
  const int h = blockIdx.x / nb, r = blockIdx.x % nb;
  const float* src = part + (long long)blockIdx.x * BW;
  float s = 0.f;
  for (int b = threadIdx.x; b < BW; b += kThr) s += src[b];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThr / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) dtable[r * H + h] = red[0];
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D>
int launch_fwd(const float* qkv, const float* table, float* out, int BW,
               int N, int WS, int H, int nWh, int nWw, int shift, float scale,
               cudaStream_t st) {
  const int smem = Smem<D>::kFwd;
  const cudaError_t e = allow_smem(window_attention_fwd<D>, smem);
  if (e != cudaSuccess) return (int)e;
  window_attention_fwd<D><<<BW * H, kThr, smem, st>>>(
      qkv, table, out, N, WS, H, nWh, nWw, shift, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const float* qkv, const float* table, const float* gout,
               float* dqkv, float* part, float* dtable, int BW, int N, int WS,
               int H, int nWh, int nWw, int shift, float scale,
               cudaStream_t st) {
  const int smem = Smem<D>::kBwd;
  const cudaError_t e = allow_smem(window_attention_bwd<D>, smem);
  if (e != cudaSuccess) return (int)e;
  window_attention_bwd<D><<<BW * H, kThr, smem, st>>>(
      qkv, table, gout, dqkv, part, BW, N, WS, H, nWh, nWw, shift, scale);
  const int nb = (2 * WS - 1) * (2 * WS - 1);
  window_attention_bias_grad<<<H * nb, kThr, 0, st>>>(part, dtable, BW, H,
                                                      nb);
  return (int)cudaGetLastError();
}

bool valid(int BW, int WS, int H, int D, int nWh, int nWw, int shift,
           std::initializer_list<const void*> ptrs) {
  return BW > 0 && WS >= 1 && WS * WS <= kMaxN && H >= 1 &&
         (D == 16 || D == 32 || D == 64) && nWh >= 1 && nWw >= 1 &&
         BW % (nWh * nWw) == 0 && shift >= 0 && shift < WS &&
         (long long)BW * H <= 0x7fffffff && vwfd::aligned16(ptrs);
}

}  // namespace

// qkv: (BW, N, 3, H, D) f32 contiguous, N = WS^2; table: ((2 WS - 1)^2, H);
// out: (BW, N, H * D). The BW windows are images of nWh x nWw windows each;
// shift 0 adds no mask.
extern "C" int vwfd_window_attention_fwd(const void* qkv, const void* table,
                                         void* out, int BW, int WS, int H,
                                         int D, int nWh, int nWw, int shift,
                                         float scale, void* stream) {
  if (!valid(BW, WS, H, D, nWh, nWw, shift, {qkv, out}))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = WS * WS;
  auto q = static_cast<const float*>(qkv);
  auto t = static_cast<const float*>(table);
  auto o = static_cast<float*>(out);
  switch (D) {
    case 16:
      return launch_fwd<16>(q, t, o, BW, N, WS, H, nWh, nWw, shift, scale, st);
    case 32:
      return launch_fwd<32>(q, t, o, BW, N, WS, H, nWh, nWw, shift, scale, st);
    default:
      return launch_fwd<64>(q, t, o, BW, N, WS, H, nWh, nWw, shift, scale, st);
  }
}

// gout: (BW, N, H * D); dqkv: (BW, N, 3, H, D); part: H * (2 WS - 1)^2 * BW
// floats of scratch; dtable: ((2 WS - 1)^2, H), every entry written.
extern "C" int vwfd_window_attention_bwd(const void* qkv, const void* table,
                                         const void* gout, void* dqkv,
                                         void* part, void* dtable, int BW,
                                         int WS, int H, int D, int nWh,
                                         int nWw, int shift, float scale,
                                         void* stream) {
  if (!valid(BW, WS, H, D, nWh, nWw, shift, {qkv, gout, dqkv}))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = WS * WS;
  auto q = static_cast<const float*>(qkv);
  auto t = static_cast<const float*>(table);
  auto g = static_cast<const float*>(gout);
  auto dq = static_cast<float*>(dqkv);
  auto p = static_cast<float*>(part);
  auto dt = static_cast<float*>(dtable);
  switch (D) {
    case 16:
      return launch_bwd<16>(q, t, g, dq, p, dt, BW, N, WS, H, nWh, nWw, shift,
                            scale, st);
    case 32:
      return launch_bwd<32>(q, t, g, dq, p, dt, BW, N, WS, H, nWh, nWw, shift,
                            scale, st);
    default:
      return launch_bwd<64>(q, t, g, dq, p, dt, BW, N, WS, H, nWh, nWw, shift,
                            scale, st);
  }
}
