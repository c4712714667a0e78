// K23 film_residual: the FiLM epilogue of FBCNN's QF-attention blocks,
// forward and backward (kernels/film.py).
//
// Replaces vwfd_tpu/nets/fbcnn.py:40 (_QFAttention's epilogue), which is
// no Pallas kernel: XLA fuses x + (gamma * h + beta) into the convolution's
// consumer on the TPU, while PyTorch runs it as three passes forward and
// four backward. Here, on NCHW float32 planes with gamma and beta of shape
// (B, C):
//
//   forward   out = x + (gamma[b, c] * h + beta[b, c])
//   backward  gh = gamma[b, c] * g;  gx = g (no kernel: the wrapper returns
//             g itself);  ggamma[b, c] = sum over the plane of g * h,
//             gbeta[b, c] = sum over the plane of g.
//
// Bound: bytes. The forward reads x and h and writes out, the backward
// reads g and h and writes gh: 12 bytes a value each way (0.315 ms for a
// KD-JPEG generator forward's 12 launches at 3.35 TB/s). The products and
// sums are written with __fmul_rn / __fadd_rn, so that nvcc contracts
// nothing into an FMA and forward and gh equal the plain version's
// separate roundings.
//
// Design: a CTA of 256 threads takes one plane (blockIdx.x = b * C + c)
// and a run of it (blockIdx.y), so gamma and beta are two scalar loads a
// CTA; each thread issues its four 16-byte loads of a sweep before it
// computes (float4 where the plane's length and every base are multiples
// of 16 bytes, else one float a thread). The backward's sums are
// deterministic, with no float atomics: each CTA reduces its run in a
// fixed order (a thread's values in turn, a shuffle tree, the warps in
// order) to a partial, and the CTA that takes a plane's last integer
// ticket adds that plane's partials in run order and resets the ticket.
// One run a plane (segs == 1) writes its sums directly. Without sums
// (frozen gamma and beta: the JPEG simulator's attack branch) h is not
// read and no partial is written.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kUnroll = 4;  // vectors a thread loads before it computes
constexpr int kWarps = kBlock / 32;

template <int V>
__device__ __forceinline__ void ldv(const float* __restrict__ p, float* v) {
  if constexpr (V == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void stv(float* __restrict__ p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// A run of kUnroll * kBlock vectors of one plane per CTA.
template <int V>
__global__ void __launch_bounds__(kBlock)
    film_fwd(const float* __restrict__ x, const float* __restrict__ h,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             float* __restrict__ out, long long hw) {
  const long long plane = blockIdx.x;
  const float gm = gamma[plane], bt = beta[plane];
  const long long nv = hw / V;
  const long long base = plane * hw;
  const long long v0 = (long long)blockIdx.y * (kUnroll * kBlock) +
                       threadIdx.x;
  float xv[kUnroll][V], hv[kUnroll][V];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = v0 + (long long)k * kBlock;
    if (i < nv) {
      ldv<V>(x + base + i * V, xv[k]);
      ldv<V>(h + base + i * V, hv[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = v0 + (long long)k * kBlock;
    if (i < nv) {
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = __fadd_rn(xv[k][j], __fadd_rn(__fmul_rn(gm, hv[k][j]), bt));
      stv<V>(out + base + i * V, o);
    }
  }
}

// Run blockIdx.y of gridDim.y (segs) of plane blockIdx.x: `per` vectors.
// gh may be null (no input gradient wanted); kSums adds the plane's sums.
template <int V, bool kSums>
__global__ void __launch_bounds__(kBlock)
    film_bwd(const float* __restrict__ g, const float* __restrict__ h,
             const float* __restrict__ gamma, float* __restrict__ gh,
             float* __restrict__ ggamma, float* __restrict__ gbeta,
             float* __restrict__ partial, unsigned int* __restrict__ ticket,
             long long hw, long long per) {
  const long long plane = blockIdx.x;
  const int segs = gridDim.y;
  const float gm = gamma[plane];
  const long long nv = hw / V;
  const long long base = plane * hw;
  const long long r0 = (long long)blockIdx.y * per;
  const long long r1 = min(nv, r0 + per);
  float sgh = 0.f, sg = 0.f;
  for (long long i0 = r0 + threadIdx.x; i0 < r1;
       i0 += (long long)kUnroll * kBlock) {
    float gv[kUnroll][V], hv[kUnroll][V];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = i0 + (long long)k * kBlock;
      if (i < r1) {
        ldv<V>(g + base + i * V, gv[k]);
        if (kSums) ldv<V>(h + base + i * V, hv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = i0 + (long long)k * kBlock;
      if (i < r1) {
        if (gh != nullptr) {
          float o[V];
#pragma unroll
          for (int j = 0; j < V; ++j) o[j] = __fmul_rn(gm, gv[k][j]);
          stv<V>(gh + base + i * V, o);
        }
        if (kSums) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            sgh = __fmaf_rn(gv[k][j], hv[k][j], sgh);
            sg = __fadd_rn(sg, gv[k][j]);
          }
        }
      }
    }
  }
  if constexpr (kSums) {
    __shared__ float warp_s[2][kWarps];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sgh = __fadd_rn(sgh, __shfl_xor_sync(0xffffffffu, sgh, o));
      sg = __fadd_rn(sg, __shfl_xor_sync(0xffffffffu, sg, o));
    }
    if (lane == 0) {
      warp_s[0][w] = sgh;
      warp_s[1][w] = sg;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      a = __fadd_rn(a, warp_s[0][v]);
      b = __fadd_rn(b, warp_s[1][v]);
    }
    if (segs == 1) {
      ggamma[plane] = a;
      gbeta[plane] = b;
      return;
    }
    const long long slot = plane * segs + blockIdx.y;
    const long long n_part = (long long)gridDim.x * segs;
    partial[slot] = a;
    partial[n_part + slot] = b;
    __threadfence();  // the partials before the ticket
    if (atomicAdd(ticket + plane, 1u) != (unsigned int)segs - 1) return;
    __threadfence();
    a = 0.f;
    b = 0.f;
    for (int s = 0; s < segs; ++s) {  // run order, whichever CTA is last
      a = __fadd_rn(a, __ldcg(partial + plane * segs + s));
      b = __fadd_rn(b, __ldcg(partial + n_part + plane * segs + s));
    }
    ggamma[plane] = a;
    gbeta[plane] = b;
    ticket[plane] = 0u;  // ready for the next call
  }
}

template <int V>
cudaError_t launch_fwd(const float* x, const float* h, const float* gamma,
                       const float* beta, float* out, long long planes,
                       long long hw, cudaStream_t s) {
  const long long runs = (hw / V + kUnroll * kBlock - 1) / (kUnroll * kBlock);
  if (runs > 65535) return cudaErrorInvalidConfiguration;
  film_fwd<V><<<dim3((unsigned)planes, (unsigned)runs), kBlock, 0, s>>>(
      x, h, gamma, beta, out, hw);
  return cudaGetLastError();
}

template <int V, bool kSums>
cudaError_t launch_bwd(const float* g, const float* h, const float* gamma,
                       float* gh, float* gg, float* gb, float* partial,
                       unsigned int* ticket, long long planes, long long hw,
                       int segs, cudaStream_t s) {
  const long long nv = hw / V;
  const long long per = (nv + segs - 1) / segs;
  film_bwd<V, kSums><<<dim3((unsigned)planes, (unsigned)segs), kBlock, 0,
                       s>>>(g, h, gamma, gh, gg, gb, partial, ticket, hw,
                            per);
  return cudaGetLastError();
}

}  // namespace

// x, h, out: (planes, hw) float32, planes = B * C; gamma, beta: (planes,).
extern "C" int vwfd_film_fwd(const void* x, const void* h, const void* gamma,
                             const void* beta, void* out, long long planes,
                             long long hw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes < 1 || planes > 0x7fffffffLL || hw < 1)
    return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* hf = static_cast<const float*>(h);
  const auto* gf = static_cast<const float*>(gamma);
  const auto* bf = static_cast<const float*>(beta);
  auto* of = static_cast<float*>(out);
  const bool vec = hw % 4 == 0 && vwfd::aligned16({x, h, out});
  return (int)(vec ? launch_fwd<4>(xf, hf, gf, bf, of, planes, hw, s)
                   : launch_fwd<1>(xf, hf, gf, bf, of, planes, hw, s));
}

// g, h, gh: (planes, hw) float32 (gh null: no input gradient); gamma:
// (planes,); with sums (ggamma, gbeta non-null, both (planes,)) h is read,
// and for segs > 1 partial (2 * planes * segs floats) and ticket (planes
// u32, 0 on entry and left 0) are stream scratch.
extern "C" int vwfd_film_bwd(const void* g, const void* h, const void* gamma,
                             void* gh, void* ggamma, void* gbeta,
                             void* partial, void* ticket, long long planes,
                             long long hw, int segs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sums = ggamma != nullptr && gbeta != nullptr;
  if (planes < 1 || planes > 0x7fffffffLL || hw < 1 || segs < 1 ||
      segs > 65535 || (!sums && gh == nullptr) ||
      (sums && segs > 1 && (partial == nullptr || ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto* gf = static_cast<const float*>(g);
  const auto* hf = static_cast<const float*>(h);
  const auto* gmf = static_cast<const float*>(gamma);
  auto* ghf = static_cast<float*>(gh);
  auto* ggf = static_cast<float*>(ggamma);
  auto* gbf = static_cast<float*>(gbeta);
  auto* pf = static_cast<float*>(partial);
  auto* tk = static_cast<unsigned int*>(ticket);
  const bool vec = hw % 4 == 0 && vwfd::aligned16({g, h}) &&
                   (gh == nullptr || vwfd::aligned16({gh}));
  cudaError_t rc;
  if (vec)
    rc = sums ? launch_bwd<4, true>(gf, hf, gmf, ghf, ggf, gbf, pf, tk,
                                    planes, hw, segs, s)
              : launch_bwd<4, false>(gf, hf, gmf, ghf, ggf, gbf, pf, tk,
                                     planes, hw, segs, s);
  else
    rc = sums ? launch_bwd<1, true>(gf, hf, gmf, ghf, ggf, gbf, pf, tk,
                                    planes, hw, segs, s)
              : launch_bwd<1, false>(gf, hf, gmf, ghf, ggf, gbf, pf, tk,
                                     planes, hw, segs, s);
  return (int)rc;
}
