// K15 `coupling_affine`: the RealNVP affine of one coupling half on the INN
// module path, forward and backward (NHWC rows, f32 or bf16, f32
// arithmetic inside, one rounding per output).
//
// Replaces the affine lines of vwfd_tpu/nets/inn.py::RNVPCoupling.forward /
// .inverse (:235-250) with _e (:176-179):
//   e   = exp(2*sigmoid(s) - 1) + 1e-4
//   out = e*x + t                  (inverse: (x - t) / e)
// s and t are channel slices of the subnet's head (fused_st: its two
// halves) or two tensors (the reference's split subnets); x is a channel
// slice of the coupling's input and out one of its output. Every operand is
// M rows of C values with unit channel stride and its own row stride.
//
// Backward, from g = dL/dout (K2's backward order,
// vwfd_tpu_torch/kernels/coupling.py::coupling_head_backward):
//   forward:  dx = g*e,  dt = g,      de = g*x
//   inverse:  dx = g/e,  dt = -dx,    de = (-dx*(x - t))/e
//   ds = (((de*e0)*2)*sig)*(1 - sig),  e0 = e - 1e-4 before the addition
//
// Bound: bytes (about 20 operations a value). Design: one thread per (row,
// group of V channels), V values being 16 bytes: 16-byte loads of s, t, x
// (and g), 16-byte stores; rows whose strides or widths are not whole
// 16-byte words take V = 1. The forward uses vwfd::rnvp_affine, K2's and
// K13's epilogue, so the three kernels round alike.
#include "common.cuh"

namespace {

using vwfd::from_f32;
using vwfd::to_f32;

constexpr float kEps = 1e-4f;

template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float* v) {
  if constexpr (V == 1) {
    v[0] = to_f32(*p);
  } else {
    vwfd::load_vec<T, V>(p, v);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float* v) {
  if constexpr (V == 1) {
    *p = from_f32<T>(v[0]);
  } else {
    vwfd::store_vec<T, V>(p, v);
  }
}

struct Rows {  // row strides, in values
  int s, t, x, o;
};

template <typename T, int V>
__global__ void __launch_bounds__(vwfd::kThreads)
    affine_fwd(const T* __restrict__ s, const T* __restrict__ t,
               const T* __restrict__ x, T* __restrict__ out, long long total,
               int C, Rows ld, int inverse) {
  const long long idx = vwfd::global_index();
  if (idx >= total) return;
  const int groups = C / V;
  const long long r = idx / groups;
  const int c = (int)(idx % groups) * V;
  float sv[V], tv[V], xv[V], o[V];
  load_v<T, V>(s + r * ld.s + c, sv);
  load_v<T, V>(t + r * ld.t + c, tv);
  load_v<T, V>(x + r * ld.x + c, xv);
#pragma unroll
  for (int v = 0; v < V; ++v)
    o[v] = vwfd::rnvp_affine(sv[v], tv[v], xv[v], inverse);
  store_v<T, V>(out + r * ld.o + c, o);
}

struct GradRows {  // row strides of g, s, t, x, dx, ds, dt
  int g, s, t, x, dx, ds, dt;
};

template <typename T, int V>
__global__ void __launch_bounds__(vwfd::kThreads)
    affine_bwd(const T* __restrict__ g, const T* __restrict__ s,
               const T* __restrict__ t, const T* __restrict__ x,
               T* __restrict__ dx, T* __restrict__ ds, T* __restrict__ dt,
               long long total, int C, GradRows ld, int inverse) {
  const long long idx = vwfd::global_index();
  if (idx >= total) return;
  const int groups = C / V;
  const long long r = idx / groups;
  const int c = (int)(idx % groups) * V;
  float gv[V], sv[V], tv[V], xv[V], odx[V], ods[V], odt[V];
  load_v<T, V>(g + r * ld.g + c, gv);
  load_v<T, V>(s + r * ld.s + c, sv);
  load_v<T, V>(x + r * ld.x + c, xv);
  if (inverse) load_v<T, V>(t + r * ld.t + c, tv);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float sig = __frcp_rn(__fadd_rn(1.f, expf(-sv[v])));
    const float e0 = expf(__fsub_rn(__fmul_rn(2.f, sig), 1.f));
    const float e = __fadd_rn(e0, kEps);
    float de;
    if (inverse) {
      odx[v] = __fdiv_rn(gv[v], e);
      odt[v] = -odx[v];
      de = __fdiv_rn(__fmul_rn(-odx[v], __fsub_rn(xv[v], tv[v])), e);
    } else {
      odx[v] = __fmul_rn(gv[v], e);
      odt[v] = gv[v];
      de = __fmul_rn(gv[v], xv[v]);
    }
    ods[v] = __fmul_rn(
        __fmul_rn(__fmul_rn(__fmul_rn(de, e0), 2.f), sig),
        __fsub_rn(1.f, sig));
  }
  store_v<T, V>(dx + r * ld.dx + c, odx);
  store_v<T, V>(ds + r * ld.ds + c, ods);
  store_v<T, V>(dt + r * ld.dt + c, odt);
}

// 16-byte accesses need C and every row stride in whole 16-byte words and
// every base address on a 16-byte boundary.
bool vec_ok(int C, int per_word, std::initializer_list<int> lds,
            std::initializer_list<const void*> ptrs) {
  if (C % per_word) return false;
  for (int ld : lds)
    if (ld % per_word) return false;
  return vwfd::aligned16(ptrs);
}

template <typename T, int V>
void fwd(const void* s, const void* t, const void* x, void* out,
         long long M, int C, Rows ld, int inverse, cudaStream_t st) {
  const long long total = M * (C / V);
  affine_fwd<T, V><<<vwfd::blocks_for(total), vwfd::kThreads, 0, st>>>(
      static_cast<const T*>(s), static_cast<const T*>(t),
      static_cast<const T*>(x), static_cast<T*>(out), total, C, ld, inverse);
}

template <typename T, int V>
void bwd(const void* g, const void* s, const void* t, const void* x,
         void* dx, void* ds, void* dt, long long M, int C, GradRows ld,
         int inverse, cudaStream_t st) {
  const long long total = M * (C / V);
  affine_bwd<T, V><<<vwfd::blocks_for(total), vwfd::kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(s),
      static_cast<const T*>(t), static_cast<const T*>(x), static_cast<T*>(dx),
      static_cast<T*>(ds), static_cast<T*>(dt), total, C, ld, inverse);
}

}  // namespace

// out = e(s)*x + t (inverse: (x - t)/e(s)) over M rows of C values; each
// operand with its own row stride (in values), unit channel stride. vec = 1
// asks for 16-byte accesses and is refused where the shapes do not allow
// them.
extern "C" int vwfd_coupling_affine(const void* s, int lds, const void* t,
                                    int ldt, const void* x, int ldx,
                                    void* out, int ldo, long long M, int C,
                                    int inverse, int dtype, int vec,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M * C == 0) return (int)cudaGetLastError();
  const Rows ld{lds, ldt, ldx, ldo};
  const int per = dtype == vwfd::kBF16 ? 8 : 4;
  if (vec && !vec_ok(C, per, {lds, ldt, ldx, ldo}, {s, t, x, out}))
    return (int)cudaErrorInvalidValue;
  if (dtype == vwfd::kBF16) {
    if (vec) fwd<__nv_bfloat16, 8>(s, t, x, out, M, C, ld, inverse, st);
    else fwd<__nv_bfloat16, 1>(s, t, x, out, M, C, ld, inverse, st);
  } else {
    if (vec) fwd<float, 4>(s, t, x, out, M, C, ld, inverse, st);
    else fwd<float, 1>(s, t, x, out, M, C, ld, inverse, st);
  }
  return (int)cudaGetLastError();
}

// dx, ds, dt of the affine from g = dL/dout; same layout rules as the
// forward (t is read by the inverse only).
extern "C" int vwfd_coupling_affine_bwd(
    const void* g, int ldg, const void* s, int lds, const void* t, int ldt,
    const void* x, int ldx, void* dx, int lddx, void* ds, int ldds, void* dt,
    int lddt, long long M, int C, int inverse, int dtype, int vec,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M * C == 0) return (int)cudaGetLastError();
  const GradRows ld{ldg, lds, ldt, ldx, lddx, ldds, lddt};
  const int per = dtype == vwfd::kBF16 ? 8 : 4;
  if (vec && !vec_ok(C, per, {ldg, lds, ldt, ldx, lddx, ldds, lddt},
                     {g, s, t, x, dx, ds, dt}))
    return (int)cudaErrorInvalidValue;
  if (dtype == vwfd::kBF16) {
    if (vec) bwd<__nv_bfloat16, 8>(g, s, t, x, dx, ds, dt, M, C, ld, inverse, st);
    else bwd<__nv_bfloat16, 1>(g, s, t, x, dx, ds, dt, M, C, ld, inverse, st);
  } else {
    if (vec) bwd<float, 4>(g, s, t, x, dx, ds, dt, M, C, ld, inverse, st);
    else bwd<float, 1>(g, s, t, x, dx, ds, dt, M, C, ld, inverse, st);
  }
  return (int)cudaGetLastError();
}
