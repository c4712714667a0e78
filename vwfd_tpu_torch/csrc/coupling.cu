// K2 `coupling_head`: one coupling half's 1x1 head GEMM, bias and RealNVP
// affine in one kernel.
//
// Replaces vwfd_tpu/nets/inn_packed.py::_st_packed / _st_unpacked from the
// concat on (:186-188, :195-198) and the affine lines of _coupling_fwd /
// _coupling_inv (:201-220) with e(s) of vwfd_tpu/nets/inn.py::_e:
//   head = round_dt([xin | h] . W)          (M x 2C, f32 accumulation)
//   s, t = head[:, s-cols] + b_s, head[:, t-cols] + b_t
//   e    = exp(2 * sigmoid(s) - 1) + 1e-4
//   out  = e * x + t        (inverse: (x - t) / e)
// Rows run over N*H*W. xin, x and out are channel slices of NHWC tensors
// (unit channel stride, row strides ldxin / ldx / ldo), h is the trunk
// output (row stride ldh). W is given transposed, (2C x K) with K = Kx + F
// contiguous, its rows (the head's columns) interleaved in blocks of 8,
// [s c..c+7 | t c..c+7 | ...], and the bias likewise
// (kernels/coupling.py::interleave_index), so that every accumulator
// fragment a thread holds pairs the s and t of the same channels.
//
// Bound: at the flagship shapes bytes (level 48: M = 65536, K = 224,
// N = 192) or bytes ~ tensor-core flops (levels 192/768: M = 16384, K = 512,
// N = 768). Design (bf16): no concat and no head in device memory.
// * W stationary: each persistent block owns one BN-column slice of W and
//   keeps all of it in shared memory, loaded once; only A streams. Where
//   the slice does not fit beside two ring stages a consumer (down_num 4's
//   3072-channel head: K = 1,664, 426 KB at BN 128), W streams through the
//   ring instead: each stage carries the A boxes and the W boxes of the same
//   K columns, so the wgmma sequence, and with it the order of the sums, is
//   the resident path's (ROADMAP F20). The resident path's code is the
//   kStreamW = false instantiation, unchanged.
// * A is read in place from its two sources: TMA loads 32-column boxes from
//   xin's tensor map below kx and from h's above (and W's slice from the
//   matching two maps of W), 64-byte swizzled, into a ring of shared-memory
//   stages guarded by mbarriers.
// * Warp specialisation: one producer warp issues the TMA loads; three or
//   four consumer warpgroups take the block's 64-row tiles in turn, each
//   through its own ring, multiply with wgmma (f32 accumulators), and run
//   the epilogue of their tile while the others multiply theirs: the
//   epilogue's transcendentals, not the GEMM, are the larger part of the
//   work, so more consumers run faster (PERF.md).
// * Epilogue: round the accumulator to bf16 (as the plain version's bf16
//   head), add the f32 bias, apply the affine with explicitly rounded
//   mul/add/div (no FMA contraction), read x and write out as channel pairs.
// f32 tensors take a CUDA-core (FFMA) tile: no TF32, so that f32 keeps its
// tolerance.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
                   // through the CUDA runtime, so no -lcuda

#include <atomic>

#include "common.cuh"

namespace {

using vwfd::mbar_arrive;
using vwfd::mbar_expect_tx;
using vwfd::mbar_init;
using vwfd::mbar_wait;
using vwfd::smem_u32;

struct Args {
  const void* xin;
  const void* h;
  const void* w;
  const float* bias;
  const void* x;
  void* out;
  int ldxin, ldh, ldx, ldo;
  int kx, K, M, N;  // N = 2C
  int inverse;
};

using vwfd::rnvp_affine;

// ------------------------------------------------- bf16: TMA + wgmma (sm_90a)

constexpr int kBoxK = 32;  // K columns per TMA box: 64 bytes of bf16
constexpr int kRows = 64;  // rows of a consumer's tile (one wgmma M)
constexpr int kSubBytes = kRows * kBoxK * 2;  // one A box, 4 KB
constexpr int kStageBytes = 2 * kSubBytes;    // two boxes: K = 64 a stage
constexpr int kMaxStages = 16;  // ring slots of all consumers
constexpr int kSmemBudget = 227 * 1024 - 1024;   // minus 1 KB for alignment

struct Maps {
  CUtensorMap xin, h, wx, wh;  // wx / wh: W's columns below / above kx
};

// One 2-D box (inner coordinate k, outer coordinate row) of `map` into
// shared memory at dst; its completion counts bytes on `bar`. A box
// reaching past the tensor's edge is zero-filled there.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 64-byte
// swizzle layout TMA writes: rows of 32 bf16 (64 bytes), 8-row groups 512
// bytes apart. The operand starts on a 512-byte boundary; a k16 step adds
// 32 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x n, f32) += A(64 x 16) . B(n x 16)^T, both bf16 K-major in shared
// memory, n = 64 or 128; the warpgroup's thread t holds D rows 16 (t / 32)
// + (t % 32) / 4 (+ 8) at columns 8 j + 2 (t % 4) (+ 1) in d[4 j ..], the
// m16n8 fragment order.
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// The blocks' schedule. K runs as `boxes` 32-column boxes: xin's first
// (qx = ceil(kx / 32) of them, zero-filled past kx), then h's; a stage
// holds two. Block b owns W slice b % n_tiles and the 64-row tiles
// b / n_tiles + j * groups; its j-th tile goes to consumer j % NC, whose
// own ring of `ring` stages carries it (one producer and one consumer per
// ring, each in step order, so a stage's phase parity is never ambiguous).
struct Plan {
  int qx, boxes, stages_per_tile, n_tiles, groups, ring;
};

// Shared memory from a 1024-byte boundary: the W slice (boxes x BN rows x
// 64 bytes), then the consumers' rings (NC x `ring` stages of two 4 KB A
// boxes); the barriers in static shared memory. With kStreamW there is no
// resident slice, and a stage holds its two A boxes, then the two W boxes
// of the same K columns.
template <int BN, int NC, bool kStreamW>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
    coupling_head_bf16(const Args a, const Plan pl,
                       const __grid_constant__ Maps maps) {
  using bf = __nv_bfloat16;
  constexpr int kWBox = BN * kBoxK * 2;  // bytes of one W box
  constexpr int kSlot = kStageBytes + (kStreamW ? 2 * kWBox : 0);
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages],
      wready;
  const uint32_t wsm = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = wsm + (kStreamW ? 0 : pl.boxes * kWBox);
  const int tiles_m = (a.M + kRows - 1) / kRows;
  const int g0 = blockIdx.x / pl.n_tiles;
  const int mine = g0 < tiles_m ? (tiles_m - 1 - g0) / pl.groups + 1 : 0;
  const int n0 = (blockIdx.x % pl.n_tiles) * BN;
  // the warpgroup index, broadcast from lane 0 so that the compiler sees
  // it warp-uniform: wgmma under a branch it deems divergent is
  // serialised
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < NC * pl.ring; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), 1);
    }
    mbar_init(smem_u32(&wready), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {  // the producer warp: one thread issues the loads
    if (threadIdx.x != NC * 128) return;
    if constexpr (!kStreamW) {
      const uint32_t wb = smem_u32(&wready);
      mbar_expect_tx(wb, pl.boxes * kWBox);
      for (int q = 0; q < pl.boxes; ++q)
        tma_load(wsm + q * kWBox, q < pl.qx ? &maps.wx : &maps.wh,
                 (q < pl.qx ? q : q - pl.qx) * kBoxK, n0, wb);
    }
    for (int j = 0; j < mine; ++j) {
      const int m0 = (g0 + j * pl.groups) * kRows;
      for (int s = 0; s < pl.stages_per_tile; ++s) {
        const int ls = (j / NC) * pl.stages_per_tile + s;  // consumer's step
        const int slot = (j % NC) * pl.ring + ls % pl.ring;
        mbar_wait(smem_u32(&empty[slot]), ((ls / pl.ring) & 1) ^ 1);
        const int nq = min(2, pl.boxes - 2 * s);
        const uint32_t fb = smem_u32(&full[slot]);
        mbar_expect_tx(fb, nq * (kSubBytes + (kStreamW ? kWBox : 0)));
        for (int u = 0; u < nq; ++u) {
          const int q = 2 * s + u;
          const int kq = (q < pl.qx ? q : q - pl.qx) * kBoxK;
          tma_load(ring + slot * kSlot + u * kSubBytes,
                   q < pl.qx ? &maps.xin : &maps.h, kq, m0, fb);
          if constexpr (kStreamW)
            tma_load(ring + slot * kSlot + kStageBytes + u * kWBox,
                     q < pl.qx ? &maps.wx : &maps.wh, kq, n0, fb);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: the block's tiles j = wg, wg + NC, ...
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bf* xp = static_cast<const bf*>(a.x);
  bf* op = static_cast<bf*>(a.out);
  if constexpr (!kStreamW) mbar_wait(smem_u32(&wready), 0);
  float d[BN / 2];
  for (int j = wg; j < mine; j += NC) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    int prev = -1;
    for (int s = 0; s < pl.stages_per_tile; ++s) {
      const int ls = (j / NC) * pl.stages_per_tile + s;
      const int slot = wg * pl.ring + ls % pl.ring;
      mbar_wait(smem_u32(&full[slot]), (ls / pl.ring) & 1);
      const int nq = min(2, pl.boxes - 2 * s);
      fence_regs<BN / 2>(d);
      wgmma_fence();
      for (int u = 0; u < nq; ++u) {
        const uint32_t ta = ring + slot * kSlot + u * kSubBytes;
        const uint32_t tb = kStreamW
                                ? ring + slot * kSlot + kStageBytes + u * kWBox
                                : wsm + (2 * s + u) * kWBox;
#pragma unroll
        for (int kk = 0; kk < kBoxK / 16; ++kk) {
          const uint64_t da = smem_desc(ta + kk * 32);
#pragma unroll
          for (int nc = 0; nc + 128 <= BN; nc += 128)
            wgmma_n128(d + nc / 2, da, smem_desc(tb + nc * 64 + kk * 32));
          if constexpr (BN % 128 != 0)
            wgmma_n64(d + (BN - 64) / 2, da,
                      smem_desc(tb + (BN - 64) * 64 + kk * 32));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: free it
      fence_regs<BN / 2>(d);
      if (prev >= 0 && (threadIdx.x & 127) == 0)
        mbar_arrive(smem_u32(&empty[prev]));
      prev = slot;
    }

    // Epilogue. n8 blocks 2p (s) and 2p+1 (t) hold the same 8 channels.
    // The thread's x pairs are loaded (as raw words) while the last wgmma
    // runs.
    const int m0 = (g0 + j * pl.groups) * kRows;
    const int rw = m0 + warp * 16 + (lane >> 2);
    uint32_t xw[BN / 16][2];
#pragma unroll
    for (int p = 0; p < BN / 16; ++p)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = rw + 8 * hf;
        const int ch = (n0 >> 1) + p * 8 + 2 * (lane & 3);
        xw[p][hf] = 0u;
        if (n0 + p * 16 < a.N && row < a.M)
          xw[p][hf] = *reinterpret_cast<const uint32_t*>(
              xp + (size_t)row * a.ldx + ch);
      }
    wgmma_wait<0>();
    fence_regs<BN / 2>(d);
    if ((threadIdx.x & 127) == 0) mbar_arrive(smem_u32(&empty[prev]));
#pragma unroll
    for (int p = 0; p < BN / 16; ++p) {
      const int cs = n0 + p * 16 + 2 * (lane & 3);
      if (n0 + p * 16 >= a.N) continue;
      const int ch = (n0 >> 1) + p * 8 + 2 * (lane & 3);
      float b[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        b[e] = a.bias[cs + e];
        b[2 + e] = a.bias[cs + 8 + e];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = rw + 8 * hf;
        if (row >= a.M) continue;
        float xv[2], y[2];
        vwfd::Word<bf>::unpack(xw[p][hf], xv);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = __bfloat162float(
              __float2bfloat16_rn(d[8 * p + 2 * hf + e]));
          const float t = __bfloat162float(
              __float2bfloat16_rn(d[8 * p + 4 + 2 * hf + e]));
          y[e] = rnvp_affine(__fadd_rn(s, b[e]), __fadd_rn(t, b[2 + e]),
                             xv[e], a.inverse);
        }
        *reinterpret_cast<uint32_t*>(op + (size_t)row * a.ldo + ch) =
            vwfd::Word<bf>::pack(y);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The tensor map of a (rows x cols) bf16 matrix with row stride ld
// (elements), read in (box_rows x 32) boxes, 64-byte swizzled, zero-filled
// past its edges.
cudaError_t encode_map(CUtensorMap* map, const void* base, int cols,
                       int rows, int ld, int box_rows) {
  // cuTensorMapEncodeTiled's address: one for the process, whatever the
  // device
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (rc != cudaSuccess) return rc;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBoxK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The current device's SM count, queried once per device (the launcher
// runs with the tensors' device current, and one process may drive several
// cards). 0 where the query fails.
int sm_count() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> sms[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  int n = sms[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    sms[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

template <int BN, int NC>
cudaError_t launch_bf16(const Args& a, cudaStream_t s) {
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  Plan pl;
  pl.qx = (a.kx + kBoxK - 1) / kBoxK;
  pl.boxes = pl.qx + (a.K - a.kx + kBoxK - 1) / kBoxK;
  pl.stages_per_tile = (pl.boxes + 1) / 2;
  pl.n_tiles = (a.N + BN - 1) / BN;
  const int tiles_m = (a.M + kRows - 1) / kRows;
  pl.groups = sms / pl.n_tiles > 0 ? sms / pl.n_tiles : 1;
  if (pl.groups > tiles_m) pl.groups = tiles_m;
  // the resident W slice where it leaves each consumer two ring stages,
  // else W streamed beside A (stages of kStageBytes + two W boxes)
  const int wbytes = pl.boxes * BN * kBoxK * 2;
  int slots = (kSmemBudget - wbytes) / kStageBytes;
  if (slots > kMaxStages) slots = kMaxStages;
  pl.ring = slots / NC;
  const bool stream_w = pl.ring < 2;
  const int slot_bytes = kStageBytes + (stream_w ? 2 * BN * kBoxK * 2 : 0);
  if (stream_w) {
    slots = kSmemBudget / slot_bytes;
    if (slots > kMaxStages) slots = kMaxStages;
    pl.ring = slots / NC;
    if (pl.ring < 2) return cudaErrorInvalidValue;
  }
  Maps m;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  cudaError_t rc = encode_map(&m.xin, a.xin, a.kx, a.M, a.ldxin, kRows);
  if (rc == cudaSuccess)
    rc = encode_map(&m.h, a.h, a.K - a.kx, a.M, a.ldh, kRows);
  if (rc == cudaSuccess) rc = encode_map(&m.wx, w, a.kx, a.N, a.K, BN);
  if (rc == cudaSuccess)
    rc = encode_map(&m.wh, w + a.kx, a.K - a.kx, a.N, a.K, BN);
  if (rc != cudaSuccess) return rc;
  const size_t smem = (size_t)(stream_w ? 0 : wbytes) +
                      (size_t)NC * pl.ring * slot_bytes + 1024;
  auto kern = stream_w ? coupling_head_bf16<BN, NC, true>
                       : coupling_head_bf16<BN, NC, false>;
  rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem);
  if (rc != cudaSuccess) return rc;
  kern<<<pl.groups * pl.n_tiles, NC * 128 + 32, smem, s>>>(a, pl, m);
  return cudaSuccess;
}

// ------------------------------------------------------------- f32, FFMA

constexpr int kFM = 64, kFN = 64, kFK = 16, kFThreads = 256;

// Block: a 64 x 64 output tile; thread (ty, tx) holds rows ty + 16 i and
// channels 2 tx, 2 tx + 1 of the tile's 32, with their s and t columns.
__global__ void __launch_bounds__(kFThreads) coupling_head_f32(const Args a) {
  __shared__ float As[kFK][kFM + 4];
  __shared__ float Bs[kFK][kFN + 4];
  const float* xin = static_cast<const float*>(a.xin);
  const float* h = static_cast<const float*>(a.h);
  const float* w = static_cast<const float*>(a.w);
  const int n_tiles = (a.N + kFN - 1) / kFN;
  const int m0 = (blockIdx.x / n_tiles) * kFM;
  const int n0 = (blockIdx.x % n_tiles) * kFN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int cs = (tx >> 2) * 16 + 2 * (tx & 3);  // tile-local s column
  float acc[4][2][2] = {};                      // [row][channel][s, t]
  for (int k0 = 0; k0 < a.K; k0 += kFK) {
    for (int idx = threadIdx.x; idx < kFM * kFK; idx += kFThreads) {
      const int r = idx / kFK, kk = idx % kFK;
      const int gr = m0 + r, gk = k0 + kk;
      float v = 0.f;
      if (gr < a.M && gk < a.K)
        v = gk < a.kx ? xin[(size_t)gr * a.ldxin + gk]
                      : h[(size_t)gr * a.ldh + (gk - a.kx)];
      As[kk][r] = v;
    }
    for (int idx = threadIdx.x; idx < kFK * kFN; idx += kFThreads) {
      const int nc = idx / kFK, kr = idx % kFK;
      const int gk = k0 + kr, gn = n0 + nc;
      Bs[kr][nc] = (gk < a.K && gn < a.N) ? w[(size_t)gn * a.K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float b[2][2] = {{Bs[kk][cs], Bs[kk][cs + 8]},
                             {Bs[kk][cs + 1], Bs[kk][cs + 9]}};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = As[kk][ty + 16 * i];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[i][e][0] = fmaf(av, b[e][0], acc[i][e][0]);
          acc[i][e][1] = fmaf(av, b[e][1], acc[i][e][1]);
        }
      }
    }
    __syncthreads();
  }
  const int gcs = n0 + cs;
  if (gcs >= a.N) return;
  const int ch = (n0 >> 1) + (tx >> 2) * 8 + 2 * (tx & 3);
  const float* xp = static_cast<const float*>(a.x);
  float* op = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= a.M) continue;
    const float2 xv =
        *reinterpret_cast<const float2*>(xp + (size_t)row * a.ldx + ch);
    const float y0 = rnvp_affine(__fadd_rn(acc[i][0][0], a.bias[gcs]),
                                 __fadd_rn(acc[i][0][1], a.bias[gcs + 8]),
                                 xv.x, a.inverse);
    const float y1 = rnvp_affine(__fadd_rn(acc[i][1][0], a.bias[gcs + 1]),
                                 __fadd_rn(acc[i][1][1], a.bias[gcs + 9]),
                                 xv.y, a.inverse);
    *reinterpret_cast<float2*>(op + (size_t)row * a.ldo + ch) =
        make_float2(y0, y1);
  }
}

}  // namespace

// xin: (M, kx) row stride ldxin; h: (M, F) row stride ldh; w: (2C, kx + F)
// contiguous, rows interleaved in blocks of 8; bias: (2C,) float32, the
// same interleave; x / out: (M, C) with row strides ldx / ldo. Unit channel
// strides; xin, h and w 16-byte aligned with 16-byte row strides; kx, F and
// C multiples of 8.
extern "C" int vwfd_coupling_head(const void* xin, int ldxin, const void* h,
                                  int ldh, int kx, int F, const void* w,
                                  const void* bias, const void* x, int ldx,
                                  void* out, int ldo, int M, int C,
                                  int inverse, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || C == 0) return (int)cudaSuccess;
  Args a{xin, h, w, static_cast<const float*>(bias), x, out,
         ldxin, ldh, ldx, ldo, kx, kx + F, M, 2 * C, inverse};
  if (dtype == vwfd::kBF16) {
    // Narrow heads (level 48, 2C = 192) take 64-column W slices and four
    // consumers, wider ones (2C = 768) 128-column slices and three: the
    // fastest of the widths and consumer counts measured at the flagship
    // shapes on an H100 (vwfd_tpu_torch/sweep_coupling.py, PERF.md).
    const cudaError_t rc = 2 * C > 192 ? launch_bf16<128, 3>(a, s)
                                       : launch_bf16<64, 4>(a, s);
    if (rc != cudaSuccess) return (int)rc;
  } else {
    const int tiles = ((M + kFM - 1) / kFM) * ((2 * C + kFN - 1) / kFN);
    coupling_head_f32<<<tiles, kFThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
