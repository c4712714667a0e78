// The Hopper int8 implicit-GEMM core of K11 `qconv` (qconv.cu), K12
// `qconv_t` (qconv_t.cu) and K13 `qcoupling_head` (qcoupling.cu): wgmma s8
// fed by a TMA ring, with the sources' prologue loads (Src, load_a) and the
// epilogues' requant helpers.
//
// A persistent block walks output tiles of kTH x kTW = 16 x 8 pixels of one
// image and BN output columns (one column block per block: grid = groups x
// column blocks). The products are exact int32 sums of an int8 NHWC
// activation (3x3 SAME or 1x1) and an int8 weight matrix, rows x (taps x
// cin), K contiguous in (tap, channel) order (OHWI). With two operands
// (kDual) a block keeps one accumulator set each: the two carry their own
// scales (the split decoder conv, the split coupling head). A 1x1 product
// has no halo, so K12 hands the core its batch stacked as one tall image
// (1, N*H, W): a tile may then span images.
//
// * Warp specialisation: warpgroup 2 is the producer, warpgroups 0 and 1 the
//   consumers (8 tile rows each, one wgmma M of 64 pixels). setmaxnreg
//   gives the consumers kConsumerRegs registers and the producer
//   kProducerRegs.
// * Ring: `stages` slots of KC input channels (32 for 3x3, 128 for 1x1),
//   each guarded by a full and an empty mbarrier, one sequence for both
//   consumers (each consumes every stage; the producer refills a slot once
//   both released it). Operands are K-major. A 3x3 slot holds
//   A: KC/16 planes of the tile's (kTH+2) x (kTW+2)-pixel halo, 16 channels
//      (bytes) a pixel, pixels row-major, no swizzle;
//   B: taps x BN weight rows of 32 bytes (32-byte swizzle).
//   Eight pixels of a halo row are one 8 x 16-byte core matrix, and the next
//   8-row group of the wgmma's M is the next halo row, so the nine taps read
//   one staged halo: tap (dy, dx) is the descriptor offset (dy*(kTW+2) + dx)
//   * 16 bytes, leading byte offset one plane, stride byte offset one halo
//   row. A 1x1 slot holds the tile's 128 pixels and the BN weight rows as
//   128-byte rows in the 128-byte swizzle.
// * Loaders. TMA (one thread issues): A through a 4-D tensor map over the
//   NHWC input (box 16 channels x halo; 1x1: 128 x tile); its out-of-bounds
//   zero fill (negative start coordinates included) is the SAME padding,
//   and channels past cin and rows past the matrix fill as 0 too. B through
//   a 2-D map over (rows, taps x cin), one 32 x BN box a tap (1x1: 128 x
//   BN). TMA's time goes by rows more than by bytes here: the deep layers'
//   weights as 32-byte rows took about half the time of 16-byte ones
//   (PERF.md). TMA needs 16-byte global strides and addresses; what it
//   cannot describe is loaded by the producer warpgroup's 128 threads
//   (cp.async copies arrive on the barrier one stage behind, so that one
//   stage's copies are in flight while the next is issued):
//   - int8 sources off the 16-byte grid (enc1's Cin 12, ragged widths):
//     cp.async of 16 or 4 bytes, zero-filled where out of bounds;
//   - the 2x2 max-pool prologue (encoder levels 2-5): four loads and a
//     byte-wise signed max (TMA cannot take a max; the other route, the
//     level's last conv writing the pooled map as a second output, would
//     add a write and a read of the pooled map per level);
//   - the quantize prologue of a float32 / bf16 input: clip(rint(x / s),
//     -127, 127) with an IEEE division (__fdiv_rn), once per value and
//     column block, 8 values a 16-byte load where aligned; the interior
//     pixels go to the optional side output `xi` from column block 0
//     (JAX's `xi`, which K13 then reads by TMA).
//   Thread-written stages are fenced to the async proxy (which wgmma reads
//   through) before their barrier arrival.
// * Resident weights: a block keeps one column block, so when a tile's
//   stage count divides the ring (the host plan makes it so where it
//   fits), each slot always holds the same stage of the same weights, and B
//   is loaded in the first round only: after it only the activations
//   stream.
// * Consumers: per stage and tap one wgmma.mma_async m64nBNk32.s32.s8.s8 for
//   each 32 channels holding data, int32 accumulators in registers; the
//   stage is released once the next stage's products are issued
//   (wait_group 1). The kernel's epilogue (Epi) runs from the registers.
// The sums are exact int32 (|acc| < 127^2 * 9 * cin < 2^31 for cin <
// 14,800), so the kernels built on this core equal plain versions that sum
// in float64, bit for bit.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
                   // through the CUDA runtime, so no -lcuda

#include "common.cuh"

namespace vwfd {
namespace qwg {

// ------------------------------------------------- sources and epilogues

// What a source's loader applies to its input (kernels/qconv.py::_KINDS).
enum Kind : int { kI8 = 0, kI8Pool = 1, kQuantF32 = 2, kQuantBF16 = 3 };

struct Src {
  const void* x;       // NHWC activations: pixel stride ld, channel stride 1
  const int8_t* w;     // (rows, ks*ks*cin) int8, K contiguous
  const float* scale;  // kQuant*: the device scalar s of x / s
  int kind;
  int ld;              // elements between pixels of x
  int cin;
  int hin, win;        // x's spatial size (kI8Pool: pooled to H x W)
  int va, vb;          // bytes a load unit of A / B: 16, 4 or 1 (host picks)
};

__device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
  return __vmaxs4(a, b);
}
__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                    __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}
__device__ __forceinline__ uint8_t vmax(uint8_t a, uint8_t b) {
  return (int8_t)a > (int8_t)b ? a : b;
}

template <int V>
struct Unit;
template <>
struct Unit<16> {
  using T = uint4;
  static __device__ __forceinline__ T zero() { return make_uint4(0, 0, 0, 0); }
};
template <>
struct Unit<4> {
  using T = uint32_t;
  static __device__ __forceinline__ T zero() { return 0u; }
};
template <>
struct Unit<1> {
  using T = uint8_t;
  static __device__ __forceinline__ T zero() { return 0; }
};

// clip(rint(v / s), -127, 127) as a byte (jnp.round / torch.round: half to
// even), with an IEEE division as the plain version's by a 0-dim tensor.
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

// V channels (c .. c+V-1, all < cin) of the conv-input pixel (img, y, x),
// through the source's prologue: a plain int8 copy, the 2x2 max-pool of an
// int8 input (byte-wise signed max) or the quantization of a float32 / bf16
// input.
template <int V>
__device__ __forceinline__ typename Unit<V>::T load_a(const Src& s, int img,
                                                      int y, int x, int c) {
  using T = typename Unit<V>::T;
  if (s.kind == kI8) {
    const long long pix = ((long long)img * s.hin + y) * s.win + x;
    return *reinterpret_cast<const T*>(
        static_cast<const int8_t*>(s.x) + pix * s.ld + c);
  }
  if (s.kind == kI8Pool) {  // the max of input pixels (2y|2y+1, 2x|2x+1)
    const int8_t* p = static_cast<const int8_t*>(s.x) +
                      (((long long)img * s.hin + 2 * y) * s.win + 2 * x) *
                          s.ld + c;
    const long long down = (long long)s.win * s.ld;
    const T v00 = *reinterpret_cast<const T*>(p);
    const T v01 = *reinterpret_cast<const T*>(p + s.ld);
    const T v10 = *reinterpret_cast<const T*>(p + down);
    const T v11 = *reinterpret_cast<const T*>(p + down + s.ld);
    return vmax(vmax(v00, v01), vmax(v10, v11));
  }
  const long long off =
      (((long long)img * s.hin + y) * s.win + x) * s.ld + c;
  const float sc = *s.scale;
  uint32_t w[(V + 3) / 4] = {};
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float v =
        s.kind == kQuantF32
            ? static_cast<const float*>(s.x)[off + i]
            : __bfloat162float(static_cast<const __nv_bfloat16*>(s.x)[off + i]);
    w[i / 4] |= quant_byte(v, sc) << (8 * (i % 4));
  }
  T out;
  if constexpr (V == 16)
    out = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (V == 4)
    out = w[0];
  else
    out = (uint8_t)w[0];
  return out;
}

// float(acc) * m, rounded (no contraction with a following add).
__device__ __forceinline__ float scaled(int acc, float m) {
  return __fmul_rn(__int2float_rn(acc), m);
}

// clip(rint(y), lo, 127) as an int8.
__device__ __forceinline__ int8_t requant(float y, float lo) {
  return (int8_t)(int)fminf(fmaxf(rintf(y), lo), 127.f);
}

// Host side: the widest load unit (16, 4 or 1 bytes) that divides cin, the
// pixel stride and the address; for a float input, elements (4 or 1).
inline int unit_bytes(const void* p, int cin, int ld, int elem) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (elem > 1) return (cin % 4 == 0 && ld % 4 == 0) ? 4 : 1;
  for (int v : {16, 4})
    if (cin % v == 0 && ld % v == 0 && a % v == 0) return v;
  return 1;
}

// ------------------------------------------------------------ the core

constexpr int kTH = 16, kTW = 8;  // output tile: rows x columns of pixels
constexpr int kConsumers = 2;     // warpgroups of 8 tile rows (64 pixels)
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 104, kConsumerRegs = 200;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                  65536, "register file");
constexpr int kMaxStages = 6;
constexpr int kSmemLimit = 232448;  // a block's shared memory on an H100
constexpr int kStaticSmem = 256;    // the barriers (static)
constexpr int kAlign = 1024;        // slack to align the ring
constexpr int kParamBytes = 2048;   // the epilogue's per-column parameters

// The slot layout of a (KS, BN, KC) instantiation (kernels/qconv.py::plan
// mirrors these sizes). 3x3: no swizzle, 16-byte planes (the halo's taps
// are descriptor offsets) and weight rows of 32 bytes in the 32-byte
// swizzle; 1x1: rows of KC = 128 bytes in the 128-byte swizzle, one TMA row
// a pixel or weight row.
template <int KS, int BN, int KC>
struct Ring {
  static constexpr bool kSw = KS == 1;
  static_assert(!kSw || KC == 128, "1x1 stages are 128-byte rows");
  static constexpr int kPad = KS / 2;
  static constexpr int kHaloH = kTH + KS - 1, kHaloW = kTW + KS - 1;
  static constexpr int kHaloPix = kHaloH * kHaloW;
  static constexpr int kTaps = KS * KS;
  static constexpr int kPlanes = KC / 16;
  static constexpr int kPlane = (kHaloPix * 16 + 127) / 128 * 128;
  static constexpr int kABytes =
      kSw ? kHaloPix * KC : (kPlanes * kPlane + 1023) / 1024 * 1024;
  static constexpr int kBTap = BN * KC;  // 3x3: one tap's weight rows
  static constexpr int kBBytes = kTaps * kBTap;
  static constexpr int kSlot = kABytes + kBBytes;
  static_assert(kSlot % 1024 == 0, "swizzle atoms stay aligned");
  static_assert(kSw || KC == 32, "3x3 stages are 32 channels");
  // byte b of staged row r (pixel or weight row) of the 1x1 layout
  static __device__ __forceinline__ int sw(int r, int b) {
    return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
  }
  // byte b of weight row r of a 3x3 tap: rows of 32 bytes, 32-byte swizzle
  static __device__ __forceinline__ int sw32(int r, int b) {
    return r * 32 + ((((b >> 4) ^ (r >> 2)) & 1) << 4) + (b & 15);
  }
};

// One operand pair: an activation with its prologue and its weights.
struct Operand {
  Src s;        // activation, weights, prologue kind, strides, load units
  int a_tma;    // 1: A by TMA; 0: by the producer's threads
  int b_tma;    // 1: B by TMA; 0: by the producer's threads
  int stages;   // ceil(cin / KC)
  int wrows;    // rows of the weight matrix
  int8_t* xi;   // quantize prologue: the side output, (N, H, W, cin)
  int q16;      // quantize prologue in 16-byte loads (cin, ld % 8 == 0, x
                // 16-byte aligned: 8 values a unit)
};

struct Core {
  Operand op[2];
  int N, H, W;          // output pixels (the conv's input after pooling)
  int tiles_x, tiles_y; // output tiles across and down an image
  int pixel_tiles;      // N * tiles_y * tiles_x
  int nblk, groups;     // column blocks; blocks per column block
  int st_c;             // K13: coupling channels C (B rows s | t); else 0
  int stages;           // ring slots
  int b_resident;       // 1: B is loaded in the first round only (below)
  int threads_load;     // 1: some operand is loaded by the producer's threads
};

struct Maps {
  CUtensorMap a[2], b[2];
};

struct Tile {
  int img, y0, x0, nb;
};

__device__ __forceinline__ Tile tile_of(const Core& c, int j) {
  Tile t;
  t.nb = blockIdx.x % c.nblk;
  const int p = blockIdx.x / c.nblk + j * c.groups;
  const int per = c.tiles_x * c.tiles_y;
  t.img = p / per;
  const int r = p - t.img * per;
  t.y0 = (r / c.tiles_x) * kTH;
  t.x0 = (r % c.tiles_x) * kTW;
  return t;
}

// Tiles of this block.
__device__ __forceinline__ int tiles_of_block(const Core& c) {
  const int p0 = blockIdx.x / c.nblk;
  return p0 < c.pixel_tiles ? (c.pixel_tiles - 1 - p0) / c.groups + 1 : 0;
}

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, int c3,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// cp.async of V (4 or 16) bytes, the rest of V zero-filled past `bytes`.
template <int V>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, K-major, no swizzle: core matrices of
// 8 rows x 16 bytes; `lbo` bytes to the next 16 bytes of K, `sbo` bytes to
// the next 8 rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// The same for rows of 128 bytes in the 128-byte swizzle (8-row atoms of
// 1024 bytes, the operand on a 1024-byte boundary); a k32 step adds 32
// bytes to the address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Rows of 32 bytes in the 32-byte swizzle (8-row atoms of 256 bytes).
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
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
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D(64 x N, s32) += A(64 x 32) . B(N x 32)^T, int8, both K-major in shared
// memory; the warpgroup's thread t holds D rows 16 (t / 32) + (t % 32) / 4
// (+ 8) at columns 8 j + 2 (t % 4) (+ 1) in d[4 j ..], the m16n8 fragment
// order.
__device__ __forceinline__ void wgmma_n64(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db));
}
__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db));
}
template <int BN>
__device__ __forceinline__ void wgmma(int* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 64)
    wgmma_n64(d, da, db);
  else
    wgmma_n128(d, da, db);
}

// Named barrier of one consumer warpgroup (ids 1, 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// ------------------------------------------------------------ producer

// Slot row r -> weight row, or -1 for none. st_c == 0: rows nb*BN + r.
// st_c > 0 (K13): rows below BN/2 are the s rows of coupling channels
// nb*BN/2 + r, the rest their t rows (st_c + channel), so that a thread's
// column j and j + BN/2 hold the s and the t of one channel.
template <int BN>
__device__ __forceinline__ int weight_row(int r, int nb, int rows, int st_c) {
  if (st_c == 0) {
    const int row = nb * BN + r;
    return row < rows ? row : -1;
  }
  const int h = r / (BN / 2), ch = nb * (BN / 2) + r - h * (BN / 2);
  if (ch >= st_c) return -1;
  return h ? st_c + ch : ch;
}

// The producer threads' part of A: the stage's KC channels (from c0) of
// the tile's halo, through the source's prologue, in units of V bytes.
// Int8 copies go by cp.async; the prologues' loads are issued kBatch units
// at a time before any is stored, so that their latencies overlap.
template <int KS, int BN, int KC, int V>
__device__ __forceinline__ void thread_a(uint8_t* sa, const Operand& op,
                                         const Core& c, const Tile& tl,
                                         int c0, int t) {
  using R = Ring<KS, BN, KC>;
  using T = typename Unit<V>::T;
  constexpr int kUnits = KC / V, kTotal = R::kHaloPix * kUnits;
  constexpr int kBatch = V == 16 ? 1 : 2;
  const Src& s = op.s;
  const bool xi = op.xi != nullptr && tl.nb == 0;
  for (int u0 = t; u0 < kTotal; u0 += 128 * kBatch) {
    T v[kBatch];
    int8_t* xo[kBatch];
    uint8_t* dst[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int u = u0 + 128 * i;
      dst[i] = nullptr;
      xo[i] = nullptr;
      if (u >= kTotal) continue;
      const int p = u / kUnits, cc = (u - p * kUnits) * V;
      const int r = p / R::kHaloW, col = p - r * R::kHaloW;
      const int y = tl.y0 - R::kPad + r, x = tl.x0 - R::kPad + col;
      const int ch = c0 + cc;
      const bool in = ch < s.cin && y >= 0 && y < c.H && x >= 0 && x < c.W;
      dst[i] = sa + (R::kSw ? R::sw(p, cc)
                            : (cc >> 4) * R::kPlane + p * 16 + (cc & 15));
      if constexpr (V >= 4) {
        if (s.kind == kI8) {  // cp.async, zero-filled when out
          const int8_t* src = static_cast<const int8_t*>(s.x);
          if (in)
            src += ((long long)(tl.img * s.hin + y) * s.win + x) * s.ld + ch;
          cp_async<V>(smem_u32(dst[i]), src, in ? V : 0);
          dst[i] = nullptr;
          continue;
        }
      }
      v[i] = Unit<V>::zero();
      if (in) v[i] = load_a<V>(s, tl.img, y, x, ch);
      if (xi && in && r >= R::kPad && r < R::kPad + kTH && col >= R::kPad &&
          col < R::kPad + kTW)
        xo[i] = op.xi + ((long long)(tl.img * c.H + y) * c.W + x) * s.cin + ch;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (dst[i] != nullptr) *reinterpret_cast<T*>(dst[i]) = v[i];
      if (xo[i] != nullptr) *reinterpret_cast<T*>(xo[i]) = v[i];
    }
  }
}

// The quantize prologue in units of 8 values, read as 16-byte words: each
// thread issues all its loads of a batch before it quantizes and stores
// any, and reads the scale once a stage.
template <int KS, int BN, int KC, typename E>
__device__ __forceinline__ void thread_quant8(uint8_t* sa, const Operand& op,
                                              const Core& c, const Tile& tl,
                                              int c0, int t) {
  using R = Ring<KS, BN, KC>;
  constexpr int kWords = 8 * sizeof(E) / 16;  // 16-byte words a unit
  constexpr int kUnits = KC / 8, kTotal = R::kHaloPix * kUnits;
  constexpr int kBatch = kWords == 1 ? 4 : 2;
  const Src& s = op.s;
  const float sc = *s.scale;
  const bool xi = op.xi != nullptr && tl.nb == 0;
  for (int u0 = t; u0 < kTotal; u0 += 128 * kBatch) {
    uint4 raw[kBatch][kWords];
    int off[kBatch];  // staged byte; -1: none (past the stage)
    int pix[kBatch];  // conv-input pixel; -1: padding (below 2^31: the
                      // wrappers refuse larger tensors)
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int u = u0 + 128 * i;
      off[i] = -1;
      pix[i] = -1;
      if (u >= kTotal) continue;
      const int p = u / kUnits, cc = (u - p * kUnits) * 8;
      const int r = p / R::kHaloW, col = p - r * R::kHaloW;
      const int y = tl.y0 - R::kPad + r, x = tl.x0 - R::kPad + col;
      off[i] = R::kSw ? R::sw(p, cc)
                      : (cc >> 4) * R::kPlane + p * 16 + (cc & 15);
      if (c0 + cc >= s.cin || y < 0 || y >= c.H || x < 0 || x >= c.W)
        continue;
      pix[i] = (tl.img * c.H + y) * c.W + x;
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const E*>(s.x) + (long long)pix[i] * s.ld + c0 + cc);
#pragma unroll
      for (int w = 0; w < kWords; ++w) raw[i][w] = src[w];
      const bool interior = r >= R::kPad && r < R::kPad + kTH &&
                            col >= R::kPad && col < R::kPad + kTW;
      if (!(xi && interior)) pix[i] = -2 - pix[i];  // no side output
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (off[i] < 0) continue;
      uint2 q = make_uint2(0u, 0u);
      if (pix[i] != -1) {
        float v[8];
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          if constexpr (sizeof(E) == 2) {
            Word<__nv_bfloat16>::unpack(raw[i][w].x, v + 0);
            Word<__nv_bfloat16>::unpack(raw[i][w].y, v + 2);
            Word<__nv_bfloat16>::unpack(raw[i][w].z, v + 4);
            Word<__nv_bfloat16>::unpack(raw[i][w].w, v + 6);
          } else {
            v[4 * w + 0] = __uint_as_float(raw[i][w].x);
            v[4 * w + 1] = __uint_as_float(raw[i][w].y);
            v[4 * w + 2] = __uint_as_float(raw[i][w].z);
            v[4 * w + 3] = __uint_as_float(raw[i][w].w);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          q.x |= quant_byte(v[k], sc) << (8 * k);
          q.y |= quant_byte(v[4 + k], sc) << (8 * k);
        }
      }
      *reinterpret_cast<uint2*>(sa + off[i]) = q;
      if (pix[i] >= 0) {
        const int u = u0 + 128 * i, cc = (u % kUnits) * 8;
        *reinterpret_cast<uint2*>(op.xi + (long long)pix[i] * s.cin + c0 +
                                  cc) = q;
      }
    }
  }
}

// The producer threads' part of B: the stage's channels of every tap for
// the block's BN rows, cp.async of V bytes (or byte copies), zero-filled.
template <int KS, int BN, int KC, int V>
__device__ __forceinline__ void thread_b(uint8_t* sb, const Operand& op,
                                         const Core& c, int nb, int c0,
                                         int t) {
  using R = Ring<KS, BN, KC>;
  constexpr int kUnits = KC / V, kPerRow = R::kTaps * kUnits;
  const Src& s = op.s;
  const long long ldw = (long long)R::kTaps * s.cin;
  for (int u = t; u < BN * kPerRow; u += 128) {
    const int r = u / kPerRow, rem = u - r * kPerRow, tap = rem / kUnits;
    const int cc = (rem - tap * kUnits) * V, ch = c0 + cc;
    const int row = weight_row<BN>(r, nb, op.wrows, c.st_c);
    const bool in = row >= 0 && ch < s.cin;
    uint8_t* dst =
        sb + (R::kSw ? R::sw(r, cc) : tap * R::kBTap + R::sw32(r, cc));
    const int8_t* src = s.w + (in ? row * ldw + tap * s.cin + ch : 0);
    if constexpr (V >= 4) {
      cp_async<V>(smem_u32(dst), src, in ? V : 0);
    } else {
      *dst = in ? (uint8_t)*src : 0;
    }
  }
}

// Producer warpgroup. With threads_load 0 only thread 0 runs (TMA only);
// else all 128 load their parts and arrive one stage behind.
template <int KS, int BN, int KC, bool kDual>
__device__ __forceinline__ void produce(const Core& c, const Maps& maps,
                                        uint8_t* ring, uint64_t* full,
                                        uint64_t* empty) {
  using R = Ring<KS, BN, KC>;
  const int t = threadIdx.x - 128 * kConsumers;
  const int mine = tiles_of_block(c);
  int it = 0, prev = -1;
  for (int j = 0; j < mine; ++j) {
    const Tile tl = tile_of(c, j);
    // not unrolled: one copy of the loaders (their registers) for both
#pragma unroll 1
    for (int o = 0; o < (kDual ? 2 : 1); ++o) {
      const Operand& op = c.op[o];
      for (int st = 0; st < op.stages; ++st, ++it) {
        const int slot = it % c.stages;
        mbar_wait(smem_u32(&empty[slot]), ((it / c.stages) & 1) ^ 1);
        uint8_t* sa = ring + slot * R::kSlot;
        uint8_t* sb = sa + R::kABytes;
        const int c0 = st * KC;
        const uint32_t bar = smem_u32(&full[slot]);
        const bool load_b = !c.b_resident || it < c.stages;
        if (t == 0) {
          int bytes = 0;
          if (op.a_tma)
            bytes += R::kSw ? R::kABytes : R::kPlanes * R::kHaloPix * 16;
          if (op.b_tma && load_b) bytes += R::kBBytes;
          if (bytes)
            mbar_expect_tx(bar, bytes);
          else
            mbar_arrive(bar);
          if (op.a_tma) {
            if constexpr (R::kSw)
              tma_4d(smem_u32(sa), &maps.a[o], c0, tl.x0, tl.y0, tl.img, bar);
            else
              for (int q = 0; q < R::kPlanes; ++q)
                tma_4d(smem_u32(sa + q * R::kPlane), &maps.a[o], c0 + 16 * q,
                       tl.x0 - R::kPad, tl.y0 - R::kPad, tl.img, bar);
          }
          if (op.b_tma && load_b) {
            if constexpr (R::kSw) {
              if (c.st_c == 0) {
                tma_2d(smem_u32(sb), &maps.b[o], c0, tl.nb * BN, bar);
              } else {  // s rows, then t rows
                tma_2d(smem_u32(sb), &maps.b[o], c0, tl.nb * (BN / 2), bar);
                tma_2d(smem_u32(sb + BN / 2 * 128), &maps.b[o], c0,
                       c.st_c + tl.nb * (BN / 2), bar);
              }
            } else {
              for (int tap = 0; tap < R::kTaps; ++tap)
                tma_2d(smem_u32(sb + tap * R::kBTap), &maps.b[o],
                       tap * op.s.cin + c0, tl.nb * BN, bar);
            }
          }
        }
        if (!c.threads_load) continue;
        if (!op.a_tma && op.q16) {
          if (op.s.kind == kQuantBF16)
            thread_quant8<KS, BN, KC, __nv_bfloat16>(sa, op, c, tl, c0, t);
          else
            thread_quant8<KS, BN, KC, float>(sa, op, c, tl, c0, t);
        } else if (!op.a_tma) {
          if (op.s.va == 16)
            thread_a<KS, BN, KC, 16>(sa, op, c, tl, c0, t);
          else if (op.s.va == 4)
            thread_a<KS, BN, KC, 4>(sa, op, c, tl, c0, t);
          else
            thread_a<KS, BN, KC, 1>(sa, op, c, tl, c0, t);
        }
        if (!op.b_tma && load_b) {
          if (op.s.vb == 16)
            thread_b<KS, BN, KC, 16>(sb, op, c, tl.nb, c0, t);
          else if (op.s.vb == 4)
            thread_b<KS, BN, KC, 4>(sb, op, c, tl.nb, c0, t);
          else
            thread_b<KS, BN, KC, 1>(sb, op, c, tl.nb, c0, t);
        }
        // cp.async copies complete later: that stage arrives one behind,
        // so that one stage's copies are in flight while the next is
        // issued; loads through registers are stored already and arrive
        // now
        const bool copies =
            (!op.a_tma && op.s.kind == kI8 && op.s.va >= 4) ||
            (!op.b_tma && load_b && op.s.vb >= 4);
        if (copies) {
          cp_async_commit();
          cp_async_wait<1>();  // the previous stage's copies have landed
        } else {
          cp_async_wait<0>();
        }
        fence_to_bulk();  // the writes, visible to wgmma (async proxy)
        if (prev >= 0) mbar_arrive(smem_u32(&full[prev]));
        prev = -1;
        if (copies)
          prev = slot;
        else
          mbar_arrive(smem_u32(&full[slot]));
      }
    }
  }
  if (c.threads_load && prev >= 0) {
    cp_async_wait<0>();
    fence_to_bulk();
    mbar_arrive(smem_u32(&full[prev]));
  }
}

// ------------------------------------------------------------ consumers

// One operand's stages into acc (zeroed by the caller); `it` and `prev`
// carry the ring position across operands and tiles.
template <int KS, int BN, int KC>
__device__ __forceinline__ void mainloop(const Core& c, const Operand& op,
                                         int wg, uint8_t* ring,
                                         uint64_t* full, uint64_t* empty,
                                         int* acc, int& it, int& prev) {
  using R = Ring<KS, BN, KC>;
  const bool lead = (threadIdx.x & 127) == 0;
  for (int st = 0; st < op.stages; ++st, ++it) {
    const int slot = it % c.stages;
    mbar_wait(smem_u32(&full[slot]), (it / c.stages) & 1);
    const uint32_t sa = smem_u32(ring + slot * R::kSlot);
    const uint32_t sb = sa + R::kABytes;
    fence_regs<BN / 2>(acc);
    wgmma_fence();
    // every k32 step of the stage: channels past cin hold zeros in A and B
#pragma unroll
    for (int kk = 0; kk < KC / 32; ++kk) {
      if constexpr (R::kSw) {
        wgmma<BN>(acc, desc_sw128(sa + wg * 64 * 128 + kk * 32),
                  desc_sw128(sb + kk * 32));
      } else {
#pragma unroll
        for (int tap = 0; tap < R::kTaps; ++tap) {
          const int dy = tap / KS, dx = tap % KS;
          const uint64_t da = desc(
              sa + 2 * kk * R::kPlane +
                  ((wg * 8 + dy) * R::kHaloW + dx) * 16,
              R::kPlane, R::kHaloW * 16);
          wgmma<BN>(acc, da, desc_sw32(sb + tap * R::kBTap));
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
    fence_regs<BN / 2>(acc);
    if (prev >= 0 && lead) mbar_arrive(smem_u32(&empty[prev]));
    prev = slot;
  }
}

// The whole kernel body: barriers, roles, and per tile `epi.prefetch(core,
// tile, wg)` (the epilogue's loads, issued before the products), the
// products and `epi(core, tile, wg, acc, acc2, staging, params, pre)`.
// Shared memory: the ring from a 1024-byte boundary, the epilogue's
// per-column parameters (filled once by `epi.init(core, nb, params)`: a
// block keeps its column block), then the epilogue's staging.
// kOrdered: the consumers take turns to issue a tile's products (named
// barriers 4 and 5), so that the tensor cores finish one consumer's rows
// before the other's and one consumer's epilogue runs while the other's
// products do (both consumers otherwise finish their products together,
// then leave the tensor cores idle through their epilogues). Only where the
// ring holds a whole tile's stages (up4's eight stream through six slots:
// no turns): consumer 0 takes all of a tile's stages before consumer 1
// takes any, and a slot is refilled only once both have released it.
template <int KS, int BN, int KC, bool kDual, bool kOrdered = false,
          class Epi>
__device__ __forceinline__ void run(const Core& c, const Maps& maps,
                                    const Epi& epi) {
  using R = Ring<KS, BN, KC>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~(uintptr_t)(kAlign - 1));
  float* params = reinterpret_cast<float*>(ring + c.stages * R::kSlot);
  uint8_t* staging = ring + c.stages * R::kSlot + kParamBytes;
  // broadcast from lane 0: the compiler sees the role warp-uniform (a
  // wgmma under a branch it deems divergent is serialised)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < c.stages; ++i) {
      mbar_init(smem_u32(&full[i]), c.threads_load ? 129 : 1);
      mbar_init(smem_u32(&empty[i]), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (!c.threads_load && threadIdx.x != 128 * kConsumers) return;
    produce<KS, BN, KC, kDual>(c, maps, ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  epi.init(c, blockIdx.x % c.nblk, params);
  asm volatile("bar.sync 3, %0;\n" ::"n"(128 * kConsumers) : "memory");
  const int mine = tiles_of_block(c);
  // (stages the producer's threads load arrive one late: one slot more)
  const bool turns =
      kOrdered && c.op[0].stages + c.threads_load <= c.stages;
  int acc[BN / 2], acc2[kDual ? BN / 2 : 1];
  int it = 0, prev = -1;
  for (int j = 0; j < mine; ++j) {
    const Tile tl = tile_of(c, j);
    // the epilogue's own loads, in flight while the products run
    const typename Epi::Pre pre = epi.prefetch(c, tl, wg);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    // kOrdered: consumer 0 issues tile j's products first, then consumer 1
    if (turns && (wg == 1 || j > 0))
      asm volatile("bar.sync %0, %1;\n" ::"r"(4 + wg), "n"(128 * kConsumers)
                   : "memory");
    mainloop<KS, BN, KC>(c, c.op[0], wg, ring, full, empty, acc, it, prev);
    if (turns && (wg == 0 || j + 1 < mine))  // the other's turn, if any
      asm volatile("bar.arrive %0, %1;\n" ::"r"(5 - wg),
                   "n"(128 * kConsumers) : "memory");
    if constexpr (kDual) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc2[i] = 0;
      mainloop<KS, BN, KC>(c, c.op[1], wg, ring, full, empty, acc2, it,
                           prev);
    }
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc);
    if constexpr (kDual) fence_regs<BN / 2>(acc2);
    if ((threadIdx.x & 127) == 0) mbar_arrive(smem_u32(&empty[prev]));
    prev = -1;
    epi(c, tl, wg, acc, acc2, staging, params, pre);
  }
}

// The output pixel of accumulator row hf (0: d[4j], d[4j+1]; 1: d[4j+2],
// d[4j+3]) of this thread: (y, x) in the image, false past its edge.
__device__ __forceinline__ bool acc_pixel(const Core& c, const Tile& tl,
                                          int wg, int hf, int& y, int& x) {
  const int t = threadIdx.x & 127;
  y = tl.y0 + wg * 8 + 2 * (t >> 5) + hf;
  x = tl.x0 + ((t & 31) >> 2);
  return y < c.H && x < c.W;
}

// ------------------------------------------------------------ host side

// One operand: x (NHWC, pixel stride ld; kind: Kind; hin x win its
// spatial size, pooled to the output's for kI8Pool; scale for a quantize
// prologue), w (rows x ks*ks*cin int8), stages of kc channels; tma: bit 0
// A by TMA, bit 1 B by TMA.
inline Operand make_operand(const void* x, int kind, int ld, int hin, int win,
                            const void* w, int cin, int rows,
                            const float* scale, int kc, int tma) {
  Operand o = {};
  o.s.x = x;
  o.s.w = static_cast<const int8_t*>(w);
  o.s.scale = scale;
  o.s.kind = kind;
  o.s.ld = ld;
  o.s.cin = cin;
  o.s.hin = hin;
  o.s.win = win;
  const bool quant = kind == kQuantF32 || kind == kQuantBF16;
  const int elem = kind == kQuantF32 ? 4 : quant ? 2 : 1;
  o.s.va = unit_bytes(x, cin, ld, elem);
  o.s.vb = unit_bytes(w, cin, cin, 1);
  o.a_tma = tma & 1;
  o.b_tma = (tma >> 1) & 1;
  o.stages = (cin + kc - 1) / kc;
  o.wrows = rows;
  o.xi = nullptr;
  // a quantize prologue reads 8 values a 16-byte load where aligned
  o.q16 = quant && cin % 8 == 0 && ld % 8 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return o;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// An int8 tensor map of `rank` dims (innermost first), byte strides of
// dims 1.., zero fill out of bounds.
inline cudaError_t encode_i8(CUtensorMap* map, const void* base, int rank,
                             const cuuint64_t* dims,
                             const cuuint64_t* strides, const cuuint32_t* box,
                             CUtensorMapSwizzle swizzle) {
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
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                            const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of operand o: A as (cin, W, H, N) with pixel stride ld, box 16 x
// halo (1x1: 128 x tile, swizzled); B as (taps x cin, rows), box 32 (1x1:
// 128) x (BN, or BN / 2 for split rows), swizzled.
// Refuses what TMA cannot describe (the host plan routes it to threads).
template <int KS, int BN, int KC>
cudaError_t encode_operand(Maps& m, int o, const Core& c) {
  using R = Ring<KS, BN, KC>;
  const Operand& op = c.op[o];
  if (op.a_tma) {
    if (op.s.kind != kI8 || op.s.ld % 16 ||
        reinterpret_cast<uintptr_t>(op.s.x) % 16)
      return cudaErrorInvalidValue;
    const cuuint64_t dims[4] = {(cuuint64_t)op.s.cin, (cuuint64_t)c.W,
                                (cuuint64_t)c.H, (cuuint64_t)c.N};
    const cuuint64_t strides[3] = {(cuuint64_t)op.s.ld,
                                   (cuuint64_t)op.s.ld * c.W,
                                   (cuuint64_t)op.s.ld * c.W * c.H};
    const cuuint32_t box[4] = {R::kSw ? 128u : 16u, R::kHaloW, R::kHaloH, 1};
    const cudaError_t rc = encode_i8(&m.a[o], op.s.x, 4, dims, strides, box,
                                     R::kSw ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc != cudaSuccess) return rc;
  }
  if (op.b_tma) {
    const int k = R::kTaps * op.s.cin;
    if (op.s.cin % 16 || reinterpret_cast<uintptr_t>(op.s.w) % 16)
      return cudaErrorInvalidValue;
    const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)op.wrows};
    const cuuint64_t strides[1] = {(cuuint64_t)k};
    const cuuint32_t box[2] = {R::kSw ? 128u : 32u,
                               (cuuint32_t)(c.st_c ? BN / 2 : BN)};
    const cudaError_t rc = encode_i8(&m.b[o], op.s.w, 2, dims, strides, box,
                                     R::kSw ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : CU_TENSOR_MAP_SWIZZLE_32B);
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

// Fills the geometry of `c` for an (N, H, W) output, `cols` output columns
// (st_c: coupling channels, BN / 2 each a block) and `groups` blocks per
// column block; returns the grid, 0 for a bad plan.
template <int BN>
int geometry(Core& c, int N, int H, int W, int cols, int groups) {
  c.N = N;
  c.H = H;
  c.W = W;
  c.tiles_x = (W + kTW - 1) / kTW;
  c.tiles_y = (H + kTH - 1) / kTH;
  c.pixel_tiles = N * c.tiles_x * c.tiles_y;
  const int per = c.st_c ? BN / 2 : BN;
  c.nblk = (cols + per - 1) / per;
  if (groups < 1 || groups > c.pixel_tiles) return 0;
  c.groups = groups;
  return groups * c.nblk;
}

// Launches `kern` with the ring of c.stages slots and `staging` bytes after
// it, after encoding both operands' maps.
template <int KS, int BN, int KC, class K, class A>
cudaError_t launch(K kern, const A& args, Core& c, int grid, int staging,
                   cudaStream_t s) {
  using R = Ring<KS, BN, KC>;
  const size_t smem = (size_t)kAlign + (size_t)c.stages * R::kSlot +
                     kParamBytes + (size_t)staging;
  if (c.stages < 2 || c.stages > kMaxStages || grid < 1 ||
      smem + kStaticSmem > (size_t)kSmemLimit)
    return cudaErrorInvalidValue;
  Maps m = {};
  for (int o = 0; o < 2; ++o) {
    if (c.op[o].stages == 0) continue;
    const cudaError_t rc = encode_operand<KS, BN, KC>(m, o, c);
    if (rc != cudaSuccess) return rc;
  }
  c.threads_load = 0;
  for (int o = 0; o < 2; ++o)
    if (c.op[o].stages && (!c.op[o].a_tma || !c.op[o].b_tma))
      c.threads_load = 1;
  // thread-loaded stages arrive one stage late and consumers release one
  // stage late: two slots would wait on each other
  if (c.threads_load && c.stages < 3) return cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  kern<<<grid, kThreads, smem, s>>>(args, c, m);
  return cudaGetLastError();
}

}  // namespace qwg
}  // namespace vwfd
