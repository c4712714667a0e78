// K25 `blockdct`: the orthonormal 8×8 DCT-II of every block of float32
// planes, on the host: (n, h, w) -> (n, h/8, w/8, 64), each block's 64
// coefficients row-major (u, v).
//
// Replaces csrc/blockdct.cpp::blockwise_dct8 / blockwise_dct8_batch (:35-75,
// bound by vwfd_tpu/native.py) and its numpy fallback
// vwfd_tpu/data/jpeg_data.py::blockwise_dct_np (:39-51): the DCT-domain
// data pipeline (DCTDomainDataset) runs it on the host, one item at a time.
//
// Per block B: T = C·B (columns), then T·Cᵀ (rows), each coefficient an
// 8-term sum in index order with one rounding a product and a sum (built
// with -ffp-contract=off: no FMA contraction, so the result does not depend
// on the host's instruction set). C is the float32 DCT matrix built in
// double (vwfd_tpu_torch/ops/dct.py::_dct_matrix_np).
//
// Bound: bytes or operations of the host: 1,024 multiply-adds a block
// (2 passes × 64 outputs × 8 terms), 8 bytes a pixel in and out.
//
// C interface, loaded with ctypes by vwfd_tpu_torch/native.py, which
// builds it with the system g++ into build/vwfd_tpu_torch/ at first use.
#include <cmath>

namespace {

struct Dct {
  float c[8][8];
  Dct() {
    const double pi = 3.14159265358979323846;
    for (int j = 0; j < 8; ++j) c[0][j] = (float)std::sqrt(1.0 / 8.0);
    for (int i = 1; i < 8; ++i)
      for (int j = 0; j < 8; ++j)
        c[i][j] = (float)(std::cos(pi * i * (2 * j + 1) / 16.0) *
                          std::sqrt(2.0 / 8.0));
  }
};
const Dct kDct;

void plane_dct(const float* p, int h, int w, float* out) {
  const int bh = h / 8, bw = w / 8;
  float t[8][8];
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bw; ++bx) {
      const float* src = p + (long long)by * 8 * w + bx * 8;
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) {
          float acc = 0.f;
          for (int k = 0; k < 8; ++k) acc += kDct.c[i][k] * src[k * w + j];
          t[i][j] = acc;
        }
      float* dst = out + ((long long)by * bw + bx) * 64;
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) {
          float acc = 0.f;
          for (int k = 0; k < 8; ++k) acc += t[i][k] * kDct.c[j][k];
          dst[i * 8 + j] = acc;
        }
    }
  }
}

}  // namespace

extern "C" {

// planes (n, h, w) row-major float32, h and w multiples of 8; out
// (n, h/8, w/8, 64). Returns 0, or 1 for a shape it does not take.
int vwfd_blockdct(const float* planes, int n, int h, int w, float* out) {
  if (n < 0 || h < 0 || w < 0 || h % 8 || w % 8) return 1;
  const long long in_sz = (long long)h * w, out_sz = in_sz;  // 64 per 64
  for (int i = 0; i < n; ++i) plane_dct(planes + i * in_sz, h, w,
                                        out + i * out_sz);
  return 0;
}

}  // extern "C"
