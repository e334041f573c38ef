// Quantized matmul over unpacked int8 weights for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quant_matmul.py:_qmm_kernel, reached through
// quant_matmul.
//
// Computes f32 out (M, N) = ((x - zx) @ w) * sx * sw, with x int8 activation
// codes (M, K) and w int8 weight codes (K, N), both row-major. The sum is
// exact int32 arithmetic (x.w - zx * colsum(w)), converted to f32 and scaled
// by sx then sw with __fmul_rn, in the reference's order, so the result is
// bit-equal to the plain PyTorch version and to the reference's oracle.
//
// What bounds it on this card: bytes. At the paper's linear shapes (K, N <=
// 64, M = 16,384) the work is at most 67 M multiply-adds, well under a
// microsecond on the s8 tensor cores; the bytes are x (M * K), w (K * N)
// and the f32 output (M * N * 4, three quarters of the traffic), and at
// one linear's size the fixed cost of a launch is as large as the bytes.
//
// Design: the packed kernel's (qmm_tile.cuh) without the unpack. Each block
// stages its columns of w once, transposed to K-contiguous s8 columns (the
// MMA's B fragment layout; one thread per 16 codes of a column, reads
// coalesced along N), with each column's colsum; x.w runs on the s8 tensor
// cores (mma.sync m16n8k32) over N tiled in multiples of 8; x tiles of BM
// rows stream in as flat byte ranges through a cp.async ring while the
// block walks its M tiles; the output leaves through shared memory as one
// flat range of 16-byte stores. Ragged M, K and N are masked in the
// kernel: no padded copies. K beyond one chunk of the stage (256 codes)
// loops over chunks. The tile's constants and the launch plan are
// qmm_tile.cuh's, timed in PERF.md.
#include "qmm_tile.cuh"

namespace {

struct Int8Stage {
  const int8_t* w;
  int K, N;

  // One thread per (16 codes of K, column): its 16 loads (coalesced along
  // N across the warp) are all in flight before any is used.
  __device__ __forceinline__ void operator()(int8_t* ws, int ws_stride,
                                             int* colsum, int k0, int kpad,
                                             int n0, int nw, int ncols,
                                             bool add_colsum) const {
    constexpr int R = 16;
    const int runs = kpad / R;
    for (int e = threadIdx.x; e < runs * ncols; e += blockDim.x) {
      const int c = e % ncols, k = k0 + (e / ncols) * R;
      int q[R];
#pragma unroll
      for (int b = 0; b < R; ++b)
        q[b] = c < nw && k + b < K
                   ? (int)__ldg(&w[(size_t)(k + b) * N + n0 + c]) : 0;
      uint32_t word[R / 4] = {0, 0, 0, 0};
      int sum = 0;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        sum += q[b];
        word[b / 4] |= ((uint32_t)q[b] & 0xFFu) << (8 * (b % 4));
      }
      *reinterpret_cast<uint4*>(ws + c * ws_stride + (k - k0)) =
          make_uint4(word[0], word[1], word[2], word[3]);
      if (add_colsum && sum) atomicAdd(&colsum[c], sum);
    }
  }
};

__global__ void __launch_bounds__(qmm::THREADS)
qmm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ sx_p, const float* __restrict__ sw_p,
           const int32_t* __restrict__ zx_p, float* __restrict__ out, int M,
           int K, int N) {
  const Int8Stage stage{w, K, N};
  qmm::tiles(stage, x, sx_p, sw_p, zx_p, out, M, K, N);
}

}  // namespace

extern "C" int repro_quant_matmul(const void* x, const void* w,
                                  const void* sx, const void* sw,
                                  const void* zx, void* out, int M, int K,
                                  int N, int n_sm, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  return qmm::launch<qmm_kernel>(
      qmm::Plan(M, K, N, n_sm), stream, (const int8_t*)x, (const int8_t*)w,
      (const float*)sx, (const float*)sw, (const int32_t*)zx, (float*)out, M,
      K, N);
}
