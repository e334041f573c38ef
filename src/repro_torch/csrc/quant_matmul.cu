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
// Ragged M, K and N are masked while the tiles load: no padded copies.
//
// What bounds it on this card: at the paper's linear shapes (K, N <= 64,
// M = 16,384) the work is ~2*M*N*K int ops, far below the int8 rate; the
// bytes are x (M*K), w (K*N) and the f32 output (M*N*4), so it is memory
// (and, at these sizes, launch) bound. The design is the packed kernel's
// without the unpack: one block computes a 64 x 64 output tile with 256
// threads, each a 4 x 4 register micro-tile of int32 multiply-adds, K
// advancing 32 codes at a time through shared memory; each input is read
// once per output tile and each output written once. Tensor-core (s8 MMA)
// tiles are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int TK = 32;   // K codes per step
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
qmm_kernel(const int8_t* __restrict__ x,
           const int8_t* __restrict__ w,
           const float* __restrict__ sx_p,
           const float* __restrict__ sw_p,
           const int32_t* __restrict__ zx_p,
           float* __restrict__ out,
           int M, int K, int N) {
  __shared__ int xs[BM][TK + 1];
  __shared__ int ws[TK][BN];
  __shared__ int colsum[BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column quad
  const int ty = tid / 16;  // row quad
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int zx = *zx_p;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0;
  int csum = 0;

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < BM * TK; e += THREADS) {
      const int r = e / TK, j = e % TK;
      const int m = m0 + r, k = k0 + j;
      xs[r][j] = (m < M && k < K) ? (int)x[(size_t)m * K + k] : 0;
    }
    for (int e = tid; e < TK * BN; e += THREADS) {
      const int j = e / BN, c = e % BN;
      const int n = n0 + c, k = k0 + j;
      ws[j][c] = (n < N && k < K) ? (int)w[(size_t)k * N + n] : 0;
    }
    __syncthreads();

    if (tid < BN) {
      int s = 0;
#pragma unroll 8
      for (int j = 0; j < TK; ++j) s += ws[j][tid];
      csum += s;
    }
#pragma unroll 4
    for (int j = 0; j < TK; ++j) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty * 4 + i][j];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = ws[j][tx * 4 + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] += a[i] * b[c];
    }
    __syncthreads();
  }
  if (tid < BN) colsum[tid] = csum;
  __syncthreads();

  const float sx = *sx_p, sw = *sw_p;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n >= N) continue;
      const int v = acc[i][c] - zx * colsum[tx * 4 + c];
      out[(size_t)m * N + n] =
          __fmul_rn(__fmul_rn(__int2float_rn(v), sx), sw);
    }
  }
}

}  // namespace

extern "C" int repro_quant_matmul(const void* x, const void* w,
                                  const void* sx, const void* sw,
                                  const void* zx, void* out, int M, int K,
                                  int N, void* stream) {
  if (M > 0 && N > 0) {
    dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    qmm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x, (const int8_t*)w, (const float*)sx,
        (const float*)sw, (const int32_t*)zx, (float*)out, M, K, N);
  }
  return (int)cudaGetLastError();
}
