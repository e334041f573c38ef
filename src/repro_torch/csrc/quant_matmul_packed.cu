// Packed-weight quantized matmul for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quant_matmul.py:_qmm_packed_kernel (with its
// _unpack_tile / _unpack_tile_native helpers), reached through
// quant_matmul_packed.
//
// Computes f32 out (M, N) = ((x - zx) @ q) * sx * sw, where x is an int8
// activation-code matrix (M, K) and q the weight codes unpacked from
// sub-byte bit-plane words: q = clip(u + offset, -128, 127) with rows >= K
// forced to 0. The sum is exact int32 arithmetic (x.q - zx * colsum(q)),
// converted to f32 and scaled by sx then sw, in that order, so the result
// is bit-equal to the plain PyTorch version.
//
// Word layouts (groups of 32 codes along K; `bits` plane words per group):
//   planar  (groups_per_tile == 0): row g * bits + p holds plane p of group g;
//   tile:bk (groups_per_tile == bk / 32 = gt): row
//           (g / gt) * gt * bits + p * gt + (g % gt).
//
// What bounds it on this card: at the serve shapes (K <= 64, N <= 64,
// M up to 16,384) the work is ~2*M*N*K int ops, far below the int8 rate;
// the bytes are x (M*K) and the f32 output (M*N*4), so it is memory (and,
// at one slot's size, launch) bound. The design therefore keeps the packed
// words as the only weight traffic (unpack-on-load into shared memory),
// reads x once per output tile column block, and writes the output once.
// One block computes a 64 x 64 output tile with 256 threads, each a 4 x 4
// register micro-tile of int32 multiply-accumulates; K advances one
// 32-code group at a time. Tensor-core (wgmma / mma.sync s8) variants are
// later work: at these K the MMA would idle on the unpack.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int TG = 32;   // K codes per group (one bit-plane word)
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
qmm_packed_kernel(const int8_t* __restrict__ x,
                  const int32_t* __restrict__ words,
                  const int32_t* __restrict__ offset_p,
                  const float* __restrict__ sx_p,
                  const float* __restrict__ sw_p,
                  const int32_t* __restrict__ zx_p,
                  float* __restrict__ out,
                  int M, int K, int N, int bits, int gpt) {
  __shared__ int xs[BM][TG + 1];
  __shared__ int ws[TG][BN];
  __shared__ int colsum[BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column quad
  const int ty = tid / 16;  // row quad
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int off = *offset_p;
  const int zx = *zx_p;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0;
  int csum = 0;

  const int n_groups = (K + TG - 1) / TG;
  for (int g = 0; g < n_groups; ++g) {
    // Activation codes of this K group (zero past M or K).
    for (int e = tid; e < BM * TG; e += THREADS) {
      const int r = e / TG, j = e % TG;
      const int m = m0 + r, k = g * TG + j;
      xs[r][j] = (m < M && k < K) ? (int)x[(size_t)m * K + k] : 0;
    }
    // Unpack-on-load: plane words -> signed, clipped, K-masked codes.
    for (int e = tid; e < TG * BN; e += THREADS) {
      const int j = e / BN, c = e % BN;
      const int n = n0 + c, k = g * TG + j;
      int q = 0;
      if (n < N && k < K) {
        unsigned u = 0;
        for (int p = 0; p < bits; ++p) {
          const int row = gpt ? (g / gpt) * gpt * bits + p * gpt + (g % gpt)
                              : g * bits + p;
          const unsigned w = (unsigned)__ldg(&words[(size_t)row * N + n]);
          u |= ((w >> j) & 1u) << p;
        }
        q = (int)u + off;
        q = q < -128 ? -128 : (q > 127 ? 127 : q);
      }
      ws[j][c] = q;
    }
    __syncthreads();

    if (tid < BN) {
      int s = 0;
#pragma unroll 8
      for (int j = 0; j < TG; ++j) s += ws[j][tid];
      csum += s;
    }
#pragma unroll 4
    for (int j = 0; j < TG; ++j) {
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

extern "C" int repro_quant_matmul_packed(
    const void* x, const void* words, const void* offset, const void* sx,
    const void* sw, const void* zx, void* out, int M, int K, int N, int bits,
    int groups_per_tile, void* stream) {
  if (M > 0 && N > 0) {
    dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    qmm_packed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x, (const int32_t*)words, (const int32_t*)offset,
        (const float*)sx, (const float*)sw, (const int32_t*)zx, (float*)out,
        M, K, N, bits, groups_per_tile);
  }
  return (int)cudaGetLastError();
}
