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
// What bounds it on this card: bytes. At the serve shapes (M = 16,384,
// K <= 64, N <= 64) the work is at most 67 M multiply-adds, a few
// microseconds on the CUDA cores but well under one on the s8 tensor
// cores, and the bytes are x (M * K) and the f32 output (M * N * 4, three
// quarters of the traffic); the packed weight is at most 2 KB. At one
// linear's size the fixed cost of a launch is as large as the bytes.
//
// Design (the tile machinery is qmm_tile.cuh, shared with quant_matmul.cu):
//   - the weight is unpacked once per block: four lanes per (32-code
//     group, column) read that column's `bits` plane words once each,
//     share them by shuffles, and write 32 clipped, K-masked s8 codes into
//     the K-contiguous weight stage (the layout the MMA's B fragment
//     reads), adding their sum to the column's colsum;
//   - x.q on the s8 tensor cores (mma.sync m16n8k32), N tiled in
//     multiples of 8 (N = 3 computes 8 columns, not 64);
//   - x tiles of 128 rows are one flat byte range each, copied by
//     cp.async as wide as x's alignment allows, in a ring of two tiles
//     while the block walks its M tiles; the output tile goes out through
//     shared memory as one flat range of 16-byte stores.
// The tile rows, blocks per SM and ring depth are constants of
// qmm_tile.cuh, chosen from timings on an H100 (PERF.md); the entry point
// derives the grid and shared bytes from (M, K, N) and the SM count.
#include "qmm_tile.cuh"

namespace {

// Spread the 4 bits of n to bit 0 of four bytes: i + 7 * i = 8 * i, and no
// two products of the multiply land on the same bit.
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

struct PackedStage {
  const int32_t* words;
  int K, N, bits, gpt, offset;

  // Four lanes per (32-code group, column): lane j reads planes j and
  // j + 4 (each word once), the four swap them by shuffles, and lane j
  // unpacks codes [8j, 8j + 8) of the group.
  __device__ __forceinline__ void operator()(int8_t* ws, int ws_stride,
                                             int* colsum, int k0, int kpad,
                                             int n0, int nw, int ncols,
                                             bool add_colsum) const {
    const int g0 = k0 / qmm::KSTEP, total = kpad / qmm::KSTEP * ncols * 4;
    const int lane = threadIdx.x & 31, j = lane & 3;
    for (int base = threadIdx.x & ~31; base < total; base += blockDim.x) {
      const int e = base + lane, task = e >> 2;
      const int c = task % ncols, g = g0 + task / ncols;
      const bool live = e < total && c < nw;
      uint32_t mine[2] = {0u, 0u};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = j + 4 * h;
        if (live && p < bits) {
          const int row = gpt ? (g / gpt) * gpt * bits + p * gpt + g % gpt
                              : g * bits + p;
          mine[h] = (uint32_t)__ldg(&words[(size_t)row * N + n0 + c]);
        }
      }
      uint32_t u[2] = {0u, 0u};  // byte b of u[h]: unsigned code 8j+4h+b
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        if (p < bits) {
          const uint32_t plane = __shfl_sync(0xffffffffu, mine[p >> 2],
                                             (lane & ~3) | (p & 3));
          u[0] |= spread4((plane >> (8 * j)) & 0xFu) << p;
          u[1] |= spread4((plane >> (8 * j + 4)) & 0xFu) << p;
        }
      }
      const int valid = live ? K - g * qmm::KSTEP - 8 * j : 0;
      uint32_t word[2] = {0u, 0u};
      int sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        int q = (int)((u[i / 4] >> (8 * (i % 4))) & 0xFFu) + offset;
        q = q < -128 ? -128 : (q > 127 ? 127 : q);
        q = i < valid ? q : 0;  // rows >= K are 0
        sum += q;
        word[i / 4] |= ((uint32_t)q & 0xFFu) << (8 * (i % 4));
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (e < total)
        *reinterpret_cast<uint2*>(ws + c * ws_stride + (g - g0) * qmm::KSTEP +
                                  8 * j) = make_uint2(word[0], word[1]);
      if (add_colsum && live && j == 0 && sum) atomicAdd(&colsum[c], sum);
    }
  }
};

__global__ void __launch_bounds__(qmm::THREADS)
qmm_packed_kernel(const int8_t* __restrict__ x,
                  const int32_t* __restrict__ words,
                  const int32_t* __restrict__ offset_p,
                  const float* __restrict__ sx_p,
                  const float* __restrict__ sw_p,
                  const int32_t* __restrict__ zx_p, float* __restrict__ out,
                  int M, int K, int N, int bits, int gpt) {
  const PackedStage stage{words, K, N, bits, gpt, *offset_p};
  qmm::tiles(stage, x, sx_p, sw_p, zx_p, out, M, K, N);
}

}  // namespace

extern "C" int repro_quant_matmul_packed(
    const void* x, const void* words, const void* offset, const void* sx,
    const void* sw, const void* zx, void* out, int M, int K, int N, int bits,
    int groups_per_tile, int n_sm, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (bits < 1 || bits > 8) return (int)cudaErrorInvalidValue;
  return qmm::launch<qmm_packed_kernel>(
      qmm::Plan(M, K, N, n_sm), stream, (const int8_t*)x,
      (const int32_t*)words, (const int32_t*)offset, (const float*)sx,
      (const float*)sw, (const int32_t*)zx, (float*)out, M, K, N, bits,
      groups_per_tile);
}
