// Tile machinery shared by the two quantized-matmul kernels for Hopper
// (sm_90a): quant_matmul_packed.cu and quant_matmul.cu.
//
// Both compute f32 out (M, N) = ((x - zx) @ q) * sx * sw with x int8
// activation codes (M, K, contiguous) and q int8 weight codes (K, N). They
// differ only in where q comes from (sub-byte bit-plane words, or an int8
// matrix): each .cu file supplies a Stage functor that writes q into the
// block's weight stage; everything else is here, the launch plan included.
//
// The sum is exact int32 arithmetic, x.q - zx * colsum(q): the x.q part on
// the s8 tensor cores (mma.sync m16n8k32, s32 accumulators), colsum from
// the weight stage. The result is converted with __int2float_rn and scaled
// with __fmul_rn by sx then sw, in that order: bit-equal to the plain
// PyTorch versions.
//
// A block owns BM output rows at a time (one warp per 16 rows) and up to
// tile_cols(N) <= 64 output columns (blockIdx.y picks them). Shared memory
// holds:
//   - the x tiles, each BM rows of x staged as one flat byte range
//     (row r at r * xs_stride; xs_stride = K when K fits one chunk),
//     followed by slack for padded-K reads;
//   - the weight stage: column c's codes K-contiguous at c * ws_stride,
//     ws_stride = kc + 16 bytes (= 16 mod 32, so the eight columns a B
//     fragment reads fall on distinct banks), rows >= K zero, padded to a
//     multiple of 32 so that padded x columns meet zero codes whatever
//     they hold;
//   - the f32 output tile, flat (row r, column c at r * nw + c);
//   - colsum(q) of the block's columns.
// When K fits one chunk (K <= kc), the weight is staged once and the block
// walks M tiles blockIdx.x, +gridDim.x, ... with a ring of STAGES x tiles
// in flight by cp.async. Larger K loops over chunks of kc codes, staging
// the weight and the x rows of each chunk in turn (no ring).
//
// The tuned constants: BM = 128 rows a tile, about BLOCKS_PER_SM = 2
// blocks an SM in the grid, a ring of STAGES = 2 x tiles.
// scripts/torch_qmm_tune.py times copies of this header with others (an
// H100's times are in PERF.md): at the five NeRF linears, BM 64 read
// 4-22 % slower than BM 128 on the packed kernel and BM 32 20-75 %; at
// BM 128 the blocks per SM (1, 2, 4) and the depth (1-3) moved the time
// by under 3 %, since at M = 16,384 each block holds one tile.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm {

constexpr int BM = 128;           // rows a tile: one warp per 16 rows
constexpr int BLOCKS_PER_SM = 2;  // blocks an SM the grid aims for
constexpr int STAGES = 2;         // x tiles in flight when K fits a chunk
constexpr int THREADS = BM * 2;
constexpr int KSTEP = 32;    // K codes per mma.sync m16n8k32
constexpr int BN_MAX = 64;   // output columns a block holds
constexpr int NT_MAX = BN_MAX / 8;
constexpr int KC_MAX = 256;  // K codes a block stages at once
constexpr int WS_PAD = 16;   // bytes after each staged weight column
constexpr int X_SLACK = 48;  // bytes after an x tile: padded-K reads
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Output columns a block holds: N in multiples of 8, at most BN_MAX.
__host__ __device__ constexpr int tile_cols(int N) {
  return N < BN_MAX ? round_up(N < 1 ? 1 : N, 8) : BN_MAX;
}

// K codes a block stages at once: K in multiples of 32, at most KC_MAX.
__host__ __device__ constexpr int chunk(int K) {
  return K < KC_MAX ? round_up(K < 1 ? 1 : K, KSTEP) : KC_MAX;
}

// Byte offsets of the shared-memory regions of an (M, K) x (K, N) product
// (host and device alike).
struct SmemLayout {
  int bn = 0, kc = 0, xs_stride = 0, x_stage = 0, ws_stride = 0,
      off_ws = 0, off_out = 0, off_colsum = 0, total = 0;
  __host__ __device__ constexpr SmemLayout(int K, int N)
      : bn(tile_cols(N)), kc(chunk(K)) {
    xs_stride = K <= kc ? K : kc;
    x_stage = round_up(BM * xs_stride + X_SLACK, 16);
    ws_stride = kc + WS_PAD;
    off_ws = (K <= kc ? STAGES : 1) * x_stage;
    off_out = off_ws + round_up(bn * ws_stride, 16);
    off_colsum = off_out + BM * bn * 4;
    total = off_colsum + bn * 4;
  }
};

// The largest layouts (the ring at one full chunk, one chunk of a longer
// K) fit a block.
static_assert(SmemLayout(KC_MAX, BN_MAX).total <= SMEM_MAX &&
                  SmemLayout(KC_MAX + 1, BN_MAX).total <= SMEM_MAX,
              "the shared-memory layout outgrows a block");

// The launch of an (M, K) x (K, N) product on a card of n_sm SMs: column
// tiles along y, and about BLOCKS_PER_SM * n_sm blocks in all, each
// walking the M tiles of its column tile gridDim.x apart.
struct Plan {
  dim3 grid;
  int smem;
  Plan(int M, int K, int N, int n_sm) {
    const SmemLayout L(K, N);
    const int grid_y = (N + L.bn - 1) / L.bn;
    const int m_tiles = (M + BM - 1) / BM;
    const int per_column_tile = (BLOCKS_PER_SM * n_sm + grid_y - 1) / grid_y;
    const int grid_x = m_tiles < per_column_tile ? m_tiles : per_column_tile;
    grid = dim3(grid_x > 1 ? grid_x : 1, grid_y);
    smem = L.total;
  }
};

// Launch Kernel, opting in once to the largest dynamic shared memory it
// has been asked for above the default 48 KB.
template <auto Kernel, class... A>
int launch(const Plan& p, void* stream, A... args) {
  static int opted = 48 * 1024;
  if (p.smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
    opted = p.smem;
  }
  Kernel<<<p.grid, THREADS, p.smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of one W-byte piece, `src_bytes` of it read and the rest zeroed.
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(W), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` committed groups are still in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// The widest copy piece (16, 8, 4 or 1 bytes) that `p` is aligned to.
__device__ __forceinline__ int copy_width(const void* p) {
  const uintptr_t a = (uintptr_t)p;
  return (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4 : 1;
}

template <int W>
__device__ __forceinline__ void copy_pieces(int8_t* dst, const int8_t* src,
                                            int n, int i0, int step) {
  for (int i = i0 * W; i < n; i += step * W)
    cp_async<W>(dst + i, src + i, min(W, n - i));
}

// Copy n bytes from src into shared memory at dst (16-byte aligned), in
// pieces as wide as src's alignment allows: piece i0, i0 + step, ...
// Byte-aligned sources are copied by plain loads and stores.
__device__ __forceinline__ void copy_range(int8_t* dst, const int8_t* src,
                                           int n, int w, int i0, int step) {
  switch (w) {
    case 16: copy_pieces<16>(dst, src, n, i0, step); break;
    case 8: copy_pieces<8>(dst, src, n, i0, step); break;
    case 4: copy_pieces<4>(dst, src, n, i0, step); break;
    default:
      for (int i = i0; i < n; i += step) dst[i] = __ldg(src + i);
  }
}

// Four bytes of shared memory at p; p may be unaligned when `aligned` is
// false (two aligned words and a funnel shift).
__device__ __forceinline__ uint32_t lds32(const int8_t* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint32_t*>(p);
  const uintptr_t a = (uintptr_t)p;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  return __funnelshift_r(w[0], w[1], (uint32_t)(a & 3) * 8);
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc += x rows [16 * warp, +16) of the staged tile . weight columns
// [0, 8 * nt), over K codes [0, kpad) of the stage.
__device__ __forceinline__ void mma_tile(const int8_t* xs, int xs_stride,
                                         const int8_t* ws, int ws_stride,
                                         int kpad, int nt,
                                         int (&acc)[NT_MAX][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool aligned = (xs_stride & 3) == 0;
  const int8_t* xa = xs + (warp * 16 + g) * xs_stride + t * 4;
  const int8_t* xb = xa + 8 * xs_stride;
  const int8_t* wb = ws + g * ws_stride + t * 4;
  for (int k = 0; k < kpad; k += KSTEP) {
    const uint32_t a0 = lds32(xa + k, aligned), a1 = lds32(xb + k, aligned);
    const uint32_t a2 = lds32(xa + k + 16, aligned);
    const uint32_t a3 = lds32(xb + k + 16, aligned);
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) {
      if (j < nt) {
        const int8_t* b = wb + j * 8 * ws_stride + k;
        mma_s8(acc[j], a0, a1, a2, a3,
               *reinterpret_cast<const uint32_t*>(b),
               *reinterpret_cast<const uint32_t*>(b + 16));
      }
    }
  }
}

// Scale the accumulators into the flat output tile os[r * nw + c].
__device__ __forceinline__ void epilogue(int (&acc)[NT_MAX][4],
                                         const int* colsum, float* os,
                                         int nw, int nt, int zx, float sx,
                                         float sw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NT_MAX; ++j) {
    if (j >= nt) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j * 8 + (lane & 3) * 2 + (e & 1);
      if (c < nw) {
        const int v = acc[j][e] - zx * colsum[c];
        os[(r0 + (e >> 1) * 8) * nw + c] =
            __fmul_rn(__fmul_rn(__int2float_rn(v), sx), sw);
      }
    }
  }
}

// Store `rows` rows of the output tile at row m0, columns [n0, n0 + nw):
// one flat range of 16-byte stores when the block holds every column.
__device__ __forceinline__ void store_tile(const float* os, float* out,
                                           int m0, int rows, int n0, int nw,
                                           int N) {
  const int tid = threadIdx.x, step = blockDim.x;
  if (nw == N) {
    float* dst = out + (size_t)m0 * N;
    const int n = rows * N;
    int head = 0;
    if (((uintptr_t)dst & 15) == 0) {
      head = n & ~3;
      for (int i = tid * 4; i < head; i += step * 4)
        *reinterpret_cast<float4*>(dst + i) =
            *reinterpret_cast<const float4*>(os + i);
    }
    for (int i = head + tid; i < n; i += step) dst[i] = os[i];
  } else {
    for (int i = tid; i < rows * nw; i += step) {
      const int r = i / nw;
      out[(size_t)(m0 + r) * N + n0 + (i - r * nw)] = os[i];
    }
  }
}

// The whole kernel: every M tile of this block against its columns.
// `stage(ws, ws_stride, colsum, k0, kpad, n0, nw, ncols, add_colsum)`
// writes the weight codes of rows [k0, k0 + kpad) and columns
// [n0, n0 + ncols) (zero past K and past nw), adding each column's sum to
// colsum when add_colsum holds.
template <class Stage>
__device__ __forceinline__ void tiles(const Stage& stage,
                                      const int8_t* __restrict__ x,
                                      const float* sx_p, const float* sw_p,
                                      const int32_t* zx_p,
                                      float* __restrict__ out, int M, int K,
                                      int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemLayout L(K, N);
  const int bn = L.bn, kc = L.kc;
  int8_t* xs = reinterpret_cast<int8_t*>(smem);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + L.off_ws);
  float* os = reinterpret_cast<float*>(smem + L.off_out);
  int* colsum = reinterpret_cast<int*>(smem + L.off_colsum);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * bn;
  const int nw = min(bn, N - n0);
  const int nt = (nw + 7) / 8;
  const int m_tiles = (M + BM - 1) / BM;
  const int zx = *zx_p;
  const float sx = *sx_p, sw = *sw_p;
  auto zero_colsum = [&]() {
    for (int c = tid; c < bn; c += THREADS) colsum[c] = 0;
    __syncthreads();
  };
  int acc[NT_MAX][4];
  if (K <= kc) {
    // One chunk: the weight is staged once; x tiles stream through a ring
    // whose first tiles are in flight while the weight is staged.
    const int kpad = round_up(K, KSTEP);
    const int w = copy_width(x);  // every tile starts at a multiple of 16
    auto load = [&](int i) {      // x tile of this block's i-th step
      const int t = blockIdx.x + i * gridDim.x;
      if (t < m_tiles) {
        const int m0 = t * BM;
        copy_range(xs + (i % STAGES) * L.x_stage, x + (size_t)m0 * K,
                   min(BM, M - m0) * K, w, tid, THREADS);
      }
      cp_async_commit();
    };
    for (int i = 0; i < (STAGES > 1 ? STAGES - 1 : 1); ++i) load(i);
    zero_colsum();
    stage(ws, L.ws_stride, colsum, 0, kpad, n0, nw, nt * 8, true);
    int i = 0;
    for (int t = blockIdx.x; t < m_tiles; t += gridDim.x, ++i) {
      if constexpr (STAGES > 1) load(i + STAGES - 1);
      else if (i > 0) load(i);
      cp_async_wait<STAGES - 1>();
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NT_MAX; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
      mma_tile(xs + (i % STAGES) * L.x_stage, L.xs_stride, ws, L.ws_stride,
               kpad, nt, acc);
      epilogue(acc, colsum, os, nw, nt, zx, sx, sw);
      __syncthreads();
      const int m0 = t * BM;
      store_tile(os, out, m0, min(BM, M - m0), n0, nw, N);
    }
    cp_async_wait<0>();
  } else {
    // Chunks of kc codes: stage each chunk's weight and x rows in turn.
    zero_colsum();
    for (int t = blockIdx.x; t < m_tiles; t += gridDim.x) {
      const int m0 = t * BM, rows = min(BM, M - m0);
#pragma unroll
      for (int j = 0; j < NT_MAX; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
      for (int k0 = 0; k0 < K; k0 += kc) {
        const int kv = min(kc, K - k0), kpad = round_up(kv, KSTEP);
        __syncthreads();  // the last chunk's readers are done
        for (int r = warp; r < rows; r += THREADS / 32) {
          const int8_t* src = x + (size_t)(m0 + r) * K + k0;
          copy_range(xs + r * kc, src, kv, copy_width(src), lane, 32);
        }
        cp_async_commit();
        stage(ws, L.ws_stride, colsum, k0, kpad, n0, nw, nt * 8,
              t == (int)blockIdx.x);
        cp_async_wait<0>();
        __syncthreads();
        mma_tile(xs, kc, ws, L.ws_stride, kpad, nt, acc);
      }
      epilogue(acc, colsum, os, nw, nt, zx, sx, sw);
      __syncthreads();
      store_tile(os, out, m0, rows, n0, nw, N);
    }
  }
}

}  // namespace qmm
