// Flash-attention backward (grouped-query, causal or full) for Hopper
// (sm_90a).
//
// Replaces: nothing in Pallas. The reference's flash kernel
// (src/repro/kernels/flash_attention_kernel.py:flash_attention) has no
// custom_vjp; the reference trains through XLA's autodiff of its plain jnp
// attention (src/repro/models/attention.py:75). This is the gradient of the
// port's forward kernel (csrc/flash_attention.cu), so that a loss on the
// card differentiates through it.
//
// Operands, as the forward takes them: q (B, Hkv, S, G, hd), k and v
// (B, Hkv, Sk, hd) in float32 or bfloat16, the forward's f32 output o
// (B, Hkv, S, G, hd) and the f32 gradient dO of the same shape, every one
// addressed through its strides (the innermost axis contiguous); lse
// (B, Hkv, S, G) f32, the per-row log-sum-exp m + log l that the forward
// wrote. Outputs dq, dk, dv in the inputs' dtype, through their strides;
// dk and dv sum over the G query heads of their KV head.
//
// For each query row i and key j (s_ij = scale q_i . k_j, masked entries
// as in the forward: keys >= Sk, and keys after the row's position when
// causal):
//   P_ij  = exp(s_ij - lse_i)          recomputed, never stored;
//   D_i   = dO_i . o_i                 (bwd_delta_kernel, f32);
//   dP_ij = dO_i . v_j;   dS_ij = P_ij (dP_ij - D_i);
//   dv_j  = sum_i round_v(P_ij) dO_i   (round_v: to v's dtype, as the
//                                       forward rounds p before P V);
//   dk_j  = scale sum_i dS_ij q_i;     dq_i = scale sum_j dS_ij k_j.
// This is the gradient autograd takes of the plain version
// (flash_attention_plain): in float32 exactly that function; in bfloat16
// the plain version also rounds the unnormalised p (and, in its backward,
// dP) to bf16 at the row's maximum, which moves the result by a few bf16
// ulps.
//
// No atomics on either route: every sum is taken in a fixed order inside
// one block, so the gradient is the same bits on every run (a resumed
// training run repeats the uninterrupted one). Three kernels a call: the
// pre-pass `bwd_delta_kernel` (one warp a row, D = rowsum(dO * o) in f32),
// then a dK/dV kernel (a block owns a key tile of one (batch, KV head) and
// walks the tiles of 64 query rows; rows are the flattened (position,
// head-in-group) pairs, as in the forward, so the G heads of the KV head
// are summed by the walk itself, with no reduction across blocks; causal
// walks start at the first row that can see the tile), then a dQ kernel (a
// block owns a query-row tile and walks the key tiles up to the diagonal
// when causal, or to Sk; longest tiles first). Each recomputes S and dP, so
// the route does 7 products of S x Sk x hd where 5 are the least (S, dP,
// dV, dK, dQ): the price of needing no atomics.
//
// The dtype decides the route; neither gives way to the other:
//
// - bfloat16: `bwd_dkdv_tc_kernel` and `bwd_dq_tc_kernel`, every product
//   on the tensor cores (wgmma), from the forward's building blocks
//   (wgmma_tile.cuh). Tiles are 128-byte-swizzled panels of 64 rows, hd
//   zero-padded to HDP = 64 (hd <= 64) or 128, a template parameter.
//   dK/dV, per warpgroup of 64 keys and each 64-row tile: S^T = K Q^T and
//   dP^T = V dO^T with both operands K-major in shared memory (m64n64k16);
//   P^T = 2^(s scale log2 e - lse log2 e) and dS^T = P^T (dP^T - D) in
//   registers; dV += P^T dO and dK += dS^T Q with the accumulators
//   converted to bf16 pairs as the A fragment and the dO / Q tile read
//   through the transpose bit (m64nHDPk16). dQ, per warpgroup of 64 rows
//   and each 64-key tile: S = Q K^T, dP = dO V^T (shared memory), dS in
//   registers, dQ += dS K (K through the transpose bit). K and V (dK/dV),
//   Q and dO (dQ) are staged once; the walked operand comes through a
//   two-stage cp.async ring (16-byte pieces straight from the strided
//   views, zero-filled past S * G, Sk and hd), tile t + 1 loading while
//   tile t is computed; lse and D of a row tile ride in the ring too.
//   Masks are explicit: zero-filled rows and keys give s = 0, not -inf, so
//   P is set to 0 past S * G, past Sk and (causal) at keys after the row's
//   position. Rounding: dO is rounded to bf16 once, by the pre-pass, into
//   a contiguous (B, Hkv, S * G, hd rounded up to 8) scratch the wrapper
//   allocates (D still comes from the f32 dO); P^T and dS^T are rounded to
//   bf16 as the A operands; every accumulator, P, dS and D are f32.
//   Tiles and occupancy, chosen on an NVIDIA H100 80GB HBM3 (700 W) by
//   scripts/torch_flash_bwd_tune.py: one warpgroup a block in both
//   kernels (KV_WARPGROUPS, Q_WARPGROUPS below). At hd 128 the dK/dV
//   block holds 64 (dK) + 64 (dV) + 32 (S^T) + 32 (dP^T) accumulator
//   registers a thread (254 in all) and 100,352 bytes of shared memory,
//   the dQ block 164 registers and 99,328 bytes: two blocks a
//   multiprocessor each. Two warpgroups a dK/dV block (128 keys sharing
//   the Q / dO ring, one block a multiprocessor) were 3-14 % slower at
//   the training shapes, two a dQ block within 4 %.
// - float32: `bwd_dkdv_f32_kernel` and `bwd_dq_f32_kernel`, on the CUDA
//   cores in f32: operands staged in shared memory as f32 rows padded to
//   hd + 1 (conflict-free column reads), 4 x 4 score and 4 x 8 gradient
//   micro-tiles a thread, P and dS through shared memory; 165 KB a block
//   at hd = 128. TF32 would miss the 1e-5 band the smoke configs' card-vs-
//   CPU checks hold this route to.
//
// What bounds it on this card: operations. At qwen2-7b's training shape
// (B 4, Hkv 4, G 7, hd 128, S 1,024, causal, bf16) the five products are
// 7.5e10 FLOP, 0.076 ms at the bf16 tensor-core rate (989 TFLOP/s); at
// whisper's encoder (B 4, Hkv 20, hd 64, 1,500 over 1,500) 1.15e11 FLOP,
// 0.117 ms. The bytes (q, k, v, o, dO, lse in; dq, dk, dv out) are the
// forward's twice over, far below.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

constexpr int HD_MAX = 128;
constexpr int BR = 64;  // query rows a tile (float32 route)
constexpr int BK = 64;  // keys a tile (float32 route)
constexpr int THREADS = 256;
constexpr int NJ = HD_MAX / 16;  // head-dim columns a thread

struct Strides {
  long long b, h, s, g;  // element strides; g unused for k, v, dk, dv
};

struct Args {
  Strides q, k, v, o, dO, dq, dk, dv;
};

// D_i = dO_i . o_i over hd, one warp a row; rows are (s, g) flattened.
// With `dob` (the bfloat16 route) the row of dO is also written there,
// rounded to bf16, at row stride hd8.
__global__ void __launch_bounds__(THREADS)
bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dO,
                 float* __restrict__ delta, __nv_bfloat16* __restrict__ dob,
                 int Hkv, int S, int G, int hd, int hd8, Strides os,
                 Strides ds) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + warp;
  const int bh = blockIdx.y, b = bh / Hkv, h = bh % Hkv;
  if (row >= S * G) return;
  const int s = row / G, g = row - s * G;
  const float* orow = o + b * os.b + h * os.h + s * os.s + g * os.g;
  const float* drow = dO + b * ds.b + h * ds.h + s * ds.s + g * ds.g;
  float acc = 0.0f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(orow[d], drow[d], acc);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(long long)bh * S * G + row] = acc;
  if (dob != nullptr) {
    __nv_bfloat16* brow = dob + ((long long)bh * S * G + row) * hd8;
    for (int d = lane; d < hd; d += 32) brow[d] = __float2bfloat16(drow[d]);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core tiles.
// ---------------------------------------------------------------------------
size_t dkdv_smem_bytes(int hd) {
  const size_t ld = hd + 1;
  return sizeof(float) *
         (4 * 64 * ld + 2 * (size_t)BK * (BR + 1) + 2 * (size_t)BR);
}

size_t dq_smem_bytes(int hd) {
  const size_t ld = hd + 1;
  return sizeof(float) * (4 * 64 * ld + (size_t)BR * (BK + 1) + 2 * BR);
}

// Rows [r0, r0 + BR) of the flattened (s, g) rows of q-shaped `src` into
// `dst` (BR x ld f32); rows past S * G read as zero.
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          Strides st_, int r0, int S, int G,
                                          int hd, int ldd) {
  for (int e = threadIdx.x; e < BR * hd; e += THREADS) {
    const int r = e / hd, d = e - r * hd;
    const int row = r0 + r, s = row / G, g = row - s * G;
    dst[r * ldd + d] = s < S ? base[s * st_.s + g * st_.g + d] : 0.0f;
  }
}

// Keys [k0, k0 + BK) of k-shaped `src` into `dst` (BK x ld f32); keys past
// Sk read as zero.
__device__ __forceinline__ void load_keys(float* dst, const float* base,
                                          long long ss, int k0, int Sk,
                                          int hd, int ldd) {
  for (int e = threadIdx.x; e < BK * hd; e += THREADS) {
    const int c = e / hd, d = e - c * hd;
    dst[c * ldd + d] = k0 + c < Sk ? base[(k0 + c) * ss + d] : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
bwd_dkdv_f32_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int Hkv, int S, int Sk, int G,
                    int hd, Args a, int causal, float scale) {
  extern __shared__ float smem[];
  const int ldd = hd + 1;
  float* Ks = smem;              // BK x ldd
  float* Vs = Ks + BK * ldd;     // BK x ldd
  float* Qs = Vs + BK * ldd;     // BR x ldd
  float* dOs = Qs + BR * ldd;    // BR x ldd
  float* Pt = dOs + BR * ldd;    // BK x (BR + 1): P^T
  float* dSt = Pt + BK * (BR + 1);  // BK x (BR + 1): dS^T
  float* lse_s = dSt + BK * (BR + 1);
  float* D_s = lse_s + BR;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / Hkv, h = bh % Hkv;
  const int k0 = blockIdx.x * BK;
  const int rows = S * G;
  const float* qb = q + b * a.q.b + h * a.q.h;
  const float* dOb = dO + b * a.dO.b + h * a.dO.h;
  const float* lse_b = lse + (long long)bh * rows;
  const float* D_b = delta + (long long)bh * rows;

  load_keys(Ks, k + b * a.k.b + h * a.k.h, a.k.s, k0, Sk, hd, ldd);
  load_keys(Vs, v + b * a.v.b + h * a.v.h, a.v.s, k0, Sk, hd, ldd);

  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  // Causal: rows of positions < k0 see no key of this tile.
  const int first = causal ? (k0 * G) / BR * BR : 0;
  for (int r0 = first; r0 < rows; r0 += BR) {
    __syncthreads();  // the previous tile's products are done with Qs, dOs
    load_rows(Qs, qb, a.q, r0, S, G, hd, ldd);
    load_rows(dOs, dOb, a.dO, r0, S, G, hd, ldd);
    if (tid < BR) {
      const bool in = r0 + tid < rows;
      lse_s[tid] = in ? lse_b[r0 + tid] : 0.0f;
      D_s[tid] = in ? D_b[r0 + tid] : 0.0f;
    }
    __syncthreads();

    // S^T and dP^T: keys ty * 4 + i, rows tx + 16 * j.
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < hd; ++d) {
      float kk[4], vv[4], qq[4], oo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = Ks[(ty * 4 + i) * ldd + d];
        vv[i] = Vs[(ty * 4 + i) * ldd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qq[j] = Qs[(tx + 16 * j) * ldd + d];
        oo[j] = dOs[(tx + 16 * j) * ldd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(kk[i], qq[j], sc[i][j]);
          dp[i][j] = fmaf(vv[i], oo[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, row = r0 + r;
        const bool live = row < rows && key < Sk && !(causal && key > row / G);
        const float p = live ? expf(sc[i][j] * scale - lse_s[r]) : 0.0f;
        Pt[(ty * 4 + i) * (BR + 1) + r] = p;
        dSt[(ty * 4 + i) * (BR + 1) + r] = p * (dp[i][j] - D_s[r]);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q: keys ty * 4 + i, columns tx + 16 * j.
#pragma unroll 4
    for (int r = 0; r < BR; ++r) {
      float pp[4], ss[4], oo[NJ], qq[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pp[i] = Pt[(ty * 4 + i) * (BR + 1) + r];
        ss[i] = dSt[(ty * 4 + i) * (BR + 1) + r];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        oo[j] = d < hd ? dOs[r * ldd + d] : 0.0f;
        qq[j] = d < hd ? Qs[r * ldd + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc_v[i][j] = fmaf(pp[i], oo[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(ss[i], qq[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Sk) continue;
    float* dkr = dk + b * a.dk.b + h * a.dk.h + key * a.dk.s;
    float* dvr = dv + b * a.dv.b + h * a.dv.h + key * a.dv.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        dkr[d] = acc_k[i][j] * scale;
        dvr[d] = acc_v[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dO,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int Hkv, int S, int Sk, int G, int hd, Args a, int causal,
                  float scale) {
  extern __shared__ float smem[];
  const int ldd = hd + 1;
  float* Qs = smem;              // BR x ldd
  float* dOs = Qs + BR * ldd;    // BR x ldd
  float* Ks = dOs + BR * ldd;    // BK x ldd
  float* Vs = Ks + BK * ldd;     // BK x ldd
  float* dSs = Vs + BK * ldd;    // BR x (BK + 1)
  float* lse_s = dSs + BR * (BK + 1);
  float* D_s = lse_s + BR;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / Hkv, h = bh % Hkv;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;  // longest first
  const int rows = S * G;
  const float* kb = k + b * a.k.b + h * a.k.h;
  const float* vb = v + b * a.v.b + h * a.v.h;

  load_rows(Qs, q + b * a.q.b + h * a.q.h, a.q, r0, S, G, hd, ldd);
  load_rows(dOs, dO + b * a.dO.b + h * a.dO.h, a.dO, r0, S, G, hd, ldd);
  if (tid < BR) {
    const bool in = r0 + tid < rows;
    lse_s[tid] = in ? lse[(long long)bh * rows + r0 + tid] : 0.0f;
    D_s[tid] = in ? delta[(long long)bh * rows + r0 + tid] : 0.0f;
  }
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = (r0 + ty * 4 + i) / G;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  const int qmax = min((r0 + BR - 1) / G, S - 1);
  const int n_tiles = causal ? qmax / BK + 1 : (Sk + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's dS K is done with Ks and dSs
    load_keys(Ks, kb, a.k.s, k0, Sk, hd, ldd);
    load_keys(Vs, vb, a.v.s, k0, Sk, hd, ldd);
    __syncthreads();

    // S and dP: rows ty * 4 + i, keys tx + 16 * j.
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < hd; ++d) {
      float qq[4], oo[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qq[i] = Qs[(ty * 4 + i) * ldd + d];
        oo[i] = dOs[(ty * 4 + i) * ldd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = Ks[(tx + 16 * j) * ldd + d];
        vv[j] = Vs[(tx + 16 * j) * ldd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qq[i], kk[j], sc[i][j]);
          dp[i][j] = fmaf(oo[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = r0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool live =
            row < rows && key < Sk && !(causal && key > qpos[i]);
        const float p = live ? expf(sc[i][j] * scale - lse_s[r]) : 0.0f;
        dSs[r * (BK + 1) + tx + 16 * j] = p * (dp[i][j] - D_s[r]);
      }
    }
    __syncthreads();

    // dQ += dS K: rows ty * 4 + i, columns tx + 16 * j.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ss[4], kk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ss[i] = dSs[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        kk[j] = d < hd ? Ks[c * ldd + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(ss[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= rows) continue;
    const int s = row / G, g = row - s * G;
    float* o = dq + b * a.dq.b + h * a.dq.h + s * a.dq.s + g * a.dq.g;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) o[d] = acc[i][j] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma tiles.
// ---------------------------------------------------------------------------
// Warpgroups a block: in the dK/dV kernel each owns 64 keys and they share
// the Q / dO ring; in the dQ kernel each owns 64 rows and they share the
// K / V ring (scripts/torch_flash_bwd_tune.py times other values).
constexpr int KV_WARPGROUPS = 1;
constexpr int Q_WARPGROUPS = 1;
constexpr float LOG2E = 1.4426950408889634f;

// Bytes of one 64-row tile, hd padded to HDP.
template <int HDP>
__host__ __device__ constexpr int tile_bytes() {
  return HDP / 64 * PANEL;
}

// Shared memory of the two kernels: 1 KB of alignment slack, the staged
// tiles (two a warpgroup), the two-stage ring (two tiles a stage) and, for
// dK/dV, lse and D of both stages.
template <int HDP, int WG>
__host__ __device__ constexpr int dkdv_tc_smem() {
  return 1024 + (2 * WG + 4) * tile_bytes<HDP>() + 2 * 2 * 64 * 4;
}
template <int HDP, int WG>
__host__ __device__ constexpr int dq_tc_smem() {
  return 1024 + (2 * WG + 4) * tile_bytes<HDP>();
}

// 4 bytes from global to shared; zero-filled when !in (`src` is then not
// read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// Rows [r0, r0 + 64) of q's flattened (s, g) rows into a 64 x HDP swizzled
// tile; rows past S * G and columns >= hd are zero-filled.
template <int THREADS, int HDP>
__device__ __forceinline__ void load_qrows(uint32_t dst,
                                           const __nv_bfloat16* qb,
                                           Strides qs, int r0, int S, int G,
                                           int hd, int tid) {
  constexpr int CH = HDP / 8, LOG_CH = HDP == 128 ? 4 : 3;
#pragma unroll
  for (int i = 0; i < 64 * CH / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e >> LOG_CH, c = e & (CH - 1);
    const int row = r0 + r, s = row / G, g = row - s * G;
    const int bytes = s < S ? min(16, max(0, (hd - c * 8) * 2)) : 0;
    const __nv_bfloat16* p = bytes ? qb + s * qs.s + g * qs.g + c * 8 : qb;
    cp_async16(dst + swz(r, c, PANEL), p, bytes);
  }
}

// The RS product of the head-dim width: m64n128k16 or m64n64k16.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_64x128(d, a, db);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_64x64(d, a, db);
}

// acc (64 rows x HDP, tile row = A operand's row) (+)= A (64 x HDP tile at
// `sa`) * B^T (64 x HDP tile at `sb`): both K-major, the depth hd.
template <int HDP>
__device__ __forceinline__ void ss_product(float (&acc)[32], uint32_t sa,
                                           uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t off = (kk >> 2) * PANEL + (kk & 3) * 32;
    wgmma_ss_64x64(acc, desc128(sa + off, 16, 1024),
                   desc128(sb + off, 16, 1024), kk > 0);
  }
}

// acc (64 x HDP) += A (64 x 64, the bf16 pairs `frag` in the accumulator
// layout) * B (the 64 x HDP tile at `sb`, its rows the depth: read through
// the transpose bit).
template <int N>
__device__ __forceinline__ void rs_product(float (&acc)[N],
                                           const uint32_t (&frag)[16],
                                           uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {frag[4 * kk], frag[4 * kk + 1], frag[4 * kk + 2],
                           frag[4 * kk + 3]};
    wgmma_rs(acc, a, desc128(sb + kk * 16 * 128, PANEL, 1024));
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// x0, x1 to columns d, d + 1 of a bf16 row (d even; d + 1 only if < hd).
__device__ __forceinline__ void store2(__nv_bfloat16* p, int d, int hd,
                                       float x0, float x1, bool pairs) {
  if (pairs) {
    *reinterpret_cast<__nv_bfloat162*>(p + d) = __floats2bfloat162_rn(x0, x1);
  } else {
    p[d] = __float2bfloat16(x0);
    if (d + 1 < hd) p[d + 1] = __float2bfloat16(x1);
  }
}

// The accumulator rows A and B of this thread (64 x HDP, the layout of
// m64nHDPk16), times `scale`, to the bf16 rows at pA and pB.
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N],
                                           __nv_bfloat16* pA, bool inA,
                                           __nv_bfloat16* pB, bool inB,
                                           int col0, int hd, float scale) {
  const bool pairs = (hd & 1) == 0;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int d = 8 * j + col0;
    if (d >= hd) continue;
    if (inA) store2(pA, d, hd, acc[4 * j] * scale, acc[4 * j + 1] * scale,
                    pairs);
    if (inB) store2(pB, d, hd, acc[4 * j + 2] * scale,
                    acc[4 * j + 3] * scale, pairs);
  }
}

template <int HDP, int WG>
__global__ void __launch_bounds__(WG * 128)
bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dob,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int Hkv, int S, int Sk,
                   int G, int hd, int hd8, Args a, int causal, float scale,
                   float scale_log2) {
  constexpr int THREADS = WG * 128, TILE = tile_bytes<HDP>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u, sV = sK + WG * TILE;
  const uint32_t sRing = sV + WG * TILE;   // [stage][Q tile, dO tile]
  const uint32_t sStat = sRing + 4 * TILE;  // [stage][lse 64, D 64] f32
  const float* stat = reinterpret_cast<const float*>(smem_raw + (sStat - raw));

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int k0 = blockIdx.y * 64 * WG;  // causal: the longest walks first
  const int rows = S * G;
  const __nv_bfloat16* qb = q + b * a.q.b + h * a.q.h;
  const __nv_bfloat16* kb = k + b * a.k.b + h * a.k.h;
  const __nv_bfloat16* vb = v + b * a.v.b + h * a.v.h;
  const __nv_bfloat16* dob_b = dob + (long long)bh * rows * hd8;
  const float* lse_b = lse + (long long)bh * rows;
  const float* D_b = delta + (long long)bh * rows;

#pragma unroll
  for (int w = 0; w < WG; ++w) {
    const int kr = k0 + 64 * w;
    load_tile<THREADS, HDP>(sK + w * TILE, kr < Sk ? kb + kr * a.k.s : kb,
                            a.k.s, Sk - kr, hd, tid);
    load_tile<THREADS, HDP>(sV + w * TILE, kr < Sk ? vb + kr * a.v.s : vb,
                            a.v.s, Sk - kr, hd, tid);
  }
  // Row tile t into ring stage st: Q's rows, dO's (bf16 scratch), lse, D.
  auto stage = [&](int t, int st) {
    const int r0 = t * 64;
    const uint32_t sQ = sRing + st * 2 * TILE;
    load_qrows<THREADS, HDP>(sQ, qb, a.q, r0, S, G, hd, tid);
    load_tile<THREADS, HDP>(sQ + TILE, dob_b + (long long)r0 * hd8, hd8,
                            rows - r0, hd, tid);
    if (tid < 64) {
      const bool in = r0 + tid < rows;
      const uint32_t dst = sStat + st * 512 + tid * 4;
      cp_async4(dst, in ? lse_b + r0 + tid : lse_b, in);
      cp_async4(dst + 256, in ? D_b + r0 + tid : D_b, in);
    }
  };
  const int n_rt = (rows + 63) / 64;
  // Causal: rows of positions < k0 see no key of this tile.
  const int first = causal ? k0 * G / 64 : 0;
  stage(first, 0);
  cp_async_commit();  // K, V and the first row tile
  if (first + 1 < n_rt) stage(first + 1, 1);
  cp_async_commit();

  // This thread's two keys (accumulator rows) and the first column.
  const int kA = k0 + wg * 64 + warp * 16 + (lane >> 2), kB = kA + 8;
  const int col0 = 2 * (lane & 3);
  // Row `row` (< rows) sees key kX iff row >= lowX: kX < Sk and, causal,
  // kX <= row / G, i.e. row >= kX * G.
  const int lowA = kA >= Sk ? rows : causal ? kA * G : 0;
  const int lowB = kB >= Sk ? rows : causal ? kB * G : 0;
  const uint32_t sKw = sK + wg * TILE, sVw = sV + wg * TILE;

  float dk_acc[HDP / 2], dv_acc[HDP / 2];
  zero(dk_acc);
  zero(dv_acc);
  for (int t = first; t < n_rt; ++t) {
    const int st = (t - first) & 1;
    const uint32_t sQ = sRing + st * 2 * TILE, sdO = sQ + TILE;
    cp_async_wait<1>();  // tile t landed; tile t + 1 may be in flight
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    float sc[32], dp[32];  // S^T, dP^T: keys x the tile's 64 rows
    zero(sc);
    zero(dp);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    ss_product<HDP>(sc, sKw, sQ);
    ss_product<HDP>(dp, sVw, sdO);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);

    const float* ls = stat + st * 128;
    const float* Ds = ls + 64;
    const int r0 = t * 64;
    uint32_t pf[16], sf[16];  // P^T, dS^T as bf16 A fragments
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pa[2], pb[2], da[2], db[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = 8 * j + col0 + c, row = r0 + r;
        const float l2 = ls[r] * LOG2E, D = Ds[r];
        const bool live = row < rows;
        pa[c] = live && row >= lowA
                    ? fast_exp2(fmaf(sc[4 * j + c], scale_log2, -l2))
                    : 0.0f;
        pb[c] = live && row >= lowB
                    ? fast_exp2(fmaf(sc[4 * j + 2 + c], scale_log2, -l2))
                    : 0.0f;
        da[c] = pa[c] * (dp[4 * j + c] - D);
        db[c] = pb[c] * (dp[4 * j + 2 + c] - D);
      }
      pf[2 * j] = pack_bf16(pa[0], pa[1]);
      pf[2 * j + 1] = pack_bf16(pb[0], pb[1]);
      sf[2 * j] = pack_bf16(da[0], da[1]);
      sf[2 * j + 1] = pack_bf16(db[0], db[1]);
    }

    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    rs_product(dv_acc, pf, sdO);  // dV += P^T dO
    rs_product(dk_acc, sf, sQ);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // every warpgroup is done with this stage

    if (t + 2 < n_rt) stage(t + 2, st);
    cp_async_commit();  // (possibly empty: keeps the group count in step)
  }
  cp_async_wait<0>();

  const bool inA = kA < Sk, inB = kB < Sk;
  __nv_bfloat16* dkb = dk + b * a.dk.b + h * a.dk.h;
  __nv_bfloat16* dvb = dv + b * a.dv.b + h * a.dv.h;
  store_rows(dk_acc, dkb + (inA ? kA * a.dk.s : 0), inA,
             dkb + (inB ? kB * a.dk.s : 0), inB, col0, hd, scale);
  store_rows(dv_acc, dvb + (inA ? kA * a.dv.s : 0), inA,
             dvb + (inB ? kB * a.dv.s : 0), inB, col0, hd, 1.0f);
}

template <int HDP, int WG>
__global__ void __launch_bounds__(WG * 128)
bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dob,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int Hkv, int S, int Sk,
                 int G, int hd, int hd8, Args a, int causal, float scale,
                 float scale_log2) {
  constexpr int THREADS = WG * 128, TILE = tile_bytes<HDP>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + WG * TILE;
  const uint32_t sRing = sdO + WG * TILE;  // [stage][K tile, V tile]

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * 64 * WG;  // longest first
  const int rows = S * G;
  const __nv_bfloat16* kb = k + b * a.k.b + h * a.k.h;
  const __nv_bfloat16* vb = v + b * a.v.b + h * a.v.h;
  const __nv_bfloat16* dob_b = dob + (long long)bh * rows * hd8;

#pragma unroll
  for (int w = 0; w < WG; ++w) {
    const int rw = r0 + 64 * w;
    load_qrows<THREADS, HDP>(sQ + w * TILE, q + b * a.q.b + h * a.q.h, a.q,
                             rw, S, G, hd, tid);
    load_tile<THREADS, HDP>(
        sdO + w * TILE, rw < rows ? dob_b + (long long)rw * hd8 : dob_b,
        hd8, rows - rw, hd, tid);
  }
  // Key tile t into ring stage st: K, V.
  auto stage = [&](int t, int st) {
    const int kr = t * 64;
    const uint32_t sKt = sRing + st * 2 * TILE;
    load_tile<THREADS, HDP>(sKt, kb + kr * a.k.s, a.k.s, Sk - kr, hd, tid);
    load_tile<THREADS, HDP>(sKt + TILE, vb + kr * a.v.s, a.v.s, Sk - kr, hd,
                            tid);
  };
  const int qmax = min((r0 + 64 * WG - 1) / G, S - 1);
  const int n_tiles = causal ? qmax / 64 + 1 : (Sk + 63) / 64;
  stage(0, 0);
  cp_async_commit();  // Q, dO and the first key tile
  if (n_tiles > 1) stage(1, 1);
  cp_async_commit();

  // This thread's two rows (accumulator rows) and the first column.
  const int rowA = r0 + wg * 64 + warp * 16 + (lane >> 2), rowB = rowA + 8;
  const int col0 = 2 * (lane & 3);
  const bool inA = rowA < rows, inB = rowB < rows;
  const float lA = inA ? lse[(long long)bh * rows + rowA] * LOG2E : 0.0f;
  const float lB = inB ? lse[(long long)bh * rows + rowB] * LOG2E : 0.0f;
  const float DA = inA ? delta[(long long)bh * rows + rowA] : 0.0f;
  const float DB = inB ? delta[(long long)bh * rows + rowB] : 0.0f;
  // Row X sees key `key` iff key <= limX: the key < Sk and, causal, at
  // most the row's position.
  const int limA = !inA ? -1 : causal ? rowA / G : Sk - 1;
  const int limB = !inB ? -1 : causal ? rowB / G : Sk - 1;
  const uint32_t sQw = sQ + wg * TILE, sdOw = sdO + wg * TILE;

  float dq_acc[HDP / 2];
  zero(dq_acc);
  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t sKt = sRing + (t & 1) * 2 * TILE, sVt = sKt + TILE;
    cp_async_wait<1>();  // tile t landed; tile t + 1 may be in flight
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    float sc[32], dp[32];  // S, dP: the warpgroup's 64 rows x 64 keys
    zero(sc);
    zero(dp);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    ss_product<HDP>(sc, sQw, sKt);
    ss_product<HDP>(dp, sdOw, sVt);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);

    const int k0 = t * 64;
    uint32_t sf[16];  // dS as bf16 A fragments
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float da[2], db[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + col0 + c;
        const float pa =
            key <= limA ? fast_exp2(fmaf(sc[4 * j + c], scale_log2, -lA))
                        : 0.0f;
        const float pb =
            key <= limB
                ? fast_exp2(fmaf(sc[4 * j + 2 + c], scale_log2, -lB))
                : 0.0f;
        da[c] = pa * (dp[4 * j + c] - DA);
        db[c] = pb * (dp[4 * j + 2 + c] - DB);
      }
      sf[2 * j] = pack_bf16(da[0], da[1]);
      sf[2 * j + 1] = pack_bf16(db[0], db[1]);
    }

    fence_regs(dq_acc);
    wgmma_fence();
    rs_product(dq_acc, sf, sKt);  // dQ += dS K
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dq_acc);
    __syncthreads();  // every warpgroup is done with this stage

    if (t + 2 < n_tiles) stage(t + 2, t & 1);
    cp_async_commit();  // (possibly empty: keeps the group count in step)
  }
  cp_async_wait<0>();

  const int sA = rowA / G, gA = rowA - sA * G, sB = rowB / G,
            gB = rowB - sB * G;
  __nv_bfloat16* dqb = dq + b * a.dq.b + h * a.dq.h;
  store_rows(dq_acc, dqb + (inA ? sA * a.dq.s + gA * a.dq.g : 0), inA,
             dqb + (inB ? sB * a.dq.s + gB * a.dq.g : 0), inB, col0, hd,
             scale);
}

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, const void* dob,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int B, int Hkv, int S, int Sk, int G, int hd,
              int hd8, const Args& a, int causal, float scale,
              cudaStream_t st_) {
  const float scale_log2 = scale * LOG2E;
  const int rows = S * G;
  constexpr int smem_kv = dkdv_tc_smem<HDP, KV_WARPGROUPS>();
  auto* kv = bwd_dkdv_tc_kernel<HDP, KV_WARPGROUPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  const int keys = 64 * KV_WARPGROUPS;
  dim3 grid_kv(B * Hkv, (Sk + keys - 1) / keys);
  kv<<<grid_kv, 128 * KV_WARPGROUPS, smem_kv, st_>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dob, (const float*)lse,
      (const float*)delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, Hkv, S,
      Sk, G, hd, hd8, a, causal, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int smem_q = dq_tc_smem<HDP, Q_WARPGROUPS>();
  auto* qk = bwd_dq_tc_kernel<HDP, Q_WARPGROUPS>;
  err = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return (int)err;
  const int tile_rows = 64 * Q_WARPGROUPS;
  dim3 grid_q(B * Hkv, (rows + tile_rows - 1) / tile_rows);
  qk<<<grid_q, 128 * Q_WARPGROUPS, smem_q, st_>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dob, (const float*)lse,
      (const float*)delta, (__nv_bfloat16*)dq, Hkv, S, Sk, G, hd, hd8, a,
      causal, scale, scale_log2);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int B, int Hkv, int S, int Sk, int G, int hd,
               const Args& a, int causal, float scale, cudaStream_t st_) {
  const int rows = S * G;
  const size_t smem_kv = dkdv_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv((Sk + BK - 1) / BK, B * Hkv);
  bwd_dkdv_f32_kernel<<<grid_kv, THREADS, smem_kv, st_>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dO,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, Hkv, S,
      Sk, G, hd, a, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = dq_smem_bytes(hd);
  err = cudaFuncSetAttribute(bwd_dq_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((rows + BR - 1) / BR, B * Hkv);
  bwd_dq_f32_kernel<<<grid_q, THREADS, smem_q, st_>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dO,
      (const float*)lse, (const float*)delta, (float*)dq, Hkv, S, Sk, G, hd,
      a, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dq, dk and dv share it; o and
// dO are float32). `strides` holds 28 element strides, in this order:
// q (b, h, s, g), k (b, h, s), v (b, h, s), o (b, h, s, g), dO (b, h, s, g),
// dq (b, h, s, g), dk (b, h, s), dv (b, h, s). lse and delta (scratch the
// wrapper allocates) are contiguous (B, Hkv, S, G) f32; dob (bfloat16 only,
// else null) is scratch for dO rounded to bf16, contiguous (B, Hkv, S * G,
// hd rounded up to 8). Causal needs Sk == S; hd <= 128. The bfloat16 route
// needs 16-byte-aligned q, k, v and strides that are multiples of 8
// elements (the wrapper checks both).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* delta, void* dob, void* dq,
    void* dk, void* dv, int B, int Hkv, int S, int Sk, int G, int hd,
    const long long* strides, int causal, float scale, int dtype,
    void* stream) {
  if (hd < 1 || hd > HD_MAX) return (int)cudaErrorInvalidValue;
  if (causal && Sk != S) return (int)cudaErrorInvalidValue;
  if (Sk < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && dob == nullptr) return (int)cudaErrorInvalidValue;
  if (B * Hkv * S * G == 0) return (int)cudaGetLastError();
  const long long* x = strides;
  Args a;
  a.q = Strides{x[0], x[1], x[2], x[3]};
  a.k = Strides{x[4], x[5], x[6], 0};
  a.v = Strides{x[7], x[8], x[9], 0};
  a.o = Strides{x[10], x[11], x[12], x[13]};
  a.dO = Strides{x[14], x[15], x[16], x[17]};
  a.dq = Strides{x[18], x[19], x[20], x[21]};
  a.dk = Strides{x[22], x[23], x[24], 0};
  a.dv = Strides{x[25], x[26], x[27], 0};
  cudaStream_t st_ = (cudaStream_t)stream;
  const int rows = S * G, hd8 = (hd + 7) & ~7;

  dim3 grid_d((rows + THREADS / 32 - 1) / (THREADS / 32), B * Hkv);
  bwd_delta_kernel<<<grid_d, THREADS, 0, st_>>>(
      (const float*)o, (const float*)dO, (float*)delta,
      dtype == 1 ? (__nv_bfloat16*)dob : nullptr, Hkv, S, G, hd, hd8, a.o,
      a.dO);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (dtype != 1)
    return launch_f32(q, k, v, dO, lse, delta, dq, dk, dv, B, Hkv, S, Sk, G,
                      hd, a, causal, scale, st_);
  if (hd <= 64)
    return launch_tc<64>(q, k, v, dob, lse, delta, dq, dk, dv, B, Hkv, S, Sk,
                         G, hd, hd8, a, causal, scale, st_);
  return launch_tc<128>(q, k, v, dob, lse, delta, dq, dk, dv, B, Hkv, S, Sk,
                        G, hd, hd8, a, causal, scale, st_);
}
