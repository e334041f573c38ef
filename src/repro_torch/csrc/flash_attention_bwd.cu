// Flash-attention backward (grouped-query, causal or full) for Hopper
// (sm_90a).
//
// Replaces: nothing in Pallas. The reference's flash kernel
// (src/repro/kernels/flash_attention_kernel.py:flash_attention) has no
// custom_vjp; the reference trains through XLA's autodiff of its plain jnp
// attention (src/repro/models/attention.py). This is the gradient of the
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
//   D_i   = dO_i . o_i                 (bwd_delta_kernel);
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
// Design: CUDA cores, f32 arithmetic, no atomics, so the gradient is the
// same bits on every run (a resumed training run repeats the uninterrupted
// one). Three kernels a call:
//  - bwd_delta_kernel: one warp a row, D = rowsum(dO * o).
//  - bwd_dkdv_kernel: one block a 64-key tile of one (batch, KV head).
//    K and V stay in shared memory; the block walks the tiles of 64 query
//    rows (rows are the flattened (position, head-in-group) pairs, as in
//    the forward, so the G heads of the KV head are summed by the walk
//    itself, with no reduction across blocks), starting at the first row
//    that can see the tile when causal. Per row tile: S^T and dP^T as
//    4 x 4 micro-tiles a thread, P and dS into shared memory, then
//    dV += P^T dO and dK += dS^T Q as 4 x 8 micro-tiles in registers.
//  - bwd_dq_kernel: one block a 64-row query tile; walks the key tiles up
//    to the diagonal (causal) or to Sk, dQ += dS K in registers. Tiles run
//    longest first.
// Operands are staged in shared memory as f32 rows padded to hd + 1
// (conflict-free column reads): 165 KB a block at hd = 128, one block a
// multiprocessor.
//
// What bounds it on this card: operations. The backward does five
// products of S x Sk x hd (S and dP recomputed, dV, dK, dQ) where the
// forward does two, here on the CUDA cores at the f32 rate (67 TFLOP/s),
// not the bf16 tensor cores (989). The bytes (q, k, v, o, dO, lse in; dq,
// dk, dv out) are the forward's twice over, far below. Moving the
// products to wgmma, as the forward does, is the later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD_MAX = 128;
constexpr int BR = 64;  // query rows a tile
constexpr int BK = 64;  // keys a tile
constexpr int THREADS = 256;
constexpr int NJ = HD_MAX / 16;  // head-dim columns a thread

struct Strides {
  long long b, h, s, g;  // element strides; g unused for k, v, dk, dv
};

struct Args {
  Strides q, k, v, o, dO, dq, dk, dv;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// p as the forward's P V product takes it: rounded to v's dtype.
__device__ __forceinline__ float round_v(float p, const float*) { return p; }
__device__ __forceinline__ float round_v(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

// D_i = dO_i . o_i over hd, one warp a row; rows are (s, g) flattened.
__global__ void __launch_bounds__(THREADS)
bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dO,
                 float* __restrict__ delta, int Hkv, int S, int G, int hd,
                 Strides os, Strides ds) {
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
}

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
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* base,
                                          Strides st_, int r0, int S, int G,
                                          int hd, int ldd) {
  for (int e = threadIdx.x; e < BR * hd; e += THREADS) {
    const int r = e / hd, d = e - r * hd;
    const int row = r0 + r, s = row / G, g = row - s * G;
    dst[r * ldd + d] = s < S ? ld(base + s * st_.s + g * st_.g + d) : 0.0f;
  }
}

// Keys [k0, k0 + BK) of k-shaped `src` into `dst` (BK x ld f32); keys past
// Sk read as zero.
template <typename T>
__device__ __forceinline__ void load_keys(float* dst, const T* base,
                                          long long ss, int k0, int Sk,
                                          int hd, int ldd) {
  for (int e = threadIdx.x; e < BK * hd; e += THREADS) {
    const int c = e / hd, d = e - c * hd;
    dst[c * ldd + d] = k0 + c < Sk ? ld(base + (k0 + c) * ss + d) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ dO,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int Hkv, int S, int Sk, int G, int hd,
                Args a, int causal, float scale) {
  extern __shared__ float smem[];
  const int ldd = hd + 1;
  float* Ks = smem;              // BK x ldd
  float* Vs = Ks + BK * ldd;     // BK x ldd
  float* Qs = Vs + BK * ldd;     // BR x ldd
  float* dOs = Qs + BR * ldd;    // BR x ldd
  float* Pt = dOs + BR * ldd;    // BK x (BR + 1): P^T, rounded to v's dtype
  float* dSt = Pt + BK * (BR + 1);  // BK x (BR + 1): dS^T
  float* lse_s = dSt + BK * (BR + 1);
  float* D_s = lse_s + BR;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / Hkv, h = bh % Hkv;
  const int k0 = blockIdx.x * BK;
  const int rows = S * G;
  const T* qb = q + b * a.q.b + h * a.q.h;
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
        Pt[(ty * 4 + i) * (BR + 1) + r] = round_v(p, v);
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
    T* dkr = dk + b * a.dk.b + h * a.dk.h + key * a.dk.s;
    T* dvr = dv + b * a.dv.b + h * a.dv.h + key * a.dv.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        st(dkr + d, acc_k[i][j] * scale);
        st(dvr + d, acc_v[i][j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ dO,
              const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int Hkv,
              int S, int Sk, int G, int hd, Args a, int causal,
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
  const T* kb = k + b * a.k.b + h * a.k.h;
  const T* vb = v + b * a.v.b + h * a.v.h;

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
    T* o = dq + b * a.dq.b + h * a.dq.h + s * a.dq.s + g * a.dq.g;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) st(o + d, acc[i][j] * scale);
    }
  }
}

template <typename T>
int launch_all(const void* q, const void* k, const void* v, const void* o,
               const void* dO, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int B, int Hkv, int S, int Sk, int G,
               int hd, const Args& a, int causal, float scale,
               cudaStream_t st_) {
  const int rows = S * G;
  dim3 grid_d((rows + THREADS / 32 - 1) / (THREADS / 32), B * Hkv);
  bwd_delta_kernel<<<grid_d, THREADS, 0, st_>>>(
      (const float*)o, (const float*)dO, (float*)delta, Hkv, S, G, hd, a.o,
      a.dO);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_kv = dkdv_smem_bytes(hd);
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv((Sk + BK - 1) / BK, B * Hkv);
  bwd_dkdv_kernel<T><<<grid_kv, THREADS, smem_kv, st_>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)dO,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, Hkv, S, Sk, G,
      hd, a, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = dq_smem_bytes(hd);
  err = cudaFuncSetAttribute(bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((rows + BR - 1) / BR, B * Hkv);
  bwd_dq_kernel<T><<<grid_q, THREADS, smem_q, st_>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)dO,
      (const float*)lse, (const float*)delta, (T*)dq, Hkv, S, Sk, G, hd, a,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dq, dk and dv share it; o and
// dO are float32). `strides` holds 28 element strides, in this order:
// q (b, h, s, g), k (b, h, s), v (b, h, s), o (b, h, s, g), dO (b, h, s, g),
// dq (b, h, s, g), dk (b, h, s), dv (b, h, s). lse and delta (scratch the
// wrapper allocates) are contiguous (B, Hkv, S, G) f32. Causal needs
// Sk == S; hd <= 128.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Hkv, int S, int Sk, int G, int hd,
    const long long* strides, int causal, float scale, int dtype,
    void* stream) {
  if (hd < 1 || hd > HD_MAX) return (int)cudaErrorInvalidValue;
  if (causal && Sk != S) return (int)cudaErrorInvalidValue;
  if (Sk < 1) return (int)cudaErrorInvalidValue;
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
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(q, k, v, o, dO, lse, delta, dq, dk, dv,
                                     B, Hkv, S, Sk, G, hd, a, causal, scale,
                                     st_);
  return launch_all<float>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Hkv, S,
                           Sk, G, hd, a, causal, scale, st_);
}
