// Flash-attention forward (grouped-query, causal or full) for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention_kernel.py:_flash_kernel,
// reached through flash_attention.
//
// q (B, Hkv, S, G, hd) holds the G query heads of each KV head; k, v are
// (B, Hkv, S, hd). Every operand is addressed through its strides (the
// innermost axis contiguous), so the model passes views of its (B, S, H, hd)
// projections and no copy is made. For each query row:
//   s   = (q . k) * scale in f32, masked entries set to -1e30;
//   online softmax over key tiles: m_new = max(m, max s), corr = exp(m -
//   m_new), p = exp(s - m_new), l = l * corr + sum p (p in f32),
//   acc = acc * corr + round_to_v_dtype(p) @ v;
//   out = acc / max(l, 1e-30), f32.
// These are the Pallas kernel's semantics, step for step.
//
// Design for the card. The TPU walked key tiles on a sequential grid axis
// with the accumulators carried in VMEM; here one block owns one tile of
// query rows of one (batch, KV head) and loops over the key tiles itself,
// so nothing carries between blocks. The rows of a tile are the flattened
// (query position, head-in-group) pairs: the G heads of a KV head share
// every K/V tile staged in shared memory, which is the point of the
// grouped layout, and a G that is not a power of two (7 at qwen2-7b) only
// changes which query position a row masks with (row / G). Causal tiles
// lying wholly above the diagonal are skipped, which the TPU could not do;
// this is exact, because the first tile always holds key 0, so m is finite
// after it and a fully masked tile would add exp(-1e30 - m) = 0 with
// corr = 1.
//
// What bounds it on this card: at the prefill shapes (B=4, Hkv=4, S=1024,
// G=7, hd=128, causal) the two bounds are close: ~3.0e10 FLOP per call
// at the bf16 tensor-core rate and ~96 MB of operands (the f32 output is
// the largest) at the memory rate, both ~0.03 ms. This first version keeps
// the products on the CUDA cores in f32 (a 4 x 4 score and a 4 x 8 output
// micro-tile per thread, out of shared memory), so it runs far from that
// bound; wgmma tiles, TMA staging and pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BR = 64;           // query rows (position, head) per block
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;
constexpr int HD_MAX = 128;
constexpr int NJ = HD_MAX / 16;  // output columns per thread
constexpr float NEG = -1e30f;

struct Strides {
  long long b, h, s, g;  // element strides; g unused for k and v
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// p rounded to the value operand's type before the PV product.
__device__ __forceinline__ float round_as(float p, const float*) { return p; }
__device__ __forceinline__ float round_as(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

size_t smem_bytes(int hd) {
  const int ld = hd + 1;
  return sizeof(float) *
         ((size_t)BR * ld + (size_t)BK * ld + (size_t)BR * (BK + 1) + 3 * BR);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ out, int Hkv, int S,
             int G, int hd, Strides qs, Strides ks, Strides vs, Strides os,
             int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Qs = smem;                  // BR x ld
  float* KVs = Qs + BR * ld;         // BK x ld: the K tile, then the V tile
  float* Ps = KVs + BK * ld;         // BR x (BK + 1): scores, then p
  float* row_m = Ps + BR * (BK + 1);
  float* row_l = row_m + BR;
  float* row_c = row_l + BR;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int r0 = blockIdx.x * BR;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  for (int e = tid; e < BR * hd; e += THREADS) {
    const int r = e / hd, d = e % hd;
    const int row = r0 + r, s = row / G, g = row % G;
    Qs[r * ld + d] = s < S ? to_f(qb[s * qs.s + g * qs.g + d]) : 0.0f;
  }
  if (tid < BR) {
    row_m[tid] = NEG;
    row_l[tid] = 0.0f;
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
  const int n_tiles = causal ? qmax / BK + 1 : (S + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's PV is done with KVs and Ps
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int c = e / hd, d = e % hd;
      KVs[c * ld + d] = k0 + c < S ? to_f(kb[(k0 + c) * ks.s + d]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = KVs[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool masked = kp >= S || (causal && kp > qpos[i]);
        Ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] =
            masked ? NEG : sc[i][j] * scale;
      }
    __syncthreads();  // scores complete; K no longer needed

    for (int e = tid; e < BK * hd; e += THREADS) {
      const int c = e / hd, d = e % hd;
      KVs[c * ld + d] = k0 + c < S ? to_f(vb[(k0 + c) * vs.s + d]) : 0.0f;
    }
    {
      // Four neighbouring lanes own one row, 16 columns each.
      const int r = tid / 4, part = tid % 4;
      float* pr = Ps + r * (BK + 1) + part * 16;
      float mt = NEG;
#pragma unroll
      for (int c = 0; c < 16; ++c) mt = fmaxf(mt, pr[c]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(pr[c] - m_new);
        sum += p;
        pr[c] = round_as(p, v);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        row_c[r] = corr;
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();  // p, corr and the V tile are ready

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = row_c[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < hd ? KVs[c * ld + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i, s = row / G, g = row % G;
    if (s >= S) continue;
    const float l = fmaxf(row_l[ty * 4 + i], 1e-30f);
    float* o = out + b * os.b + h * os.h + s * os.s + g * os.g;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) o[d] = acc[i][j] / l;
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hkv, int S, int G, int hd, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(((long long)S * G + BR - 1) / BR, B * Hkv);
  flash_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (float*)out, Hkv, S, G, hd, qs,
      ks, vs, os, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it). Strides are in
// elements: q and out (b, h, s, g), k and v (b, h, s). Requires hd <= 128.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int Hkv,
    int S, int G, int hd, long long qsb, long long qsh, long long qss,
    long long qsg, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, long long osg, int causal, float scale,
    int dtype, void* stream) {
  if (hd < 1 || hd > HD_MAX) return (int)cudaErrorInvalidValue;
  if (B * Hkv * S * G == 0) return (int)cudaGetLastError();
  const Strides qs{qsb, qsh, qss, qsg}, ks{ksb, ksh, kss, 0},
      vs{vsb, vsh, vss, 0}, os{osb, osh, oss, osg};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Hkv, S, G, hd, qs, ks, vs,
                                 os, causal, scale, st);
  return launch<float>(q, k, v, out, B, Hkv, S, G, hd, qs, ks, vs, os,
                       causal, scale, st);
}
