// Flash-decoding attention (one query token per head against a KV cache)
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention_kernel.py:_decode_attn_kernel,
// reached through decode_attention.
//
// q (B, Hkv, G, hd) holds the G query heads of each KV head; k, v are
// (B, Hkv, S, hd) views of the cache, addressed through their strides (the
// model's cache is laid out (B, S_max, Hkv, hd) and is read in place).
// Positions pos < length take part; for each query head
//   s = (q . k) * scale in f32, p = exp(s - m), l = sum p (f32),
//   out = (round_to_v_dtype(p) @ v) / max(l, 1e-30), cast to q's dtype:
// the Pallas kernel's semantics. `length` is read from device memory and
// must be >= 1 (the decode step passes pos + 1).
//
// Design for the card. The TPU walked the cache on a sequential grid axis
// per (batch, KV head); at the decode shapes that is only B * Hkv = 16
// sequences, 16 of the card's 132 SMs. So the cache is split across
// blocks (flash-decoding): block (split, b * Hkv + h) takes 64 positions
// and writes a partial (m, l, acc) for each of the G heads; a second
// kernel combines the partials of each (b, h) by their maxima. Splits that
// start at or past `length` read nothing and are left out of the combine,
// so positions >= length never change the result and are never read.
// Scores: one warp per cache position, lanes along hd, the G heads' dot
// products reduced with shuffles. PV: one thread per hd column, reading V
// rows coalesced, with the G sums in registers.
//
// What bounds it on this card: bytes. Each step reads the K and V rows up
// to `length` once (2 * B * Hkv * length * hd * 2 bytes in bf16, ~8.5 MB
// per layer at the serve shapes: ~2.5 us at the memory rate), which is
// also all the design reads besides q and the small partials.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 64;        // cache positions per split
constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int G_MAX = 16;
constexpr int HD_MAX = 256;
constexpr int DPL = HD_MAX / 32;  // hd elements per lane
constexpr float NEG = -1e30f;

struct Strides {
  long long b, h, s;  // element strides; for q, s is the head-in-group axis
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float round_as(float p, const float*) { return p; }
__device__ __forceinline__ float round_as(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ length_p,
                      float* __restrict__ m_part, float* __restrict__ l_part,
                      float* __restrict__ acc_part, int Hkv, int G, int S,
                      int hd, Strides qs, Strides ks, Strides vs,
                      int n_split, float scale) {
  __shared__ float qsm[G_MAX * HD_MAX];
  __shared__ float sc[G_MAX * CH];

  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int c0 = split * CH;
  const int n_valid = min(CH, min(*length_p, S) - c0);
  if (n_valid <= 0) return;  // left out of the combine

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h + (long long)c0 * ks.s;
  const T* vb = v + b * vs.b + h * vs.h + (long long)c0 * vs.s;
  for (int e = tid; e < G * hd; e += THREADS) {
    const int g = e / hd, d = e % hd;
    qsm[g * hd + d] = to_f(qb[g * qs.s + d]);
  }
  __syncthreads();

  for (int c = warp; c < n_valid; c += WARPS) {
    float kr[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      kr[i] = d < hd ? to_f(kb[c * ks.s + d]) : 0.0f;
    }
    for (int g = 0; g < G; ++g) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) part = fmaf(qsm[g * hd + d], kr[i], part);
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) sc[g * CH + c] = part * scale;
    }
  }
  __syncthreads();

  const long long part0 = ((long long)bh * n_split + split) * G;
  for (int g = warp; g < G; g += WARPS) {
    float mx = NEG;
    for (int c = lane; c < n_valid; c += 32) mx = fmaxf(mx, sc[g * CH + c]);
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int c = lane; c < n_valid; c += 32) {
      const float p = expf(sc[g * CH + c] - mx);
      sum += p;
      sc[g * CH + c] = round_as(p, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      m_part[part0 + g] = mx;
      l_part[part0 + g] = sum;
    }
  }
  __syncthreads();

  for (int d = tid; d < hd; d += THREADS) {
    float acc[G_MAX];
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) acc[g] = 0.0f;
    for (int c = 0; c < n_valid; ++c) {
      const float vv = to_f(vb[c * vs.s + d]);
#pragma unroll
      for (int g = 0; g < G_MAX; ++g)
        if (g < G) acc[g] = fmaf(sc[g * CH + c], vv, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < G_MAX; ++g)
      if (g < G) acc_part[(part0 + g) * hd + d] = acc[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const int* __restrict__ length_p,
                      const float* __restrict__ m_part,
                      const float* __restrict__ l_part,
                      const float* __restrict__ acc_part,
                      T* __restrict__ out, int G, int S, int hd,
                      int n_split) {
  const int bh = blockIdx.x;
  const int n_used = (min(*length_p, S) + CH - 1) / CH;
  for (int g = 0; g < G; ++g) {
    float M = NEG;
    for (int s = 0; s < n_used; ++s)
      M = fmaxf(M, m_part[((long long)bh * n_split + s) * G + g]);
    float L = 0.0f;
    for (int s = 0; s < n_used; ++s) {
      const long long i = ((long long)bh * n_split + s) * G + g;
      L += l_part[i] * expf(m_part[i] - M);
    }
    const float denom = fmaxf(L, 1e-30f);
    for (int d = threadIdx.x; d < hd; d += THREADS) {
      float o = 0.0f;
      for (int s = 0; s < n_used; ++s) {
        const long long i = ((long long)bh * n_split + s) * G + g;
        o += acc_part[i * hd + d] * expf(m_part[i] - M);
      }
      store(out + ((long long)bh * G + g) * hd + d, o / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* out, void* m_part, void* l_part, void* acc_part, int B,
           int Hkv, int G, int S, int hd, Strides qs, Strides ks, Strides vs,
           float scale, cudaStream_t stream) {
  const int n_split = (S + CH - 1) / CH;
  dim3 grid(n_split, B * Hkv);
  decode_partial_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)length,
      (float*)m_part, (float*)l_part, (float*)acc_part, Hkv, G, S, hd, qs,
      ks, vs, n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<B * Hkv, THREADS, 0, stream>>>(
      (const int*)length, (const float*)m_part, (const float*)l_part,
      (const float*)acc_part, (T*)out, G, S, hd, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). Strides are
// in elements: q (b, h, g), k and v (b, h, s). Scratch: m_part and l_part
// hold B * Hkv * ceil(S / 64) * G floats, acc_part that times hd. Requires
// G <= 16 and hd <= 256.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* length,
    void* out, void* m_part, void* l_part, void* acc_part, int B, int Hkv,
    int G, int S, int hd, long long qsb, long long qsh, long long qsg,
    long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, float scale, int dtype, void* stream) {
  if (G < 1 || G > G_MAX || hd < 1 || hd > HD_MAX)
    return (int)cudaErrorInvalidValue;
  if (B * Hkv == 0 || S == 0) return (int)cudaGetLastError();
  const Strides qs{qsb, qsh, qsg}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, length, out, m_part, l_part,
                                 acc_part, B, Hkv, G, S, hd, qs, ks, vs,
                                 scale, st);
  return launch<float>(q, k, v, length, out, m_part, l_part, acc_part, B,
                       Hkv, G, S, hd, qs, ks, vs, scale, st);
}
