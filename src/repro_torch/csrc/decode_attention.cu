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
// the Pallas kernel's semantics. `length` is read from device memory, or
// passed by value (the decode step passes pos + 1).
//
// The partial form (flash-decoding over ranks, each holding a block of the
// cache's positions): with `lse` given, the kernel also writes the f32
// log-sum-exp of each head's scores, M + log L, and writes the output in
// f32 unrounded, so that the partials of several blocks combine exactly
// as the splits below do. A block of length <= 0 (wholly past the token)
// reads nothing: its output is zero and its log-sum-exp -inf.
//
// Design for the card. The TPU walked the cache on a sequential grid axis
// per (batch, KV head); at the decode shapes that is only B * Hkv = 16
// sequences, 16 of the card's 132 SMs. So the cache is split across
// blocks (flash-decoding), one launch in all:
//   1. Block (split, b * Hkv + h) requests q and every K and V row of its
//      split at once, 16 bytes a thread by cp.async (q and K, then V), so the
//      whole call's bytes are in flight together; the wrapper sizes the
//      split so that there are about three blocks a multiprocessor.
//   2. Q.K on the CUDA cores, one thread per (position, head):
//      neighbouring threads take neighbouring positions of one head, so q
//      is read by broadcast and, with each K row padded by one 16-byte
//      piece, the K reads fall on distinct banks; no cross-lane reduction.
//      With three blocks sharing a multiprocessor the phase is bound by
//      instructions: lanes along hd would need a shuffle tree and a fresh
//      read of q per position and head, 4.5x the cycles on an H100. Then
//      one warp per head takes the split's maximum and sum, and rounds p
//      to v's dtype.
//   3. P.V: all threads over (head, 16-byte column piece, share of the
//      positions), unrolled over the positions in shared memory; the
//      shares are summed into this split's partial (m, l, acc).
//   4. The last block of each (b, h) to finish, found by an atomicAdd
//      ticket after __threadfence(), combines the partials: the maxima and
//      sums once per head, warp-parallel, the factors exp(m_s - M) kept in
//      shared memory, then one pass over (head, column); it writes the
//      output (in q's dtype, or f32 in the partial form, with M + log L)
//      and resets its ticket to 0 for the next call.
// Splits that start at or past `length` return at once and take no
// ticket, so positions >= length are never read and never change the
// result.
//
// What bounds it on this card: bytes, in principle. Each step reads the K
// and V rows up to `length` once (2 * B * Hkv * length * hd * 2 bytes in
// bf16, ~8.5 MB per layer at the serve shapes: ~2.5 us at the memory
// rate); the partials add G * hd floats a block, written once and read
// once from L2; ~30 MFLOP a call need no tensor cores. In practice a call
// (~20 us at the serve shapes on an H100) is a chain of latencies per
// block: the loads, four phases with a barrier each, the ticket, and the
// combine's reads of the partials.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int G_MAX = 16;
constexpr int HD_MAX = 256;
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
// Four consecutive outputs (the address 4-element aligned).
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float round_as(float p, const float*) { return p; }
__device__ __forceinline__ float round_as(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// N consecutive values of a row in shared memory (16-byte aligned),
// widened to f32: one 16-byte piece of a K or V row, or of q in f32.
template <int N>
__device__ __forceinline__ void widen(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 u = reinterpret_cast<const float4*>(p)[i];
    x[4 * i] = u.x;
    x[4 * i + 1] = u.y;
    x[4 * i + 2] = u.z;
    x[4 * i + 3] = u.w;
  }
}
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 16 bytes from global to shared; only `bytes` are read, the rest of the
// 16 is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory layout of one block; the host sizes the launch with the
// same struct. K rows carry one extra 16-byte piece so that threads on
// consecutive positions read different banks.
struct Layout {
  int hdp;    // hd padded to whole 16-byte pieces
  int kst;    // K row stride in elements: hdp + one piece
  int parts;  // position shares of the PV product
  size_t k, v, qt, qf, sc, red, fac, den, bytes;  // byte offsets, total
  __host__ __device__ Layout(int esize, int G, int hd, int split,
                             int n_split) {
    const int epc = 16 / esize, nch = (hd + epc - 1) / epc;
    hdp = nch * epc;
    kst = hdp + epc;
    const int items = G * nch;
    parts = items >= THREADS ? 1 : THREADS / items;
    k = 0;
    v = k + (size_t)split * kst * esize;
    qt = v + (size_t)split * hdp * esize;      // q as given: G x hdp
    qf = qt + (size_t)G * hdp * esize;         // q in f32: G x hdp
    sc = qf + (size_t)G * hdp * 4;             // scores, then p: G x split
    red = sc + (((size_t)G * split * 4 + 15) & ~(size_t)15);  // parts x G x hdp
    fac = red + (size_t)parts * G * hdp * 4;   // exp(m_s - M): G x n_split
    den = fac + (size_t)G * n_split * 4;       // max(L, 1e-30): G
    bytes = den + (size_t)G * 4;
  }
};

// T: q, k and v; O: the output (T, or float in the partial form).
template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ length_p,
              int length_v, O* __restrict__ out, float* __restrict__ lse,
              float* __restrict__ m_part, float* __restrict__ l_part,
              float* __restrict__ acc_part, unsigned* __restrict__ tickets,
              int Hkv, int G, int S, int hd, Strides qs, Strides ks,
              Strides vs, int split, int n_split, float scale) {
  constexpr int EPC = 16 / sizeof(T);  // elements in 16 bytes
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;
  const Layout lay(sizeof(T), G, hd, split, n_split);
  const int hdp = lay.hdp, kst = lay.kst, nch = hdp / EPC;
  T* Ks = reinterpret_cast<T*>(smem + lay.k);        // split x kst
  T* Vs = reinterpret_cast<T*>(smem + lay.v);        // split x hdp
  T* qt = reinterpret_cast<T*>(smem + lay.qt);       // G x hdp
  float* qf = reinterpret_cast<float*>(smem + lay.qf);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* fac = reinterpret_cast<float*>(smem + lay.fac);
  float* den = reinterpret_cast<float*>(smem + lay.den);

  const int split_idx = blockIdx.x, bh = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int length = min(length_p ? *length_p : length_v, S);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (length <= 0) {  // an empty block: zero, and -inf for its lse
    if (split_idx == 0) {
      O* ob = out + (long long)bh * G * hd;
      for (int i = tid; i < G * hd; i += THREADS) store(ob + i, 0.0f);
      if (lse != nullptr)
        for (int g = tid; g < G; g += THREADS)
          lse[(long long)bh * G + g] = -INFINITY;
    }
    return;
  }
  const int c0 = split_idx * split;
  const int n_valid = min(split, length - c0);
  if (n_valid <= 0) return;  // takes no ticket: left out of the combine
  const int n_used = (length + split - 1) / split;

  // 1. q and every K row of the split, then every V row, in flight at once.
  //    Pieces are walked as (row, piece) with the pieces of a row on
  //    neighbouring threads (lpr a power of two >= nch).
  int lg = 0;
  while ((1 << lg) < nch) ++lg;
  const int lpr = 1 << lg;
  const T* kb = k + b * ks.b + h * ks.h + (long long)c0 * ks.s;
  const T* vb = v + b * vs.b + h * vs.h + (long long)c0 * vs.s;
  const T* qb = q + b * qs.b + h * qs.h;
  for (int e = tid; e < (G << lg); e += THREADS) {
    const int r = e >> lg, c = e & (lpr - 1);
    if (c < nch)
      cp_async16(qt + r * hdp + c * EPC, qb + r * qs.s + c * EPC,
                 min(16, (hd - c * EPC) * (int)sizeof(T)));
  }
  for (int e = tid; e < (n_valid << lg); e += THREADS) {
    const int r = e >> lg, c = e & (lpr - 1);
    if (c < nch)
      cp_async16(Ks + r * kst + c * EPC, kb + r * ks.s + c * EPC,
                 min(16, (hd - c * EPC) * (int)sizeof(T)));
  }
  cp_async_commit();
  for (int e = tid; e < (n_valid << lg); e += THREADS) {
    const int r = e >> lg, c = e & (lpr - 1);
    if (c < nch)
      cp_async16(Vs + r * hdp + c * EPC, vb + r * vs.s + c * EPC,
                 min(16, (hd - c * EPC) * (int)sizeof(T)));
  }
  cp_async_commit();
  cp_async_wait<1>();  // q and K have landed; V may still be in flight
  __syncthreads();
  for (int e = tid; e < G * hdp; e += THREADS) qf[e] = to_f(qt[e]);
  __syncthreads();

  // 2. Scores: one thread per (position, head), neighbouring threads on
  //    neighbouring positions of one head (q read by broadcast), four
  //    pieces of the row in flight.
  for (int it = tid; it < n_valid * G; it += THREADS) {
    const int g = it / n_valid, pos = it - g * n_valid;
    const T* kr = Ks + pos * kst;
    const float* qg = qf + g * hdp;
    float s = 0.0f;
#pragma unroll 4
    for (int c = 0; c < nch; ++c) {
      float kx[EPC], qx[EPC];
      widen(kr + c * EPC, kx);
      widen(qg + c * EPC, qx);
      float t = 0.0f;
#pragma unroll
      for (int i = 0; i < EPC; ++i) t = fmaf(qx[i], kx[i], t);
      s += t;
    }
    sc[g * split + pos] = s * scale;
  }
  __syncthreads();

  const long long part0 = ((long long)bh * n_split + split_idx) * G;
  for (int g = warp; g < G; g += WARPS) {
    float* sg = sc + g * split;
    float mx = NEG;
    for (int c = lane; c < n_valid; c += 32) mx = fmaxf(mx, sg[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int c = lane; c < n_valid; c += 32) {
      const float p = expf(sg[c] - mx);
      sum += p;
      sg[c] = round_as(p, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      m_part[part0 + g] = mx;
      l_part[part0 + g] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. P.V over (share, head, piece); the shares go to `red`, then their
  //    sum to this split's partial, four floats at a time.
  const int items = G * nch, parts = lay.parts;
  for (int it = tid; it < items * parts; it += THREADS) {
    const int sh = it / items, item = it - sh * items;
    const int g = item / nch, c = item - g * nch;
    const float* pg = sc + g * split;
    const T* vc = Vs + c * EPC;
    float acc[EPC];
#pragma unroll
    for (int i = 0; i < EPC; ++i) acc[i] = 0.0f;
#pragma unroll 4
    for (int pos = sh; pos < n_valid; pos += parts) {
      const float p = pg[pos];
      float vx[EPC];
      widen(vc + pos * hdp, vx);
#pragma unroll
      for (int i = 0; i < EPC; ++i) acc[i] = fmaf(p, vx[i], acc[i]);
    }
    float4* rp = reinterpret_cast<float4*>(red + (sh * G + g) * hdp + c * EPC);
#pragma unroll
    for (int i = 0; i < EPC / 4; ++i)
      rp[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                          acc[4 * i + 3]);
  }
  __syncthreads();
  const int n4 = G * hdp / 4;  // float4s of one split's partial
  float4* ap = reinterpret_cast<float4*>(acc_part + part0 * hdp);
  for (int i4 = tid; i4 < n4; i4 += THREADS) {
    float4 s4 = reinterpret_cast<const float4*>(red)[i4];
    for (int sh = 1; sh < parts; ++sh) {
      const float4 r = reinterpret_cast<const float4*>(red)[sh * n4 + i4];
      s4.x += r.x;
      s4.y += r.y;
      s4.z += r.z;
      s4.w += r.w;
    }
    ap[i4] = s4;
  }

  // 4. The last block of this (b, h) combines.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(tickets + bh, 1u) == (unsigned)(n_used - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid == 0) tickets[bh] = 0u;
  const float* mp = m_part + (long long)bh * n_split * G;
  const float* lp = l_part + (long long)bh * n_split * G;
  for (int g = warp; g < G; g += WARPS) {
    // Each lane keeps the (m, l) of its splits: one load of each.
    float mv[4], lv[4];
    float M = NEG;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = lane + 32 * j;
      mv[j] = s < n_used ? __ldcg(mp + s * G + g) : NEG;
      lv[j] = s < n_used ? __ldcg(lp + s * G + g) : 0.0f;
      M = fmaxf(M, mv[j]);
    }
    for (int s = lane + 128; s < n_used; s += 32)
      M = fmaxf(M, __ldcg(mp + s * G + g));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = lane + 32 * j;
      if (s < n_used) {
        const float f = expf(mv[j] - M);
        fac[g * n_used + s] = f;
        L += lv[j] * f;
      }
    }
    for (int s = lane + 128; s < n_used; s += 32) {
      const float f = expf(__ldcg(mp + s * G + g) - M);
      fac[g * n_used + s] = f;
      L += __ldcg(lp + s * G + g) * f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      L += __shfl_xor_sync(0xffffffffu, L, o);
    if (lane == 0) {
      den[g] = fmaxf(L, 1e-30f);
      if (lse != nullptr) lse[(long long)bh * G + g] = M + logf(L);
    }
  }
  __syncthreads();
  const float4* ab = reinterpret_cast<const float4*>(
      acc_part + (long long)bh * n_split * G * hdp);
  O* ob = out + (long long)bh * G * hd;
  for (int i4 = tid; i4 < n4; i4 += THREADS) {
    const int g = 4 * i4 / hdp, d = 4 * i4 - g * hdp;
    if (d >= hd) continue;
    const float* fg = fac + g * n_used;
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int s = 0; s < n_used; ++s) {
      const float4 a = __ldcg(ab + (long long)s * n4 + i4);
      const float f = fg[s];
      o.x += a.x * f;
      o.y += a.y * f;
      o.z += a.z * f;
      o.w += a.w * f;
    }
    const float dn = den[g];
    O* op = ob + g * hd + d;
    if ((hd & 3) == 0) {
      store4(op, o.x / dn, o.y / dn, o.z / dn, o.w / dn);
    } else {
      const float r[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (d + i < hd) store(op + i, r[i] / dn);
    }
  }
}

template <typename T, typename O>
int launch(const void* q, const void* k, const void* v, const void* length_p,
           int length_v, void* out, void* lse, void* m_part, void* l_part,
           void* acc_part, void* tickets, int B, int Hkv, int G, int S,
           int hd, Strides qs, Strides ks, Strides vs, int split,
           float scale, cudaStream_t stream) {
  const int n_split = (S + split - 1) / split;
  const size_t smem = Layout(sizeof(T), G, hd, split, n_split).bytes;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(n_split, B * Hkv);
  decode_kernel<T, O><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)length_p, length_v,
      (O*)out, (float*)lse, (float*)m_part, (float*)l_part, (float*)acc_part,
      (unsigned*)tickets, Hkv, G, S, hd, qs, ks, vs, split, n_split, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it; so does out,
// unless `lse` is given: then out is float32 and `lse` B * Hkv * G floats).
// Strides are in elements: q (b, h, g), k and v (b, h, s); q, k and v
// start on 16-byte boundaries with strides of whole 16-byte units.
// `length_p` points to an int32 on the device, or is null and `length_v`
// holds the length (<= 0: an empty block). `split` positions a block;
// scratch: m_part and l_part hold B * Hkv * ceil(S / split) * G floats,
// acc_part that times hdp (hd rounded up to whole 16-byte pieces), and
// `tickets` B * Hkv unsigned ints that are 0 before the first call (each
// call leaves them 0). Requires G <= 16 and hd <= 256.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* length_p,
    int length_v, void* out, void* lse, void* m_part, void* l_part,
    void* acc_part, void* tickets, int B, int Hkv, int G, int S, int hd,
    long long qsb, long long qsh, long long qsg, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, int split, float scale, int dtype, void* stream) {
  if (G < 1 || G > G_MAX || hd < 1 || hd > HD_MAX || split < 1)
    return (int)cudaErrorInvalidValue;
  if (B * Hkv == 0 || S == 0) return (int)cudaGetLastError();
  const Strides qs{qsb, qsh, qsg}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1 && lse != nullptr)
    return launch<__nv_bfloat16, float>(q, k, v, length_p, length_v, out,
                                        lse, m_part, l_part, acc_part,
                                        tickets, B, Hkv, G, S, hd, qs, ks, vs,
                                        split, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, length_p, length_v, out, lse, m_part, l_part, acc_part,
        tickets, B, Hkv, G, S, hd, qs, ks, vs, split, scale, st);
  return launch<float, float>(q, k, v, length_p, length_v, out, lse, m_part,
                              l_part, acc_part, tickets, B, Hkv, G, S, hd, qs,
                              ks, vs, split, scale, st);
}
