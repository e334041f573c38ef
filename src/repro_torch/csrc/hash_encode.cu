// Fused multi-resolution hash encode for Hopper (sm_90a): two kernels, one
// for each form the encode's input takes.
//
// Replaces: src/repro/kernels/hash_encoding_kernel.py:hash_gather (the
// Pallas gather) together with the composition around it:
// src/repro/kernels/ops.py:hash_encode (one gather over the concatenated
// level tables, then the trilinear 8-corner sum) and fused_field_query
// (then the first linear's activation codes), and for the points form also
// the corner math of src/repro/nerf/hash_encoding.py:level_corner_data.
//
// - hash_encode_kernel: from sample points (the march and warp tiers, the
//   PSNR march path); it derives each level's corners itself.
// - hash_encode_corners_kernel: from baked corner data, the (L, B, 8)
//   indices and weights a cull plan carries (the hit tier, the PSNR plan
//   path); it skips the corner math and reads 64 B a (point, level).
//
// Computes, for point b (3 floats in [0, 1]) and level l, with the level's
// resolution res, direct flag, entries and row offset from meta[l]:
//   x = p * res, x0 = clamp(floor(x), 0, res), frac = x - floor(x);
//   corner c (bits (c & 1, c >> 1 & 1, c >> 2 & 1)) at clamp(x0 + bit, 0,
//   res), indexed directly (x + y*s + z*s^2, s = res + 1) or hashed
//   ((x*1 ^ y*2654435761 ^ z*805459861) mod entries), all in uint32;
//   weight w_c = (t0 * t1) * t2, t_a = bit ? frac_a : 1 - frac_a;
//   enc[b, l*F + f] = fma(v_7, w_7, ... fma(v_0, w_0, 0)), v_c the table
//   row at offset + index (a zero row outside the table).
// The corners kernel takes index and w_c from corner_idx[l, b, c] and
// corner_w[l, b, c], the offset from level_offsets[l], and sums the same
// chain. With `codes`, out[b, l*F + f] = int8(clip(rint(enc / sx + zx_f),
// 0, qmax) - off) instead, the first linear's activation codes. Both
// kernels are templates over F in {1, 2, 4, 8}, the feature counts the
// Instant-NGP paper (Mueller et al., 2022) sweeps; F = 2 is every
// configuration's.
//
// Exactness: the encodings must be bit-equal to the plain PyTorch
// composition, which reproduces the jitted reference's roundings, so that
// round(enc / sx + zx_f) flips no code. Every rounding is spelled out:
// __fmul_rn / __fsub_rn for the corner math (no contraction into FMAs),
// the weight's product order (t0 * t1) * t2, the 8-corner chain as
// __fmaf_rn from 0 in corner order, __fdiv_rn / __fadd_rn / rintf
// (half-even, as torch.round) for the codes. The build uses neither
// --use_fast_math nor flush-to-zero: the products in the chain can be
// subnormal.
//
// What bounds them on this card: bytes. HBM sees the points (12 B each)
// or the baked corners (64 B a point and level), the table rows touched
// (8 B each at F = 2; the 46.5 MiB paper table sits in the 50 MB L2
// across calls) and the encodings (4 B a feature) or codes (1 B). The
// corner indices, weights and corner values stay in registers: the
// compositions these replace wrote each of them to device memory and read
// it back (~570 launches a slot from points; from baked corners a gather
// of every corner value and ~110 launches of a float64 sum a chunk). One
// thread per (point, level), point-major, so a warp covers 32 / L points x
// L levels: its loads of a point's 3 floats and of the per-level metadata
// are broadcasts, each thread loads a corner row as one vector (a float2
// at F = 2), and the warp's stores are one contiguous run (256 B at
// L = 16, F = 2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t PRIME_Y = 2654435761u;
constexpr uint32_t PRIME_Z = 805459861u;

// The first linear's activation grid, each a one-element f32 in device
// memory (read there: no host sync). All null for the f32 encodings.
struct ActGrid {
  const float* sx;
  const float* zx_f;
  const float* qmax;
  const float* off;
};

// One table row of F features, as one vector load where F allows it
// (float2 for F = 2, float4s for F = 4 and 8); a zero row outside the
// table.
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ table,
                                         long long row, long long T,
                                         float (&v)[F]) {
  if (row < 0 || row >= T) {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = 0.0f;
  } else if constexpr (F == 1) {
    v[0] = __ldg(table + row);
  } else if constexpr (F == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(table) + row);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    const float4* p = reinterpret_cast<const float4*>(table) + row * (F / 4);
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 t = __ldg(p + q);
      v[4 * q + 0] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  }
}

// Writes one (point, level)'s F encodings at out + i * F: the f32 sums,
// or with CODES the first linear's int8 codes clip(rint(e / sx + zx_f), 0,
// qmax) - off, rounded as torch rounds them (half-even, no contraction).
template <int F, bool CODES>
__device__ __forceinline__ void store_encoding(const float (&acc)[F],
                                               ActGrid act, void* out,
                                               long long i) {
  if constexpr (CODES) {
    const float sx = __ldg(act.sx), zx_f = __ldg(act.zx_f);
    const float qmax = __ldg(act.qmax), off = __ldg(act.off);
    auto code = [&](float e) {
      const float q = rintf(__fadd_rn(__fdiv_rn(e, sx), zx_f));
      return (signed char)__float2int_rz(
          __fsub_rn(fminf(fmaxf(q, 0.0f), qmax), off));
    };
    signed char* o = static_cast<signed char*>(out) + i * F;
    if constexpr (F == 2) {
      *reinterpret_cast<char2*>(o) = make_char2(code(acc[0]), code(acc[1]));
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) o[f] = code(acc[f]);
    }
  } else {
    float* o = static_cast<float*>(out) + i * F;
    if constexpr (F == 1) {
      o[0] = acc[0];
    } else if constexpr (F == 2) {
      *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
    } else {
#pragma unroll
      for (int q = 0; q < F / 4; ++q) {
        reinterpret_cast<float4*>(o)[q] = make_float4(
            acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
      }
    }
  }
}

template <int F, bool CODES>
__global__ void __launch_bounds__(THREADS)
hash_encode_kernel(const float* __restrict__ points,
                   const float* __restrict__ table,
                   const int4* __restrict__ meta, ActGrid act,
                   void* __restrict__ out, long long total, int L,
                   long long T) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long b = i / L;
  const int l = (int)(i - b * L);
  const int4 m = __ldg(meta + l);  // res, direct, entries, row offset
  const int res = m.x;
  const float resf = (float)res;
  int x0[3];
  float fr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x = __fmul_rn(__ldg(points + 3 * b + a), resf);
    const float xf = floorf(x);
    fr[a] = __fsub_rn(x, xf);
    const int xi = __float2int_rz(xf);
    x0[a] = xi < 0 ? 0 : (xi > res ? res : xi);
  }
  const uint32_t stride = (uint32_t)res + 1u;
  const uint32_t entries = (uint32_t)m.z;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    uint32_t cc[3];
    float t[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int bit = (c >> a) & 1;
      const int v = x0[a] + bit;
      cc[a] = (uint32_t)(v > res ? res : v);
      t[a] = bit ? fr[a] : __fsub_rn(1.0f, fr[a]);
    }
    const uint32_t h =
        m.y ? cc[0] + cc[1] * stride + cc[2] * stride * stride
            : (cc[0] ^ (cc[1] * PRIME_Y) ^ (cc[2] * PRIME_Z)) % entries;
    float v[F];
    load_row<F>(table, (long long)m.w + (long long)(int32_t)h, T, v);
    const float w = __fmul_rn(__fmul_rn(t[0], t[1]), t[2]);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fmaf_rn(v[f], w, acc[f]);
  }
  store_encoding<F, CODES>(acc, act, out, i);
}

template <int F>
void launch_encode(const float* p, const float* tab, const int4* m,
                   ActGrid act, void* out, long long total, int L, int T,
                   int codes, cudaStream_t s) {
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (codes) {
    hash_encode_kernel<F, true><<<blocks, THREADS, 0, s>>>(p, tab, m, act,
                                                           out, total, L, T);
  } else {
    hash_encode_kernel<F, false><<<blocks, THREADS, 0, s>>>(p, tab, m, act,
                                                            out, total, L, T);
  }
}

// The same encode from baked corner data, as a cull plan carries it: the
// (L, B, 8) corner indices (each within its level's table) and trilinear
// weights. A block takes PB = THREADS / L points. Their corner data lie
// in L runs of PB x 32 B, one a level (512 B at L = 16), which the block
// first copies into shared memory with coalesced 16-byte loads (streamed
// and marked evict-first: each is read once, and the table should keep
// L2), each level's run padded by 16 B so that the reads below meet no
// bank conflict. Then one thread per (point, level), point-major as
// above, reads its 8 indices and 8 weights there, adds its level's row
// offset in 32 bits with wrap-around, as the plain version's int32 sum
// does, and loads the 8 corner rows, a zero row outside [0, T). Against
// per-thread 16-byte loads of the same data straight from device memory,
// staging took chip_smoke.py's paper slot from 0.0248 to 0.0233 ms and an
// evaluation chunk from 0.0682 to 0.0549 ms on an H100 SXM (PERF.md).
template <int F, bool CODES>
__global__ void __launch_bounds__(THREADS)
hash_encode_corners_kernel(const int4* __restrict__ idx,
                           const float4* __restrict__ wts,
                           const float* __restrict__ table,
                           const int* __restrict__ offsets,
                           ActGrid act, void* __restrict__ out, int B, int L,
                           long long T) {
  // L runs of 2 PB + 1 vectors: at most 2 THREADS + L <= 3 THREADS.
  __shared__ int4 s_idx[3 * THREADS];
  __shared__ float4 s_w[3 * THREADS];
  const int PB = THREADS / L, RUN = 2 * PB + 1;
  const long long b0 = (long long)blockIdx.x * PB;
  const int nb = (int)((long long)B - b0 < PB ? (long long)B - b0 : PB);
  for (int e = threadIdx.x; e < L * 2 * nb; e += THREADS) {
    const int l = e / (2 * nb), r = e - l * 2 * nb;
    const long long g = ((long long)l * B + b0) * 2 + r;
    s_idx[l * RUN + r] = __ldcs(idx + g);
    s_w[l * RUN + r] = __ldcs(wts + g);
  }
  __syncthreads();
  const int bl = threadIdx.x / L, l = threadIdx.x - bl * L;
  if (bl >= nb) return;
  const int s = l * RUN + 2 * bl;
  const int4 i0 = s_idx[s], i1 = s_idx[s + 1];
  const float4 w0 = s_w[s], w1 = s_w[s + 1];
  const int ci[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
  const float cw[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const uint32_t off = (uint32_t)__ldg(offsets + l);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float v[F];
    load_row<F>(table, (long long)(int32_t)((uint32_t)ci[c] + off), T, v);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fmaf_rn(v[f], cw[c], acc[f]);
  }
  store_encoding<F, CODES>(acc, act, out, (b0 + bl) * L + l);
}

template <int F>
void launch_corners(const int4* idx, const float4* w, const float* tab,
                    const int* offsets, ActGrid act, void* out, int B, int L,
                    int T, int codes, cudaStream_t s) {
  const int PB = THREADS / L;
  const unsigned blocks = (unsigned)((B + PB - 1) / PB);
  if (codes) {
    hash_encode_corners_kernel<F, true><<<blocks, THREADS, 0, s>>>(
        idx, w, tab, offsets, act, out, B, L, T);
  } else {
    hash_encode_corners_kernel<F, false><<<blocks, THREADS, 0, s>>>(
        idx, w, tab, offsets, act, out, B, L, T);
  }
}

}  // namespace

extern "C" int repro_hash_encode(const void* points, const void* table,
                                 const void* meta, const void* sx,
                                 const void* zx_f, const void* qmax,
                                 const void* off, void* out, int B, int L,
                                 int T, int F, int codes, void* stream) {
  const long long total = (long long)B * L;
  if (total > 0) {
    const ActGrid act{(const float*)sx, (const float*)zx_f,
                      (const float*)qmax, (const float*)off};
    cudaStream_t s = (cudaStream_t)stream;
    auto* p = (const float*)points;
    auto* tab = (const float*)table;
    auto* m = (const int4*)meta;
    switch (F) {
      case 1: launch_encode<1>(p, tab, m, act, out, total, L, T, codes, s);
        break;
      case 2: launch_encode<2>(p, tab, m, act, out, total, L, T, codes, s);
        break;
      case 4: launch_encode<4>(p, tab, m, act, out, total, L, T, codes, s);
        break;
      case 8: launch_encode<8>(p, tab, m, act, out, total, L, T, codes, s);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_hash_encode_corners(const void* corner_idx,
                                         const void* corner_w,
                                         const void* table,
                                         const void* level_offsets,
                                         const void* sx, const void* zx_f,
                                         const void* qmax, const void* off,
                                         void* out, int B, int L, int T,
                                         int F, int codes, void* stream) {
  if (B > 0 && L > 0) {
    if (L > THREADS) return (int)cudaErrorInvalidValue;  // a point a block
    const ActGrid act{(const float*)sx, (const float*)zx_f,
                      (const float*)qmax, (const float*)off};
    cudaStream_t s = (cudaStream_t)stream;
    auto* ix = (const int4*)corner_idx;
    auto* w = (const float4*)corner_w;
    auto* tab = (const float*)table;
    auto* o = (const int*)level_offsets;
    switch (F) {
      case 1: launch_corners<1>(ix, w, tab, o, act, out, B, L, T, codes, s);
        break;
      case 2: launch_corners<2>(ix, w, tab, o, act, out, B, L, T, codes, s);
        break;
      case 4: launch_corners<4>(ix, w, tab, o, act, out, B, L, T, codes, s);
        break;
      case 8: launch_corners<8>(ix, w, tab, o, act, out, B, L, T, codes, s);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
