// Fused multi-resolution hash encode for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hash_encoding_kernel.py:hash_gather (the
// Pallas gather) together with the composition around it on the serve
// path: src/repro/kernels/ops.py:hash_encode (one gather over the
// concatenated level tables, then the trilinear 8-corner sum) and the
// corner math of src/repro/nerf/hash_encoding.py:level_corner_data.
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
// With `codes`, out[b, l*F + f] = int8(clip(rint(enc / sx + zx_f), 0,
// qmax) - off) instead, the first linear's activation codes. The kernel is
// a template over F in {1, 2, 4, 8}, the feature counts the Instant-NGP
// paper (Mueller et al., 2022) sweeps; F = 2 is every configuration's.
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
// What bounds it on this card: bytes. HBM sees the points (12 B each),
// the table rows touched (8 B each; the 46.5 MiB paper table sits
// in the 50 MB L2 across calls) and the encodings (4 B a feature) or codes
// (1 B). The corner indices, weights and corner values stay in registers:
// the composition this replaces wrote each of them to device memory and
// read it back, over ~570 launches a slot. One thread per (point, level),
// point-major, so a warp covers 32 / L points x L levels: its loads of a
// point's 3 floats and its level rows of meta are broadcasts, each thread
// loads a corner row as one vector (a float2 at F = 2), and the warp's
// stores are one contiguous run (256 B at L = 16, F = 2).
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
