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
//   enc[b, l*2 + f] = fma(v_7, w_7, ... fma(v_0, w_0, 0)), v_c the table
//   row at offset + index (a zero row outside the table).
// With `codes`, out[b, l*2 + f] = int8(clip(rint(enc / sx + zx_f), 0,
// qmax) - off) instead, the first linear's activation codes.
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
// loads a corner row as one float2, and the warp's
// stores are one contiguous run (256 B at L = 16). F = 2 features a
// level, as every configuration of the repository has.
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

template <bool CODES>
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
  float2 acc = make_float2(0.0f, 0.0f);
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
    const long long row = (long long)m.w + (long long)(int32_t)h;
    const float2 v = (row >= 0 && row < T)
                         ? __ldg(reinterpret_cast<const float2*>(table) + row)
                         : make_float2(0.0f, 0.0f);
    const float w = __fmul_rn(__fmul_rn(t[0], t[1]), t[2]);
    acc.x = __fmaf_rn(v.x, w, acc.x);
    acc.y = __fmaf_rn(v.y, w, acc.y);
  }
  if constexpr (CODES) {
    const float sx = __ldg(act.sx), zx_f = __ldg(act.zx_f);
    const float qmax = __ldg(act.qmax), off = __ldg(act.off);
    auto code = [&](float e) {
      const float q = rintf(__fadd_rn(__fdiv_rn(e, sx), zx_f));
      return (signed char)__float2int_rz(
          __fsub_rn(fminf(fmaxf(q, 0.0f), qmax), off));
    };
    static_cast<char2*>(out)[i] = make_char2(code(acc.x), code(acc.y));
  } else {
    static_cast<float2*>(out)[i] = acc;
  }
}

}  // namespace

extern "C" int repro_hash_encode(const void* points, const void* table,
                                 const void* meta, const void* sx,
                                 const void* zx_f, const void* qmax,
                                 const void* off, void* out, int B, int L,
                                 int T, int codes, void* stream) {
  const long long total = (long long)B * L;
  if (total > 0) {
    const ActGrid act{(const float*)sx, (const float*)zx_f,
                      (const float*)qmax, (const float*)off};
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    auto* p = (const float*)points;
    auto* tab = (const float*)table;
    auto* m = (const int4*)meta;
    if (codes) {
      hash_encode_kernel<true><<<blocks, THREADS, 0, s>>>(p, tab, m, act,
                                                          out, total, L, T);
    } else {
      hash_encode_kernel<false><<<blocks, THREADS, 0, s>>>(p, tab, m, act,
                                                           out, total, L, T);
    }
  }
  return (int)cudaGetLastError();
}
