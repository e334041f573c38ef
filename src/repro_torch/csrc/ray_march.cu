// Occupancy-grid ray march for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ray_march.py:_ray_march_kernel, reached
// through ray_march.
//
// Computes the active mask out (R, S) f32 {0, 1}: sample s of ray r, at
// p = o + d * t[s], is active iff p lies strictly inside (-0.5, 0.5)^3 and
// its cell of the (G, G, G) unit-cube grid has occ > 0.5. The cell index
// is trunc(clip(p + 0.5, 0, 1) * G) clipped to [0, G - 1].
//
// Exactness: the mask must be bit-equal to the plain PyTorch version and
// to the host numpy oracle (the serve engine's budget and the march ==
// scatter byte-parity rest on it). Those compute o + d * t as a multiply
// and a separate add, so this file uses __fmul_rn / __fadd_rn: nvcc would
// otherwise contract them into one FMA and move points across cell faces.
//
// Design: one warp per ray, lane k on sample s0 + k of each stride of 32
// samples. At the serve shape (R = 512, S = 32) that is 512 warps spread
// over the card's SMs, each lane doing one grid load, where one thread a
// ray walked 32 dependent loads in sequence on 4 blocks; each stride's
// mask is one coalesced 128-byte store.
//
// Early exit: the TPU kernel skipped whole sample chunks once a chunk was
// past every ray's analytic slab-test exit. Here a warp leaves its ray
// once every lane's point of a stride lies beyond a face the ray is
// moving away from (d > 0 and p >= 0.5, or d < 0 and p <= -0.5, on some
// axis): every later point does too, because t is non-decreasing and
// rounded multiplication and addition are monotone. So the warp writes
// exact zeros for the rest of the row; no rounding of an analytic exit t
// can cut off a sample the plain version keeps.
//
// What bounds it on this card: at serve shapes (R = 512, S = 32, G = 32)
// the launch; the bytes are the rays (12 KB), the mask written (64 KB)
// and the grid cells touched (at most 128 KB, from L2). The grid is read
// directly through the read-only cache.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // rays a block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
ray_march_kernel(const float* __restrict__ occ,
                 const float* __restrict__ rays_o,
                 const float* __restrict__ rays_d,
                 const float* __restrict__ t,
                 float* __restrict__ out,
                 int R, int S, int G, int early_stop) {
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;  // the whole warp: r is the warp's
  float o[3], d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = __ldg(&rays_o[3 * (size_t)r + a]);
    d[a] = __ldg(&rays_d[3 * (size_t)r + a]);
  }
  const float g = (float)G;
  float* row = out + (size_t)r * S;
  int s0 = 0;
  for (; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    bool past = true;  // a lane beyond the row's end counts as past
    if (s < S) {
      const float ts = __ldg(&t[s]);
      float p[3];
      bool inside = true;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        p[a] = __fadd_rn(o[a], __fmul_rn(d[a], ts));
        inside = inside && (p[a] > -0.5f) && (p[a] < 0.5f);
      }
      float v = 0.0f;
      if (inside) {
        int c[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float u = __fadd_rn(p[a], 0.5f);
          u = fminf(fmaxf(u, 0.0f), 1.0f);
          int ci = __float2int_rz(__fmul_rn(u, g));
          c[a] = ci < 0 ? 0 : (ci > G - 1 ? G - 1 : ci);
        }
        const float cell =
            __ldg(&occ[((size_t)c[0] * G + c[1]) * G + c[2]]);
        v = cell > 0.5f ? 1.0f : 0.0f;
        past = false;
      } else {
        bool gone = false;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          gone = gone || (d[a] > 0.0f && p[a] >= 0.5f) ||
                 (d[a] < 0.0f && p[a] <= -0.5f);
        }
        past = gone;
      }
      row[s] = v;
    }
    if (early_stop && __all_sync(FULL, past)) {
      s0 += 32;
      break;
    }
  }
  for (; s0 < S; s0 += 32) {  // past the exit: exact zeros
    const int s = s0 + lane;
    if (s < S) row[s] = 0.0f;
  }
}

}  // namespace

extern "C" int repro_ray_march(const void* occ, const void* rays_o,
                               const void* rays_d, const void* t, void* out,
                               int R, int S, int G, int early_stop,
                               void* stream) {
  if (R > 0 && S > 0) {
    ray_march_kernel<<<(R + WARPS - 1) / WARPS, THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const float*)occ, (const float*)rays_o, (const float*)rays_d,
        (const float*)t, (float*)out, R, S, G, early_stop);
  }
  return (int)cudaGetLastError();
}
