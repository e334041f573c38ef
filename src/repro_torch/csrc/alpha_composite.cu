// Volume-rendering alpha compositing for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/alpha_composite.py:_composite_kernel,
// reached through alpha_composite.
//
//   alpha_s = 1 - exp(-sigma_s * delta_s)
//   T_s     = prod_{j<s} (1 - alpha_j)        (exclusive)
//   color   = sum_s T_s * alpha_s * rgb_s ;  acc = sum_s T_s * alpha_s
//
// The TPU kernel walked sample chunks on a sequential grid axis with the
// transmittance carried in VMEM, and could only skip a whole block of rays
// once every ray in it had saturated. Here each thread owns one ray and
// walks its samples front to back with T in a register; with early_stop it
// leaves the loop as soon as its own T < t_eps. The samples skipped would
// add at most T < t_eps per channel, so the result is within t_eps of the
// dense walk.
//
// What bounds it on this card: bytes (5 * R * S * 4 read, 16 * R written)
// and, at serve shapes (R = 512, S = 32: 330 KB), the launch itself. The
// design reads each input element once and writes each output once; at
// this size nothing else is worth doing.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
alpha_composite_kernel(const float* __restrict__ sigma,
                       const float* __restrict__ rgb,
                       const float* __restrict__ delta,
                       float* __restrict__ color,
                       float* __restrict__ acc,
                       int R, int S, int early_stop, float t_eps) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const float* sg = sigma + (size_t)r * S;
  const float* dl = delta + (size_t)r * S;
  const float* rg = rgb + (size_t)r * S * 3;
  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, a = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float alpha = 1.0f - expf(-sg[s] * dl[s]);
    const float w = T * alpha;
    c0 += w * rg[3 * s + 0];
    c1 += w * rg[3 * s + 1];
    c2 += w * rg[3 * s + 2];
    a += w;
    T *= 1.0f - alpha;
    if (early_stop && T < t_eps) break;
  }
  color[3 * (size_t)r + 0] = c0;
  color[3 * (size_t)r + 1] = c1;
  color[3 * (size_t)r + 2] = c2;
  acc[r] = a;
}

}  // namespace

extern "C" int repro_alpha_composite(const void* sigma, const void* rgb,
                                     const void* delta, void* color,
                                     void* acc, int R, int S, int early_stop,
                                     float t_eps, void* stream) {
  if (R > 0) {
    alpha_composite_kernel<<<(R + THREADS - 1) / THREADS, THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const float*)sigma, (const float*)rgb, (const float*)delta,
        (float*)color, (float*)acc, R, S, early_stop, t_eps);
  }
  return (int)cudaGetLastError();
}
