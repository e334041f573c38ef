// Hash-table gather for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hash_encoding_kernel.py:_hash_gather_kernel,
// reached through hash_gather.
//
// Computes out (P, F) = table[idx], with an index outside [0, T) giving a
// zero row. The TPU kernel re-expressed the gather as one-hot matmuls over
// table tiles because its vector unit has no per-lane gather; Hopper does,
// so this is a direct gather: one thread per (index, feature).
//
// What bounds it on this card: bytes. Each output element costs one 4-byte
// index read (shared by the F threads of a row, so served from L1) and one
// scattered 4-byte table read; the paper-width concatenated table is
// 46.5 MiB f32 and barely fits the 50 MB L2, so repeated rows of nearby
// samples mostly hit L2. The design keeps neighbouring threads on the
// features of one row (coalesced within a row) and touches each output
// once. The encode does not come here: csrc/hash_encode.cu fuses the
// gather with the trilinear sum and the first linear's codes, from sample
// points or from a plan's baked corners. This kernel serves the bare
// `ops.hash_gather` and the per-level gathers of a pack with no staged
// table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
hash_gather_kernel(const int32_t* __restrict__ idx,
                   const float* __restrict__ table,
                   float* __restrict__ out,
                   long long total, int T, int F) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long p = i / F;
  const int f = (int)(i - p * F);
  const int r = __ldg(&idx[p]);
  out[i] = (r >= 0 && r < T) ? __ldg(&table[(long long)r * F + f]) : 0.0f;
}

}  // namespace

extern "C" int repro_hash_gather(const void* idx, const void* table,
                                 void* out, int P, int T, int F,
                                 void* stream) {
  const long long total = (long long)P * F;
  if (total > 0) {
    const long long blocks = (total + THREADS - 1) / THREADS;
    hash_gather_kernel<<<(unsigned)blocks, THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const float*)table, (float*)out, total, T, F);
  }
  return (int)cudaGetLastError();
}
