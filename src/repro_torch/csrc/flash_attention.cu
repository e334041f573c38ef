// Flash-attention forward (grouped-query, causal or full) for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention_kernel.py:_flash_kernel,
// reached through flash_attention.
//
// q (B, Hkv, S, G, hd) holds the G query heads of each KV head; k, v are
// (B, Hkv, Sk, hd): Sk keys, Sk == S for causal attention, any Sk >= 1 for
// full attention (an encoder's self-attention, a decoder's cross-attention
// over the encoder's Sk positions). Every operand is addressed through its strides (the
// innermost axis contiguous), so the model passes views of its (B, S, H, hd)
// projections and no copy is made. For each query row:
//   s   = (q . k) * scale in f32, masked entries set to -1e30;
//   online softmax over key tiles: m_new = max(m, max s), corr = exp(m -
//   m_new), p = exp(s - m_new), l = l * corr + sum p (p in f32),
//   acc = acc * corr + round_to_v_dtype(p) @ v;
//   out = acc / max(l, 1e-30), f32.
// These are the Pallas kernel's semantics, step for step.
//
// Shared by every route. The TPU walked key tiles on a sequential grid
// axis with the accumulators carried in VMEM; here one block owns a tile
// of query rows of one (batch, KV head) and loops over the key tiles
// itself, so nothing carries between blocks. The rows of a tile are the
// flattened (query position, head-in-group) pairs: the G heads of a KV head
// share every K/V tile staged in shared memory, which is the point of the
// grouped layout, and a G that is not a power of two (7 at qwen2-7b) only
// changes which query position a row masks with (row / G). Causal tiles
// lying wholly above the diagonal are skipped, which the TPU could not do;
// this is exact, because the first tile always holds key 0, so m is finite
// after it and a fully masked tile would add exp(-1e30 - m) = 0 with
// corr = 1.
//
// `flash_route` (kernels/flash_attention_kernel.py) picks the route, by the
// dtype and the head dim; none gives way to another:
//
// - bfloat16, hd > 64: the tensor-core kernel `flash_tc_kernel`. Two
//   consumer warpgroups own 64 rows each (128 a block). S = Q K^T is
//   wgmma m64n64k16 with Q and K read from shared memory; O += P V is
//   wgmma m64n128k16 with P in registers (the S accumulator converted to
//   bf16 pairs is the A fragment, as in FlashAttention-3) and V read from
//   shared memory through the transpose bit (V's rows are keys, hd
//   contiguous). Q is staged once; K and V tiles go through a two-stage
//   ring, tile t + 1 loading by cp.async (16 bytes a thread, straight from
//   the strided views, no tensor map) while tile t is computed. Shared
//   memory holds 128-byte-swizzled panels of 64 rows x 64 columns, hd
//   zero-padded to 128 (the padded columns add 0 and are never stored).
//   l sums the unrounded f32 p; the PV product takes p rounded to bf16;
//   exp is ex2.approx of s * scale * log2 e - m, one multiply-add. Query
//   tiles run longest first (the tile index reversed) to balance the
//   causal triangle. Two blocks share a multiprocessor (128 registers a
//   thread, 97 KB of shared memory a block), so one block's softmax runs
//   while the other's products do: at the serve shapes on an NVIDIA H100
//   80GB HBM3 (700 W) that is 1.2x faster than one block of 168 registers.
//   The copies, swizzled panels, descriptors and wgmma forms are in
//   wgmma_tile.cuh, shared with the backward (flash_attention_bwd.cu).
// - bfloat16, hd <= 64: `flash_tcp_kernel<64>`, the same rows, 64-key
//   tiles and arithmetic on one 64-column panel a tile: Q K^T in 4 k-steps
//   where
//   the hd-128 kernel takes 8, P V as m64n64k16 with 32 accumulators a
//   thread where it keeps 64 (at hd 64 half of its products, staged bytes
//   and accumulators are padding). What that frees goes to
//   FlashAttention-3's intra-warpgroup overlap: S of tile t is issued with
//   P V of tile t - 1 behind it, and tile t's softmax runs while that PV
//   does. P is packed to bf16 only after the PV's wait, and pinned there:
//   ptxas serialises every product of a kernel in which a register that an
//   in-flight wgmma reads is written. Masks are applied only on tiles that
//   reach past Sk or past the diagonal of the warpgroup's first row. A
//   three-stage cp.async ring (tile t + 1 lands while tile t is computed),
//   65 KB a block, two blocks a multiprocessor. Chosen on an NVIDIA H100
//   80GB HBM3 (700 W) by scripts/torch_attention_routes.py (PERF.md
//   section 6): three stages were 1-4 % faster than four; a warp-
//   specialised form (four producer warps on an mbarrier ring, the two
//   consumer warpgroups taking turns on named barriers, 128-key tiles,
//   one block a multiprocessor) was 1-26 % faster at the non-causal
//   shapes but 10-25 % slower at the causal ones, and is not kept. The
//   kernel is written for HDP / 64 panels a tile and shares Q's staging
//   and the epilogue with `flash_tc_kernel`; with two panels (hd 128) its
//   129 KB of shared memory leave one block a multiprocessor, and it is
//   15 % slower than `flash_tc_kernel` at qwen2-7b's prefill shape, so the
//   hd-128 route keeps the in-step kernel (TC128_PIPELINED).
// - float32: `flash_f32_kernel`, products on the CUDA cores in f32 out of
//   shared memory (a 4 x 4 score and a 4 x 8 output micro-tile per
//   thread). TF32 tensor cores would miss the float32 band (1e-4) that
//   the card-vs-CPU model check holds this route to.
//
// What bounds it on this card: at the prefill shapes (B=4, Hkv=4, S=1024,
// G=7, hd=128, causal, bf16) the two bounds are close: ~3.0e10 FLOP per
// call at the bf16 tensor-core rate and ~96 MB of operands (the 58.7 MB
// f32 output is the largest) at the memory rate, both ~0.03 ms. The bf16
// routes keep both products on the tensor cores and every K/V byte in
// flight behind the compute of the previous tile. At hd 64 the
// exponentials weigh as much as the products: at whisper's encoder (B 4,
// 20 heads, 1,500 over 1,500) its 1.8e8 scores at the special-function
// unit's 16 ex2 a clock per multiprocessor take about as long as the two
// products at the bf16 rate (~0.05 ms each), so only overlapping the two
// reaches the bound; within a block the two warpgroups still run in step
// (one barrier a tile), and only the other block on the multiprocessor
// fills the products' gaps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int HD_MAX = 128;

struct Strides {
  long long b, h, s, g;  // element strides; g unused for k and v
};

// ---------------------------------------------------------------------------
// bfloat16: wgmma tiles.
// ---------------------------------------------------------------------------
constexpr int TC_ROWS = 128;              // query rows a block: 2 x 64
constexpr int TC_KEYS = 64;               // keys a tile
constexpr int TC_THREADS = 256;           // 2 warpgroups
constexpr int Q_BYTES = 2 * 2 * PANEL;    // [warpgroup][hd panel] panels
constexpr int KV_BYTES = 2 * PANEL;       // one K or V tile: 2 hd panels
constexpr int STAGE_BYTES = 2 * KV_BYTES; // K then V
constexpr int TC_SMEM = Q_BYTES + 2 * STAGE_BYTES + 1024;  // + alignment

// a / d correctly rounded, from r = 1 / d (correctly rounded): q = a r,
// then one fused multiply-add on the exact remainder a - d q (Markstein's
// correction), three instructions where a division takes a dozen. Exact
// while nothing over- or underflows; here d = l >= 1 (the row's maximum
// adds p = 1).
__device__ __forceinline__ float quot(float a, float d, float r) {
  const float q = __fmul_rn(a, r);
  return fmaf(fmaf(-d, q, a), r, q);
}

// Q's rows [r0, r0 + 128) of one (batch, KV head) into the two
// warpgroups' 64 x HDP swizzled tiles at sQ (HDP / 64 panels each); row
// (s, g) at s * qs.s + g * qs.g, rows past S and columns past hd
// zero-filled. Not committed.
template <int HDP>
__device__ __forceinline__ void stage_q(uint32_t sQ,
                                        const __nv_bfloat16* qb,
                                        const Strides& qs, int r0, int S,
                                        int G, int hd, int tid) {
  constexpr int CH = HDP / 8, LOG_CH = HDP == 128 ? 4 : 3;
#pragma unroll
  for (int i = 0; i < TC_ROWS * CH / TC_THREADS; ++i) {
    const int e = tid + i * TC_THREADS;
    const int r = e >> LOG_CH, c = e & (CH - 1);
    const int row = r0 + r, s = row / G, g = row - s * G;
    const int bytes = s < S ? min(16, max(0, (hd - c * 8) * 2)) : 0;
    const __nv_bfloat16* p = bytes ? qb + s * qs.s + g * qs.g + c * 8 : qb;
    cp_async16(sQ + (r >> 6) * (HDP / 64) * PANEL + swz(r & 63, c, PANEL), p,
               bytes);
  }
}

// The epilogue of the bfloat16 kernels, for a thread's two rows rowA and
// rowA + 8 of its warpgroup's 64 x HDP accumulator `o`: l summed over the
// row's four lanes, the log-sum-exp m + log l written when `lse` is not
// null (m is kept in log2 units), and out = o / max(l, 1e-30) in f32;
// rows past S and columns past hd are not stored.
template <int HDP>
__device__ __forceinline__ void store_rows(const float (&o)[HDP / 2],
                                           float mA, float mB, float lA,
                                           float lB, int rowA, int lane,
                                           int bh, int b, int h, int S,
                                           int G, int hd, float* out,
                                           float* lse, const Strides& os) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    lA += __shfl_xor_sync(0xffffffffu, lA, off);
    lB += __shfl_xor_sync(0xffffffffu, lB, off);
  }
  const int rowB = rowA + 8, col0 = 2 * (lane & 3);
  const float dA = fmaxf(lA, 1e-30f), dB = fmaxf(lB, 1e-30f);
  const float rA = 1.0f / dA, rB = 1.0f / dB;
  const int sA = rowA / G, gA = rowA - sA * G, sB = rowB / G,
            gB = rowB - sB * G;
  if (lse != nullptr && (lane & 3) == 0) {
    float* lb = lse + (long long)bh * S * G;
    if (sA < S) lb[rowA] = (mA + log2f(dA)) * 0.6931471805599453f;
    if (sB < S) lb[rowB] = (mB + log2f(dB)) * 0.6931471805599453f;
  }
  float* oA = out + b * os.b + h * os.h + sA * os.s + gA * os.g;
  float* oB = out + b * os.b + h * os.h + sB * os.s + gB * os.g;
  const bool pairs = (hd & 1) == 0;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = 8 * j + col0;
    if (d >= hd) continue;
    if (pairs) {
      if (sA < S)
        *reinterpret_cast<float2*>(oA + d) =
            make_float2(quot(o[4 * j], dA, rA), quot(o[4 * j + 1], dA, rA));
      if (sB < S)
        *reinterpret_cast<float2*>(oB + d) =
            make_float2(quot(o[4 * j + 2], dB, rB), quot(o[4 * j + 3], dB, rB));
    } else {
      if (sA < S) oA[d] = quot(o[4 * j], dA, rA);
      if (sB < S) oB[d] = quot(o[4 * j + 2], dB, rB);
      if (d + 1 < hd) {
        if (sA < S) oA[d + 1] = quot(o[4 * j + 1], dA, rA);
        if (sB < S) oB[d + 1] = quot(o[4 * j + 3], dB, rB);
      }
    }
  }
}

__global__ void __launch_bounds__(TC_THREADS, 2)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, float* __restrict__ out,
                float* __restrict__ lse, int Hkv, int S, int Sk, int G,
                int hd, Strides qs, Strides ks, Strides vs, Strides os,
                int causal, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sKV = base + Q_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // longest first
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  const int qmax = min((r0 + TC_ROWS - 1) / G, S - 1);
  const int n_tiles =
      causal ? qmax / TC_KEYS + 1 : (Sk + TC_KEYS - 1) / TC_KEYS;

  stage_q<128>(sQ, qb, qs, r0, S, G, hd, tid);
  load_tile<TC_THREADS>(sKV, kb, ks.s, Sk, hd, tid);
  load_tile<TC_THREADS>(sKV + KV_BYTES, vb, vs.s, Sk, hd, tid);
  cp_async_commit();
  if (n_tiles > 1) {
    load_tile<TC_THREADS>(sKV + STAGE_BYTES, kb + TC_KEYS * ks.s, ks.s,
                          Sk - TC_KEYS, hd, tid);
    load_tile<TC_THREADS>(sKV + STAGE_BYTES + KV_BYTES, vb + TC_KEYS * vs.s,
                          vs.s, Sk - TC_KEYS, hd, tid);
  }
  cp_async_commit();

  // This thread's two rows of its warpgroup's 64 (the accumulator layout).
  const int rowA = r0 + wg * 64 + warp * 16 + (lane >> 2);
  const int rowB = rowA + 8;
  const int qposA = rowA / G, qposB = rowB / G;
  const int col0 = 2 * (lane & 3);
  const uint32_t sQw = sQ + wg * 2 * PANEL;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.0f;
  float mA = NEG, mB = NEG, lA = 0.0f, lB = 0.0f;  // l: this thread's part

  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t sK = sKV + (t & 1) * STAGE_BYTES, sV = sK + KV_BYTES;
    cp_async_wait<1>();  // tile t (and Q) landed; tile t + 1 may be in flight
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD_MAX / 16; ++kk) {  // all 8: padding adds 0
      const uint32_t off = (kk >> 2) * PANEL + (kk & 3) * 32;
      wgmma_ss_64x64(sc, desc128(sQw + off, 16, 1024),
                     desc128(sK + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    const int k0 = t * TC_KEYS;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + col0 + c;
        if (key >= Sk || (causal && key > qposA)) sc[4 * j + c] = NEG;
        if (key >= Sk || (causal && key > qposB)) sc[4 * j + 2 + c] = NEG;
      }
    }
    // Maxima in the log2 domain (scale * log2 e > 0 commutes with max);
    // p = 2^(s * scale_log2 - m) in one multiply-add.
    float mxA = NEG, mxB = NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mxA = fmaxf(mxA, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mxB = fmaxf(mxB, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, off));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, off));
    }
    const float mnA = fmaxf(mA, mxA * scale_log2);
    const float mnB = fmaxf(mB, mxB * scale_log2);
    const float corrA = fast_exp2(mA - mnA), corrB = fast_exp2(mB - mnB);
    mA = mnA;
    mB = mnB;
    float sumA = 0.0f, sumB = 0.0f;
    uint32_t pf[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float pa0 = fast_exp2(fmaf(sc[4 * j], scale_log2, -mnA));
      const float pa1 = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -mnA));
      const float pb0 = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -mnB));
      const float pb1 = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -mnB));
      sumA += pa0 + pa1;
      sumB += pb0 + pb1;
      pf[2 * j] = pack_bf16(pa0, pa1);      // row A, keys 8j + col0 + {0,1}
      pf[2 * j + 1] = pack_bf16(pb0, pb1);  // row B
    }
    lA = lA * corrA + sumA;
    lB = lB * corrB + sumB;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[4 * j] *= corrA;
      o[4 * j + 1] *= corrA;
      o[4 * j + 2] *= corrB;
      o[4 * j + 3] *= corrB;
    }

    // O += P V: 4 steps of 16 keys; the A fragment of step kk is the score
    // fragment of key groups 2kk and 2kk + 1.
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_KEYS / 16; ++kk) {
      const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                             pf[4 * kk + 3]};
      wgmma_rs_64x128(o, a, desc128(sV + kk * 16 * 128, PANEL, 1024));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    __syncthreads();  // both warpgroups are done with this stage

    if (t + 2 < n_tiles) {
      const int k2 = (t + 2) * TC_KEYS;
      load_tile<TC_THREADS>(sK, kb + k2 * ks.s, ks.s, Sk - k2, hd, tid);
      load_tile<TC_THREADS>(sV, vb + k2 * vs.s, vs.s, Sk - k2, hd, tid);
    }
    cp_async_commit();  // (possibly empty: keeps the group count in step)
  }
  cp_async_wait<0>();
  store_rows<128>(o, mA, mB, lA, lB, rowA, lane, bh, b, h, S, G, hd, out,
                  lse, os);
}

// ---------------------------------------------------------------------------
// bfloat16, the products pipelined: HDP / 64 panels of 64 columns a tile.
// ---------------------------------------------------------------------------
constexpr int TCP_STAGES = 3;  // K/V ring depth
// The kernel of the bfloat16 route at hd > 64: 0 the in-step
// `flash_tc_kernel`, 1 this one with two panels a tile (one block a
// multiprocessor: 129 KB of shared memory), 15 % slower at qwen2-7b's
// prefill shape on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6;
// scripts/torch_attention_routes.py --variants TC128_PIPELINED=0,1).
constexpr int TC128_PIPELINED = 0;
// Shared memory a block: Q's two warpgroup tiles, then the ring's stages
// (K then V, HDP / 64 panels each), + alignment.
constexpr int tcp_smem(int hdp) {
  return 2 * (hdp / 64) * PANEL + TCP_STAGES * 2 * (hdp / 64) * PANEL + 1024;
}

template <int HDP>
__global__ void __launch_bounds__(TC_THREADS, HDP == 64 ? 2 : 1)
flash_tcp_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 float* __restrict__ out, float* __restrict__ lse, int Hkv,
                 int S, int Sk, int G, int hd, Strides qs, Strides ks,
                 Strides vs, Strides os, int causal, float scale_log2) {
  constexpr int NP = HDP / 64, STAGE = 2 * NP * PANEL;  // K then V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sKV = base + 2 * NP * PANEL;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // longest first
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  const int qmax = min((r0 + TC_ROWS - 1) / G, S - 1);
  const int n_tiles =
      causal ? qmax / TC_KEYS + 1 : (Sk + TC_KEYS - 1) / TC_KEYS;

  stage_q<HDP>(sQ, qb, qs, r0, S, G, hd, tid);
  // Tile t goes to stage t % TCP_STAGES, one commit group a tile: group 0
  // holds Q and tile 0, tiles 1 .. TCP_STAGES - 3 follow, and iteration t
  // loads tile t + TCP_STAGES - 2 into the stage of tile t - 2.
  auto load = [&](int t) {
    const uint32_t st = sKV + (t % TCP_STAGES) * STAGE;
    const int k0 = t * TC_KEYS;
    load_tile<TC_THREADS, HDP>(st, kb + k0 * ks.s, ks.s, Sk - k0, hd, tid);
    load_tile<TC_THREADS, HDP>(st + NP * PANEL, vb + k0 * vs.s, vs.s,
                               Sk - k0, hd, tid);
  };
  load(0);
  cp_async_commit();
#pragma unroll
  for (int t = 1; t <= TCP_STAGES - 3; ++t) {
    if (t < n_tiles) load(t);
    cp_async_commit();
  }

  const int rowA = r0 + wg * 64 + warp * 16 + (lane >> 2);
  const int rowB = rowA + 8;
  const int qposA = rowA / G, qposB = rowB / G;
  const int qmin = (r0 + wg * 64) / G;  // this warpgroup's first position
  const int col0 = 2 * (lane & 3);
  const uint32_t sQw = sQ + wg * NP * PANEL;

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.0f;
  float mA = NEG, mB = NEG, lA = 0.0f, lB = 0.0f;  // l: this thread's part
  float corrA, corrB;

  // Tile t has landed once every thread's copies of it are visible; the
  // barrier also certifies that both warpgroups are done with tile t - 2
  // (its PV was waited for in iteration t - 1), whose stage then takes
  // tile t + TCP_STAGES - 2.
  auto arrive = [&](int t) {
    cp_async_wait<TCP_STAGES - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + TCP_STAGES - 2 < n_tiles) load(t + TCP_STAGES - 2);
    cp_async_commit();  // (possibly empty: keeps the group count in step)
  };
  // S = Q K_t^T, issued and committed (after a wgmma fence: o and the P
  // fragments were written since the last product).
  auto issue_s = [&](int t, float(&sc)[32]) {
    const uint32_t sK = sKV + (t % TCP_STAGES) * STAGE;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * PANEL + (kk & 3) * 32;
      wgmma_ss_64x64(sc, desc128(sQw + off, 16, 1024),
                     desc128(sK + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V_t, P the bf16 fragments `pv`, issued and committed.
  auto issue_pv = [&](int t, const uint32_t(&pv)[16]) {
    const uint32_t sV = sKV + (t % TCP_STAGES) * STAGE + NP * PANEL;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pv[4 * kk], pv[4 * kk + 1], pv[4 * kk + 2],
                             pv[4 * kk + 3]};
      const uint64_t dv = desc128(sV + kk * 16 * 128, PANEL, 1024);
      if constexpr (HDP == 64)
        wgmma_rs_64x64(o, a, dv);
      else
        wgmma_rs_64x128(o, a, dv);
    }
    wgmma_commit();
  };
  // The online softmax of tile t's scores, in place: masks (only where
  // the tile reaches past Sk, or past the diagonal of this warpgroup's
  // first row: elsewhere every key is in), the new maxima, corr, l, and p
  // (f32) over the scores.
  auto softmax = [&](int t, float(&sc)[32]) {
    const int k0 = t * TC_KEYS;
    if (k0 + TC_KEYS > Sk || (causal && k0 + TC_KEYS - 1 > qmin)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + 8 * j + col0 + c;
          if (key >= Sk || (causal && key > qposA)) sc[4 * j + c] = NEG;
          if (key >= Sk || (causal && key > qposB)) sc[4 * j + 2 + c] = NEG;
        }
      }
    }
    float mxA = NEG, mxB = NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mxA = fmaxf(mxA, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mxB = fmaxf(mxB, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, off));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, off));
    }
    const float mnA = fmaxf(mA, mxA * scale_log2);
    const float mnB = fmaxf(mB, mxB * scale_log2);
    corrA = fast_exp2(mA - mnA);
    corrB = fast_exp2(mB - mnB);
    mA = mnA;
    mB = mnB;
    float sumA = 0.0f, sumB = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = fast_exp2(fmaf(sc[4 * j], scale_log2, -mnA));
      sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -mnA));
      sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -mnB));
      sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -mnB));
      sumA += sc[4 * j] + sc[4 * j + 1];
      sumB += sc[4 * j + 2] + sc[4 * j + 3];
    }
    lA = lA * corrA + sumA;
    lB = lB * corrB + sumB;
  };
  // P as bf16 pairs, the A fragment of the next PV: row A, keys 8j + col0
  // + {0, 1}, then row B. Packed only once no product is in flight, and
  // pinned there (ptxas serialises every wgmma when a register one reads
  // is written while any is in flight).
  auto pack = [&](const float(&sc)[32], uint32_t(&pv)[16]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pv[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pv[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
    fence_regs(pv);
  };

  // Tile 0: no PV behind it yet (o is 0, so it needs no correction).
  uint32_t pv[16];  // P of the previous tile: the A fragment of its PV
  {
    arrive(0);
    float sc[32];
    issue_s(0, sc);
    wgmma_wait0();
    fence_regs(sc);
    softmax(0, sc);
    pack(sc, pv);
  }
  // Tile t: S_t issued, then PV of tile t - 1 behind it; the softmax of
  // tile t runs while the second product does (FlashAttention-3's
  // intra-warpgroup overlap). The loop body has no branch around a
  // product or a wait, so ptxas sees every accumulator read after its
  // wait.
  for (int t = 1; t < n_tiles; ++t) {
    arrive(t);
    float sc[32];
    issue_s(t, sc);
    issue_pv(t - 1, pv);
    wgmma_wait<1>();  // S is done; the PV product may still run
    fence_regs(sc);
    softmax(t, sc);
    wgmma_wait0();  // PV of tile t - 1 done: o and pv are free
    fence_regs(o);
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      o[4 * j] *= corrA;
      o[4 * j + 1] *= corrA;
      o[4 * j + 2] *= corrB;
      o[4 * j + 3] *= corrB;
    }
    pack(sc, pv);
  }
  // O += P V of the last tile.
  fence_regs(o);
  wgmma_fence();
  issue_pv(n_tiles - 1, pv);
  wgmma_wait0();
  fence_regs(o);
  cp_async_wait<0>();
  store_rows<HDP>(o, mA, mB, lA, lB, rowA, lane, bh, b, h, S, G, hd, out,
                  lse, os);
}

// ---------------------------------------------------------------------------
// float32: CUDA-core tiles.
// ---------------------------------------------------------------------------
constexpr int BR = 64;           // query rows (position, head) per block
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;
constexpr int NJ = HD_MAX / 16;  // output columns per thread

size_t f32_smem_bytes(int hd) {
  const int ld = hd + 1;
  return sizeof(float) *
         ((size_t)BR * ld + (size_t)BK * ld + (size_t)BR * (BK + 1) + 3 * BR);
}

__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Hkv, int S, int Sk, int G,
                 int hd, Strides qs,
                 Strides ks, Strides vs, Strides os, int causal,
                 float scale) {
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
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  for (int e = tid; e < BR * hd; e += THREADS) {
    const int r = e / hd, d = e % hd;
    const int row = r0 + r, s = row / G, g = row % G;
    Qs[r * ld + d] = s < S ? qb[s * qs.s + g * qs.g + d] : 0.0f;
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
  const int n_tiles = causal ? qmax / BK + 1 : (Sk + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's PV is done with KVs and Ps
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int c = e / hd, d = e % hd;
      KVs[c * ld + d] = k0 + c < Sk ? kb[(k0 + c) * ks.s + d] : 0.0f;
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
        const bool masked = kp >= Sk || (causal && kp > qpos[i]);
        Ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] =
            masked ? NEG : sc[i][j] * scale;
      }
    __syncthreads();  // scores complete; K no longer needed

    for (int e = tid; e < BK * hd; e += THREADS) {
      const int c = e / hd, d = e % hd;
      KVs[c * ld + d] = k0 + c < Sk ? vb[(k0 + c) * vs.s + d] : 0.0f;
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
        pr[c] = p;
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
    if (lse != nullptr && tx == 0)
      lse[(long long)bh * S * G + row] = row_m[ty * 4 + i] + logf(l);
    float* o = out + b * os.b + h * os.h + s * os.s + g * os.g;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) o[d] = acc[i][j] / l;
    }
  }
}

}  // namespace

// route: 0 = float32, 1 = bfloat16 at hd <= 128 (`flash_tc_kernel`), 2 =
// bfloat16 at hd <= 64 (`flash_tcp_kernel<64>`); q, k and v share the
// dtype.
// Strides are in
// elements: q and out (b, h, s, g), k and v (b, h, s). S query positions
// against Sk keys; causal needs Sk == S. `lse`, when not null, receives
// each row's log-sum-exp m + log l (f32, contiguous (B, Hkv, S, G)), which
// the backward (flash_attention_bwd.cu) recomputes P from. Requires
// hd <= 128 (64 on route 2); the bfloat16
// routes also need 16-byte-aligned q, k, v and strides that are multiples
// of 8 elements (the wrapper checks both).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int Hkv,
    int S, int Sk, int G, int hd, long long qsb, long long qsh, long long qss,
    long long qsg, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, long long osg, int causal, float scale,
    int route, void* stream) {
  if (hd < 1 || hd > (route == 2 ? 64 : HD_MAX) || route < 0 || route > 2)
    return (int)cudaErrorInvalidValue;
  if (causal && Sk != S) return (int)cudaErrorInvalidValue;
  if (B * Hkv * S * G == 0) return (int)cudaGetLastError();
  if (Sk < 1) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss, qsg}, ks{ksb, ksh, kss, 0},
      vs{vsb, vsh, vss, 0}, os{osb, osh, oss, osg};
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)S * G;
  if (route != 0) {
    auto* kernel = flash_tcp_kernel<64>;
    int smem = tcp_smem(64);
    if (route == 1) {
      if constexpr (TC128_PIPELINED) {
        kernel = flash_tcp_kernel<128>;
        smem = tcp_smem(128);
      } else {
        kernel = flash_tc_kernel;
        smem = TC_SMEM;
      }
    }
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(B * Hkv, (rows + TC_ROWS - 1) / TC_ROWS);
    kernel<<<grid, TC_THREADS, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (float*)out, (float*)lse, Hkv, S, Sk, G, hd,
        qs, ks, vs, os, causal, scale * 1.4426950408889634f);
    return (int)cudaGetLastError();
  }
  const size_t smem = f32_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((rows + BR - 1) / BR, B * Hkv);
  flash_f32_kernel<<<grid, THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, Hkv, S, Sk, G, hd, qs, ks, vs, os, causal, scale);
  return (int)cudaGetLastError();
}
