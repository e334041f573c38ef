#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's NeRF training, the HERO search, its
search -> compile -> serve pipeline, its two serving paths, the LM
quantization search, the LM stack's other block families and LM
training, unplaced and placed over a one-rank mesh, on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, and exits non-zero, printing no result, without
one (or without the rest of the repository beside it).

Phases, each of which raises on failure:

1. Build the ten CUDA sources from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together) and print the build time,
   every kernel's registers, the attention, quantized-matmul, encode,
   march and gather-composite kernels' spill bytes, and the tensor-core
   (HGMMA, HMMA, IMMA) and cp.async (LDGSTS) instructions in their SASS
   (``cuobjdump``); the bf16 flash kernels (hd 128 and hd 64) must hold
   HGMMA, and both quantized matmuls an s8 tensor-core instruction.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes its serve path gives it, and time kernel, plain version and,
   where one exists, the one PyTorch call that computes the same function
   (median of 20 CUDA-event-timed runs after warm-up). The timing floor,
   an empty launch timed the same ways, is printed first. The quantized
   matmuls are bit-equal also at N = 8 and 200, K = 257 and on x views
   off 16-byte boundaries, and their five serve linears are also timed
   back to back in one bracket (``seq_ms``), as a slot runs them. The
   fused hash encode from points is bit-equal on one slot's serve points
   and on the grid's edges, and the encode from baked corners at one
   hit-tier slot (16 levels x 16,384 points x 8 corners) and one
   evaluation chunk (50,560 points), 1 % of its indices outside the
   table, both to f32 encodings and to int8 codes; the points kernel is
   timed on the same rows' points beside it. The fused
   gather-composite is within 1e-5 of its plain version on a real march's
   ranks (R = 512, S = 32, B = 16,384; a warp tier's int32 take with the
   march mask; S = 64), early stop off and on, and bit-stable across
   calls. Decode attention is also timed cold, each call on one of 8
   caches (69 MB against the 50 MB L2), beside the library call on the
   same caches.
3. Training and the PSNR half of the reward at ``paper()`` width: the
   chair scene's dataset (64x64, 12 train and 3 test views) rendered on
   the card, ``train_ngp`` with ``TrainConfig()`` (400 steps of 512 rays;
   the median ms a step by CUDA events, the first and last loss),
   ``evaluate_psnr`` in reference mode, the episode's activation-range
   calibration and occupancy bake (32^3 at 1e-2; its occupied fraction),
   the 40-step QAT finetune under a mixed int policy (6-bit hash, 4-bit
   weights, 8-bit activations), then the finetuned field's PSNR in
   reference mode and in fused mode under the test set's cull plan and
   under an explicit budget (the march), each within 0.1 dB of reference
   mode, with wall and device ms, launches counted around each (the plan
   path must launch the packed matmul, the encode from baked corners once
   a chunk and the gather-composite; the march path the packed matmul,
   the fused encode, the gather-composite and the march; neither the bare
   gather). Before them the encode from baked corners is held to its
   plain version, and timed beside the points kernel, on the trained
   plan's first chunk. Then five train steps at a
   4-level config on the card and on the CPU: loss within 1e-5 relative,
   every leaf within 5e-5. The finetuned field, its ranges and its grid
   are packed into a ``QuantArtifact``, saved, loaded (``tile:128``) and
   served by ``RenderService`` with the pose cache on (8 requests of
   64x64 camera rays from 8 poses: all misses). Every kernel's launch
   count is zeroed just before the requests and read just after; each
   render kernel must have risen, the fused encode and the
   gather-composite once a slot render (as often as the march; a slot
   that outgrows its sample budget renders again), no plan may have been
   built or hit, and no kernel off the render path (the bare gather and
   the unfused composite among them) may have run. One request of a fresh
   pose is then profiled: wall and device time, and its launches; the
   per-slot sample budget is printed against its 16,384 cap.
4. The search (after phase 3's training, before its serving), on the
   trained field and its dataset at full width
   (``EnvConfig()``: 1,024 trace rays, the 40-step finetune, fused PSNR;
   ``HWConfig()``; ``DDPGConfig()``): ``NGPQuantEnv`` built (its
   seconds, the finetune's ms a step, ``psnr_org``, ``original_cost``),
   its trace equal to the CPU's, the card's cache statistics equal to the
   copied numpy oracle's on the 8-bit baseline, the 26 slope policies and
   64 random ones (cycle terms within 1e-3, ``model_bytes`` equal),
   ``simulate_batch`` at K = 64 cold and warm on the card and on the host
   (policies per second, the device cache walk's ms), ``hero_search`` for
   6 episodes (4 warm-up walks, 2 by the actor) with every count zeroed
   around them (the packed matmul, the encode from baked corners and the
   gather-composite must rise, the bare gather and the unfused composite
   must not; the finetune's ms a step, the PSNR's and the simulation's
   ms), the last episode's fused PSNR within 0.1 dB of reference mode
   (then its pack build timed and profiled apart from the evaluation),
   ``evaluate_population`` and 2 iterations of ``hero_population_search``
   at K = 16 (one proxy render profiled, one ``act()`` timed), and a
   4-level env's ``evaluate_bits`` on the card and on the CPU (misses
   equal, cycles within 1e-6, PSNR within 1e-3 dB).
5. The pipeline (after the search), through the public entry points on
   the same env and batched env wrapped in a ``WorkloadBundle``:
   ``HeroSearchRun`` over budgets 1.0 and 0.85, 2 iterations at K = 16 a
   cell, every count zeroed around it (policies/s, the frontier's size
   and hypervolume, ``seconds_to_fixed_bit``; ``bench_report``'s
   ``frontier_valid_vs_8bit`` must hold; the loop's time split into the
   population's proxy renders and simulator, the budget enforcement, the
   actor walks and the agent updates); the same run stopped after one
   cell and resumed (its one cell profiled) must equal it (frontiers,
   sizes, cells' bits); the
   best policy compiled by ``hero.compile`` with counts zeroed around it
   (the packed matmul, the encode from baked corners and the
   gather-composite must rise, the bare gather and the unfused composite
   must not; finetune, PSNR, pack build and simulation timed apart), its
   ``model_bytes`` equal to the simulator's, its PSNR within 0.1 dB of
   reference mode; saved, loaded and served by ``hero.serve`` (8 fresh
   poses: the fused encode, the march and the gather-composite once a
   slot render, nothing else but the packed matmul), one request matching
   the CPU's colours to 1e-5; and ``hero-search-torch --quick`` (one
   budget, one iteration of 8) returning 0 with a non-empty frontier.
6. The distributed search (after the pipeline), on the same bundle, each
   step held to phase 5's sequential closed loop: ``run_orchestrated``
   over two thread workers on the one card, every count zeroed around it
   (its frontier and cells' bits equal, its launches equal the loop's;
   its s and policies/s beside the loop's); one inline worker (equal, the
   cells done in canonical order); the chaos drill (``FaultPlan.seeded(3,
   ...)`` over two thread workers with a checkpoint: the injected fault,
   its retry and the pool's rescale printed, the result equal); the
   population split (``BatchedQuantEnv(sharded=True)``: one shard a
   card, ``evaluate_population`` of 16 policies equal to the plain env's
   exactly, ``simulate_batch`` through ``policy_latency`` equal to the
   memoized path); and one ``SubprocessWorker`` cell of a quick-scale
   config (one budget, one iteration of 8) pinned to card 0, its points
   compared with the same cell run here, no second kernel library built.
7. One request of phase 3's artifact served again on the CPU from the
   same directory (the plain versions) must match the card's colours to
   1e-5.
8. The revisit stream: two more poses, each visited three times (miss;
   miss and plan build; hit), then each jittered inside its pose cell
   (warp), counts zeroed around it: hits, warps and misses must each be
   > 0, each kernel must have launched as its tiers dictate (the encode
   from baked corners once a hit slot, the bare gather never), and every
   hit and warp request's colours must
   equal, bit for bit, the same rays served on the card without the pose
   cache. Plan bytes and ``resident_bytes`` are printed, and one hit and
   one warp request are profiled beside the march request. The misses'
   march slots must have captured a slot graph and replayed it, and
   ``resident_bytes`` must be the artifact's, the plans' and the graphs'
   pool's bytes.
9. The LM path: qwen2-7b at full width (28 layers, d 3584, bf16, random
   weights from a seed) served by ``repro_torch.launch.serve``: 8 requests
   of 1024 prompt tokens and 32 generated tokens, 4 at a time. Counts are
   zeroed just before and read just after: flash attention must launch
   once per layer per prefill, decode attention once per layer per step.
10. qwen2-7b's widths at 2 layers in float32 on the card and on the CPU:
   logits and caches within 1e-3.
11. The LM quantization search (``repro_torch.workloads.lm``): flash
   attention at the search's shapes first (the smoke configs' float32
   route, S 64, hd 16, within 1e-4 of its plain version and timed beside
   it and SDPA; qwen3-moe's bf16 geometry, hd 64, G 16); the
   ``LMWorkload`` bundle of qwen2-7b's smoke config built on the card
   (its seconds, ``psnr_org``, ``original_cost``) and with the same
   weights on the CPU; 16 policies from a fixed numpy seed (the 8-bit and
   b_min extremes among them) scored by both, the proxy and base losses
   within 1e-6 relative, quality and reward within the bounds that
   implies policy by policy (one float32 ulp of the loss moves quality by
   up to 0.01 dB near its floor), latency and ``model_bytes`` within 1e-6
   relative, flash attention once per layer per forward (the extremes'
   losses printed beside the quality cap at which the reference's
   bundle saturates); ``HeroSearchRun`` at
   ``examples/torch/lm_quant_search.py``'s defaults (budgets 1.0 and
   0.85, 2 iterations at K = 8), counts zeroed around it (flash attention
   once per layer per forward, nothing else; policies/s, frontier,
   hypervolume, ``frontier_valid_vs_8bit``, proxy forwards against cost),
   then ``hero-search-torch --workload lm --arch qwen2-7b --quick``
   returning 0; ``loss_fn`` at qwen2-7b's published width in bf16 over 4 x
   1024 tokens with no spec, the 8-bit spec and a mixed one (loss,
   quality, ms, peak memory; flash attention 28 times each); the
   ``roofline-lm`` preset's seconds/token at 8 and 4 bits beside the
   card's measured copy rate (4 GiB device to device); qwen3-moe and
   arctic smoke on the card against the CPU (``loss_fn``'s ce and aux
   within 1e-5 relative, prefill and 4 decode steps within 1e-3), and
   qwen3-moe-235b-a22b's published widths at 2 layers in bf16 under a
   mixed spec (ms, peak memory, the dropped share of (token, slot)
   pairs); then ``examples/torch/{quickstart,render_compare,
   lm_quant_search}.py`` at their own scale on the card.
12. The other block families (Mamba / jamba, mLSTM and sLSTM / xlstm,
   whisper's encoder-decoder, llava's patch prefix): flash attention at
   the shapes the serves below give it (B 4): whisper's encoder (Sq = Sk
   = 1,500, 20 heads, hd 64, as ``ops.full_attention`` runs it), its
   cross-attention (1,024 and 64 queries over 1,500 keys), both over
   1,001 keys (a partly filled last tile), whisper's causal decoder
   self-attention (S 1,024, G 1, hd 64) and llava's and jamba's causal
   layers (Hkv 8, G 4, hd 128, S 1,024), bf16 within ``BF16_ATTN_LIMIT``
   and f32 within 1e-4 of ``full_attention_plain`` or
   ``flash_attention_plain``, each printed with the route it took (bf16
   at hd <= 64: ``flash_tcp_kernel<64>``); decode attention at whisper's
   cross decode
   (all 1,500 rows of the cross cache) and at whisper's and llava's
   self-attention decode, held alike to ``decode_attention_plain``; each
   timed beside it and SDPA with its bound; each of whisper-large-v3,
   llava-next-mistral-7b, xlstm-350m (full width and depth) and
   jamba-v0.1-52b (full width, one period: 8 layers) served by
   ``repro_torch.launch.serve``, 4 requests of 1,024 prompt positions
   (llava: 576 zero patches and 448 tokens; whisper beside 1,500 zero
   frames) and 32 tokens, counts zeroed around each serve (flash once
   per attention layer per prefill, for whisper also once per encoder
   layer and once per decoder layer for cross-attention; decode
   attention once per attention layer per step, twice per decoder layer
   for whisper); the mLSTM, sLSTM and Mamba mixers (and the selective
   scan) timed at the served shapes; jamba's ``loss_fn`` under a mixed
   spec over 4 x 1,024 tokens (ms, peak memory); the four smoke configs
   in float32 on the card against the CPU (forward, prefill and a decode
   step with every cache leaf within 1e-3) and jamba's and xlstm's
   ``LMWorkload`` bundles (the base loss within 1e-6 relative, quantized
   losses as ``workloads.lm.losses_agree`` says); ``hero-search-torch
   --workload lm --arch xlstm-350m --quick`` returning 0.
13. LM training: kernel 6's backward (``csrc/flash_attention_bwd.cu``)
   against ``flash_attention_bwd_plain`` at every shape the training
   below gives it (whisper's encoder, causal decoder and cross-attention,
   qwen2-7b's layers in bf16 within 2e-2 of the largest gradient; the
   smoke configs' in f32 within 1e-5), with the forward's log-sum-exp
   within 1e-5 and a second call bit-equal, timed at the bf16 shapes
   beside its plain version, its bound, the forward and backward kernels
   back to back and SDPA's forward plus backward (``enable_gqa``);
   whisper-large-v3 at full width and depth trained by
   ``launch.train.main`` for 6 steps of 8 x 128 tokens (2 microbatches,
   1,500 zero frames, f32 moments, one checkpoint at step 4), counts
   zeroed around it (kernel 6 and its backward once per attention call
   per microbatch, nothing else), then resumed from its step-4
   checkpoint: steps 5-6 within 1e-5 relative of the first run's, their
   bit-equality printed; qwen2-7b at published width cut to 2 layers,
   ``make_train_step`` with int8 moments for 4 steps of 2 x 4 x 1,024
   tokens (ms a step, the clip's and the update's share, peak memory,
   finite losses and grad norms, the entries whose second moment the
   codec dropped, launches counted, one more step profiled), then the
   same steps with f32 moments as a witness; one train step of each of
   the ten smoke configs in float32 on the card against the CPU (losses
   and grad norm within 1e-5 relative, first moments within 1e-5 of
   their largest entry, parameters within 1e-5 where the gradient
   exceeds 100 eps; MoE archs and xlstm as ``losses_agree`` says, xlstm's
   moments leaf by leaf within twice what one ulp of weight noise moves
   them on the CPU); two steps of qwen2-7b's smoke config with int8
   moments on the card against the CPU (losses and grad norms within
   1e-5, the moments' scales within 1e-5 and their values within one
   code step).
14. Placement: a one-rank NCCL process group (a ``FileStore`` in a
   temporary directory) and the mesh (1, 1) over it, which takes the
   placed path (DTensor parameters and moments, the gather, the
   reduce-scatter onto the accumulator's blocks, the norm and the int8
   row scales reduced over the mesh): qwen2-7b at published width cut to
   2 layers, f32 moments, PLACED_STEPS (3) steps of (b)'s batches placed
   and unplaced
   from the same weights, the first step's parameters and moments and
   every step's loss and grad norm bit-equal, kernel 6 and its backward
   launched by the placed steps (counts zeroed around them), the ms a
   step each way (the median after the first) and peak memory, one more
   step each way profiled (device time; the placed one's NCCL ranges and
   device-to-device copies: at one rank DTensor's gather and
   reduce-scatter move nothing, the loss's and norm's all-reduces reach
   NCCL); then qwen2-7b's smoke config
   with int8 moments placed and unplaced, bit-equal, and its placed
   checkpoint (rank 0 writes) restored unplaced, bit-equal; then the
   Mamba and xLSTM mixers on the placed path (split over `model` by
   their channels and heads, the identity at one rank): xlstm-350m at
   full width and depth (f32 moments) and jamba-v0.1-52b at published
   widths cut to its two first layers, both Mamba (int8 moments),
   MIXER_STEPS (2) steps each placed and unplaced from the same weights,
   bit-equal as above, ms a step, peak memory, the model-side calls
   (`sum_over_model` among them), and one more placed step profiled:
   the device time of the Mamba conv and scan, the mLSTM mixer and the
   sLSTM time loop (``record_function`` ranges).
15. The dry-run (``repro_torch.launch.dryrun``, ROADMAP item 10a): phase
   14's one-rank qwen2-7b step (2 layers, f32 moments, 2 x 4 x 1,024
   tokens) traced as a cell at mesh (1, 1) in a child process on the CPU
   (tensors without data, a fake process group), then that step run on
   the card over a one-rank NCCL mesh, counts zeroed around one step:
   kernel 6's and its backward's launches predicted, counted and
   profiled, equal; the predicted peak within 10 % of
   ``max_memory_allocated``; the step's device time at or above the
   roofline's ``step_time_s`` (the H100 datasheet rates), and their
   ratio; and the full cell qwen2-7b x train_4k x 16x16 (rank 0 of 256)
   traced in a second child meanwhile: its roofline line and
   ``trace_s``.
16. Placed prefill and decode (ROADMAP item 10b): (a) kernel 7's
   partial form (``lse=True``: the f32 output and the log-sum-exp)
   against its plain version in bf16 and f32 at phase 10's shape and
   lengths, on either side of the one-pass route's threshold, and at
   length 0 (zero and -inf), each length's route printed; its time at a
   sixteenth of the cache (the one-pass route, required) and at a rank's
   block of the dry-run's decode_32k cell (B 8, 2,048 positions, the
   split route), each beside memory-efficient attention asked for its
   log-sum-exp and the bound; (b) that cache cut into 2, 4 and 16 blocks of positions,
   some empty, kernel 7's partial form on each merged by
   ``distributed.sharding.combine_partials`` against kernel 7 over the
   whole cache; (c) over a one-rank NCCL mesh, qwen2-7b at its published
   width and depth (28 layers, bf16) served unplaced and then placed
   (``make_prefill_step`` / ``make_decode_step`` with the mesh): a
   prefill of 4 x 1,024 tokens and 32 greedy decode steps, the logits of
   every call, the tokens and the cache bit-equal, prefill ms, decode ms
   a step, peak, the placed run's launches (counts zeroed just before
   it), one placed prefill and decode step profiled; (d) the dry-run's
   one-rank prefill and decode cells of that serve traced on the CPU in
   child processes: kernel 6's launches a prefill and kernel 7's a
   decode step predicted, counted and profiled, equal; the decode cell
   run on the card, its peak within 10 % of the prediction and its
   device time at or above the roofline's.

The last lines are the kernels JSON line (``launches`` from the all-miss
stream and the LM serve, and for the backward phase 13's whisper run, ``launches_revisit`` from the revisit stream,
``launches_psnr_plan`` and ``launches_psnr_march`` from the two fused
PSNR evaluations, ``launches_search`` from the search's episodes,
``launches_closed_loop``, ``launches_compile`` and
``launches_pipeline_serve`` from the pipeline's three stages,
``launches_distributed`` from the thread-pool sweep,
``launches_lm_search`` from the LM closed loop,
``launches_serve_{whisper,llava,xlstm,jamba}`` from phase 12's serves,
``launches_train_{whisper,qwen2}`` from phase 13's runs,
``launches_placed`` from phase 14's placed steps, ``launches_placed_mixers``
from its placed mixers' steps (0: no kernel lies on them), ``launches_dryrun``
from phase 15's step, ``launches_placed_serve`` from phase 16's placed
serve;
the flash entry also carries the phase 12 shapes' numbers under
``*_{whisper_enc,cross_served,cross,ragged,cross_ragged,whisper_dec,
llava_jamba}`` and the decode entry under
``*_{whisper_cross,whisper_self,llava_jamba}`` and phase 16's partial
form under ``max_abs_err_lse``, ``lse_err``, ``ms_lse_block16``,
``plain_ms_lse_block16``, ``library_ms_lse_block16``,
``bound_ms_lse_block16`` (a sixteenth of the cache, the one-pass route),
``ms_lse_block2048``, ``library_ms_lse_block2048``,
``bound_ms_lse_block2048`` (a rank's block of the decode_32k cell, B 8,
2,048 positions, the split route) and ``combine_err``, and the backward's
entry, ``flash_attention_bwd``, qwen2-7b's shape with whisper's under
``*_{whisper_enc,whisper_dec,whisper_cross}``),
the card's name and power limit (``nvidia-smi``), and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

QMM_SHAPES = ((32, 64), (64, 16), (40, 64), (64, 64), (64, 3))  # paper (K, N)
SERVE_ROWS = 512 * 32  # slot_rays * n_samples: the M of one slot's linears
# The test set's cull-plan budget a 4,096-ray chunk on the trained chair
# (PERF.md section 4): the B of one plan-path evaluation chunk.
EVAL_CHUNK_POINTS = 50_560
# The LM serve path: qwen2-7b, 4 requests a batch, 1024 prompt tokens, 32
# generated; attention shapes (B, Hkv, G, hd) and the cache length.
LM_BATCH, LM_PROMPT, LM_GEN, LM_REQUESTS = 4, 1024, 32, 8
LM_B, LM_HKV, LM_G, LM_HD = 4, 4, 7, 128
LM_SMAX = LM_PROMPT + LM_GEN
# The attention kernels in bf16 are held to the reference's test bands
# (3e-2 flash, 2e-2 decode) and to this tighter limit, about three times
# the worst readings on the H100 (flash 1.64e-3, decode 9.77e-4): a
# bf16-only fault of a few percent of the output passes the former only.
BF16_ATTN_LIMIT = 5e-3


SPIN_CYCLES = 5_000_000  # ~2.5 ms of device spin: longer than any enqueue


def median_ms(fn, iters: int = 20, warmup: int = 3, hide_host: bool = True
              ) -> float:
    """Median of `iters` CUDA-event-timed calls of `fn`, after warm-up.

    With `hide_host`, each timed call is queued behind a spin kernel, so
    the events bracket only the device's work for `fn` (the host enqueues
    it while the device spins). Without, the device is idle when the
    first event is recorded, and the time includes the host's launch
    overhead: what one call costs a caller."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(*costs):
    """(bound_ms, bound_by) of the summed `kernels.cost` counts (one unit):
    the larger of bytes over the memory rate and operations over the peak
    rate of their type. The package's count, so the dry-run reads the
    same one."""
    from repro_torch.kernels.cost import Cost

    return Cost(sum(c.ops for c in costs), sum(c.bytes for c in costs),
                costs[0].unit).bound_ms()


def entry(name, source, replaces, err, ms, plain_ms, bnd, library_ms,
          call_ms, **more):
    """One kernel's record. `ms`, `plain_ms` and `library_ms` are device
    times; `call_ms` is one kernel call with the host's launch overhead;
    `more` adds measured times under their own names."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": float(err), "ms": float(ms),
            "plain_ms": float(plain_ms), "bound_ms": float(bnd[0]),
            "bound_by": bnd[1],
            "library_ms": None if library_ms is None else float(library_ms),
            "call_ms": float(call_ms),
            **{k: float(v) for k, v in more.items()}}


# ---------------------------------------------------------------------------
# Kernel phases: kernel == plain version on the card, then timed.
# ---------------------------------------------------------------------------
def unaligned_views(rng, M, K, dev):
    """x operands that start off a 16-byte boundary: one byte into a
    buffer, and row 1 of an (M + 1, K) matrix (K bytes in)."""
    buf = torch.from_numpy(rng.integers(-128, 128, M * K + 1, dtype=np.int8))
    big = torch.from_numpy(rng.integers(-128, 128, (M + 1, K), dtype=np.int8))
    return {"byte 1": buf.to(dev)[1:].view(M, K), "row 1": big.to(dev)[1:]}


def qmm_inputs(rng, dev, packed: bool):
    """The five paper linears of one slot at M = 16,384: x, the weight
    (4-bit tile:128 words, or int8 codes), sx, sw, zx, and the f32 operands
    of the `torch.matmul` yardstick."""
    from repro_torch.kernels.repack import repack_tile_native
    from repro_torch.quant.packing import pack_codes

    out = []
    for K, N in QMM_SHAPES:
        x = torch.from_numpy(rng.integers(-128, 128, (SERVE_ROWS, K),
                                          dtype=np.int8)).to(dev)
        sx = torch.tensor(0.02, device=dev)
        zx = torch.tensor(-3, dtype=torch.int32, device=dev)
        if packed:
            w = repack_tile_native(pack_codes(rng.integers(-9, 8, (K, N)), 4,
                                              scale=0.01, device=dev))
            sw, wf = w.scale, w.dequantize()
        else:
            w = torch.from_numpy(rng.integers(-8, 8, (K, N),
                                              dtype=np.int8)).to(dev)
            sw, wf = torch.tensor(0.01, device=dev), w.to(torch.float32)
        out.append((x, w, sx, sw, zx, x.to(torch.float32), wf))
    return out


def time_linears(name, kernel, plain, cases, floor):
    """Time kernel, plain version and `torch.matmul` (f32) on each linear
    alone (device time, and one kernel call from an idle device) and on
    all five back to back inside one bracket, as a slot runs them."""
    tot = dict(ms=0.0, plain_ms=0.0, lib_ms=0.0, call_ms=0.0)
    for x, w, sx, sw, zx, xf, wf in cases:
        t_k = median_ms(lambda: kernel(x, w, sx, sw, zx))
        t_p = median_ms(lambda: plain(x, w, sx, sw, zx))
        t_l = median_ms(lambda: torch.matmul(xf, wf))
        t_c = median_ms(lambda: kernel(x, w, sx, sw, zx), hide_host=False)
        K, N = x.shape[1], wf.shape[1]
        print(f"  K={K:3d} N={N:3d}: kernel {t_k:.4f} ms (one call {t_c:.4f} "
              f"ms), plain {t_p:.4f} ms, torch.matmul(f32) {t_l:.4f} ms")
        for key, t in zip(tot, (t_k, t_p, t_l, t_c)):
            tot[key] += t
    seq = {"seq_ms": lambda: [kernel(*c[:5]) for c in cases],
           "plain_seq_ms": lambda: [plain(*c[:5]) for c in cases],
           "library_seq_ms": lambda: [torch.matmul(*c[5:]) for c in cases]}
    seq = {k: median_ms(f) for k, f in seq.items()}
    print(f"  {name}, the five linears back to back in one bracket: kernel "
          f"{seq['seq_ms']:.4f} ms, plain {seq['plain_seq_ms']:.4f} ms, "
          f"torch.matmul(f32) {seq['library_seq_ms']:.4f} ms; summed alone: "
          f"kernel {tot['ms']:.4f} ms, five empty launches "
          f"{5 * floor['floor_ms']:.4f} ms")
    return tot, seq


def phase_quant_matmul(rng, dev, floor):
    from repro_torch.kernels import cost
    from repro_torch.kernels.quant_matmul import (
        quant_matmul_packed_cuda as kernel,
        quant_matmul_packed_plain as plain,
    )
    from repro_torch.kernels.repack import repack_tile_native
    from repro_torch.quant.packing import pack_codes

    M = SERVE_ROWS
    worst = 0.0
    # The paper linears, then N = 8 and 200 (N = 3 is the last paper one)
    # and a K past one staged chunk.
    shapes = [(M, K, N) for K, N in QMM_SHAPES] + [
        (M, 64, 8), (M, 40, 200), (M + 13, 257, 3)]
    for m, K, N in shapes:
        x = torch.from_numpy(rng.integers(-128, 128, (m, K), dtype=np.int8)).to(dev)
        for bits in (2, 4, 6, 8):
            # The paper-exact grid [-2^(b-1) - 1, 2^(b-1) - 1], full span.
            q = rng.integers(-(2 ** (bits - 1)) - 1, 2 ** (bits - 1), (K, N))
            pt = pack_codes(q, bits, scale=float(rng.uniform(1e-3, 1e-1)),
                            device=dev)
            for wq in (pt, repack_tile_native(pt)):
                sx = torch.tensor(float(rng.uniform(1e-3, 1e-1)), device=dev)
                for zx_v in (17, -128, int(rng.integers(-128, 128))):
                    zx = torch.tensor(zx_v, dtype=torch.int32, device=dev)
                    a = kernel(x, wq, sx, wq.scale, zx)
                    b = plain(x, wq, sx, wq.scale, zx)
                    torch.cuda.synchronize()
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"quant_matmul_packed M={m} K={K} N={N} "
                            f"bits={bits} {wq.layout} zx={zx_v}: max |diff| "
                            f"{(a - b).abs().max().item()}")
                    worst = max(worst, (a - b).abs().max().item())
    for K, N in ((40, 64), (64, 3)):
        wq = repack_tile_native(pack_codes(rng.integers(-9, 8, (K, N)), 4,
                                           scale=0.01, device=dev))
        for what, x in unaligned_views(rng, M, K, dev).items():
            a = kernel(x, wq, 0.02, wq.scale, 17)
            b = plain(x, wq, 0.02, wq.scale, 17)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"quant_matmul_packed x view {what} K={K}"
                                     f" N={N}: max |diff| "
                                     f"{(a - b).abs().max().item()}")
    print(f"quant_matmul_packed: exact on {len(shapes)} shapes (the paper "
          "linears at M=16384, N=8, N=200, K=257) x bits {2,4,6,8} x "
          "{planar, tile:128} x 3 zero points, and on x views off 16-byte "
          "boundaries")

    # Time the five linears of one slot (4-bit weights, tile:128, as served).
    cases = qmm_inputs(rng, dev, packed=True)
    tot, seq = time_linears("quant_matmul_packed", kernel, plain, cases, floor)
    bnd = bound(*(cost.quant_matmul_packed(*x.shape, w.cols, w.words.numel())
                  for x, w, *_ in cases))
    e = entry("quant_matmul_packed", "src/repro_torch/csrc/quant_matmul_packed.cu",
              "src/repro/kernels/quant_matmul.py:199", worst, tot["ms"],
              tot["plain_ms"], bnd, tot["lib_ms"],
              tot["call_ms"], **seq, launch_floor_ms=floor["floor_ms"])
    e["timed_as"] = "sum of the five paper linears, M=16384, 4-bit tile:128"
    return e


def serve_points(n_rays: int, dev):
    """Sample points (unit cube) and directions of `n_rays` camera rays of
    the first scene pose, at the render config's deterministic depths."""
    from repro_torch.nerf.occupancy import ray_t_samples
    from repro_torch.nerf.render import RenderConfig
    from repro_torch.nerf.scenes import SceneConfig, camera_poses, camera_rays

    sc = SceneConfig()
    train, _ = camera_poses(sc)
    ro, rd = camera_rays(train[0], sc.image_hw, sc.focal_mult * sc.image_hw)
    step = max(1, ro.shape[0] // n_rays)
    ro, rd = ro[::step][:n_rays], rd[::step][:n_rays]
    t = torch.from_numpy(ray_t_samples(RenderConfig()))
    pts = ro[:, None, :] + rd[:, None, :] * t[None, :, None]
    dirs = rd[:, None, :].expand(pts.shape)
    return (torch.clamp(pts + 0.5, 0.0, 1.0).reshape(-1, 3).to(dev),
            dirs.reshape(-1, 3).to(dev), ro, rd)


def encode_edge_points(hc, n_per_level: int, seed: int = 0) -> np.ndarray:
    """(L * n_per_level, 3) f32 points on the hash grid's edges: for each
    level, coordinates on its exact cell faces k / res (rounded to f32 from
    the double and divided in f32), mixed per axis with 0, 1, the float
    just below 1 and uniform coordinates."""
    rng = np.random.default_rng(seed)
    below1 = np.nextafter(np.float32(1), np.float32(0))
    out = []
    for res in hc.resolutions():
        k = rng.integers(0, res + 1, (n_per_level, 3))
        face = np.where(rng.integers(0, 2, k.shape) == 1,
                        (k / res).astype(np.float32),
                        k.astype(np.float32) / np.float32(res))
        ends = rng.choice(np.array([0.0, 1.0, below1], np.float32), k.shape)
        pick = rng.integers(0, 4, k.shape)
        p = np.where(pick == 1, ends, face)
        p = np.where(pick == 2, rng.uniform(size=k.shape), p)
        out.append(p.astype(np.float32))
    return np.concatenate(out)


def encode_inputs(rng, hc, dev, subnormal: bool = True):
    """A concatenated table at `hc`'s widths (trained-like magnitudes;
    with `subnormal`, every 97th row scaled to 1e-37 so that corner
    products and partial sums go subnormal), its level description, and
    an 8-bit activation grid fitted to the encodings' range."""
    from repro_torch.nerf.hash_encoding import level_meta
    from repro_torch.quant.linear_quant import activation_qparams

    T = sum(hc.level_entries(l) for l in range(hc.n_levels))
    table = (rng.normal(size=(T, hc.n_features)) * 0.3).astype(np.float32)
    if subnormal:
        table[::97] *= np.float32(1e-37)
    qp = activation_qparams(-0.8, 0.9, 8)
    act = dict(sx=qp.scale, zx_f=qp.zero_point, qmax=qp.q_max,
               off=torch.tensor(128.0))
    return (torch.from_numpy(table).to(dev), level_meta(hc, dev),
            {k: v.to(dev) for k, v in act.items()})


def phase_hash_encode(rng, dev, cfg):
    from repro_torch.kernels import cost
    from repro_torch.kernels.hash_encode import (
        corner_data,
        hash_encode_points_cuda as kernel,
        hash_encode_points_plain as plain,
    )

    hc = cfg.hash
    table, meta, act = encode_inputs(rng, hc, dev)
    pts, _, _, _ = serve_points(512, dev)  # one slot's 16,384 samples
    edges = torch.from_numpy(encode_edge_points(hc, 1024)).to(dev)
    worst = 0.0
    for what, p in (("serve points", pts), ("edge points", edges)):
        for a in (None, act):
            got, want = kernel(p, table, meta, a), plain(p, table, meta, a)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"hash_encode ({what}, {'codes' if a else 'f32'}): "
                    f"kernel != plain version, max |diff| {err}")
            worst = max(worst, err)
    print(f"hash_encode: exact, f32 encodings and int8 codes, on "
          f"{pts.shape[0]} serve points and {edges.shape[0]} edge points "
          f"over a ({table.shape[0]}, {table.shape[1]}) f32 table, "
          f"{hc.n_levels} levels")
    t_k = median_ms(lambda: kernel(pts, table, meta, act))
    t_kf = median_ms(lambda: kernel(pts, table, meta))
    t_p = median_ms(lambda: plain(pts, table, meta, act))
    t_c = median_ms(lambda: kernel(pts, table, meta, act), hide_host=False)
    # Bytes: the points, each table row the corners touch once, the codes.
    rows = torch.cat([corner_data(pts, r, bool(d), n)[0].reshape(-1) + o
                      for r, d, n, o in meta.tolist()])
    uniq = int(torch.unique(rows).numel())
    B, F, L = pts.shape[0], hc.n_features, hc.n_levels
    print(f"  hash_encode: {uniq} distinct table rows of {B * L * 8} corner "
          f"reads; codes {t_k:.4f} ms, f32 encodings {t_kf:.4f} ms")
    return entry("hash_encode", "src/repro_torch/csrc/hash_encode.cu",
                 "src/repro/kernels/hash_encoding_kernel.py:50", worst, t_k,
                 t_p, bound(cost.hash_encode_points(B, L, F, uniq)), None,
                 t_c, ms_f32_out=t_kf)


def corner_case(rng, pts, hc, table, meta, bad_share: float = 0.01):
    """The corner data a plan bakes for `pts`: (L, B, 8) indices within
    each level's table and weights, and the (L,) level offsets, with
    `bad_share` of the indices moved outside the table once their level's
    offset is added (below 0, at T and past it, at 2^31 - 1)."""
    from repro_torch.nerf.fast_render import corner_data_of

    idx, w = corner_data_of(pts, hc)
    off = meta[:, 3].contiguous()
    T, n = table.shape[0], int(idx.numel() * bad_share)
    pos = torch.from_numpy(rng.choice(idx.numel(), n, replace=False))
    rows = torch.from_numpy(rng.choice([-1, -7, T, T + 5, 2 ** 31 - 1], n))
    level = pos // (idx.shape[1] * idx.shape[2])
    idx.view(-1)[pos.to(idx.device)] = (
        rows - off.cpu().long()[level]).to(torch.int32).to(idx.device)
    return idx, w, off


def time_corners(what, idx, w, table, off, act, pts, meta):
    """The corners kernel against its plain version on one set of baked
    corners, f32 encodings and int8 codes bit for bit, then timed (codes,
    as the path asks for them) beside the points kernel on the same rows'
    points. Returns the numbers of one kernels-line entry."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.hash_encode import (
        hash_encode_corners_cuda as kernel,
        hash_encode_corners_plain as plain,
        hash_encode_points_cuda as points_kernel,
    )

    worst = 0.0
    for a in (None, act):
        got, want = kernel(idx, w, table, off, a), plain(idx, w, table, off, a)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(
                f"hash_encode_corners ({what}, {'codes' if a else 'f32'}): "
                f"kernel != plain version, max |diff| {err}")
        worst = max(worst, err)
    t = dict(err=worst, ms=median_ms(lambda: kernel(idx, w, table, off, act)),
             ms_f32_out=median_ms(lambda: kernel(idx, w, table, off)),
             plain_ms=median_ms(lambda: plain(idx, w, table, off, act)),
             call_ms=median_ms(lambda: kernel(idx, w, table, off, act),
                               hide_host=False),
             points_kernel_ms=median_ms(
                 lambda: points_kernel(pts, table, meta, act)))
    # Bytes: the corners (64 B a point and level), each table row they
    # touch once, the codes; operations: 8 fused multiply-adds a feature.
    L, B, _ = idx.shape
    F = table.shape[1]
    rows = idx.long() + off.long()[:, None, None]
    uniq = int(torch.unique(rows[(rows >= 0) & (rows < table.shape[0])])
               .numel())
    t["bound"] = bound(cost.hash_encode_corners(L, B, F, uniq))
    n_bad = int(((rows < 0) | (rows >= table.shape[0])).sum())
    print(f"hash_encode_corners ({what}): exact, f32 encodings and int8 codes,"
          f" L={L} B={B} ({n_bad} of {rows.numel()} corner rows outside the "
          f"({table.shape[0]}, {F}) table, {uniq} distinct rows inside); "
          f"codes {t['ms']:.4f} ms (one call {t['call_ms']:.4f} ms), f32 "
          f"{t['ms_f32_out']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
          f"{t['bound'][0]:.4f} ms ({t['bound'][1]}); library: none (no single"
          f" PyTorch call computes it); the points kernel on the same rows' "
          f"points {t['points_kernel_ms']:.4f} ms (recorded, not routed)")
    return t


def phase_hash_encode_corners(rng, dev, cfg):
    """The corners kernel at one hit-tier slot (16 levels x 16,384 points x
    8 corners) and at one PSNR evaluation chunk (50,560 points: the test
    set's plan budget a 4,096-ray chunk, PERF.md section 4), 1 % of the
    indices out of the table."""
    hc = cfg.hash
    table, meta, act = encode_inputs(rng, hc, dev)
    got = {}
    for what, n_rays in (("slot", 512), ("chunk", EVAL_CHUNK_POINTS // 32)):
        pts = serve_points(n_rays, dev)[0]
        idx, w, off = corner_case(rng, pts, hc, table, meta)
        got[what] = time_corners(f"{what}, {pts.shape[0]} serve points", idx,
                                 w, table, off, act, pts, meta)
    slot, chunk = got["slot"], got["chunk"]
    return entry("hash_encode_corners", "src/repro_torch/csrc/hash_encode.cu",
                 "src/repro/kernels/hash_encoding_kernel.py:50",
                 max(slot["err"], chunk["err"]), slot["ms"], slot["plain_ms"],
                 slot["bound"], None, slot["call_ms"],
                 ms_f32_out=slot["ms_f32_out"],
                 points_kernel_ms=slot["points_kernel_ms"],
                 ms_chunk=chunk["ms"], plain_ms_chunk=chunk["plain_ms"],
                 bound_ms_chunk=chunk["bound"][0],
                 call_ms_chunk=chunk["call_ms"],
                 points_kernel_ms_chunk=chunk["points_kernel_ms"])


def phase_hash_gather(rng, dev, cfg):
    from repro_torch.kernels import cost
    from repro_torch.kernels.hash_encoding_kernel import (
        hash_gather_cuda as kernel,
        hash_gather_plain as plain,
    )
    from repro_torch.nerf.hash_encoding import level_corner_data

    hc = cfg.hash
    rows = [hc.level_entries(l) for l in range(hc.n_levels)]
    T, F = sum(rows), hc.n_features
    table = torch.from_numpy(
        rng.uniform(-1e-4, 1e-4, (T, F)).astype(np.float32)).to(dev)
    # The corner rows one slot's samples gather (16 levels x 16384 x 8).
    pts, _, _, _ = serve_points(512, dev)
    offs = np.cumsum([0] + rows[:-1])
    idx = torch.cat([level_corner_data(pts, l, hc)[0].reshape(-1) + int(offs[l])
                     for l in range(hc.n_levels)]).to(torch.int32)
    P = idx.numel()
    bad = torch.from_numpy(rng.choice(P, P // 100, replace=False)).to(dev)
    junk = rng.choice([-1, -7, T, T + 5, 2 ** 31 - 1], bad.numel())
    idx[bad] = torch.from_numpy(junk.astype(np.int32)).to(dev)
    a = kernel(idx, table)
    b = plain(idx, table)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("hash_gather: kernel != plain version")
    print(f"hash_gather: exact, P={P} indices ({bad.numel()} out of range) "
          f"over a ({T}, {F}) f32 table")
    ok = (idx >= 0) & (idx < T)
    idx_lib = torch.where(ok, idx, 0).to(torch.int64)
    t_k = median_ms(lambda: kernel(idx, table))
    t_p = median_ms(lambda: plain(idx, table))
    t_l = median_ms(lambda: table[idx_lib])
    t_c = median_ms(lambda: kernel(idx, table), hide_host=False)
    uniq = int(torch.unique(idx[ok]).numel())
    return entry("hash_gather", "src/repro_torch/csrc/hash_gather.cu",
                 "src/repro/kernels/hash_encoding_kernel.py:50",
                 (a - b).abs().max().item(), t_k, t_p,
                 bound(cost.hash_gather(P, F, uniq)), t_l, t_c)


def march_rays(rng, R: int = 512):
    """Camera-like rays plus the edge cases: coordinates held exactly on
    cell faces and on box faces (zero direction on that axis), axis-aligned
    rays, rays starting inside the box, and zero-direction rays."""
    o = np.empty((R, 3), np.float32)
    d = np.empty((R, 3), np.float32)
    n_cam = R // 2
    theta = rng.uniform(0, 2 * np.pi, n_cam)
    phi = rng.uniform(-0.6, 0.6, n_cam)
    o[:n_cam] = 1.3 * np.stack([np.cos(theta) * np.cos(phi), np.sin(phi),
                                np.sin(theta) * np.cos(phi)], -1)
    aim = rng.uniform(-0.4, 0.4, (n_cam, 3))
    d[:n_cam] = aim - o[:n_cam]
    i = n_cam
    faces = (np.arange(33) / 32.0 - 0.5).astype(np.float32)  # cell + box faces
    while i < R - 64:
        ax = rng.integers(0, 3)
        sign = rng.choice([-1.0, 1.0])
        o[i] = rng.choice(faces, 3)
        o[i, ax] = -1.5 * sign
        d[i] = 0.0
        d[i, ax] = sign
        i += 1
    for j in range(i, R):  # inside the box; half with zero direction
        o[j] = rng.uniform(-0.45, 0.45, 3)
        d[j] = 0.0 if j % 2 else rng.normal(size=3)
    n = np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.where(n > 0, d / np.where(n > 0, n, 1.0), 0.0).astype(np.float32)
    return o, d


def phase_ray_march(rng, dev):
    from repro_torch.kernels import cost
    from repro_torch.kernels.ray_march import (
        ray_march_cuda as kernel,
        ray_march_plain as plain,
    )
    from repro_torch.nerf.occupancy import (
        OccupancyGrid,
        ray_t_samples,
        sample_active_mask,
    )
    from repro_torch.nerf.render import RenderConfig

    G = 32
    occ_np = (rng.uniform(size=(G, G, G)) < 0.5).astype(np.float32)
    occ = torch.from_numpy(occ_np).to(dev)
    o_np, d_np = march_rays(rng)
    ro, rd = torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev)
    rcfg = RenderConfig()
    t = torch.from_numpy(ray_t_samples(rcfg)).to(dev)
    a = kernel(occ, ro, rd, t, True)
    b = plain(occ, ro, rd, t)
    grid = OccupancyGrid(occ=occ, resolution=G, threshold=0.5,
                         occupied_fraction=float(occ_np.mean()))
    host, pts = sample_active_mask(grid, o_np, d_np, rcfg)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("ray_march: kernel != plain version")
    if not np.array_equal(a.cpu().numpy() > 0.5, host):
        raise AssertionError("ray_march: kernel != host sample_active_mask")
    print(f"ray_march: exact against the plain version and the host oracle "
          f"on {o_np.shape[0]} rays ({int(host.sum())} active samples)")
    t_k = median_ms(lambda: kernel(occ, ro, rd, t, True))
    t_p = median_ms(lambda: plain(occ, ro, rd, t))
    t_c = median_ms(lambda: kernel(occ, ro, rd, t, True), hide_host=False)
    inside = np.all((pts > -0.5) & (pts < 0.5), axis=-1)
    cells = np.clip(((pts[inside] + 0.5) * G).astype(np.int64), 0, G - 1)
    uniq = np.unique(cells[:, 0] * G * G + cells[:, 1] * G + cells[:, 2]).size
    R, S = o_np.shape[0], t.numel()
    return entry("ray_march", "src/repro_torch/csrc/ray_march.cu",
                 "src/repro/kernels/ray_march.py:134",
                 (a - b).abs().max().item(), t_k, t_p,
                 bound(cost.ray_march(R, S, int(uniq))), None, t_c)


def phase_alpha_composite(rng, dev):
    from repro_torch.kernels import cost
    from repro_torch.kernels.alpha_composite import (
        alpha_composite_cuda as kernel,
        alpha_composite_plain as plain,
    )
    from repro_torch.nerf.occupancy import ray_t_samples
    from repro_torch.nerf.render import RenderConfig

    R, S, t_eps = 512, 32, 1e-6
    t = ray_t_samples(RenderConfig())
    delta_np = np.tile(np.append(np.diff(t), np.float32(1e10)),
                       (R, 1)).astype(np.float32)
    scale = rng.choice([0.0, 0.5, 5.0, 200.0], (R, 1))  # empty ... opaque
    sigma_np = (rng.exponential(1.0, (R, S)) * scale).astype(np.float32)
    sigma = torch.from_numpy(sigma_np).to(dev)
    delta = torch.from_numpy(delta_np).to(dev)
    rgb = torch.from_numpy(rng.uniform(size=(R, S, 3)).astype(np.float32)).to(dev)
    worst = 0.0
    for early in (False, True):
        c, acc = kernel(sigma, rgb, delta, early, t_eps)
        pc, pa = plain(sigma, rgb, delta)
        torch.cuda.synchronize()
        err = max((c - pc).abs().max().item(), (acc - pa).abs().max().item())
        if not err <= 1e-5:
            raise AssertionError(f"alpha_composite early_stop={early}: "
                                 f"max |diff| {err} > 1e-5")
        worst = max(worst, err) if early else worst
    print(f"alpha_composite: within 1e-5 of the dense plain walk "
          f"(early stop {worst:.3g}), R={R} S={S}")
    t_k = median_ms(lambda: kernel(sigma, rgb, delta, True, t_eps))
    t_p = median_ms(lambda: plain(sigma, rgb, delta))
    t_c = median_ms(lambda: kernel(sigma, rgb, delta, True, t_eps),
                    hide_host=False)
    # Samples the early exit leaves unread: after the one where T < t_eps.
    alpha = 1.0 - np.exp(-sigma_np.astype(np.float64) * delta_np)
    T_after = np.cumprod(1.0 - alpha, axis=1)
    below = T_after < t_eps
    walked = np.where(below.any(1), below.argmax(1) + 1, S).sum()
    return entry("alpha_composite", "src/repro_torch/csrc/alpha_composite.cu",
                 "src/repro/kernels/alpha_composite.py:77", worst, t_k, t_p,
                 bound(cost.alpha_composite(R, S, int(walked))), None, t_c)


def composite_inputs(rng, dev, R: int = 512, S: int = 32, G: int = 32):
    """One march tier's compacted chunk at the serve shape: R camera rays
    of the first scene pose marched through a half-full G^3 grid on the
    card, ranked under a budget of every sample (B = R * S), and the field
    outputs the buffer rows would hold — sigma drawn per ray from empty to
    opaque, rgb uniform. Returns (sigma_b, rgb_b, take (int64 rank),
    valid, delta_row, march mask (P,) f32)."""
    from repro_torch.kernels.ray_march import ray_march_cuda
    from repro_torch.nerf.occupancy import ray_t_samples
    from repro_torch.nerf.render import RenderConfig

    _, _, ro, rd = serve_points(R, "cpu")
    rcfg = RenderConfig(n_samples=S)
    t = torch.from_numpy(ray_t_samples(rcfg)).to(dev)
    delta = torch.cat([torch.diff(t), torch.full((1,), 1e10, device=dev)])
    occ = torch.from_numpy((rng.uniform(size=(G, G, G)) < 0.5)
                           .astype(np.float32)).to(dev)
    mask = ray_march_cuda(occ, ro.to(dev).contiguous(),
                          rd.to(dev).contiguous(), t, True).reshape(-1)
    active = mask > 0.5
    P = R * S
    rank = torch.cumsum(active, dim=0) - 1
    valid = active & (rank < P)
    inv_take = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    inv_take.scatter_(0, torch.where(valid, rank, P),
                      torch.arange(P, device=dev))
    scale = rng.choice([0.0, 0.5, 5.0, 200.0], (R, 1))  # empty ... opaque
    sigma = torch.from_numpy((rng.exponential(1.0, (R, S)) * scale)
                             .astype(np.float32)).to(dev).reshape(-1)
    rgb = torch.from_numpy(rng.uniform(size=(P, 3)).astype(np.float32)) \
        .to(dev)
    rows = inv_take[:P]
    return (sigma[rows].contiguous(), rgb[rows].contiguous(), rank, valid,
            delta, mask)


def phase_gather_composite(rng, dev):
    from repro_torch.kernels import cost
    from repro_torch.kernels.gather_composite import (
        gather_composite_cuda as kernel,
        gather_composite_plain as plain,
    )

    t_eps = 1e-6
    sigma_b, rgb_b, take, valid, delta, mask = composite_inputs(rng, dev)
    R, S = take.numel() // delta.numel(), delta.numel()
    # The serve shape (one 32-sample chunk, int64 rank), a warp tier's
    # int32 take with the march mask to AND, and S = 64 (two chunks, where
    # the early exit can leave a ray).
    cases = [("serve", (sigma_b, rgb_b, take, valid, delta), {}),
             ("warp", (sigma_b, rgb_b, take.to(torch.int32),
                       valid | (torch.rand(valid.shape, device=dev) < 0.1),
                       delta), {"active": mask})]
    s64 = composite_inputs(rng, dev, R=256, S=64)
    cases.append(("S=64", s64[:5], {}))
    dense = 0.0
    for what, args, kw in cases:
        for early in (False, True):
            c, acc = kernel(*args, True, early, t_eps, **kw)
            c2, acc2 = kernel(*args, True, early, t_eps, **kw)
            pc, pa = plain(*args, True, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(c, c2) and torch.equal(acc, acc2)):
                raise AssertionError(f"gather_composite {what}: two calls "
                                     "gave different bits")
            err = max((c - pc).abs().max().item(),
                      (acc - pa).abs().max().item())
            if not err <= 1e-5:
                raise AssertionError(f"gather_composite {what} early_stop="
                                     f"{early}: max |diff| {err} > 1e-5")
            if what == "serve" and not early:
                dense = err
            print(f"  gather_composite {what} early_stop={early}: max |diff| "
                  f"{err:.3g}")
    print(f"gather_composite: within 1e-5 of the plain composition, early "
          f"stop off and on, bit-stable across calls; dense reading "
          f"{dense:.3g} at R={R} S={S} B={sigma_b.numel()} "
          f"({int(valid.sum())} active samples)")
    args = (sigma_b, rgb_b, take, valid, delta, True)
    t_k = median_ms(lambda: kernel(*args, True, t_eps))
    t_p = median_ms(lambda: plain(*args))
    t_c = median_ms(lambda: kernel(*args, True, t_eps), hide_host=False)
    if take.numel() != R * S:
        raise AssertionError(f"take holds {take.numel()} samples, not R S")
    c = cost.gather_composite(R, S, take.element_size(), int(valid.sum()))
    return entry("gather_composite", "src/repro_torch/csrc/gather_composite.cu",
                 "src/repro/kernels/alpha_composite.py:77", dense, t_k, t_p,
                 bound(c), None, t_c)


def phase_quant_matmul_unpacked(rng, dev, floor):
    from repro_torch.kernels import cost
    from repro_torch.kernels.quant_matmul import (
        quant_matmul_cuda as kernel,
        quant_matmul_plain as plain,
    )

    M = SERVE_ROWS
    shapes = [(M, K, N) for K, N in QMM_SHAPES] + [
        (1, 1, 1), (37, 45, 5), (300, 129, 70), (M + 13, 257, 65),
        (M, 64, 8), (M, 40, 200), (300, 33, 3)]
    worst = 0.0
    for m, K, N in shapes:
        x = torch.from_numpy(rng.integers(-128, 128, (m, K), dtype=np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-128, 128, (K, N), dtype=np.int8)).to(dev)
        sx = torch.tensor(float(rng.uniform(1e-3, 1e-1)), device=dev)
        for zx_v in (0, 17, -128, 127):
            zx = torch.tensor(zx_v, dtype=torch.int32, device=dev)
            a = kernel(x, w, sx, 0.011, zx)
            b = plain(x, w, sx, 0.011, zx)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(
                    f"quant_matmul M={m} K={K} N={N} zx={zx_v}: max |diff| "
                    f"{(a - b).abs().max().item()}")
            worst = max(worst, (a - b).abs().max().item())
    for K, N in ((40, 64), (33, 3)):
        w = torch.from_numpy(rng.integers(-128, 128, (K, N), dtype=np.int8)).to(dev)
        for what, x in unaligned_views(rng, M, K, dev).items():
            a = kernel(x, w, 0.02, 0.011, -5)
            b = plain(x, w, 0.02, 0.011, -5)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"quant_matmul x view {what} K={K} N={N}:"
                                     f" max |diff| {(a - b).abs().max().item()}")
    print(f"quant_matmul: exact on the {len(QMM_SHAPES)} paper linears "
          f"(M={M}) and {len(shapes) - len(QMM_SHAPES)} ragged shapes (N=3, "
          "8, 200 among them) x 4 zero points, and on x views off 16-byte "
          "boundaries")

    cases = qmm_inputs(rng, dev, packed=False)
    tot, seq = time_linears("quant_matmul", kernel, plain, cases, floor)
    bnd = bound(*(cost.quant_matmul(*x.shape, w.shape[1])
                  for x, w, *_ in cases))
    e = entry("quant_matmul", "src/repro_torch/csrc/quant_matmul.cu",
              "src/repro/kernels/quant_matmul.py:70", worst, tot["ms"],
              tot["plain_ms"], bnd, tot["lib_ms"],
              tot["call_ms"], **seq, launch_floor_ms=floor["floor_ms"])
    e["timed_as"] = "sum of the five paper linears, M=16384, int8 weights"
    return e


def launch_floor(dev):
    """The floor of one bracketed call: an empty launch (a one-element
    `add_`) timed as the kernels are, device time and one call from an
    idle device."""
    t = torch.zeros(1, device=dev)
    floor = {"floor_ms": median_ms(lambda: t.add_(1)),
             "floor_call_ms": median_ms(lambda: t.add_(1), hide_host=False)}
    print(f"timing floor, an empty launch (one-element add_): "
          f"{floor['floor_ms']:.4f} ms device time, {floor['floor_call_ms']:.4f}"
          f" ms one call; five separately bracketed launches take at least "
          f"{5 * floor['floor_ms']:.4f} ms")
    return floor


def lm_views(gen, dev, dtype, S):
    """q, k, v as the LM's prefill hands them to the kernel: strided views
    of (B, S, H, hd) and (B, S, Hkv, hd) projections."""
    B, Hkv, G, hd = LM_B, LM_HKV, LM_G, LM_HD
    q = torch.randn((B, S, Hkv * G, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
    return (q.view(B, S, Hkv, G, hd).permute(0, 2, 1, 3, 4),
            k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))


def phase_flash_attention(dev):
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention_kernel import (
        flash_attention_cuda as kernel,
        flash_attention_plain as plain,
    )

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    cases = [(torch.bfloat16, LM_PROMPT, True, 3e-2),
             (torch.float32, LM_PROMPT, True, 1e-4),
             (torch.bfloat16, LM_PROMPT, False, 3e-2),
             (torch.float32, 333, True, 1e-4),
             (torch.bfloat16, 333, True, 3e-2),
             (torch.bfloat16, 333, False, 3e-2)]
    for dtype, S, causal, tol in cases:
        q, k, v = lm_views(gen, dev, dtype, S)
        a = kernel(q, k, v, causal)
        b = plain(q, k, v, causal)
        torch.cuda.synchronize()
        err = (a - b).abs().max().item()
        if dtype == torch.bfloat16:
            tol = min(tol, BF16_ATTN_LIMIT)
        print(f"flash_attention {dtype} S={S} causal={causal}: max |diff| "
              f"{err:.3g} (tolerance {tol})")
        if not err <= tol:
            raise AssertionError(f"flash_attention: {err} > {tol}")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
    # The main path's shapes: bf16, causal, 28 heads on 4 KV heads.
    q, k, v = lm_views(gen, dev, torch.bfloat16, LM_PROMPT)
    B, Hkv, S, G, hd = q.shape
    # The same inputs in the library's layout: (B, H, S, hd) queries, head
    # h on KV head h // G, as the kernel groups them.
    qs = q.permute(0, 2, 1, 3, 4).reshape(B, S, Hkv * G, hd).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_k = median_ms(lambda: kernel(q, k, v, True))
    t_p = median_ms(lambda: plain(q, k, v, True))
    t_l = median_ms(lambda: sdpa(qs, k, v, is_causal=True, enable_gqa=True))
    t_c = median_ms(lambda: kernel(q, k, v, True), hide_host=False)
    return entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention_kernel.py:67", worst, t_k,
                 t_p, bound(cost.flash_attention(B, Hkv, G, hd, S, S, True, 2)),
                 t_l, t_c)


def phase_decode_attention(dev):
    from repro_torch.kernels import cost
    from repro_torch.kernels.decode_attention_kernel import (
        decode_attention_cuda as kernel,
        decode_attention_plain as plain,
        one_pass,
        split_len,
    )

    gen = torch.Generator(device=dev).manual_seed(2)
    B, Hkv, G, hd, S = LM_B, LM_HKV, LM_G, LM_HD, LM_SMAX
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    worst, routes = 0.0, {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q = torch.randn((B, Hkv, G, hd), generator=gen, device=dev).to(dtype)
        cache = [torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
                 .to(dtype) for _ in range(2)]
        k, v = (c.permute(0, 2, 1, 3) for c in cache)
        esize = q.element_size()
        sp = split_len(B * Hkv, S, G, hd, esize, n_sm)
        edges = {sp - 1, sp, sp + 1, 2 * sp, 2 * sp + 1, (S // sp) * sp}
        if one_pass(S, G, hd, esize):
            raise AssertionError("a length on the card reads all the cache's "
                                 f"{S} rows: it must take the split route")
        # Each length as an int (the route `one_pass` picks by it) and on
        # the card (the split route, whose split edges the int lengths
        # below the one-pass threshold no longer reach).
        for length in sorted({1, 64, LM_PROMPT + 1, LM_PROMPT + 16, S - 1,
                              S} | edges):
            routes.setdefault((str(dtype)[6:], "one-pass" if one_pass(
                length, G, hd, esize) else "split"), []).append(length)
            b = plain(q, k, v, length)
            for n in (length, torch.tensor(length, dtype=torch.int32,
                                           device=dev)):
                a = kernel(q, k, v, n)
                torch.cuda.synchronize()
                err = (a.float() - b.float()).abs().max().item()
                if dtype == torch.bfloat16:
                    tol = min(tol, BF16_ATTN_LIMIT)
                if not err <= tol:
                    raise AssertionError(f"decode_attention {dtype} length="
                                         f"{n}: {err} > {tol}")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
        # Positions at or past `length` are never read: poison them.
        length = LM_PROMPT + 16
        base = kernel(q, k, v, length)
        cache[0][:, length:] = 99.0
        cache[1][:, length:] = float("nan")
        poisoned = kernel(q, k, v, torch.tensor(length, device=dev))
        torch.cuda.synchronize()
        if not torch.equal(base, poisoned):
            raise AssertionError("decode_attention: positions >= length "
                                 "changed the result")
    print(f"decode_attention: within {BF16_ATTN_LIMIT} (bf16, worst "
          f"{worst:.3g}) and 1e-4 "
          f"(f32) of the plain version at lengths 1..{S}, on and beside the "
          f"edges of its {sp}-position splits, each length on the card (the "
          "split route) and as an int (" + "; ".join(
              f"{d} {r} at {v}" for (d, r), v in sorted(routes.items()))
          + "); future positions poisoned change nothing")
    q = torch.randn((B, Hkv, G, hd), generator=gen, device=dev).to(torch.bfloat16)
    cache = [torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2)]
    k, v = (c.permute(0, 2, 1, 3) for c in cache)
    length = LM_PROMPT + LM_GEN // 2  # the middle of a request's decode
    len_t = torch.tensor(length, dtype=torch.int32, device=dev)
    qs = q.reshape(B, Hkv * G, 1, hd)
    mask = (torch.arange(S, device=dev) < length)[None, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_k = median_ms(lambda: kernel(q, k, v, len_t))
    t_p = median_ms(lambda: plain(q, k, v, len_t))
    t_l = median_ms(lambda: sdpa(qs, k, v, attn_mask=mask, enable_gqa=True))
    t_c = median_ms(lambda: kernel(q, k, v, len_t), hide_host=False)
    # Cold: each timed call reads one of 8 caches (69 MB in all, against a
    # 50 MB L2), the one read longest ago, as the 28 layers' caches are.
    ring = [tuple(torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
                  .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
            for _ in range(8)]
    turn = iter(range(10 ** 9))

    def cold(f):
        """`f` on the next cache of the ring: the one read longest ago."""
        return lambda: f(*ring[next(turn) % len(ring)])

    t_kc = median_ms(cold(lambda kk, vv: kernel(q, kk, vv, len_t)))
    t_lc = median_ms(cold(lambda kk, vv: sdpa(qs, kk, vv, attn_mask=mask,
                                              enable_gqa=True)))
    ring_mb = len(ring) * 2 * ring[0][0].numel() * 2 / 1e6
    print(f"  decode_attention cold ({len(ring)} caches, {ring_mb:.1f} MB): "
          f"kernel {t_kc:.4f} ms, SDPA {t_lc:.4f} ms; warm: kernel "
          f"{t_k:.4f} ms, SDPA {t_l:.4f} ms")
    return entry("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention_kernel.py:61", worst, t_k,
                 t_p, bound(cost.decode_attention(B, Hkv, G, hd, length, 2)),
                 t_l, t_c, ms_cold=t_kc, library_ms_cold=t_lc)


# ---------------------------------------------------------------------------
# The main path.
# ---------------------------------------------------------------------------
# The mixed policy every served artifact carries: 6-bit hash levels,
# 4-bit weights, 8-bit activations (every linear in the `int` mode).
KIND_BITS = {"HASH_LEVEL": 6, "WEIGHT": 4, "ACTIVATION": 8}
# The episode's defaults (`EnvConfig` of the reference's `core/env.py`):
# trace rays drawn before the calibration rays, calibration points, the
# occupancy grid's resolution and threshold, the QAT finetune's steps.
TRACE_RAYS, CALIB_POINTS = 1024, 2048
OCC_RESOLUTION, OCC_THRESHOLD, FINETUNE_STEPS = 32, 1e-2, 40
# The reference's acceptance band of fused against reference-mode PSNR.
PSNR_BAND_DB = 0.1


def mixed_spec(cfg, act_ranges):
    """(bits in unit walk order, spec) of the mixed policy."""
    from repro_torch.nerf.ngp import make_quant_units, spec_from_policy
    from repro_torch.quant.policy import QuantPolicy

    units = make_quant_units(cfg)
    bits = [KIND_BITS[u.kind.name] for u in units]
    return bits, spec_from_policy(
        cfg, QuantPolicy.uniform(units, 8).with_bits(bits), act_ranges)


def pack_artifact(params, act_ranges, occ, cfg, metrics=None,
                  name="random-weights"):
    """A `QuantArtifact` of the chair scene's `params` under the mixed
    policy."""
    from repro_torch.hero.artifact import QuantArtifact
    from repro_torch.nerf.fast_render import build_fused_pack
    from repro_torch.nerf.ngp import ngp_linear_names
    from repro_torch.nerf.render import RenderConfig
    from repro_torch.nerf.scenes import SceneConfig

    bits, spec = mixed_spec(cfg, act_ranges)
    pack = build_fused_pack(params, cfg, spec)
    if pack.modes != ("int",) * len(ngp_linear_names(cfg)):
        raise AssertionError(f"expected every linear in int mode: {pack.modes}")
    return QuantArtifact(
        scene="chair", bits=bits, cfg=cfg, rcfg=RenderConfig(),
        scene_cfg=dataclasses.asdict(SceneConfig()), params=params,
        act_ranges=act_ranges, pack=pack, occ=occ, hardware={"name": name},
        metrics=metrics or {})


def build_artifact(cfg, device, seed: int = 0, occ_resolution: int = 32):
    """Random `cfg`-width weights from `seed`, activation ranges from the
    field's taps on camera-ray samples, a baked occupancy grid (full: every
    random density is near 1), packed under the mixed policy."""
    from repro_torch.nerf.ngp import init_ngp, ngp_apply, ngp_linear_names
    from repro_torch.nerf.occupancy import bake_occupancy

    params = init_ngp(torch.Generator().manual_seed(seed), cfg, device=device)
    pts, dirs, _, _ = serve_points(4096, device)
    pick = torch.from_numpy(
        np.random.default_rng(seed).choice(pts.shape[0] // 32, 64,
                                           replace=False))
    sel = ((pick[:, None] * 32) + torch.arange(32)[None]).reshape(-1).to(device)
    with torch.no_grad():
        _, _, taps = ngp_apply(params, pts[sel], dirs[sel], cfg,
                               return_taps=True)
    act_ranges = torch.tensor(
        [[float(taps[n].min()), float(taps[n].max())]
         for n in ngp_linear_names(cfg)], dtype=torch.float32, device=device)
    occ = bake_occupancy(params, cfg, resolution=occ_resolution)
    return pack_artifact(params, act_ranges, occ, cfg)


# ---------------------------------------------------------------------------
# Training and the PSNR half of the reward.
# ---------------------------------------------------------------------------
def calibrate_ranges(params, ds, cfg, rcfg, seed: int = 0):
    """Activation ranges as the episode calibrates them: from the seed's
    stream, the trace rays' draw, then 64 train rays sampled at the
    render's `linspace` depths, clipped into the unit cube; the field's
    taps on the first `CALIB_POINTS` points give each linear (min, max)."""
    from repro_torch.nerf.ngp import ngp_apply, ngp_linear_names

    dev = params["sigma/0"]["w"].device
    rng = np.random.RandomState(seed)
    n = ds.train_rays_o.shape[0]
    rng.randint(0, n, size=TRACE_RAYS)
    idx = rng.randint(0, n, size=64)
    t = np.linspace(rcfg.near, rcfg.far, rcfg.n_samples)
    pts = ds.train_rays_o[idx][:, None, :] \
        + ds.train_rays_d[idx][:, None, :] * t[None, :, None]
    pts = np.clip(pts + 0.5, 0.0, 1.0).reshape(-1, 3)
    dirs = np.broadcast_to(ds.train_rays_d[idx][:, None, :],
                           (idx.size, t.size, 3)).reshape(-1, 3)
    k = min(CALIB_POINTS, pts.shape[0])
    with torch.no_grad():
        _, _, taps = ngp_apply(
            params, torch.from_numpy(pts[:k].astype(np.float32)).to(dev),
            torch.from_numpy(dirs[:k].astype(np.float32)).to(dev), cfg,
            None, return_taps=True)
    return torch.tensor([[float(taps[nm].min()), float(taps[nm].max())]
                         for nm in ngp_linear_names(cfg)],
                        dtype=torch.float32, device=dev)


class StepTimer:
    """Wraps the train step of `repro_torch.nerf.train` while in use: each
    step is bracketed by CUDA events and its loss kept, so `train_ngp` and
    `finetune_ngp` run as a user calls them."""

    def __init__(self, train_mod):
        self.mod, self.events, self.losses = train_mod, [], []

    def __enter__(self):
        self.step = self.mod._train_step

        def timed(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.step(*args, **kw)
            b.record()
            self.events.append((a, b))
            self.losses.append(out[2])
            return out
        self.mod._train_step = timed
        return self

    def __exit__(self, *exc):
        self.mod._train_step = self.step

    def summary(self):
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self.events]
        return (float(np.median(ms)), float(self.losses[0]),
                float(self.losses[-1]))


def psnr_eval(label, engine, ds, kern):
    """One `evaluate_psnr` under the profiler, every kernel's count zeroed
    just before and read just after: (psnr, launches, profile)."""
    for fn in kern.values():
        fn.launches = 0
    out = {}
    prof = profile(label, lambda: out.setdefault("psnr",
                                                 engine.evaluate_psnr(ds)))
    torch.cuda.synchronize()
    return out["psnr"], {n: fn.launches for n, fn in kern.items()}, prof[2]


def profile_train_step(train_mod, params, ds, cfg, rcfg, tcfg, dev):
    """One more unquantized train step of `params` under the profiler:
    where a step's time goes."""
    from repro_torch.nerf.ngp import no_quant_spec
    from repro_torch.optim import AdamWConfig, adamw_init

    batch = [torch.from_numpy(a).to(dev)
             for a in next(ds.ray_batches(tcfg.batch_rays, seed=1))]
    jitter = torch.rand((tcfg.batch_rays, rcfg.n_samples), device=dev)
    opt = AdamWConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay)
    state, spec = adamw_init(params), no_quant_spec(cfg, dev)
    profile(f"one train step ({tcfg.batch_rays} rays)",
            lambda: train_mod._train_step(params, state, *batch, jitter,
                                          spec, cfg, rcfg, opt))


def train_and_score(cfg, dev, kern):
    """The training phase at `cfg` width: the chair scene's dataset rendered
    on the card, `train_ngp` (`TrainConfig()`), `evaluate_psnr` in reference
    mode, the episode's calibration and occupancy bake, the QAT finetune
    under the mixed policy, then the PSNR of the finetuned field in
    reference mode and in fused mode under the test set's cull plan and
    under an explicit budget (the march), each within `PSNR_BAND_DB` of
    reference mode. Returns (the finetuned artifact, the two fused
    evaluations' launches, the plan row's timings, (the trained params,
    the dataset))."""
    from repro_torch.nerf import train as train_mod
    from repro_torch.nerf.dataset import make_dataset
    from repro_torch.nerf.fast_render import FastRenderEngine
    from repro_torch.nerf.occupancy import bake_occupancy
    from repro_torch.nerf.render import RenderConfig
    from repro_torch.nerf.scenes import SceneConfig

    t0 = time.perf_counter()
    ds = make_dataset(SceneConfig(), device=dev)
    print(f"dataset: chair, {ds.train_rgb.shape[0]} train rays, "
          f"{ds.test_rgb.shape[0]} test views of {ds.test_rgb.shape[1]} rays, "
          f"rendered on the card in {time.perf_counter() - t0:.2f} s")
    rcfg, tcfg = RenderConfig(), train_mod.TrainConfig()
    t0 = time.perf_counter()
    with StepTimer(train_mod) as timer:
        params, last = train_mod.train_ngp(ds, cfg, rcfg, tcfg, device=dev)
    ms, first, last_rec = timer.summary()
    wall = time.perf_counter() - t0
    if not (np.isfinite(last) and last == last_rec and last < first):
        raise AssertionError(f"training did not lower the loss: {first} -> "
                             f"{last} ({last_rec} recorded)")
    print(f"train_ngp: {tcfg.steps} steps of {tcfg.batch_rays} rays in "
          f"{wall:.2f} s, median {ms:.3f} ms a step (CUDA events), loss "
          f"{first:.6f} -> {last:.6f}")
    profile_train_step(train_mod, params, ds, cfg, rcfg, tcfg, dev)
    p_trained = train_mod.evaluate_psnr(params, ds, cfg, rcfg, device=dev)
    act_ranges = calibrate_ranges(params, ds, cfg, rcfg)
    occ = bake_occupancy(params, cfg, resolution=OCC_RESOLUTION,
                         threshold=OCC_THRESHOLD)
    print(f"reference-mode PSNR of the trained field {p_trained:.4f} dB; "
          f"occupancy grid {OCC_RESOLUTION}^3 at {OCC_THRESHOLD}: occupied "
          f"fraction {occ.occupied_fraction:.4f}")
    _, spec = mixed_spec(cfg, act_ranges)
    with StepTimer(train_mod) as timer:
        ft, ft_loss = train_mod.finetune_ngp(params, ds, cfg, rcfg, tcfg,
                                             spec, FINETUNE_STEPS, device=dev)
    ft_ms, ft_first, _ = timer.summary()
    print(f"finetune_ngp (6-bit hash, 4-bit weights, 8-bit activations): "
          f"{FINETUNE_STEPS} steps, median {ft_ms:.3f} ms a step, loss "
          f"{ft_first:.6f} -> {ft_loss:.6f}")

    ref = train_mod.evaluate_psnr(ft, ds, cfg, rcfg, spec, device=dev)
    plan_eng = FastRenderEngine(ft, cfg, rcfg, spec=spec, occ=occ,
                                mode="fused", device=dev)
    t0 = time.perf_counter()
    budget = plan_eng.test_views_budget(ds)  # builds the plan, once
    plan_s = time.perf_counter() - t0
    plan_chunk = plan_row_corners(plan_eng, ds)
    p_plan, l_plan, prof_plan = psnr_eval(
        "fused evaluate_psnr, plan path", plan_eng, ds, kern)
    march_eng = FastRenderEngine(ft, cfg, rcfg, spec=spec, occ=occ,
                                 mode="fused", budget=budget, device=dev)
    p_march, l_march, prof_march = psnr_eval(
        "fused evaluate_psnr, march path (explicit budget)", march_eng, ds,
        kern)
    cap = min(tcfg.eval_ray_chunk, ds.test_rgb.shape[0]
              * ds.test_rgb.shape[1]) * rcfg.n_samples
    print(f"finetuned field PSNR: reference mode {ref:.4f} dB, fused plan "
          f"{p_plan:.4f} dB, fused march {p_march:.4f} dB; plan budget "
          f"{budget} of {cap} samples a chunk (built in {plan_s:.2f} s)")
    for name, p, prof in (("plan", p_plan, prof_plan),
                          ("march", p_march, prof_march)):
        print(f"  {name}: {prof['wall_ms']:.2f} ms wall, "
              f"{prof['device_ms']:.3f} ms device, {prof['events']} events")
        if not abs(p - ref) < PSNR_BAND_DB:
            raise AssertionError(f"fused {name} PSNR {p} is not within "
                                 f"{PSNR_BAND_DB} dB of reference mode {ref}")
    print(f"  launches, plan path: {l_plan}; march path: {l_march}")
    for name, launched, want in (
            ("plan", l_plan, ("quant_matmul_packed", "hash_encode_corners",
                              "gather_composite")),
            ("march", l_march, ("quant_matmul_packed", "hash_encode",
                                "gather_composite", "ray_march"))):
        if min(launched[k] for k in want) <= 0 or launched["hash_gather"]:
            raise AssertionError(f"the {name} path did not launch each of "
                                 f"{want}, or launched the bare gather: "
                                 f"{launched}")
    if l_plan["hash_encode_corners"] != l_plan["gather_composite"]:
        raise AssertionError(f"the plan path did not encode once a chunk: "
                             f"{l_plan}")
    metrics = {"psnr_reference": ref, "psnr_fused": p_plan,
               "psnr_trained": p_trained}
    art = pack_artifact(ft, act_ranges, occ, cfg, metrics=metrics,
                        name="trained")
    return (art, {"psnr_plan": l_plan, "psnr_march": l_march}, plan_chunk,
            (params, ds))


def plan_row_corners(engine, ds):
    """The corners kernel on the first chunk of the test set's cull plan,
    the trained field's table and its first linear's activation grid:
    bit-equal to its plain version, timed beside the points kernel on the
    row's `buf_pts` (the plan is cached: the evaluation reuses it)."""
    from repro_torch.nerf.fast_render import _test_set_plan
    from repro_torch.nerf.hash_encoding import level_meta
    from repro_torch.nerf.ngp import ngp_linear_names

    plan = _test_set_plan(ds, engine.occ, engine.rcfg, engine.chunk,
                          engine.cfg)
    pts, _, _, _, idx, w, _ = plan.row(0)
    pack = engine.pack
    act = pack.layers[ngp_linear_names(engine.cfg)[0]]
    return time_corners(f"the trained plan's chunk 0 of "
                        f"{plan.buf_pts.shape[0]}", idx, w,
                        pack.compute["table_cat"], pack.compute["table_off"],
                        act, pts, level_meta(engine.cfg.hash, pts.device))


def train_card_vs_cpu(dev, steps: int = 5, loss_rtol: float = 1e-5,
                      leaf_atol: float = 5e-5):
    """`steps` train steps at the 4-level test config on the card and on
    the CPU from the same initial parameters, batches and jitter. The
    card sums the tables' gradients in another order (sorted index
    reductions), and its matmuls and transcendentals round otherwise, so
    the two agree to a tolerance: the loss within `loss_rtol`, every leaf
    within `leaf_atol`
    (1 % of one step of lr 5e-3; AdamW's first updates m / sqrt(v) are
    most sensitive where a gradient is near zero). Returns the gaps."""
    from repro_torch.nerf import train as train_mod
    from repro_torch.nerf.dataset import make_dataset
    from repro_torch.nerf.hash_encoding import HashEncodingConfig
    from repro_torch.nerf.ngp import NGPConfig, init_ngp, no_quant_spec
    from repro_torch.nerf.render import RenderConfig
    from repro_torch.nerf.scenes import SceneConfig
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree_util import leaves_with_path

    cfg = NGPConfig(hash=HashEncodingConfig(n_levels=4, log2_table_size=9,
                                            base_resolution=4,
                                            max_resolution=32),
                    hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7,
                    sh_degree=2)
    rcfg, opt = RenderConfig(n_samples=16), AdamWConfig(lr=5e-3,
                                                       weight_decay=1e-6)
    cpu = torch.device("cpu")
    ds = make_dataset(SceneConfig(image_hw=16, n_train_views=4,
                                  n_test_views=2), device=cpu)
    p0 = init_ngp(torch.Generator().manual_seed(0), cfg, device=cpu)
    gen = torch.Generator().manual_seed(0)
    batches = ds.ray_batches(64, seed=0)
    inputs = [tuple(torch.from_numpy(a) for a in next(batches))
              + (torch.rand((64, 16), generator=gen),)
              for _ in range(steps)]
    runs = {}
    for d in (dev, cpu):
        params = to_device(p0, d)
        state, losses = adamw_init(params), []
        for batch in inputs:
            params, state, loss = train_mod._train_step(
                params, state, *(a.to(d) for a in batch),
                no_quant_spec(cfg, d), cfg, rcfg, opt)
            losses.append(float(loss))
        runs[d.type] = (losses, dict(leaves_with_path(params)))
    (l_dev, p_dev), (l_cpu, p_cpu) = runs[dev.type], runs["cpu"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_cpu))
    leaf_gap = max((p_dev[k].cpu() - v).abs().max().item()
                   for k, v in p_cpu.items())
    print(f"train card vs CPU ({steps} steps, 4-level config): loss max "
          f"relative gap {loss_gap:.3g} (tolerance {loss_rtol}), leaves max "
          f"|diff| {leaf_gap:.3g} (tolerance {leaf_atol})")
    if not (loss_gap <= loss_rtol and leaf_gap <= leaf_atol):
        raise AssertionError(f"train card vs CPU: loss {loss_gap}, leaves "
                             f"{leaf_gap}")
    return loss_gap, leaf_gap


# ---------------------------------------------------------------------------
# The search: the cost half of the reward, the env, DDPG and the population.
# ---------------------------------------------------------------------------
# Depth cuts of the search phase (PERF.md section 4): 6 episodes of the
# reference's 40, 2 population iterations of its 12 (K = 16 as there).
SEARCH_EPISODES, POP_ITERATIONS, POP_K = 6, 2, 16
SIM_K = 64  # policies a simulator timing scores in one call
ORACLE_RTOL = 1e-3  # every cycle term against the float64 numpy oracle
CARD_CPU_RTOL, CARD_CPU_PSNR_DB = 1e-6, 1e-3
# Kernels an episode's fused PSNR on the test set's cull plan launches,
# and kernels off that path.
SEARCH_KERNELS = ("quant_matmul_packed", "hash_encode_corners",
                  "gather_composite")
SEARCH_OFF_PATH = ("hash_gather", "alpha_composite")


def oracle_policies(env, n_random: int = 64, seed: int = 0):
    """The 8-bit baseline, the env's 26 slope policies (one unit 8 -> 4)
    and `n_random` random ones, in walk order."""
    n = env.n_units
    slopes = np.full((n, n), 8)
    slopes[np.arange(n), np.arange(n)] = 4
    rand = np.random.RandomState(seed).randint(1, 9, size=(n_random, n))
    return np.concatenate([np.full((1, n), 8), slopes, rand])


def cache_stats_vs_oracle(benv, bits, dev):
    """A fresh card simulator on the env's trace scores every policy in
    one call; the copied float64 numpy oracle walks each (threads: its
    sorts release the interpreter lock). The cache statistics must be
    equal, every cycle term within `ORACLE_RTOL`, `model_bytes` equal."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.hwsim import BatchedNeuRexSimulator, NeuRexSimulator

    env = benv.env
    hw, res = env.target.hw, env.cfg.hash.resolutions()
    hb, wb, ab = benv.bits_to_arrays(bits)
    sim = BatchedNeuRexSimulator(env.trace, hw, n_features=2,
                                 resolutions=res, device=dev)
    t0 = time.perf_counter()
    got = sim.simulate_batch(hb, wb, ab)
    card_s = time.perf_counter() - t0
    oracle = NeuRexSimulator(hw, backend="numpy")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as ex:
        want = list(ex.map(lambda i: oracle.simulate(
            env.trace, hb[i], wb[i], ab[i], resolutions=res),
            range(len(hb))))
    oracle_s = time.perf_counter() - t0
    worst = 0.0
    for i, w in enumerate(want):
        st = w.grid_cache
        if (int(got["grid_hits"][i]), int(got["grid_misses"][i]),
                int(got["grid_cold_misses"][i])) != (st.hits, st.misses,
                                                     st.cold_misses):
            raise AssertionError(f"policy {i}: card cache statistics "
                                 f"{got['grid_misses'][i]} misses, oracle "
                                 f"{st}")
        if float(got["model_bytes"][i]) != w.model_bytes:
            raise AssertionError(f"policy {i}: model_bytes "
                                 f"{got['model_bytes'][i]} != {w.model_bytes}")
        for key in ("lookup_cycles", "grid_miss_cycles",
                    "subgrid_prefetch_cycles", "encode_cycles",
                    "mlp_compute_cycles", "total_cycles", "dram_bytes"):
            ref = getattr(w, key)
            gap = abs(float(got[key][i]) - ref) / max(abs(ref), 1e-30)
            worst = max(worst, gap)
    if not worst <= ORACLE_RTOL:
        raise AssertionError(f"a cycle term is {worst} off the oracle")
    tc = sim.tc
    distinct = len({tuple(r) for r in np.round(hb[:, :tc.n_coarse] * 2)})
    print(f"cache statistics against the numpy oracle: {len(bits)} policies "
          f"({distinct} coarse combinations, {tc.n_points * 8 * tc.n_coarse} "
          f"accesses each) equal, "
          f"cycle terms within {worst:.3g} (tolerance {ORACLE_RTOL}), "
          f"model_bytes equal; card {card_s:.3f} s in one call, oracle "
          f"{oracle_s:.2f} s on 8 threads; misses "
          f"{int(got['grid_misses'].min())}..{int(got['grid_misses'].max())}")


def simulator_speed(benv, dev):
    """`simulate_batch` at K = `SIM_K` random policies, cold (memo
    cleared) and warm, on the card and on the host, their results equal;
    and the device sort of the K streams alone, timed by CUDA events."""
    from repro_torch.hwsim import BatchedNeuRexSimulator
    from repro_torch.hwsim.batched import grid_cache_stats

    env = benv.env
    hw, res = env.target.hw, env.cfg.hash.resolutions()
    bits = np.random.RandomState(1).randint(1, 9, size=(SIM_K, env.n_units))
    hb, wb, ab = benv.bits_to_arrays(bits)
    out, rates = [], []  # the card's, then the host's
    for where in (dev, torch.device("cpu")):
        sim = BatchedNeuRexSimulator(env.trace, hw, n_features=2,
                                     resolutions=res, device=where)
        times = []
        for memo in ("cold", "warm"):
            if memo == "cold":
                sim.clear_stats_memo()
            t0 = time.perf_counter()
            got = sim.simulate_batch(hb, wb, ab)
            times.append(time.perf_counter() - t0)
        out.append(got)
        rates.append([SIM_K / t for t in times])
    (card, host), (card_rate, host_rate) = out, rates
    for key in ("grid_hits", "grid_misses", "grid_cold_misses",
                "model_bytes"):
        if not np.array_equal(card[key], host[key]):
            raise AssertionError(f"card and host simulators differ in {key}")
    gap = float(np.max(np.abs(card["total_cycles"].astype(np.float64)
                              - host["total_cycles"])
                       / host["total_cycles"]))
    if not gap <= CARD_CPU_RTOL:
        raise AssertionError(f"card and host cycles differ by {gap}")
    tc = sim.tc
    eb8 = torch.from_numpy(np.round(hb[:, :tc.n_coarse] * 2)
                           .astype(np.int64)).to(dev)
    coarse = torch.from_numpy(tc.coarse_indices).to(dev)
    sort_ms = median_ms(lambda: grid_cache_stats(eb8, tc, hw, coarse),
                        iters=5, warmup=1)
    n_acc = tc.n_points * 8 * tc.n_coarse
    speedup = card_rate[0] / host_rate[0]
    print(f"simulate_batch K={SIM_K}: card {card_rate[0]:.1f} policies/s "
          f"cold, {card_rate[1]:.1f} warm; host "
          f"{host_rate[0]:.2f} cold, {host_rate[1]:.1f} warm (cold: "
          f"card {speedup:.1f}x the host); the device cache walk of "
          f"{SIM_K} x {n_acc} accesses {sort_ms:.3f} ms "
          f"({sort_ms / SIM_K:.4f} ms a policy); card and host equal "
          f"(cycles within {gap:.3g})")


class EpisodeTimer:
    """Times an env's PSNR scores and simulator calls (CUDA-synchronised
    host clock) while in use."""

    def __init__(self, env):
        self.env, self.ms = env, {"psnr": [], "simulate": []}

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    def __enter__(self):
        self.env.eval_psnr = self._wrap("psnr", self.env.eval_psnr)
        self.env.simulate_policy = self._wrap("simulate",
                                              self.env.simulate_policy)
        return self

    def __exit__(self, *exc):
        del self.env.eval_psnr, self.env.simulate_policy


def act_ms(dev, n_units: int) -> float:
    """Median host ms of one `DDPGAgent.act()` past warm-up on the card
    (one actor forward and one scalar copy to the host)."""
    from repro_torch.core import DDPGAgent

    agent = DDPGAgent(device=dev)
    agent._episodes_seen = agent.cfg.warmup_episodes
    obs = np.random.RandomState(0).rand(n_units, 7).astype(np.float32)
    ms = []
    for o in np.concatenate([obs, obs]):
        t0 = time.perf_counter()
        agent.act(o)
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms[n_units:]))


def search_card_vs_cpu(dev, bits_seed: int = 3):
    """A 4-level env on the card and on the CPU from the same briefly
    trained field: `evaluate_bits(bits, finetune_steps=0)` of two policies
    gives equal misses, cycles within `CARD_CPU_RTOL` relative and PSNR
    within `CARD_CPU_PSNR_DB`."""
    from repro_torch.core import EnvConfig, NGPQuantEnv
    from repro_torch.hwsim import HWConfig
    from repro_torch.nerf import train as train_mod
    from repro_torch.nerf.dataset import make_dataset
    from repro_torch.nerf.hash_encoding import HashEncodingConfig
    from repro_torch.nerf.ngp import NGPConfig
    from repro_torch.nerf.render import RenderConfig
    from repro_torch.nerf.scenes import SceneConfig

    cfg = NGPConfig(hash=HashEncodingConfig(n_levels=4, log2_table_size=9,
                                            base_resolution=4,
                                            max_resolution=32),
                    hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7,
                    sh_degree=2)
    rcfg, cpu = RenderConfig(n_samples=16), torch.device("cpu")
    tcfg = train_mod.TrainConfig(steps=20, batch_rays=64)
    ds = make_dataset(SceneConfig(image_hw=16, n_train_views=4,
                                  n_test_views=2), device=cpu)
    params, _ = train_mod.train_ngp(ds, cfg, rcfg, tcfg, device=cpu)
    ecfg = EnvConfig(finetune_steps=0, trace_rays=64, calib_points=256)
    envs = [NGPQuantEnv(to_device(params, d), ds, cfg, rcfg, tcfg, ecfg,
                        HWConfig(coarse_levels=2), device=d)
            for d in (dev, cpu)]
    rng = np.random.RandomState(bits_seed)
    worst = [0.0, 0.0]
    for bits in ([8] * 14, [int(b) for b in rng.randint(1, 9, size=14)]):
        card, host = (e.evaluate_bits(bits, finetune_steps=0) for e in envs)
        m = [e.simulate_policy(r.policy).grid_cache.misses
             for e, r in zip(envs, (card, host))]
        cyc = abs(card.latency_cycles - host.latency_cycles) \
            / host.latency_cycles
        dpsnr = abs(card.psnr - host.psnr)
        worst = [max(worst[0], cyc), max(worst[1], dpsnr)]
        if m[0] != m[1] or not cyc <= CARD_CPU_RTOL \
                or not dpsnr <= CARD_CPU_PSNR_DB:
            raise AssertionError(f"search card vs CPU, bits {bits}: misses "
                                 f"{m}, cycles {cyc}, PSNR {dpsnr}")
    print(f"search card vs CPU (4-level env, 2 policies): misses equal, "
          f"cycles within {worst[0]:.3g} (tolerance {CARD_CPU_RTOL}), PSNR "
          f"within {worst[1]:.3g} dB (tolerance {CARD_CPU_PSNR_DB})")


def search_phase(cfg, params, ds, dev, kern):
    """The HERO search at `cfg` width on the trained chair: the env
    (`EnvConfig()`, `HWConfig()`), its trace against the CPU's, the card's
    cache statistics against the numpy oracle, the simulator's speed,
    `hero_search` for `SEARCH_EPISODES` episodes with every kernel's count
    zeroed around them, one episode's fused PSNR against reference mode,
    the population (`evaluate_population` and `hero_population_search`),
    and a 4-level env card against CPU. Returns (the episodes' launches,
    the env, the batched env)."""
    from repro_torch.core import (
        BatchedEnvConfig,
        BatchedQuantEnv,
        EnvConfig,
        NGPQuantEnv,
        PopulationSearchConfig,
        SearchConfig,
        hero_population_search,
        hero_search,
    )
    from repro_torch.hwsim import build_trace
    from repro_torch.nerf import train as train_mod
    from repro_torch.nerf.fast_render import FastRenderEngine, build_fused_pack
    from repro_torch.nerf.ngp import spec_from_policy
    from repro_torch.nerf.render import RenderConfig

    t_phase = time.perf_counter()
    rcfg, tcfg, ecfg = RenderConfig(), train_mod.TrainConfig(), EnvConfig()
    t0 = time.perf_counter()
    with StepTimer(train_mod) as timer:
        env = NGPQuantEnv(params, ds, cfg, rcfg, tcfg, ecfg, device=dev)
    env_s = time.perf_counter() - t0
    print(f"NGPQuantEnv (EnvConfig(), HWConfig()): built in {env_s:.2f} s "
          f"(trace, calibration, bake, {ecfg.finetune_steps}-step 8-bit "
          f"finetune at {timer.summary()[0]:.3f} ms a step, fused PSNR, "
          f"{env.n_units} slopes); psnr_org {env.psnr_org:.4f} dB, "
          f"original_cost {env.original_cost:.1f} cycles")

    idx = np.random.RandomState(0).randint(0, ds.train_rays_o.shape[0],
                                           size=ecfg.trace_rays)
    t0 = time.perf_counter()
    host = build_trace(cfg, rcfg, ds.train_rays_o[idx], ds.train_rays_d[idx],
                       env.target.hw.subgrid_resolution, device="cpu")
    host_s = time.perf_counter() - t0
    for a, b in zip(env.trace.level_indices, host.level_indices):
        if not np.array_equal(a, b):
            raise AssertionError("the card's trace differs from the CPU's")
    if not (np.array_equal(env.trace.subgrid_ids, host.subgrid_ids)
            and env.trace.mlp_dims == host.mlp_dims
            and env.trace.level_entries == host.level_entries):
        raise AssertionError("the card's trace differs from the CPU's")
    print(f"trace: {env.trace.n_points} points x {len(host.level_indices)} "
          f"levels, card equal to CPU (CPU build {host_s:.2f} s)")

    t0 = time.perf_counter()
    benv = BatchedQuantEnv(env, BatchedEnvConfig(), device=dev)
    benv_s = time.perf_counter() - t0
    cache_stats_vs_oracle(benv, oracle_policies(env), dev)
    simulator_speed(benv, dev)

    for fn in kern.values():
        fn.launches = 0
    with StepTimer(train_mod) as timer, EpisodeTimer(env) as ep:
        t0 = time.perf_counter()
        res = hero_search(env, SearchConfig(n_episodes=SEARCH_EPISODES,
                                            verbose=False), device=dev)
        search_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in kern.items()}
    for i, h in enumerate(res.history):
        if not (np.isfinite(h.psnr) and h.latency_cycles > 0):
            raise AssertionError(f"episode {i}: {h}")
        print(f"  episode {i} ({'warm-up' if i < 4 else 'actor'}): bits "
              f"{''.join(map(str, h.bits))}, PSNR {h.psnr:.4f} dB, latency "
              f"{h.latency_cycles:.1f} cycles, model {h.model_bytes:.0f} B, "
              f"reward {h.reward:+.4f}, {h.wall_seconds:.2f} s")
    ft_ms = timer.summary()[0]
    print(f"hero_search: {SEARCH_EPISODES} episodes in {search_s:.2f} s; "
          f"finetune median {ft_ms:.3f} ms a step, PSNR median "
          f"{np.median(ep.ms['psnr']):.2f} ms, simulation median "
          f"{np.median(ep.ms['simulate']):.2f} ms an episode; launches "
          f"{launches}")
    if min(launches[k] for k in SEARCH_KERNELS) <= 0 or any(
            launches[k] for k in SEARCH_OFF_PATH):
        raise AssertionError(f"the episodes did not launch each of "
                             f"{SEARCH_KERNELS}, or launched one of "
                             f"{SEARCH_OFF_PATH}: {launches}")

    last = res.history[-1]
    spec = spec_from_policy(cfg, last.policy, env.act_ranges)
    ft, _ = train_mod.finetune_ngp(dict(env.params), ds, cfg, rcfg, tcfg,
                                   spec, ecfg.finetune_steps, device=dev)
    fused = env.eval_psnr(ft, spec)
    ref = train_mod.evaluate_psnr(ft, ds, cfg, rcfg, spec, device=dev)
    print(f"episode {len(res.history) - 1} again: fused PSNR {fused:.4f} dB "
          f"(the episode read {last.psnr:.4f}), reference mode {ref:.4f} dB")
    if not abs(fused - ref) < PSNR_BAND_DB:
        raise AssertionError(f"the episode's fused PSNR {fused} is not "
                             f"within {PSNR_BAND_DB} dB of reference mode")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pack = build_fused_pack(ft, cfg, spec)
    torch.cuda.synchronize()
    pack_ms = (time.perf_counter() - t0) * 1e3
    engine = FastRenderEngine(ft, cfg, rcfg, spec=spec, occ=env.occ,
                              mode="fused", pack=pack, device=dev)
    t0 = time.perf_counter()
    engine.evaluate_psnr(ds)
    eval_ms = (time.perf_counter() - t0) * 1e3
    print(f"an episode's fused PSNR: the pack build {pack_ms:.1f} ms, the "
          f"evaluation on the built pack {eval_ms:.1f} ms")
    profile("the fused pack build of an episode's policy",
            lambda: build_fused_pack(ft, cfg, spec))

    bits = np.random.RandomState(2).randint(1, 9, size=(POP_K, env.n_units))
    t0 = time.perf_counter()
    ev = benv.evaluate_population(bits)
    pop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    benv.simulate_batch(bits)
    sim_s = time.perf_counter() - t0
    if not (np.all(np.isfinite(ev.psnr)) and ev.k == POP_K
            and np.all(ev.latency_cycles > 0)):
        raise AssertionError(f"evaluate_population: {ev}")
    t0 = time.perf_counter()
    pres = hero_population_search(
        benv, PopulationSearchConfig(n_iterations=POP_ITERATIONS,
                                     population=POP_K, verbose=False),
        device=dev)
    psearch_s = time.perf_counter() - t0
    if pres.policies_evaluated != POP_ITERATIONS * POP_K \
            or not np.isfinite(pres.best_reward):
        raise AssertionError(f"hero_population_search: {pres}")
    act = act_ms(dev, env.n_units)
    profile("one proxy render (K = 1, 512 rays, reference mode)",
            lambda: benv.evaluate_population(bits[:1]))
    print(f"BatchedQuantEnv built in {benv_s:.2f} s (proxy PSNR of the 8-bit "
          f"policy {benv.psnr_org_proxy:.4f} dB); evaluate_population K="
          f"{POP_K}: {pop_s:.3f} s ({POP_K / pop_s:.1f} policies/s; its "
          f"simulator alone {sim_s * 1e3:.1f} ms), proxy PSNR "
          f"{ev.psnr.min():.3f}..{ev.psnr.max():.3f} dB; "
          f"hero_population_search {POP_ITERATIONS} x {POP_K}: "
          f"{psearch_s:.2f} s ({pres.policies_evaluated / psearch_s:.1f} "
          f"policies/s), best reward {pres.best_reward:+.4f}; one act() "
          f"{act:.3f} ms ({env.n_units} a walk)")
    search_card_vs_cpu(dev)
    print(f"search phase: {time.perf_counter() - t_phase:.2f} s")
    return launches, env, benv


# ---------------------------------------------------------------------------
# The pipeline: search -> compile -> serve through the public entry points.
# ---------------------------------------------------------------------------
# Depth cuts of the pipeline phase (PERF.md section 4): one scene, two
# budgets, 2 population iterations at the reference's K = 16 a cell.
PIPE_BUDGETS, PIPE_ITERATIONS, PIPE_K = (1.0, 0.85), 2, 16
# Kernels the compile's fused PSNR (the plan path) launches, and kernels
# the served compiled artifact's march tier launches; the rest are off
# those paths.
COMPILE_KERNELS = ("quant_matmul_packed", "hash_encode_corners",
                   "gather_composite")


def zeroed(kern):
    for fn in kern.values():
        fn.launches = 0


def read(kern):
    torch.cuda.synchronize()
    return {n: fn.launches for n, fn in kern.items()}


class CallTimer:
    """Adds up the CUDA-synchronised host seconds of calls to the named
    attributes of `owner` while in use."""

    def __init__(self, owner, *names):
        self.owner, self.names = owner, names
        self.s = {n: 0.0 for n in names}

    def __enter__(self):
        self.saved = {n: getattr(self.owner, n) for n in self.names}
        self.own = {n for n in self.names if n in vars(self.owner)}
        for n, fn in self.saved.items():
            def timed(*args, _n=n, _fn=fn, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*args, **kw)
                torch.cuda.synchronize()
                self.s[_n] += time.perf_counter() - t0
                return out
            setattr(self.owner, n, timed)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            if n in self.own:
                setattr(self.owner, n, fn)
            else:  # an instance's method: drop the wrapper
                delattr(self.owner, n)


def same_results(a, b) -> bool:
    """Equal joint and per-scene frontiers (objective sets and sizes) and
    equal best bits per cell."""
    return (a.frontier.objective_set() == b.frontier.objective_set()
            and len(a.frontier) == len(b.frontier)
            and set(a.scene_frontiers) == set(b.scene_frontiers)
            and all(a.scene_frontiers[s].objective_set()
                    == b.scene_frontiers[s].objective_set()
                    and len(a.scene_frontiers[s]) == len(b.scene_frontiers[s])
                    for s in a.scene_frontiers)
            and [c.best_bits for c in a.cells]
            == [c.best_bits for c in b.cells])


def pipeline_phase(env, benv, dev, kern):
    """HERO's main path through its public entry points, on the search
    phase's `paper()`-width env and batched env: the closed loop over two
    budgets (`HeroSearchRun`, launches counted), a stopped and resumed run
    equal to it, the best policy compiled (`hero.compile`, launches
    counted, `model_bytes` exact, PSNR within `PSNR_BAND_DB` of reference
    mode), saved, loaded and served (`hero.serve`, 8 fresh poses, launches
    counted, one request within 1e-5 of the CPU's), and the `--quick` CLI
    search. Returns the launches of the loop, the compile and the
    serving."""
    import repro_torch.hero as hero
    from repro_torch.core import search as search_mod
    from repro_torch.core.closed_loop import (
        ClosedLoopConfig,
        HeroSearchRun,
        bench_report,
        scene_bundle,
    )
    from repro_torch.core.ddpg import DDPGAgent
    from repro_torch.hero import artifact as artifact_mod
    from repro_torch.hero import cli
    from repro_torch.nerf import train as train_mod
    from repro_torch.quant.policy import QuantPolicy

    t_phase = time.perf_counter()
    bundle = scene_bundle(env, benv)
    cfg = ClosedLoopConfig(scenes=(bundle.scene,), budget_fracs=PIPE_BUDGETS,
                           n_iterations=PIPE_ITERATIONS, population=PIPE_K,
                           verbose=False)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        full_cfg = dataclasses.replace(cfg, checkpoint_path=str(tmp / "a.json"))
        zeroed(kern)
        with CallTimer(benv, "evaluate_population", "_mse_batch",
                       "simulate_batch") as pop_t, \
                CallTimer(env, "enforce_latency_target") as enf_t, \
                CallTimer(search_mod, "_agent_walk") as walk_t, \
                CallTimer(DDPGAgent, "update") as upd_t:
            t0 = time.perf_counter()
            result = HeroSearchRun(full_cfg, {bundle.scene: bundle},
                                   device=dev).run()
            loop_s = time.perf_counter() - t0
        loop = read(kern)
        report = bench_report(result, full_cfg)
        print(f"closed loop ({len(PIPE_BUDGETS)} budgets x "
              f"{PIPE_ITERATIONS} iterations x K={PIPE_K}): {loop_s:.2f} s, "
              f"{result.policies_evaluated} policies, "
              f"{result.policies_per_sec:.2f} policies/s of search "
              f"({result.search_seconds:.2f} s), frontier "
              f"{len(result.frontier)} points, hypervolume "
              f"{result.hypervolume():.6f}, seconds_to_fixed_bit "
              f"{result.seconds_to_fixed_bit}; launches {loop}")
        print(f"  where the loop's time went: evaluate_population "
              f"{pop_t.s['evaluate_population']:.3f} s (its proxy renders "
              f"{pop_t.s['_mse_batch']:.3f} s, its simulator "
              f"{pop_t.s['simulate_batch']:.3f} s), budget enforcement "
              f"{enf_t.s['enforce_latency_target']:.3f} s, actor walks "
              f"{walk_t.s['_agent_walk']:.3f} s, agent updates "
              f"{upd_t.s['update']:.3f} s")
        for c in result.cells:
            print(f"  cell {c.scene}@{c.budget_frac:g}: target "
                  f"{c.latency_target:.1f} cycles, best reward "
                  f"{c.best_reward:+.4f}, bits "
                  f"{''.join(map(str, c.best_bits))}, "
                  f"{c.admitted_to_frontier} admitted, "
                  f"{c.search_seconds:.2f} s")
        if not (report["frontier_valid_vs_8bit"] and len(result.cells) == 2
                and result.policies_evaluated == 2 * PIPE_ITERATIONS * PIPE_K):
            raise AssertionError(f"closed loop: {report}")

        part_cfg = dataclasses.replace(cfg, checkpoint_path=str(tmp / "b.json"))
        HeroSearchRun(part_cfg, {bundle.scene: bundle}, device=dev).run(
            stop_after_cells=1)
        out = {}
        profile("the resumed run: one closed-loop cell (2 iterations x "
                f"K={PIPE_K})", lambda: out.setdefault(
                    "res", HeroSearchRun(part_cfg, {bundle.scene: bundle},
                                         device=dev).run()))
        resumed = out["res"]
        if resumed.resumed_cells != 1 or not same_results(resumed, result):
            raise AssertionError("the resumed closed loop differs from the "
                                 "uninterrupted one")
        print(f"stopped after 1 cell and resumed: equal to the uninterrupted "
              f"run (frontier {len(resumed.frontier)} points, cells' bits "
              f"equal)")

        scene, bits = hero.best_bits(result)
        zeroed(kern)
        with CallTimer(train_mod, "finetune_ngp") as ft_t, \
                CallTimer(artifact_mod, "build_fused_pack") as pack_t, \
                CallTimer(env, "eval_psnr", "simulate_policy") as env_t:
            t0 = time.perf_counter()
            art = hero.compile(bundle, bits)
            compile_s = time.perf_counter() - t0
        comp = read(kern)
        print(f"compile of {scene}'s best policy "
              f"{''.join(map(str, bits))}: {compile_s:.2f} s (finetune "
              f"{ft_t.s['finetune_ngp']:.2f} s, fused PSNR "
              f"{env_t.s['eval_psnr']:.3f} s, pack build "
              f"{pack_t.s['build_fused_pack']:.3f} s, simulation "
              f"{env_t.s['simulate_policy'] * 1e3:.2f} ms); metrics "
              f"{art.metrics}; launches {comp}")
        if min(comp[k] for k in COMPILE_KERNELS) <= 0 or any(
                comp[k] for k in SEARCH_OFF_PATH):
            raise AssertionError(f"the compile did not launch each of "
                                 f"{COMPILE_KERNELS}, or launched one of "
                                 f"{SEARCH_OFF_PATH}: {comp}")
        policy = QuantPolicy.uniform(env.units, 8).with_bits(bits)
        sim_bytes = env.simulate_policy(policy).model_bytes
        batch_bytes = float(benv.simulate_batch(np.asarray([bits]))[
            "model_bytes"][0])
        if not (art.metrics["model_bytes"] == sim_bytes == batch_bytes
                == art.stored_model_bytes()):
            raise AssertionError(f"model_bytes: artifact "
                                 f"{art.metrics['model_bytes']}, simulator "
                                 f"{sim_bytes}, batched {batch_bytes}")
        ref = train_mod.evaluate_psnr(art.params, env.dataset, env.cfg,
                                      env.rcfg, art.spec(), device=dev)
        print(f"compiled artifact: model_bytes {art.metrics['model_bytes']:.0f}"
              f" (the simulator's, exactly), PSNR {art.metrics['psnr']:.4f} "
              f"dB against reference mode {ref:.4f} dB")
        if not abs(art.metrics["psnr"] - ref) < PSNR_BAND_DB:
            raise AssertionError(f"the compiled PSNR is not within "
                                 f"{PSNR_BAND_DB} dB of reference mode")

        art.save(tmp / "art")
        loaded = hero.QuantArtifact.load(tmp / "art", device=dev)
        svc = hero.serve(loaded, device=dev)
        requests = request_rays(8, 64, held_out=True)
        zeroed(kern)
        t0 = time.perf_counter()
        colors = answer(svc, requests)
        serve_s = time.perf_counter() - t0
        served = read(kern)
        stats = svc.stats()
        pc = stats["pose_cache"]
        slots = pc["misses"] + stats["budget_retraces"]
        print(f"served the compiled artifact: 8 requests in {serve_s:.3f} s "
              f"({stats['requests_per_sec']} req/s), pose cache {pc}; "
              f"launches {served}")
        want = {n: 0 for n in kern}
        want.update(quant_matmul_packed=5 * slots, hash_encode=slots,
                    ray_march=slots, gather_composite=slots)
        if served != want or pc["builds"] or pc["hits"] or pc["warps"]:
            raise AssertionError(f"serving the compiled artifact launched "
                                 f"{served}, want {want}; pose cache {pc}")
        for (ro, _), c in zip(requests, colors):
            if c.shape != (ro.shape[0], 3) or not np.isfinite(c).all():
                raise AssertionError(f"bad result: shape {c.shape}")
        cpu_svc, _ = serve(tmp / "art", "cpu")
        diff = float(np.abs(answer(cpu_svc, requests[:1])[0]
                            - colors[0]).max())
        print(f"compiled artifact, card vs CPU plain versions, one request: "
              f"max |diff| {diff:.3g}")
        if not diff <= 1e-5:
            raise AssertionError(f"served colours differ from the CPU by "
                                 f"{diff}")
        del svc, cpu_svc, loaded, art

        t0 = time.perf_counter()
        rc = cli.main(["search", "--quick", "--scenes", "chair", "--budgets",
                       "1.0", "--iterations", "1", "--population", "8",
                       "--device", "cuda", "--checkpoint", "", "--out",
                       str(tmp / "search.json")])
        cli_s = time.perf_counter() - t0
        cli_report = json.loads((tmp / "search.json").read_text())
        print(f"hero-search-torch --quick: rc {rc} in {cli_s:.2f} s, "
              f"frontier {cli_report['frontier_size']} points, "
              f"{cli_report['policies_per_sec']} policies/s")
        if rc != 0 or not cli_report["frontier_size"]:
            raise AssertionError(f"the CLI search failed: rc {rc}")
    print(f"pipeline phase: {time.perf_counter() - t_phase:.2f} s")
    return ({"closed_loop": loop, "compile": comp, "pipeline_serve": served},
            {"result": result, "seconds": loop_s, "launches": loop})


# ---------------------------------------------------------------------------
# The distributed search: the orchestrator and the population split.
# ---------------------------------------------------------------------------
def distributed_phase(env, benv, dev, kern, seq):
    """The distributed HERO search on the pipeline phase's `paper()`-width
    bundle, each step held to the pipeline's sequential closed loop `seq`
    (its result, seconds and launches): `run_orchestrated` over two thread
    workers (launches counted: the main path of this phase), one inline
    worker, the seeded chaos drill with a checkpoint, the population split
    over the visible cards (`sharded=True`), and one `SubprocessWorker`
    cell of a quick-scale config pinned to card 0. Returns the
    thread pool's launches."""
    import repro_torch.distributed.orchestrator as orch_mod
    from repro_torch.core.batched_env import BatchedQuantEnv
    from repro_torch.core.closed_loop import (
        ClosedLoopConfig,
        HeroSearchRun,
        SceneScale,
        scene_bundle,
    )
    from repro_torch.distributed.chaos import FaultPlan
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    bundle = scene_bundle(env, benv)
    bundles = {bundle.scene: bundle}
    cfg = ClosedLoopConfig(scenes=(bundle.scene,), budget_fracs=PIPE_BUDGETS,
                           n_iterations=PIPE_ITERATIONS, population=PIPE_K,
                           verbose=False)
    want, seq_res = seq["launches"], seq["result"]

    zeroed(kern)
    t0 = time.perf_counter()
    pool = orch_mod.run_orchestrated(HeroSearchRun(cfg, bundles, device=dev),
                                     workers=2, worker_kind="thread")
    pool_s = time.perf_counter() - t0
    launches = read(kern)
    n = pool.policies_evaluated
    print(f"run_orchestrated, 2 thread workers on one card: {pool_s:.2f} s, "
          f"{n / pool_s:.2f} policies/s of wall time "
          f"({pool.policies_per_sec:.2f} of the cells' summed search "
          f"seconds); the sequential loop {seq['seconds']:.2f} s, "
          f"{seq_res.policies_evaluated / seq['seconds']:.2f} policies/s "
          f"({seq_res.policies_per_sec:.2f}); launches {launches}")
    if not same_results(pool, seq_res) or n != seq_res.policies_evaluated:
        raise AssertionError("the thread pool's result differs from the "
                             "sequential closed loop")
    if launches != want:
        raise AssertionError(f"the thread pool launched {launches}, the "
                             f"sequential loop {want}")

    program = orch_mod.SearchCellProgram(HeroSearchRun(cfg, bundles,
                                                       device=dev))
    orch = orch_mod.ElasticOrchestrator(
        program, orch_mod.OrchestratorConfig(workers=1, worker_kind="inline"))
    t0 = time.perf_counter()
    inline = orch.run()
    inline_s = time.perf_counter() - t0
    done = [e[1] for e in orch.events if e[0] == "done"]
    canonical = [s.name for s in program.cell_specs()]
    print(f"one inline worker: {inline_s:.2f} s, equal to the sequential "
          f"loop {same_results(inline, seq_res)}, cells done in {done}")
    if not same_results(inline, seq_res) or done != canonical:
        raise AssertionError(f"one inline worker differs from the "
                             f"sequential loop, or ran {done} out of "
                             f"{canonical}")

    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "chaos.json")
        run = HeroSearchRun(dataclasses.replace(cfg, checkpoint_path=ck),
                            bundles, device=dev)
        # What `run_orchestrated(run, workers=2, chaos_seed=3)` builds,
        # kept at hand for its event trail.
        plan = FaultPlan.seeded(3, [s.name for s in run.cell_specs()])
        drill = orch_mod.ElasticOrchestrator(
            orch_mod.SearchCellProgram(run),
            orch_mod.OrchestratorConfig(workers=2, worker_kind="thread"),
            chaos=plan)
        t0 = time.perf_counter()
        chaos_res = drill.run()
        chaos_s = time.perf_counter() - t0
        completed = json.loads(Path(ck).read_text())["completed"]
    faults = [(f.kind, f.cell) for f in plan.injected]
    trail = [e for e in drill.events
             if e[0] in ("crash", "error", "evict", "retry", "rescale")]
    print(f"chaos drill (seed 3, 2 thread workers): injected {faults}; "
          f"{trail}; {chaos_s:.2f} s; checkpoint holds {completed}")
    if not (faults and trail and same_results(chaos_res, seq_res)
            and sorted(completed) == sorted(canonical)):
        raise AssertionError("the chaos drill did not inject and recover, "
                             "or its result differs from the sequential "
                             "loop")

    split = BatchedQuantEnv(env, benv.bcfg, sharded=True, device=dev)
    bits = np.random.RandomState(21).randint(
        env.ecfg.b_min, env.ecfg.b_max + 1, size=(PIPE_K, env.n_units))
    t0 = time.perf_counter()
    got = split.evaluate_population(bits)
    split_s = time.perf_counter() - t0
    plain = benv.evaluate_population(bits)
    same = {k: bool(np.array_equal(getattr(got, k), getattr(plain, k)))
            for k in ("psnr", "latency_cycles", "model_bytes", "reward")}
    fused, memo = split.simulate_batch(bits), benv.simulate_batch(bits)
    sims_equal = fused.keys() == memo.keys() and all(
        np.array_equal(fused[k], memo[k]) for k in memo)
    print(f"sharded=True on {torch.cuda.device_count()} card(s): n_shards "
          f"{split.n_shards}, evaluate_population of {PIPE_K} policies "
          f"{split_s:.2f} s, equal to the plain env {same}; simulate_batch "
          f"through policy_latency equal to the memoized path {sims_equal}")
    if (split.n_shards != torch.cuda.device_count() or not all(same.values())
            or not sims_equal):
        raise AssertionError("the split population differs from the plain "
                             "env")
    del split

    libs = sorted(p.name for p in build.build_dir().glob("*.so"))
    quick = ClosedLoopConfig(scenes=("chair",), budget_fracs=(1.0,),
                             scale=SceneScale.quick(), n_iterations=1,
                             population=8, verbose=False)
    qprog = orch_mod.SearchCellProgram(HeroSearchRun(quick, device=dev))
    spec = qprog.cell_specs()[0]
    worker = orch_mod.SubprocessWorker(qprog.job_payload, name="proc-0",
                                       device=dev, index=0)
    t0 = time.perf_counter()
    worker.start(spec, 0)
    try:
        worker._proc.wait(timeout=300)
        ev = worker.poll()
    finally:
        worker.close()
    sub_s = time.perf_counter() - t0
    if ev is None or ev[0] != "done" or ev[3].policies_evaluated != 8:
        raise AssertionError(f"the subprocess worker failed: {ev}")
    out = ev[3]
    t0 = time.perf_counter()
    inline_out = qprog.run_cell(spec)
    here_s = time.perf_counter() - t0
    timeless = lambda o: [dict(p, t_emit=None) for p in o.points]
    print(f"SubprocessWorker on card {worker.card} (CUDA_VISIBLE_DEVICES): "
          f"cell {out.cell}, {out.policies_evaluated} policies, "
          f"{sub_s:.2f} s with its start-up and training (inline, with "
          f"its training: {here_s:.2f} s); points equal to the same "
          f"cell inline: {timeless(out) == timeless(inline_out)}, best bits "
          f"equal: {out.best_bits == inline_out.best_bits}")
    if sorted(p.name for p in build.build_dir().glob("*.so")) != libs:
        raise AssertionError("the subprocess worker built another kernel "
                             "library")
    print(f"distributed phase: {time.perf_counter() - t_phase:.2f} s")
    return launches


def request_rays(n_requests: int, hw: int, held_out: bool = False):
    """(rays_o, rays_d) numpy pairs: hw x hw camera rays of successive
    scene poses (the held-out ring, a different set of poses, with
    `held_out`)."""
    from repro_torch.nerf.scenes import SceneConfig, camera_poses, camera_rays

    sc = SceneConfig(image_hw=hw, n_train_views=n_requests,
                     n_test_views=n_requests)
    poses = camera_poses(sc)[1 if held_out else 0]
    return [tuple(a.numpy() for a in camera_rays(c2w, hw, sc.focal_mult * hw))
            for c2w in poses]


def serve(path, device, serve_cfg=None):
    """Load the artifact at `path` onto `device` and stand up a warmed-up
    `RenderService` for it. Returns (service, artifact)."""
    from repro_torch.hero.artifact import QuantArtifact
    from repro_torch.hero.service import RenderService, ServeConfig

    art = QuantArtifact.load(path, layout="tile:128", device=device)
    svc = RenderService(art, serve_cfg or ServeConfig(), device=device)
    svc.warmup()
    return svc, art


def answer(svc, requests):
    """Submit every (rays_o, rays_d) request, drain, return the colours."""
    rids = [svc.submit(ro, rd) for ro, rd in requests]
    svc.drain()
    return [svc.result(r) for r in rids]


def profile(label: str, fn) -> None:
    """Run `fn` once under `torch.profiler` and print where its time went:
    wall time, device kernel time (busy share), launches, and the kernels
    that took the most device time. Ranges that a `record_function`
    annotates on the device's timeline (NCCL's `nccl:*`) span kernels or
    copies that are counted already: they are returned apart, {name:
    (count, ms)} under "annotations", and add nothing to the device
    time. Under "ranges", {name: (calls, ms)} of each `record_function`
    range on the host: the device time of the kernels its calls ran."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device
               if not getattr(e, "is_user_annotation", False)]
    annotations = {}
    for e in device:
        if getattr(e, "is_user_annotation", False):
            n, t = annotations.get(e.name, (0, 0.0))
            annotations[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3  # ms
    ranges = {}  # a `record_function` range's calls: the kernels they ran
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU \
                and getattr(e, "is_user_annotation", False):
            n, t = ranges.get(e.name, (0, 0.0))
            ranges[e.name] = (n + 1, t + e.device_time_total / 1e3)
    print(f"profiled {label}: wall {wall * 1e3:.2f} ms, device kernel time "
          f"{busy:.2f} ms ({100.0 * busy / (wall * 1e3):.1f} % busy), "
          f"{len(kernels)} device events (kernel launches and copies)")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  {t:8.3f} ms {n:5d}x {name[:90]}")
    order = [e.name for e in sorted(kernels,
                                     key=lambda e: e.time_range.start)]
    return busy, by_name, {"events": len(kernels), "device_ms": busy,
                           "wall_ms": wall * 1e3, "order": order,
                           "annotations": annotations, "ranges": ranges}


NERF_KERNELS = ("quant_matmul_packed", "hash_encode", "gather_composite",
                "ray_march")
LM_KERNELS = ("flash_attention", "decode_attention")


def counters():
    from repro_torch.kernels.alpha_composite import alpha_composite_cuda
    from repro_torch.kernels.decode_attention_kernel import (
        decode_attention_cuda,
    )
    from repro_torch.kernels.flash_attention_kernel import (
        flash_attention_bwd_cuda,
        flash_attention_cuda,
    )
    from repro_torch.kernels.gather_composite import gather_composite_cuda
    from repro_torch.kernels.hash_encode import (
        hash_encode_corners_cuda,
        hash_encode_points_cuda,
    )
    from repro_torch.kernels.hash_encoding_kernel import hash_gather_cuda
    from repro_torch.kernels.quant_matmul import (
        quant_matmul_cuda,
        quant_matmul_packed_cuda,
    )
    from repro_torch.kernels.ray_march import ray_march_cuda

    return {"quant_matmul_packed": quant_matmul_packed_cuda,
            "hash_gather": hash_gather_cuda,
            "hash_encode_corners": hash_encode_corners_cuda,
            "hash_encode": hash_encode_points_cuda,
            "alpha_composite": alpha_composite_cuda,
            "gather_composite": gather_composite_cuda,
            "ray_march": ray_march_cuda,
            "quant_matmul": quant_matmul_cuda,
            "flash_attention": flash_attention_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda,
            "decode_attention": decode_attention_cuda}


def jittered(ro, rd, key, pos_cell: float, dir_cell: float):
    """The first of the origins shifted by +-1e-4 or +-5e-5 that keeps the
    request in pose cell `key` (a pose component can sit on a cell
    boundary), or None."""
    from repro_torch.nerf.pose_cache import pose_cell_key

    for eps in (1e-4, -1e-4, 5e-5, -5e-5):
        ro_j = ro + np.float32(eps)
        if pose_cell_key(ro_j, rd, pos_cell, dir_cell) == key:
            return ro_j
    return None


def revisit_stream(path, dev, kern):
    """The pose-cache tiers at `paper()` width: two held-out poses of 64x64
    rays, each visited three times in turn (miss; miss and build; hit),
    then each with its origin jittered inside its pose cell (warp). Every
    kernel's count is zeroed just before and read just after. Hits, warps
    and misses must each be > 0, and each hit and warp request's colours
    equal, bit for bit, the same rays served on the card without the pose
    cache. Then one hit and one warp request are profiled."""
    from repro_torch.hero.engine import ServeEngine
    from repro_torch.hero.service import ServeConfig
    from repro_torch.nerf.pose_cache import pose_cell_key

    svc, art = serve(path, dev)
    cfg = svc.engine.cfg
    plain = ServeEngine({art.scene: art},
                        ServeConfig().engine_config(pose_cache=False),
                        device=dev)
    plain.warmup()
    poses = request_rays(3, 64, held_out=True)[1:]
    for fn in kern.values():
        fn.launches = 0
    tiers, served = [], []

    def visit(ro, rd):
        before = dict(svc.stats()["pose_cache"])
        out = answer(svc, [(ro, rd)])[0]
        after = svc.stats()["pose_cache"]
        tier = max(("hits", "warps", "misses"),
                   key=lambda k: after[k] - before[k])
        tiers.append(tier)
        served.append((tier, ro, rd, out))

    for _ in range(3):
        for ro, rd in poses:
            visit(ro, rd)
    warped = []
    for ro, rd in poses:
        key = pose_cell_key(ro, rd, cfg.pose_pos_cell, cfg.pose_dir_cell)
        ro_j = jittered(ro, rd, key, cfg.pose_pos_cell, cfg.pose_dir_cell)
        if ro_j is not None:
            visit(ro_j, rd)
            warped.append((ro_j, rd))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kern.items()}
    st = svc.stats()
    pc = st["pose_cache"]
    print(f"revisit stream: {len(tiers)} requests, tiers {tiers}; pose cache "
          f"{pc}; launches {launches}")
    sg = st["slot_graphs"]
    print(f"  plan bytes {pc['bytes']}, slot graphs {sg}, resident_bytes "
          f"{st['cache']['resident_bytes']} (the artifact "
          f"{art.resident_bytes()} + the plans + the graphs' pool)")
    if not (pc["hits"] > 0 and pc["warps"] > 0 and pc["misses"] > 0):
        raise AssertionError(f"a pose-cache tier never served: {pc}")
    if st["cache"]["resident_bytes"] != (art.resident_bytes() + pc["bytes"]
                                         + sg["bytes"]):
        raise AssertionError("plan and slot graph bytes are not charged to "
                             "resident_bytes")
    if not (sg["captures"] > 0 and sg["replays"] > 0):
        raise AssertionError(f"the march slots were not replayed: {sg}")
    slots = pc["hits"] + pc["warps"] + pc["misses"]
    grown = st["budget_retraces"]  # a march slot rendered again, grown
    want = {"gather_composite": slots + grown, "hash_gather": 0,
            "hash_encode_corners": pc["hits"],
            "hash_encode": pc["warps"] + pc["misses"] + grown,
            "ray_march": pc["warps"] + pc["misses"] + grown,
            "quant_matmul_packed": 5 * (slots + grown), "alpha_composite": 0}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"revisit stream: {name} launched "
                                 f"{launches[name]} times, want {n}")
    n_same = 0
    for tier, ro, rd, out in served:
        if tier in ("hits", "warps"):
            ref = plain.render(ro, rd)
            if not np.array_equal(out, ref):
                raise AssertionError(
                    f"a {tier[:-1]} request differs from the same rays "
                    f"without the pose cache by "
                    f"{float(np.abs(out - ref).max())}")
            n_same += 1
    print(f"  {n_same} hit and warp requests equal, bit for bit, the same "
          f"rays served on the card without the pose cache")
    hit = profile("hit request (plan tier, 8 slots)",
                  lambda: answer(svc, [poses[0]]))
    warp = profile("warp request (warp tier, 8 slots)",
                   lambda: answer(svc, [warped[0]]))
    if svc.stats()["pose_cache"]["hits"] != pc["hits"] + 8 or \
            svc.stats()["pose_cache"]["warps"] != pc["warps"] + 8:
        raise AssertionError("the profiled requests missed their tiers")
    return launches, {"hit": hit[2], "warp": warp[2]}


# ---------------------------------------------------------------------------
# The LM serve path.
# ---------------------------------------------------------------------------
def lm_serve(dev, kern):
    """qwen2-7b at full width through `repro_torch.launch.serve`: random
    weights from a seed on the card, 8 requests of 1024 prompt tokens and
    32 generated tokens, 4 at a time. Every kernel's count is zeroed just
    before and read just after; attention must have gone through the
    kernels once per layer per prefill and per decode step."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as lm_serve_mod

    model = get_arch("qwen2-7b").model
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in kern.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = lm_serve_mod.main([
        "--arch", "qwen2-7b", "--batch", str(LM_BATCH), "--prompt-len",
        str(LM_PROMPT), "--gen", str(LM_GEN), "--requests", str(LM_REQUESTS)])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kern.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"flash_attention": model.n_layers * stats.prefills,
            "decode_attention": model.n_layers * stats.decode_steps}
    print(f"LM serve: {stats.requests} requests, {stats.tokens} tokens in "
          f"{stats.wall_s:.3f} s: {stats.tokens_per_s:.1f} tokens/s "
          f"(init and serve {total_s:.1f} s)")
    print(f"  prefill ms per batch of {LM_BATCH} x {LM_PROMPT}: "
          f"{[round(t, 2) for t in stats.prefill_ms]}")
    print(f"  decode ms per step (batch {LM_BATCH}): "
          f"{[round(t, 3) for t in stats.decode_ms_per_step]}")
    print(f"  max_memory_allocated {peak / 2**30:.2f} GiB; launches {launches}"
          f" (want {want}: {model.n_layers} per prefill and per decode step)")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name}: {launches[name]} launches, want {n}")
    for s in stats.samples:
        if s.shape != (LM_BATCH, LM_GEN):
            raise AssertionError(f"bad LM result shape {s.shape}")
    return launches


def lm_profile(dev, steps: int = 4) -> None:
    """Where one prefill and `steps` decode steps of the LM path spend
    their time: the same model and traffic as `lm_serve`, each window run
    once under the profiler after a warm-up."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch.serve import greedy
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import lm

    model = get_arch("qwen2-7b").model
    params = lm.init_params(model, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    prompts = torch.from_numpy(TokenPipeline(TokenPipelineConfig(
        vocab_size=model.vocab_size, seq_len=LM_PROMPT,
        global_batch=LM_BATCH)).batch()).to(dev)
    prefill_fn = make_prefill_step(model, LM_SMAX)
    decode_fn = make_decode_step(model)
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill_fn(params,
                                                     {"tokens": prompts})

    def run_decode():
        for i in range(steps):
            tok = greedy(state["logits"])[:, None]
            state["logits"], state["cache"] = decode_fn(
                params, state["cache"], tok, LM_PROMPT + i)

    with torch.inference_mode():
        run_prefill()
        run_decode()
        busy, by_name, _ = profile(
            f"LM prefill ({LM_BATCH} x {LM_PROMPT})", run_prefill)
        n, t = by_name_sum(by_name, "flash_")
        print(f"  flash attention in prefill: {t:.3f} ms over {n} launches, "
              f"{100.0 * t / busy:.1f} % of its device time")
        busy, by_name, _ = profile(f"LM decode ({steps} steps, batch "
                                   f"{LM_BATCH})", run_decode)
        n, t = by_name_sum(by_name, "decode_kernel")
        print(f"  decode attention in {steps} steps: {t:.3f} ms over {n} "
              f"launches, {100.0 * t / busy:.1f} % of their device time")


def by_name_sum(by_name, *parts: str):
    """(launches, ms) of the profiled kernels whose name holds one of
    `parts`."""
    hits = [v for name, v in by_name.items()
            if any(part in name for part in parts)]
    return sum(n for n, _ in hits), sum(t for _, t in hits)


# The profiled name of each route's kernel in csrc/flash_attention.cu
# (`flash_route`), and all of them: kernel 6's forward launches.
FLASH_ROUTE_KERNELS = {"tc64": "flash_tcp_kernel<64>",
                       "tc128": "flash_tc_kernel", "f32": "flash_f32_kernel"}
FLASH_FORWARD = tuple(FLASH_ROUTE_KERNELS.values())


# Empty spin kernels launched before and after a profiled call: at least
# EDGE_PAD of them and EDGE_PAD_S seconds of host time a side.
EDGE_PAD, EDGE_PAD_S = 256, 5e-3


def spin_pad() -> int:
    """One pad of empty spin kernels (`torch.cuda._sleep`): EDGE_PAD
    launches, and more while EDGE_PAD_S seconds have not passed, so that
    a slower host sends more. Returns how many."""
    t0, n = time.perf_counter(), 0
    while n < EDGE_PAD or time.perf_counter() - t0 < EDGE_PAD_S:
        torch.cuda._sleep(1)
        n += 1
    return n


def kernels_run(fn, tries: int = 3) -> list:
    """The names of the device kernels that `fn` launches, from one call
    under the profiler between two spin pads. Late in a full run the
    profiler drops a window's first events (`edge_padded_profile`); a
    window that kept no pad before the call or none after it is printed
    and profiled again, `tries` times in all."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            sent = spin_pad()
            fn()
            sent += spin_pad()
            torch.cuda.synchronize()
        names = [e.name for e in sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        own = [i for i, n in enumerate(names) if "spin_kernel" not in n]
        if own and 0 < own[0] and own[-1] < len(names) - 1:
            return [names[i] for i in own]
        print(f"  a profiled call kept {len(names) - len(own)} of {sent} "
              f"spin kernels and {len(own)} kernels of its own, at "
              f"{own[:1]}..{own[-1:]} of {len(names)}: profiled again")
    raise AssertionError(f"{tries} profiles of a call each lost a pad or "
                         "the call's kernels")


def flash_kernel_route(fn) -> str:
    """The route of kernel 6's forward that `fn` (one call) launched, by
    the profiled kernel's name."""
    names = [n for n in kernels_run(fn) if any(k in n for k in FLASH_FORWARD)]
    routes = [r for r, k in FLASH_ROUTE_KERNELS.items() if k in names[-1]] \
        if len(names) == 1 else []
    if len(routes) != 1:
        raise AssertionError(f"one call of kernel 6 launched {names}")
    return routes[0]


def decode_kernel_route(fn) -> str:
    """The route of kernel 7 that `fn` (one call) launched: "one-pass" or
    "split", by the template flag of the profiled `decode_kernel`."""
    import re

    names = [n for n in kernels_run(fn) if "decode_kernel" in n]
    m = re.search(r"decode_kernel<[^()]*, (true|false)>", names[0]) \
        if len(names) == 1 else None
    if not m:
        raise AssertionError(f"one call of kernel 7 launched {names}")
    return "one-pass" if m.group(1) == "true" else "split"


def to_device(tree, dev):
    """The same nested dicts and lists of tensors, on `dev`."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def lm_card_vs_cpu(dev, tol: float = 1e-3):
    """qwen2-7b's widths at 2 layers in float32 on the card and on the CPU
    (the plain versions), same weights, same 64-token prompts of batch 2,
    then 8 decode steps fed the card's greedy tokens on both sides. The
    card's float32 matmuls are full float32 (TF32 off), so the two differ
    only by summation order: ~1e-5 on logits of order 1, and `tol` = 1e-3
    leaves a hundredfold margin while any kernel fault shows at 1e-2 or
    more."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch.serve import greedy
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_arch("qwen2-7b").model, n_layers=2,
                              dtype="float32")
    cpu = torch.device("cpu")
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), device=cpu)
    p_dev = to_device(p_cpu, dev)
    prompt_len, steps = 64, 8
    prompts = torch.from_numpy(TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=prompt_len,
        global_batch=2)).batch()).long()
    worst, agree, total = 0.0, 0, 0
    with torch.inference_mode():
        l_dev, c_dev = lm.prefill(p_dev, {"tokens": prompts.to(dev)}, cfg,
                                  prompt_len + steps)
        l_cpu, c_cpu = lm.prefill(p_cpu, {"tokens": prompts}, cfg,
                                  prompt_len + steps)
        for i in range(steps + 1):
            worst = max(worst, (l_dev.cpu() - l_cpu).abs().max().item())
            tok_dev, tok_cpu = greedy(l_dev), greedy(l_cpu)
            agree += int((tok_dev.cpu() == tok_cpu).sum())
            total += tok_cpu.numel()
            if i == steps:
                break
            tok = tok_dev[:, None]
            l_dev, c_dev = lm.decode_step(p_dev, c_dev, tok, prompt_len + i,
                                          cfg)
            l_cpu, c_cpu = lm.decode_step(p_cpu, c_cpu, tok.cpu(),
                                          prompt_len + i, cfg)
        cache_err = max((c_dev["pos0"][n].cpu() - c_cpu["pos0"][n]).abs()
                        .max().item() for n in ("k", "v"))
    print(f"LM card vs CPU (qwen2-7b widths, 2 layers, float32, prompt "
          f"{prompt_len} x 2, {steps} decode steps): logits max |diff| "
          f"{worst:.3g} (tolerance {tol}), cache max |diff| {cache_err:.3g}, "
          f"greedy tokens agree {agree}/{total}")
    if not (worst <= tol and cache_err <= tol):
        raise AssertionError(f"LM card vs CPU: logits {worst}, cache "
                             f"{cache_err} > {tol}")


# ---------------------------------------------------------------------------
# Phase 11: the LM quantization search.
# ---------------------------------------------------------------------------
LM_ARCH = "qwen2-7b"
LM_POP_K = 16  # policies of the card-vs-CPU population
LM_BUDGETS = (1.0, 0.85)  # lm_quant_search's defaults: 2 iterations at K = 8
LM_ITERATIONS, LM_K = 2, 8
LM_FULL_BATCH, LM_FULL_SEQ = 4, 1024  # full-width loss_fn tokens
COPY_BYTES = 4 << 30  # the card's stream rate: a 4 GiB device copy


def lm_flash_shapes(dev, entry):
    """Flash attention at the LM search's shapes before the search runs
    them: the smoke configs' float32 route (B 4, Hkv 2, S 64, G 2, hd 16,
    causal) within 1e-4 of its plain version, timed beside it and SDPA
    (kept in `entry` under `*_lm_smoke`); and qwen3-moe's bf16 geometry
    (Hkv 4, G 16, hd 64, S 1024) within `BF16_ATTN_LIMIT`."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention_kernel import (
        flash_attention_cuda as kernel,
        flash_attention_plain as plain,
    )

    gen = torch.Generator(device=dev).manual_seed(22)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype, (B, Hkv, S, G, hd), tol in (
            (torch.float32, (4, 2, 64, 2, 16), 1e-4),
            (torch.bfloat16, (4, 4, 1024, 16, 64), BF16_ATTN_LIMIT)):
        q = torch.randn((B, S, Hkv * G, hd), generator=gen, device=dev) \
            .to(dtype)
        k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
        q5 = q.view(B, S, Hkv, G, hd).permute(0, 2, 1, 3, 4)
        k4, v4 = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        err = (kernel(q5, k4, v4, True) - plain(q5, k4, v4, True)).abs() \
            .max().item()
        print(f"flash_attention {dtype} (B {B}, Hkv {Hkv}, S {S}, G {G}, hd "
              f"{hd}) causal: max |diff| {err:.3g} (tolerance {tol})")
        if not err <= tol:
            raise AssertionError(f"flash_attention at the LM search's shapes:"
                                 f" {err} > {tol}")
        if dtype != torch.float32:
            continue
        qs = q.transpose(1, 2)
        t_k = median_ms(lambda: kernel(q5, k4, v4, True))
        t_p = median_ms(lambda: plain(q5, k4, v4, True))
        t_l = median_ms(lambda: sdpa(qs, k4, v4, is_causal=True,
                                     enable_gqa=True))
        bnd = bound(cost.flash_attention(B, Hkv, G, hd, S, S, True, 4))
        print(f"  float32 at the smoke shapes: kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, SDPA {t_l:.4f} ms, bound {bnd[0]:.6f} ms "
              f"({bnd[1]})")
        entry.update(max_abs_err_lm_smoke=err, ms_lm_smoke=t_k,
                     plain_ms_lm_smoke=t_p, library_ms_lm_smoke=t_l,
                     bound_ms_lm_smoke=bnd[0])


class ForwardCounter:
    """Counts `repro_torch.models.lm.forward` calls while in use (each
    `loss_fn` makes one)."""

    def __enter__(self):
        from repro_torch.models import lm

        self.mod, self.inner, self.n = lm, lm.forward, 0

        def counted(*a, **kw):
            self.n += 1
            return self.inner(*a, **kw)
        lm.forward = counted
        return self

    def __exit__(self, *exc):
        self.mod.forward = self.inner


def lm_population_card_vs_cpu(dev, kern, loss_rel: float = 1e-6):
    """The LM workload's bundle for qwen2-7b built on the card, and the
    same weights' bundle on the CPU; 16 policies from a fixed numpy seed
    (the all-8-bit and all-b_min extremes first) scored by both, flash
    attention launched once per layer per forward. The proxy losses and
    the full-precision base losses agree within `loss_rel` (a few float32
    ulps: the card's products sum in another order); latency and
    model_bytes within 1e-6 relative. Quality is the loss mapped to dB,
    and the mapping's slope near its floor is 10 / ln 10 / (2 *
    LOSS_FLOOR) ~ 2.2e4 dB per unit of loss, so one ulp of a loss of ~7
    (4.8e-7) moves it by up to 0.01 dB: quality and reward are held to
    the bound the loss tolerance implies, policy by policy, and their
    largest differences printed. Returns the card's bundle."""
    from repro_torch.workloads.lm import (
        LOSS_FLOOR,
        LMBatchedEnv,
        LMQuantEnv,
        LMWorkload,
        lm_bundle,
    )

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = LMWorkload().build_bundle(LM_ARCH, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    env = bundle.env
    cpu = torch.device("cpu")
    cpu_env = LMQuantEnv(LM_ARCH, env.ecfg, device=cpu,
                         params=to_device(env.params, cpu))
    cpu_bundle = lm_bundle(cpu_env, LMBatchedEnv(cpu_env))
    print(f"LM workload ({LM_ARCH} smoke, {env.n_units} units): bundle "
          f"built on the card in {build_s:.3f} s; psnr_org "
          f"{env.psnr_org!r} dB (CPU {cpu_env.psnr_org!r}), original_cost "
          f"{env.original_cost!r} s/token (CPU {cpu_env.original_cost!r}), "
          f"target {env.target.describe()}")
    rng = np.random.default_rng(11)
    b_min, b_max = env.ecfg.b_min, env.ecfg.b_max
    bits = rng.integers(b_min, b_max + 1, (LM_POP_K, env.n_units))
    bits[0], bits[1] = b_max, b_min
    zeroed(kern)
    with ForwardCounter() as fwd:
        t0 = time.perf_counter()
        ev = bundle.benv.evaluate_population(bits)
        torch.cuda.synchronize()
        pop_s = time.perf_counter() - t0
    launches = read(kern)
    ref = cpu_bundle.benv.evaluate_population(bits)
    loss = bundle.benv.proxy_losses(env.params, bits).astype(np.float64)
    loss_cpu = cpu_bundle.benv.proxy_losses(cpu_env.params, bits) \
        .astype(np.float64)
    base, base_cpu = env.base_loss_proxy, cpu_env.base_loss_proxy
    d_loss = max(float(np.abs(loss / loss_cpu - 1).max()),
                 abs(base / base_cpu - 1))
    # |d quality| <= slope * |d excess|, the slope taken at the smaller
    # of the two excesses (the mapping is convex), |d excess| bounded by
    # the loss tolerance on both losses.
    d_excess = loss_rel * (loss_cpu + base_cpu)
    excess = np.maximum(np.minimum(loss - base, loss_cpu - base_cpu)
                        - d_excess, LOSS_FLOOR)
    q_bound = 10.0 / np.log(10.0) * d_excess / (excess + LOSS_FLOOR)
    dq = np.abs(ev.psnr - ref.psnr)
    org_bound = float(q_bound[0]) if np.all(bits[0] == b_max) else 0.0
    d_org = abs(bundle.benv.psnr_org_proxy - cpu_bundle.benv.psnr_org_proxy)
    dr = np.abs(ev.reward - ref.reward)
    r_bound = env.ecfg.lam * (q_bound + org_bound) + 1e-9
    dl = float(np.abs(ev.latency_cycles / ref.latency_cycles - 1).max())
    db = float(np.abs(ev.model_bytes / ref.model_bytes - 1).max())
    print(f"LM population of {LM_POP_K} on the card in {pop_s:.3f} s "
          f"({LM_POP_K / pop_s:.1f} policies/s), card vs CPU: losses "
          f"{d_loss:.3g} rel (tolerance {loss_rel}), quality max "
          f"{float(dq.max()):.3g} dB (bounds by policy from the loss "
          f"tolerance {float(q_bound.min()):.3g}..{float(q_bound.max()):.3g}"
          f"), 8-bit anchor {d_org:.3g} dB, reward max {float(dr.max()):.3g}"
          f", latency {dl:.3g} rel, model_bytes {db:.3g} rel; {fwd.n} "
          f"forwards, launches {launches}")
    if not (d_loss <= loss_rel and np.all(dq <= q_bound)
            and d_org <= org_bound and np.all(dr <= r_bound)
            and dl <= 1e-6 and db <= 1e-6):
        raise AssertionError("the LM population on the card differs from "
                             "the CPU's")
    want = {n: 0 for n in kern}
    want["flash_attention"] = env.cfg.n_layers * LM_POP_K
    if fwd.n != LM_POP_K or launches != want:
        raise AssertionError(f"{fwd.n} forwards and launches {launches}, "
                             f"want {LM_POP_K} and {want}")
    cap = -10.0 * np.log10(2 * LOSS_FLOOR)
    print(f"  extremes on the proxy batch: all-{b_max}-bit loss "
          f"{float(loss[0])!r}, all-{b_min}-bit loss {float(loss[1])!r}, "
          f"full precision "
          f"{base!r}; quality {float(ev.psnr[0])!r} and "
          f"{float(ev.psnr[1])!r} dB against the cap -10 log10(2 * "
          f"LOSS_FLOOR) = {float(cap)!r}, at which the reference's qwen2-7b "
          "smoke bundle (its own random weights) saturates at both "
          "extremes")
    del cpu_bundle, cpu_env
    return bundle


def lm_closed_loop(bundle, dev, kern):
    """The closed loop at `examples/torch/lm_quant_search.py`'s defaults
    on the card (qwen2-7b, budgets 1.0 and 0.85, 2 iterations at K = 8),
    counts zeroed around it: flash attention once per layer per forward,
    nothing else; its time split into proxy forwards and cost. Then
    `hero-search-torch --workload lm --arch qwen2-7b --quick` must return
    0. Returns the loop's launches."""
    from repro_torch.core.closed_loop import (
        ClosedLoopConfig,
        HeroSearchRun,
        bench_report,
    )
    from repro_torch.hero import cli

    benv = bundle.benv
    cfg = ClosedLoopConfig(scenes=(LM_ARCH,), budget_fracs=LM_BUDGETS,
                           n_iterations=LM_ITERATIONS, population=LM_K,
                           workload="lm", hardware="roofline-lm",
                           checkpoint_path=None, verbose=False)
    zeroed(kern)
    with ForwardCounter() as fwd, \
            CallTimer(benv, "evaluate_population", "proxy_losses",
                      "simulate_batch") as pop_t:
        t0 = time.perf_counter()
        result = HeroSearchRun(cfg, {LM_ARCH: bundle}, device=dev).run()
        loop_s = time.perf_counter() - t0
    loop = read(kern)
    report = bench_report(result, cfg)
    print(f"LM closed loop ({len(LM_BUDGETS)} budgets x {LM_ITERATIONS} "
          f"iterations x K={LM_K}): {loop_s:.2f} s, "
          f"{result.policies_evaluated} policies, "
          f"{result.policies_per_sec:.2f} policies/s of search "
          f"({result.search_seconds:.3f} s), frontier "
          f"{len(result.frontier)} points, hypervolume "
          f"{result.hypervolume()!r}, frontier_valid_vs_8bit "
          f"{report['frontier_valid_vs_8bit']}; {fwd.n} forwards, launches "
          f"{loop}")
    print(f"  where the loop's time went: evaluate_population "
          f"{pop_t.s['evaluate_population']:.3f} s (proxy forwards "
          f"{pop_t.s['proxy_losses']:.3f} s, cost "
          f"{pop_t.s['simulate_batch']:.4f} s), the rest (agent, CEM, "
          f"budget enforcement, frontier) "
          f"{loop_s - pop_t.s['evaluate_population']:.3f} s")
    want = {n: 0 for n in kern}
    want["flash_attention"] = bundle.env.cfg.n_layers * fwd.n
    if not (report["frontier_valid_vs_8bit"] and len(result.cells) == 2
            and result.policies_evaluated
            == len(LM_BUDGETS) * LM_ITERATIONS * LM_K and loop == want):
        raise AssertionError(f"LM closed loop: launches {loop} (want "
                             f"{want}), report {report}")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "search.json"
        t0 = time.perf_counter()
        rc = cli.main(["search", "--workload", "lm", "--arch", LM_ARCH,
                       "--quick", "--device", dev.type, "--checkpoint", "",
                       "--out", str(out)])
        cli_s = time.perf_counter() - t0
        cli_report = json.loads(out.read_text())
    print(f"hero-search-torch --workload lm --arch {LM_ARCH} --quick: rc {rc}"
          f" in {cli_s:.2f} s, {cli_report['policies_evaluated']} policies, "
          f"frontier {cli_report['frontier_size']} points, "
          f"{cli_report['policies_per_sec']} policies/s")
    if rc != 0 or not cli_report["frontier_size"]:
        raise AssertionError(f"the LM CLI search failed: rc {rc}")
    return loop


def lm_full_width(dev, kern):
    """`loss_fn` at qwen2-7b's published width (bf16, random weights from a
    seed) over 4 x 1024 `TokenPipeline` tokens with no spec, the all-8-bit
    spec and a mixed one (4-bit bands, layers' weights 4/8 and
    activations 8/4 bits alternating): flash attention once per layer
    each; loss, quality, ms and peak memory. Then the roofline's
    seconds/token and model_bytes at 8 and 4 bits under the card's preset
    beside the card's measured device-to-device copy rate."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.hero.targets import LMRooflineTarget
    from repro_torch.models import lm
    from repro_torch.workloads.lm import quality_db

    model = get_arch(LM_ARCH).model
    params = lm.init_params(model, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    tokens = torch.from_numpy(TokenPipeline(TokenPipelineConfig(
        vocab_size=model.vocab_size, seq_len=LM_FULL_SEQ,
        global_batch=LM_FULL_BATCH)).batch()).long().to(dev)
    L = lm.total_layers(model)
    full = lambda v, *shape: torch.full(shape, float(v), device=dev)
    alt = lambda a, b: torch.tensor([[a if l % 2 == 0 else b] * lm.N_GROUPS
                                     for l in range(L)], dtype=torch.float32,
                                    device=dev)
    specs = {
        "none": None,
        "8-bit": lm.LMQuantSpec(full(8, model.n_embed_bands),
                                full(8, L, lm.N_GROUPS),
                                full(8, L, lm.N_GROUPS)),
        "mixed": lm.LMQuantSpec(full(4, model.n_embed_bands), alt(4, 8),
                                alt(8, 4)),
    }
    base = None
    with torch.inference_mode():
        for name, spec in specs.items():
            run = lambda: lm.loss_fn(params, {"tokens": tokens}, model,
                                     spec=spec)[0]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            zeroed(kern)
            loss = float(run())
            launches = read(kern)
            peak = torch.cuda.max_memory_allocated(dev)
            ms = median_ms(run, iters=3, warmup=1, hide_host=False)
            base = loss if base is None else base
            q = float(quality_db(loss, base))
            print(f"{LM_ARCH} full width, loss_fn over {LM_FULL_BATCH} x "
                  f"{LM_FULL_SEQ} tokens, spec {name}: loss {loss!r}, quality "
                  f"{q!r} dB, {ms:.2f} ms (CUDA events, median of 3), peak "
                  f"{peak / 2**30:.2f} GiB; launches {launches}")
            want = {n: 0 for n in kern}
            want["flash_attention"] = L
            if launches != want or not np.isfinite(loss):
                raise AssertionError(f"full-width loss_fn ({name}): loss "
                                     f"{loss}, launches {launches}, want "
                                     f"{want}")
    del params
    target = LMRooflineTarget(device=dev)
    wl = target.build_workload(model)
    for bits in (8, 4):
        r = target.baseline(wl, bits)
        print(f"roofline-lm ({target.hw.chip}, {target.hw.hbm_gbps} GB/s) on "
              f"{LM_ARCH} at {bits} bits: {r['seconds_per_token'] * 1e3:.4f} "
              f"ms/token, model_bytes {r['model_bytes']:.0f}")
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    ms = median_ms(lambda: dst.copy_(src), iters=10, warmup=2)
    print(f"the card's stream rate: a {COPY_BYTES / 2**30:.0f} GiB "
          f"device-to-device copy in {ms:.3f} ms (CUDA events, median of "
          f"10): {2 * COPY_BYTES / ms / 1e6:.1f} GB/s read + write, against "
          f"the preset's {target.hw.hbm_gbps} GB/s")
    del src, dst


def lm_moe(dev, kern, tol: float = 1e-3, rel: float = 1e-5):
    """The MoE archs on the card: qwen3-moe and arctic smoke against the
    CPU (`loss_fn`'s ce and aux within `rel`, `prefill` and 4 decode steps'
    logits within `tol`), then qwen3-moe-235b-a22b's published widths at 2
    layers in bf16: `loss_fn` under a mixed spec, its ms, peak memory and
    the share of dropped (token, slot) pairs."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch.serve import greedy
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.models import lm
    from repro_torch.tree_util import tree_leaves

    cpu = torch.device("cpu")
    for arch in ("qwen3-moe-235b-a22b", "arctic-480b"):
        cfg = get_arch(arch).smoke
        p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device=cpu)
        p_dev = to_device(p_cpu, dev)
        toks = torch.from_numpy(TokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)).batch()
        ).long()
        with torch.inference_mode():
            zeroed(kern)
            l_dev, m_dev = lm.loss_fn(p_dev, {"tokens": toks.to(dev)}, cfg)
            launches = read(kern)
            l_cpu, m_cpu = lm.loss_fn(p_cpu, {"tokens": toks}, cfg)
            d_ce = abs(float(m_dev["ce"]) / float(m_cpu["ce"]) - 1)
            d_aux = abs(float(m_dev["aux"]) / float(m_cpu["aux"]) - 1)
            prompt, steps = toks[:2, :32], 4
            ld, cd = lm.prefill(p_dev, {"tokens": prompt.to(dev)}, cfg,
                                32 + steps)
            lc, cc = lm.prefill(p_cpu, {"tokens": prompt}, cfg, 32 + steps)
            worst = (ld.cpu() - lc).abs().max().item()
            for i in range(steps):
                tok = greedy(lc)[:, None]
                ld, cd = lm.decode_step(p_dev, cd, tok.to(dev), 32 + i, cfg)
                lc, cc = lm.decode_step(p_cpu, cc, tok, 32 + i, cfg)
                worst = max(worst, (ld.cpu() - lc).abs().max().item())
        print(f"{arch} smoke, card vs CPU: loss_fn ce {float(m_dev['ce'])!r} "
              f"({d_ce:.3g} rel), aux {float(m_dev['aux'])!r} ({d_aux:.3g} "
              f"rel); prefill + {steps} decode steps logits max |diff| "
              f"{worst:.3g} (tolerance {tol}); loss_fn launches {launches}")
        if not (d_ce <= rel and d_aux <= rel and worst <= tol
                and launches["flash_attention"] == cfg.n_layers):
            raise AssertionError(f"{arch} on the card differs from the CPU")

    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b").model,
                              n_layers=2)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    tokens = torch.from_numpy(TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_FULL_SEQ,
        global_batch=LM_FULL_BATCH)).batch()).long().to(dev)
    L = lm.total_layers(cfg)
    spec = lm.LMQuantSpec(
        torch.full((cfg.n_embed_bands,), 4.0, device=dev),
        torch.tensor([[4.0] * lm.N_GROUPS, [8.0] * lm.N_GROUPS], device=dev),
        torch.tensor([[8.0] * lm.N_GROUPS, [4.0] * lm.N_GROUPS], device=dev))
    shares = []
    inner = ffn_mod.moe_route

    def route(*a, **kw):
        r = inner(*a, **kw)
        shares.append(r.dropped_share())
        return r
    ffn_mod.moe_route = route
    try:
        with torch.inference_mode():
            run = lambda: lm.loss_fn(params, {"tokens": tokens}, cfg,
                                     spec=spec)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            zeroed(kern)
            loss, metrics = run()
            loss = float(loss)
            launches = read(kern)
            peak = torch.cuda.max_memory_allocated(dev)
            dropped = list(shares)
            ms = median_ms(run, iters=3, warmup=1, hide_host=False)
    finally:
        ffn_mod.moe_route = inner
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"qwen3-moe-235b-a22b published widths, {L} layers, bf16 "
          f"({n_bytes / 1e9:.2f} GB of weights), loss_fn under a mixed spec "
          f"over {LM_FULL_BATCH} x {LM_FULL_SEQ} tokens: loss {loss!r} (aux "
          f"{float(metrics['aux'])!r}), {ms:.2f} ms (CUDA events, median of "
          f"3), peak {peak / 2**30:.2f} GiB, dropped (token, slot) pairs by "
          f"layer {dropped}; launches {launches}")
    if not (np.isfinite(loss) and launches["flash_attention"] == L):
        raise AssertionError(f"qwen3-moe full width: loss {loss}, launches "
                             f"{launches}")
    del params


def examples_on_card(dev):
    """The ported examples at their own scale on the card: the quickstart
    (train, env, PTQ, an 8-episode search), the render comparison and the
    LM search; each must return 0."""
    import importlib.util
    import io
    from contextlib import redirect_stdout

    for name, writes in (("quickstart", False), ("render_compare", True),
                         ("lm_quant_search", False)):
        path = ROOT / "examples" / "torch" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"example_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with tempfile.TemporaryDirectory() as tmp:
            args = ["--device", dev.type] + (["--out", tmp] if writes
                                              else [])
            out = io.StringIO()
            t0 = time.perf_counter()
            with redirect_stdout(out):
                rc = mod.main(args)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
        tail = out.getvalue().strip().splitlines()[-1]
        print(f"examples/torch/{name}.py on the card: rc {rc} in {s:.2f} s; "
              f"last line: {tail}")
        if rc != 0:
            raise AssertionError(f"examples/torch/{name}.py returned {rc}")


def lm_search_phase(dev, kern, flash_entry):
    """Phase 11. Returns the LM closed loop's launches."""
    t0 = time.perf_counter()
    lm_flash_shapes(dev, flash_entry)
    bundle = lm_population_card_vs_cpu(dev, kern)
    loop = lm_closed_loop(bundle, dev, kern)
    del bundle
    lm_full_width(dev, kern)
    lm_moe(dev, kern)
    examples_on_card(dev)
    print(f"LM search phase: {time.perf_counter() - t0:.2f} s")
    return loop


# ---------------------------------------------------------------------------
# Phase 12: the LM stack's other block families (Mamba / jamba, xLSTM,
# whisper's encoder-decoder, llava's patch prefix).
# ---------------------------------------------------------------------------
ITEM8_ARCHS = ("whisper-large-v3", "llava-next-mistral-7b", "xlstm-350m",
               "jamba-v0.1-52b")
ITEM8_SHORT = {"whisper-large-v3": "whisper", "llava-next-mistral-7b": "llava",
               "xlstm-350m": "xlstm", "jamba-v0.1-52b": "jamba"}
# Prompt positions a request: llava's are its 576 patches and 448 tokens.
ITEM8_PROMPT = 1024
# Jamba at full width is cut to one period (PERF.md section 4): 7 Mamba
# layers, 1 attention layer, 4 of them with the 16-expert MoE (~25 GB).
JAMBA_LAYERS = 8
# Kernel 6 at the shapes phase 12's serves give it, B 4 (name, Hkv, G, hd,
# Sq, Sk, causal): whisper's encoder over its 1,500 frames; its decoder's
# cross-attention of the 1,024 prompt positions over them, and of 64;
# both over 1,001 frames, whose last 64-key tile holds 41 keys; whisper's
# causal decoder self-attention; llava's and jamba's causal layers.
FULL_SHAPES = (("whisper_enc", 20, 1, 64, 1500, 1500, False),
               ("cross_served", 20, 1, 64, 1024, 1500, False),
               ("cross", 20, 1, 64, 64, 1500, False),
               ("ragged", 20, 1, 64, 1001, 1001, False),
               ("cross_ragged", 20, 1, 64, 64, 1001, False),
               ("whisper_dec", 20, 1, 64, 1024, 1024, True),
               ("llava_jamba", 8, 4, 128, 1024, 1024, True))
# Kernel 7 at the shapes phase 12's serves give it, B 4 (name, Hkv, G, hd,
# cache rows, length): whisper's cross decode over every row of its
# 1,500-row cross cache, and whisper's and llava's (jamba's) self-attention
# decode in the middle of a request's 32 tokens.
DECODE_SHAPES = (("whisper_cross", 20, 1, 64, 1500, 1500),
                 ("whisper_self", 20, 1, 64, LM_SMAX, LM_PROMPT + LM_GEN // 2),
                 ("llava_jamba", 8, 4, 128, LM_SMAX, LM_PROMPT + LM_GEN // 2))


def flash_full_shapes(dev, entry):
    """Kernel 6 at FULL_SHAPES: the non-causal ones as `ops.full_attention`
    runs them (Sq queries against Sk keys) held to `full_attention_plain`,
    the causal ones to `flash_attention_plain`; bf16 within
    BF16_ATTN_LIMIT and f32 within 1e-4; each call profiled once, and the
    kernel it launched must be the one of `flash_route`'s route; the bf16
    call timed beside the plain version and SDPA, with its bound (kept in
    `entry` under `*_<shape>`)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention_kernel import (
        flash_attention_cuda as kernel,
        flash_attention_plain,
        flash_route,
        full_attention_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(23)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B = LM_BATCH
    for name, Hkv, G, hd, Sq, Sk, causal in FULL_SHAPES:
        H = Hkv * G
        plain = (lambda q, k, v: flash_attention_plain(q, k, v, True)) \
            if causal else full_attention_plain
        errs, ran = {}, {}
        for dtype, tol in ((torch.float32, 1e-4),
                           (torch.bfloat16, BF16_ATTN_LIMIT)):
            q = torch.randn((B, Sq, H, hd), generator=gen, device=dev) \
                .to(dtype)
            k = torch.randn((B, Sk, Hkv, hd), generator=gen, device=dev) \
                .to(dtype)
            v = torch.randn((B, Sk, Hkv, hd), generator=gen, device=dev) \
                .to(dtype)
            q5 = q.view(B, Sq, Hkv, G, hd).permute(0, 2, 1, 3, 4)
            k4, v4 = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
            err = (kernel(q5, k4, v4, causal) - plain(q5, k4, v4)).abs() \
                .max().item()
            errs[dtype] = err
            if not err <= tol:
                raise AssertionError(f"flash_attention {name} ({dtype}, Sq "
                                     f"{Sq}, Sk {Sk}): {err} > {tol}")
            ran[dtype] = flash_kernel_route(
                lambda: kernel(q5, k4, v4, causal))
            if ran[dtype] != flash_route(dtype, hd):
                raise AssertionError(f"flash_attention {name} ({dtype}): "
                                     f"launched the {ran[dtype]} kernel, "
                                     f"not {flash_route(dtype, hd)}'s")
        qs = q.transpose(1, 2)  # the bf16 inputs in the library's layout
        t_k = median_ms(lambda: kernel(q5, k4, v4, causal))
        t_p = median_ms(lambda: plain(q5, k4, v4))
        t_l = median_ms(lambda: sdpa(qs, k4, v4, is_causal=causal,
                                     enable_gqa=True))
        bnd = bound(cost.flash_attention(B, Hkv, G, hd, Sq, Sk, causal, 2))
        print(f"flash_attention (B {B}, Hkv {Hkv}, G {G}, hd {hd}, Sq {Sq}, "
              f"Sk {Sk}, causal {causal}, {name}; profiled routes bf16 "
              f"{ran[torch.bfloat16]}, f32 {ran[torch.float32]}): max "
              "|diff| bf16 "
              f"{errs[torch.bfloat16]:.3g}, f32 {errs[torch.float32]:.3g}; "
              f"bf16 kernel {t_k:.4f} ms, plain {t_p:.4f} ms, SDPA "
              f"{t_l:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        entry.update({f"max_abs_err_{name}": errs[torch.bfloat16],
                      f"max_abs_err_{name}_f32": errs[torch.float32],
                      f"ms_{name}": t_k, f"plain_ms_{name}": t_p,
                      f"library_ms_{name}": t_l, f"bound_ms_{name}": bnd[0],
                      f"bound_by_{name}": bnd[1]})


def decode_full_shapes(dev, entry):
    """Kernel 7 at DECODE_SHAPES on strided views of (B, rows, Hkv, hd)
    caches, as the model hands them over: bf16 within BF16_ATTN_LIMIT and
    f32 within 1e-4 of `decode_attention_plain`; the bf16 call timed
    beside the plain version and SDPA, with its bound (kept in `entry`
    under `*_<shape>`)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.decode_attention_kernel import (
        decode_attention_cuda as kernel,
        decode_attention_plain as plain,
    )

    gen = torch.Generator(device=dev).manual_seed(24)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B = LM_BATCH
    for name, Hkv, G, hd, S, length in DECODE_SHAPES:
        errs = {}
        for dtype, tol in ((torch.float32, 1e-4),
                           (torch.bfloat16, BF16_ATTN_LIMIT)):
            q = torch.randn((B, Hkv, G, hd), generator=gen, device=dev) \
                .to(dtype)
            cache = [torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
                     .to(dtype) for _ in range(2)]
            k, v = (c.permute(0, 2, 1, 3) for c in cache)
            err = (kernel(q, k, v, length).float()
                   - plain(q, k, v, length).float()).abs().max().item()
            errs[dtype] = err
            if not err <= tol:
                raise AssertionError(f"decode_attention {name} ({dtype}, "
                                     f"rows {S}, length {length}): {err} > "
                                     f"{tol}")
        len_t = torch.tensor(length, dtype=torch.int32, device=dev)
        qs = q.reshape(B, Hkv * G, 1, hd)
        mask = (torch.arange(S, device=dev) < length)[None, None, None, :]
        t_k = median_ms(lambda: kernel(q, k, v, len_t))
        t_p = median_ms(lambda: plain(q, k, v, len_t))
        t_l = median_ms(lambda: sdpa(qs, k, v, attn_mask=mask,
                                     enable_gqa=True))
        bnd = bound(cost.decode_attention(B, Hkv, G, hd, length, 2))
        print(f"decode_attention (B {B}, Hkv {Hkv}, G {G}, hd {hd}, rows "
              f"{S}, length {length}, {name}): max |diff| bf16 "
              f"{errs[torch.bfloat16]:.3g}, f32 {errs[torch.float32]:.3g}; "
              f"bf16 kernel {t_k:.4f} ms, plain {t_p:.4f} ms, SDPA "
              f"{t_l:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        entry.update({f"max_abs_err_{name}": errs[torch.bfloat16],
                      f"max_abs_err_{name}_f32": errs[torch.float32],
                      f"ms_{name}": t_k, f"plain_ms_{name}": t_p,
                      f"library_ms_{name}": t_l, f"bound_ms_{name}": bnd[0],
                      f"bound_by_{name}": bnd[1]})


def item8_model(arch: str):
    """The full-width config phase 12 serves: the published one, jamba's
    cut to JAMBA_LAYERS layers."""
    from repro_torch.configs import get_arch

    model = get_arch(arch).model
    if arch == "jamba-v0.1-52b":
        model = dataclasses.replace(model, n_layers=JAMBA_LAYERS)
    return model


def attention_launches(model):
    """(flash launches a forward or prefill, decode-attention launches a
    decode step): flash once per attention layer, and for whisper also
    once per encoder layer and once per decoder layer for
    cross-attention; decode attention once per attention layer, twice per
    decoder layer for whisper."""
    from repro_torch.models import lm

    n_attn = sum(lm._layer_kind(model, l) in ("attn", "dec")
                 for l in range(model.n_layers))
    cross = model.n_layers if model.pattern == "encdec" else 0
    return n_attn + model.encoder_layers + cross, n_attn + cross


def item8_want(model, stats, kern):
    """The launches a serve run must make (`attention_launches`), and no
    other kernel's."""
    flash, decode = attention_launches(model)
    want = {n: 0 for n in kern}
    want["flash_attention"] = flash * stats.prefills
    want["decode_attention"] = decode * stats.decode_steps
    return want


def mixer_ms(label, fn):
    """One recurrent mixer at full width: median of 3 calls, host clock
    included (CUDA events around each)."""
    with torch.inference_mode():
        ms = median_ms(fn, iters=3, warmup=1, hide_host=False)
    print(f"  {label}: {ms:.2f} ms")
    return ms


def item8_serve(dev, kern):
    """Each of ITEM8_ARCHS at full width (jamba cut to one period), random
    weights from a seed on the card, through `repro_torch.launch.serve`:
    4 requests of ITEM8_PROMPT prompt positions (llava: 576 zero patches
    and 448 tokens; whisper: 1,500 zero frames beside 1,024 tokens) and
    LM_GEN generated tokens. Counts are zeroed just before each serve and
    read just after (`item8_want`). The recurrent mixers are timed at the
    served shapes, and jamba's `loss_fn` under a mixed spec. Returns
    {"serve_<arch>": launches}."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm, ssm as ssm_mod
    from repro_torch.models import xlstm_blocks as xl
    from repro_torch.tree_util import tree_leaves

    out = {}
    for arch in ITEM8_ARCHS:
        model = item8_model(arch)
        prefix = model.n_prefix_patches \
            if model.embed_frontend == "prefix_patches" else 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = lm.init_params(model, torch.Generator(device=dev)
                                .manual_seed(0), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
        zeroed(kern)
        stats = serve_mod.serve(model, params, LM_BATCH, LM_BATCH,
                                ITEM8_PROMPT - prefix, LM_GEN, dev,
                                log=lambda _: None)
        launches = read(kern)
        peak = torch.cuda.max_memory_allocated(dev)
        want = item8_want(model, stats, kern)
        print(f"{arch} ({model.n_layers} layers"
              f"{f' + {model.encoder_layers} encoder' if model.encoder_layers else ''}"
              f", d {model.d_model}, {n_bytes / 1e9:.2f} GB of weights, "
              f"drawn in {init_s:.2f} s) served: {stats.requests} requests "
              f"of {ITEM8_PROMPT} prompt positions + {LM_GEN} tokens, "
              f"prefill {stats.prefill_ms[0]:.2f} ms, decode "
              f"{stats.decode_ms_per_step[0]:.3f} ms a step, "
              f"{stats.tokens_per_s:.1f} tokens/s ({stats.wall_s:.2f} s), "
              f"peak {peak / 2**30:.2f} GiB; launches {launches} (want "
              f"{want})")
        if launches != want or any(s.shape != (LM_BATCH, LM_GEN)
                                   for s in stats.samples):
            raise AssertionError(f"{arch}: launches {launches}, want {want}")
        out[f"serve_{ITEM8_SHORT[arch]}"] = launches
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn((LM_BATCH, ITEM8_PROMPT, model.d_model),
                        generator=gen, device=dev).to(model.param_dtype) \
            if model.pattern in ("xlstm", "jamba") else None
        if arch == "xlstm-350m":
            mixer_ms(f"mLSTM forward (B {LM_BATCH}, S {ITEM8_PROMPT}, d "
                     f"{model.d_model})",
                     lambda: xl.mlstm_forward(params["blocks"][0]["mlstm"],
                                              x, model))
            mixer_ms(f"sLSTM forward, {ITEM8_PROMPT} sequential cell steps",
                     lambda: xl.slstm_forward(params["blocks"][1]["slstm"],
                                              x, model))
        if arch == "jamba-v0.1-52b":
            din, r, n = ssm_mod.ssm_dims(model)
            f32 = lambda *s: torch.rand(s, generator=gen, device=dev)
            scan = (f32(LM_BATCH, ITEM8_PROMPT, din) * 0.1, -f32(din, n),
                    f32(LM_BATCH, ITEM8_PROMPT, n), f32(LM_BATCH,
                                                         ITEM8_PROMPT, n),
                    f32(LM_BATCH, ITEM8_PROMPT, din),
                    torch.zeros((LM_BATCH, din, n), device=dev))
            mixer_ms(f"Mamba forward (B {LM_BATCH}, S {ITEM8_PROMPT}, d_inner"
                     f" {din}, d_state {n})",
                     lambda: ssm_mod.ssm_forward(params["blocks"][0]["ssm"],
                                                 x, model))
            mixer_ms(f"  of which the selective scan ({ITEM8_PROMPT // 128} "
                     "chunks of 128)",
                     lambda: ssm_mod._selective_scan_chunked(*scan, 128))
            del scan
            jamba_loss_full_width(dev, kern, model, params)
        del params, x
        torch.cuda.empty_cache()
    return out


def jamba_loss_full_width(dev, kern, model, params):
    """`loss_fn` at jamba's one-period full width (bf16) over 4 x 1024
    `TokenPipeline` tokens under a mixed spec (4-bit bands, layers'
    weights 4/8 and activations 8/4 bits alternating): loss, ms and peak
    memory; flash attention once (the one attention layer), nothing
    else. Beyond 70 GiB of peak memory the same is also run over 2 x 1024 tokens."""
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.models import lm

    L = lm.total_layers(model)
    alt = lambda a, b: torch.tensor([[a if l % 2 == 0 else b] * lm.N_GROUPS
                                     for l in range(L)], dtype=torch.float32,
                                    device=dev)
    spec = lm.LMQuantSpec(torch.full((model.n_embed_bands,), 4.0,
                                     device=dev), alt(4, 8), alt(8, 4))
    for batch in (LM_FULL_BATCH, LM_FULL_BATCH // 2):
        tokens = torch.from_numpy(TokenPipeline(TokenPipelineConfig(
            vocab_size=model.vocab_size, seq_len=LM_FULL_SEQ,
            global_batch=batch)).batch()).long().to(dev)
        run = lambda: lm.loss_fn(params, {"tokens": tokens}, model,
                                 spec=spec)[0]
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            zeroed(kern)
            loss = float(run())
            launches = read(kern)
            peak = torch.cuda.max_memory_allocated(dev)
            ms = median_ms(run, iters=3, warmup=1, hide_host=False)
        print(f"jamba one period, loss_fn under a mixed spec over {batch} x "
              f"{LM_FULL_SEQ} tokens: loss {loss!r}, {ms:.2f} ms (CUDA "
              f"events, median of 3), peak {peak / 2**30:.2f} GiB; launches "
              f"{launches}")
        want = {n: 0 for n in kern}
        want["flash_attention"] = attention_launches(model)[0]
        if launches != want or not np.isfinite(loss):
            raise AssertionError(f"jamba loss_fn: loss {loss}, launches "
                                 f"{launches}, want {want}")
        if peak <= 70 * 2**30:
            break


def item8_batch(cfg, rng, B: int = 2, S: int = 32):
    """A numpy batch for a smoke config: tokens, llava's patches, or
    whisper's frames (4 fewer than max_source_len, so the cross cache
    keeps zero rows)."""
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)}
    if cfg.embed_frontend == "prefix_patches":
        b["patches"] = (rng.normal(size=(B, cfg.n_prefix_patches,
                                         cfg.d_model)) * 0.02) \
            .astype(np.float32)
    if cfg.embed_frontend == "stub_frames":
        b["frames"] = (rng.normal(size=(B, cfg.max_source_len - 4,
                                        cfg.d_model)) * 0.02) \
            .astype(np.float32)
    return b


def item8_smoke_card_vs_cpu(dev, kern, arch: str, tol: float = 1e-3):
    """`arch`'s smoke config in float32 on the card and on the CPU, same
    weights and inputs (whisper's frames short of max_source_len):
    `forward`'s logits, `prefill`'s logits and every cache leaf, one
    `decode_step`'s logits and cache within `tol`; the forward's launches
    flash attention's alone, once per attention layer
    (`attention_launches`), and the decode step's decode attention's
    alone. Returns the largest gaps."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    cpu = torch.device("cpu")
    cfg = get_arch(arch).smoke
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), device=cpu)
    p_dev = to_device(p_cpu, dev)
    b_cpu = {k: torch.from_numpy(v) for k, v in
             item8_batch(cfg, np.random.default_rng(12)).items()}
    b_dev = to_device(b_cpu, dev)
    prefix = cfg.n_prefix_patches \
        if cfg.embed_frontend == "prefix_patches" else 0
    S = b_cpu["tokens"].shape[1] + prefix
    pre = lambda b: dict(b, tokens=b["tokens"][:, :-1])
    diffs = {}
    with torch.inference_mode():
        zeroed(kern)
        l_dev = lm.forward(p_dev, b_dev, cfg)[0]
        launches = read(kern)
        diffs["forward"] = (l_dev.cpu() - lm.forward(p_cpu, b_cpu, cfg)[0]
                            ).abs().max().item()
        ld, cd = lm.prefill(p_dev, pre(b_dev), cfg, S)
        lc, cc = lm.prefill(p_cpu, pre(b_cpu), cfg, S)
        diffs["prefill"] = (ld.cpu() - lc).abs().max().item()
        diffs["prefill cache"] = max(
            (cd[i][n].cpu() - cc[i][n]).abs().max().item()
            for i in cc for n in cc[i])
        tok = b_cpu["tokens"][:, -1:]
        zeroed(kern)
        ld, cd = lm.decode_step(p_dev, cd, tok.to(dev), S - 1, cfg)
        launches_decode = read(kern)
        lc, cc = lm.decode_step(p_cpu, cc, tok, S - 1, cfg)
        diffs["decode"] = (ld.cpu() - lc).abs().max().item()
        diffs["decode cache"] = max(
            (cd[i][n].cpu() - cc[i][n]).abs().max().item()
            for i in cc for n in cc[i])
    flash, decode = attention_launches(cfg)
    want = {n: 0 for n in kern}
    want_decode = dict(want, decode_attention=decode)
    want["flash_attention"] = flash
    print(f"{arch} smoke, float32 card vs CPU: max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
          + f" (tolerance {tol}); forward launches {launches}, decode step "
          f"launches {launches_decode}")
    if max(diffs.values()) > tol or launches != want \
            or launches_decode != want_decode:
        raise AssertionError(f"{arch} smoke on the card differs from the "
                             f"CPU: {diffs}, launches {launches} and "
                             f"{launches_decode}, want {want} and "
                             f"{want_decode}")
    return diffs


def item8_card_vs_cpu(dev, kern, loss_rel: float = 1e-6):
    """`item8_smoke_card_vs_cpu` for the four smoke configs; then jamba's
    and xlstm's `LMWorkload` bundle built on the card and the same
    weights' on the CPU: the full-precision base loss within `loss_rel`
    relative, 4 policies' proxy losses as `losses_agree` says (at least 3
    within FLIP_NEAR, all within FLIP_FAR), flash attention once per
    attention layer per forward."""
    from repro_torch.workloads.lm import (
        FLIP_FAR,
        FLIP_NEAR,
        LMBatchedEnv,
        LMQuantEnv,
        LMWorkload,
        losses_agree,
    )

    cpu = torch.device("cpu")
    rng = np.random.default_rng(12)
    for arch in ITEM8_ARCHS:
        item8_smoke_card_vs_cpu(dev, kern, arch)
    for arch in ("jamba-v0.1-52b", "xlstm-350m"):
        bundle = LMWorkload().build_bundle(arch, device=dev)
        env = bundle.env
        cpu_env = LMQuantEnv(arch, env.ecfg, device=cpu,
                             params=to_device(env.params, cpu))
        bits = rng.integers(env.ecfg.b_min, env.ecfg.b_max + 1,
                            (4, env.n_units))
        bits[0], bits[1] = env.ecfg.b_max, env.ecfg.b_min
        zeroed(kern)
        loss = bundle.benv.proxy_losses(env.params, bits).astype(np.float64)
        launches = read(kern)
        loss_cpu = LMBatchedEnv(cpu_env).proxy_losses(cpu_env.params, bits) \
            .astype(np.float64)
        d_base = abs(env.base_loss_proxy / cpu_env.base_loss_proxy - 1)
        ok, d = losses_agree(loss, loss_cpu)
        print(f"{arch} LMWorkload bundle, card vs CPU: base loss "
              f"{env.base_loss_proxy!r} (CPU {cpu_env.base_loss_proxy!r}): "
              f"{d_base:.3g} rel (tolerance {loss_rel}); 4 policies' proxy "
              f"losses {loss.tolist()}: {d.tolist()} rel (tolerance "
              f"{FLIP_NEAR} for 3, {FLIP_FAR} for all); launches {launches}")
        want = {n: 0 for n in kern}
        want["flash_attention"] = 4 * attention_launches(env.cfg)[0]
        if not (d_base <= loss_rel and ok) or launches != want:
            raise AssertionError(f"{arch} LM bundle on the card differs from "
                                 f"the CPU: base {d_base}, policies {d}, "
                                 f"launches {launches}")
        del bundle, cpu_env


def item8_cli(dev):
    """`hero-search-torch --workload lm --arch xlstm-350m --quick` on the
    card must return 0 with a non-empty frontier."""
    from repro_torch.hero import cli

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "search.json"
        t0 = time.perf_counter()
        rc = cli.main(["search", "--workload", "lm", "--arch", "xlstm-350m",
                       "--quick", "--device", dev.type, "--checkpoint", "",
                       "--out", str(out)])
        s = time.perf_counter() - t0
        report = json.loads(out.read_text())
    print(f"hero-search-torch --workload lm --arch xlstm-350m --quick: rc "
          f"{rc} in {s:.2f} s, {report['policies_evaluated']} policies, "
          f"frontier {report['frontier_size']} points")
    if rc != 0 or not report["frontier_size"]:
        raise AssertionError(f"the xlstm CLI search failed: rc {rc}")


def item8_phase(dev, kern, flash_entry, decode_entry):
    """Phase 12. Returns the four serves' launches."""
    t0 = time.perf_counter()
    flash_full_shapes(dev, flash_entry)
    decode_full_shapes(dev, decode_entry)
    launches = item8_serve(dev, kern)
    item8_card_vs_cpu(dev, kern)
    item8_cli(dev)
    print(f"phase 12 (jamba, xlstm, whisper, llava): "
          f"{time.perf_counter() - t0:.2f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: LM training on the card
# ---------------------------------------------------------------------------
# (a) whisper-large-v3 at full width and depth through the launcher: 6
# steps of 8 sequences of 128 tokens in 2 microbatches beside 1,500 zero
# frames, one checkpoint (at step 4), then the same run resumed there.
WHISPER_TRAIN = ["--arch", "whisper-large-v3", "--seq-len", "128",
                 "--global-batch", "8", "--accum", "2"]
WHISPER_STEPS, WHISPER_CKPT_EVERY = 6, 4
# (b) qwen2-7b at its published width cut to 2 of 28 layers (PERF.md
# section 4: 28 layers with an f32 accumulator do not fit one card), int8
# moments: 4 steps of 2 microbatches of 4 x 1,024 tokens; then the same
# steps with f32 moments, a witness for the int8 run's loss curve.
QWEN_TRAIN_LAYERS, QWEN_MB, QWEN_SEQ, QWEN_ACCUM, QWEN_STEPS = 2, 4, 1024, 2, 4
TRAIN_LR = 3e-4  # the launcher's default, weight decay 0.1
# (c) one train step of every smoke config, card against CPU: 4
# microbatches of 2 sequences of 32 tokens; and INT8_STEPS steps of
# INT8_ARCH's with int8 moments.
SMOKE_ACCUM, SMOKE_MB, SMOKE_SEQ = 4, 2, 32
INT8_ARCH, INT8_STEPS = "qwen2-7b", 2
# xlstm's first moments are held leaf by leaf to twice what SENS_DRAWS
# draws of SENS_REL weight noise (about one float32 ulp) move them on the
# CPU, and to no less than 1e-5 (scripts/torch_train_grad_sensitivity.py).
SENS_REL, SENS_DRAWS = 1e-7, 4
# (d) kernel 6's backward against its plain version: the largest error
# over the largest |gradient| of the plain version, per dtype.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RESUME_REL = 1e-5
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd")


def train_shapes():
    """(name, B, Hkv, G, hd, Sq, Sk, causal, dtype) of every call (a), (b)
    and (c) make of kernel 6 and its backward: whisper's encoder, causal
    decoder and cross-attention, qwen2-7b's layers (bf16); the smoke
    configs' attention layers (f32), deduplicated."""
    from repro_torch.configs import ARCH_IDS, get_arch

    w = get_arch("whisper-large-v3").model
    q = get_arch("qwen2-7b").model
    B = QWEN_MB
    bf16 = torch.bfloat16
    shapes = [("whisper_enc", B, w.n_kv_heads, 1, w.head_dim,
               w.max_source_len, w.max_source_len, False, bf16),
              ("whisper_dec", B, w.n_kv_heads, 1, w.head_dim, 128, 128,
               True, bf16),
              ("whisper_cross", B, w.n_kv_heads, 1, w.head_dim, 128,
               w.max_source_len, False, bf16),
              ("qwen2", QWEN_MB, q.n_kv_heads, q.n_heads // q.n_kv_heads,
               q.head_dim, QWEN_SEQ, QWEN_SEQ, True, bf16)]
    seen = set()
    for arch in ARCH_IDS:
        cfg = get_arch(arch).smoke
        if cfg.pattern == "xlstm":
            continue
        G = cfg.n_heads // cfg.n_kv_heads
        S = SMOKE_SEQ + (cfg.n_prefix_patches
                         if cfg.embed_frontend == "prefix_patches" else 0)
        calls = [(S, S, True)]
        if cfg.pattern == "encdec":
            src = cfg.max_source_len
            calls = [(S, S, True), (src, src, False), (S, src, False)]
        for Sq, Sk, causal in calls:
            key = (cfg.n_kv_heads, G, cfg.head_dim, Sq, Sk, causal)
            if key not in seen:
                seen.add(key)
                shapes.append((f"smoke_{len(seen)}", SMOKE_MB, *key,
                               torch.float32))
    return shapes


def bwd_inputs(gen, dev, B, Hkv, G, hd, Sq, Sk, dtype):
    """q, k, v as the model hands them over (views of (B, S, H, hd) and
    (B, Sk, Hkv, hd)) and an f32 output gradient of q's shape."""
    H = Hkv * G
    q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Sk, Hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Sk, Hkv, hd), generator=gen, device=dev).to(dtype)
    do = torch.randn((B, Sq, H, hd), generator=gen, device=dev)
    v5 = lambda t: t.view(B, Sq, Hkv, G, hd).permute(0, 2, 1, 3, 4)  # noqa
    return (v5(q), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), v5(do))


def phase_flash_backward(dev):
    """(d): the backward kernel against `flash_attention_bwd_plain` at
    every shape of `train_shapes()`, on the forward kernel's output and
    log-sum-exp (the plain version's from the same), within BWD_TOL; the
    LSE against `attention_lse_plain` within 1e-5; at each bf16 shape
    also against the float32 gradient (autograd of
    `flash_attention_plain` in f32 on the same inputs) within the same
    BWD_TOL, which bounds what the tensor-core route's bf16 rounding
    costs against the true gradient; then, at each bf16
    shape, the kernel timed beside the plain version, its bound, the
    forward and backward kernels back to back, and SDPA's forward plus
    backward (`enable_gqa`, a yardstick only). The entry's plain numbers
    are qwen2-7b's shape; the others ride under `*_<shape>`."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention_kernel import (
        attention_lse_plain,
        flash_attention_bwd_cuda as kernel,
        flash_attention_bwd_plain as plain,
        flash_attention_cuda,
        flash_attention_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(24)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst, worst_f32, timed = 0.0, 0.0, {}
    for name, B, Hkv, G, hd, Sq, Sk, causal, dtype in train_shapes():
        q, k, v, do = bwd_inputs(gen, dev, B, Hkv, G, hd, Sq, Sk, dtype)
        lse = torch.empty((B, Hkv, Sq, G), device=dev)
        out = flash_attention_cuda(q, k, v, causal, lse)
        lse_err = (lse - attention_lse_plain(q, k, causal)).abs().max() \
            .item()
        got = kernel(q, k, v, out, lse, do, causal)
        want = plain(q, k, v, out, attention_lse_plain(q, k, causal), do,
                     causal)
        torch.cuda.synchronize()
        gaps = [((a.float() - b.float()).abs().max().item(),
                 b.float().abs().max().item()) for a, b in zip(got, want)]
        err = max(d / top for d, top in gaps)  # the tolerance's reading
        abs_err = max(d for d, _ in gaps)
        again = kernel(q, k, v, out, lse, do, causal)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"flash backward {name} ({dtype}, B {B}, Hkv {Hkv}, G {G}, "
              f"hd {hd}, Sq {Sq}, Sk {Sk}, causal {causal}): max |diff| / "
              f"max |grad| {err:.3g} (tolerance {BWD_TOL[dtype]}; max "
              f"|diff| {abs_err:.3g}), LSE "
              f"max |diff| {lse_err:.3g}, rerun bit-equal {same}")
        if not (err <= BWD_TOL[dtype] and lse_err <= 1e-5 and same):
            raise AssertionError(f"flash backward {name}: {err}, LSE "
                                 f"{lse_err}, bit-equal {same}")
        if dtype == torch.float32:
            worst_f32 = max(worst_f32, abs_err)
            continue
        worst = max(worst, abs_err)
        qf, kf, vf = (t.detach().float().requires_grad_(True)
                      for t in (q, k, v))
        exact = torch.autograd.grad(flash_attention_plain(qf, kf, vf, causal),
                                    (qf, kf, vf), do)
        del qf, kf, vf
        err32 = max(((a.float() - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(got, exact))
        del exact
        print(f"  against the float32 gradient: max |diff| / max |grad| "
              f"{err32:.3g} (tolerance {BWD_TOL[dtype]})")
        if not err32 <= BWD_TOL[dtype]:
            raise AssertionError(f"flash backward {name}: {err32} from the "
                                 f"float32 gradient")
        H = Hkv * G
        qs = q.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hd).transpose(1, 2)
        dos = do.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hd) \
            .transpose(1, 2)
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (qs, k, v))

        def library():
            torch.autograd.grad(sdpa(qs, ks, vs, is_causal=causal,
                                     enable_gqa=True), (qs, ks, vs), dos)

        def fwd_bwd():
            o = flash_attention_cuda(q, k, v, causal, lse)
            kernel(q, k, v, o, lse, do, causal)

        t_k = median_ms(lambda: kernel(q, k, v, out, lse, do, causal),
                        iters=10)
        t_p = median_ms(lambda: plain(q, k, v, out, lse, do, causal),
                        iters=5, warmup=1)
        t_l = median_ms(library, iters=10)
        t_fb = median_ms(fwd_bwd, iters=10)
        t_c = median_ms(lambda: kernel(q, k, v, out, lse, do, causal),
                        iters=10, hide_host=False)
        bnd = bound(cost.flash_attention_bwd(B, Hkv, G, hd, Sq, Sk, causal,
                                             2))
        print(f"  kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}), forward + backward kernels "
              f"{t_fb:.4f} ms, SDPA forward + backward {t_l:.4f} ms")
        timed[name] = dict(err=abs_err, rel=err, rel32=err32, ms=t_k,
                           plain_ms=t_p, bnd=bnd,
                           library_ms=t_l, fwd_bwd_ms=t_fb, call_ms=t_c)
    main = timed["qwen2"]
    e = entry("flash_attention_bwd",
              "src/repro_torch/csrc/flash_attention_bwd.cu",
              "src/repro/kernels/flash_attention_kernel.py:67 (no backward "
              "there: XLA autodiff of src/repro/models/attention.py:75)",
              worst, main["ms"], main["plain_ms"], main["bnd"],
              main["library_ms"], main["call_ms"],
              fwd_bwd_ms=main["fwd_bwd_ms"], max_abs_err_f32=worst_f32,
              max_err_over_max_grad=main["rel"],
              max_err_over_max_grad_f32_gradient=main["rel32"])
    for name, t in timed.items():
        if name == "qwen2":
            continue
        e.update({f"max_abs_err_{name}": t["err"],
                  f"max_err_over_max_grad_{name}": t["rel"],
                  f"max_err_over_max_grad_f32_gradient_{name}": t["rel32"],
                  f"ms_{name}": t["ms"],
                  f"plain_ms_{name}": t["plain_ms"],
                  f"bound_ms_{name}": t["bnd"][0],
                  f"library_ms_{name}": t["library_ms"],
                  f"fwd_bwd_ms_{name}": t["fwd_bwd_ms"]})
        e[f"bound_by_{name}"] = t["bnd"][1]
    return e


def train_launches(model, microbatches: int):
    """Kernel 6's launches (forward, backward) in `microbatches` training
    microbatches of `model`: one of each per attention call, and a second
    forward where `model.remat` recomputes each period in backward."""
    n = attention_launches(model)[0] * microbatches
    return {"flash_attention": n * (2 if model.remat else 1),
            "flash_attention_bwd": n}


def check_train_launches(label, got, want):
    extra = {n: v for n, v in got.items() if n not in want and v}
    print(f"  launches in {label}: "
          + ", ".join(f"{n} {got[n]}" for n in want))
    if any(got[n] != v for n, v in want.items()) or extra:
        raise AssertionError(f"{label}: launches {got}, want {want} and no "
                             f"other kernel")


def train_whisper(dev, kern):
    """(a): whisper-large-v3 trained by `launch.train.main`, counts zeroed
    just before and read just after; then resumed from its one
    checkpoint (step WHISPER_CKPT_EVERY), the steps after it within
    RESUME_REL of the first run's. Returns the first run's launches."""
    import gc
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.launch import train as train_mod
    from repro_torch.tree_util import leaves_with_path

    model = get_arch("whisper-large-v3").model
    ckpt = ROOT / "build" / "train_whisper_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = WHISPER_TRAIN + ["--steps", str(WHISPER_STEPS),
                            "--ckpt-dir", str(ckpt)]
    torch.cuda.reset_peak_memory_stats()
    log, t0 = [], time.perf_counter()
    zeroed(kern)
    params = train_mod.main(argv + ["--ckpt-every",
                                    str(WHISPER_CKPT_EVERY)], log=log)
    launches = read(kern)
    wall = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in leaves_with_path(params))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"whisper-large-v3 trained at full width and depth ({n_params:,} "
          f"parameters, {model.param_dtype}, f32 moments): {WHISPER_STEPS} "
          f"steps of "
          f"{WHISPER_TRAIN[5]} x {WHISPER_TRAIN[3]} tokens in "
          f"{WHISPER_TRAIN[7]} microbatches, {wall:.2f} s with "
          f"checkpoints, peak memory {peak:.2f} GiB; s a step "
          + ", ".join(f"{r['seconds']:.3f}" for r in log)
          + "; losses " + ", ".join(f"{r['loss']:.6f}" for r in log))
    check_train_launches("the whisper run",
                         launches, train_launches(model,
                                                  2 * WHISPER_STEPS))
    # a checkpoint at the last step would be the one resumed from
    shutil.rmtree(ckpt / f"step_{WHISPER_STEPS}", ignore_errors=True)
    again, t0 = [], time.perf_counter()
    del_params = train_mod.main(argv + ["--ckpt-every", "1000", "--resume"],
                                log=again)
    del del_params
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)
    first = log[WHISPER_CKPT_EVERY:]
    rel = max(max(abs(a[k] / b[k] - 1) for k in ("loss", "grad_norm"))
              for a, b in zip(again, first))
    bit = all(a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
              for a, b in zip(again, first))
    print(f"  resumed at step {WHISPER_CKPT_EVERY} ({time.perf_counter() - t0:.2f} s "
          f"with the restore): steps "
          f"{[r['step'] + 1 for r in again]} losses "
          + ", ".join(f"{r['loss']:.6f}" for r in again)
          + f"; largest relative gap to the first run {rel:.3g} "
          f"(tolerance {RESUME_REL}), bit-equal {bit}")
    if [r["step"] for r in again] != [r["step"] for r in first] \
            or not rel <= RESUME_REL:
        raise AssertionError(f"the resumed whisper run differs: {again} "
                             f"against {first}")
    return launches


def lost_second_moments(opt) -> int:
    """Entries of int8 moments whose nu code is 0 while their mu code is
    not: the codec's row-wise rounding dropped their second moment and
    kept their first."""
    from repro_torch.tree_util import leaves_with_path

    mu, nu = dict(leaves_with_path(opt.mu)), dict(leaves_with_path(opt.nu))
    return sum(int(((nu[k] == 0) & (mu[k] != 0)).sum()) for k in mu
               if k.endswith("/codes"))


def qwen2_run(dev, kern, moment_dtype: str):
    """QWEN_STEPS steps of qwen2-7b at published width, 2 layers, through
    `make_train_step` with `moment_dtype`, from the weights of seed 0 and
    the pipeline's first batches; counts zeroed just before the steps and
    read just after. Returns (params, opt state, step, batch function, the
    report)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree_util import leaves_with_path

    model = dataclasses.replace(get_arch("qwen2-7b").model,
                                n_layers=QWEN_TRAIN_LAYERS)
    params = lm.init_params(model, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    opt = adamw_init(params, moment_dtype=moment_dtype)
    step = steps_mod.make_train_step(
        model, AdamWConfig(lr=TRAIN_LR, weight_decay=0.1),
        moment_dtype=moment_dtype)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=model.vocab_size, seq_len=QWEN_SEQ,
        global_batch=QWEN_MB))

    def batch():
        return {"tokens": torch.from_numpy(np.stack(
            [pipe.batch() for _ in range(QWEN_ACCUM)])).to(dev)}

    n_params = sum(t.numel() for _, t in leaves_with_path(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, secs, lost = [], [], []
    zeroed(kern)
    with CallTimer(steps_mod, "clip_by_global_norm", "adamw_update") as ct:
        for _ in range(QWEN_STEPS):
            b = batch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            rows.append((float(m["loss"]), float(m["grad_norm"])))
            if moment_dtype == "int8":
                lost.append(lost_second_moments(opt))
    launches = read(kern)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = [1e3 * t for t in secs]
    clip_ms = 1e3 * ct.s["clip_by_global_norm"] / QWEN_STEPS
    upd_ms = 1e3 * ct.s["adamw_update"] / QWEN_STEPS
    print(f"qwen2-7b at published width, {QWEN_TRAIN_LAYERS} layers "
          f"({n_params:,} parameters, {model.param_dtype}, {moment_dtype} "
          f"moments): {QWEN_STEPS} "
          f"steps of {QWEN_ACCUM} x {QWEN_MB} x {QWEN_SEQ} tokens, ms a step "
          + ", ".join(f"{t:.2f}" for t in ms)
          + f" (median of the last {QWEN_STEPS - 1}: "
          f"{float(np.median(ms[1:])):.2f}); a step's clip {clip_ms:.2f} ms "
          f"and AdamW update {upd_ms:.2f} ms (synchronised, averaged), the "
          f"rest forward and backward; peak memory {peak:.2f} GiB; loss, "
          f"grad norm " + "; ".join(f"{l:.6f}, {g:.4f}" for l, g in rows))
    if lost:
        print(f"  entries whose second moment's code is 0 while the first "
              f"moment's is not, after each step: "
              + ", ".join(f"{n:,}" for n in lost)
              + f" of {n_params:,} (the next update divides their first "
              f"moment by that step's |g| alone, or by eps)")
    if not all(np.isfinite(v) for r in rows for v in r):
        raise AssertionError(f"qwen2-7b training ({moment_dtype} moments) "
                             f"gave non-finite values: {rows}")
    check_train_launches(f"the qwen2-7b steps ({moment_dtype} moments)",
                         launches,
                         train_launches(model, QWEN_ACCUM * QWEN_STEPS))
    return params, opt, step, batch, dict(rows=rows, launches=launches)


def profile_attention(label: str, fn):
    """`profile` of a train step `fn`, then kernel 6's forward (the
    kernels of every route) and its backward's three kernels in it: device
    ms, launches, share of the step's device time. Fails if the wrapper
    counted forward launches in the step and the profile shows none."""
    from repro_torch.kernels.flash_attention_kernel import (
        flash_attention_cuda,
    )

    before = flash_attention_cuda.launches
    busy, by_name, stats = profile(label, fn)
    counted = flash_attention_cuda.launches - before
    for parts, what in ((FLASH_FORWARD, "forward kernel"),
                        (("bwd_dkdv",), "backward dK/dV"),
                        (("bwd_dq",), "backward dQ"),
                        (("bwd_delta",), "backward D")):
        n, t = by_name_sum(by_name, *parts)
        print(f"  {what}: {t:.3f} ms over {n} launches, "
              f"{100.0 * t / busy:.1f} % of the step's device time")
    if counted and not by_name_sum(by_name, *FLASH_FORWARD)[0]:
        raise AssertionError(f"{label}: {counted} forward launches counted, "
                             "none of them profiled under a forward "
                             f"kernel's name {FLASH_FORWARD}")
    return busy, by_name, stats


def profile_whisper(dev):
    """One whisper-large-v3 train step at (a)'s config (the seed-0 weights,
    the pipeline's first batch), profiled after one unprofiled step: where
    the step's device time goes, the attention kernels' share of it."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_batch_fn
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init

    spec = get_arch("whisper-large-v3")
    model = spec.model
    seq, accum = int(WHISPER_TRAIN[3]), int(WHISPER_TRAIN[7])
    mb = int(WHISPER_TRAIN[5]) // accum
    params = lm.init_params(model, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    opt = adamw_init(params, moment_dtype=spec.moment_dtype)
    step = make_train_step(model, AdamWConfig(lr=TRAIN_LR, weight_decay=0.1),
                           moment_dtype=spec.moment_dtype)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=model.vocab_size, seq_len=seq, global_batch=mb, seed=0))
    b = build_batch_fn(model, pipe, accum, mb, dev)()
    params, opt, _ = step(params, opt, b)
    profile_attention(f"whisper-large-v3 train step ({accum} x {mb} x "
                      f"{seq} tokens)", lambda: step(params, opt, b))
    del params, opt, step, b
    gc.collect()
    torch.cuda.empty_cache()


def train_qwen2(dev, kern):
    """(b): `qwen2_run` with int8 moments (the run whose launches count),
    one more step of it profiled for the kernels' device time; then the
    same steps with f32 moments from the same weights and batches, a
    witness for the int8 run's loss curve. Returns the int8 run's
    launches."""
    import gc

    params, opt, step, batch, int8 = qwen2_run(dev, kern, "int8")
    b = batch()
    profile_attention("qwen2-7b 2-layer train step",
                      lambda: step(params, opt, b))
    del params, opt, step, b
    gc.collect()
    torch.cuda.empty_cache()
    f32 = qwen2_run(dev, kern, "float32")[4]
    gc.collect()
    torch.cuda.empty_cache()
    print("  int8 against f32 moments, same weights and batches: relative "
          "gap of the loss, grad norm by step " + "; ".join(
              f"{abs(a[0] / c[0] - 1):.3g}, {abs(a[1] / c[1] - 1):.3g}"
              for a, c in zip(int8["rows"], f32["rows"])))
    return int8["launches"]


def train_int8_card_vs_cpu(dev):
    """(c) with int8 moments: qwen2-7b's smoke config in float32, the same
    weights and batches on the card and the CPU, INT8_STEPS
    `make_train_step` steps. Each step's loss and grad norm within 1e-5
    relative. After the last step, for every leaf of mu and nu: the row
    scales within 1e-5 of the leaf's largest, and the encoded values
    (codes times scale) within 1e-5 of the leaf's largest plus one code
    step (a rounding tie that 1e-5 moves flips a code by one); the share
    of codes that differ is printed."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree_util import leaves_with_path

    cpu = torch.device("cpu")
    cfg = get_arch(INT8_ARCH).smoke
    rng = np.random.default_rng(37)
    batches = []
    for _ in range(INT8_STEPS):
        parts = [item8_batch(cfg, rng, SMOKE_MB, SMOKE_SEQ)
                 for _ in range(SMOKE_ACCUM)]
        batches.append({k: torch.from_numpy(np.stack([p[k] for p in parts]))
                        for k in parts[0]})
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, weight_decay=0.1),
                           moment_dtype="int8")
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), device=cpu)
    runs = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        p = to_device(p_cpu, d)
        o = adamw_init(p, "int8")
        rows = []
        for b in batches:
            p, o, m = step(p, o, to_device(b, d))
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        runs[where] = (rows, o)
    (rows_d, od), (rows_c, oc) = runs["card"], runs["cpu"]
    rel = max(abs(a / c - 1) for rd, rc in zip(rows_d, rows_c)
              for a, c in zip(rd, rc))
    worst_s, worst_y, n_diff, n_codes, max_dc = 0.0, 0.0, 0, 0, 0
    for name, md, mc in (("mu", od.mu, oc.mu), ("nu", od.nu, oc.nu)):
        got = {k: t.cpu() for k, t in leaves_with_path(md)}
        want = dict(leaves_with_path(mc))
        if got.keys() != want.keys() or not all(
                k.endswith(("/codes", "/scale")) for k in got):
            raise AssertionError(f"{name} is not int8 throughout: "
                                 f"{sorted(got)[:4]}")
        for path in (k for k in got if k.endswith("/codes")):
            sp = path[:-len("codes")] + "scale"
            cd, cc, sd, sc = got[path], want[path], got[sp], want[sp]
            worst_s = max(worst_s, float((sd - sc).abs().max()
                                         / sc.abs().max()))
            yd, yc = cd.float() * sd, cc.float() * sc
            slack = (yd - yc).abs() - (sd + sc) / 2
            worst_y = max(worst_y, float(slack.max() / yc.abs().max()))
            dc = (cd.int() - cc.int()).abs()
            n_diff += int((dc > 0).sum())
            n_codes += dc.numel()
            max_dc = max(max_dc, int(dc.max()))
    print(f"{INT8_ARCH} smoke, int8 moments, {INT8_STEPS} steps card vs "
          f"CPU: loss, grad norm by step "
          + "; ".join(f"{a[0]:.6f}, {a[1]:.6f}" for a in rows_d)
          + f" (largest relative gap {rel:.3g}); mu and nu after the last "
          f"step: scales max |diff| / leaf max {worst_s:.3g}, encoded "
          f"values beyond one code step max / leaf max {worst_y:.3g}, "
          f"codes differing {n_diff} of {n_codes} (max by {max_dc})")
    if not (rel <= 1e-5 and worst_s <= 1e-5 and worst_y <= 1e-5):
        raise AssertionError(f"{INT8_ARCH}: the card's int8-moment steps "
                             f"differ from the CPU's: {rel}, {worst_s}, "
                             f"{worst_y}")


def cpu_moment_spread(step, params, batch, mu):
    """{leaf: the largest change of its first moment over its largest
    entry} that SENS_DRAWS draws of SENS_REL relative weight noise make
    in one CPU `step` from `params`, whose own step gave `mu`: what
    float32 rounding alone moves them, as
    `scripts/torch_train_grad_sensitivity.py` measures it."""
    from repro_torch.optim import adamw_init
    from repro_torch.tree_util import leaves_with_path, tree_map

    gen = torch.Generator().manual_seed(1)
    base = dict(leaves_with_path(mu))
    spread = dict.fromkeys(base, 0.0)
    for _ in range(SENS_DRAWS):
        p = tree_map(lambda t: t * (1 + SENS_REL * torch.randn(
            t.shape, generator=gen)), params)
        got = dict(leaves_with_path(step(p, adamw_init(p, "float32"),
                                         batch)[1].mu))
        for k, t in base.items():
            spread[k] = max(spread[k], float((got[k] - t).abs().max()
                                             / t.abs().max()))
    return spread


def train_step_card_vs_cpu(dev, kern, arch: str):
    """(c) for one arch: its smoke config in float32, the same weights and
    batch (SMOKE_ACCUM microbatches) on the card and the CPU, one
    `make_train_step` step, held as `tests/test_torch_train_lm.py` holds
    it against the reference: the microbatch losses (forward only), the
    step's loss and grad norm within 1e-5 relative; the first moments
    (0.1 times the clipped gradient) within 1e-5 of their largest entry;
    every parameter after the update within 1e-5 where the CPU's gradient
    exceeds 100 eps (a first AdamW step divides the rounding of a
    near-zero gradient by eps). MoE archs and xlstm: the losses as
    `workloads.lm.losses_agree` says, since a top-2 expert choice or an
    xLSTM cell's max stabilizer makes the gradient discontinuous at
    float32 rounding (`scripts/torch_train_grad_sensitivity.py`); their
    first moments leaf by leaf (the largest gap over the leaf's largest
    entry), the MoE archs' by `losses_agree`'s rule, xlstm's each within
    `cpu_moment_spread`'s bound (one ulp of weight noise moves its
    mLSTM gate bias's moments 3.5e-3 on the CPU alone). The MoE archs'
    parameters ride on those moments. Kernel 6 and its backward once per
    attention call per microbatch. Returns the largest gaps."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree_util import leaves_with_path
    from repro_torch.workloads.lm import FLIP_FAR, FLIP_NEAR, losses_agree

    cpu = torch.device("cpu")
    cfg = get_arch(arch).smoke
    flips = cfg.moe is not None or cfg.pattern == "xlstm"
    rng = np.random.default_rng(31)
    parts = [item8_batch(cfg, rng, SMOKE_MB, SMOKE_SEQ)
             for _ in range(SMOKE_ACCUM)]
    b_cpu = {k: torch.from_numpy(np.stack([p[k] for p in parts]))
             for k in parts[0]}
    b_dev = to_device(b_cpu, dev)
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), device=cpu)
    p_dev = to_device(p_cpu, dev)
    ocfg = AdamWConfig(lr=TRAIN_LR, weight_decay=0.1)
    step = make_train_step(cfg, ocfg, moment_dtype="float32")
    with torch.no_grad():
        mb = lambda p, b: [float(lm.loss_fn(  # noqa: E731
            p, {k: v[a] for k, v in b.items()}, cfg)[0])
            for a in range(SMOKE_ACCUM)]
        l_dev, l_cpu = mb(p_dev, b_dev), mb(p_cpu, b_cpu)
    zeroed(kern)
    pd, od, md = step(p_dev, adamw_init(p_dev, "float32"), b_dev)
    launches = read(kern)
    pc, oc, mc = step(p_cpu, adamw_init(p_cpu, "float32"), b_cpu)
    got = l_dev + [float(md["loss"]), float(md["grad_norm"])]
    want = l_cpu + [float(mc["loss"]), float(mc["grad_norm"])]
    ok, rel = losses_agree(got, want)
    if not flips:
        ok = bool(rel.max() <= 1e-5)
    mu_c = dict(leaves_with_path(oc.mu))
    mu_gap = {k: float((t.cpu() - mu_c[k]).abs().max())
              for k, t in leaves_with_path(od.mu)}
    top = {k: float(t.abs().max()) for k, t in mu_c.items()}
    if mu_gap.keys() != top.keys():
        raise AssertionError(f"{arch}: the moment trees differ")
    if flips:
        by_leaf = {k: mu_gap[k] / top[k] if top[k] else
                   (0.0 if mu_gap[k] == 0 else np.inf) for k in top}
        leaf_rel = np.array(list(by_leaf.values()))
        mu_ok = bool(leaf_rel.max() <= FLIP_FAR and (
            leaf_rel <= FLIP_NEAR).sum() >= -(-3 * leaf_rel.size // 4))
        mu_read = (f"first moments by leaf, max |diff| / leaf max: "
                   f"{int((leaf_rel <= FLIP_NEAR).sum())} of "
                   f"{leaf_rel.size} within {FLIP_NEAR}, largest "
                   f"{leaf_rel.max():.3g}")
        worst_mu = float(leaf_rel.max())
        if cfg.pattern == "xlstm":
            spread = cpu_moment_spread(step, p_cpu, b_cpu, oc.mu)
            ratio = {k: v / max(FLIP_NEAR, 2 * spread[k])
                     for k, v in by_leaf.items()}
            w = max(ratio, key=ratio.get)
            mu_ok = ratio[w] <= 1.0
            mu_read += (f"; against max({FLIP_NEAR}, 2 x the CPU's own "
                        f"change under {SENS_REL:g} weight noise) at most "
                        f"{ratio[w]:.3g} of it ({w}: {by_leaf[w]:.3g}, "
                        f"the CPU's {spread[w]:.3g})")
    else:
        worst_mu = max(mu_gap.values()) / max(top.values())
        mu_ok = worst_mu <= 1e-5
        mu_read = (f"first moments max |diff| / max {worst_mu:.3g}")
    worst_p, p_read = 0.0, "not held (MoE)"
    if cfg.moe is None:
        pc_by = dict(leaves_with_path(pc))
        for path, t in leaves_with_path(pd):
            gap = (t.cpu() - pc_by[path]).abs()
            steady = mu_c[path].abs() / (1 - ocfg.b1) > 100 * ocfg.eps
            worst_p = max(worst_p,
                          float(torch.where(steady, gap, 0.0).max()))
        p_read = f"{worst_p:.3g} where |g| > 100 eps"
    p_ok = worst_p <= 1e-5
    want_l = train_launches(cfg, SMOKE_ACCUM)
    lok = all(launches[n] == v for n, v in want_l.items())
    print(f"{arch} smoke train step, float32 card vs CPU: relative gaps "
          f"(microbatch losses, loss, grad norm) "
          + ", ".join(f"{r:.2g}" for r in rel)
          + f"; {mu_read}; parameters max |diff| {p_read}; launches "
          + ", ".join(f"{n} {launches[n]}" for n in want_l))
    if not (ok and mu_ok and p_ok and lok):
        raise AssertionError(f"{arch}: the card's train step differs from "
                             f"the CPU's: {rel}, moments {worst_mu}, "
                             f"parameters {worst_p}, launches {launches}, "
                             f"want {want_l}")
    return {"rel": float(rel.max()), "mu": worst_mu, "params": worst_p}


def train_phase(dev, kern):
    """Phase 13: (d) the backward kernel's checks and times, (a) whisper
    and one of its steps profiled, (b) qwen2-7b, (c) the ten smoke
    configs card vs CPU and the int8 moments card vs CPU. Returns (the
    backward's kernels entry, {run: launches})."""
    from repro_torch.configs import ARCH_IDS

    t0 = time.perf_counter()
    bwd_entry = phase_flash_backward(dev)
    print(f"  backward kernel checks: {time.perf_counter() - t0:.2f} s")
    runs = {"train_whisper": train_whisper(dev, kern)}
    profile_whisper(dev)
    runs["train_qwen2"] = train_qwen2(dev, kern)
    t1 = time.perf_counter()
    for arch in ARCH_IDS:
        train_step_card_vs_cpu(dev, kern, arch)
    train_int8_card_vs_cpu(dev)
    print(f"  smoke train steps card vs CPU: {time.perf_counter() - t1:.2f} s")
    print(f"phase 13 (LM training): {time.perf_counter() - t0:.2f} s")
    return bwd_entry, runs


# Phase 14: the train step placed over a one-rank NCCL mesh (1, 1), the
# placed path itself (DTensor parameters and moments, each layer's
# weights gathered where it uses them by `gather_on_use` inside its
# rematerialised period, Megatron's operators over `model`, the
# redistribution of the gradients onto the accumulator's blocks, the norm
# and the int8 row scales reduced over the mesh), held bit-equal to the
# unplaced step:
# phase 13's (b) at f32 moments (PLACED_STEPS steps, the first one's
# state compared, the median of the others timed, one more profiled), then
# INT8_STEPS steps of qwen2-7b's smoke config with int8 moments and a
# placed checkpoint restored unplaced; then phase 13's (b) with int8
# moments, PLACED_STEPS steps with `remat` on and off: ms a step, peak
# memory, the metrics compared; and one microbatch's forward and backward
# of it and of whisper-large-v3, remat on and off: the memory they add.
PLACED_STEPS = 3


def same_bits(label, got, want) -> None:
    """Every leaf of `got` (placed or not; gathered to the host one leaf
    at a time) bit-equal to the host tree `want`."""
    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.tree_util import leaves_with_path

    w = dict(leaves_with_path(want))
    g = leaves_with_path(got)
    if [k for k, _ in g] != list(w):
        raise AssertionError(f"{label}: the trees differ")
    bad = [k for k, t in g if not torch.equal(full_tensor(t).cpu(), w[k])]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} leaves differ, "
                             f"{bad[:4]}")


def placed_state(model, mesh, moment_dtype, params):
    """(placed params, placed zero moments, the step) from whole
    `params`, by the pruned specs of `mesh`."""
    from repro_torch.distributed.sharding import (
        ShardingConfig,
        blocks,
        from_blocks,
        named,
        param_pspecs,
        place,
    )
    from repro_torch.launch.steps import make_train_step, opt_state_pspecs
    from repro_torch.optim import AdamWConfig, adamw_init

    pspec = param_pspecs(params, ShardingConfig(), mesh)
    p = place(params, named(mesh, pspec))
    o = from_blocks(adamw_init(blocks(p), moment_dtype),
                    named(mesh, opt_state_pspecs(pspec, moment_dtype)))
    step = make_train_step(model, AdamWConfig(lr=TRAIN_LR, weight_decay=0.1),
                           moment_dtype=moment_dtype, grad_pspecs=pspec,
                           mesh=mesh)
    return p, o, step


def collective_time(by_name, annotations):
    """(device ms, events) of the profiled NCCL ranges (annotations that
    span the collectives' kernels or copies) and of the device-to-device
    copies (a one-rank NCCL collective moves its data as one)."""
    nccl = [v for n, v in {**by_name, **annotations}.items()
            if "nccl" in n.lower()]
    copies = [v for n, v in by_name.items() if "dtod" in n.lower()]
    return (sum(t for _, t in nccl), sum(n for n, _ in nccl),
            sum(t for _, t in copies), sum(n for n, _ in copies))


class PlacedCalls:
    """Counts the calls of the placed path's model-side collectives
    (`gather_on_use`, and `Placement`'s operators over `model`) while
    active; at one rank each returns its input and moves nothing."""
    NAMES = ("copy_to_model", "reduce_from_model", "sum_over_model",
             "gather_model")

    def __enter__(self):
        from repro_torch.distributed import sharding

        self.mod, self.n = sharding, {"gather_on_use": 0}
        self.saved = [(sharding, "gather_on_use",
                       sharding.gather_on_use)] + [
            (sharding.Placement, n, getattr(sharding.Placement, n))
            for n in self.NAMES]
        for owner, name, fn in self.saved:
            self.n[name] = 0

            def counted(*a, _fn=fn, _name=name, **kw):
                self.n[_name] += 1
                return _fn(*a, **kw)

            setattr(owner, name, counted)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def run_steps(step, state, batches, first=None):
    """`step` over `batches` from `state`, a list [params, opt state]
    that it empties, so that the first step's inputs are freed as the
    step replaces them, as in a training loop; `first(p, o)` after the
    first step. Returns (params, opt state, [(loss, grad norm)], ms a
    step, peak GiB)."""
    p, o = state
    state.clear()
    torch.cuda.reset_peak_memory_stats()
    rows, ms = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step(p, o, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        rows.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0 and first is not None:
            first(p, o)
    return p, o, rows, ms, torch.cuda.max_memory_allocated() / 2 ** 30


def placed_qwen2(dev, kern, mesh):
    """qwen2-7b at published width cut to 2 layers, f32 moments, phase
    13's batches: PLACED_STEPS unplaced steps, the first step's state to
    the host; the same steps placed over `mesh`, counts zeroed around
    them; the first step's state and every step's loss and grad norm
    bit-equal. Prints each way's ms a step (the median after the first)
    and peak memory, and one more step each way profiled: device time,
    and the placed one's collectives. Returns the placed steps'
    launches."""
    import gc

    from repro_torch.checkpoint.checkpoint import to_host
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels.backend import power_limit
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init

    model = dataclasses.replace(get_arch("qwen2-7b").model,
                                n_layers=QWEN_TRAIN_LAYERS)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=model.vocab_size, seq_len=QWEN_SEQ,
        global_batch=QWEN_MB))
    batches = [{"tokens": torch.from_numpy(np.stack(
        [pipe.batch() for _ in range(QWEN_ACCUM)])).to(dev)}
        for _ in range(PLACED_STEPS)]
    weights = lambda: lm.init_params(  # noqa: E731
        model, torch.Generator(device=dev).manual_seed(0), device=dev)
    held = {}
    state = [weights()]
    state.append(adamw_init(state[0], "float32"))
    step = make_train_step(model, AdamWConfig(lr=TRAIN_LR, weight_decay=0.1),
                           moment_dtype="float32")
    p, o, rows_u, ms_u, peak_u = run_steps(
        step, state, batches, lambda p, o: held.update(s=to_host((p, o))))
    busy_u = profile("unplaced qwen2-7b 2-layer train step",
                     lambda: step(p, o, batches[0]))[0]
    del p, o, step
    gc.collect()
    torch.cuda.empty_cache()

    *state, step = placed_state(model, mesh, "float32", weights())
    zeroed(kern)
    with PlacedCalls() as calls:
        p, o, rows_p, ms_p, peak_p = run_steps(
            step, state, batches, lambda p, o: same_bits(
                "the placed qwen2-7b step", (p, o), held.pop("s")))
    launches = read(kern)
    print(f"  the placed steps' model-side calls: "
          + ", ".join(f"{n} {v}" for n, v in calls.n.items())
          + f" ({model.remat=}: each period's gathers run again in its "
          f"backward)")
    if not calls.n["gather_on_use"] or not calls.n["reduce_from_model"]:
        raise AssertionError(f"the placed step did not gather on use or "
                             f"reduce over model: {calls.n}")
    print(f"qwen2-7b at published width, {QWEN_TRAIN_LAYERS} layers, f32 "
          f"moments, placed over a one-rank NCCL mesh {mesh.shape}: "
          f"{PLACED_STEPS} steps of {QWEN_ACCUM} x {QWEN_MB} x {QWEN_SEQ} "
          f"tokens, ms a step placed " + ", ".join(f"{t:.2f}" for t in ms_p)
          + f" (median after the first {float(np.median(ms_p[1:])):.2f}, "
          f"peak {peak_p:.2f} GiB), unplaced "
          + ", ".join(f"{t:.2f}" for t in ms_u)
          + f" (median after the first {float(np.median(ms_u[1:])):.2f}, "
          f"peak {peak_u:.2f} GiB)"
          + "; loss, grad norm " + "; ".join(
              f"{l:.6f}, {g:.4f}" for l, g in rows_p)
          + "; the first step's parameters and moments bit-equal "
          f"({power_limit()})")
    if rows_p != rows_u:
        raise AssertionError(f"the placed steps' metrics differ: {rows_p} "
                             f"against {rows_u}")
    check_train_launches("the placed qwen2-7b steps", launches,
                         train_launches(model, QWEN_ACCUM * PLACED_STEPS))
    busy, by_name, stats = profile_attention(
        "placed qwen2-7b 2-layer train step", lambda: step(p, o, batches[0]))
    t_n, n_n, t_c, n_c = collective_time(by_name, stats["annotations"])
    print(f"  collectives: NCCL ranges {t_n:.3f} ms over {n_n} events, "
          f"device-to-device copies {t_c:.3f} ms over {n_c} events "
          f"({100.0 * t_c / busy:.1f} % of the step's device time); "
          f"device time placed {busy:.2f} ms, unplaced {busy_u:.2f} ms")
    del p, o, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def placed_smoke_int8(dev, mesh, tmp):
    """qwen2-7b's smoke config with int8 moments, INT8_STEPS steps of
    SMOKE batches placed over `mesh` and unplaced on the card: metrics,
    parameters, codes and scales bit-equal. Then the placed state is
    saved (`CheckpointManager`, rank 0 writes), restored unplaced
    (`launch.train.restore_state`) and held bit-equal to it."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.checkpoint import to_host
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import checkpoint_state, restore_state
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_arch(INT8_ARCH).smoke
    rng = np.random.default_rng(41)
    batches = []
    for _ in range(INT8_STEPS):
        parts = [item8_batch(cfg, rng, SMOKE_MB, SMOKE_SEQ)
                 for _ in range(SMOKE_ACCUM)]
        batches.append({k: torch.from_numpy(np.stack([q[k] for q in parts]))
                        .to(dev) for k in parts[0]})
    weights = lambda: lm.init_params(  # noqa: E731
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    p = weights()
    o = adamw_init(p, "int8")
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, weight_decay=0.1),
                           moment_dtype="int8")
    rows_u, rows_p = [], []
    for b in batches:
        p, o, m = step(p, o, b)
        rows_u.append((float(m["loss"]), float(m["grad_norm"])))
    want = to_host((p, o))
    p, o, step = placed_state(cfg, mesh, "int8", weights())
    for b in batches:
        p, o, m = step(p, o, b)
        rows_p.append((float(m["loss"]), float(m["grad_norm"])))
    if rows_p != rows_u:
        raise AssertionError(f"{INT8_ARCH} smoke, int8 moments: the placed "
                             f"metrics {rows_p} differ from {rows_u}")
    same_bits(f"{INT8_ARCH} smoke placed, int8 moments", (p, o), want)
    ckpt = Path(tmp) / "placed_ckpt"
    mgr = CheckpointManager(ckpt, async_write=True)
    mgr.save(INT8_STEPS, checkpoint_state(p, o, cfg),
             {"train_step": INT8_STEPS})
    mgr.close()
    like_o = adamw_init(weights(), "int8")
    (rp, ro), extra = restore_state(ckpt, weights(), like_o, cfg, dev)
    if extra != {"train_step": INT8_STEPS}:
        raise AssertionError(f"the placed checkpoint's extra: {extra}")
    same_bits("the placed checkpoint restored unplaced", (rp, ro), want)
    print(f"{INT8_ARCH} smoke, int8 moments, {INT8_STEPS} steps placed over "
          f"{mesh.shape} and unplaced on the card: loss, grad norm "
          + "; ".join(f"{l:.6f}, {g:.6f}" for l, g in rows_p)
          + "; parameters, codes and scales bit-equal; the placed "
          "checkpoint restored unplaced bit-equal")


def remat_qwen2(dev):
    """Phase 13's (b) with int8 moments, PLACED_STEPS unplaced steps from
    the seed-0 weights with `ModelConfig.remat` on (the configs' default,
    as in the reference) and off, the same batches: ms a step (the median
    after the first), peak memory, the loss and grad norm of each step.
    Fails unless every metric is finite and the two agree within 1e-3
    relative; prints whether they are bit-equal and the largest gap."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels.backend import power_limit
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init

    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=get_arch("qwen2-7b").model.vocab_size, seq_len=QWEN_SEQ,
        global_batch=QWEN_MB))
    batches = [{"tokens": torch.from_numpy(np.stack(
        [pipe.batch() for _ in range(QWEN_ACCUM)])).to(dev)}
        for _ in range(PLACED_STEPS)]
    out = {}
    for remat in (True, False):
        model = dataclasses.replace(get_arch("qwen2-7b").model,
                                    n_layers=QWEN_TRAIN_LAYERS, remat=remat)
        p = lm.init_params(model, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        o = adamw_init(p, "int8")
        step = make_train_step(model, AdamWConfig(lr=TRAIN_LR,
                                                  weight_decay=0.1),
                               moment_dtype="int8")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows, ms = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = step(p, o, b)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        out[remat] = (rows, ms, torch.cuda.max_memory_allocated() / 2 ** 30)
        del p, o, step
        gc.collect()
        torch.cuda.empty_cache()
    (r_on, ms_on, pk_on), (r_off, ms_off, pk_off) = out[True], out[False]
    gap = max(abs(a / b - 1) for x, y in zip(r_on, r_off)
              for a, b in zip(x, y))
    print(f"qwen2-7b at published width, {QWEN_TRAIN_LAYERS} layers, int8 "
          f"moments, {PLACED_STEPS} steps of {QWEN_ACCUM} x {QWEN_MB} x "
          f"{QWEN_SEQ} tokens: remat on ms a step "
          + ", ".join(f"{t:.2f}" for t in ms_on)
          + f" (median after the first {float(np.median(ms_on[1:])):.2f}), "
          f"peak {pk_on:.2f} GiB; remat off "
          + ", ".join(f"{t:.2f}" for t in ms_off)
          + f" (median after the first {float(np.median(ms_off[1:])):.2f}), "
          f"peak {pk_off:.2f} GiB; loss, grad norm on "
          + "; ".join(f"{l:.6f}, {g:.4f}" for l, g in r_on) + ", off "
          + "; ".join(f"{l:.6f}, {g:.4f}" for l, g in r_off)
          + f"; bit-equal {r_on == r_off}, largest relative gap {gap:.3g} "
          f"({power_limit()})")
    if not all(np.isfinite(v) for r in r_on + r_off for v in r) \
            or not gap <= 1e-3:
        raise AssertionError(f"remat on and off disagree: {r_on} against "
                             f"{r_off}")


def remat_backward_peaks(dev):
    """One microbatch's `loss_fn` and autograd gradient, remat on and off,
    from the seed-0 weights: qwen2-7b at 2 layers (QWEN_MB x QWEN_SEQ
    tokens) and whisper-large-v3 at full depth (phase 13's microbatch:
    4 x 128 tokens beside 1,500 zero frames). Prints the memory the
    forward and backward add over the resident weights at their peak,
    and their ms (synchronised, the second of two calls). The optimizer
    plays no part: this is the activations' share that remat moves."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels.backend import power_limit
    from repro_torch.launch.train import build_batch_fn
    from repro_torch.models import lm
    from repro_torch.tree_util import leaves_with_path, map_with_path

    seq, accum = int(WHISPER_TRAIN[3]), int(WHISPER_TRAIN[7])
    runs = (("qwen2-7b", dataclasses.replace(
        get_arch("qwen2-7b").model, n_layers=QWEN_TRAIN_LAYERS), QWEN_MB,
        QWEN_SEQ), ("whisper-large-v3", get_arch("whisper-large-v3").model,
                    int(WHISPER_TRAIN[5]) // accum, seq))
    for arch, model, mb, s in runs:
        params = lm.init_params(model, torch.Generator(
            device=dev).manual_seed(0), device=dev)
        b = build_batch_fn(model, TokenPipeline(TokenPipelineConfig(
            vocab_size=model.vocab_size, seq_len=s, global_batch=mb,
            seed=0)), 1, mb, dev)()
        mbatch = {k: v[0] for k, v in b.items()}
        got = {}
        for remat in (True, False):
            cfg = dataclasses.replace(model, remat=remat)

            def once():
                live = map_with_path(
                    lambda _, t: t.detach().requires_grad_(True), params)
                loss, _ = lm.loss_fn(live, mbatch, cfg)
                torch.autograd.grad(loss, [t for _, t in
                                           leaves_with_path(live)])
                return float(loss.detach())

            once()
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = once()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            got[remat] = (loss, ms, (torch.cuda.max_memory_allocated()
                                     - base) / 2 ** 30)
        (l_on, ms_on, gb_on), (l_off, ms_off, gb_off) = got[True], got[False]
        print(f"{arch} ({model.n_layers} layers), one microbatch of {mb} x "
              f"{s} tokens, forward and backward: remat on adds "
              f"{gb_on:.2f} GiB over the resident weights at its peak in "
              f"{ms_on:.2f} ms, off {gb_off:.2f} GiB in {ms_off:.2f} ms; "
              f"loss {l_on:.6f} / {l_off:.6f} ({power_limit()})")
        if not (np.isfinite(l_on) and abs(l_on / l_off - 1) <= 1e-3):
            raise AssertionError(f"{arch}: remat on and off give the losses "
                                 f"{l_on} and {l_off}")
        del params, b, mbatch
        gc.collect()
        torch.cuda.empty_cache()


# The Mamba and xLSTM mixers on the placed path, split over
# `model` by their inner channels and heads (at one rank every cut keeps
# the whole leaf and every operator over `model` returns its input):
# xlstm-350m at full width and depth (bf16, f32 moments) and
# jamba-v0.1-52b at published widths cut to its first two layers, both
# Mamba (layer 0 with the dense SwiGLU FFN, layer 1 with the 16-expert
# MoE: ~3.7 B parameters; bf16, int8 moments: f32 moments need ~30 GB
# more, and the update keeps the old and new moments alive at once).
# (arch, layers (None: all), moment dtype, sequences, positions) of the
# one microbatch of each of MIXER_STEPS steps. xlstm's step is host-bound
# by the sLSTM's cell steps (169k device events a step at 4 x 128, which
# the profiler took ~90 s to read), hence its 32 positions.
MIXER_RUNS = (("xlstm-350m", None, "float32", 4, 32),
              ("jamba-v0.1-52b", 2, "int8", 2, 256))
MIXER_STEPS = 2


class MixerRanges:
    """While active, each mixer part in PARTS runs inside a
    `torch.profiler.record_function` range of its label, so that
    `profile` reads the device time of the kernels its calls ran (the
    forward and the checkpoint's recompute; backward runs outside
    them)."""
    PARTS = (("ssm", "_causal_conv", "Mamba conv"),
             ("ssm", "_selective_scan_chunked", "Mamba scan"),
             ("xlstm_blocks", "mlstm_forward", "mLSTM mixer"),
             ("xlstm_blocks", "_slstm_scan", "sLSTM time loop"))

    def __enter__(self):
        import importlib

        self.saved = []
        for mod, name, label in self.PARTS:
            m = importlib.import_module(f"repro_torch.models.{mod}")
            fn = getattr(m, name)

            def ranged(*a, _fn=fn, _label=label, **kw):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **kw)

            self.saved.append((m, name, fn))
            setattr(m, name, ranged)
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def mixer_model(arch, layers, dev):
    """(config, a function that draws its seed-0 weights on `dev`): the
    published config, cut to its first `layers` layers where given
    (`lm.init_params` draws whole periods, jamba's 8 layers: the cut
    draws the embedding, norm and head, then each layer)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    model = get_arch(arch).model
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    if layers is None:
        return model, lambda: lm.init_params(model, gen(), device=dev)
    model = dataclasses.replace(model, n_layers=layers)

    def weights():
        g = gen()
        params = lm.init_params(dataclasses.replace(model, n_layers=0), g,
                                device=dev)
        params["blocks"] = [lm._init_block(g, model, lm._layer_kind(model, l),
                                           lm._layer_has_moe(model, l))
                            for l in range(layers)]
        return params

    return model, weights


def mixer_shares(label, busy, ranges) -> str:
    """Each MixerRanges part's device ms and share of a profiled step's
    device time `busy`."""
    return f"{label}: " + ", ".join(
        f"{name} {ranges[name][1]:.3f} ms over {ranges[name][0]} calls "
        f"({100.0 * ranges[name][1] / busy:.1f} %)"
        for _, _, name in MixerRanges.PARTS if name in ranges)


def placed_mixers(dev, kern, mesh):
    """For each of MIXER_RUNS: MIXER_STEPS unplaced steps from the seed-0
    weights (the first step's state to the host); the same steps placed
    over `mesh`, counts zeroed around them, and one more profiled. The
    first step's parameters and moments and every
    step's loss and grad norm bit-equal. Prints ms a step each way, peak
    memory, the placed steps' model-side calls (`sum_over_model`,
    Mamba's, among them), and the device time of the Mamba conv and
    scan, the mLSTM mixer and the sLSTM time loop in the profiled step
    (`MixerRanges`). No kernel of the port lies on these layers (jamba's
    two hold no attention): every count stays 0. Returns the placed
    steps' launches."""
    import gc

    from repro_torch.checkpoint.checkpoint import to_host
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels.backend import power_limit
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree_util import tree_leaves

    total = {n: 0 for n in kern}
    for arch, layers, md, mb, seq in MIXER_RUNS:
        model, weights = mixer_model(arch, layers, dev)
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab_size=model.vocab_size, seq_len=seq, global_batch=mb))
        batches = [{"tokens": torch.from_numpy(pipe.batch()[None]).to(dev)}
                   for _ in range(MIXER_STEPS)]
        held = {}
        state = [weights()]
        n_params = sum(t.numel() for t in tree_leaves(state[0]))
        state.append(adamw_init(state[0], md))
        step = make_train_step(model, AdamWConfig(lr=TRAIN_LR,
                                                  weight_decay=0.1),
                               moment_dtype=md)
        p, o, rows_u, ms_u, peak_u = run_steps(
            step, state, batches,
            lambda p, o: held.update(s=to_host((p, o))))
        del p, o, step
        gc.collect()
        torch.cuda.empty_cache()

        *state, step = placed_state(model, mesh, md, weights())
        zeroed(kern)
        with PlacedCalls() as calls:
            p, o, rows_p, ms_p, peak_p = run_steps(
                step, state, batches, lambda p, o: same_bits(
                    f"the placed {arch} step", (p, o), held.pop("s")))
        launches = read(kern)
        with MixerRanges():
            busy_p, _, st_p = profile(f"placed {arch} train step",
                                      lambda: step(p, o, batches[0]))
        print(f"{arch} ({model.n_layers} layers, d {model.d_model}, "
              f"{n_params / 1e9:.2f} B parameters, {model.dtype}, {md} "
              f"moments) placed over a one-rank NCCL mesh {mesh.shape}: "
              f"{MIXER_STEPS} steps of {mb} x {seq} tokens, ms a step "
              f"placed " + ", ".join(f"{t:.2f}" for t in ms_p)
              + f" (peak {peak_p:.2f} GiB), unplaced "
              + ", ".join(f"{t:.2f}" for t in ms_u)
              + f" (peak {peak_u:.2f} GiB); loss, grad norm "
              + "; ".join(f"{l:.6f}, {g:.4f}" for l, g in rows_p)
              + "; the first step's parameters and moments bit-equal; "
              "model-side calls " + ", ".join(f"{n} {v}" for n, v
                                              in calls.n.items())
              + f"; launches {launches} ({power_limit()})")
        print("  " + mixer_shares(f"placed step, device {busy_p:.2f} ms",
                                  busy_p, st_p["ranges"]))
        if rows_p != rows_u or not all(np.isfinite(v) for r in rows_p
                                       for v in r):
            raise AssertionError(f"{arch}: the placed steps' metrics "
                                 f"{rows_p} differ from {rows_u}")
        want = "sum_over_model" if model.pattern == "jamba" \
            else "reduce_from_model"
        if not calls.n[want] or not calls.n["copy_to_model"] \
                or any(launches.values()):
            raise AssertionError(f"{arch}: the placed mixers made the calls "
                                 f"{calls.n} and launched {launches}")
        total = {n: total[n] + launches[n] for n in total}
        del p, o, step, batches
        gc.collect()
        torch.cuda.empty_cache()
    return total


def placement_phase(dev, kern):
    """Phase 14: a one-rank NCCL process group (rendezvous through a
    `FileStore` in a temporary directory), the placed mesh (1, 1), the
    three checks above; the group is destroyed after them. Then
    `remat_qwen2` and `remat_backward_peaks`, unplaced. Returns
    {"placed": the placed qwen2-7b steps' launches, "placed_mixers": the
    placed mixers' steps'}."""
    import os
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_mesh

    t0 = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one rank: loopback
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(dev, rank=0, world_size=1,
                         store=dist.FileStore(str(Path(tmp) / "store"), 1))
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            if not mesh.placed:
                raise AssertionError("the one-rank mesh is not placed")
            launches = placed_qwen2(dev, kern, mesh)
            placed_smoke_int8(dev, mesh, tmp)
            t1 = time.perf_counter()
            mixers = placed_mixers(dev, kern, mesh)
            print(f"  placed mixers: {time.perf_counter() - t1:.2f} s")
        finally:
            dist.destroy_process_group()
    remat_qwen2(dev)
    remat_backward_peaks(dev)
    print(f"phase 14 (placement): {time.perf_counter() - t0:.2f} s")
    return {"placed": launches, "placed_mixers": mixers}


# ---------------------------------------------------------------------------
# Phase 15: the dry-run (ROADMAP item 10a) against the card.
# ---------------------------------------------------------------------------
DRY_PEAK_REL = 0.10  # predicted peak within 10 % of max_memory_allocated
DRY_TIMEOUT = 600  # seconds a dry-run child may take
# A child process traces one cell (one default process group a process:
# the dry-run's is a fake one) and prints its JSON as its last line.
_DRY_CHILD = """
import dataclasses, json, sys, tempfile
from pathlib import Path
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import dryrun

spec, shape, mesh = get_arch("qwen2-7b"), SHAPES["train_4k"], None
if sys.argv[1] == "phase14":
    layers, mb, seq, accum = map(int, sys.argv[2:6])
    spec = dataclasses.replace(
        spec, model=dataclasses.replace(spec.model, n_layers=layers),
        moment_dtype="float32", microbatch={"train_4k": mb})
    shape = dataclasses.replace(shape, seq_len=seq, global_batch=mb * accum)
    mesh = ((1, 1), ("data", "model"))
elif sys.argv[1] == "serve":  # phase 16: a one-rank prefill or decode cell
    kind, batch, seq = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    shape = dataclasses.replace(SHAPES[kind], seq_len=seq,
                                global_batch=batch)
    mesh = ((1, 1), ("data", "model"))
with tempfile.TemporaryDirectory() as tmp:
    print(json.dumps(dryrun.run_cell(spec, shape, False, Path(tmp),
                                     mesh=mesh)))
"""


def dryrun_child(*args):
    """A child process tracing one dry-run cell on the CPU (no card
    visible to it)."""
    import os
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", _DRY_CHILD, *args],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def dryrun_result(proc, label: str) -> dict:
    out, err = proc.communicate(timeout=DRY_TIMEOUT)
    if proc.returncode:
        raise AssertionError(f"the dry-run of {label} failed:\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase14_cell():
    """Phase 14's one-rank qwen2-7b step as a dry-run cell: 2 of 28
    layers, f32 moments, QWEN_ACCUM microbatches of QWEN_MB x QWEN_SEQ."""
    from repro_torch.configs import SHAPES, get_arch

    spec = get_arch("qwen2-7b")
    spec = dataclasses.replace(
        spec, model=dataclasses.replace(spec.model,
                                        n_layers=QWEN_TRAIN_LAYERS),
        moment_dtype="float32", microbatch={"train_4k": QWEN_MB})
    return spec, dataclasses.replace(SHAPES["train_4k"], seq_len=QWEN_SEQ,
                                     global_batch=QWEN_MB * QWEN_ACCUM)


def dryrun_phase(dev, kern):
    """Phase 15: (a) `launch.dryrun.run_cell` of phase 14's one-rank
    qwen2-7b step (`phase14_cell`, mesh (1, 1)) in a child process; (b)
    the same cell's step on the card (`dryrun.build_cell` over a one-rank
    NCCL mesh (1, 1), zero tokens, one warm-up step): counts zeroed
    around one step, its peak above the memory held before the cell
    (`max_memory_allocated` after `reset_peak_memory_stats`), one more
    step profiled; kernel 6's and its backward's launches predicted,
    counted and profiled, all equal; the predicted peak within
    DRY_PEAK_REL; the step's device time at or above the roofline's
    `step_time_s`, and their ratio; (c) the full cell qwen2-7b x train_4k
    x 16x16 traced in a second child meanwhile: its roofline line and
    `trace_s`. Returns {"dryrun": (b)'s launches}."""
    import gc
    import os

    import torch.distributed as dist

    from repro_torch.kernels.backend import power_limit
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_distributed, make_mesh

    t0 = time.perf_counter()
    full = dryrun_child("full")
    small = dryrun_child("phase14", str(QWEN_TRAIN_LAYERS), str(QWEN_MB),
                         str(QWEN_SEQ), str(QWEN_ACCUM))
    pred = dryrun_result(small, "phase 14's cell")
    mem = pred["memory_analysis"]
    print(f"dry-run of phase 14's cell ({pred['cell']}, traced on the CPU "
          f"in {pred['trace_s']} s): kernels {pred['kernels']}, peak "
          f"{mem['peak_size_in_bytes'] / 2 ** 30:.3f} GiB, roofline "
          f"step_time_s {pred['roofline']['step_time_s']:.6f} "
          f"({pred['roofline']['dominant']})")

    spec, shape = phase14_cell()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one rank: loopback
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(dev, rank=0, world_size=1,
                         store=dist.FileStore(str(Path(tmp) / "store"), 1))
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            step, (p, o, one), accum = dryrun.build_cell(spec, shape, mesh,
                                                         device=dev)
            batch = {k: v.expand((accum,) + tuple(v.shape[1:])).contiguous()
                     for k, v in one.items()}
            del one
            out = step(p, o, batch)  # warm-up
            del out
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            zeroed(kern)
            out = step(p, o, batch)
            launches = read(kern)
            peak = torch.cuda.max_memory_allocated(dev) - base
            loss = float(out[2]["loss"])
            del out
            busy, by_name, _ = profile("the dry-run cell's step on the card",
                                       lambda: step(p, o, batch))
            del p, o, batch, step
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    prof = {"flash_attention": by_name_sum(by_name, *FLASH_FORWARD)[0],
            "flash_attention_bwd": by_name_sum(by_name, "bwd_dq")[0]}
    want = {n: int(pred["kernels"][n]) for n in prof}
    got = {n: launches[n] for n in prof}
    roof_ms = pred["roofline"]["step_time_s"] * 1e3
    rel = mem["peak_size_in_bytes"] / peak - 1.0
    print(f"  kernel 6 and its backward: predicted {want}, counted {got}, "
          f"profiled {prof}; peak predicted "
          f"{mem['peak_size_in_bytes'] / 2 ** 30:.3f} GiB against "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB ({100 * rel:+.2f} "
          f"%); device time {busy:.2f} ms against the roofline's "
          f"{roof_ms:.3f} ms (ratio {busy / roof_ms:.2f}); loss {loss:.4f} "
          f"({power_limit()})")
    if not want == got == prof:
        raise AssertionError(f"kernel launches: predicted {want}, counted "
                             f"{got}, profiled {prof}")
    if not abs(rel) <= DRY_PEAK_REL:
        raise AssertionError(f"predicted peak {mem['peak_size_in_bytes']} "
                             f"against {peak}: {rel:+.3f}")
    if not busy >= roof_ms:
        raise AssertionError(f"device time {busy} ms below the roofline's "
                             f"{roof_ms} ms")
    if not np.isfinite(loss):
        raise AssertionError(f"the cell's loss is {loss}")

    r = dryrun_result(full, "qwen2-7b x train_4k x 16x16")
    rf, m = r["roofline"], r["memory_analysis"]
    print(f"dry-run {r['cell']} (rank 0 of 256, traced on the CPU in "
          f"{r['trace_s']} s): compute {rf['compute_s']:.4f} s, memory "
          f"{rf['memory_s']:.4f} s, collective {rf['collective_s']:.4f} s, "
          f"dominant {rf['dominant']}, roofline_fraction "
          f"{rf['roofline_fraction']:.4f}, peak "
          f"{m['peak_size_in_bytes'] / 2 ** 30:.2f} GiB (fits 80 GB: "
          f"{r['fits_hbm']}), kernels {r['kernels']}")
    print(f"phase 15 (dry-run): {time.perf_counter() - t0:.2f} s")
    return {"dryrun": got}


# ---------------------------------------------------------------------------
# Phase 16: placed prefill and decode (ROADMAP item 10b).
# ---------------------------------------------------------------------------
SERVE_BLOCKS = (2, 4, 16)  # `model` ranks a cache is cut into in (b)
SERVE_COMBINE_F32 = 1e-5  # (b): the combined blocks against the whole, f32


def phase_lse_form(dev):
    """(a) Kernel 7's partial form (`lse=True`: the f32 output and the
    log-sum-exp) against its plain version, bf16 and f32, at
    `phase_decode_attention`'s shape and lengths (on both routes: the
    one-pass route below its threshold, the split route above), and at
    length 0 (zero and -inf, no read of the cache); each bf16 call
    profiled once, and the route it launched (the kernel's template flag)
    must be `one_pass`'s, the one-pass route at a sixteenth of the cache
    and the split route at the decode_32k block. Returns (the worst
    output error, the worst log-sum-exp error, and the times: the
    kernel's, the plain version's and the library's ms and the bound at a
    sixteenth of the cache, `model` rank 0's block of a 16-rank mesh, by
    the one-pass route, and at the block a rank holds in the dry-run's
    qwen2-7b decode_32k cell on the 16 x 16 mesh: B 8, 2,048 positions,
    by the split route)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.decode_attention_kernel import (
        decode_attention_cuda as kernel,
        decode_attention_plain as plain,
        one_pass,
    )

    gen = torch.Generator(device=dev).manual_seed(16)
    B, Hkv, G, hd, S = LM_B, LM_HKV, LM_G, LM_HD, LM_SMAX
    worst = {"out": 0.0, "lse": 0.0}
    routes = {}
    for dtype, tol in ((torch.bfloat16, BF16_ATTN_LIMIT),
                       (torch.float32, 1e-4)):
        q = torch.randn((B, Hkv, G, hd), generator=gen, device=dev).to(dtype)
        cache = [torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
                 .to(dtype) for _ in range(2)]
        k, v = (c.permute(0, 2, 1, 3) for c in cache)
        esize = q.element_size()
        for length in (1, 64, 66, 69, 70, LM_PROMPT + 1, LM_PROMPT + 16,
                       S - 1, S):
            want_route = "one-pass" if one_pass(length, G, hd, esize) \
                else "split"
            if dtype == torch.bfloat16:
                got = decode_kernel_route(
                    lambda: kernel(q, k, v, length, lse=True))
                if got != want_route:
                    raise AssertionError(f"the lse form at length {length} "
                                         f"launched the {got} route, not "
                                         f"{want_route}")
                routes.setdefault(got, []).append(length)
            out, lse = kernel(q, k, v, length, lse=True)
            w_out, w_lse = plain(q, k, v, length, lse=True)
            torch.cuda.synchronize()
            e_out = (out - w_out).abs().max().item()
            e_lse = (lse - w_lse).abs().max().item()
            if not (out.dtype == lse.dtype == torch.float32 and e_out <= tol
                    and e_lse <= 1e-4 * w_lse.abs().max().item()):
                raise AssertionError(f"decode_attention lse form {dtype} "
                                     f"length={length}: output {e_out}, "
                                     f"lse {e_lse}")
            worst["out"] = max(worst["out"], e_out)
            worst["lse"] = max(worst["lse"], e_lse)
        for n in (0, torch.tensor(0, dtype=torch.int32, device=dev)):
            out, lse = kernel(q, k, v, n, lse=True)
            torch.cuda.synchronize()
            if not (torch.equal(out, torch.zeros_like(out)) and torch.equal(
                    lse, torch.full_like(lse, -torch.inf))):
                raise AssertionError("decode_attention of an empty block: "
                                     "not zero and -inf")
    print(f"decode_attention lse form: output within {worst['out']:.3g}, "
          f"log-sum-exp within {worst['lse']:.3g} of the plain version "
          f"(bf16, f32, lengths 1..{S}); length 0 gives zero and -inf; "
          "bf16 routes by profile: " + "; ".join(
              f"{r} at lengths {v}" for r, v in sorted(routes.items())))
    n = S // 16
    qb = q.to(torch.bfloat16)
    kb, vb = (c.to(torch.bfloat16)[:, :n].permute(0, 2, 1, 3) for c in cache)
    route = decode_kernel_route(lambda: kernel(qb, kb, vb, n, lse=True))
    if route != "one-pass":
        raise AssertionError(f"the lse form at {n} positions launched the "
                             f"{route} route, not the one-pass route")
    t_k = median_ms(lambda: kernel(qb, kb, vb, n, lse=True))
    t_p = median_ms(lambda: plain(qb, kb, vb, n, lse=True))
    # The library's call for the same output and log-sum-exp: the G query
    # rows of a KV head as one query of G rows over the block (no mask:
    # the block is full), through memory-efficient attention asked for
    # its log-sum-exp (padded to 32 rows; its output in q's dtype).
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    out, lse = kernel(qb, kb, vb, n, lse=True)
    l_out, l_lse = eff(qb, kb, vb, None, True)[:2]
    torch.cuda.synchronize()
    e_out = (l_out.float() - out).abs().max().item()
    e_lse = (l_lse[..., :G] - lse).abs().max().item()
    if not (e_out <= BF16_ATTN_LIMIT and e_lse <= 1e-3 * lse.abs().max()
            .item()):
        raise AssertionError(f"memory-efficient attention differs from "
                             f"the lse form: output {e_out}, lse {e_lse}")
    t_l = median_ms(lambda: eff(qb, kb, vb, None, True))
    bnd = bound(cost.decode_attention(B, Hkv, G, hd, n, 2, lse=True))
    print(f"decode_attention lse form at {n} positions (bf16, {route} "
          f"route by profile): kernel {t_k:.4f} "
          f"ms, plain {t_p:.4f} ms, memory-efficient attention with its "
          f"log-sum-exp {t_l:.4f} ms, bound {bnd[0]:.6f} ms ({bnd[1]}) "
          f"(output within {e_out:.3g}, log-sum-exp within {e_lse:.3g} of "
          "the kernel's)")
    times = {"ms_lse_block16": t_k, "plain_ms_lse_block16": t_p,
             "library_ms_lse_block16": t_l, "bound_ms_lse_block16": bnd[0]}
    # A rank's block in the decode_32k cell: B 8, 2,048 positions.
    B2, n2 = 8, 2048
    q2 = torch.randn((B2, Hkv, G, hd), generator=gen, device=dev) \
        .to(torch.bfloat16)
    k2, v2 = (torch.randn((B2, n2, Hkv, hd), generator=gen, device=dev)
              .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
    out, lse = kernel(q2, k2, v2, n2, lse=True)
    w_out, w_lse = plain(q2, k2, v2, n2, lse=True)
    torch.cuda.synchronize()
    e_out = (out - w_out).abs().max().item()
    e_lse = (lse - w_lse).abs().max().item()
    if not (e_out <= BF16_ATTN_LIMIT
            and e_lse <= 1e-4 * w_lse.abs().max().item()):
        raise AssertionError(f"the lse form at the decode_32k block: output "
                             f"{e_out}, lse {e_lse}")
    route2 = decode_kernel_route(lambda: kernel(q2, k2, v2, n2, lse=True))
    if route2 != "split":
        raise AssertionError(f"the lse form at the decode_32k block "
                             f"launched the {route2} route, not the split "
                             "route")
    t_k2 = median_ms(lambda: kernel(q2, k2, v2, n2, lse=True))
    t_l2 = median_ms(lambda: eff(q2, k2, v2, None, True))
    bnd2 = bound(cost.decode_attention(B2, Hkv, G, hd, n2, 2, lse=True))
    print(f"decode_attention lse form at the decode_32k cell's rank block "
          f"(B {B2}, {n2} positions, bf16, "
          f"{route2} route by profile): kernel "
          f"{t_k2:.4f} ms, memory-efficient attention {t_l2:.4f} ms, bound "
          f"{bnd2[0]:.4f} ms ({bnd2[1]}); output within {e_out:.3g}, "
          f"log-sum-exp within {e_lse:.3g} of the plain version")
    times.update(ms_lse_block2048=t_k2, library_ms_lse_block2048=t_l2,
                 bound_ms_lse_block2048=bnd2[0])
    return worst, times


def phase_flash_combine(dev):
    """(b) The flash-decoding combine on the card: one cache at
    `phase_decode_attention`'s shape cut into 2, 4 and 16 blocks of
    positions, kernel 7's partial form on each block at its length
    (blocks wholly past the token empty), merged by
    `distributed.sharding.combine_partials` (the function the placed
    decode's `Placement.combine_over_model` wraps), against kernel 7
    over the whole cache. Returns the worst errors (f32, bf16)."""
    from repro_torch.distributed.sharding import combine_partials
    from repro_torch.kernels.decode_attention_kernel import (
        decode_attention_cuda as kernel,
    )

    gen = torch.Generator(device=dev).manual_seed(17)
    B, Hkv, G, hd, S = LM_B, LM_HKV, LM_G, LM_HD, LM_SMAX
    worst = {}
    for dtype, tol in ((torch.float32, SERVE_COMBINE_F32),
                       (torch.bfloat16, BF16_ATTN_LIMIT)):
        q = torch.randn((B, Hkv, G, hd), generator=gen, device=dev).to(dtype)
        cache = [torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
                 .to(dtype) for _ in range(2)]
        k, v = (c.permute(0, 2, 1, 3) for c in cache)
        err = 0.0
        for blocks in SERVE_BLOCKS:
            n = S // blocks
            for length in (1, 100, LM_PROMPT + 16, S):
                parts = [kernel(q, k[:, :, r * n:(r + 1) * n],
                                v[:, :, r * n:(r + 1) * n],
                                min(max(length - r * n, 0), n), lse=True)
                         for r in range(blocks)]
                got = combine_partials(torch.stack([o for o, _ in parts]),
                                       torch.stack([l for _, l in parts]))
                want = kernel(q, k, v, length).float()
                e = (got - want).abs().max().item()
                if not e <= tol:
                    raise AssertionError(f"combine of {blocks} blocks "
                                         f"{dtype} length={length}: {e}")
                err = max(err, e)
        worst[str(dtype).replace("torch.", "")] = err
    print(f"flash-decoding combine of {SERVE_BLOCKS} blocks (some empty) "
          f"against kernel 7 over the whole cache: {worst}")
    return worst


def edge_padded_profile(label, fn):
    """`profile` of `fn` with a pad of empty spin kernels (`spin_pad`)
    launched before and after it inside the window;
    they are left out of the device time and the counts by name. Late in
    a full run of this script the profiler drops the device events at
    the start of a window (58 and 79 spin kernels in two runs, more on
    the slower host; before the pad, layer 0's attention, kernel 7 among
    them), so `fn`'s own events must not lie at its edges; the pad is
    timed so that a slower host sends more. The cause is not known; a pad that survives on both sides
    shows the margin held, and a pad dropped whole fails the phase."""
    sent = []

    def padded():
        sent.append(spin_pad())
        fn()
        sent.append(spin_pad())

    busy, by_name, info = profile(label, padded)
    spin = {n: v for n, v in by_name.items() if "spin_kernel" in n}
    busy -= sum(t for _, t in spin.values())
    own = [i for i, n in enumerate(info["order"]) if n not in spin]
    front, back = own[0], len(info["order"]) - 1 - own[-1]
    print(f"  {label}: {busy:.2f} ms device time without the "
          f"{sum(n for n, _ in spin.values())} spin kernels ({front} of "
          f"{sent[0]} before it, {back} of {sent[1]} after it)")
    if not (front and back):
        raise AssertionError(f"{label}: the profiler dropped a whole pad "
                             f"of spin kernels at an edge; the window's "
                             "own events may be missing")
    return busy, {n: v for n, v in by_name.items() if n not in spin}, info


def serve_qwen2(dev, kern, mesh, after_timed):
    """(c) qwen2-7b at its published width and depth (28 layers, bf16)
    served unplaced, then placed over the one-rank mesh
    (`make_prefill_step` / `make_decode_step` with `mesh`), each after a
    warm-up prefill and decode step: a prefill of
    LM_BATCH x LM_PROMPT tokens, then LM_GEN greedy decode steps. The
    logits of every call and the tokens bit-equal; the placed prefill's
    and decode steps' ms, the peak, the placed run's launches (counts
    zeroed just before it) and one placed prefill and decode step
    profiled; `after_timed()` is called once the timed runs are over.
    Returns (the launches, {"flash_attention": kernel 6
    launches a prefill, "decode_attention": kernel 7 launches a step},
    profiled counts of the same)."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import (
        ShardingConfig,
        gather,
        named,
        param_pspecs,
        place,
    )
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import lm
    from repro_torch.tree_util import leaves_with_path

    model = get_arch(LM_ARCH).model
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(model, gen, device=dev)
    tokens = torch.randint(0, model.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    S = LM_SMAX

    def run(prefill, decode, p):
        """(every call's logits, the tokens fed, the cache, each call's
        ms)."""
        ms = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(p, {"tokens": tokens})
        out, toks = [gather(logits)], []
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for i in range(LM_GEN):
            toks.append(torch.argmax(out[-1][:, -1], dim=-1)
                        .to(torch.int32)[:, None])
            t0 = time.perf_counter()
            logits, cache = decode(p, cache, toks[-1], LM_PROMPT + i)
            out.append(gather(logits))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, torch.cat(toks, dim=1), cache, ms

    with torch.no_grad():
        # warm-up at the served shapes (the first calls' library set-up;
        # `gather`'s first call imports DTensor's modules, ~4.6 s), then
        # the timed run
        logits, cache = lm.prefill(params, {"tokens": tokens}, model, S)
        gather(logits)
        lm.decode_step(params, cache, tokens[:, :1], LM_PROMPT, model)
        del logits, cache
        want = run(lambda p, b: lm.prefill(p, b, model, S),
                   lambda p, c, t, pos: lm.decode_step(p, c, t, pos, model),
                   params)
    placed = place(params, named(mesh, param_pspecs(params, ShardingConfig(),
                                                    mesh)))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    prefill = make_prefill_step(model, S, mesh)
    decode = make_decode_step(model, mesh)
    # the placed path's own warm-up (its first call also works out the
    # cache's specs), so that both runs are timed warm
    logits, cache = prefill(placed, {"tokens": tokens})
    gather(logits)
    decode(placed, cache, tokens[:, :1], LM_PROMPT)
    del logits, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zeroed(kern)
    got = run(prefill, decode, placed)
    launches = read(kern)
    peak = torch.cuda.max_memory_allocated(dev)
    after_timed()
    same = all(torch.equal(a, b) for a, b in zip(got[0], want[0])) \
        and torch.equal(got[1], want[1])
    cache_same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_path(gather(got[2])), leaves_with_path(want[2])))
    print(f"placed serve of {LM_ARCH} ({model.n_layers} layers, "
          f"{model.dtype}) over the one-rank "
          f"mesh: prefill {LM_BATCH}x{LM_PROMPT} {got[3][0]:.2f} ms "
          f"(unplaced {want[3][0]:.2f}), decode {np.median(got[3][1:]):.3f} "
          f"ms a step (unplaced {np.median(want[3][1:]):.3f}), peak "
          f"{peak / 2 ** 30:.3f} GiB; logits and tokens bit-equal: {same}, "
          f"cache bit-equal: {cache_same}; launches {launches}")
    if not (same and cache_same):
        raise AssertionError("the one-rank placed serve differs from the "
                             "unplaced one")
    per = {"flash_attention": launches["flash_attention"],
           "decode_attention": launches["decode_attention"] / LM_GEN}
    tok = got[1][:, -1:]
    cache = got[2]
    del got, want
    busy_p, by_p, _ = edge_padded_profile(
        "one placed prefill", lambda: prefill(placed, {"tokens": tokens}))
    busy_d, by_d, _ = edge_padded_profile(
        "one placed decode step", lambda: decode(placed, cache, tok, S - 1))
    prof = {"flash_attention": by_name_sum(by_p, *FLASH_FORWARD)[0],
            "decode_attention": by_name_sum(by_d, "decode_kernel")[0]}
    del placed, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches, per, prof


def serve_dryrun_on_card(dev, kern, mesh):
    """(d) The dry-run's one-rank decode cell of `serve_qwen2`'s serve
    (qwen2-7b, LM_BATCH sequences, a cache of LM_SMAX positions, at
    pos = LM_SMAX - 1) run on the card (`dryrun.build_cell` over the
    one-rank mesh, one warm-up step): its kernel-7 launches counted and
    profiled, its peak above the memory held before the cell, its device
    time. Returns (the count, the profiled count, the peak, the device
    ms)."""
    import gc

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch import dryrun

    spec = get_arch(LM_ARCH)
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=LM_SMAX,
                                global_batch=LM_BATCH)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    step, args, _ = dryrun.build_cell(spec, shape, mesh, device=dev)
    step(*args)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zeroed(kern)
    step(*args)
    counted = read(kern)["decode_attention"]
    peak = torch.cuda.max_memory_allocated(dev) - base
    busy, by_name, _ = edge_padded_profile(
        "the dry-run's decode cell on the card", lambda: step(*args))
    profiled = by_name_sum(by_name, "decode_kernel")[0]
    del step, args
    gc.collect()
    torch.cuda.empty_cache()
    return counted, profiled, peak, busy


def serve_phase(dev, kern, decode_entry):
    """Phase 16: (a) kernel 7's partial form, (b) the flash-decoding
    combine, both on the card alone; then on a one-rank NCCL process
    group and the placed mesh (1, 1): (c) `serve_qwen2`, (d) the CPU
    dry-run of its prefill and decode cells (children, started after
    (c)'s timed runs, so that their tracing takes no core from the
    serve's host) against the counted and profiled launches, the decode cell's peak
    within DRY_PEAK_REL of `max_memory_allocated` and its device time at
    or above the roofline's. Adds the partial form's times to
    `decode_entry` and returns {"placed_serve": (c)'s launches}."""
    import os

    import torch.distributed as dist

    from repro_torch.kernels.backend import power_limit
    from repro_torch.launch.mesh import init_distributed, make_mesh

    t0 = time.perf_counter()
    worst, times = phase_lse_form(dev)
    combine = phase_flash_combine(dev)
    decode_entry.update(max_abs_err_lse=worst["out"], lse_err=worst["lse"],
                        combine_err=combine, **times)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one rank: loopback
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(dev, rank=0, world_size=1,
                         store=dist.FileStore(str(Path(tmp) / "store"), 1))
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            kids = {}

            def start_kids():
                kids.update((k, dryrun_child("serve", k, str(LM_BATCH),
                                             str(n)))
                            for k, n in (("prefill_32k", LM_PROMPT),
                                         ("decode_32k", LM_SMAX)))

            try:
                launches, per, prof = serve_qwen2(dev, kern, mesh,
                                                  start_kids)
                counted, profiled, peak, busy = serve_dryrun_on_card(
                    dev, kern, mesh)
                pred = {k: dryrun_result(p, f"the one-rank {k} cell")
                        for k, p in kids.items()}
            finally:
                for p in kids.values():
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            dec = pred["decode_32k"]
        finally:
            dist.destroy_process_group()
    want = {"flash_attention": int(pred["prefill_32k"]["kernels"]
                                   ["flash_attention"]),
            "decode_attention": int(dec["kernels"]["decode_attention"])}
    mem = dec["memory_analysis"]["peak_size_in_bytes"]
    rel = mem / peak - 1.0
    roof_ms = dec["roofline"]["step_time_s"] * 1e3
    print(f"  dry-run (traced on the CPU): kernel 6 {want['flash_attention']}"
          f" a prefill, kernel 7 {want['decode_attention']} a decode step; "
          f"counted {per}, profiled {prof}; the decode cell on the card: "
          f"kernel 7 counted {counted}, profiled {profiled}, peak predicted "
          f"{mem / 2 ** 30:.3f} GiB against max_memory_allocated "
          f"{peak / 2 ** 30:.3f} GiB ({100 * rel:+.2f} %), device time "
          f"{busy:.3f} ms against the roofline's {roof_ms:.4f} ms (ratio "
          f"{busy / roof_ms:.2f}, {dec['roofline']['dominant']}) "
          f"({power_limit()})")
    if not (want == per == prof
            and counted == profiled == want["decode_attention"]):
        raise AssertionError(f"launches: predicted {want}, counted {per} "
                             f"and {counted}, profiled {prof} and "
                             f"{profiled}")
    if not abs(rel) <= DRY_PEAK_REL:
        raise AssertionError(f"predicted peak {mem} against {peak}: "
                             f"{rel:+.3f}")
    if not busy >= roof_ms:
        raise AssertionError(f"device time {busy} ms below the roofline's "
                             f"{roof_ms} ms")
    print(f"phase 16 (placed serve): {time.perf_counter() - t0:.2f} s")
    return {"placed_serve": launches}


# Sources whose ptxas lines are printed in full (kernel names, stack and
# spill bytes, wgmma notes); for the others only the register counts.
DETAIL_SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
                  "decode_attention.cu",
                  "quant_matmul_packed.cu", "quant_matmul.cu",
                  "hash_encode.cu", "ray_march.cu", "gather_composite.cu")
# Kernels whose tensor-core (HGMMA, HMMA, IMMA) and cp.async (LDGSTS)
# instructions are counted in the SASS.
SASS_KERNELS = ("flash_tc_kernel", "flash_tcp_kernel", "flash_f32_kernel",
                "decode_kernel",
                "qmm_packed_kernel", "qmm_kernel", "bwd_dkdv_tc_kernel",
                "bwd_dq_tc_kernel")


def print_ptxas(log: str) -> None:
    """Registers of every kernel from the build's `ptxas -v` log; for the
    attention and quantized-matmul sources also each kernel's name, its
    stack and spill bytes, and any note ptxas made about the wgmma
    pipeline."""
    src = None
    for line in log.splitlines():
        line = line.strip()
        if line.startswith("=="):
            src = line[3:]
            print(f"  {line}")
        elif "registers" in line:
            print(f"  {line}")
        elif src in DETAIL_SOURCES and (
                "entry function" in line or "spill" in line
                or "wgmma" in line or "warpgroup" in line):
            print(f"  {line[:160]}")


def sass_counts(lib) -> dict:
    """{(kernel, op): count} of the tensor-core and cp.async instructions
    of SASS_KERNELS in the built library (`cuobjdump -sass`)."""
    import re
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            name = next((k for k in SASS_KERNELS if k in fn), None)
            if name == "decode_kernel":
                name += "<bf16>" if "bfloat16" in fn else "<f32>"
            if name == "flash_tcp_kernel":  # <HDP>, mangled ILi64E
                name += "<" + re.search(r"ILi(\d+)E", fn).group(1) + ">"
            if name:
                counts.setdefault((name, "LDGSTS"), 0)
            continue
        for op in ("HGMMA", "HMMA", "IMMA", "LDGSTS"):
            if name and re.search(rf"\b{op}\.", line):
                counts[(name, op)] = counts.get((name, op), 0) + 1
    return counts


def print_tensor_core_ops(lib) -> None:
    """Print the SASS counts; the bf16 flash kernels (the forward, the
    backward's dK/dV and dQ) must hold HGMMA, and both quantized matmuls
    an s8 tensor-core instruction (IMMA or HGMMA)."""
    counts = sass_counts(lib)
    for (kernel, op), n in sorted(counts.items()):
        print(f"  SASS {kernel}: {n} {op}")
    for k in ("flash_tc_kernel", "flash_tcp_kernel<64>", "bwd_dkdv_tc_kernel",
              "bwd_dq_tc_kernel"):
        if not counts.get((k, "HGMMA")):
            raise AssertionError(f"the bf16 {k}'s SASS holds no HGMMA")
    for k in ("qmm_packed_kernel", "qmm_kernel"):
        if (k, "LDGSTS") not in counts:
            raise AssertionError(f"no {k} in the library's SASS")
        if not (counts.get((k, "IMMA")) or counts.get((k, "HGMMA"))):
            raise AssertionError(f"{k}'s SASS holds no s8 tensor-core "
                                 "instruction (IMMA or HGMMA)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs.ngp import paper
    from repro_torch.hero.service import ServeConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.backend import power_limit
    from repro_torch.nerf.render import RenderConfig

    card = power_limit()
    if card is None:
        raise RuntimeError("nvidia-smi did not report the card")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    res = build.build()
    print(f"kernel build: {res.seconds:.2f} s ({res.path.name})")
    print_ptxas(res.log)
    build.library()
    print_tensor_core_ops(res.path)

    dev = torch.device("cuda")
    # Full float32 products wherever float32 is compared (the default,
    # stated and set).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = paper()
    rng = np.random.default_rng(0)
    floor = launch_floor(dev)
    entries = [phase_quant_matmul(rng, dev, floor),
               phase_hash_gather(rng, dev, cfg),
               phase_hash_encode_corners(rng, dev, cfg),
               phase_hash_encode(rng, dev, cfg),
               phase_gather_composite(rng, dev),
               phase_alpha_composite(rng, dev), phase_ray_march(rng, dev),
               phase_quant_matmul_unpacked(rng, dev, floor),
               phase_flash_attention(dev), phase_decode_attention(dev)]
    for e in entries:
        print(f"{e['name']}: max_abs_err {e['max_abs_err']:.3g}, kernel "
              f"{e['ms']:.4f} ms (one call with launch {e['call_ms']:.4f} "
              f"ms), plain {e['plain_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}), library "
              f"{e['library_ms']}")

    kern = counters()
    t0 = time.perf_counter()
    art, psnr_launches, plan_chunk, (trained, ds) = train_and_score(
        cfg, dev, kern)
    corners = next(e for e in entries if e["name"] == "hash_encode_corners")
    corners.update(ms_plan_chunk=plan_chunk["ms"],
                   plain_ms_plan_chunk=plan_chunk["plain_ms"],
                   bound_ms_plan_chunk=plan_chunk["bound"][0],
                   points_kernel_ms_plan_chunk=plan_chunk["points_kernel_ms"])
    print(f"training phase: {time.perf_counter() - t0:.2f} s")
    train_card_vs_cpu(dev)
    psnr_launches["search"], env, benv = search_phase(cfg, trained, ds,
                                                      dev, kern)
    pipe_launches, seq = pipeline_phase(env, benv, dev, kern)
    psnr_launches.update(pipe_launches)
    psnr_launches["distributed"] = distributed_phase(env, benv, dev, kern,
                                                     seq)
    del seq
    del trained, ds, env, benv
    t0 = time.perf_counter()
    requests = request_rays(8, 64)
    fresh = request_rays(3, 64, held_out=True)[0]
    with tempfile.TemporaryDirectory() as tmp:
        art.save(tmp)
        svc, loaded = serve(tmp, dev)
        print(f"main path set-up (save, load, warm-up): "
              f"{time.perf_counter() - t0:.2f} s")
        for fn in kern.values():
            fn.launches = 0
        colors = answer(svc, requests)
        torch.cuda.synchronize()
        launches = {name: kern[name].launches for name in NERF_KERNELS}
        stats = svc.stats()
        pc = stats["pose_cache"]
        for (ro, _), c in zip(requests, colors):
            if c.shape != (ro.shape[0], 3) or not np.isfinite(c).all():
                raise AssertionError(f"bad result: shape {c.shape}")
        print(f"launches during the 8 served requests: {launches}; pose "
              f"cache {pc}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel was never launched: {launches}")
        off_path = {n: kern[n].launches for n in kern
                    if n not in NERF_KERNELS and kern[n].launches}
        if off_path:
            raise AssertionError(f"kernels off the render path (the bare "
                                 f"gather, the unfused composite among "
                                 f"them) were launched: {off_path}")
        # A slot that overflows its sample budget grows it and renders
        # again: once a slot, and once more a growth.
        slots = pc["misses"] + stats["budget_retraces"]
        if not (launches["hash_encode"] == launches["ray_march"]
                == launches["gather_composite"] == slots):
            raise AssertionError("the fused encode and the gather-composite "
                                 "did not run once a slot render (one march "
                                 f"a slot render): {launches}, {slots}")
        if pc["builds"] or pc["hits"] or pc["warps"] or pc["bytes"]:
            raise AssertionError(f"fresh poses built or hit plans: {pc}")

        march = profile("march request (a fresh pose, 8 slots)",
                        lambda: answer(svc, [fresh]))[2]
        if svc.stats()["pose_cache"]["builds"]:
            raise AssertionError("the fresh profiled pose built plans")
        cpu_svc, _ = serve(tmp, "cpu")
        ref = answer(cpu_svc, requests[:1])[0]
        del svc, cpu_svc
        revisit_launches, tier_prof = revisit_stream(tmp, dev, kern)
    tier_prof["march"] = march
    print("profiled requests by tier (8 slots each): " + "; ".join(
        f"{k} {v['events']} device events ({v['events'] / 8:.0f} a slot), "
        f"device {v['device_ms']:.3f} ms, wall {v['wall_ms']:.2f} ms"
        for k, v in tier_prof.items()))
    diff = float(np.abs(ref - colors[0]).max())
    print(f"card vs CPU plain versions, one request: max |diff| {diff:.3g}")
    if not diff <= 1e-5:
        raise AssertionError(f"served colours differ from the CPU by {diff}")
    lat = stats["latency_ms"]
    print(f"served {stats['requests_completed']} requests "
          f"({stats['rays_rendered']} rays) in {stats['wall_seconds']} s: "
          f"{stats['requests_per_sec']} req/s, {stats['rays_per_sec']} rays/s, "
          f"latency p50 {lat['p50']} ms p95 {lat['p95']} ms")
    print(f"sample budget {stats['sample_budget']} of "
          f"{ServeConfig().slot_rays * RenderConfig().n_samples} a slot, grows "
          f"{stats['budget_retraces']}, resident_bytes "
          f"{loaded.resident_bytes()}, stored_model_bytes "
          f"{loaded.stored_model_bytes()}, occupied fraction "
          f"{loaded.occ.occupied_fraction:.4f}")
    del loaded, art

    lm_launches = lm_serve(dev, kern)
    launches.update({n: lm_launches[n] for n in LM_KERNELS})
    lm_profile(dev)
    lm_card_vs_cpu(dev)
    flash_entry = next(e for e in entries if e["name"] == "flash_attention")
    psnr_launches["lm_search"] = lm_search_phase(dev, kern, flash_entry)
    decode_entry = next(e for e in entries
                        if e["name"] == "decode_attention")
    psnr_launches.update(item8_phase(dev, kern, flash_entry, decode_entry))
    bwd_entry, train_runs = train_phase(dev, kern)
    entries.append(bwd_entry)
    psnr_launches.update(train_runs)
    psnr_launches.update(placement_phase(dev, kern))
    psnr_launches.update(dryrun_phase(dev, kern))
    psnr_launches.update(serve_phase(dev, kern, decode_entry))
    # The backward's main path is phase 13's whisper run.
    launches["flash_attention_bwd"] = \
        train_runs["train_whisper"]["flash_attention_bwd"]

    for e in entries:
        # quant_matmul lies on no path: 0 launches in every run.
        e["launches"] = launches.get(e["name"], 0)
        e["launches_revisit"] = revisit_launches.get(e["name"], 0)
        for k, v in psnr_launches.items():
            e[f"launches_{k}"] = v.get(e["name"], 0)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
