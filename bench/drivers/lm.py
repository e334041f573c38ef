"""LLaVA-NeXT (Mistral-7B) offline batches through the port's LM server.

The system under test is `repro_torch.launch.serve.generate` over the
steps `repro_torch.launch.steps.make_prefill_step` and `make_decode_step`
(`models/lm.py` `prefill` and `decode_step`: the bf16 matmuls, kernel 6
in the prefill, kernel 7 over the cache in each decode step). The
benchmark makes the inputs from the seed on the card: the weights (one
normal draw in bf16, each matrix scaled by 1 / sqrt(d_in), the
embedding by 1, the norms one), and per batch the patch embeddings and
the text tokens.

Traffic (`kind: lm_offline`): batches of B requests one after another,
each request the patches and a text prompt of the batch's length, then
`gen` greedy tokens. The lengths come in blocks that hold each length
once, in the seed's order, so every seed serves the same mix.
"""
from __future__ import annotations

import gc
import resource
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from bench.lib import costs
from bench.lib.device import peak_bytes, release, sync
from bench.lib.outcome import Check, Outcome
from bench.lib.trace import traced
from bench.reference import lm as ref



def model_config(config: Dict):
    """The port's `ModelConfig` of the configuration file."""
    from repro_torch.models.common import ModelConfig

    return ModelConfig(
        name=config["name"], n_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"], n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        d_head=config["head_dim"], ffn_type="swiglu",
        rope_theta=config["rope_theta"], embed_frontend="prefix_patches",
        n_prefix_patches=config["image_seq_length"],
        norm_eps=config["rms_norm_eps"],
        tie_embeddings=config["tie_word_embeddings"],
        dtype=config["torch_dtype"])


def make_weights(model, seed: int, device) -> Dict:
    """The parameter tree of the port's layout (`models.lm.param_specs`),
    filled from one normal draw in the served dtype on the card."""
    from repro_torch.models import lm

    specs = lm.param_specs(model)
    leaves: List = []

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (i,)) for i, v in enumerate(t)]
        leaves.append((path, t))
        return len(leaves) - 1

    tree = walk(specs, ())
    flat = torch.empty(sum(t.numel() for _, t in leaves),
                       dtype=model.param_dtype, device=device)
    flat.normal_(generator=torch.Generator(device=device).manual_seed(seed))
    views, off = [], 0
    for path, t in leaves:
        v = flat[off:off + t.numel()].view(t.shape)
        off += t.numel()
        if path[-1] in ("scale_param", "bias"):
            v.fill_(1.0 if path[-1] == "scale_param" else 0.0)
        elif path != ("embed",):
            v.mul_(1.0 / np.sqrt(t.shape[0]))
        views.append(v)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        if isinstance(t, list):
            return [fill(v) for v in t]
        return views[t]
    return fill(tree)


def batch_inputs(model, seed: int, b: int, batch: int, length: int, device):
    """(tokens (B, L) int64, patches (B, P, d)) of batch `b`."""
    g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + b)
    tokens = torch.randint(0, model.vocab_size, (batch, length), generator=g,
                           device=device)
    patches = torch.randn((batch, model.n_prefix_patches, model.d_model),
                          generator=g, device=device,
                          dtype=model.param_dtype)
    return tokens, patches


def lengths(traffic: Dict, seed: int, n: int) -> List[int]:
    """The text lengths of the first `n` batches: blocks of every length
    once, each block in the seed's order."""
    rng = np.random.default_rng([seed, 2])
    out: List[int] = []
    while len(out) < n:
        out += [traffic["text_lengths"][i]
                for i in rng.permutation(len(traffic["text_lengths"]))]
    return out[:n]


def attention_work(model, batch: int, length: int, gen: int) -> float:
    """Least seconds of one batch's attention: a causal prefill over every
    layer and `gen - 1` decode steps against the cache."""
    B, Hkv, hd = batch, model.n_kv_heads, model.head_dim
    G = model.n_heads // Hkv
    S = model.n_prefix_patches + length
    isz = torch.tensor([], dtype=model.param_dtype).element_size()
    t = costs.least_s(*costs.flash_attention(B, Hkv, G, hd, S, S, True, isz))
    for i in range(gen - 1):
        t += costs.least_s(*costs.decode_attention(B, Hkv, G, hd, S + i + 1,
                                                   isz))
    return model.n_layers * t


def model_flops(model, batch: int, length: int, gen: int) -> float:
    """Matmul FLOPs of one batch by the configuration: 2 x the matrix
    parameters (no embedding) a position, plus causal attention's score
    and value products; the prefill's head over every position as the
    server computes it."""
    d, hd, H, Hkv = model.d_model, model.head_dim, model.n_heads, \
        model.n_kv_heads
    per_layer = d * (H * hd) * 2 + d * (Hkv * hd) * 2 + 3 * d * model.d_ff
    mats = model.n_layers * per_layer + d * model.vocab_size
    S = model.n_prefix_patches + length
    positions = batch * (S + gen - 1)
    attn = model.n_layers * batch * H * hd * 4 * (
        S * S / 2 + sum(S + i + 1 for i in range(gen - 1)))
    return 2.0 * mats * positions + attn


def run(config: Dict, traffic: Dict, limits: Dict, seed: int,
        seconds: float, trace: bool, device, control: bool = False
        ) -> Outcome:
    """One run of a cell. `control` adds the control's reading (the
    reference with float8 products in the port's place) as the
    `control_logit_gap_max` counter: `bench/control.py` reads it; the
    benchmark's runs do not."""
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    t_setup = time.perf_counter()
    model = model_config(config)
    params = make_weights(model, seed, device)
    B, gen = traffic["batch"], traffic["gen_tokens"]
    P = model.n_prefix_patches
    steps = {L: make_prefill_step(model, P + L + gen)
             for L in traffic["text_lengths"]}
    decode = make_decode_step(model)

    def serve(b: int, L: int, marks: List[float]) -> torch.Tensor:
        with record_function("bench.inputs"):
            tokens, patches = batch_inputs(model, seed, b, B, L, device)
        sync(device)
        marks.append(time.perf_counter())
        with record_function("lm.generate"):
            return generate(steps[L], decode, params, tokens, gen, marks,
                            {"patches": patches}).cpu()

    with torch.inference_mode():
        # Every prompt length once, the longest with its whole answer.
        longest = max(traffic["text_lengths"])
        for L in traffic["text_lengths"]:
            g = gen if L == longest else 2
            tokens, patches = batch_inputs(model, seed, -1, B, L, device)
            generate(steps[L], decode, params, tokens, g, None,
                     {"patches": patches}).cpu()
        sync(device)
        gc.freeze()  # set-up's objects leave the collector's young generations
        setup_s = time.perf_counter() - t_setup

        order = lengths(traffic, seed, 100_000)
        served: List = []  # (batch, length, tokens (B, gen))
        prefill_s, decode_s = [], []
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        while True:
            b = len(served)
            marks: List[float] = []
            out = serve(b, order[b], marks)
            t1 = time.perf_counter()
            served.append((b, order[b], out))
            prefill_s.append(marks[1] - marks[0])
            decode_s.append(marks[2] - marks[1])
            if t1 - t0 >= seconds:
                break
        window_s = t1 - t0
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        positions = sum(B * (P + L) for _, L, _ in served)
        generated = sum(o.numel() for _, _, o in served)
        out = Outcome(
            setup_s=setup_s, window_s=window_s, attempted=B * len(served),
            failed=0, memory_peak_bytes=0,
            records={"prefill_s": prefill_s, "decode_s": decode_s},
            counters={"tokens": positions + generated,
                      "prefill_positions": positions,
                      "decode_steps": len(served) * (gen - 1),
                      "batches": len(served)})
        step_ms = [1e3 * d / (gen - 1) for d in decode_s]
        out.notes += [
            ("host", f"page faults {ru1.ru_minflt - ru0.ru_minflt}, context switches {ru1.ru_nvcsw - ru0.ru_nvcsw} / {ru1.ru_nivcsw - ru0.ru_nivcsw} involuntary, cpu {ru1.ru_utime - ru0.ru_utime:.2f} user {ru1.ru_stime - ru0.ru_stime:.2f} sys"),
            ("batches", " ".join(f"{L}:{1e3 * p:.0f}+{m:.1f}x{gen - 1}" for (_, L, _), p, m in zip(served, prefill_s, step_ms)))]
        out.work["lm_flops"] = sum(model_flops(model, B, L, gen)
                                   for _, L, _ in served)
        if trace:
            first = len(served)
            extra = order[first:first + traffic["trace_batches"]]

            def traced_batches():
                for i, L in enumerate(extra):
                    serve(first + i, L, [])
            out.trace = traced(traced_batches, device)
            out.work["attention_s"] = sum(attention_work(model, B, L, gen)
                                          for L in extra)
    sync(device)
    out.memory_peak_bytes = peak_bytes(device)
    release(device)

    # The reference: a sample of the served requests, the longest among
    # them, each prompt with its served tokens through the plain forward.
    rng = np.random.default_rng([seed, 3])
    top = max(L for _, L, _ in served)
    pick = [(int(rng.choice([b for b, L, _ in served if L == top])),
             int(rng.integers(B)))]
    while len(pick) < traffic["check_requests"]:
        c = (int(rng.integers(len(served))), int(rng.integers(B)))
        if c not in pick:
            pick.append(c)
    ref.matmul_precision_f32()
    seqs, at, toks = [], [], []
    for b, row in pick:
        L = served[b][1]
        tokens, patches = batch_inputs(model, seed, b, B, L, device)
        got = served[b][2][row].to(device)
        seqs.append((patches[row], torch.cat([tokens[row], got[:-1]])))
        at.append(range(P + L - 1, P + L - 1 + gen))
        toks.append(got)
    logits = ref.logits_at(params, config, seqs, at)
    gap = max(float(ref.served_gaps(lg, t).max())
              for lg, t in zip(logits, toks))
    out.checks = {"logit_gap_max": Check(gap, limits["logit_gap_max"])}
    if control:
        low = ref.logits_at(params, config, seqs, at, precision="fp8")
        out.counters["control_logit_gap_max"] = max(
            float(ref.control_gaps(r, lw).max()) for r, lw in zip(logits, low))
    out.counters["checked_tokens"] = sum(t.numel() for t in toks)
    return out
