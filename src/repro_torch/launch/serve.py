"""Batched LM server: prefill + greedy decode over a request queue.

The counterpart of `repro/launch/serve.py`, on one card. Requests arrive
as `TokenPipeline` prompts, are batched, prefilled into a KV cache, then
decoded one greedy token per step; the next batch starts at the next
prefill. The reference's host mesh and donated cache have no counterpart
on one card: the decode step updates its cache in place. The stub
frontends get zero inputs, as in the reference: llava's prompts are
`n_prefix_patches` patch embeddings before the text (decode positions
count them, and the cache is sized for them), whisper's carry
`max_source_len` frames for the encoder.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --batch 4 --prompt-len 16 --gen 24

Without `--device` it runs on the card, and raises where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs import get_arch
from repro_torch.data import TokenPipeline, TokenPipelineConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocabulary at the last position; ties go to the
    first index, as in JAX."""
    return torch.argmax(logits[:, -1, :], dim=-1)


def frontend_inputs(model: ModelConfig, batch: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The stub frontend's zero inputs of a request batch: llava's
    (batch, n_prefix_patches, d) patches, whisper's (batch,
    max_source_len, d) frames, nothing for a token model."""
    if model.embed_frontend == "prefix_patches":
        shape = (batch, model.n_prefix_patches, model.d_model)
        return {"patches": torch.zeros(shape, dtype=model.param_dtype,
                                       device=device)}
    if model.embed_frontend == "stub_frames":
        shape = (batch, model.max_source_len, model.d_model)
        return {"frames": torch.zeros(shape, dtype=model.param_dtype,
                                      device=device)}
    return {}


def generate(prefill_fn: Callable, decode_fn: Callable, params: Dict,
             tokens: torch.Tensor, gen: int,
             marks: Optional[List[float]] = None,
             extra: Optional[Dict[str, torch.Tensor]] = None
             ) -> torch.Tensor:
    """Greedy continuation of the prompts `tokens` (B, S): (B, gen) tokens
    on the prompts' device. `extra` holds the frontend's inputs
    (`frontend_inputs`); patches lead the prompt, so the first decode
    position follows them. `marks`, when given, receives the host clock
    after the prefill and after the last decode step (the device
    synchronised at both).

    Spans (`repro_torch.spans`): `lm.prefill` (attrs `batch`, and
    `positions`, a request's prompt positions with its patches) and one
    `lm.decode` a step (attr `pos`), each ending once its launches are
    queued; `lm.sync` around the synchronisations that `marks` takes."""
    extra = extra or {}
    pos = tokens.shape[1]
    if "patches" in extra:
        pos += extra["patches"].shape[1]
    with spans.span("lm.prefill", batch=tokens.shape[0], positions=pos):
        logits, cache = prefill_fn(params, {"tokens": tokens, **extra})
        tok = greedy(logits)[:, None]
    outs = [tok]
    if marks is not None:
        with spans.span("lm.sync"):
            _sync(tokens.device)
        marks.append(time.perf_counter())
    for i in range(gen - 1):
        with spans.span("lm.decode", pos=pos + i):
            logits, cache = decode_fn(params, cache, tok, pos + i)
            tok = greedy(logits)[:, None]
        outs.append(tok)
    if marks is not None:
        with spans.span("lm.sync"):
            _sync(tokens.device)
        marks.append(time.perf_counter())
    return torch.cat(outs, dim=1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class ServeStats:
    """What one `serve` run did and how long it took (host clock, the
    device synchronised at each mark)."""

    device: str
    requests: int
    tokens: int
    prefills: int
    decode_steps: int
    prefill_ms: List[float]  # one per batch
    decode_ms_per_step: List[float]  # one per batch
    wall_s: float
    samples: List[np.ndarray]  # the generated tokens of each batch

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall_s


def serve(model: ModelConfig, params: Dict, requests: int, batch: int,
          prompt_len: int, gen: int, device: torch.device,
          log: Callable[[str], None] = print) -> ServeStats:
    """Serve `requests` greedy generations of `gen` tokens, `batch` at a
    time, for `TokenPipeline` prompts of `prompt_len` tokens (behind the
    patches, for llava)."""
    extra = frontend_inputs(model, batch, device)
    prefix = extra["patches"].shape[1] if "patches" in extra else 0
    max_seq = prefix + prompt_len + gen
    prefill_fn = make_prefill_step(model, max_seq)
    decode_fn = make_decode_step(model)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=model.vocab_size, seq_len=prompt_len, global_batch=batch,
    ))
    stats = ServeStats(device=_device_name(device), requests=0, tokens=0,
                       prefills=0, decode_steps=0, prefill_ms=[],
                       decode_ms_per_step=[], wall_s=0.0, samples=[])
    _sync(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        while stats.requests < requests:
            prompts = torch.from_numpy(pipe.batch()).to(device)
            marks = [time.perf_counter()]
            out = generate(prefill_fn, decode_fn, params, prompts, gen, marks,
                           extra)
            gen_np = out.cpu().numpy()
            assert gen_np.shape == (batch, gen)
            assert np.all(gen_np >= 0) and np.all(gen_np < model.vocab_size)
            stats.prefills += 1
            stats.decode_steps += gen - 1
            stats.prefill_ms.append((marks[1] - marks[0]) * 1e3)
            stats.decode_ms_per_step.append(
                (marks[2] - marks[1]) * 1e3 / max(gen - 1, 1))
            stats.samples.append(gen_np)
            stats.requests += batch
            stats.tokens += gen_np.size
            log(f"served {stats.requests}/{requests} requests; "
                f"sample: {gen_np[0, :8].tolist()}")
    stats.wall_s = time.perf_counter() - t0
    return stats


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv=None) -> ServeStats:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    model = spec.smoke if args.smoke else spec.model
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init_params(model, gen, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    print(f"{model.name}: {model.n_params():,} parameters, "
          f"{model.param_dtype}, initialised on {device} in {init_s:.2f} s")

    stats = serve(model, params, args.requests, args.batch, args.prompt_len,
                  args.gen, device)
    print(f"done: {stats.tokens} tokens in {stats.wall_s:.1f}s "
          f"({stats.tokens_per_s:.1f} tok/s on {stats.device})")
    return stats


if __name__ == "__main__":
    main()
