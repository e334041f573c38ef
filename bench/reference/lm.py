"""Plain reference of the Mistral-7B decoder that LLaVA-NeXT serves.

Written from the published architecture (Mistral 7B, arXiv:2310.06825;
LLaVA-NeXT prepends the projected image patches to the text), in plain
PyTorch and float32 with TF32 off, to judge the tokens the port serves.
It imports nothing of the port. It reads the benchmark's weights (bf16,
in the port's layout: each matrix (d_in, d_out), applied as x @ W) and
the inputs the benchmark made (patches and token ids), and computes the
full causal forward over a prompt and the tokens served after it, with
no cache.

- Blocks: x + attn(rmsnorm(x)), then x + swiglu(rmsnorm(x)); a final
  rmsnorm and the output head. RMS norm: x / sqrt(mean(x^2) + eps) *
  scale (`src/repro_torch/models/common.py`, `rms_norm`).
- Attention: 32 query heads over 8 key/value heads of 128 (query head h
  reads key head h // 4), causal softmax at 1 / sqrt(128). The rotary
  embedding turns each (even, odd) pair of a head's features by the
  angle position * theta^(-2i / 128), as the port's `apply_rope` pairs
  them (`src/repro_torch/models/common.py`): a fixed permutation of the
  head's features away from the published rotate-half layout, the same
  model under permuted weights.
- FFN: (silu(x W_gate) * (x W_in)) W_out.

`precision="fp8"` is the control that a comparison has to fail: every
matrix product's operands rounded to float8 e4m3 (per-tensor scale to
its largest magnitude), accumulated in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

E4M3_MAX = 448.0


def matmul_precision_f32() -> None:
    """Matrix products in full float32 on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    s = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Mm:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(torch.float32)
        return _fp8(t) if self.fp8 else t

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_fp8(x) if self.fp8 else x) @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale.to(torch.float32)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd) at positions 0..S-1, pairs (even, odd)."""
    S, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                        device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).to(torch.float32)[:, None, :]
    sin = torch.sin(ang).to(torch.float32)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def attention(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: Dict,
              mm: _Mm) -> torch.Tensor:
    S = x.shape[0]
    H, Hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    q = rope(mm(x, w["wq"]).view(S, H, hd), cfg["rope_theta"])
    k = rope(mm(x, w["wk"]).view(S, Hkv, hd), cfg["rope_theta"])
    v = mm(x, w["wv"]).view(S, Hkv, hd)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    p = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    out = torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * hd)
    return mm(out, w["wo"])


def ffn(x: torch.Tensor, w: Dict[str, torch.Tensor], mm: _Mm) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(x, w["w_gate"])) * mm(x, w["w_in"]),
              w["w_out"])


@torch.no_grad()
def logits_at(params: Dict, cfg: Dict,
              seqs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              at: Sequence[Sequence[int]], precision: str = "f32"
              ) -> List[torch.Tensor]:
    """For each sequence (patches (P, d) bf16, tokens (T,) int64) the
    float32 logits (len(at[i]), V) at the positions `at[i]` of the input
    [patches, embeddings of tokens]. Layer by layer: each layer's weights
    are widened to f32 once and run over every sequence."""
    mm = _Mm(precision)
    eps = cfg["rms_norm_eps"]
    embed = params["embed"]
    xs = [torch.cat([p.to(torch.float32), embed[t].to(torch.float32)])
          for p, t in seqs]
    for bp in params["blocks"]:
        attn = {k: mm.w(v) for k, v in bp["attn"].items()}
        mlp = {k: mm.w(v) for k, v in bp["ffn"].items()}
        for i, x in enumerate(xs):
            x = x + attention(rms_norm(x, bp["ln1"]["scale_param"], eps),
                              attn, cfg, mm)
            xs[i] = x + ffn(rms_norm(x, bp["ln2"]["scale_param"], eps), mlp,
                            mm)
        del attn, mlp
    head = mm.w(params["lm_head"])
    return [mm(rms_norm(x[list(a)], params["final_norm"]["scale_param"], eps),
               head) for x, a in zip(xs, at)]


def served_gaps(logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the row's best: (n,)."""
    return logits.max(dim=-1).values - logits.gather(
        1, served.view(-1, 1).to(logits.device)).squeeze(1)


def control_gaps(ref: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """The reference's gap of the token that the lower precision's logits
    put first, at each row."""
    return served_gaps(ref, low.argmax(dim=-1))
