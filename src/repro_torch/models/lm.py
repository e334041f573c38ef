"""The LM stack: init, the quantized forward and loss, prefill and decode.

The counterpart of `repro/models/lm.py` for attention blocks with dense
or mixture-of-experts FFNs. The reference stacks each block parameter
over periods and scans them; here `params["blocks"]` is a list with one
dict per layer and the scan is a Python loop (layer n * period + i is the
reference's period n, position i). The decode cache keeps the
reference's layout, `{"pos<i>": {"k", "v"}}` with a leading period axis
((n_periods, B, S_max, n_kv, hd)), so both compare leaf for leaf; a
decode step updates it in place.

Quantization (HERO applied to LMs): `LMQuantSpec` carries bit tensors,
per-embedding-band bits (the hash-level analogue) and per-layer (w, a)
bits over 4 projection groups (mixer-in / mixer-out / ffn-in / ffn-out).
Weights and activations are fake-quantized in float32 through the
paper's quantizers (`quant.linear_quant`, `quant.qat.ste_fake_quant`),
whatever the model's dtype, and cast back, as the reference's promotion
does. Bits >= 16 are the full-precision sentinel: the quantized value is
still computed and then not selected, so a degenerate range never leaks.

Not ported yet (ROADMAP §1 item 8): the mamba, mLSTM, sLSTM and
encoder-decoder blocks and non-token frontends.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (
    ModelConfig,
    apply_norm,
    dense_init,
    layer_kind,
    norm_init,
)
from repro_torch.quant.linear_quant import activation_qparams, weight_qparams
from repro_torch.quant.qat import ste_fake_quant

_LATER = "ROADMAP §1 item 8 (LM workload)"

N_GROUPS = 4  # quant groups per layer: mixer_in, mixer_out, ffn_in, ffn_out

# Param-name -> quant group (absent = keep full precision: routers, gates,
# SSM dynamics, norms, biases).
_WEIGHT_GROUP = {
    "wq": 0, "wk": 0, "wv": 0, "wo": 1,
    "w_gate": 2, "w_in": 2, "w_out": 3,
    "experts_gate": 2, "experts_in": 2, "experts_out": 3,
    "in_proj": 0, "out_proj": 1,
    "wog": 0, "W": 0, "R": 2,
}


# ---------------------------------------------------------------------------
# Quant spec
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LMQuantSpec:
    embed_bits: torch.Tensor  # (n_bands,) f32
    w_bits: torch.Tensor  # (n_layers, N_GROUPS) f32
    a_bits: torch.Tensor  # (n_layers, N_GROUPS) f32
    paper_exact: bool = True


def no_lm_quant(cfg: ModelConfig, device: DeviceLike = None) -> LMQuantSpec:
    """The full-precision spec (32 bits everywhere) on `device` (the card
    unless "cpu")."""
    dev = resolve_device(device)
    n = total_layers(cfg)
    full = lambda *shape: torch.full(shape, 32.0, dtype=torch.float32,
                                     device=dev)
    return LMQuantSpec(embed_bits=full(cfg.n_embed_bands),
                       w_bits=full(n, N_GROUPS), a_bits=full(n, N_GROUPS))


def embed_band_boundaries(vocab: int, n_bands: int) -> List[int]:
    """Geometric row-bands: hot (low-id, Zipf-frequent) tokens get small
    bands — the LM analogue of coarse->fine hash levels."""
    bounds = [0]
    for i in range(1, n_bands):
        b = int(round(vocab ** (i / n_bands)))
        bounds.append(max(b, bounds[-1] + 1))
    bounds.append(vocab)
    return bounds


def _maybe_quant_w(w: torch.Tensor, bits: torch.Tensor,
                   paper_exact: bool = True) -> torch.Tensor:
    """Symmetric fake quantization over the tensor's own min/max."""
    lo, hi = torch.min(w), torch.max(w)
    qp = weight_qparams(lo, hi, bits, paper_exact=paper_exact)
    x = w.float()
    q = ste_fake_quant(x, qp, symmetric=True)
    return torch.where(bits >= 16.0, x, q).to(w.dtype)


def _maybe_quant_a(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Asymmetric fake quantization over the tensor's dynamic min/max."""
    lo, hi = torch.min(x), torch.max(x)
    qp = activation_qparams(lo, hi, bits)
    xf = x.float()
    q = ste_fake_quant(xf, qp, symmetric=False)
    return torch.where(bits >= 16.0, xf, q).to(x.dtype)


def _quant_block_weights(bp: Dict, w_bits: torch.Tensor,
                         paper_exact: bool) -> Dict:
    """Fake-quantize one block's weights by group. w_bits: (N_GROUPS,)."""

    def walk(tree):
        out = {}
        for name, v in tree.items():
            if isinstance(v, dict):
                out[name] = walk(v)
            elif name in _WEIGHT_GROUP and v.dim() >= 2:
                out[name] = _maybe_quant_w(v, w_bits[_WEIGHT_GROUP[name]],
                                           paper_exact)
            else:
                out[name] = v
        return out

    return walk(bp)


def quant_embedding(table: torch.Tensor, band_bits: torch.Tensor,
                    paper_exact: bool = True) -> torch.Tensor:
    """Each row-band of the table fake-quantized at its own bits."""
    bounds = embed_band_boundaries(table.shape[0], band_bits.shape[0])
    return torch.cat([
        _maybe_quant_w(table[bounds[i]:bounds[i + 1]], band_bits[i],
                       paper_exact)
        for i in range(len(bounds) - 1)
    ], dim=0)


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------
def period(cfg: ModelConfig) -> int:
    if cfg.pattern == "jamba":
        p = cfg.attn_every
        if cfg.moe is not None:
            p = math.lcm(p, cfg.moe.every_n_layers)
        return p
    if cfg.pattern == "xlstm":
        return 2
    if cfg.moe is not None and cfg.moe.every_n_layers > 1:
        return cfg.moe.every_n_layers
    return 1


def total_layers(cfg: ModelConfig) -> int:
    return cfg.n_layers + cfg.encoder_layers


def _block_kinds(cfg: ModelConfig) -> List[str]:
    """Mixer kind for each position within one decoder period."""
    if cfg.pattern == "encdec":
        return ["dec"] * period(cfg)
    return [layer_kind(cfg, p) for p in range(period(cfg))]


def _has_moe(cfg: ModelConfig, pos_in_period: int) -> bool:
    if cfg.moe is None or cfg.pattern == "xlstm":
        return False
    e = cfg.moe.every_n_layers
    return pos_in_period % e == e - 1


def _layer_has_moe(cfg: ModelConfig, layer: int) -> bool:
    return _has_moe(cfg, layer % period(cfg))


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for the parts of the stack the port does not have yet."""
    kinds = set(_block_kinds(cfg))
    if kinds != {"attn"}:
        raise NotImplementedError(
            f"{sorted(kinds - {'attn'})} blocks are not ported yet: {_LATER}")
    if cfg.embed_frontend != "tokens":
        raise NotImplementedError(
            f"the {cfg.embed_frontend!r} frontend is not ported yet: {_LATER}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_block(generator: torch.Generator, cfg: ModelConfig,
                has_moe: bool) -> Dict:
    """One attention block (the only kind `_check_ported` lets through)
    with its dense or MoE FFN."""
    dev = generator.device
    p: Dict = {"ln1": norm_init(cfg, cfg.d_model, dev),
               "attn": attn_mod.init_attn(generator, cfg)}
    if cfg.d_ff > 0 or has_moe:
        p["ln2"] = norm_init(cfg, cfg.d_model, dev)
        if has_moe:
            p["moe"] = ffn_mod.init_moe(generator, cfg)
        else:
            p["ffn"] = ffn_mod.init_ffn(generator, cfg)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict:
    """Random parameters from `generator`, drawn on `device` (the card
    unless `device="cpu"`), which must be the generator's device."""
    _check_ported(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"parameters are asked for on {dev}")
    d, V = cfg.d_model, cfg.vocab_size
    params: Dict = {
        "embed": dense_init(generator, V, d, cfg.param_dtype, scale=1.0),
        "final_norm": norm_init(cfg, d, generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, d, V, cfg.param_dtype)
    if cfg.pos_embed == "learned":
        params["pos_embed"] = dense_init(
            generator, cfg.max_pos_embed, d, cfg.param_dtype, scale=0.02)
    if cfg.n_layers % period(cfg):
        raise ValueError(f"{cfg.n_layers} layers are not whole periods of "
                         f"{period(cfg)}")
    params["blocks"] = [_init_block(generator, cfg, _layer_has_moe(cfg, l))
                        for l in range(cfg.n_layers)]
    return params


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict:
    """Zero decode cache in the reference's layout: {"pos<i>": {"k", "v"}}
    for each position of a period, each (n_periods, B, S_max, n_kv, hd)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    p = period(cfg)
    shape = (cfg.n_layers // p, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {f"pos{i}": {
        "k": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.param_dtype, device=dev)}
        for i in range(p)}


def _layer_cache(cache: Dict, layer: int, p: int) -> Dict:
    """Layer `layer`'s (B, S_max, n_kv, hd) views into the cache."""
    c = cache[f"pos{layer % p}"]
    return {"k": c["k"][layer // p], "v": c["v"][layer // p]}


# ---------------------------------------------------------------------------
# Forward (training shape / scoring)
# ---------------------------------------------------------------------------
def _embed_tokens(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                  spec: Optional[LMQuantSpec] = None) -> torch.Tensor:
    table = params["embed"]
    if spec is not None:
        table = quant_embedding(table, spec.embed_bits, spec.paper_exact)
    return table[tokens]


def _head(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def _ffn(bp: Dict, h: torch.Tensor, cfg: ModelConfig, has_moe: bool
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on its normed input: (out, aux loss or None)."""
    if has_moe:
        return ffn_mod.moe_ffn(bp["moe"], h, cfg)
    return ffn_mod.ffn(bp["ffn"], h, cfg), None


def _apply_block(bp: Dict, x: torch.Tensor, cfg: ModelConfig, has_moe: bool,
                 a_bits: Optional[torch.Tensor],
                 positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention block over the full sequence: (x, aux loss). The
    mixer's and the FFN's inputs are fake-quantized at `a_bits[0]` and
    `a_bits[2]` when given."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(bp["ln1"], x, cfg)
    if a_bits is not None:
        h = _maybe_quant_a(h, a_bits[0])
    h = attn_mod.attention(bp["attn"], h, cfg, positions=positions,
                           causal=True, use_rope=cfg.pos_embed == "rope")
    x = x + h
    if "ln2" in bp:
        h = apply_norm(bp["ln2"], x, cfg)
        if a_bits is not None:
            h = _maybe_quant_a(h, a_bits[2])
        h, a = _ffn(bp, h, cfg, has_moe)
        if a is not None:
            aux = aux + a
        x = x + h
    return x, aux


def forward(params: Dict, batch: Dict, cfg: ModelConfig,
            spec: Optional[LMQuantSpec] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, V), aux_loss). batch: {"tokens": (B, S)}. Under a
    spec, each layer's weights are fake-quantized at its `w_bits` row as
    the layer runs (one layer's copies live at a time)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg, spec)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"][:S]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, bp in enumerate(params["blocks"]):
        a_bits = None
        if spec is not None:
            row = cfg.encoder_layers + l
            bp = _quant_block_weights(bp, spec.w_bits[row], spec.paper_exact)
            a_bits = spec.a_bits[row]
        x, a = _apply_block(bp, x, cfg, _layer_has_moe(cfg, l), a_bits,
                            positions)
        aux = aux + a
    return _head(params, x, cfg), aux


def loss_fn(params: Dict, batch: Dict, cfg: ModelConfig,
            spec: Optional[LMQuantSpec] = None, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy plus `aux_weight` times the MoE aux loss:
    (loss, {"ce", "aux"}). labels = tokens shifted inside, or explicit
    batch["labels"] (negative = no loss)."""
    logits, aux = forward(params, batch, cfg, spec)
    tokens = batch["tokens"]
    if "labels" in batch:
        labels = batch["labels"]
        valid = labels >= 0
        labels = torch.clamp_min(labels, 0)
        lg = logits
    else:
        labels = tokens[:, 1:]
        lg = logits[:, :-1]
        valid = torch.ones_like(labels, dtype=torch.bool)
    lg = lg.float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold) * valid
    loss = torch.sum(nll) / torch.clamp_min(torch.sum(valid), 1)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill and decode
# ---------------------------------------------------------------------------
def _ffn_residual(bp: Dict, x: torch.Tensor, cfg: ModelConfig,
                  has_moe: bool) -> torch.Tensor:
    if "ln2" not in bp:
        return x
    return x + _ffn(bp, apply_norm(bp["ln2"], x, cfg), cfg, has_moe)[0]


def _decode_block(bp: Dict, cache: Dict, x: torch.Tensor, pos: int,
                  cfg: ModelConfig, has_moe: bool) -> torch.Tensor:
    """One attention block's decode step; `cache` is updated in place."""
    h, _ = attn_mod.decode_attention(
        bp["attn"], apply_norm(bp["ln1"], x, cfg), cache, pos, cfg,
        use_rope=cfg.pos_embed == "rope")
    return _ffn_residual(bp, x + h, cfg, has_moe)


def decode_step(
    params: Dict,
    cache: Dict,
    tokens: torch.Tensor,  # (B, 1)
    pos: int,  # position being written
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict]:
    """One token for every sequence in the batch. Returns (logits, cache);
    the cache is updated in place."""
    x = _embed_tokens(params, tokens, cfg)
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"][pos:pos + 1]
    p = period(cfg)
    for l, bp in enumerate(params["blocks"]):
        x = _decode_block(bp, _layer_cache(cache, l, p), x, pos, cfg,
                          _layer_has_moe(cfg, l))
    return _head(params, x, cfg), cache


def prefill(
    params: Dict,
    batch: Dict,
    cfg: ModelConfig,
    max_seq: int,
) -> Tuple[torch.Tensor, Dict]:
    """Consume a prompt, produce (logits (B, S, V), decode cache at pos=S).

    Runs the full forward while writing each layer's K/V into a cache that
    is zero past S, as the reference's padded cache is. The serve path
    never quantizes (the reference's prefill passes no spec)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"][:S]
    use_rope = cfg.pos_embed == "rope"
    cache = init_cache(cfg, B, max_seq, x.device)
    p = period(cfg)
    for l, bp in enumerate(params["blocks"]):
        h, k, v = attn_mod.self_attention(
            bp["attn"], apply_norm(bp["ln1"], x, cfg), cfg, positions,
            causal=True, use_rope=use_rope)
        c = _layer_cache(cache, l, p)
        c["k"][:, :S] = k
        c["v"][:, :S] = v
        x = _ffn_residual(bp, x + h, cfg, _layer_has_moe(cfg, l))
    return _head(params, x, cfg), cache
