"""The LM stack's serving half: init, prefill and decode, dense pattern.

The counterpart of `repro/models/lm.py` for dense attention blocks. The
reference stacks each block parameter over periods and scans them; here
`params["blocks"]` is a list with one dict per layer and the scan is a
Python loop. The decode cache keeps the reference's layout,
`{"pos0": {"k", "v"}}` with a leading layer axis ((n_layers, B, S_max,
n_kv, hd)), so both compare leaf for leaf; a decode step updates it in
place.

Not ported yet (ROADMAP §1 item 8, LM workload): the mamba, mLSTM,
sLSTM, encoder-decoder and MoE blocks, non-token frontends, `forward`,
`loss_fn`, `LMQuantSpec` and the quantization helpers. The serve path
never quantizes the embedding (the reference's prefill passes no spec).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

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

_LATER = "ROADMAP §1 item 8 (LM workload)"


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


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for the parts of the stack the port does not have yet."""
    kinds = set(_block_kinds(cfg))
    if kinds != {"attn"}:
        raise NotImplementedError(
            f"{sorted(kinds - {'attn'})} blocks are not ported yet: {_LATER}")
    if cfg.moe is not None:
        raise NotImplementedError(f"MoE blocks are not ported yet: {_LATER}")
    if cfg.embed_frontend != "tokens":
        raise NotImplementedError(
            f"the {cfg.embed_frontend!r} frontend is not ported yet: {_LATER}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_block(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    """One attention block (the only kind `_check_ported` lets through)."""
    dev = generator.device
    p: Dict = {"ln1": norm_init(cfg, cfg.d_model, dev),
               "attn": attn_mod.init_attn(generator, cfg)}
    if cfg.d_ff > 0:
        p["ln2"] = norm_init(cfg, cfg.d_model, dev)
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
    params["blocks"] = [_init_block(generator, cfg)
                        for _ in range(cfg.n_layers)]
    return params


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict:
    """Zero decode cache in the reference's layout: {"pos0": {"k", "v"}},
    each (n_layers, B, S_max, n_kv, hd)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"pos0": {"k": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
                     "v": torch.zeros(shape, dtype=cfg.param_dtype, device=dev)}}


# ---------------------------------------------------------------------------
# Serving: prefill and decode
# ---------------------------------------------------------------------------
def _embed_tokens(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def _head(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def _ffn_residual(bp: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "ln2" not in bp:
        return x
    return x + ffn_mod.ffn(bp["ffn"], apply_norm(bp["ln2"], x, cfg), cfg)


def _decode_block(bp: Dict, cache: Dict, x: torch.Tensor, pos: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """One attention block's decode step; `cache` is updated in place."""
    h, _ = attn_mod.decode_attention(
        bp["attn"], apply_norm(bp["ln1"], x, cfg), cache, pos, cfg,
        use_rope=cfg.pos_embed == "rope")
    return _ffn_residual(bp, x + h, cfg)


def decode_step(
    params: Dict,
    cache: Dict,
    tokens: torch.Tensor,  # (B, 1)
    pos: int,  # position being written
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict]:
    """One token for every sequence in the batch. Returns (logits, cache);
    the cache is updated in place."""
    x = _embed_tokens(params, tokens)
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"][pos:pos + 1]
    k_all, v_all = cache["pos0"]["k"], cache["pos0"]["v"]
    for l, bp in enumerate(params["blocks"]):
        x = _decode_block(bp, {"k": k_all[l], "v": v_all[l]}, x, pos, cfg)
    return _head(params, x, cfg), cache


def prefill(
    params: Dict,
    batch: Dict,
    cfg: ModelConfig,
    max_seq: int,
) -> Tuple[torch.Tensor, Dict]:
    """Consume a prompt, produce (logits (B, S, V), decode cache at pos=S).

    Runs the full forward while writing each layer's K/V into a cache that
    is zero past S, as the reference's padded cache is."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"][:S]
    use_rope = cfg.pos_embed == "rope"
    cache = init_cache(cfg, B, max_seq, x.device)
    k_all, v_all = cache["pos0"]["k"], cache["pos0"]["v"]
    for l, bp in enumerate(params["blocks"]):
        h, k, v = attn_mod.self_attention(
            bp["attn"], apply_norm(bp["ln1"], x, cfg), cfg, positions,
            causal=True, use_rope=use_rope)
        k_all[l, :, :S] = k
        v_all[l, :, :S] = v
        x = _ffn_residual(bp, x + h, cfg)
    return _head(params, x, cfg), cache
