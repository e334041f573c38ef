"""The LM stack: init, the quantized forward and loss, prefill and decode.

The counterpart of `repro/models/lm.py` for all ten archs: attention
blocks with dense or mixture-of-experts FFNs, Mamba (jamba), mLSTM and
sLSTM (xlstm), the encoder-decoder with cross-attention (whisper, over
stub frame embeddings `batch["frames"]`) and the patch prefix (llava,
`batch["patches"]` prepended to the token embeddings). The reference
stacks each block parameter over periods and scans them; here
`params["blocks"]` (and whisper's `params["enc_blocks"]`) is a list with
one dict per layer and the scan is a Python loop (layer n * period + i
is the reference's period n, position i). The decode cache keeps the
reference's layout, `{"pos<i>": {leaf: (n_periods, ...)}}` ({"k", "v"}
for attention, and the cross cache {"xk", "xv"} at `max_source_len` for
whisper's decoder; {"conv", "ssm"} for Mamba; {"C", "n", "m"} and {"c",
"n", "h", "m"} for the two xLSTM cells), so both compare leaf for leaf;
a decode step updates it in place.

Quantization (HERO applied to LMs): `LMQuantSpec` carries bit tensors,
per-embedding-band bits (the hash-level analogue) and per-layer (w, a)
bits over 4 projection groups (mixer-in / mixer-out / ffn-in / ffn-out).
Weights and activations are fake-quantized in float32 through the
paper's quantizers (`quant.linear_quant`, `quant.qat.ste_fake_quant`),
whatever the model's dtype, and cast back, as the reference's promotion
does. Bits >= 16 are the full-precision sentinel: the quantized value is
still computed and then not selected, so a degenerate range never leaks.

Rematerialisation: where `cfg.remat` is set and autograd records, each
period's blocks (`period(cfg)` consecutive layers, the reference's scan
body; one layer of whisper's encoder) run under
`torch.utils.checkpoint`: between forward and backward only each
period's input is kept, and backward runs the period again. Nothing
random runs inside a block, so no RNG state is restored.

Placed training (`placement`, a `distributed.sharding.Placement`): the
parameters are this rank's blocks, gathered over the FSDP axes where
they are used (`gather_on_use`; a period's inside its checkpoint, so
backward gathers them again and at most one period's are alive at a
time). Over `model`: the embedding is vocab-parallel (each rank looks up
its rows, zeros elsewhere, summed over `model`), the head gives
vocab-split logits and `loss_fn` takes a vocab-parallel cross entropy;
attention, mLSTM and sLSTM split their heads, Mamba its inner channels,
the dense FFN its hidden units, MoE its experts (`models.attention`,
`models.xlstm_blocks`, `models.ssm`, `models.ffn`). A mixer whose heads
(or, for Mamba, channels) `model` does not divide computes on its
weights gathered over `model` as well, whole on every `model` rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm_blocks as xl
from repro_torch.models.common import (
    ModelConfig,
    apply_norm,
    dense_init,
    layer_kind,
    norm_init,
)
from repro_torch.quant.linear_quant import activation_qparams, weight_qparams
from repro_torch.quant.qat import ste_fake_quant

N_GROUPS = 4  # quant groups per layer: mixer_in, mixer_out, ffn_in, ffn_out

# Param-name -> quant group (absent = keep full precision: routers, gates,
# SSM dynamics (x_proj, dt_proj, conv_w, A_log, D), norms, biases).
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


_STACKED = (("blocks", period), ("enc_blocks", lambda cfg: 1))


def _stack(leaves: List):
    x = leaves[0]
    if isinstance(x, dict):
        return {k: _stack([l[k] for l in leaves]) for k in x}
    if isinstance(x, tuple):  # a named tuple of leaves (int8 moments)
        return type(x)(*(_stack([l[i] for l in leaves])
                         for i in range(len(x))))
    return torch.stack(leaves)


def _row(tree, n: int):
    if isinstance(tree, dict):
        return {k: _row(v, n) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_row(v, n) for v in tree))
    return tree[n]


def to_reference_layout(tree: Dict, cfg: ModelConfig) -> Dict:
    """A tree that mirrors the port's parameters (the parameters, an AdamW
    moment tree, a host copy of either, or meta tensors; an int8 moment's
    named tuple stacked field by field) in the reference's layout:
    `blocks` stacked over periods under `pos<i>` (layer n * period + i is
    period n's row of `pos<i>`), whisper's `enc_blocks` under `pos0`.
    Checkpoints are written in it, so both packages read them."""
    out = {k: v for k, v in tree.items() if k not in dict(_STACKED)}
    for key, per in _STACKED:
        if key in tree:
            layers, p = tree[key], per(cfg)
            out[key] = {f"pos{i}": _stack(layers[i::p]) for i in range(p)}
    return out


def from_reference_layout(tree: Dict, cfg: ModelConfig) -> Dict:
    """`to_reference_layout` undone: one dict a layer (views of the
    stacked rows)."""
    out = {k: v for k, v in tree.items() if k not in dict(_STACKED)}
    for key, per in _STACKED:
        if key in tree:
            p = per(cfg)
            pos = [tree[key][f"pos{i}"] for i in range(p)]
            first = pos[0]
            while isinstance(first, (dict, tuple)):
                first = next(iter(first.values())) \
                    if isinstance(first, dict) else first[0]
            out[key] = [_row(pos[i], n) for n in range(first.shape[0])
                        for i in range(p)]
    return out


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


def _layer_kind(cfg: ModelConfig, layer: int) -> str:
    return _block_kinds(cfg)[layer % period(cfg)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_block(generator: torch.Generator, cfg: ModelConfig, kind: str,
                has_moe: bool) -> Dict:
    """One block of mixer `kind` with its dense or MoE FFN, where the
    config has one (never for xlstm)."""
    dev = generator.device
    d = cfg.d_model
    p: Dict = {"ln1": norm_init(cfg, d, dev)}
    if kind in ("attn", "enc", "dec"):
        p["attn"] = attn_mod.init_attn(generator, cfg)
        if kind == "dec":
            p["ln_x"] = norm_init(cfg, d, dev)
            p["xattn"] = attn_mod.init_attn(generator, cfg)
    elif kind == "mamba":
        p["ssm"] = ssm_mod.init_ssm(generator, cfg)
    elif kind == "mlstm":
        p["mlstm"] = xl.init_mlstm(generator, cfg)
    elif kind == "slstm":
        p["slstm"] = xl.init_slstm(generator, cfg)
    else:
        raise ValueError(kind)
    if cfg.pattern != "xlstm" and cfg.d_ff > 0 or has_moe:
        p["ln2"] = norm_init(cfg, d, dev)
        if has_moe:
            p["moe"] = ffn_mod.init_moe(generator, cfg)
        else:
            p["ffn"] = ffn_mod.init_ffn(generator, cfg)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict:
    """Random parameters from `generator`, drawn on `device` (the card
    unless `device="cpu"`), which must be the generator's device."""
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
    params["blocks"] = [
        _init_block(generator, cfg, _layer_kind(cfg, l),
                    _layer_has_moe(cfg, l)) for l in range(cfg.n_layers)]
    if cfg.pattern == "encdec":
        params["enc_blocks"] = [_init_block(generator, cfg, "enc", False)
                                for _ in range(cfg.encoder_layers)]
        params["enc_pos_embed"] = dense_init(
            generator, cfg.max_source_len, d, cfg.param_dtype, scale=0.02)
        params["enc_final_norm"] = norm_init(cfg, d, generator.device)
    return params


def _without_storage(tree):
    """Each tensor of `tree` as a `meta` tensor of its shape and dtype."""
    from repro_torch.tree_util import map_with_path

    return map_with_path(lambda _, t: torch.empty(
        t.shape, dtype=t.dtype, device="meta"), tree)


def param_specs(cfg: ModelConfig) -> Dict:
    """The parameters' tree, each leaf a `meta` tensor of its shape and
    dtype (no storage): the dry-run's input, the counterpart of the
    reference's `jax.eval_shape` tree (in the port's layout:
    `to_reference_layout` gives the reference's shapes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return _without_storage(init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"))


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Dict:
    """`init_cache`'s tree as `meta` tensors (no storage)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return _without_storage(init_cache(cfg, batch, max_seq, "cpu"))


def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                      dev: torch.device) -> Dict:
    if kind in ("attn", "dec"):
        c = attn_mod.init_kv_cache(cfg, batch, max_seq, dev)
        if kind == "dec":
            shape = (batch, cfg.max_source_len, cfg.n_kv_heads, cfg.head_dim)
            c["xk"] = torch.zeros(shape, dtype=cfg.param_dtype, device=dev)
            c["xv"] = torch.zeros(shape, dtype=cfg.param_dtype, device=dev)
        return c
    if kind == "mamba":
        return ssm_mod.init_ssm_cache(cfg, batch, dev)
    if kind == "mlstm":
        return xl.init_mlstm_cache(cfg, batch, dev)
    if kind == "slstm":
        return xl.init_slstm_cache(cfg, batch, dev)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict:
    """The initial decode cache in the reference's layout: for each
    position i of a period, {"pos<i>": {leaf: (n_periods, ...)}} with the
    leaves of that position's block kind (zeros; the xLSTM stabilizers
    at -1e30)."""
    dev = resolve_device(device)
    p = period(cfg)
    n_periods = cfg.n_layers // p
    return {f"pos{i}": {
        name: leaf.expand((n_periods,) + leaf.shape).contiguous()
        for name, leaf in _init_block_cache(cfg, kind, batch, max_seq,
                                            dev).items()}
        for i, kind in enumerate(_block_kinds(cfg))}


def _layer_cache(cache: Dict, layer: int, p: int) -> Dict:
    """Layer `layer`'s views into the cache: every leaf of its position
    at its period (writes through them update the cache)."""
    return {name: leaf[layer // p]
            for name, leaf in cache[f"pos{layer % p}"].items()}


def _store(cache: Dict, state: Dict) -> None:
    """Write a recurrent block's new state into its cache views."""
    for name, t in state.items():
        cache[name].copy_(t)


# ---------------------------------------------------------------------------
# Forward (training shape / scoring)
# ---------------------------------------------------------------------------
def _used(params: Dict, name: str, placement):
    """Top-level parameter `name` as a layer computes on it: gathered over
    the FSDP axes under a placement."""
    t = params[name]
    return t if placement is None else placement.use(t, placement.specs[name])


def _embed_rows(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                spec: Optional[LMQuantSpec] = None, placement=None
                ) -> Tuple[torch.Tensor, bool]:
    """(the token embeddings, whether `model` splits the vocabulary):
    where it does, this rank's rows and zeros for the others' tokens (a
    part of the sum over `model`)."""
    table = _used(params, "embed", placement)
    if spec is not None:
        table = quant_embedding(table, spec.embed_bits, spec.paper_exact)
    n = table.shape[0]
    if n == cfg.vocab_size:
        return table[tokens], False
    local = tokens - placement.tp_rank * n
    mine = (local >= 0) & (local < n)
    x = table[torch.where(mine, local, 0)]
    return torch.where(mine[..., None], x, torch.zeros(
        (), dtype=x.dtype, device=x.device)), True


def _embed_tokens(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                  spec: Optional[LMQuantSpec] = None,
                  placement=None) -> torch.Tensor:
    x, split = _embed_rows(params, tokens, cfg, spec, placement)
    return placement.reduce_from_model(x) if split else x


def _embed_inputs(params: Dict, batch: Dict, cfg: ModelConfig,
                  spec: Optional[LMQuantSpec] = None,
                  placement=None) -> torch.Tensor:
    """The token embeddings, behind llava's patch embeddings. Under
    sequence parallelism (`placement.seq`), this rank's block of their
    sequence: the vocabulary-parallel parts reduce-scattered (the patches
    counted once, on `model` rank 0), a whole embedding cut."""
    seq = placement is not None and placement.seq
    if not seq:
        x = _embed_tokens(params, batch["tokens"], cfg, spec, placement)
    else:
        x, split = _embed_rows(params, batch["tokens"], cfg, spec, placement)
    if cfg.embed_frontend == "prefix_patches":
        p = batch["patches"].to(x.dtype)
        if seq and split and placement.tp_rank:
            p = torch.zeros_like(p)
        x = torch.cat([p, x], dim=1)
    return placement.leave(x, split) if seq else x


def _head(params: Dict, x: torch.Tensor, cfg: ModelConfig,
          placement=None) -> torch.Tensor:
    """The logits of x: (B, S, V), or this rank's vocabulary columns where
    `model` splits the head (under sequence parallelism the normed block
    gathered first, `Placement.enter`)."""
    norm = _used(params, "final_norm", placement)
    if placement is not None:
        norm = placement.seq_params(norm)
    x = apply_norm(norm, x, cfg)
    if cfg.tie_embeddings:
        head = _used(params, "embed", placement).T
    else:
        head = _used(params, "lm_head", placement)
    if placement is not None:
        x = placement.enter(x, head.shape[1] != cfg.vocab_size)
    return x @ head


def _ffn(bp: Dict, h: torch.Tensor, cfg: ModelConfig, has_moe: bool,
         placement=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on its normed input: (out, aux loss or None)."""
    if has_moe:
        return ffn_mod.moe_ffn(bp["moe"], h, cfg, placement)
    return ffn_mod.ffn(bp["ffn"], h, cfg, placement), None


def _mixer(bp: Dict, h: torch.Tensor, cfg: ModelConfig, kind: str,
           positions: Optional[torch.Tensor], placement=None
           ) -> torch.Tensor:
    """The block's sequence mixer over the full sequence of normed h."""
    if kind in ("attn", "dec", "enc"):
        return attn_mod.attention(bp["attn"], h, cfg, positions=positions,
                                  causal=kind != "enc",
                                  use_rope=cfg.pos_embed == "rope",
                                  placement=placement)
    if kind == "mamba":
        return ssm_mod.ssm_forward(bp["ssm"], h, cfg, placement=placement)
    if kind == "mlstm":
        return xl.mlstm_forward(bp["mlstm"], h, cfg, placement)
    if kind == "slstm":
        return xl.slstm_forward(bp["slstm"], h, cfg, placement)
    raise ValueError(kind)


def _apply_block(bp: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 has_moe: bool, a_bits: Optional[torch.Tensor],
                 enc_out: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None,
                 placement=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block over the full sequence: (x, aux loss). The mixer's and
    the FFN's inputs are fake-quantized at `a_bits[0]` and `a_bits[2]`
    when given; a decoder block ("dec") attends over `enc_out` between
    them."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(bp["ln1"], x, cfg)
    if a_bits is not None:
        h = _maybe_quant_a(h, a_bits[0])
    x = x + _mixer(bp, h, cfg, kind, positions, placement)
    if kind == "dec":
        h = apply_norm(bp["ln_x"], x, cfg)
        x = x + attn_mod.attention(bp["xattn"], h, cfg, causal=False,
                                   use_rope=False, x_kv=enc_out,
                                   placement=placement)
    if "ln2" in bp:
        h = apply_norm(bp["ln2"], x, cfg)
        if a_bits is not None:
            h = _maybe_quant_a(h, a_bits[2])
        h, a = _ffn(bp, h, cfg, has_moe, placement)
        if a is not None:
            aux = aux + a
        x = x + h
    return x, aux


def _placed_block(bp: Dict, specs: Dict, cfg: ModelConfig, placement
                  ) -> Dict:
    """Block `bp` (this rank's blocks, their `specs`) as it computes:
    gathered over the FSDP axes; a mixer that `model` cannot split by
    its heads (attention, mLSTM, sLSTM: `model` does not divide n_heads)
    or its inner channels (Mamba: it does not divide d_inner) gathered
    over `model` too, computed whole on every `model` rank. The others
    cut their heads or channels from what their specs leave (mixers'
    `_own_heads`, `_own_channels`)."""
    bp = placement.use(bp, specs)
    for name in ("ln1", "ln_x", "ln2"):
        if name in bp:
            bp[name] = placement.seq_params(bp[name])
    if placement.tp > 1:
        whole = ["ssm"] if ssm_mod.ssm_dims(cfg)[0] % placement.tp else []
        if cfg.n_heads % placement.tp:
            whole += ["attn", "xattn", "mlstm", "slstm"]
        for name in whole:
            if name in bp:
                bp[name] = placement.whole(bp[name], specs[name])
    return bp


def _run_blocks(blocks: List[Dict], x: torch.Tensor, cfg: ModelConfig,
                kinds: List[str], moe: List[bool],
                spec: Optional[LMQuantSpec], row0: int,
                enc_out: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                per: int = 1, placement=None, specs=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocks in order, block l of kind kinds[l], under spec row
    row0 + l (its weights fake-quantized as it runs: one block's copies
    live at a time): (x, summed aux loss). They run `per` at a time (a
    period), each period under `checkpoint` where `cfg.remat` is set and
    autograd records; under a `placement` a block's parameters are
    gathered inside its period (`_placed_block`, `specs` their specs)."""
    def run(lo, x, aux):
        for l in range(lo, min(lo + per, len(blocks))):
            bp, a_bits = blocks[l], None
            if placement is not None:
                bp = _placed_block(bp, specs[l], cfg, placement)
            if spec is not None:
                bp = _quant_block_weights(bp, spec.w_bits[row0 + l],
                                          spec.paper_exact)
                a_bits = spec.a_bits[row0 + l]
            x, a = _apply_block(bp, x, cfg, kinds[l], moe[l], a_bits,
                                enc_out, positions, placement)
            aux = aux + a
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, len(blocks), per):
        if remat:
            x, aux = checkpoint(run, lo, x, aux, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = run(lo, x, aux)
    return x, aux


def encode_source(params: Dict, frames: torch.Tensor, cfg: ModelConfig,
                  spec: Optional[LMQuantSpec] = None,
                  placement=None) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings (B, S_src, d): full
    self-attention, learned positions; under a spec its layers take the
    spec's first `encoder_layers` rows."""
    S = frames.shape[1]
    x = frames + _used(params, "enc_pos_embed", placement)[:S]
    n = len(params["enc_blocks"])
    x, _ = _run_blocks(params["enc_blocks"], x, cfg, ["enc"] * n,
                       [False] * n, spec, 0, placement=placement,
                       specs=placement and placement.specs["enc_blocks"])
    return apply_norm(_used(params, "enc_final_norm", placement), x, cfg)


def forward(params: Dict, batch: Dict, cfg: ModelConfig,
            spec: Optional[LMQuantSpec] = None, placement=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, V), aux_loss). batch keys: tokens (B, S_text);
    patches (B, P, d) [llava], whose positions lead the sequence; frames
    (B, S_src, d) [whisper]. Under a spec, each layer's weights are
    fake-quantized at its `w_bits` row as the layer runs. Under a
    `placement` (placed training: `params` are this rank's blocks, the
    batch this rank's rows) the logits are this rank's vocabulary columns
    where `model` splits the head. Where `cfg.act_pspec` asks for
    Megatron sequence parallelism (`Placement.sequence_parallel`), the
    decoder's residual stream between blocks is this rank's block of the
    sequence; whisper's encoder keeps its whole."""
    if spec is not None and placement is not None and placement.tp > 1:
        raise ValueError("a quantization spec takes each weight's range "
                         "over the whole tensor: it does not run over a "
                         "model axis that splits the weights")
    S = batch["tokens"].shape[1]
    if cfg.embed_frontend == "prefix_patches":
        S += batch["patches"].shape[1]
    where = placement and placement.sequence_parallel(cfg, S)
    x = _embed_inputs(params, batch, cfg, spec, where)
    positions = torch.arange(S, device=x.device)
    if cfg.pos_embed == "learned":
        pos = _used(params, "pos_embed", placement)[:S]
        if where is not None:
            pos = where.seq_rows(where.seq_params(pos), 0)
        x = x + pos
    enc_out = None
    if cfg.pattern == "encdec":
        enc_out = encode_source(params, batch["frames"], cfg, spec,
                                placement)
    L = len(params["blocks"])
    x, aux = _run_blocks(
        params["blocks"], x, cfg, [_layer_kind(cfg, l) for l in range(L)],
        [_layer_has_moe(cfg, l) for l in range(L)], spec, cfg.encoder_layers,
        enc_out, positions, period(cfg), where,
        placement and placement.specs["blocks"])
    return _head(params, x, cfg, where), aux


def _vocab_parallel_nll(lg: torch.Tensor, labels: torch.Tensor, placement
                        ) -> torch.Tensor:
    """logsumexp(logits) - logits[label] from this rank's vocabulary
    columns `lg` (..., V / tp) f32, without gathering the logits: the max
    over `model` (no gradient: it cancels), the sum of exponentials and
    the gold logit (from the rank that holds it) summed over `model`."""
    n = lg.shape[-1]
    top = placement.max_over_model(torch.amax(lg.detach(), dim=-1))
    logz = top + torch.log(placement.reduce_from_model(
        torch.sum(torch.exp(lg - top[..., None]), dim=-1)))
    local = labels.long() - placement.tp_rank * n
    mine = (local >= 0) & (local < n)
    gold = torch.gather(lg, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    return logz - placement.reduce_from_model(torch.where(mine, gold, 0.0))


def loss_fn(params: Dict, batch: Dict, cfg: ModelConfig,
            spec: Optional[LMQuantSpec] = None, aux_weight: float = 0.01,
            placement=None) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy plus `aux_weight` times the MoE aux loss:
    (loss, {"ce", "aux"}). labels = tokens shifted inside, or explicit
    batch["labels"] (negative = no loss). For llava, patch positions
    carry no loss. Under a `placement`, this rank's rows' loss (see
    `forward`)."""
    logits, aux = forward(params, batch, cfg, spec, placement)
    tokens = batch["tokens"]
    if cfg.embed_frontend == "prefix_patches":
        logits = logits[:, batch["patches"].shape[1]:]
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
    if lg.shape[-1] == cfg.vocab_size:
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
        nll = (logz - gold) * valid
    else:
        nll = _vocab_parallel_nll(lg, labels, placement) * valid
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
                  cfg: ModelConfig, kind: str, has_moe: bool) -> torch.Tensor:
    """One block's decode step; `cache` (the layer's views) is updated in
    place."""
    h = apply_norm(bp["ln1"], x, cfg)
    if kind in ("attn", "dec"):
        h, _ = attn_mod.decode_attention(bp["attn"], h, cache, pos, cfg,
                                         use_rope=cfg.pos_embed == "rope")
    elif kind == "mamba":
        h, state = ssm_mod.ssm_decode_step(bp["ssm"], h, cache, cfg)
        _store(cache, state)
    elif kind == "mlstm":
        h, state = xl.mlstm_decode_step(bp["mlstm"], h, cache, cfg)
        _store(cache, state)
    elif kind == "slstm":
        h, state = xl.slstm_decode_step(bp["slstm"], h, cache, cfg)
        _store(cache, state)
    else:
        raise ValueError(kind)
    x = x + h
    if kind == "dec":
        x = x + attn_mod.decode_cross_attention(
            bp["xattn"], apply_norm(bp["ln_x"], x, cfg),
            {"k": cache["xk"], "v": cache["xv"]}, cfg)
    return _ffn_residual(bp, x, cfg, has_moe)


def decode_step(
    params: Dict,
    cache: Dict,
    tokens: torch.Tensor,  # (B, 1)
    pos: int,  # position being written
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict]:
    """One token for every sequence in the batch. Returns (logits, cache);
    the cache is updated in place. For llava, `pos` counts the patch
    positions before the text."""
    x = _embed_tokens(params, tokens, cfg)
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"][pos:pos + 1]
    p = period(cfg)
    for l, bp in enumerate(params["blocks"]):
        x = _decode_block(bp, _layer_cache(cache, l, p), x, pos, cfg,
                          _layer_kind(cfg, l), _layer_has_moe(cfg, l))
    return _head(params, x, cfg), cache


def prefill(
    params: Dict,
    batch: Dict,
    cfg: ModelConfig,
    max_seq: int,
) -> Tuple[torch.Tensor, Dict]:
    """Consume a prompt (`forward`'s batch keys), produce (logits (B, S,
    V), decode cache at pos=S).

    Runs the full forward while writing each layer's decode state into a
    fresh cache: attention K/V, zero past S as the reference's padded
    cache is; the recurrent blocks' final states; whisper's cross K/V,
    zero past the frames' length up to `max_source_len`. The serve path
    never quantizes (the reference's prefill passes no spec)."""
    x = _embed_inputs(params, batch, cfg)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"][:S]
    enc_out = None
    if cfg.pattern == "encdec":
        enc_out = encode_source(params, batch["frames"], cfg)
    use_rope = cfg.pos_embed == "rope"
    cache = init_cache(cfg, B, max_seq, x.device)
    p = period(cfg)
    for l, bp in enumerate(params["blocks"]):
        kind = _layer_kind(cfg, l)
        c = _layer_cache(cache, l, p)
        h = apply_norm(bp["ln1"], x, cfg)
        if kind in ("attn", "dec"):
            h, k, v = attn_mod.self_attention(bp["attn"], h, cfg, positions,
                                              causal=True, use_rope=use_rope)
            c["k"][:, :S] = k
            c["v"][:, :S] = v
        elif kind == "mamba":
            h, state = ssm_mod.ssm_forward(bp["ssm"], h, cfg,
                                           return_state=True)
            _store(c, state)
        elif kind == "mlstm":
            _store(c, xl.mlstm_final_state(bp["mlstm"], h, cfg))
            h = xl.mlstm_forward(bp["mlstm"], h, cfg)
        elif kind == "slstm":
            h, state = xl.slstm_forward_with_state(bp["slstm"], h, cfg)
            _store(c, state)
        else:
            raise ValueError(kind)
        x = x + h
        if kind == "dec":
            xkv = attn_mod.precompute_cross_kv(bp["xattn"], enc_out, cfg)
            x = x + attn_mod.cross_attention(
                bp["xattn"], apply_norm(bp["ln_x"], x, cfg), xkv, cfg)
            S_src = enc_out.shape[1]
            c["xk"][:, :S_src] = xkv["k"]
            c["xv"][:, :S_src] = xkv["v"]
        x = _ffn_residual(bp, x, cfg, _layer_has_moe(cfg, l))
    return _head(params, x, cfg), cache
