"""GQA/MQA/MHA attention: the full-sequence (prefill) path and the
KV-cache decode path.

The counterpart of `repro/models/attention.py`. Both paths compute the
reference's function through the port's attention kernels instead of the
reference's chunked jnp softmax:

- `self_attention` (and `attention`, its output alone) hands the
  projections to the flash kernel as strided views: (B, S, H, hd) ->
  (B, S, Hkv, G, hd) -> (B, Hkv, S, G, hd), and the keys and values
  (B, S, Hkv, hd) -> (B, Hkv, S, hd). Query head h belongs to KV head
  h // G. Causal attention goes through `ops.flash_attention`, full
  attention (an encoder's) through `ops.full_attention`, which takes any
  length.
- Cross-attention (`attention(x_kv=...)`, `cross_attention` over
  `precompute_cross_kv`'s keys and values) attends the decoder's S
  queries over the encoder's Skv positions through `ops.full_attention`,
  without a mask and without a rotary embedding on the keys.
- `decode_attention` writes the new token's K/V into the cache at `pos`
  and hands `ops.decode_attention` the cache (B, S_max, Hkv, hd) as a
  (B, Hkv, S_max, hd) view, masked to `pos + 1` positions; the cache is
  not copied. `decode_cross_attention` reads the static cross cache the
  same way over all of its rows, the zero padding past the encoder's
  length included, as the reference's unmasked softmax does.

In a placed train step (`distributed.sharding.Placement`) whose `model`
axis splits the query heads, `attention` computes this rank's heads
alone (`wq`/`bq` by columns, `wo` by rows) on its input copied to
`model`, and sums the output over `model`. Where `model` splits the KV
heads too, the rank's KV heads are its own; where it does not (fewer KV
heads than ranks), the rank gathers `wk`/`wv` whole and keeps the KV
heads its query heads read, their gradient summed back to the owners.
Under Megatron sequence parallelism (`Placement.seq`) the input is this
rank's block of the sequence, gathered on entry and reduce-scattered on
the way out (`Placement.enter`, `Placement.leave`).

Placed serving (under `torch.no_grad()`). Prefill computes as training
does, by heads (`attention_kv`), but the cache keeps every KV head at
this rank's block of positions: where the rank computed only its own
KV heads, `cache_kv` recomputes the keys and values of its block of the
prompt for every KV head from `wk`/`wv` gathered over `model`. Decode
(flash decoding, `Placement.kv_split`): q, k and v of the new token are
computed by heads and gathered over `model` (each rank holds every KV
head at its positions, so it reads every query head), the token's K/V is
written by the rank whose block holds `pos` alone, kernel 7's partial
form runs over this rank's block (its length clamp(pos + 1 - r S/tp, 0,
S/tp)), `Placement.combine_over_model` merges the partials, and `wo`
applies this rank's rows, the sum over `model` after it. Where `model`
does not divide the heads the block's weights are whole
(`lm._placed_block`) and so is the projection.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, apply_rope, dense_init


def attn_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    shapes = {
        "wq": (d, nh * hd),
        "wk": (d, nkv * hd),
        "wv": (d, nkv * hd),
        "wo": (nh * hd, d),
    }
    if cfg.qkv_bias:
        shapes.update(
            {"bq": (nh * hd,), "bk": (nkv * hd,), "bv": (nkv * hd,)}
        )
    return shapes


def init_attn(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    """Weights from `generator` on its device; biases zero."""
    params = {}
    for name, shape in attn_param_shapes(cfg).items():
        if name.startswith("b"):
            params[name] = torch.zeros(shape, dtype=cfg.param_dtype,
                                       device=generator.device)
        else:
            params[name] = dense_init(generator, shape[0], shape[1],
                                      cfg.param_dtype)
    return params


def _cols(y: torch.Tensor, full: int, placement) -> torch.Tensor:
    """A projection's output y (..., n): whole, gathered over `model`
    where its weight's columns are split there (n < full)."""
    if placement is None or y.shape[-1] == full:
        return y
    return placement.gather_model(y, y.ndim - 1)


def _project_q(params: Dict, x: torch.Tensor, cfg: ModelConfig,
               placement=None) -> torch.Tensor:
    """x: (B, S, d) -> q (B, S, H, hd) (every head: gathered over `model`
    under a `placement` whose `model` axis splits `wq`)."""
    B, S, _ = x.shape
    q = x @ params["wq"]
    if cfg.qkv_bias:
        q = q + params["bq"]
    q = _cols(q, cfg.n_heads * cfg.head_dim, placement)
    return q.reshape(B, S, cfg.n_heads, cfg.head_dim)


def _project_kv(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                placement=None):
    """x: (B, S, d) -> k, v (B, S, Hkv, hd) (every KV head under a
    `placement`, as `_project_q`)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        k = k + params["bk"]
        v = v + params["bv"]
    full = cfg.n_kv_heads * hd
    k, v = _cols(k, full, placement), _cols(v, full, placement)
    return (k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


def _project_qkv(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 x_kv: Optional[torch.Tensor] = None):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,Skv,Hkv,hd) from `x_kv`
    (B, Skv, d), x itself when None."""
    k, v = _project_kv(params, x if x_kv is None else x_kv, cfg)
    return _project_q(params, x, cfg), k, v


def precompute_cross_kv(params: Dict, enc_out: torch.Tensor,
                        cfg: ModelConfig) -> Dict:
    """The keys and values of `enc_out` (B, S, d): {"k", "v"} each
    (B, S, Hkv, hd)."""
    k, v = _project_kv(params, enc_out, cfg)
    return {"k": k, "v": v}


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, Skv, Hkv, hd) -> (B, S, H * hd) in q's
    dtype, on views (no copies of q, k or v): causal (Skv == S) through
    `ops.flash_attention`, full through `ops.full_attention`."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    q5 = q.view(B, S, Hkv, H // Hkv, hd).permute(0, 2, 1, 3, 4)
    k4, v4 = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    if causal:
        out = ops.flash_attention(q5, k4, v4, causal=True)
    else:
        out = ops.full_attention(q5, k4, v4)  # (B, Hkv, S, G, hd) f32
    return out.permute(0, 2, 1, 3, 4).reshape(B, S, H * hd).to(q.dtype)


def self_attention(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                   positions: Optional[torch.Tensor] = None,
                   causal: bool = True, use_rope: bool = True):
    """Full-sequence self-attention of x (B, S, d) -> (out (B, S, d), k, v),
    k and v (B, S, Hkv, hd) after the rotary embedding, as prefill caches
    them."""
    S = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return grouped_attention(q, k, v, causal) @ params["wo"], k, v


def cross_attention(params: Dict, x: torch.Tensor, kv: Dict,
                    cfg: ModelConfig,
                    positions: Optional[torch.Tensor] = None,
                    use_rope: bool = False) -> torch.Tensor:
    """x (B, S, d) attending over precomputed keys and values `kv`
    ({"k", "v"}: (B, Skv, Hkv, hd)), non-causal: (B, S, d). The rotary
    embedding, when asked for, turns the queries only."""
    q = _project_q(params, x, cfg)
    if use_rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
    return grouped_attention(q, kv["k"], kv["v"], causal=False) \
        @ params["wo"]


def _own_heads(params: Dict, cfg: ModelConfig, placement):
    """(this rank's projections, the config of its heads) where `model`
    splits the query heads (at one `model` rank, every head), else None.
    Rank r holds query heads
    [r H/tp, (r+1) H/tp); query head h reads KV head h // (H / Hkv). Where
    `model` does not split the KV heads, `wk`/`wv` (and their biases) are
    gathered whole with their gradient summed over `model`, and the rank
    keeps the KV heads its query heads read: each once where they group
    evenly, else one for each query head."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if placement is None or params["wq"].shape[1] * placement.tp != H * hd:
        return None
    tp = placement.tp
    hl = H // tp
    own = dict(params)
    n_kv = Hkv // tp
    if Hkv % tp:
        G = H // Hkv
        read = [(placement.tp_rank * hl + i) // G for i in range(hl)]
        kept = sorted(set(read))
        even = [kept[i // (hl // len(kept))] for i in range(hl)] \
            if hl % len(kept) == 0 else None
        sel = kept if even == read else read
        idx = torch.tensor(sel, device=params["wk"].device)
        for name in ("wk", "wv", "bk", "bv"):
            if name not in params:
                continue
            w = params[name]
            w = placement.gather_model(w, w.ndim - 1, summed=True) \
                if w.shape[-1] != Hkv * hd else placement.copy_to_model(w)
            own[name] = w.unflatten(-1, (Hkv, hd)).index_select(
                -2, idx).flatten(-2)
        n_kv = len(sel)
    return own, dataclasses.replace(cfg, n_heads=hl, n_kv_heads=n_kv,
                                    d_head=hd)


def attention(params: Dict, x: torch.Tensor, cfg: ModelConfig,
              positions: Optional[torch.Tensor] = None, causal: bool = True,
              use_rope: bool = True,
              x_kv: Optional[torch.Tensor] = None,
              placement=None) -> torch.Tensor:
    """Full-sequence attention (training / prefill). x: (B, S, d); with
    `x_kv` (B, Skv, d) cross-attention over it (non-causal, the keys not
    turned by the rotary embedding). Under a `placement` that splits the
    heads over `model`, this rank's heads (`_own_heads`) between
    Megatron's two operators."""
    return attention_kv(params, x, cfg, positions, causal, use_rope, x_kv,
                        placement)[0]


def attention_kv(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor] = None,
                 causal: bool = True, use_rope: bool = True,
                 x_kv: Optional[torch.Tensor] = None, placement=None):
    """`attention`, and the keys and values it attended over: (out, k, v,
    every) with k, v (B, Skv, n, hd) as a cache keeps them (after the
    rotary embedding) and `every` whether they are every KV head in order
    (else this rank's own, `_own_heads`)."""
    own = _own_heads(params, cfg, placement)
    every = own is None or placement.tp == 1
    if own is not None:
        params, cfg = own
        if x_kv is not None:
            x_kv = placement.copy_to_model(x_kv)
    if placement is not None:
        x = placement.enter(x, own is not None)
    if x_kv is not None:
        kv = precompute_cross_kv(params, x_kv, cfg)
        out = cross_attention(params, x, kv, cfg, positions, use_rope)
        k, v = kv["k"], kv["v"]
    else:
        out, k, v = self_attention(params, x, cfg, positions, causal,
                                   use_rope)
    if placement is not None:
        out = placement.leave(out, own is not None)
    return out, k, v, every


def cache_kv(params: Dict, x: torch.Tensor, cfg: ModelConfig,
             positions: Optional[torch.Tensor], use_rope: bool,
             placement) -> Tuple[torch.Tensor, torch.Tensor]:
    """The keys and values of x (B, n, d) at `positions` (turned by the
    rotary embedding where `use_rope`) for every KV head, from `wk`/`wv`
    (and their biases) gathered over `model` where split: what a placed
    prefill's cache keeps where the rank computed its own KV heads."""
    hd, Hkv = cfg.head_dim, cfg.n_kv_heads
    whole = {n: t if t.shape[-1] == Hkv * hd
             else placement.gather_model(t, t.ndim - 1)
             for n, t in params.items() if n in ("wk", "wv", "bk", "bv")}
    k, v = _project_kv(whole, x, cfg)
    if use_rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  device: torch.device, dtype=None) -> Dict:
    """One layer's KV cache: (B, S_max, n_kv, hd) x 2."""
    dtype = dtype or cfg.param_dtype
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(
    params: Dict,
    x: torch.Tensor,  # (B, 1, d)
    cache: Dict,  # {"k","v"}: (B, S_max, n_kv, hd), updated in place
    pos: int,  # index of the new token
    cfg: ModelConfig,
    use_rope: bool = True,
    placement=None,
) -> Tuple[torch.Tensor, Dict]:
    """One decode step against a pre-filled cache. Returns (out, cache).

    The new token's K/V are written into `cache` at `pos` in place. The
    reference's one-hot multiply-add update gives the same values bit for
    bit (every other position is multiplied by 1 and added to 0), so the
    in-place write changes nothing but the copy it saves.

    Under a `placement` (see the module's docstring) `cache` is this
    rank's block: every KV head, and where `Placement.kv_split` the
    positions [r S, (r+1) S) of `model` rank r, S its length."""
    B = x.shape[0]
    hd = cfg.head_dim
    k_new, v_new = _project_kv(params, x, cfg, placement)
    q = _project_q(params, x, cfg, placement)
    if use_rope:
        p = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, p, cfg.rope_theta)
        k_new = apply_rope(k_new, p, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    split = placement is not None and placement.kv_split
    lo = placement.tp_rank * k.shape[1] if split else 0
    if lo <= pos < lo + k.shape[1]:
        k[:, pos - lo] = k_new[:, 0].to(k.dtype)
        v[:, pos - lo] = v_new[:, 0].to(v.dtype)

    Hkv, H = cfg.n_kv_heads, cfg.n_heads
    qh = q.reshape(B, Hkv, H // Hkv, hd).to(k.dtype)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    if split:
        n = min(max(pos + 1 - lo, 0), k.shape[1])
        out = placement.combine_over_model(
            *ops.decode_attention(qh, kt, vt, n, lse=True))
    else:
        out = ops.decode_attention(qh, kt, vt, pos + 1)  # (B, Hkv, G, hd)
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    return _out_proj(params, out, placement), cache


def _out_proj(params: Dict, out: torch.Tensor, placement) -> torch.Tensor:
    """`out` (B, 1, H hd), every head, through `wo`: under a `placement`
    whose `model` axis splits `wo`'s rows, this rank's rows and the sum
    over `model`."""
    wo = params["wo"]
    if placement is None or wo.shape[0] == out.shape[-1]:
        return out @ wo
    n = wo.shape[0]
    own = out[..., placement.tp_rank * n:(placement.tp_rank + 1) * n]
    return placement.reduce_from_model(own @ wo)


def decode_cross_attention(params: Dict, x: torch.Tensor, kv: Dict,
                           cfg: ModelConfig, placement=None) -> torch.Tensor:
    """Cross-attention of one decode token x (B, 1, d) over the static
    cross cache `kv` ({"k", "v"}: (B, S_src, Hkv, hd)), through
    `ops.decode_attention` on a (B, Hkv, S_src, hd) view of every row:
    nothing is masked, as in the reference. Under a `placement` the cross
    cache is whole on every `model` rank: q gathered over `model`, `wo`
    by rows as `decode_attention`."""
    B = x.shape[0]
    hd, Hkv, H = cfg.head_dim, cfg.n_kv_heads, cfg.n_heads
    k, v = kv["k"], kv["v"]
    qh = _project_q(params, x, cfg, placement).reshape(
        B, Hkv, H // Hkv, hd).to(k.dtype)
    out = ops.decode_attention(qh, k.permute(0, 2, 1, 3),
                               v.permute(0, 2, 1, 3), k.shape[1])
    return _out_proj(params, out.reshape(B, 1, H * hd).to(x.dtype),
                     placement)
