"""FFN blocks: dense (GLU / gelu / squared-ReLU) and mixture-of-experts.

The counterpart of `repro/models/ffn.py`. MoE uses the reference's
sort-free capacity dispatch: each (token, slot)'s position in its expert
is the exclusive prefix count of earlier pairs routed there (a
group-local cumsum plus cross-group offsets, the same global order as one
flat cumsum), pairs at or past the global capacity C are dropped, the
kept ones are scattered into an (E, C, d) buffer, the experts run as
batched products, and the outputs are scattered back weighted by their
gates. All routing is integer work, and each (expert, slot) holds at most
one token, so the float scatters add a value to zeros only: exact on the
card too. The combine adds up to `top_k` contributions a token, in the
order of the slots on the CPU and in any order on the card.

In a placed train step (`distributed.sharding.Placement`) the dense FFN
is Megatron's column/row-parallel pair over `model`, the experts are
split over `model` (expert parallelism), and the routing of a batch
split over ranks is the whole microbatch's: its statistics and each
rank's expert counts come from small collectives over the batch axes.
Under Megatron sequence parallelism (`Placement.seq`) both enter on this
rank's block of the sequence and gather it (`Placement.enter`); the
routing, which every `model` rank computes whole, reads the gathered
input through `Placement.shared`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.common import ACT_FNS, ModelConfig, MoEConfig, dense_init


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------
def ffn_param_shapes(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, dff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.ffn_type in ("swiglu", "geglu"):
        return {"w_gate": (d, dff), "w_in": (d, dff), "w_out": (dff, d)}
    return {"w_in": (d, dff), "w_out": (dff, d)}


def init_ffn(generator: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Dict:
    return {name: dense_init(generator, shape[0], shape[1], cfg.param_dtype)
            for name, shape in ffn_param_shapes(cfg, d_ff).items()}


def ffn(params: Dict, x: torch.Tensor, cfg: ModelConfig,
        placement=None) -> torch.Tensor:
    """The dense FFN of x (..., d). Under a `placement` whose `model` axis
    splits the hidden units (`w_gate`/`w_in` by columns, `w_out` by rows:
    Megatron's column- and row-parallel pair), this rank's units of the
    input copied to `model`, their partial output summed over it."""
    if placement is not None:
        split = params["w_in"].shape[1] * placement.tp == cfg.d_ff
        return placement.leave(ffn(params, placement.enter(x, split), cfg),
                               split)
    if cfg.ffn_type == "swiglu":
        h = ACT_FNS["silu"](x @ params["w_gate"]) * (x @ params["w_in"])
    elif cfg.ffn_type == "geglu":
        h = ACT_FNS["gelu"](x @ params["w_gate"]) * (x @ params["w_in"])
    elif cfg.ffn_type == "gelu":
        h = ACT_FNS["gelu"](x @ params["w_in"])
    elif cfg.ffn_type == "relu2":
        h = ACT_FNS["relu2"](x @ params["w_in"])
    else:
        raise ValueError(cfg.ffn_type)
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------
def moe_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    m = cfg.moe
    d = cfg.d_model
    dffe = m.d_ff_expert or cfg.d_ff
    glu = cfg.ffn_type in ("swiglu", "geglu")
    shapes = {"router": (d, m.n_experts)}
    if glu:
        shapes["experts_gate"] = (m.n_experts, d, dffe)
    shapes["experts_in"] = (m.n_experts, d, dffe)
    shapes["experts_out"] = (m.n_experts, dffe, d)
    return shapes


def init_moe(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    """The router in f32 (`dense_init`), each expert stack N(0, 1) /
    sqrt(its second axis) in the model's dtype, and the dense residual FFN
    when the config has one; drawn from `generator` on its device."""
    params = {}
    for name, shape in moe_param_shapes(cfg).items():
        if name == "router":
            params[name] = dense_init(generator, shape[0], shape[1],
                                      torch.float32)
        else:
            w = torch.randn(shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            params[name] = w.div_(math.sqrt(shape[1])).to(cfg.param_dtype)
    if cfg.moe.dense_residual:
        params["dense"] = init_ffn(generator, cfg)
    return params


def moe_capacity(n_tokens: int, mcfg: MoEConfig) -> int:
    """Static per-expert capacity, rounded up to a multiple of 8."""
    c = math.ceil(n_tokens * mcfg.top_k * mcfg.capacity_factor / mcfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _one_hot(ids: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """`F.one_hot(ids, len(classes))` (int64) as one comparison: the same
    ops on any tensor (`F.one_hot` checks its ids' range on real tensors
    and not on tensors without data, so a dry-run would count other ops
    than the card runs)."""
    return (ids[..., None] == classes).long()


@dataclasses.dataclass
class MoERouting:
    """One MoE layer's routing of T tokens: every (token, slot) pair in
    token-major order (pair i is token i // top_k's slot i % top_k)."""

    gate_vals: torch.Tensor  # (T, k) normalized top-k gates
    expert_ids: torch.Tensor  # (T, k) int64
    flat_pos: torch.Tensor  # (T*k,) position of each pair in its expert
    keep: torch.Tensor  # (T*k,) bool: flat_pos < capacity
    slot: torch.Tensor  # (T*k,) flat (expert, slot) index; dropped: slot 0
    slot_tok: torch.Tensor  # (E, C) token in each slot; T = empty
    slot_gate: torch.Tensor  # (E, C) f32 gate of each slot; 0 = empty
    capacity: int
    aux_loss: torch.Tensor  # () Switch-style load-balancing loss
    mine: torch.Tensor  # (T*k,) bool: kept, in the slot maps' experts

    def dropped_share(self) -> float:
        """Share of (token, slot) pairs over capacity."""
        return float(1.0 - self.keep.float().mean())


def moe_route(params: Dict, xt: torch.Tensor, cfg: ModelConfig,
              placement=None, experts: Tuple[int, int] = (0, 0)
              ) -> MoERouting:
    """Route the tokens xt (T, d): router softmax in the router's dtype,
    top-k gates renormalized to sum 1, the aux loss E * sum(mean(probs) *
    frac(top-1)), each pair's global position in its expert (a
    group-local exclusive cumsum plus exclusive group offsets), the keep
    mask against the global capacity C = `moe_capacity(T)`, and the slot
    maps: the (expert, slot) -> token map by an integer `amin` scatter
    (dropped pairs offer the sentinel T) and the slot gates by an exact
    add into zeros.

    Under a `placement` that splits the batch, xt is this rank's rows of
    the microbatch and the routing is the whole microbatch's: the sums of
    `probs` and the top-1 counts are summed over the batch axes, C is the
    capacity of all T_global tokens, and a pair's position is its local
    one plus the counts of the ranks before this one (their rows come
    first in the one-process order). The slot maps then hold this rank's
    own slots of each expert, min(C, T) an expert (an expert takes each
    token at most once). `experts` (first, count) restricts the slot maps
    to a range of experts, expert parallelism's; count 0 means all."""
    m = cfg.moe
    T = xt.shape[0]
    E, k = m.n_experts, m.top_k
    dev = xt.device
    rows = 1 if placement is None else placement.rows
    rdt = getattr(torch, m.router_dtype)
    logits = xt.to(rdt) @ params["router"].to(rdt)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)  # (T, k)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)

    classes = torch.arange(E, device=dev)
    top1 = _one_hot(expert_ids[:, 0], classes).to(torch.float32)
    if rows == 1:
        me = torch.mean(probs, dim=0)  # (E,)
        ce = torch.mean(top1, dim=0)
        G = m.dispatch_groups if T % max(m.dispatch_groups, 1) == 0 else 1
    else:
        n = T * rows
        me = placement.sum_over_batch(torch.sum(probs, dim=0)) / n
        ce = placement.sum_over_batch(torch.sum(top1, dim=0)) / n
        G = 1  # any grouping gives the flat order
    aux_loss = E * torch.sum(me * ce)

    Tg = T // G
    ids_g = expert_ids.reshape(G, Tg * k)  # (G, Tg*k)
    onehot = _one_hot(ids_g, classes)  # (G, Tg*k, E) int64
    pos_local = torch.cumsum(onehot, dim=1) - onehot  # exclusive, per group
    counts = torch.sum(onehot, dim=1)  # (G, E)
    group_base = torch.cumsum(counts, dim=0) - counts  # exclusive over groups
    pos = torch.gather(pos_local, 2, ids_g[..., None])[..., 0]
    base = torch.gather(group_base, 1, ids_g)  # (G, Tg*k)
    flat_pos = (pos + base).reshape(-1)
    flat_ids = expert_ids.reshape(-1)
    if rows == 1:
        C = moe_capacity(T, m)
        C_buf, buf_pos = C, flat_pos
    else:
        every = placement.gather_over_batch(counts[0])  # (rows, E)
        before = torch.cumsum(every, dim=0) - every
        me_row = placement.batch_row()
        C = moe_capacity(T * rows, m)
        C_buf, buf_pos = min(C, T), flat_pos
        flat_pos = flat_pos + before[me_row][flat_ids]
    keep = flat_pos < C
    e0, n_e = experts if experts[1] else (0, E)
    mine = keep & (flat_ids >= e0) & (flat_ids < e0 + n_e)
    slot = (flat_ids - e0) * C_buf + torch.where(mine, buf_pos, 0)
    if n_e != E:
        slot = torch.where(mine, slot, 0)
        gate_vals = placement.copy_to_model(gate_vals)

    tok_idx = torch.arange(T, device=dev).repeat_interleave(k)
    slot_tok = torch.full((n_e * C_buf,), T, dtype=torch.int64, device=dev)
    slot_tok.scatter_reduce_(0, slot, torch.where(mine, tok_idx, T),
                             reduce="amin")
    slot_gate = torch.zeros((n_e * C_buf,), dtype=torch.float32, device=dev)
    slot_gate.index_add_(0, slot, gate_vals.reshape(-1) * mine)
    return MoERouting(gate_vals=gate_vals, expert_ids=expert_ids,
                      flat_pos=flat_pos, keep=keep, slot=slot,
                      slot_tok=slot_tok.view(n_e, C_buf),
                      slot_gate=slot_gate.view(n_e, C_buf), capacity=C,
                      aux_loss=aux_loss, mine=mine)


def moe_ffn(params: Dict, x: torch.Tensor, cfg: ModelConfig,
            placement=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (out, aux_loss); the dense residual FFN is
    added when the config has one. Under a `placement` the routing is the
    whole microbatch's (`moe_route`), and where `model` splits the experts
    (expert parallelism) this rank runs its experts' slots alone, on its
    input copied to `model`, and the combine is summed over `model`: the
    one-process combine is a sum over experts, and every `model` rank of
    a batch row holds that row's tokens, so no all-to-all is needed."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    n_e = params["experts_in"].shape[0]
    ep = placement is not None and n_e * placement.tp == E
    x_in, xr = x, x
    if placement is not None:
        x = placement.enter(x, ep)
        if placement.seq:
            xr = placement.shared(x) if ep else x
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    r = moe_route(params, xr.reshape(T, d), cfg, placement,
                  (placement.tp_rank * n_e, n_e) if ep else (0, 0))
    C = r.slot_tok.shape[1]

    # Dispatch: each kept pair's token row into its (expert, slot); a
    # dropped pair adds a zero row at its expert's slot 0.
    contrib = xt.repeat_interleave(k, dim=0) * r.mine[:, None].to(xt.dtype)
    buf = torch.zeros((n_e * C, d), dtype=xt.dtype, device=x.device)
    buf.index_add_(0, r.slot, contrib)
    buf = buf.view(n_e, C, d)

    glu = cfg.ffn_type in ("swiglu", "geglu")
    act = ACT_FNS["silu"] if cfg.ffn_type == "swiglu" else ACT_FNS["gelu"]
    if glu:
        h = act(torch.bmm(buf, params["experts_gate"]))
        h = h * torch.bmm(buf, params["experts_in"])
    elif cfg.ffn_type == "relu2":
        h = ACT_FNS["relu2"](torch.bmm(buf, params["experts_in"]))
    else:
        h = act(torch.bmm(buf, params["experts_in"]))
    out_buf = torch.bmm(h, params["experts_out"])  # (n_e, C, d)

    # Combine: each slot's gated output back to its token; row T takes
    # the empty slots' zeros and is cut off.
    weighted = out_buf * r.slot_gate[..., None].to(out_buf.dtype)
    out = torch.zeros((T + 1, d), dtype=out_buf.dtype, device=x.device)
    out.index_add_(0, r.slot_tok.reshape(-1), weighted.reshape(n_e * C, d))
    out = out[:T].reshape(B, S, d)
    if placement is not None:
        out = placement.leave(out, ep)
    if m.dense_residual:
        out = out + ffn(params["dense"], x_in, cfg, placement)
    return out, r.aux_loss
