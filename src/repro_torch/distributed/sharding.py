"""Sharding rules: param-path patterns -> partition specs.

The counterpart of `repro/distributed/sharding.py`: the same rule table
and the same specs. A spec is a `PartitionSpec`, a tuple of mesh axis
names with `None` for a replicated dimension, equal as a tuple to
`tuple(P)` of the reference's. What a spec places is one card: on a mesh
whose axes all have size 1 every spec puts the whole tensor there
(`named`), and a mesh of more than one card raises (ROADMAP item 9b).

Axis roles:
  pod    — pure data parallelism across pods;
  data   — batch DP within a pod + FSDP weight sharding + ZeRO-1
           optimizer-state sharding;
  model  — tensor parallelism (Megatron column/row), expert parallelism
           (experts live on `model`), and sequence sharding of decode KV.

Rules are matched on the '/'-joined param path, most-specific first. A rule
gives the spec for the *logical* (unstacked) tensor; stacked block leaves
(the reference's `blocks/pos<i>` and `enc_blocks/pos<i>`, with a leading
period axis) get None prepended. The port's own layout keeps one dict a
layer (`blocks/<layer>/...`): those leaves are not stacked, and get the
logical spec alone.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.launch.mesh import Mesh
from repro_torch.tree_util import map_with_path


class PartitionSpec(tuple):
    """Mesh axis names (or None) per dimension; a leaf of a spec tree."""

    tree_leaf = True  # `tree_util` does not walk into it

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    # None disables tensor parallelism (small models: replicate weights and
    # run pure DP).
    tp_axis: Optional[str] = "model"
    fsdp_axis: Optional[str] = "data"  # None disables FSDP weight sharding
    dp_axes: Tuple[str, ...] = ("data",)  # batch axes; pod prepended if present
    shard_kv_seq: bool = True  # decode KV sequence axis over tp


def batch_axes(mesh: Mesh, cfg: ShardingConfig) -> Tuple[str, ...]:
    axes = tuple(a for a in ("pod",) if a in mesh.axis_names) + tuple(
        a for a in cfg.dp_axes if a in mesh.axis_names
    )
    return axes


# (regex on leaf path, spec builder). `tp`/`fs` placeholders are substituted.
# Specs are for the logical 2D/3D weight; vectors get P(tp) when they sit on
# a tp-sharded output dim, else replicated.
_RULES: List[Tuple[str, Tuple]] = [
    # embeddings / heads
    (r"(^|/)embed$", ("tp", "fs")),  # (V, d): vocab over tp, d over fsdp
    (r"(^|/)lm_head$", ("fs", "tp")),  # (d, V)
    (r"(^|/)(pos_embed|enc_pos_embed)$", (None, "fs")),
    # attention
    (r"/wq$|/wk$|/wv$|/wog$", ("fs", "tp")),
    (r"/wo$", ("tp", "fs")),
    (r"/bq$|/bk$|/bv$", ("tp",)),
    # dense FFN
    (r"/w_gate$|/w_in$", ("fs", "tp")),
    (r"/w_out$", ("tp", "fs")),
    # MoE: experts over tp (EP); within-expert dims over fsdp
    (r"/router$", ("fs", None)),
    (r"/experts_gate$|/experts_in$", ("tp", "fs", None)),
    (r"/experts_out$", ("tp", None, "fs")),
    # Mamba
    (r"/in_proj$", ("fs", "tp")),
    (r"/out_proj$", ("tp", "fs")),
    (r"/x_proj$", ("tp", None)),
    (r"/conv_w$", (None, "tp")),
    (r"/conv_b$", ("tp",)),
    (r"/dt_proj_w$", (None, "tp")),
    (r"/dt_proj_b$", ("tp",)),
    (r"/A_log$", ("tp", None)),
    (r"/D$", ("tp",)),
    # xLSTM
    (r"/W$", ("fs", "tp")),
    (r"/R$", ("tp", None, None)),
    (r"/norm_scale$", (None, None)),
    (r"/wi$|/wf$", ("fs", None)),
    (r"/bi$|/bf$|/b$", (None,)),
    # norms & defaults
    (r"scale_param$|/bias$", (None,)),
]

_STACKED = re.compile(r"(^|/)(enc_)?blocks/pos\d+(/|$)")


def _resolve(spec_tpl: Tuple, tp: Optional[str], fs: Optional[str]):
    out = []
    for s in spec_tpl:
        if s == "tp":
            out.append(tp)
        elif s == "fs":
            out.append(fs)
        else:
            out.append(s)
    return tuple(out)


def spec_for_path(path: str, ndim: int, stacked: bool,
                  cfg: ShardingConfig) -> PartitionSpec:
    """PartitionSpec for one leaf. `stacked` = has leading n_periods axis."""
    tp, fs = cfg.tp_axis, cfg.fsdp_axis
    logical_ndim = ndim - (1 if stacked else 0)
    for pat, tpl in _RULES:
        if re.search(pat, path):
            spec = _resolve(tpl, tp, fs)
            # pad/trim to the logical rank
            if len(spec) < logical_ndim:
                spec = spec + (None,) * (logical_ndim - len(spec))
            spec = spec[:logical_ndim]
            if stacked:
                spec = (None,) + spec
            return P(*spec)
    return P(*((None,) * ndim))


def prune_pspecs(spec_tree, shape_tree, mesh: Mesh):
    """Drop sharding on any dim the axis size does not divide; falls back
    to replication per dim."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))

    def fix(_, spec, leaf):
        entries = list(spec) + [None] * (leaf.ndim - len(tuple(spec)))
        out = []
        for dim, ax in enumerate(entries[: leaf.ndim]):
            if ax is None:
                out.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            total = int(np.prod([sizes[a] for a in axes]))
            out.append(ax if leaf.shape[dim] % total == 0 else None)
        return P(*out)

    return map_with_path(fix, spec_tree, shape_tree)


def param_pspecs(params, cfg: ShardingConfig = ShardingConfig(),
                 mesh: Optional[Mesh] = None) -> Dict:
    """PartitionSpec tree matching `params` (tensors, meta tensors
    included). Pass `mesh` to prune non-divisible axes."""

    def leaf_spec(p, leaf):
        return spec_for_path(p, leaf.ndim, bool(_STACKED.search(p)), cfg)

    specs = map_with_path(leaf_spec, params)
    if mesh is not None:
        specs = prune_pspecs(specs, params, mesh)
    return specs


def cache_pspecs(cache, mesh: Mesh,
                 cfg: ShardingConfig = ShardingConfig()) -> Dict:
    """Decode-cache specs: KV sequence axis over tp (flash-decoding), batch
    over the DP axes; SSM/xLSTM states shard their channel dim over tp."""
    bax = batch_axes(mesh, cfg)
    b = bax if len(bax) > 1 else (bax[0] if bax else None)

    def leaf_spec(p, leaf):
        name = p.rsplit("/", 1)[-1]
        # leading n_periods axis everywhere
        if name in ("k", "v"):  # (n, B, S, n_kv, hd)
            seq = cfg.tp_axis if (cfg.shard_kv_seq and cfg.tp_axis) else None
            return P(None, b, seq, None, None)
        if name in ("xk", "xv"):  # (n, B, S_src, n_kv, hd)
            return P(None, b, None, None, None)
        if name == "conv":  # (n, B, K-1, din)
            return P(None, b, None, cfg.tp_axis)
        if name == "ssm":  # (n, B, din, state)
            return P(None, b, cfg.tp_axis, None)
        if name == "C":  # (n, B, H, dh, dh)
            return P(None, b, cfg.tp_axis, None, None)
        if name in ("n", "h", "c"):  # (n, B, H, dh)
            return P(None, b, cfg.tp_axis, None)
        if name == "m":  # (n, B, H) or (n, B, H, dh)
            spec = (None, b, cfg.tp_axis) + (None,) * (leaf.ndim - 3)
            return P(*spec)
        return P(*((None,) * leaf.ndim))

    return map_with_path(leaf_spec, cache)


def data_pspecs(batch, mesh: Mesh,
                cfg: ShardingConfig = ShardingConfig()) -> Dict:
    """Input batch: leading batch dim over (pod?, data)."""
    bax = batch_axes(mesh, cfg)
    b = bax if len(bax) > 1 else (bax[0] if bax else None)
    return map_with_path(
        lambda _, leaf: P(*((b,) + (None,) * (leaf.ndim - 1))), batch)


def named(mesh: Mesh, tree_specs):
    """The device each spec places its tensor on: the mesh's one card (or
    the CPU) for every leaf. A mesh of more than one card raises: placing
    shards or replicas over several cards (DTensor or FSDP, and the ZeRO-2
    reduce-scatter of the gradient) is ROADMAP item 9b."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"placement over a mesh of {mesh.size} devices {mesh.shape} is "
            "not ported (ROADMAP item 9b: multi-card placement)")
    dev = mesh.devices.reshape(-1)[0]
    return map_with_path(lambda _, s: dev, tree_specs)


def validate_divisibility(params_specs, shapes, mesh: Mesh) -> List[str]:
    """List every sharded dim that does not divide its axis size."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    findings: List[str] = []

    def check(path, spec, leaf):
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            total = int(np.prod([sizes[a] for a in axes]))
            if leaf.shape[dim] % total != 0:
                findings.append(f"{path}: dim {dim} = "
                                f"{leaf.shape[dim]} % {total} != 0 ({ax})")

    map_with_path(check, params_specs, shapes)
    return findings
