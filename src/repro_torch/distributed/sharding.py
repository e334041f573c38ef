"""Sharding rules: param-path patterns -> partition specs.

The counterpart of `repro/distributed/sharding.py`: the same rule table
and the same specs. A spec is a `PartitionSpec`, a tuple of mesh axis
names with `None` for a replicated dimension, equal as a tuple to
`tuple(P)` of the reference's. On a mesh without a process group every
spec puts the whole tensor on the mesh's one device (`named`). On a mesh
over ranks (`launch.mesh.init_distributed`) `named` gives each spec its
DTensor placements: each rank holds the block of every dimension that
names mesh axes (`place`, `gather`), and the train step reduces its
gradients onto those blocks (`reduce_to_block`, ZeRO-2).

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
import torch
import torch.distributed as dist

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


def _dim_axes(spec, ndim: int) -> List[Tuple[str, ...]]:
    """The mesh axes that shard each of `ndim` dimensions, outermost
    first."""
    entries = list(spec)[:ndim] + [None] * (ndim - len(tuple(spec)))
    return [() if a is None else (a if isinstance(a, tuple) else (a,))
            for a in entries]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """`spec` over a mesh of ranks: a dimension that names mesh axes is
    split in prod(their sizes) blocks and this rank holds the block at its
    coordinates along them (the first axis outermost, as a tuple of axes
    shards in `jax.sharding`); every other dimension is whole. Dimensions
    must divide: prune the spec first (`param_pspecs(..., mesh)`)."""
    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        names, seen = self.mesh.axis_names, []
        for axes in self.axes(len(self.spec)):
            idx = [names.index(a) if a in names else -1 for a in axes]
            if -1 in idx or idx != sorted(idx):
                raise ValueError(f"{self.spec}: {axes} are not axes of the "
                                 f"mesh {names} in its order")
            seen += axes
        if len(set(seen)) != len(seen):
            raise ValueError(f"{self.spec} names a mesh axis twice")

    def axes(self, ndim: int) -> List[Tuple[str, ...]]:
        return _dim_axes(self.spec, ndim)

    def placements(self) -> list:
        """The DTensor placements: `Shard(dim)` along each mesh axis that
        a dimension names, `Replicate()` along the others."""
        from torch.distributed.tensor import Replicate, Shard

        by_axis = {a: d for d, axes in enumerate(self.axes(len(self.spec)))
                   for a in axes}
        return [Shard(by_axis[a]) if a in by_axis else Replicate()
                for a in self.mesh.axis_names]

    def block_slices(self, shape) -> Tuple[slice, ...]:
        out = []
        for d, axes in enumerate(self.axes(len(shape))):
            n, idx = 1, 0
            for a in axes:
                size = self.mesh.axis_size(a)
                idx, n = idx * size + self.mesh.coordinate(a), n * size
            if shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"split over {axes} ({n} ways)")
            b = shape[d] // n
            out.append(slice(idx * b, (idx + 1) * b))
        return tuple(out)

    def block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor `t` (a view)."""
        return t[self.block_slices(t.shape)]


def named(mesh: Mesh, tree_specs):
    """Where each spec places its tensor: a `NamedSharding` on a mesh of
    ranks, the mesh's one device (the card or the CPU) on a mesh without
    a process group. A mesh of several devices needs a process group."""
    if mesh.placed:
        return map_with_path(lambda _, s: NamedSharding(mesh, s), tree_specs)
    if mesh.size != 1:
        raise ValueError(
            f"a mesh of {mesh.size} devices {mesh.shape} places tensors over "
            "ranks: start a process group first (torchrun, or "
            "launch.mesh.init_distributed)")
    dev = mesh.devices.reshape(-1)[0]
    return map_with_path(lambda _, s: dev, tree_specs)


def _own(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous tensor of its own on `device` with `t`'s values."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    return out.copy_(t)


def _wrap(local: torch.Tensor, sh: NamedSharding, shape) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    return DTensor.from_local(
        local, sh.mesh.device_mesh, sh.placements(), run_check=False,
        shape=shape, stride=torch.empty(shape, device="meta").stride())


def place(tree, placements):
    """Each whole tensor of `tree` where `placements` (from `named`) puts
    it: this rank's block as a DTensor, or a copy on the one device. Each
    leaf gets a tensor of its own (no view of its input)."""

    def put(_, t, where):
        if isinstance(where, NamedSharding):
            return _wrap(_own(where.block(t), where.mesh.device), where,
                         t.shape)
        return _own(t, where)

    return map_with_path(put, tree, placements)


def from_blocks(tree, placements):
    """`place` for a tree of this rank's blocks (as `blocks` gives them)."""

    def put(_, t, where):
        if isinstance(where, NamedSharding):
            shape = [n * int(np.prod([where.mesh.axis_size(a) for a in axes]))
                     for n, axes in zip(t.shape, where.axes(t.ndim))]
            return _wrap(t, where, shape)
        return t.to(where)

    return map_with_path(put, tree, placements)


def blocks(tree):
    """This rank's block of each placed leaf; other leaves as they are."""
    from torch.distributed.tensor import DTensor

    return map_with_path(lambda _, t: t.to_local()
                         if isinstance(t, DTensor) else t, tree)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of a placed tensor (`DTensor.full_tensor`: gathered over
    the mesh axes that split it); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def gather(tree):
    """The whole local tensor of each leaf (`full_tensor`)."""
    return map_with_path(lambda _, t: full_tensor(t), tree)


def all_reduce(t: torch.Tensor, mesh: Mesh, axes, op=None) -> torch.Tensor:
    """`t` reduced in place over the ranks that differ along `axes` (a sum
    unless `op` says otherwise)."""
    for a in axes:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                        group=mesh.group(a))
    return t


def reduce_to_block(g: torch.Tensor, sh: NamedSharding, over) -> torch.Tensor:
    """This rank's block (by `sh`) of the sum of the whole tensors `g`
    that the ranks differing along the axes `over` hold: `g` as a partial
    sum over those axes, redistributed to `sh`'s placements (a
    reduce-scatter along the dimensions they split, ZeRO-2; an all-reduce
    where they split none; a local cut along the dimensions other axes
    split). The sum runs in `g`'s dtype."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    dm = sh.mesh.device_mesh
    src = [Partial() if a in over else Replicate()
           for a in sh.mesh.axis_names]
    return DTensor.from_local(g, dm, src, run_check=False).redistribute(
        dm, sh.placements()).to_local()


def owns(t: torch.Tensor) -> bool:
    """Whether this rank is the first holder of the placed tensor `t`'s
    block: coordinate 0 along every mesh axis that does not split it."""
    from torch.distributed.tensor import Shard

    dm = t.device_mesh
    return all(dm.get_local_rank(i) == 0
               for i, p in enumerate(t.placements) if not isinstance(p, Shard))


def sum_over_shards(values: List[torch.Tensor], owners: List[bool]
                    ) -> List[torch.Tensor]:
    """The global sums of per-block sums `values` (one 0-d tensor a
    placed tensor; `owners`: whether this rank owns that block, `owns`):
    each block counted once (the replicas that do not own theirs add
    zero), one all-reduce over every rank."""
    own = torch.tensor(owners, device=values[0].device)
    v = torch.where(own, torch.stack(values), 0.0)
    dist.all_reduce(v, op=dist.ReduceOp.SUM)
    return list(torch.unbind(v))


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
