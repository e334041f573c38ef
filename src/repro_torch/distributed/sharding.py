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

The placed train step hands the model its blocks with a `Placement`,
which carries the collectives the model calls, each an autograd function
over the mesh's axis groups: `gather_on_use` (all-gather over the FSDP
axes, reduce-scatter backward), Megatron's `copy_to_model` (identity
forward, all-reduce backward) and `reduce_from_model` (all-reduce
forward, identity backward), `sum_over_model` (all-reduce both ways),
`gather_model` (all-gather over `model`, backward cut to the block,
summed first where each rank used a part), and the sums over the batch
axes that MoE routing reads; `own` cuts a leaf to this rank's heads or
channels. At `model` size 1 the operators over `model` return their
input.

Megatron sequence parallelism (`Placement.seq`, where the config's
`act_pspec` splits the sequence over the tensor-parallel axis): the
residual stream between blocks is this rank's block of the sequence,
(B, S / tp, d). A mixer or FFN enters with `enter` (an all-gather over
`model` along the sequence; backward a reduce-scatter where the layer
splits over `model`, a cut where it computes whole) and leaves with
`leave` (a reduce-scatter, or a cut; backward an all-gather), in place
of `copy_to_model` and `reduce_from_model`. The norms, the learned
positions and the head's norm then see this rank's block alone, so
their parameters' gradients are summed over `model` (`copy_to_model`).

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

    def block_shape(self, shape) -> Tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.block_slices(shape))

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


def spec_of(t: torch.Tensor) -> PartitionSpec:
    """The spec of a placed tensor, read from its DTensor placements: the
    mesh axes that shard each dimension, in the mesh's order."""
    from torch.distributed.tensor import Shard

    dims = [[] for _ in range(t.ndim)]
    for a, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(a)
    return P(*(None if not d else d[0] if len(d) == 1 else tuple(d)
               for d in dims))


def reduce_to_block(g: torch.Tensor, src: NamedSharding, dst: NamedSharding,
                    over) -> torch.Tensor:
    """`g`, this rank's block by `src` of a gradient that is complete along
    the axes `src` splits and a partial sum along the axes `over` it does
    not split (its batch rows), summed over `over` and redistributed to
    `dst`'s placements (an all-reduce where `dst` splits no dimension along
    an axis of `over`, a reduce-scatter where it does, ZeRO-2; an
    all-gather along the dimensions `src` splits and `dst` does not). The
    sum runs in `g`'s dtype; with nothing to sum or move, `g` itself (a
    partial sum over an axis of one rank is the sum)."""
    from torch.distributed.tensor import DTensor, Partial

    dm, mesh = src.mesh.device_mesh, src.mesh
    pls = [Partial() if a in over and pl.is_replicate()
           and mesh.axis_size(a) > 1 else pl
           for a, pl in zip(mesh.axis_names, src.placements())]
    if pls == dst.placements():
        return g
    return DTensor.from_local(g, dm, pls, run_check=False).redistribute(
        dm, dst.placements()).to_local()


# ---------------------------------------------------------------------------
# The collectives the model calls in a placed train step
# ---------------------------------------------------------------------------
def _gather_dim(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The blocks `t` of the `n` ranks of `group`, joined along `dim` in
    the group's rank order."""
    out = torch.empty((n,) + t.shape, dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out.flatten(0, 1), t.contiguous(),
                                group=group)
    return out.movedim(0, dim).reshape(
        t.shape[:dim] + (n * t.shape[dim],) + t.shape[dim + 1:])


def _scatter_dim(g: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """This rank's block along `dim` of the sum of the `n` ranks' `g`."""
    b = g.shape[dim] // n
    parts = g.reshape(g.shape[:dim] + (n, b) + g.shape[dim + 1:]) \
        .movedim(dim, 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, parts.flatten(0, 1), group=group)
    return out


class _Gather(torch.autograd.Function):
    """All-gather along `dim` over one mesh axis. Backward: the gradient
    summed over the axis and cut to this rank's block (a reduce-scatter)
    where every rank's use of the whole is its own part of the gradient,
    or only cut where every rank computes the same whole gradient."""

    @staticmethod
    def forward(ctx, t, dim, group, n, idx, summed):
        ctx.args = dim, group, n, idx, summed
        return _gather_dim(t, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n, idx, summed = ctx.args
        if summed:
            return _scatter_dim(g, dim, group, n), None, None, None, None, \
                None
        b = g.shape[dim] // n
        return g.narrow(dim, idx * b, b).contiguous(), None, None, None, \
            None, None


class _AllReduce(torch.autograd.Function):
    """A sum over a process group. Backward: the identity (`back=False`:
    Megatron's g, each rank's gradient is already the whole one) or the
    same sum (`back=True`: every rank's loss reads the sum, so each rank's
    input takes the gradients of all of them)."""

    @staticmethod
    def forward(ctx, t, groups, back):
        ctx.args = groups, back
        out = t.float() if t.dtype == torch.bfloat16 else t.clone()
        for group in groups:
            dist.all_reduce(out, group=group)
        return out.to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        groups, back = ctx.args
        if back:
            g = g.clone()
            for group in groups:
                dist.all_reduce(g, group=group)
        return g, None, None


class _ScatterSum(torch.autograd.Function):
    """The sum over a group of `n` ranks, cut to this rank's block along
    `dim` (a reduce-scatter; bfloat16 summed in float32, as
    `reduce_from_model` sums). Backward: the all-gather of the block
    gradients."""

    @staticmethod
    def forward(ctx, t, dim, group, n):
        ctx.args = dim, group, n
        wide = t.float() if t.dtype == torch.bfloat16 else t
        return _scatter_dim(wide, dim, group, n).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.args
        return _gather_dim(g, dim, group, n), None, None, None


class _Cut(torch.autograd.Function):
    """This rank's block along `dim` of a tensor every rank of the group
    holds whole and alike. Backward: the all-gather of the block
    gradients (each rank's is the whole gradient's block)."""

    @staticmethod
    def forward(ctx, t, dim, group, n, idx):
        ctx.args = dim, group, n
        b = t.shape[dim] // n
        return t.narrow(dim, idx * b, b).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.args
        return _gather_dim(g, dim, group, n), None, None, None, None


class _ScaleGrad(torch.autograd.Function):
    """The identity; backward, the gradient divided by `n`: a use whose
    gradient every rank computes whole, inside a layer whose input
    gradient is summed over the `n` ranks."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward; backward, the gradient summed
    over the group (each rank's use of the input is a part of the
    whole)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def gather_on_use(t: torch.Tensor, spec, placement: "Placement"
                  ) -> torch.Tensor:
    """The parameter block `t` (its `spec`) gathered over the axes of the
    FSDP role that split it (every axis the spec names but the tensor
    parallel one): the tensor a layer computes on, still split over
    `model`. Backward: the gradient reduce-scattered back onto the block
    over those axes (a sum over their ranks' batch rows). Where no such
    axis has more than one rank, `t` itself."""
    for dim, axes in enumerate(_dim_axes(spec, t.ndim)):
        for a in reversed(axes):
            n = placement.mesh.axis_size(a)
            if a != placement.tp_axis and n > 1:
                t = _Gather.apply(t, dim, placement.mesh.group(a), n,
                                  placement.mesh.coordinate(a), True)
    return t


@dataclasses.dataclass(frozen=True)
class Placement:
    """What the model reads of a placed train step: the mesh, the spec of
    each parameter block it is handed (`specs`, the parameters' tree),
    the tensor-parallel axis and the batch axes. `tp` and `tp_rank` are
    this rank's `model` size and coordinate (1 and 0 on a mesh without
    that axis). At `tp == 1` every operator over `model` is the identity
    and makes no collective call."""
    mesh: Mesh
    specs: object
    batch: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    seq: bool = False  # Megatron-SP: the residual stream split over `model`

    @property
    def tp(self) -> int:
        return self.mesh.axis_size(self.tp_axis) \
            if self.tp_axis in self.mesh.axis_names else 1

    @property
    def tp_rank(self) -> int:
        return self.mesh.coordinate(self.tp_axis) if self.tp > 1 else 0

    @property
    def rows(self) -> int:
        """The ways the batch is split (the batch axes' ranks)."""
        return int(np.prod([self.mesh.axis_size(a) for a in self.batch]))

    def batch_row(self) -> int:
        """This rank's block of the batch among the `rows` (the first
        batch axis outermost, as `data_pspecs` splits it)."""
        i = 0
        for a in self.batch:
            i = i * self.mesh.axis_size(a) + self.mesh.coordinate(a)
        return i

    def _tp_group(self):
        return self.mesh.group(self.tp_axis)

    def sequence_parallel(self, cfg, S: int) -> "Placement":
        """This placement with `seq` set where `cfg.act_pspec` splits the
        sequence (its second entry) over the tensor-parallel axis, that
        axis has more than one rank and divides the S positions."""
        ap = cfg.act_pspec
        on = ap is not None and len(ap) > 1 and ap[1] == self.tp_axis \
            and self.tp > 1 and S % self.tp == 0
        return dataclasses.replace(self, seq=True) if on else self

    def enter(self, x: torch.Tensor, split: bool) -> torch.Tensor:
        """A layer's input x (B, S, d), or this rank's block of its
        sequence under `seq`, as the layer computes on it: the whole
        sequence. `split`: the layer splits its work over `model` (each
        rank's use of x is a part of its gradient, summed over `model`);
        else every rank computes it whole. Without `seq`, Megatron's
        `copy_to_model` where split; under `seq`, an all-gather along
        the sequence whose backward reduce-scatters (split) or cuts."""
        if not self.seq:
            return self.copy_to_model(x) if split else x
        return _Gather.apply(x, 1, self._tp_group(), self.tp, self.tp_rank,
                             split)

    def leave(self, t: torch.Tensor, split: bool) -> torch.Tensor:
        """A layer's output over the whole sequence back to the residual
        stream: where split (each rank's output a part), summed over
        `model` (`reduce_from_model`; under `seq` a reduce-scatter onto
        this rank's block); else as it is (under `seq`, cut to the
        block). Under `seq` the backward all-gathers."""
        if not self.seq:
            return self.reduce_from_model(t) if split else t
        if split:
            return _ScatterSum.apply(t, 1, self._tp_group(), self.tp)
        return _Cut.apply(t, 1, self._tp_group(), self.tp, self.tp_rank)

    def shared(self, t: torch.Tensor) -> torch.Tensor:
        """Under `seq`, `t` (a split layer's entered input) for a use that
        every rank computes whole (MoE routing): its gradient divided by
        `tp`, so the reduce-scatter in `enter`'s backward counts it once.
        Else `t`."""
        return _ScaleGrad.apply(t, self.tp) if self.seq else t

    def seq_rows(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Under `seq`, this rank's block of `t` along `dim` (a view);
        else `t`."""
        if not self.seq:
            return t
        b = t.shape[dim] // self.tp
        return t.narrow(dim, self.tp_rank * b, b)

    def seq_params(self, tree):
        """Under `seq`, each leaf of `tree` (a norm's, the learned
        positions: parameters used on this rank's block of the sequence
        alone) through `copy_to_model`, so its gradient is summed over
        `model`; else `tree`."""
        if not self.seq:
            return tree
        return map_with_path(lambda _, t: self.copy_to_model(t), tree)

    def use(self, tree, specs):
        """`gather_on_use` on each leaf of `tree` by its spec in `specs`."""
        return map_with_path(lambda _, t, s: gather_on_use(t, s, self),
                             tree, specs)

    def whole(self, tree, specs):
        """Each leaf of `tree` (gathered by `use`) gathered over `model`
        too where its spec splits it, for a layer that every `model` rank
        computes whole: backward cuts this rank's block of the gradient,
        which every rank computes the same."""
        def one(_, t, s):
            for dim, axes in enumerate(_dim_axes(s, t.ndim)):
                if self.tp_axis in axes:
                    t = self.gather_model(t, dim)
            return t

        return map_with_path(one, tree, specs) if self.tp > 1 else tree

    def gather_model(self, t: torch.Tensor, dim: int, summed: bool = False
                     ) -> torch.Tensor:
        """All-gather along `dim` over `model`; backward cuts this rank's
        block, summed over `model` first where `summed` (each rank's use
        is its own part of the gradient)."""
        if self.tp == 1:
            return t
        return _Gather.apply(t, dim, self._tp_group(), self.tp,
                             self.tp_rank, summed)

    def copy_to_model(self, t: torch.Tensor) -> torch.Tensor:
        """Megatron's f over `model`: identity forward, all-reduce
        backward."""
        return t if self.tp == 1 else _CopyToModel.apply(t, self._tp_group())

    def reduce_from_model(self, t: torch.Tensor) -> torch.Tensor:
        """Megatron's g over `model`: all-reduce forward (bfloat16 summed
        in float32), identity backward."""
        if self.tp == 1:
            return t
        return _AllReduce.apply(t, (self._tp_group(),), False)

    def sum_over_model(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over `model` of partial sums that every `model` rank
        then reads in part: all-reduce forward (bfloat16 summed in
        float32) and backward. Mamba's `x_proj` contracts over the
        channels, which `model` splits, so each rank's product is a part
        of (dt, B, C); each rank's own channels read all of them, so each
        rank's use is a part of their gradient too. `reduce_from_model`'s
        identity backward would keep only this rank's part."""
        if self.tp == 1:
            return t
        return _AllReduce.apply(t, (self._tp_group(),), True)

    def own(self, t: torch.Tensor, dim: int, whole: int, runs: int = 1
            ) -> torch.Tensor:
        """This rank's part along `dim` of a leaf whose whole extent there
        is `whole`, laid out as `runs` equal runs (Mamba's `in_proj` holds
        x and z side by side, the sLSTM's `W` and `b` its four gates one
        after another), each split over `model` in rank order: this
        rank's block of every run, joined. A block that already is this
        rank's part (one run split over `model`) is returned as it is; a
        leaf replicated over `model` is cut after `copy_to_model` (each
        rank's slice is a part of the gradient, summed in backward); a
        leaf that `model` splits along other lines (a column block of
        `in_proj` is a block of runs, not of channels) is gathered with
        its gradient summed first (`gather_model(summed=True)`), then
        cut."""
        n = t.shape[dim]
        if n * self.tp == whole and (runs == 1 or self.tp == 1):
            return t
        t = self.copy_to_model(t) if n == whole \
            else self.gather_model(t, dim, summed=True)
        return t.unflatten(dim, (runs, self.tp, whole // runs // self.tp)) \
            .select(dim + 1, self.tp_rank).flatten(dim, dim + 1)

    def max_over_model(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over `model` of a tensor without gradient."""
        if self.tp > 1:
            t = t.clone()
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._tp_group())
        return t

    def sum_over_batch(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the batch axes of a statistic that every rank's
        loss reads whole: backward sums the gradients over them too."""
        groups = tuple(self.mesh.group(a) for a in self.batch
                       if self.mesh.axis_size(a) > 1)
        return _AllReduce.apply(t, groups, True) if groups else t

    def gather_over_batch(self, t: torch.Tensor) -> torch.Tensor:
        """(rows, *t.shape): every batch rank's `t` (no gradient), in the
        order of their rows of the batch (the first batch axis outermost)."""
        out = t[None]
        for a in reversed(self.batch):
            n = self.mesh.axis_size(a)
            if n > 1:
                out = _gather_dim(out, 0, self.mesh.group(a), n)
        return out.reshape((self.rows,) + t.shape)


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
