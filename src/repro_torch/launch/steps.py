"""Step builders: the train step (gradient accumulation + AdamW) and the
serve steps (prefill and decode), with the spec trees of their operands.

The counterpart of `repro/launch/steps.py`. The reference's steps are pure
functions that `jit` compiles and shards; the port's run eagerly. The
train step takes the gradient of `lm.loss_fn` with autograd (through the
attention kernels' backward on the card), on one device or, given a mesh
of ranks, placed over it (`make_train_step`'s `mesh`: the layers gather
their weights where they use them and `model` splits their compute, as
GSPMD splits the reference's by the same specs); the decode step
updates its cache in place (the counterpart of the reference's donated
cache buffer). The serve steps run placed too, given a mesh of ranks
(`make_prefill_step` / `make_decode_step`): the counterparts of the
reference's dry-run cells, jitted with their `in_shardings` and
`out_shardings` (`serve_pspecs`).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (
    NamedSharding,
    P,
    PartitionSpec,
    Placement,
    ShardingConfig,
    all_reduce,
    batch_axes,
    blocks,
    cache_pspecs,
    drop_batch_axis,
    from_blocks,
    named,
    owns,
    param_pspecs,
    prune_pspecs,
    reduce_to_block,
    spec_of,
    sum_over_shards,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.optim import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    clip_by_global_norm,
)
from repro_torch.optim.state_codec import Quantized
from repro_torch.tree_util import leaves_with_path, map_with_path


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    moment_dtype: str = "f32", grad_clip: float = 1.0,
                    accum_dtype: torch.dtype = torch.float32,
                    grad_pspecs=None, mesh: Optional[Mesh] = None
                    ) -> Callable:
    """batch leaves are (A, microbatch, ...): `loss_fn` runs on each of
    the A microbatches, its autograd gradients summed into an
    `accum_dtype` accumulator, which is divided by A, clipped to
    `grad_clip` global norm, and applied by one AdamW update.

    `train_step(params, opt_state, batch) -> (params, opt_state, metrics)`
    returns new trees (the old ones are not updated in place); metrics
    `{"loss": mean microbatch loss, "grad_norm": pre-clip norm}` are 0-d
    tensors on the params' device, and the step makes no host sync.

    On a mesh of ranks (`mesh.placed`) the step is placed over it: see
    `_placed_train_step`; `grad_pspecs` (the parameters' spec tree, as
    the reference's argument) places the accumulator like the parameters
    (ZeRO-2), and without it the accumulator is whole on every rank (an
    all-reduce a microbatch). Elsewhere `grad_pspecs` places nothing: on
    one device every spec is that device."""
    if mesh is not None and mesh.placed:
        return _placed_train_step(cfg, opt_cfg, moment_dtype, grad_clip,
                                  accum_dtype, grad_pspecs, mesh)

    def train_step(params, opt_state: AdamWState, batch: Dict):
        paths = [p for p, _ in leaves_with_path(params)]
        live = map_with_path(
            lambda _, p: p.detach().requires_grad_(True), params)
        leaves = dict(leaves_with_path(live))
        acc = {p: torch.zeros(leaves[p].shape, dtype=accum_dtype,
                              device=leaves[p].device) for p in paths}
        A = next(iter(batch.values())).shape[0]
        losses = []
        for a in range(A):
            mb = {k: v[a] for k, v in batch.items()}
            with torch.enable_grad():
                loss, _ = lm.loss_fn(live, mb, cfg)
                grads = torch.autograd.grad(loss, [leaves[p] for p in paths])
            for p, g in zip(paths, grads):
                acc[p].add_(g)
            del grads
            losses.append(loss.detach())
        del live, leaves
        for g in acc.values():
            g.div_(A)
        grads, gnorm = clip_by_global_norm(
            map_with_path(lambda p, _: acc.pop(p), params), grad_clip)
        params, opt_state = adamw_update(grads, opt_state, params, opt_cfg,
                                         moment_dtype=moment_dtype)
        metrics = {"loss": torch.mean(torch.stack(losses)),
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step


def _valid_labels(mb: Dict) -> torch.Tensor:
    """The labels `lm.loss_fn` averages over in microbatch `mb`."""
    if "labels" in mb:
        return torch.sum(mb["labels"] >= 0)
    t = mb["tokens"]
    return torch.tensor(t[:, 1:].numel(), device=t.device)


def _placed_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                       moment_dtype: str, grad_clip: float,
                       accum_dtype: torch.dtype, grad_pspecs, mesh: Mesh
                       ) -> Callable:
    """The train step over a mesh of ranks. Parameters and moments are
    DTensors placed by their specs (ZeRO-1 moments); one step:

    (a) hands `loss_fn` this rank's parameter blocks as plain tensors with
        their specs (`Placement`): each layer gathers its weights over
        the FSDP axes where it uses them (`gather_on_use`, inside the
        period's checkpoint), and the `model` axis splits the compute
        (attention heads, FFN units, experts, the vocabulary: see
        `models.lm`);
    (b) gives each rank its block of every microbatch over the batch axes
        (`pod`, `data`); a mixture of experts routes the whole
        microbatch (its aux loss, capacity and positions from small
        collectives over those axes);
    (c) weights each rank's loss by its share of the microbatch's valid
        labels, so the summed gradient is the one-process mean's (the aux
        term, the same on every rank, sums its gradient over the batch
        axes in its own backward and so counts once);
    (d) takes each microbatch's gradient on the blocks: complete along
        the axes a block's spec splits (reduce-scattered by
        `gather_on_use`'s backward) and along `model` (Megatron's
        operators sum what each `model` rank computes in part), a partial
        sum along the batch axes it does not split, which
        `reduce_to_block` sums onto the accumulator's blocks (ZeRO-2);
        divides by A, clips by the global norm over the blocks and runs
        AdamW on the blocks (int8 row scales reduced over the axes that
        split a row);
    (e) returns placed parameters and moments; the metrics are 0-d and
        equal on every rank, the loss summed over the batch axes."""
    scfg = ShardingConfig()
    over = batch_axes(mesh, scfg)
    acc_sh = dict(leaves_with_path(named(mesh, grad_pspecs))) \
        if grad_pspecs is not None else None
    whole = NamedSharding(mesh, P())

    def train_step(params, opt_state: AdamWState, batch: Dict):
        placed = dict(leaves_with_path(params))
        paths = list(placed)
        acc_of = acc_sh or {p: whole for p in paths}
        specs = map_with_path(lambda _, t: spec_of(t), params)
        own = {p: NamedSharding(mesh, s)
               for p, s in leaves_with_path(specs)}
        live = map_with_path(
            lambda _, p: p.to_local().detach().requires_grad_(True), params)
        leaves = dict(leaves_with_path(live))
        where = Placement(mesh, specs, over, scfg.tp_axis)
        acc = {p: torch.zeros(acc_of[p].block_shape(placed[p].shape),
                              dtype=accum_dtype, device=leaves[p].device)
               for p in paths}
        rows = dict(leaves_with_path(named(mesh, accum_batch_pspecs(
            batch, mesh, scfg))))
        A = next(iter(batch.values())).shape[0]
        losses = []
        for a in range(A):
            mb = {k: rows[k].block(v)[a] for k, v in batch.items()}
            count = _valid_labels(mb)
            total = all_reduce(count.clone(), mesh, over)
            w = count.to(torch.float32) / total.to(torch.float32)
            with torch.enable_grad():
                loss, _ = lm.loss_fn(live, mb, cfg, placement=where)
                grads = torch.autograd.grad(loss * w,
                                            [leaves[p] for p in paths])
            for p, g in zip(paths, grads):
                acc[p].add_(reduce_to_block(g, own[p], acc_of[p], over))
            del grads
            losses.append(all_reduce(loss.detach() * w, mesh, over))
        del live, leaves
        for g in acc.values():
            g.div_(A)

        def param_block(p, t):
            g = acc.pop(p)
            if tuple(acc_of[p].placements()) == tuple(t.placements):
                return g
            dm = mesh.device_mesh
            return _placed_like(g, t, acc_of[p].placements()).redistribute(
                dm, t.placements).to_local()

        grads, gnorm = clip_by_global_norm(
            map_with_path(param_block, params), grad_clip,
            reduce=lambda sq: sum_over_shards(
                sq, [owns(placed[p]) for p in paths]))

        def row_max(path):
            t = placed[path]
            last = [a for a, pl in zip(mesh.axis_names, t.placements)
                    if pl.is_shard(t.ndim - 1)]
            return lambda m: all_reduce(m, mesh, last, dist.ReduceOp.MAX)

        new_p, new_o = adamw_update(grads, blocks(opt_state), blocks(params),
                                    opt_cfg, moment_dtype=moment_dtype,
                                    row_max=row_max)
        metrics = {"loss": torch.mean(torch.stack(losses)),
                   "grad_norm": gnorm}
        return (map_with_path(lambda _, n, t: _placed_like(n, t), new_p,
                              params),
                map_with_path(lambda _, n, t: _placed_like(n, t), new_o,
                              opt_state), metrics)

    return train_step


def _placed_like(local: torch.Tensor, like: torch.Tensor, placements=None):
    """`local` as this rank's block of a placed tensor of `like`'s mesh,
    shape and stride, by `placements` (by default `like`'s)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        local, like.device_mesh,
        like.placements if placements is None else placements,
        run_check=False, shape=like.shape, stride=like.stride())


class ServeSpecs(NamedTuple):
    """The specs of a placed prefill or decode cell (the reference's
    `build_cell`, `src/repro/launch/dryrun.py:177-229`)."""
    batch: Tuple[str, ...]  # the batch axes that split the batch: () if none
    cache: object  # the cache's specs, pruned
    logits: PartitionSpec  # P(b, None, vocab axis)
    tokens: PartitionSpec  # a batch leaf's first two dimensions: P(b, None)


def serve_pspecs(cfg: ModelConfig, batch: int, max_seq: int, mesh: Mesh,
                 scfg: ShardingConfig = ShardingConfig(),
                 cache=None) -> ServeSpecs:
    """The reference's serve cell over `mesh` for `batch` sequences and a
    cache of `max_seq` positions: the batch over the batch axes where
    they divide it (else whole: the cache's batch axis dropped,
    `drop_batch_axis`), the cache by `cache_pspecs` (the keys' and
    values' positions over `model`) pruned, unless given (`cache`), the
    logits split over the vocabulary where `model` divides it."""
    bax = batch_axes(mesh, scfg)
    ok = batch % int(np.prod([mesh.axis_size(a) for a in bax])) == 0
    b = (bax if len(bax) > 1 else bax[0]) if (bax and ok) else None
    if cache is None:
        shapes = lm.cache_specs(cfg, batch, max_seq)
        cache = cache_pspecs(shapes, mesh, scfg)
        if not ok:
            cache = drop_batch_axis(cache)
        cache = prune_pspecs(cache, shapes, mesh)
    tp = mesh.axis_size("model") if "model" in mesh.axis_names else 1
    vocab = "model" if tp > 1 and cfg.vocab_size % tp == 0 else None
    return ServeSpecs(bax if ok else (), cache, P(b, None, vocab),
                      P(b, None))


def _serve_placement(params, cfg: ModelConfig, batch: int, max_seq: int,
                     mesh: Mesh, cache_specs, memo: Dict) -> Tuple:
    """(the `Placement` of a serve step on `params`' blocks, its
    `ServeSpecs`, the cache's `cache_specs` where given); the specs of
    each (batch, max_seq) computed once (`memo`)."""
    if (batch, max_seq) not in memo:
        memo[batch, max_seq] = serve_pspecs(cfg, batch, max_seq, mesh,
                                            cache=cache_specs)
    sp = memo[batch, max_seq]
    specs = map_with_path(lambda _, t: spec_of(t), params)
    return Placement(mesh, specs, sp.batch, "model", cache=sp.cache), sp


def _batch_block(t: torch.Tensor, sp: ServeSpecs, mesh: Mesh
                 ) -> torch.Tensor:
    """This rank's rows of a whole batch leaf (every rank's rows where the
    batch is not split)."""
    spec = P(*(tuple(sp.tokens)[:1] + (None,) * (t.ndim - 1)))
    return NamedSharding(mesh, spec).block(t)


def make_prefill_step(cfg: ModelConfig, max_seq: int,
                      mesh: Optional[Mesh] = None, cache_specs=None
                      ) -> Callable:
    """`prefill_step(params, batch) -> (logits, cache)`. On a mesh of
    ranks the step is placed: `params` placed by their specs (DTensors),
    `batch` whole on every rank (each rank takes its rows); under
    `torch.no_grad()` `lm.prefill` runs on this rank's blocks (a gather
    a layer, `model` splitting the compute as in training, the cache
    written as this rank's blocks of the whole batch's cache), and the
    step returns the logits and the cache placed (DTensors) by
    `serve_pspecs` (`cache_specs`, the cache's pruned specs, in place of
    its own)."""
    if mesh is None or not mesh.placed:
        def prefill_step(params, batch):
            return lm.prefill(params, batch, cfg, max_seq)

        return prefill_step

    memo = {}

    def placed_prefill_step(params, batch):
        B = batch["tokens"].shape[0]
        where, sp = _serve_placement(params, cfg, B, max_seq, mesh,
                                     cache_specs, memo)
        local = {k: _batch_block(v, sp, mesh) for k, v in batch.items()}
        with torch.no_grad():
            logits, cache = lm.prefill(blocks(params), local, cfg, max_seq,
                                       placement=where)
        return (from_blocks(logits, NamedSharding(mesh, sp.logits)),
                from_blocks(cache, named(mesh, sp.cache)))

    return placed_prefill_step


def _positions(cache) -> int:
    """The positions of a cache's keys (1 for a cache without any)."""
    return next((t.shape[2] for p, t in leaves_with_path(cache)
                 if p.rsplit("/", 1)[-1] == "k"), 1)


def make_decode_step(cfg: ModelConfig, mesh: Optional[Mesh] = None,
                     cache_specs=None) -> Callable:
    """`decode_step(params, cache, tokens, pos) -> (logits, cache)`, the
    cache updated in place. On a mesh of ranks the step is placed:
    `params` and `cache` placed (DTensors; the cache as the placed
    prefill returns it), `tokens` whole on every rank; under
    `torch.no_grad()` `lm.decode_step` runs on this rank's blocks (flash
    decoding over the cache's positions, `models.attention`) and the
    step returns the placed logits and the same cache."""
    if mesh is None or not mesh.placed:
        def decode_step(params, cache, tokens, pos):
            return lm.decode_step(params, cache, tokens, pos, cfg)

        return decode_step

    memo = {}

    def placed_decode_step(params, cache, tokens, pos):
        where, sp = _serve_placement(params, cfg, tokens.shape[0],
                                     _positions(cache), mesh, cache_specs,
                                     memo)
        with torch.no_grad():
            logits, _ = lm.decode_step(blocks(params), blocks(cache),
                                       _batch_block(tokens, sp, mesh),
                                       int(pos), cfg, placement=where)
        return from_blocks(logits, NamedSharding(mesh, sp.logits)), cache

    return placed_decode_step


# ---------------------------------------------------------------------------
# Spec trees for full step signatures
# ---------------------------------------------------------------------------
def opt_state_pspecs(params_spec_tree, moment_dtype: str = "f32"
                     ) -> AdamWState:
    """AdamWState specs mirroring the param specs (ZeRO: the moments are
    sharded exactly like the params). int8 moments: codes take the param
    spec, row scales drop the last axis."""

    def moment(_, pspec):
        if moment_dtype != "int8":
            return pspec
        entries = tuple(pspec)
        scale = P(*entries[:-1], None) if entries else P()
        return Quantized(codes=pspec, scale=scale)

    return AdamWState(step=P(), mu=map_with_path(moment, params_spec_tree),
                      nu=map_with_path(moment, params_spec_tree))


def accum_batch_pspecs(batch, mesh: Mesh, scfg: ShardingConfig):
    """(A, microbatch, ...) leaves: batch dim 1 over the DP axes."""
    bax = batch_axes(mesh, scfg)
    b = bax if len(bax) > 1 else (bax[0] if bax else None)

    def leaf_spec(_, leaf):
        if leaf.ndim < 2:
            return P()
        return P(*((None, b) + (None,) * (leaf.ndim - 2)))

    return map_with_path(leaf_spec, batch)


def train_shardings(params_sds, opt_sds, batch_sds, mesh: Mesh,
                    scfg: ShardingConfig, moment_dtype: str = "f32"):
    """(in specs, out specs) of train_step: ((params, opt_state, batch),
    (params, opt_state, metrics)) as spec trees."""
    pspec = param_pspecs(params_sds, scfg, mesh)
    ospec = opt_state_pspecs(pspec, moment_dtype)
    bspec = accum_batch_pspecs(batch_sds, mesh, scfg)
    mspec = {"loss": P(), "grad_norm": P()}
    return (pspec, ospec, bspec), (pspec, ospec, mspec)
