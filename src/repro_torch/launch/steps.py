"""Step builders: the train step (gradient accumulation + AdamW) and the
serve steps (prefill and decode), with the spec trees of their operands.

The counterpart of `repro/launch/steps.py`. The reference's steps are pure
functions that `jit` compiles and shards; the port's run eagerly on one
card. The train step takes the gradient of `lm.loss_fn` with autograd
(through the attention kernels' backward on the card), and the decode
step updates its cache in place (the counterpart of the reference's
donated cache buffer).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.distributed.sharding import (
    P,
    ShardingConfig,
    batch_axes,
    param_pspecs,
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
                    accum_dtype: torch.dtype = torch.float32) -> Callable:
    """batch leaves are (A, microbatch, ...): `loss_fn` runs on each of
    the A microbatches, its autograd gradients summed into an
    `accum_dtype` accumulator, which is divided by A, clipped to
    `grad_clip` global norm, and applied by one AdamW update.

    `train_step(params, opt_state, batch) -> (params, opt_state, metrics)`
    returns new trees (the old ones are not updated in place); metrics
    `{"loss": mean microbatch loss, "grad_norm": pre-clip norm}` are 0-d
    tensors on the params' device, and the step makes no host sync."""

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


def make_prefill_step(cfg: ModelConfig, max_seq: int) -> Callable:
    def prefill_step(params, batch):
        return lm.prefill(params, batch, cfg, max_seq)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(params, cache, tokens, pos):
        return lm.decode_step(params, cache, tokens, pos, cfg)

    return decode_step


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
