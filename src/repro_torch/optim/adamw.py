"""AdamW over a nested params tree; the moment trees mirror it exactly.

Moments in the parameters' dtype only: the quantized moments of the
reference (`moment_dtype` "f32", "bf16", "int8", its `optim/state_codec`)
are not ported yet (ROADMAP §1 item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.tree_util import map_with_path, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    # Parameters whose path contains one of these substrings get no decay
    # (biases, norms, embeddings by convention). The paths are the
    # reference's ("sigma/0/b", "hash/level_3"): an NGP's biases and
    # tables match none of them, so they are decayed, as there.
    no_decay_substrings: tuple = ("bias", "norm", "scale_param")


class AdamWState(NamedTuple):
    step: torch.Tensor  # scalar int32, on the parameters' device
    mu: Any  # first moment, same tree as params
    nu: Any  # second moment, same tree as params


def _check_moment_dtype(moment_dtype: str) -> None:
    if moment_dtype != "param":
        raise NotImplementedError(
            f"moment_dtype={moment_dtype!r}: the quantized AdamW moments "
            "(optim/state_codec) are not ported yet, ROADMAP §1 item 9")


def adamw_init(params: Any, moment_dtype: str = "param") -> AdamWState:
    """Zero moments in the parameters' dtype (`moment_dtype="param"`)."""
    _check_moment_dtype(moment_dtype)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(torch.zeros_like, params),
                      nu=tree_map(torch.zeros_like, params))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any,
                 config: AdamWConfig,
                 lr_schedule: Optional[Callable] = None,
                 moment_dtype: str = "param"):
    """One AdamW step. Returns (new_params, new_state); nothing is updated
    in place. The bias corrections are 1 - b ** step in float32, as the
    reference computes them."""
    _check_moment_dtype(moment_dtype)
    step = state.step + 1
    lr = config.lr if lr_schedule is None else lr_schedule(step) * config.lr
    b1, b2 = config.b1, config.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf

    new_mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype),
                      state.mu, grads)
    new_nu = tree_map(
        lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(v.dtype)),
        state.nu, grads)

    def _upd(path, p, m, v):
        update = (m / bc1) / (torch.sqrt(v / bc2) + config.eps)
        if config.weight_decay > 0.0 and not any(
                s in path for s in config.no_decay_substrings):
            update = update + config.weight_decay * p
        return (p - lr * update).to(p.dtype)

    new_params = map_with_path(_upd, params, new_mu, new_nu)
    return new_params, AdamWState(step=step, mu=new_mu, nu=new_nu)
