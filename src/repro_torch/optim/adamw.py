"""AdamW over a nested params tree; the moment trees mirror it exactly.

`moment_dtype` is the reference's: "param" (the parameters' dtype), "f32"
/ "float32", "bf16" / "bfloat16", or "int8" (blockwise 8-bit Adam through
`optim/state_codec`); each leaf's moments are decoded to f32 around its
update and encoded again after it, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.optim.state_codec import RowMax, moment_codecs
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


def adamw_init(params: Any, moment_dtype: str = "param") -> AdamWState:
    """Zero moments: in the parameters' dtype (`moment_dtype="param"`), or
    encoded by `moment_dtype`'s codec ('f32', 'bf16' or 'int8')."""
    dev = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if moment_dtype == "param":
        return AdamWState(step=step, mu=tree_map(torch.zeros_like, params),
                          nu=tree_map(torch.zeros_like, params))
    mu_c, nu_c = moment_codecs(moment_dtype)
    return AdamWState(step=step, mu=tree_map(mu_c.init, params),
                      nu=tree_map(nu_c.init, params))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any,
                 config: AdamWConfig,
                 lr_schedule: Optional[Callable] = None,
                 moment_dtype: str = "param",
                 row_max: Optional[Callable[[str], Optional[RowMax]]] = None):
    """One AdamW step. Returns (new_params, new_state); nothing is updated
    in place. The bias corrections are 1 - b ** step in float32, as the
    reference computes them. `moment_dtype` must match what `adamw_init`
    was called with. The update is elementwise, so the leaves may be
    blocks of placed tensors; then `row_max(path)` gives the int8 codec
    the leaf's row-absmax reduction (`MomentCodec.encode`)."""
    step = state.step + 1
    lr = config.lr if lr_schedule is None else lr_schedule(step) * config.lr
    b1, b2 = config.b1, config.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf

    quantized = moment_dtype != "param"
    if quantized:
        mu_c, nu_c = moment_codecs(moment_dtype)
    new_mu, new_nu = {}, {}

    def _upd(path, p, g, m, v):
        # One leaf at a time: its moments are decoded, updated and encoded
        # again before the next leaf's are decoded, so at most one leaf's
        # f32 moments exist at once (int8 moments would otherwise peak
        # above f32 ones).
        if quantized:
            m, v = mu_c.decode(m), nu_c.decode(v)
        m = b1 * m + (1 - b1) * g.to(m.dtype)
        v = b2 * v + (1 - b2) * torch.square(g.to(v.dtype))
        update = (m / bc1) / (torch.sqrt(v / bc2) + config.eps)
        if config.weight_decay > 0.0 and not any(
                s in path for s in config.no_decay_substrings):
            update = update + config.weight_decay * p
        if quantized:
            rm = None if row_max is None else row_max(path)
            m, v = mu_c.encode(m, p, rm), nu_c.encode(v, p, rm)
        new_mu[path], new_nu[path] = m, v
        return (p - lr * update).to(p.dtype)

    new_params = map_with_path(_upd, params, grads, state.mu, state.nu)
    pick = lambda out: map_with_path(  # noqa: E731
        lambda path, _: out[path], params)
    return new_params, AdamWState(step=step, mu=pick(new_mu),
                                  nu=pick(new_nu))
