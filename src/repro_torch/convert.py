"""Carry weights and packs from numpy arrays into the port's tensors.

The JAX package's NGP parameters are `{top: {sub: array}}` dicts, its
packed tensors carry `words`/`scale`/`offset` arrays beside static
`bits`, `shape` and `layout`, its `FusedPack` holds `layers`,
`hash_tables`, `modes` and `layout`, its AdamW state `step`, `mu` and
`nu`, its `NGPDataset` numpy arrays beside a `SceneConfig`, its DDPG
train state actor, critic and target dicts beside two AdamW states, its
`NGPTrace` numpy index arrays, and its LM parameters are a nested dict
whose block leaves are stacked over periods. These functions read any such object through `np.asarray`
(numpy arrays, or anything that converts to one, bfloat16 included) and
build the port's counterparts on `device`, so both packages can compute
on the same weights, optimizer state and data. Nothing here imports the
JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.ddpg import _TrainState
from repro_torch.hwsim.trace import NGPTrace
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.nerf.dataset import NGPDataset
from repro_torch.nerf.fast_render import FusedPack, repack_fused_pack
from repro_torch.nerf.scenes import SceneConfig
from repro_torch.optim.adamw import AdamWState
from repro_torch.quant.packing import PackedTensor


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (the reference's arrays carry an
        # extension dtype); carry the bits across as int16.
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _tree(node, device: torch.device):
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    return _tensor(node, device)


def params_from_numpy(tree: Dict, device: DeviceLike = None) -> Dict:
    """NGP parameters `{top: {sub: array}}` -> the same dict of tensors on
    `device` (the card unless `device="cpu"`)."""
    return _tree(tree, resolve_device(device))


def adamw_state_from_numpy(state, device: DeviceLike = None) -> AdamWState:
    """An AdamW state (`step`, moment trees `mu` and `nu` in the
    parameters' dtype) -> the port's `AdamWState` on `device`."""
    dev = resolve_device(device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        mu=_tree(state.mu, dev), nu=_tree(state.nu, dev))


_DATASET_ARRAYS = ("train_rays_o", "train_rays_d", "train_rgb",
                   "test_rays_o", "test_rays_d", "test_rgb")


def dataset_from_numpy(ds) -> NGPDataset:
    """An `NGPDataset` (scene name, `SceneConfig` fields, numpy arrays) ->
    the port's, with the arrays as they are: the same batches are drawn
    from both."""
    cfg = SceneConfig(**{f.name: getattr(ds.cfg, f.name)
                         for f in dataclasses.fields(SceneConfig)})
    return NGPDataset(ds.scene_name, cfg,
                      *(np.asarray(getattr(ds, a)) for a in _DATASET_ARRAYS))


def ddpg_state_from_numpy(state, device: DeviceLike = None):
    """A DDPG train state (`actor`, `critic`, `target_actor`,
    `target_critic` dicts of arrays, `actor_opt` and `critic_opt` AdamW
    states) -> the port's `_TrainState` on `device`."""
    dev = resolve_device(device)
    return _TrainState(
        actor=_tree(state.actor, dev), critic=_tree(state.critic, dev),
        target_actor=_tree(state.target_actor, dev),
        target_critic=_tree(state.target_critic, dev),
        actor_opt=adamw_state_from_numpy(state.actor_opt, dev),
        critic_opt=adamw_state_from_numpy(state.critic_opt, dev))


def trace_from_numpy(trace):
    """An `NGPTrace` (index arrays, entries, subgrid ids, layer dims and
    names) -> the port's, with the arrays as they are."""
    return NGPTrace(
        n_rays=int(trace.n_rays), n_samples=int(trace.n_samples),
        level_indices=[np.asarray(a) for a in trace.level_indices],
        level_entries=[int(e) for e in trace.level_entries],
        subgrid_ids=np.asarray(trace.subgrid_ids),
        mlp_dims=[tuple(int(v) for v in d) for d in trace.mlp_dims],
        mlp_names=list(trace.mlp_names))


def packed_from_numpy(pt, device: DeviceLike = None) -> PackedTensor:
    """A packed tensor (`words`, `scale`, `offset`, `bits`, `shape`,
    `layout`) -> `PackedTensor` on `device`, words bit for bit."""
    dev = resolve_device(device)
    return PackedTensor(
        words=_tensor(np.asarray(pt.words, np.int32), dev),
        scale=_tensor(np.asarray(pt.scale, np.float32), dev),
        offset=_tensor(np.asarray(pt.offset, np.int32), dev),
        bits=int(pt.bits),
        shape=tuple(int(s) for s in pt.shape),
        layout=str(getattr(pt, "layout", "planar")),
    )


def _value(v, dev: torch.device):
    return packed_from_numpy(v, dev) if hasattr(v, "words") \
        else _tensor(v, dev)


def pack_from_numpy(pack, device: DeviceLike = None) -> FusedPack:
    """A fused pack -> `FusedPack` on `device`. The storage arrays are
    carried over; the compute forms are staged anew for the pack's
    `layout` (they are derived from the storage and nothing else)."""
    dev = resolve_device(device)
    layers = {name: {k: _value(v, dev) for k, v in lyr.items()}
              for name, lyr in pack.layers.items()}
    tables = {name: _value(t, dev) for name, t in pack.hash_tables.items()}
    out = FusedPack(layers=layers, hash_tables=tables,
                    modes=tuple(pack.modes))
    layout = str(getattr(pack, "layout", "planar"))
    return repack_fused_pack(out, layout) if layout != "planar" else out


_STACKED = ("blocks", "enc_blocks")


def lm_params_from_numpy(tree: Dict, device: DeviceLike = None) -> Dict:
    """The reference's LM parameters (`lm.init_params`: leaves that
    `np.asarray` reads, block leaves stacked over periods under
    `blocks/pos<i>`, and for whisper the encoder's stacked over its
    layers under `enc_blocks/pos0`) -> the port's layout on `device`: the
    same top-level leaves, and `blocks` (and `enc_blocks`) a list with
    one dict per layer (layer n * period + i is period n's `pos<i>`).
    Every subtree of a block crosses as it is: attention and the decoder's
    `xattn`, dense FFN, the `moe` subtree (the f32 router, the expert
    stacks, the `dense` residual FFN), and the `ssm`, `mlstm` and `slstm`
    mixers."""
    dev = resolve_device(device)
    out = {k: _tree(v, dev) for k, v in tree.items() if k not in _STACKED}
    for key in _STACKED:
        if key in tree:
            out[key] = _layers(tree[key], dev)
    return out


def _layers(blocks: Dict, dev: torch.device) -> List[Dict]:
    """{"pos<i>": tree stacked over periods} -> one dict per layer."""
    n_pos = len(blocks)
    n_periods = len(np.asarray(_first_leaf(blocks["pos0"])))
    return [_tree(_slice(blocks[f"pos{i}"], n), dev)
            for n in range(n_periods) for i in range(n_pos)]


def _first_leaf(node):
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node


def _slice(node, n: int):
    if isinstance(node, dict):
        return {k: _slice(v, n) for k, v in node.items()}
    return np.asarray(node)[n]
