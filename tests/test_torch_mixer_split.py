"""The Mamba and xLSTM mixers split over `model`, in one process.

Each `model` rank of tp in {2, 4} is played in turn by `Rank`, a stand-in
for `distributed.sharding.Placement` with its `own` (the cut of a leaf to
the rank's heads or channels) and no process group: Megatron's operators
return their input, `gather_model` hands back the whole leaf the block
was cut from, and `sum_over_model` returns the ranks' sum of the partial
products a first pass recorded. The two layout traps are pinned:

- Mamba's `in_proj` (d, 2 d_inner) holds x and z side by side, so rank r
  takes columns [r din/tp, (r+1) din/tp) of each half, from the whole
  leaf and from its column block alike (a column block is a block of
  halves, not of channels);
- the sLSTM's `W` (d, 4 H dh) and `b` are gate-major (4, H, dh), so rank
  r takes head block r of each of the four gates.

The mixers on every rank's leaves (given whole, or as the rank's blocks
of their specs), their partial outputs summed over the ranks, equal the
whole mixer's output within 1e-5 of its largest entry; Mamba's x_proj
product is summed over the ranks before dt_proj reads it.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import (
    Placement,
    ShardingConfig,
    spec_for_path,
)
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm_blocks as xl

TPS = (2, 4)
REL = 1e-5
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Rank:
    """`model` rank `tp_rank` of `tp` without a process group."""
    own = Placement.own
    # no sequence parallelism: a mixer's `enter` and `leave` are
    # Megatron's `copy_to_model` and `reduce_from_model` below
    enter, leave, seq = Placement.enter, Placement.leave, False

    def __init__(self, tp, rank, wholes=None, total=None):
        self.tp, self.tp_rank = tp, rank
        self.wholes = wholes or {}  # id(block) -> the whole leaf
        self.total, self.parts = total, []

    def copy_to_model(self, t):
        return t

    def reduce_from_model(self, t):
        return t

    def gather_model(self, t, dim, summed=False):
        assert summed  # each rank uses a part of the gathered leaf
        whole = self.wholes[id(t)]
        b = whole.shape[dim] // self.tp
        assert torch.equal(whole.narrow(dim, self.tp_rank * b, b), t)
        return whole

    def sum_over_model(self, t):
        self.parts.append(t)
        return t if self.total is None else self.total


def block(path, w, tp, rank):
    """Rank `rank`'s block of the leaf at `path` where its spec names
    `model` (the FSDP axes left whole, as `gather_on_use` leaves them)."""
    spec = spec_for_path(path, w.ndim, False, ShardingConfig())
    for dim, ax in enumerate(spec):
        if ax == "model":
            b = w.shape[dim] // tp
            w = w.narrow(dim, rank * b, b)
    return w


def ranks_leaves(params, mixer, tp, given):
    """Each rank's (leaves, the whole leaf of each gathered block)."""
    out = []
    for r in range(tp):
        if given == "whole":
            out.append((params, {}))
            continue
        mine = {k: block(f"blocks/0/{mixer}/{k}", w, tp, r)
                for k, w in params.items()}
        out.append((mine, {id(mine[k]): params[k] for k in mine}))
    return out


def inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(B, S, cfg.d_model))
                            .astype(np.float32))


def near(got, want):
    gap = float((got - want).abs().max())
    assert gap <= REL * float(want.abs().max()), gap


@pytest.mark.parametrize("given", ["whole", "block"])
@pytest.mark.parametrize("tp", TPS)
def test_in_proj_cut_is_x_and_z_channels(tp, given):
    cfg = get_arch("jamba-v0.1-52b").smoke
    din = ssm_mod.ssm_dims(cfg)[0]
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(cfg.d_model, 2 * din)).astype(np.float32))
    b = din // tp
    for r in range(tp):
        t = w if given == "whole" else w[:, r * 2 * b:(r + 1) * 2 * b]
        got = Rank(tp, r, {id(t): w}).own(t, 1, 2 * din, 2)
        want = torch.cat([w[:, r * b:(r + 1) * b],
                          w[:, din + r * b:din + (r + 1) * b]], dim=1)
        assert torch.equal(got, want)


@pytest.mark.parametrize("given", ["whole", "block"])
@pytest.mark.parametrize("tp", TPS)
def test_slstm_cut_is_each_gates_head_block(tp, given):
    cfg = get_arch("xlstm-350m").smoke
    H, dh = xl._heads(cfg)
    hl, rng = H // tp, np.random.default_rng(2)
    W = torch.from_numpy(rng.normal(size=(cfg.d_model, 4 * H * dh))
                         .astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(4 * H * dh,))
                            .astype(np.float32))
    for r in range(tp):
        n = 4 * H * dh // tp
        t = W if given == "whole" else W[:, r * n:(r + 1) * n]
        got = Rank(tp, r, {id(t): W}).own(t, 1, 4 * H * dh, 4)
        want = W.view(-1, 4, H, dh)[:, :, r * hl:(r + 1) * hl]
        assert torch.equal(got, want.reshape(cfg.d_model, -1))
        got = Rank(tp, r).own(bias, 0, 4 * H * dh, 4)
        want = bias.view(4, H, dh)[:, r * hl:(r + 1) * hl].reshape(-1)
        assert torch.equal(got, want)


@pytest.mark.parametrize("given", ["whole", "block"])
@pytest.mark.parametrize("tp", TPS)
def test_mamba_split_sums_to_the_whole_mixer(tp, given):
    cfg = get_arch("jamba-v0.1-52b").smoke
    params = ssm_mod.init_ssm(torch.Generator().manual_seed(3), cfg)
    x = inputs(cfg, 3)
    want = ssm_mod.ssm_forward(params, x, cfg)
    leaves = ranks_leaves(params, "ssm", tp, given)
    firsts = [Rank(tp, r, wholes) for r, (_, wholes) in enumerate(leaves)]
    for rank, (p, _) in zip(firsts, leaves):  # the partial x_proj products
        ssm_mod.ssm_forward(p, x, cfg, placement=rank)
    assert all(len(rank.parts) == 1 for rank in firsts)
    din, r_dt, n = ssm_mod.ssm_dims(cfg)
    assert {tuple(rank.parts[0].shape) for rank in firsts} \
        == {(B, S, r_dt + 2 * n)}
    total = sum(rank.parts[0] for rank in firsts)
    got = sum(ssm_mod.ssm_forward(p, x, cfg,
                                  placement=Rank(tp, r, wholes, total))
              for r, (p, wholes) in enumerate(leaves))
    near(got, want)


@pytest.mark.parametrize("given", ["whole", "block"])
@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
@pytest.mark.parametrize("tp", TPS)
def test_xlstm_split_sums_to_the_whole_mixer(tp, cell, given):
    cfg = get_arch("xlstm-350m").smoke
    init = xl.init_mlstm if cell == "mlstm" else xl.init_slstm
    forward = xl.mlstm_forward if cell == "mlstm" else xl.slstm_forward
    params = init(torch.Generator().manual_seed(4), cfg)
    x = inputs(cfg, 4)
    want = forward(params, x, cfg)
    leaves = ranks_leaves(params, cell, tp, given)
    ranks = [Rank(tp, r, wholes) for r, (_, wholes) in enumerate(leaves)]
    got = sum(forward(p, x, cfg, rank)
              for rank, (p, _) in zip(ranks, leaves))
    assert not any(rank.parts for rank in ranks)  # no sum inside a head
    near(got, want)
