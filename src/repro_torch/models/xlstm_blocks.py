"""xLSTM blocks: mLSTM (matrix memory, parallel chunked form) and sLSTM
(scalar memory, strictly sequential recurrence).

The counterpart of `repro/models/xlstm_blocks.py`, in plain PyTorch (the
reference has no kernel here). mLSTM runs the stabilized parallel form, a
decay-masked attention-like contraction in query chunks of
`cfg.attn_chunk` positions with a remainder tail, as the reference does.
sLSTM has a true recurrent dependency (its gates see h_{t-1}), so it
runs a Python loop over time, one cell step a position; `_slstm_scan`
gives the outputs and the final state from one pass, where the
reference's prefill runs the recurrence twice for the same numbers.

Decode for both is an O(1) recurrent update on a small carried state.
Both caches start their stabilizer `m` at -1e30.

Placed training splits both cells over `model` by their heads (the
forwards' `placement`): each head's recurrence is its own, so a rank
runs its H / tp heads with no collective inside the time loop. A placed
prefill and decode split them the same way, the cache holding this
rank's heads of each state (the reference's cache specs put them over
`model`).

The sLSTM's positions and the mLSTM's query chunks run through
`hlo_counters.counted_loop`: as they are, but under a recording with trip
counts by a stand-in that counts two and three iterations.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.hlo_counters import counted_loop
from repro_torch.models.common import ModelConfig, dense_init

NEG_INF = -1e30


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    H = cfg.n_heads
    return H, cfg.d_model // H


# Each leaf's (axis of heads, entries a head along it: "dh" or 1, runs
# along it) under a split over `model`. The sLSTM's `W` and `b` hold the
# four gates one after another (gate-major (4, H, dh)): a column block of
# `W` is a block of gates, so each gate's run is cut to this rank's heads.
_MLSTM_HEADS = {"wq": (1, "dh", 1), "wk": (1, "dh", 1), "wv": (1, "dh", 1),
                "wog": (1, "dh", 1), "wi": (1, 1, 1), "wf": (1, 1, 1),
                "bi": (0, 1, 1), "bf": (0, 1, 1), "norm_scale": (0, 1, 1),
                "out_proj": (0, "dh", 1)}
_SLSTM_HEADS = {"W": (1, "dh", 4), "b": (0, "dh", 4), "R": (0, 1, 1),
                "norm_scale": (0, 1, 1), "out_proj": (0, "dh", 1)}


def _own_heads(params: Dict, cfg: ModelConfig, placement, layout: Dict
               ) -> Optional[Dict]:
    """This rank's leaves where `model` divides the heads (at one `model`
    rank, every head), else None. Rank r holds heads [r H/tp, (r+1) H/tp)
    of every leaf (`layout`, `Placement.own`). Each head's recurrence is
    its own, so a cell runs on its heads with no collective inside."""
    H, dh = _heads(cfg)
    if placement is None or H % placement.tp:
        return None
    own = {}
    for name, w in params.items():
        dim, size, runs = layout[name]
        size = dh if size == "dh" else size
        own[name] = placement.own(w, dim, runs * H * size, runs)
    return own


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    d = cfg.d_model
    H, dh = _heads(cfg)
    return {
        "wq": (d, H * dh),
        "wk": (d, H * dh),
        "wv": (d, H * dh),
        "wi": (d, H),  # input gate (exp), scalar per head
        "wf": (d, H),  # forget gate (sigmoid), scalar per head
        "wog": (d, H * dh),  # output gate (elementwise sigmoid)
        "out_proj": (H * dh, d),
        "norm_scale": (H, dh),  # per-head RMS norm on h
    }


def init_mlstm(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    """Weights from `generator` on its device; the gates' weights and
    biases in float32, the forget bias at 3."""
    dev = generator.device
    params = {}
    for name, shape in mlstm_param_shapes(cfg).items():
        if name == "norm_scale":
            params[name] = torch.ones(shape, dtype=cfg.param_dtype,
                                      device=dev)
        elif name in ("wi", "wf"):
            params[name] = dense_init(generator, shape[0], shape[1],
                                      torch.float32)
        else:
            params[name] = dense_init(generator, shape[0], shape[1],
                                      cfg.param_dtype)
    # Bias the forget gate towards remembering (standard LSTM trick).
    params["bf"] = torch.full((cfg.n_heads,), 3.0, dtype=torch.float32,
                              device=dev)
    params["bi"] = torch.zeros((cfg.n_heads,), dtype=torch.float32,
                               device=dev)
    return params


def _headwise_rms(h: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    # h: (..., H, dh)
    var = torch.mean(torch.square(h), dim=-1, keepdim=True)
    return h * torch.rsqrt(var + eps) * scale


def _gates(params: Dict, x: torch.Tensor):
    """(log input gate, log forget gate), float32, (..., H) each."""
    xf = x.float()
    log_i = xf @ params["wi"] + params["bi"]
    log_f = F.logsigmoid(xf @ params["wf"] + params["bf"])
    return log_i, log_f


def mlstm_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  placement=None) -> torch.Tensor:
    """Stabilized parallel mLSTM. x: (B, S, d) -> (B, S, d). Under a
    `placement` whose `model` axis divides the heads, this rank's heads
    (`_own_heads`) between Megatron's two operators."""
    own = _own_heads(params, cfg, placement, _MLSTM_HEADS)
    if own is not None:
        params = own
    if placement is not None:
        x = placement.enter(x, own is not None)
    B, S, d = x.shape
    dh = _heads(cfg)[1]
    H = params["wi"].shape[1]
    q = (x @ params["wq"]).reshape(B, S, H, dh)
    k = (x @ params["wk"]).reshape(B, S, H, dh)
    v = (x @ params["wv"]).reshape(B, S, H, dh)
    og = torch.sigmoid((x @ params["wog"]).reshape(B, S, H, dh))

    log_i, log_f = _gates(params, x)  # (B, S, H)
    Fc = torch.cumsum(log_f, dim=1)  # cumulative log-forget
    scale = 1.0 / math.sqrt(dh)
    kf, vf = k.float(), v.float()
    # log decay weight of source s seen from target t: F_t - F_s + log i_s
    base = (log_i - Fc).transpose(1, 2)  # (B, H, S)
    src = torch.arange(S, device=x.device)

    def one_chunk(start: int, c: int, q, kf, vf, Fc, base, src
                  ) -> torch.Tensor:
        Ft = Fc[:, start:start + c]  # (B, c, H)
        D = Ft[:, :, :, None] + base[:, None, :, :]  # (B, c, H, S)
        tpos = start + torch.arange(c, device=src.device)
        mask = tpos[:, None] >= src[None, :]
        D = torch.where(mask[None, :, None, :], D, NEG_INF)
        m = torch.amax(D, dim=-1, keepdim=True)  # (B, c, H, 1)
        w = torch.exp(D - m)
        s = torch.einsum("bchd,bshd->bchs", q[:, start:start + c].float(), kf)
        s = s * scale * w
        norm = torch.maximum(torch.abs(torch.sum(s, dim=-1)),
                             torch.exp(-m[..., 0]))
        return torch.einsum("bchs,bshd->bchd", s, vf) / norm[..., None]

    chunk = min(cfg.attn_chunk, S)
    n_chunks = max(S // chunk, 1)
    rem = S - n_chunks * chunk

    def chunks(n: int, *t) -> Tuple[torch.Tensor]:
        """The first n query chunks and the remainder, joined."""
        parts = [one_chunk(i * chunk, chunk, *t) for i in range(n)]
        if rem:
            parts.append(one_chunk(n_chunks * chunk, rem, *t))
        return (torch.cat(parts, dim=1),)

    h, = counted_loop(chunks, n_chunks, q, kf, vf, Fc, base, src)

    h = _headwise_rms(h, params["norm_scale"].float())
    h = (h.to(x.dtype) * og).reshape(B, S, H * dh)
    out = h @ params["out_proj"]
    return out if placement is None else placement.leave(out,
                                                         own is not None)


def _enter_heads(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 placement, layout: Dict):
    """(params, x, whether split) for a cell under `placement`: this
    rank's heads and its input entered (`_own_heads`), or as they are."""
    own = _own_heads(params, cfg, placement, layout)
    if placement is not None:
        x = placement.enter(x, own is not None)
    return (params if own is None else own), x, own is not None


def mlstm_final_state(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                      placement=None) -> Dict:
    """Decode cache after consuming x (for prefill): one weighted pass.

    C_S = sum_s exp(F_S - F_s + log i_s - m) k_s v_s^T (and n, m
    likewise). Under a `placement` whose `model` axis divides the heads,
    this rank's heads (`_own_heads`)."""
    params, x, _ = _enter_heads(params, x, cfg, placement, _MLSTM_HEADS)
    B, S, d = x.shape
    dh = _heads(cfg)[1]
    H = params["wi"].shape[1]
    k = (x @ params["wk"]).reshape(B, S, H, dh).float() / math.sqrt(dh)
    v = (x @ params["wv"]).reshape(B, S, H, dh).float()
    log_i, log_f = _gates(params, x)
    Fc = torch.cumsum(log_f, dim=1)
    logw = Fc[:, -1:, :] - Fc + log_i  # (B, S, H)
    m = torch.amax(logw, dim=1)  # (B, H)
    w = torch.exp(logw - m[:, None, :])
    C = torch.einsum("bsh,bshd,bshk->bhdk", w, k, v)
    n = torch.einsum("bsh,bshd->bhd", w, k)
    return {"C": C, "n": n, "m": m}


def init_mlstm_cache(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Dict:
    H, dh = _heads(cfg)
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, H, dh), dtype=f32, device=device),
        "m": torch.full((batch, H), NEG_INF, dtype=f32, device=device),
    }


def mlstm_decode_step(params: Dict, x: torch.Tensor, cache: Dict,
                      cfg: ModelConfig, placement=None
                      ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d). Recurrent mLSTM update: (out (B, 1, d), new cache).
    Under a `placement` whose `model` axis divides the heads, this rank's
    heads (`cache` holds them) between Megatron's two operators."""
    params, x, split = _enter_heads(params, x, cfg, placement, _MLSTM_HEADS)
    B = x.shape[0]
    dh = _heads(cfg)[1]
    H = params["wi"].shape[1]
    xt = x[:, 0]
    q = (xt @ params["wq"]).reshape(B, H, dh).float()
    k = (xt @ params["wk"]).reshape(B, H, dh).float()
    v = (xt @ params["wv"]).reshape(B, H, dh).float()
    og = torch.sigmoid((xt @ params["wog"]).reshape(B, H, dh))

    log_i, log_f = _gates(params, xt)  # (B, H)
    m_new = torch.maximum(log_f + cache["m"], log_i)
    f_sc = torch.exp(log_f + cache["m"] - m_new)[..., None]
    i_sc = torch.exp(log_i - m_new)[..., None]

    k_sc = k / math.sqrt(dh)
    C = cache["C"] * f_sc[..., None] + i_sc[..., None] * (
        k_sc[..., :, None] * v[..., None, :])  # (B, H, dh, dh)
    n = cache["n"] * f_sc + i_sc * k_sc
    num = torch.einsum("bhdk,bhd->bhk", C, q)  # read with q over key dim
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, q)),
                        torch.exp(-m_new))
    h = num / den[..., None]
    h = _headwise_rms(h, params["norm_scale"].float())
    h = (h.to(x.dtype) * og).reshape(B, 1, H * dh)
    out = h @ params["out_proj"]
    if placement is not None:
        out = placement.leave(out, split)
    return out, {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    d = cfg.d_model
    H, dh = _heads(cfg)
    return {
        "W": (d, 4 * H * dh),  # input weights for (z, i, f, o)
        "R": (H, dh, 4 * dh),  # block-diagonal recurrent weights per head
        "b": (4 * H * dh,),
        "norm_scale": (H, dh),
        "out_proj": (H * dh, d),
    }


def init_slstm(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    """Weights from `generator` on its device; the forget gate's bias 3."""
    dev = generator.device
    d = cfg.d_model
    H, dh = _heads(cfg)
    b = torch.zeros((4, H, dh), dtype=torch.float32, device=dev)
    b[2] = 3.0  # forget-gate bias
    R = torch.randn((H, dh, 4 * dh), generator=generator, device=dev,
                    dtype=torch.float32) / math.sqrt(dh)
    return {
        "W": dense_init(generator, d, 4 * H * dh, cfg.param_dtype),
        "R": R.to(cfg.param_dtype),
        "b": b.reshape(-1),
        "norm_scale": torch.ones((H, dh), dtype=cfg.param_dtype, device=dev),
        "out_proj": dense_init(generator, H * dh, d, cfg.param_dtype),
    }


def _slstm_cell(params: Dict, wx_t: torch.Tensor, state, cfg: ModelConfig):
    """One recurrence step. wx_t: (B, 4, H, dh) precomputed W @ x_t + b;
    H the heads `params["R"]` holds."""
    H, dh = params["R"].shape[:2]
    c, n, h, m = state  # each (B, H, dh)
    rh = torch.einsum("bhd,hdk->bhk", h, params["R"].float())
    rh = rh.reshape(h.shape[0], H, 4, dh).transpose(1, 2)  # (B, 4, H, dh)
    pre = wx_t + rh
    z = torch.tanh(pre[:, 0])
    log_i = pre[:, 1]
    log_f = F.logsigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(log_f + m, log_i)
    i_sc = torch.exp(log_i - m_new)
    f_sc = torch.exp(log_f + m - m_new)
    c_new = f_sc * c + i_sc * z
    n_new = f_sc * n + i_sc
    h_new = o * (c_new / torch.clamp(n_new, min=1e-6))
    return c_new, n_new, h_new, m_new


def _slstm_wx(params: Dict, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """W @ x + b in float32: (B, S, 4, H, dh), H the heads `W` holds."""
    B, S, _ = x.shape
    dh = _heads(cfg)[1]
    wx = x.float() @ params["W"].float() + params["b"]
    return wx.reshape(B, S, 4, -1, dh)


def _slstm_steps(T: int, wx: torch.Tensor, R: torch.Tensor, *state):
    """The recurrence over the first T positions of wx (B, S, 4, H, dh)
    from `state` (c, n, h, m): (h at each position (B, T, H, dh), and
    the final c, n, h, m)."""
    hs = []
    for t in range(T):
        state = _slstm_cell({"R": R}, wx[:, t], state, None)
        hs.append(state[2])
    return (torch.stack(hs, dim=1),) + tuple(state)


def _slstm_scan(params: Dict, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict]:
    """The recurrence over x (B, S, d) from the zero state (m at -1e30):
    (h at every position (B, S, H, dh), the final state)."""
    wx = _slstm_wx(params, x, cfg)
    zero = wx.new_zeros(wx.shape[:1] + wx.shape[3:])  # (B, H, dh)
    hs, c, n, h, m = counted_loop(_slstm_steps, x.shape[1], wx, params["R"],
                                  zero, zero, zero,
                                  torch.full_like(zero, NEG_INF))
    return hs, {"c": c, "n": n, "h": h, "m": m}


def _slstm_out(params: Dict, h: torch.Tensor, x: torch.Tensor
               ) -> torch.Tensor:
    """The head-wise norm and output projection of h (B, S, H, dh)."""
    B, S = h.shape[:2]
    h = _headwise_rms(h, params["norm_scale"].float())
    return h.to(x.dtype).reshape(B, S, -1) @ params["out_proj"]


def slstm_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  placement=None) -> torch.Tensor:
    """x: (B, S, d); sequential over S. Under a `placement` whose `model`
    axis divides the heads, this rank's heads (`_own_heads`) between
    Megatron's two operators: the time loop runs on them alone."""
    own = _own_heads(params, cfg, placement, _SLSTM_HEADS)
    if own is not None:
        params = own
    if placement is not None:
        x = placement.enter(x, own is not None)
    out = _slstm_out(params, _slstm_scan(params, x, cfg)[0], x)
    return out if placement is None else placement.leave(out,
                                                         own is not None)


def slstm_final_state(params: Dict, x: torch.Tensor,
                      cfg: ModelConfig) -> Dict:
    """Decode cache after consuming x: run the recurrence, keep the final
    state."""
    return _slstm_scan(params, x, cfg)[1]


def slstm_forward_with_state(params: Dict, x: torch.Tensor,
                             cfg: ModelConfig, placement=None
                             ) -> Tuple[torch.Tensor, Dict]:
    """`slstm_forward` and `slstm_final_state` from one pass of the
    recurrence (prefill); under a `placement`, this rank's heads as
    `slstm_forward` takes them, and their state."""
    params, x, split = _enter_heads(params, x, cfg, placement, _SLSTM_HEADS)
    hs, state = _slstm_scan(params, x, cfg)
    out = _slstm_out(params, hs, x)
    if placement is not None:
        out = placement.leave(out, split)
    return out, state


def init_slstm_cache(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Dict:
    H, dh = _heads(cfg)
    z = lambda: torch.zeros((batch, H, dh), dtype=torch.float32,
                            device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, H, dh), NEG_INF, dtype=torch.float32,
                            device=device)}


def slstm_decode_step(params: Dict, x: torch.Tensor, cache: Dict,
                      cfg: ModelConfig, placement=None
                      ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d). One recurrence step: (out (B, 1, d), new cache).
    Under a `placement`, this rank's heads as `mlstm_decode_step`."""
    params, x, split = _enter_heads(params, x, cfg, placement, _SLSTM_HEADS)
    wx = _slstm_wx(params, x, cfg)[:, 0]
    state = (cache["c"], cache["n"], cache["h"], cache["m"])
    c, n, h, m = _slstm_cell(params, wx, state, cfg)
    out = _slstm_out(params, h[:, None], x)
    if placement is not None:
        out = placement.leave(out, split)
    return out, {"c": c, "n": n, "h": h, "m": m}
