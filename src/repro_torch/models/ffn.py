"""Dense FFN blocks (GLU / gelu / squared-ReLU).

The counterpart of the dense half of `repro/models/ffn.py`; the
mixture-of-experts FFN comes with the MoE blocks (ROADMAP §1 item 8).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.common import ACT_FNS, ModelConfig, dense_init


def ffn_param_shapes(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, dff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.ffn_type in ("swiglu", "geglu"):
        return {"w_gate": (d, dff), "w_in": (d, dff), "w_out": (dff, d)}
    return {"w_in": (d, dff), "w_out": (dff, d)}


def init_ffn(generator: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Dict:
    return {name: dense_init(generator, shape[0], shape[1], cfg.param_dtype)
            for name, shape in ffn_param_shapes(cfg, d_ff).items()}


def ffn(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.ffn_type == "swiglu":
        h = ACT_FNS["silu"](x @ params["w_gate"]) * (x @ params["w_in"])
    elif cfg.ffn_type == "geglu":
        h = ACT_FNS["gelu"](x @ params["w_gate"]) * (x @ params["w_in"])
    elif cfg.ffn_type == "gelu":
        h = ACT_FNS["gelu"](x @ params["w_in"])
    elif cfg.ffn_type == "relu2":
        h = ACT_FNS["relu2"](x @ params["w_in"])
    else:
        raise ValueError(cfg.ffn_type)
    return h @ params["w_out"]
