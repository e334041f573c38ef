"""Instant-NGP model: hash encoding -> density MLP -> color MLP.

  - hash encoding: L levels x F features
  - density MLP: enc -> hidden -> (1 sigma + geo_feat)
  - color MLP: (geo_feat ++ SH(view_dir)) -> hidden -> hidden -> 3 rgb

Quantization hooks: every linear layer takes per-layer weight bits and input
activation bits, and each hash level its own bits, all as tensors of an
`NGPQuantSpec`; a bit value >= 16 is the full-precision sentinel.
Parameters are a plain dict of tensors, `{top: {sub: tensor}}`, with the
JAX package's names and layouts (weights `w` are (d_in, d_out)).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.nerf.hash_encoding import (
    HashEncodingConfig,
    hash_encode,
    init_hash_tables,
)
from repro_torch.quant.linear_quant import activation_qparams, weight_qparams
from repro_torch.quant.policy import QuantPolicy, QuantUnit, UnitKind
from repro_torch.quant.qat import ste_fake_quant


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    hash: HashEncodingConfig = HashEncodingConfig()
    hidden_dim: int = 32
    geo_feat_dim: int = 15
    color_hidden_dim: int = 32
    sh_degree: int = 3  # spherical-harmonic view encoding, (deg+1)^2 coeffs
    density_activation: str = "exp"  # 'exp' (trunc) or 'softplus'

    @property
    def sh_dim(self) -> int:
        return (self.sh_degree + 1) ** 2


def ngp_linear_names(cfg: NGPConfig) -> List[str]:
    """Ordered linear layers; order defines the quantization-unit walk."""
    return ["sigma/0", "sigma/1", "color/0", "color/1", "color/2"]


def _linear_dims(cfg: NGPConfig) -> Dict[str, Tuple[int, int]]:
    enc = cfg.hash.out_dim
    return {
        "sigma/0": (enc, cfg.hidden_dim),
        "sigma/1": (cfg.hidden_dim, 1 + cfg.geo_feat_dim),
        "color/0": (cfg.geo_feat_dim + cfg.sh_dim, cfg.color_hidden_dim),
        "color/1": (cfg.color_hidden_dim, cfg.color_hidden_dim),
        "color/2": (cfg.color_hidden_dim, 3),
    }


def init_ngp(generator: torch.Generator, cfg: NGPConfig,
             device: DeviceLike = None) -> Dict:
    """Random parameters from `generator` (drawn on the CPU, then moved,
    so a seed gives the same weights on any device). Runs on the card
    unless `device="cpu"`."""
    dev = resolve_device(device)
    params: Dict = {"hash": init_hash_tables(generator, cfg.hash, dev)}
    for name, (d_in, d_out) in _linear_dims(cfg).items():
        scale = float(np.sqrt(2.0 / d_in))
        w = torch.randn((d_in, d_out), generator=generator) * scale
        params[name] = {"w": w.to(dev),
                        "b": torch.zeros((d_out,), device=dev)}
    return params


# ---------------------------------------------------------------------------
# Quantization spec: bit tensors + calibrated activation ranges.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class NGPQuantSpec:
    """Per-unit bit widths as f32 tensors (one forward serves any policy)."""

    hash_bits: torch.Tensor  # (L,)
    weight_bits: torch.Tensor  # (n_linear,), order = ngp_linear_names
    act_bits: torch.Tensor  # (n_linear,)
    act_ranges: torch.Tensor  # (n_linear, 2) calibrated (lo, hi)
    paper_exact: bool = True


def _f32(values, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def no_quant_spec(cfg: NGPConfig, device: DeviceLike = None
                  ) -> NGPQuantSpec:
    """The unquantized spec (32 bits everywhere) on `device` (the card
    unless "cpu")."""
    device = resolve_device(device)
    n_lin = len(ngp_linear_names(cfg))
    return NGPQuantSpec(
        hash_bits=_f32([32.0] * cfg.hash.n_levels, device),
        weight_bits=_f32([32.0] * n_lin, device),
        act_bits=_f32([32.0] * n_lin, device),
        act_ranges=_f32([[0.0, 1.0]] * n_lin, device),
    )


def uniform_quant_spec(cfg: NGPConfig, bits: int,
                       act_ranges: Optional[torch.Tensor] = None,
                       device: DeviceLike = None) -> NGPQuantSpec:
    """`bits` everywhere on `device` (the card unless "cpu")."""
    device = resolve_device(device)
    n_lin = len(ngp_linear_names(cfg))
    if act_ranges is None:
        act_ranges = _f32([[0.0, 1.0]] * n_lin, device)
    return NGPQuantSpec(
        hash_bits=_f32([float(bits)] * cfg.hash.n_levels, device),
        weight_bits=_f32([float(bits)] * n_lin, device),
        act_bits=_f32([float(bits)] * n_lin, device),
        act_ranges=act_ranges,
    )


def spec_from_policy(cfg: NGPConfig, policy: QuantPolicy,
                     act_ranges: torch.Tensor) -> NGPQuantSpec:
    """Build the spec from a host-side QuantPolicy (on the device of
    `act_ranges`)."""
    names = ngp_linear_names(cfg)
    hb = [0.0] * cfg.hash.n_levels
    wb = [32.0] * len(names)
    ab = [32.0] * len(names)
    for u in policy.units:
        if u.kind == UnitKind.HASH_LEVEL:
            hb[u.param_size] = float(u.bits)
        elif u.kind == UnitKind.WEIGHT:
            wb[names.index(u.name.rsplit(":", 1)[0])] = float(u.bits)
        elif u.kind == UnitKind.ACTIVATION:
            ab[names.index(u.name.rsplit(":", 1)[0])] = float(u.bits)
    dev = act_ranges.device
    return NGPQuantSpec(hash_bits=_f32(hb, dev), weight_bits=_f32(wb, dev),
                        act_bits=_f32(ab, dev), act_ranges=act_ranges)


def make_quant_units(cfg: NGPConfig) -> List[QuantUnit]:
    """Episode walk order: hash levels first (coarse->fine), then for each
    MLP layer its activation then weight decision — Eqs. 1-2 metadata."""
    units: List[QuantUnit] = []
    i = 0
    for l in range(cfg.hash.n_levels):
        units.append(QuantUnit(
            name=f"hash/level_{l}", kind=UnitKind.HASH_LEVEL, layer_type=1,
            d_in=cfg.hash.n_features, d_out=cfg.hash.level_entries(l),
            param_size=l, index=i,
        ))
        i += 1
    dims = _linear_dims(cfg)
    for name in ngp_linear_names(cfg):
        d_in, d_out = dims[name]
        for suffix, kind in ((":a", UnitKind.ACTIVATION),
                             (":w", UnitKind.WEIGHT)):
            units.append(QuantUnit(
                name=f"{name}{suffix}", kind=kind, layer_type=0, d_in=d_in,
                d_out=d_out, param_size=d_in * d_out, index=i,
            ))
            i += 1
    return units


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _maybe_quant_weight(w, bits, paper_exact):
    qp = weight_qparams(w.min(), w.max(), bits, paper_exact=paper_exact)
    q = ste_fake_quant(w, qp, symmetric=True)
    return torch.where(bits >= 16.0, w, q)


def _maybe_quant_act(x, bits, lo, hi):
    qp = activation_qparams(lo, hi, bits)
    q = ste_fake_quant(x, qp, symmetric=False)
    return torch.where(bits >= 16.0, x, q)


def _qlinear(params: Dict, x: torch.Tensor, idx: int, spec: NGPQuantSpec,
             taps: Optional[Dict] = None, name: str = "") -> torch.Tensor:
    if taps is not None:
        taps[name] = x  # pre-quantization input (calibration point)
    x = _maybe_quant_act(x, spec.act_bits[idx], spec.act_ranges[idx, 0],
                         spec.act_ranges[idx, 1])
    w = _maybe_quant_weight(params["w"], spec.weight_bits[idx],
                            spec.paper_exact)
    return x @ w + params["b"]


def sh_encode(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real spherical harmonics basis up to `degree` (inclusive), (P, (d+1)^2).

    Hard-coded closed forms up to degree 4 (the Instant-NGP default).
    """
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    if degree >= 2:  # shared monomials for the whole degree ladder
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 1:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree >= 2:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
        ]
    if degree >= 3:
        out += [
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * x * y * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ]
    if degree >= 4:
        out += [
            2.5033429417967046 * xy * (xx - yy),
            1.7701307697799304 * yz * (-3.0 * xx + yy),
            0.94617469575756008 * xy * (7.0 * zz - 1.0),
            0.66904654355728921 * yz * (3.0 - 7.0 * zz),
            -3.1735664074561294 * zz + 3.7024941420321507 * zz * zz
            + 0.31735664074561293,
            0.66904654355728921 * xz * (3.0 - 7.0 * zz),
            0.47308734787878004 * (xx - yy) * (7.0 * zz - 1.0),
            1.7701307697799304 * xz * (-xx + 3.0 * yy),
            0.62583573544917614 * (xx * xx - 6.0 * xx * yy + yy * yy),
        ]
    return torch.stack(out, dim=-1)


def density(raw_sigma: torch.Tensor, cfg: NGPConfig) -> torch.Tensor:
    if cfg.density_activation == "exp":
        return torch.exp(torch.clamp(raw_sigma, -10.0, 10.0))
    return torch.nn.functional.softplus(raw_sigma)


def ngp_apply(params: Dict, points: torch.Tensor, dirs: torch.Tensor,
              cfg: NGPConfig, spec: Optional[NGPQuantSpec] = None,
              return_taps: bool = False):
    """Query the field. points (P,3) in [0,1], dirs (P,3) unit. Returns
    (sigma (P,), rgb (P,3)) — plus a dict of pre-quant linear inputs when
    return_taps=True (for activation-range calibration)."""
    if spec is None:
        spec = no_quant_spec(cfg, points.device)
    taps: Optional[Dict] = {} if return_taps else None

    enc = hash_encode(params["hash"], points, cfg.hash,
                      level_bits=spec.hash_bits, paper_exact=spec.paper_exact)
    h = torch.relu(_qlinear(params["sigma/0"], enc, 0, spec, taps, "sigma/0"))
    h = _qlinear(params["sigma/1"], h, 1, spec, taps, "sigma/1")
    raw_sigma, geo = h[..., 0], h[..., 1:]
    sigma = density(raw_sigma, cfg)

    c = torch.cat([geo, sh_encode(dirs, cfg.sh_degree)], dim=-1)
    c = torch.relu(_qlinear(params["color/0"], c, 2, spec, taps, "color/0"))
    c = torch.relu(_qlinear(params["color/1"], c, 3, spec, taps, "color/1"))
    rgb = torch.sigmoid(
        _qlinear(params["color/2"], c, 4, spec, taps, "color/2"))
    if return_taps:
        return sigma, rgb, taps
    return sigma, rgb
