"""Plain reference of the quantized Instant-NGP render that HERO serves.

Written from the papers' equations, in plain PyTorch, to judge the frames
the port serves. It imports nothing of the port: it gets the inputs the
benchmark made (float weights, bits, activation ranges, the occupancy
grid, the rays) and works out again what the port derives from them (the
integer codes and their scales, the active samples).

- Hash encoding (Muller et al., arXiv:2201.05989, section 3): L levels of
  resolution floor(N_min * b^l), direct-indexed where (N + 1)^3 entries fit
  the table, else the spatial hash (x * 1) ^ (y * 2654435761) ^
  (z * 805459861) mod T in 32-bit unsigned arithmetic; trilinear weights
  per axis, multiplied x, y, z. The corner order and the hash follow
  `src/repro_torch/kernels/hash_encode.py` (`corner_data`); the level
  sizes `src/repro_torch/nerf/hash_encoding.py`.
- Quantization (HERO, arXiv:2510.09010, Eqs. 4-7): symmetric weights and
  hash tables on the paper's printed grid [-2^(b-1) - 1, 2^(b-1) - 1]
  with s = (max - min) / (2^b - 1), stored in a b-bit window that keeps
  the top of the range (`src/repro_torch/quant/packing.py`, `pack_codes`);
  asymmetric activations with zero point round((1 - max / r) (2^b - 1))
  (`src/repro_torch/quant/linear_quant.py`). A linear multiplies integer
  codes, exactly, then scales by s_x s_w and adds its bias.
- Field (`src/repro_torch/nerf/ngp.py`): encoding -> 64 -> 1 + 15 (density
  exp(clamp(., -10, 10)) and geometry feature), [feature, SH degree 4] ->
  64 -> 64 -> 3 (sigmoid). The SH constants are copied from there.
- Render (`src/repro_torch/nerf/occupancy.py`, `kernels/ray_march.py`,
  `kernels/gather_composite.py`): S depths linspace(near, far) in float32,
  points o + d t (a product, then a sum), active where strictly inside
  (-0.5, 0.5)^3 and in an occupied grid cell; alpha = 1 - exp(-sigma
  delta), delta the depth steps and 1e10 last; colour = sum T alpha rgb
  plus the white background 1 - sum T alpha.

`dtype` sets the precision of the float arithmetic: float32 is the
reference; bfloat16 is the control that a comparison has to fail (the
integer products stay exact in both).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF
LINEARS = ("sigma/0", "sigma/1", "color/0", "color/1", "color/2")


def matmul_precision_f32() -> None:
    """Matrix products in full float32 on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------
def level_resolutions(hash_cfg: Dict) -> List[int]:
    L = hash_cfg["n_levels"]
    lo, hi = hash_cfg["base_resolution"], hash_cfg["max_resolution"]
    b = 1.0 if L == 1 else float(np.exp((np.log(hi) - np.log(lo)) / (L - 1)))
    return [int(np.floor(lo * b ** l)) for l in range(L)]


def level_entries(hash_cfg: Dict) -> List[int]:
    T = 1 << hash_cfg["log2_table_size"]
    return [min((r + 1) ** 3, T) for r in level_resolutions(hash_cfg)]


def linear_dims(cfg: Dict) -> Dict[str, Tuple[int, int]]:
    h = cfg["hash"]
    enc = h["n_levels"] * h["n_features"]
    sh = (cfg["sh_degree"] + 1) ** 2
    return {"sigma/0": (enc, cfg["hidden_dim"]),
            "sigma/1": (cfg["hidden_dim"], 1 + cfg["geo_feat_dim"]),
            "color/0": (cfg["geo_feat_dim"] + sh, cfg["color_hidden_dim"]),
            "color/1": (cfg["color_hidden_dim"], cfg["color_hidden_dim"]),
            "color/2": (cfg["color_hidden_dim"], 3)}


# ---------------------------------------------------------------------------
# Quantization grids (Eqs. 4-7)
# ---------------------------------------------------------------------------
def weight_codes(t: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(integer codes as float32, scale): the paper's symmetric grid, then
    the b-bit window that keeps the top of the range exact."""
    r = torch.clamp_min(t.max() - t.min(), 1e-8)
    scale = r / float(2 ** bits - 1)
    half = 2.0 ** (bits - 1)
    q = torch.clamp(torch.round(t / scale), -half - 1.0, half - 1.0)
    lo = max(float(q.min()), float(q.max()) - (2 ** bits - 1))
    q = torch.clamp(q, lo, lo + 2 ** bits - 1)
    return q, scale


def act_grid(lo: float, hi: float, bits: int, device) -> Tuple[torch.Tensor, ...]:
    """(scale, zero point, top code) of an activation range: the range is
    differenced in double precision, the rest is float32."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    r = torch.clamp_min(f32(float(hi) - float(lo)), 1e-8)
    levels = f32(2.0 ** bits - 1.0)
    scale = r / levels
    zero = torch.round((1.0 - f32(float(hi)) / r) * levels)
    return scale, zero, levels


@dataclasses.dataclass
class QuantField:
    """The field as the reference computes it: dequantized tables, integer
    weight codes with their scales, activation grids."""

    cfg: Dict
    tables: List[torch.Tensor]  # per level (entries, F), dequantized
    codes: Dict[str, torch.Tensor]  # (d_in, d_out) integer-valued
    w_scale: Dict[str, torch.Tensor]
    bias: Dict[str, torch.Tensor]
    act: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    resolutions: List[int]
    entries: List[int]


def quantize_field(weights: Dict, cfg: Dict, bits: Dict,
                   act_ranges: np.ndarray) -> QuantField:
    """`weights`: {"hash": [per-level (entries, F) f32], name: {"w", "b"}};
    `bits`: {"hash_level", "weight", "activation"}; `act_ranges`: (5, 2)
    float32 (lo, hi) of each linear's input."""
    dev = weights["sigma/0"]["w"].device
    tables = []
    for t in weights["hash"]:
        q, s = weight_codes(t.float(), bits["hash_level"])
        tables.append(q * s)
    codes, w_scale, bias, act = {}, {}, {}, {}
    for i, name in enumerate(LINEARS):
        q, s = weight_codes(weights[name]["w"].float(), bits["weight"])
        codes[name], w_scale[name] = q, s
        bias[name] = weights[name]["b"].float()
        act[name] = act_grid(act_ranges[i, 0], act_ranges[i, 1],
                             bits["activation"], dev)
    return QuantField(cfg=cfg, tables=tables, codes=codes, w_scale=w_scale,
                      bias=bias, act=act,
                      resolutions=level_resolutions(cfg["hash"]),
                      entries=level_entries(cfg["hash"]))


# ---------------------------------------------------------------------------
# Field
# ---------------------------------------------------------------------------
def corners(points: torch.Tensor, res: int, entries: int, direct: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx (P, 8) int64, w (P, 8) f32) of one level: corner c takes the
    offsets (c & 1, c >> 1 & 1, c >> 2 & 1)."""
    x = points * res
    x0f = torch.floor(x)
    frac = x - x0f
    x0 = torch.clamp(x0f.to(torch.int64), 0, res)
    off = torch.tensor([[(c >> d) & 1 for d in range(3)] for c in range(8)],
                       device=points.device)
    xc = torch.clamp(x0[:, None, :] + off[None], 0, res)
    if direct:
        s = res + 1
        idx = (xc[..., 0] + xc[..., 1] * s + xc[..., 2] * s * s) & U32
    else:
        h = ((xc[..., 0] * PRIMES[0]) & U32) ^ ((xc[..., 1] * PRIMES[1]) & U32) \
            ^ ((xc[..., 2] * PRIMES[2]) & U32)
        idx = h % entries
    c = off.to(torch.float32)[None]
    f = frac[:, None, :]
    t = c * f + (1.0 - c) * (1.0 - f)
    return idx, t[..., 0] * t[..., 1] * t[..., 2]


def encode(qf: QuantField, points: torch.Tensor, dtype) -> torch.Tensor:
    """(P, L * F) features, level-major."""
    T = 1 << qf.cfg["hash"]["log2_table_size"]
    feats = []
    for res, n, table in zip(qf.resolutions, qf.entries, qf.tables):
        idx, w = corners(points, res, n, (res + 1) ** 3 <= T)
        vals = table.to(dtype)[idx]  # (P, 8, F)
        feats.append((vals * w.to(dtype)[..., None]).sum(dim=1))
    return torch.cat(feats, dim=-1)


def sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """Real spherical harmonics up to `degree` <= 4 (Instant-NGP's)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 1:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree >= 2:
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz,
                0.94617469575755997 * zz - 0.31539156525251999,
                -1.0925484305920792 * xz, 0.54627421529603959 * (xx - yy)]
    if degree >= 3:
        out += [0.59004358992664352 * y * (-3.0 * xx + yy),
                2.8906114426405538 * x * y * z,
                0.45704579946446572 * y * (1.0 - 5.0 * zz),
                0.3731763325901154 * z * (5.0 * zz - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * zz),
                1.4453057213202769 * z * (xx - yy),
                0.59004358992664352 * x * (-xx + 3.0 * yy)]
    if degree >= 4:
        out += [2.5033429417967046 * xy * (xx - yy),
                1.7701307697799304 * yz * (-3.0 * xx + yy),
                0.94617469575756008 * xy * (7.0 * zz - 1.0),
                0.66904654355728921 * yz * (3.0 - 7.0 * zz),
                -3.1735664074561294 * zz + 3.7024941420321507 * zz * zz
                + 0.31735664074561293,
                0.66904654355728921 * xz * (3.0 - 7.0 * zz),
                0.47308734787878004 * (xx - yy) * (7.0 * zz - 1.0),
                1.7701307697799304 * xz * (-xx + 3.0 * yy),
                0.62583573544917614 * (xx * xx - 6.0 * xx * yy + yy * yy)]
    return torch.stack(out, dim=-1)


def qlinear(qf: QuantField, name: str, x: torch.Tensor, dtype) -> torch.Tensor:
    """Integer product of the input's and the weight's codes (exact in
    float32: every partial sum is an integer below 2^24), scaled, plus
    the bias."""
    sx, zx, top = (v.to(dtype) for v in qf.act[name])
    codes = torch.clamp(torch.round(x.to(dtype) / sx + zx), 0.0, top)
    acc = (codes.float() - zx.float()) @ qf.codes[name]
    return acc.to(dtype) * sx * qf.w_scale[name].to(dtype) \
        + qf.bias[name].to(dtype)


def field(qf: QuantField, points: torch.Tensor, dirs: torch.Tensor, dtype
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma (P,), rgb (P, 3)) of points in [0, 1]^3."""
    h = torch.relu(qlinear(qf, "sigma/0", encode(qf, points, dtype), dtype))
    h = qlinear(qf, "sigma/1", h, dtype)
    sigma = torch.exp(torch.clamp(h[:, 0], -10.0, 10.0))
    c = torch.cat([h[:, 1:], sh_basis(dirs.to(dtype), qf.cfg["sh_degree"])],
                  dim=-1)
    c = torch.relu(qlinear(qf, "color/0", c, dtype))
    c = torch.relu(qlinear(qf, "color/1", c, dtype))
    return sigma, torch.sigmoid(qlinear(qf, "color/2", c, dtype))


# ---------------------------------------------------------------------------
# Render
# ---------------------------------------------------------------------------
def depths(render: Dict, device) -> torch.Tensor:
    return torch.from_numpy(np.linspace(render["near"], render["far"],
                                        render["n_samples"],
                                        dtype=np.float32)).to(device)


def active_samples(grid: torch.Tensor, ro: torch.Tensor, rd: torch.Tensor,
                   t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(active (R, S) bool, points (R, S, 3) world)."""
    G = grid.shape[0]
    pts = ro[:, None, :] + rd[:, None, :] * t[None, :, None]
    inside = ((pts > -0.5) & (pts < 0.5)).all(dim=-1)
    cell = torch.clamp((torch.clamp(pts + 0.5, 0.0, 1.0) * G)
                       .to(torch.int64), 0, G - 1)
    occ = grid[cell[..., 0], cell[..., 1], cell[..., 2]] > 0.5
    return inside & occ, pts


@torch.no_grad()
def render_rays(qf: QuantField, grid: torch.Tensor, ro: torch.Tensor,
                rd: torch.Tensor, render: Dict, dtype=torch.float32,
                chunk: int = 65536) -> torch.Tensor:
    """(R, 3) float32 colours of rays (R, 3) on the device of `grid`."""
    t = depths(render, grid.device)
    delta = torch.cat([t[1:] - t[:-1], torch.full((1,), 1e10,
                                                  device=t.device)])
    out = []
    for s in range(0, ro.shape[0], chunk):
        o, d = ro[s:s + chunk], rd[s:s + chunk]
        active, pts = active_samples(grid, o, d, t)
        sigma = torch.zeros(active.shape, dtype=dtype, device=o.device)
        rgb = torch.zeros(active.shape + (3,), dtype=dtype, device=o.device)
        if bool(active.any()):
            p = torch.clamp(pts[active] + 0.5, 0.0, 1.0)
            dirs = d[:, None, :].expand(pts.shape)[active]
            sg, cl = field(qf, p, dirs, dtype)
            sigma[active], rgb[active] = sg, cl
        alpha = 1.0 - torch.exp(-sigma * delta.to(dtype)[None])
        trans = torch.cumprod(1.0 - alpha, dim=1)
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], 1)
        w = trans * alpha
        color = (w[..., None] * rgb).sum(dim=1)
        acc = w.sum(dim=1, keepdim=True)
        if render["white_bg"]:
            color = color + (1.0 - acc)
        out.append(color.float())
    return torch.cat(out)


@torch.no_grad()
def float_taps(weights: Dict, cfg: Dict, points: torch.Tensor,
               dirs: torch.Tensor) -> np.ndarray:
    """(5, 2) float32 (min, max) of each linear's input in the unquantized
    float32 field at `points`: the activation ranges the benchmark
    calibrates."""
    res, n = level_resolutions(cfg["hash"]), level_entries(cfg["hash"])
    T = 1 << cfg["hash"]["log2_table_size"]
    feats = []
    for l, table in enumerate(weights["hash"]):
        idx, w = corners(points, res[l], n[l], (res[l] + 1) ** 3 <= T)
        feats.append((table[idx] * w[..., None]).sum(dim=1))
    taps = [torch.cat(feats, dim=-1)]
    h = torch.relu(taps[0] @ weights["sigma/0"]["w"] + weights["sigma/0"]["b"])
    taps.append(h)
    h = h @ weights["sigma/1"]["w"] + weights["sigma/1"]["b"]
    c = torch.cat([h[:, 1:], sh_basis(dirs, cfg["sh_degree"])], dim=-1)
    taps.append(c)
    c = torch.relu(c @ weights["color/0"]["w"] + weights["color/0"]["b"])
    taps.append(c)
    c = torch.relu(c @ weights["color/1"]["w"] + weights["color/1"]["b"])
    taps.append(c)
    return np.array([[float(x.min()), float(x.max())] for x in taps],
                    dtype=np.float32)


def pixel_errors(served: np.ndarray, ref: np.ndarray) -> Tuple[float, float]:
    """(largest, mean) absolute difference of two (N, 3) colour arrays."""
    d = np.abs(np.asarray(served, np.float64) - np.asarray(ref, np.float64))
    return float(d.max()), float(d.mean())
