"""Fused quantized render engine: occupancy-culled, kernel-backed inference.

The serving subset of the JAX package's `nerf/fast_render.py`:

1. **Empty-space culling.** Sample points outside the scene box or in
   unoccupied grid cells are compacted away before the field query. The
   active mask comes from the occupancy ray-march kernel
   (`compaction="march"`, the default) or from the inline
   `occupancy_lookup` (`"scatter"`, the legacy cumsum + scatter strategy).
   Both give byte-identical colors. The per-chunk sample budget is static;
   the engine grows it before it could overflow.
2. **Real integer inference** (`mode="fused"`): a `FusedPack` holds
   sub-byte packed weight codes per linear layer and packed integer
   hash-table codes (`repro_torch.quant.packing.PackedTensor`). Activations
   are quantized to integer codes on the fly and the NGP linears run
   through `kernels.ops.quant_matmul_packed`, the hash encode (to the
   first linear's codes) through `kernels.ops.fused_field_query_points`
   from sample points or `kernels.ops.fused_field_query` from a plan
   row's baked corners, and the gathers from the compacted buffer, the
   compositing and the white background through
   `kernels.ops.gather_composite`. The `int` mode is
   the integer path everywhere: the CUDA kernels on the card, their exact
   plain versions on the CPU. There is no float carrier.
   `mode="reference"` queries the fake-quant `ngp_apply` oracle inside
   the same culled pipeline.
3. **Cull plans** (`CullPlan`, `build_cull_plan`): for FIXED rays the
   compaction and the geometry-only field work (hash corners, SH basis)
   are baked on the host once; a plan row replaces the march and the
   compaction. The serve engine's pose cache (`nerf/pose_cache.py`) keeps
   such rows per pose cell: `slot_plan` (hit), `slot_warp` (a nearby
   pose's conservative compaction) and `slot_march` (miss) are its three
   tiers, and give the same bits for the same rays.

The one-LSB clamp edge: the paper-exact symmetric grid (Eq. 5) spans
2^b + 1 levels, one more than a b-bit payload holds; `pack_codes` keeps
the top of the range exact, so only a tensor using the full span clamps
its lowest level up by one LSB. The stored payload is the truth the
kernels and any loaded artifact share bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.hash_encode import KERNEL_FEATURES
from repro_torch.kernels.backend import (
    DeviceLike,
    check_device,
    resolve_device,
)
from repro_torch.kernels.repack import DEFAULT_TILE_BK, repack_tile_native
from repro_torch.nerf.hash_encoding import (
    level_corner_data,
    level_meta,
    level_rows,
)
from repro_torch.nerf.ngp import (
    NGPConfig,
    NGPQuantSpec,
    density,
    ngp_apply,
    ngp_linear_names,
    no_quant_spec,
    sh_encode,
)
from repro_torch.nerf.occupancy import (
    OccupancyGrid,
    cull_budget,
    occupancy_lookup,
    ray_t_samples,
    sample_active_mask,
)
from repro_torch.quant.linear_quant import (
    activation_qparams,
    fake_quant_weight,
    quantize_weight,
    weight_qparams,
)
from repro_torch.quant.packing import PackedTensor, pack_codes


# ---------------------------------------------------------------------------
# FusedPack: host-built integer inference parameters for ONE concrete policy.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FusedPack:
    """Per-layer packed integer codes + scales, and packed hash tables.

    `modes[i]` selects the lowering of linear layer i:
      "int"        — packed weight codes + on-the-fly activation codes
                     through `quant_matmul_packed`;
      "float_qact" — f32 matmul, activations fake-quantized on the fly
                     (activation bits in the 9..15 band);
      "float"      — f32 matmul, activations untouched (>= 16 sentinel).

    Weight storage depends only on the weight bits: `wq` (a sub-byte
    `PackedTensor`) for bits <= 8, a fake-quantized f32 `w` for 9..15, the
    raw f32 `w` at >= 16. Hash tables likewise. `layers` / `hash_tables`
    are the storage truth (planar words: what the artifact serializes);
    `compute` holds the derived forms staged once by `repack_fused_pack`
    (tile-native words per layer, the concatenated dequantized hash table,
    f32 weight carriers for the float modes).
    """

    layers: Dict[str, Dict]
    hash_tables: Dict
    modes: Tuple[str, ...]
    layout: str = "planar"
    compute: Dict = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return next(iter(self.layers.values()))["b"].device


def _pack_weight(w: torch.Tensor, bits: float,
                 paper_exact: bool) -> PackedTensor:
    """Quantize one weight/table tensor and bit-pack its codes (b <= 8)
    with the top-exact window (module docstring)."""
    qp = weight_qparams(w.min(), w.max(), bits, paper_exact=paper_exact)
    return pack_codes(quantize_weight(w, qp), int(round(bits)),
                      scale=qp.scale)


def build_fused_pack(params: Dict, cfg: NGPConfig,
                     spec: Optional[NGPQuantSpec] = None,
                     layout: str = f"tile:{DEFAULT_TILE_BK}") -> FusedPack:
    """Lower a (params, spec) pair to packed integer inference form, on
    the device of `params`. `layout` selects the staged compute form
    (`repack_fused_pack`): the default tile-native repack, or "planar"
    for the bare storage pack."""
    dev = params["sigma/0"]["w"].device
    if spec is None:
        spec = no_quant_spec(cfg, dev)
    wb = spec.weight_bits.cpu().numpy()
    ab = spec.act_bits.cpu().numpy()
    ar = spec.act_ranges.cpu().numpy()
    hb = spec.hash_bits.cpu().numpy()
    pe = spec.paper_exact

    layers: Dict[str, Dict] = {}
    modes = []
    for i, name in enumerate(ngp_linear_names(cfg)):
        w, b = params[name]["w"], params[name]["b"]
        wbi, abi = float(wb[i]), float(ab[i])
        lo, hi = float(ar[i, 0]), float(ar[i, 1])

        if wbi <= 8.0:
            store = dict(wq=_pack_weight(w, wbi, pe))
        elif wbi < 16.0:
            qp_w = weight_qparams(w.min(), w.max(), wbi, paper_exact=pe)
            store = dict(w=fake_quant_weight(w, qp_w))
        else:
            store = dict(w=w)

        if abi < 16.0:
            # The activation range is two host floats, differenced in
            # double precision before the f32 cast (as the reference).
            qp_a = activation_qparams(lo, hi, abi)
            act = dict(sx=qp_a.scale.to(dev), zx_f=qp_a.zero_point.to(dev),
                       qmax=qp_a.q_max.to(dev))
        if wbi <= 8.0 and abi <= 8.0:
            off = 2.0 ** (abi - 1.0)  # shift codes [0, 2^b-1] into int8
            layers[name] = dict(
                store, b=b, **act,
                zx=(qp_a.zero_point - off).to(torch.int32).to(dev),
                off=torch.tensor(off, dtype=torch.float32, device=dev),
            )
            modes.append("int")
        elif abi < 16.0:
            layers[name] = dict(store, b=b, **act)
            modes.append("float_qact")
        else:
            layers[name] = dict(store, b=b)
            modes.append("float")

    tables: Dict = {}
    for l in range(cfg.hash.n_levels):
        t = params["hash"][f"level_{l}"]
        bits = float(hb[l])
        if bits <= 8.0:
            tables[f"level_{l}"] = _pack_weight(t, bits, pe)
        elif bits < 16.0:
            qp = weight_qparams(t.min(), t.max(), bits, paper_exact=pe)
            tables[f"level_{l}"] = fake_quant_weight(t, qp)
        else:
            tables[f"level_{l}"] = t
    pack = FusedPack(layers=layers, hash_tables=tables, modes=tuple(modes))
    return repack_fused_pack(pack, layout) if layout != "planar" else pack


def repack_fused_pack(pack: FusedPack,
                      layout: str = f"tile:{DEFAULT_TILE_BK}") -> FusedPack:
    """Stage the compute-layout forms next to the storage pack (once, at
    artifact load or pack build):

      "table_cat"       (sum_l T_l, F) f32 — every level table dequantized
                        and stacked row-wise, so the encode is ONE gather;
      "table_off"       (L,) int32 — each level's row offset in the cat;
      "<name>::wq_tile" tile-native `PackedTensor` per packed layer;
      "<name>::w_f32"   dequantized f32 weight per packed layer (the
                        float modes' operand).
    """
    if layout == "planar":
        return dataclasses.replace(pack, layout=layout, compute={})
    bk = int(layout.split(":", 1)[1])
    compute: Dict = {}
    tabs, offs, row = [], [], 0
    for l in range(len(pack.hash_tables)):
        t = pack.hash_tables[f"level_{l}"]
        t = t.dequantize() if isinstance(t, PackedTensor) else t
        tabs.append(t)
        offs.append(row)
        row += t.shape[0]
    compute["table_cat"] = torch.cat(tabs, dim=0).contiguous()
    compute["table_off"] = torch.tensor(offs, dtype=torch.int32,
                                        device=pack.device)
    for name, lyr in pack.layers.items():
        if "wq" in lyr:
            compute[f"{name}::wq_tile"] = repack_tile_native(lyr["wq"], bk)
            compute[f"{name}::w_f32"] = lyr["wq"].dequantize()
    return dataclasses.replace(pack, layout=layout, compute=compute)


def fused_pack_stored_bytes(pack: FusedPack) -> int:
    """Exact bytes of the pack's quantized model payload: packed words or
    f32 carrier per linear layer, plus every hash table — the quantity
    `policy_model_bytes` predicts from the bit vectors."""
    total = 0
    for lyr in pack.layers.values():
        total += lyr["wq"].nbytes_packed if "wq" in lyr \
            else int(lyr["w"].numel()) * 4
    for tab in pack.hash_tables.values():
        total += tab.nbytes_packed if isinstance(tab, PackedTensor) \
            else int(tab.numel()) * 4
    return total


def _layer_wq(pack: FusedPack, name: str) -> PackedTensor:
    """The kernel-facing packed weight: the staged tile-native repack when
    present, the storage-planar words otherwise."""
    return pack.compute.get(f"{name}::wq_tile", pack.layers[name]["wq"])


def _fused_weight_f32(pack: FusedPack, name: str) -> torch.Tensor:
    lyr = pack.layers[name]
    if "wq" in lyr:
        staged = pack.compute.get(f"{name}::w_f32")
        return lyr["wq"].dequantize() if staged is None else staged
    return lyr["w"]


def _fused_linear(pack: FusedPack, i: int, name: str,
                  x: torch.Tensor) -> torch.Tensor:
    lyr = pack.layers[name]
    mode = pack.modes[i]
    if mode == "int":
        y = ops.quant_matmul_packed(ops.quantize_codes(x, lyr),
                                    _layer_wq(pack, name), lyr["sx"],
                                    lyr["wq"].scale, lyr["zx"])
        return y + lyr["b"]
    if mode == "float_qact":
        codes = torch.clamp(torch.round(x / lyr["sx"] + lyr["zx_f"]), 0.0,
                            lyr["qmax"])
        x = (codes - lyr["zx_f"]) * lyr["sx"]
    return x @ _fused_weight_f32(pack, name) + lyr["b"]


def corner_data_of(points: torch.Tensor, hash_cfg
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx (L, P, 8) int32, w (L, P, 8) f32): every level's corner data
    of `points`, on their device."""
    per_level = [level_corner_data(points, l, hash_cfg)
                 for l in range(hash_cfg.n_levels)]
    return (torch.stack([i for i, _ in per_level]),
            torch.stack([w for _, w in per_level]))


def fused_ngp_apply(pack: FusedPack, points: torch.Tensor,
                    dirs: torch.Tensor, cfg: NGPConfig, corner_data=None,
                    sh: Optional[torch.Tensor] = None):
    """Integer-mode field query, mirroring `ngp_apply`'s fake-quant
    forward. With a repacked pack whose table has F in `KERNEL_FEATURES`
    features a level, the encode runs in one kernel over the staged
    concatenated table, and in `int` mode straight to the first linear's
    codes: from the points (`ops.fused_field_query_points`), or from
    precomputed `corner_data` (idx (L,P,8), w (L,P,8); a plan row's baked
    corners) through `ops.fused_field_query` (the same bits). A table of
    any other width, or a storage-only pack, takes per-level gathers and
    the trilinear sum. `sh` is the precomputed direction encoding."""
    names = ngp_linear_names(cfg)
    L = cfg.hash.n_levels
    staged = ("table_cat" in pack.compute
              and pack.compute["table_cat"].shape[1] in KERNEL_FEATURES)
    if staged and corner_data is None:
        cat = pack.compute["table_cat"]
        *_, (_, _, n, off) = level_rows(cfg.hash)
        if cat.shape[0] != off + n:
            raise ValueError(f"the pack's table has {cat.shape[0]} rows, "
                             f"the hash config {off + n}")
        meta = level_meta(cfg.hash, points.device)
        if pack.modes[0] == "int":
            lyr = pack.layers[names[0]]
            h = ops.fused_field_query_points(points, cat, meta,
                                             _layer_wq(pack, names[0]),
                                             lyr) + lyr["b"]
        else:
            h = _fused_linear(pack, 0, names[0],
                              ops.hash_encode_points(points, cat, meta))
    else:
        if corner_data is None:
            corner_data = corner_data_of(points, cfg.hash)
        idx, w = corner_data
        if staged:
            cat, off = pack.compute["table_cat"], pack.compute["table_off"]
            if pack.modes[0] == "int":
                lyr = pack.layers[names[0]]
                h = ops.fused_field_query(idx, w, cat, off,
                                          _layer_wq(pack, names[0]),
                                          lyr) + lyr["b"]
            else:
                h = _fused_linear(pack, 0, names[0],
                                  ops.hash_encode(idx, w, cat, off))
        else:
            # Per-level gathers over the storage tables, dequantized
            # inside the call.
            feats = []
            for l in range(L):
                table = pack.hash_tables[f"level_{l}"]
                if isinstance(table, PackedTensor):
                    table = table.dequantize()
                vals = ops.hash_gather(idx[l].reshape(-1).contiguous(),
                                       table)
                feats.append(ops.trilinear_sum(
                    vals.reshape(idx[l].shape + (cfg.hash.n_features,)),
                    w[l]))
            h = _fused_linear(pack, 0, names[0], torch.cat(feats, dim=-1))
    h = _fused_linear(pack, 1, names[1], torch.relu(h))
    sigma = density(h[..., 0], cfg)
    if sh is None:
        sh = sh_encode(dirs, cfg.sh_degree)
    c = torch.cat([h[..., 1:], sh], dim=-1)
    c = torch.relu(_fused_linear(pack, 2, names[2], c))
    c = torch.relu(_fused_linear(pack, 3, names[3], c))
    rgb = torch.sigmoid(_fused_linear(pack, 4, names[4], c))
    return sigma, rgb


# ---------------------------------------------------------------------------
# CullPlan: host-precomputed compaction for FIXED rays.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CullPlan:
    """Per-chunk precomputed compaction of active samples.

    For C chunks of R rays x S samples (P = R*S flattened samples):
      buf_pts  (C, B, 3) f32 — the active sample points, compacted, in
                               [0,1]^3 (deterministic eval sampling is
                               policy- and params-independent, so the
                               culled field-query INPUTS are fixed too);
      buf_dirs (C, B, 3) f32 — matching ray directions;
      take     (C, P) int32  — buffer slot holding sample k's result;
      valid    (C, P) bool   — sample k survives culling.
    B is EXACT (max active count over chunks, 128-aligned): the active
    mask depends only on ray geometry and the frozen occupancy grid.

    The geometry-static field work is baked too, so the fused hot path
    starts at the table gathers / MLP matmuls:
      hash_idx (C, L, B, 8) int32 — per-level voxel-corner table rows;
      hash_w   (C, L, B, 8) f32   — matching trilinear weights;
      sh       (C, B, sh_dim) f32 — spherical-harmonic view basis.
    """

    buf_pts: torch.Tensor
    buf_dirs: torch.Tensor
    take: torch.Tensor
    valid: torch.Tensor
    hash_idx: torch.Tensor
    hash_w: torch.Tensor
    sh: torch.Tensor

    @property
    def budget(self) -> int:
        return self.buf_pts.shape[-2]

    def row(self, c: int) -> Tuple[torch.Tensor, ...]:
        """Chunk `c` in `_chunk_color`'s `plan_row` layout."""
        return (self.buf_pts[c], self.buf_dirs[c], self.take[c],
                self.valid[c], self.hash_idx[c], self.hash_w[c], self.sh[c])


def bake_field_inputs(buf_pts: np.ndarray, buf_dirs: np.ndarray,
                      cfg: NGPConfig, device: torch.device):
    """(pts, dirs, hash_idx (L,B,8) int32, hash_w (L,B,8) f32, sh (B,
    sh_dim) f32) on `device`: fixed sample points and directions with the
    geometry-only field work a plan bakes, computed there by the same
    corner math and SH basis the renderer runs."""
    pts = torch.from_numpy(np.ascontiguousarray(buf_pts)).to(device)
    dirs = torch.from_numpy(np.ascontiguousarray(buf_dirs)).to(device)
    idx, w = corner_data_of(pts, cfg.hash)
    return pts, dirs, idx, w, sh_encode(dirs, cfg.sh_degree)


def build_cull_plan(occ: OccupancyGrid, ro_chunks: np.ndarray,
                    rd_chunks: np.ndarray, ray_mask: Optional[np.ndarray],
                    rcfg, cfg: NGPConfig, align: int = 128) -> CullPlan:
    """Precompute the compaction for a fixed, chunked ray population:
    (C, R, 3) rays (padded rows allowed), `ray_mask` (C, R, 1) 1.0 = a
    real ray (or None). Baked on the occupancy grid's device."""
    ro = np.asarray(ro_chunks, np.float32)
    rd = np.asarray(rd_chunks, np.float32)
    C, R = ro.shape[:2]
    S = rcfg.n_samples
    # Shared oracle with `cull_budget` — the counts must match exactly.
    active, pts = sample_active_mask(occ, ro, rd, rcfg)  # (C, R, S)
    if ray_mask is not None:
        active &= np.asarray(ray_mask).reshape(C, R, 1) > 0.5
    active = active.reshape(C, R * S)
    counts = active.sum(axis=1)
    B = max(align, int(np.ceil(counts.max() / align) * align))
    B = min(B, R * S)
    pts_unit = np.clip(pts + 0.5, 0.0, 1.0).reshape(C, R * S, 3)
    dirs_flat = np.broadcast_to(rd[:, :, None, :], pts.shape) \
        .reshape(C, R * S, 3)
    buf_pts = np.zeros((C, B, 3), np.float32)
    buf_dirs = np.zeros((C, B, 3), np.float32)
    take = np.zeros((C, R * S), np.int32)
    valid = np.zeros((C, R * S), bool)
    for c in range(C):
        idx = np.nonzero(active[c])[0]
        buf_pts[c, :idx.size] = pts_unit[c, idx]
        buf_dirs[c, :idx.size] = dirs_flat[c, idx]
        take[c, idx] = np.arange(idx.size, dtype=np.int32)
        valid[c, idx] = True
    dev = occ.occ.device
    baked = [bake_field_inputs(buf_pts[c], buf_dirs[c], cfg, dev)
             for c in range(C)]
    stack = [torch.stack([b[i] for b in baked]) for i in range(5)]
    return CullPlan(buf_pts=stack[0], buf_dirs=stack[1],
                    take=torch.from_numpy(take).to(dev),
                    valid=torch.from_numpy(valid).to(dev),
                    hash_idx=stack[2], hash_w=stack[3], sh=stack[4])


# ---------------------------------------------------------------------------
# Occupancy-culled ray rendering (one chunk).
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _t_samples_on(device: torch.device,
                  rcfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t (S,), delta (S,)) on `device`, made there once per (device,
    render config): t is the host linspace the budget oracle uses
    (`ray_t_samples`), not torch.linspace, since the sample points must be
    bit-identical on both sides; delta its differences, the last 1e10.
    A copy from host memory per chunk would stall the card's stream."""
    t = torch.from_numpy(ray_t_samples(rcfg)).to(device)
    return t, torch.cat([torch.diff(t),
                         torch.full((1,), 1e10, device=device)])


def _sample_points(rays_o: torch.Tensor, rays_d: torch.Tensor,
                   t1: torch.Tensor):
    """(pts (R, S, 3) world, flat_pts (R*S, 3) in [0,1], flat_dirs
    (R*S, 3)): the deterministic sample points, as the host oracle
    computes them (a product, then a sum, each rounded)."""
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t1[None, :, None]
    flat_pts = torch.clamp(pts + 0.5, 0.0, 1.0).reshape(-1, 3)
    flat_dirs = rays_d[:, None, :].expand(pts.shape).reshape(-1, 3)
    return pts, flat_pts, flat_dirs


def _field(params, pack, spec, cfg, mode: str, p, d, corner_data=None,
           sh=None):
    if mode == "fused":
        return fused_ngp_apply(pack, p, d, cfg, corner_data=corner_data,
                               sh=sh)
    return ngp_apply(params, p, d, cfg, spec)


def _composite(sigma_b, rgb_b, take, valid, delta1, rcfg, early_stop,
               active=None):
    """The one fused step every tier ends in: compacted field outputs to
    the served colour (`ops.gather_composite`)."""
    return ops.gather_composite(sigma_b.contiguous(), rgb_b.contiguous(),
                                take, valid, delta1, rcfg.white_bg,
                                early_stop, active=active)


def _chunk_color(params, pack, spec, occ: Optional[OccupancyGrid],
                 rays_o: torch.Tensor, rays_d: torch.Tensor, cfg, rcfg,
                 mode: str, budget: Optional[int], early_stop: bool,
                 compaction: str = "march", plan_row=None):
    """Core renderer for one chunk of rays.

    Returns (color (R,3), acc (R,1), n_active) where n_active is the
    device count of active samples (None without a grid or with a plan
    row) — from the SAME mask the colors used, so the caller detects a
    budget overflow without marching again. Budget overflow drops the
    samples ranked past B. `plan_row` (a `CullPlan.row` layout) replaces
    the march and the compaction with precomputed gathers.
    """
    dev = rays_o.device
    n_rays, n_s = rays_o.shape[0], rcfg.n_samples
    t1, delta1 = _t_samples_on(dev, rcfg)

    def field(p, d, corner_data=None, sh=None):
        return _field(params, pack, spec, cfg, mode, p, d, corner_data, sh)

    if plan_row is not None:
        # Precomputed compaction: the culled field-query inputs and their
        # hash-corner / SH bases are staged in the plan.
        buf_pts, buf_dirs, take, valid, hash_idx, hash_w, sh = plan_row
        sigma_b, rgb_b = field(buf_pts, buf_dirs, (hash_idx, hash_w), sh)
        color, acc = _composite(sigma_b, rgb_b, take, valid, delta1, rcfg,
                                early_stop)
        return color, acc, None

    pts, flat_pts, flat_dirs = _sample_points(rays_o, rays_d, t1)
    inside = ((pts > -0.5) & (pts < 0.5)).all(dim=-1)  # (R, S)
    P = n_rays * n_s
    n_active = None
    if occ is None:
        sigma_b, rgb_b = field(flat_pts, flat_dirs)
        take = torch.arange(P, device=dev)
        valid = inside.reshape(-1)
    else:
        if compaction == "scatter":
            active = inside.reshape(-1) & occupancy_lookup(occ, flat_pts)
        else:
            active = ops.ray_march(occ.occ, rays_o.contiguous(),
                                   rays_d.contiguous(), t1,
                                   early_stop).reshape(-1) > 0.5
        n_active = active.sum()
        B = P if budget is None else min(int(budget), P)
        rank = torch.cumsum(active, dim=0) - 1
        valid = active & (rank < B)
        pos = torch.where(valid, rank, B)  # B = the dropped overflow slot
        if compaction == "march":
            # Gather compaction: a scatter of arange at rank gives the
            # active flat indices in increasing order (fill 0), with no
            # host sync — the same buffers the scatter strategy writes.
            inv_take = torch.zeros(B + 1, dtype=torch.int64, device=dev)
            inv_take.scatter_(0, pos, torch.arange(P, device=dev))
            buf_pts = flat_pts[inv_take[:B]]
            buf_dirs = flat_dirs[inv_take[:B]]
        else:
            buf_pts = torch.zeros((B + 1, 3), device=dev)
            buf_dirs = torch.zeros((B + 1, 3), device=dev)
            buf_pts[pos] = flat_pts
            buf_dirs[pos] = flat_dirs
            buf_pts, buf_dirs = buf_pts[:B], buf_dirs[:B]
        sigma_b, rgb_b = field(buf_pts, buf_dirs)
        take = rank  # read only where valid, so within [0, B)
    color, acc = _composite(sigma_b, rgb_b, take, valid, delta1, rcfg,
                            early_stop)
    return color, acc, n_active


def fast_render_rays(params: Dict, rays_o: torch.Tensor,
                     rays_d: torch.Tensor, cfg: NGPConfig, rcfg,
                     spec: Optional[NGPQuantSpec] = None,
                     occ: Optional[OccupancyGrid] = None,
                     mode: str = "reference",
                     pack: Optional[FusedPack] = None,
                     budget: Optional[int] = None, early_stop: bool = True,
                     compaction: str = "march",
                     plan: Optional[CullPlan] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Occupancy-culled render of one ray batch -> (color (R,3), acc (R,1)).
    `mode="fused"` builds the pack from (params, spec) when none is
    given. Sampling is the deterministic `ray_t_samples`. A single-chunk
    `plan` (`build_cull_plan`) replaces the on-device compaction with its
    precomputed gathers."""
    assert mode in ("reference", "fused"), mode
    if mode == "fused" and pack is None:
        pack = build_fused_pack(params, cfg, spec)
    plan_row = None
    if plan is not None:
        assert plan.buf_pts.shape[0] == 1, \
            "fast_render_rays takes a 1-chunk plan"
        plan_row = plan.row(0)
    color, acc, _ = _chunk_color(params, pack, spec, occ, rays_o, rays_d,
                                 cfg, rcfg, mode, budget, early_stop,
                                 compaction, plan_row)
    return color, acc


# ---------------------------------------------------------------------------
# Frame and slot paths (counterparts of `_frame_colors_impl` and the
# three serve tiers `_slot_march_impl`, `_slot_plan_impl`,
# `_slot_warp_impl`). A bucket mixes tiers slot by slot at the same padded
# shape; each tier ends in the same `ops.gather_composite`, so the same
# rays give the same bits in every tier.
# ---------------------------------------------------------------------------
def frame_colors(params, pack, spec, occ, rays_o: torch.Tensor,
                 rays_d: torch.Tensor, cfg, rcfg, mode: str,
                 budget: Optional[int], early_stop: bool,
                 compaction: str = "march") -> torch.Tensor:
    """(C, R, 3) colors of C padded ray chunks, one chunk at a time under
    the per-chunk `budget`."""
    return torch.stack([
        _chunk_color(params, pack, spec, occ, rays_o[c], rays_d[c], cfg,
                     rcfg, mode, budget, early_stop, compaction)[0]
        for c in range(rays_o.shape[0])
    ])


def slot_march(params, pack, spec, occ: OccupancyGrid,
               rays_o: torch.Tensor, rays_d: torch.Tensor, cfg, rcfg,
               mode: str, budget: Optional[int], early_stop: bool):
    """Cache-miss serve tier for one slot: march render + the device
    active count of the same march (the engine's overflow check)."""
    color, _, n_active = _chunk_color(params, pack, spec, occ, rays_o,
                                      rays_d, cfg, rcfg, mode, budget,
                                      early_stop)
    return color, n_active


def slot_plan(params, pack, spec, occ: OccupancyGrid, rays_o: torch.Tensor,
              rays_d: torch.Tensor, plan_row, cfg, rcfg, mode: str,
              early_stop: bool) -> torch.Tensor:
    """Cache-hit serve tier: the slot's rays fingerprint-match a baked
    plan row — its gathers, hash corners and SH basis; no march and no
    compaction."""
    return _chunk_color(params, pack, spec, occ, rays_o, rays_d, cfg, rcfg,
                        mode, None, early_stop, plan_row=plan_row)[0]


def slot_warp(params, pack, spec, occ: OccupancyGrid, rays_o: torch.Tensor,
              rays_d: torch.Tensor, inv_take: torch.Tensor,
              take: torch.Tensor, valid_cons: torch.Tensor, cfg, rcfg,
              mode: str, early_stop: bool) -> torch.Tensor:
    """Warped-plan serve tier: a nearby pose's CONSERVATIVE compaction
    indices for these rays. The plan contributes indices only — the field
    queries these rays' own sample points — and the final mask is
    `valid_cons` ANDed with the exact march of these rays (inside the
    composite kernel), so a plan that covers every exact-active sample
    renders what the march tier renders."""
    t1, delta1 = _t_samples_on(rays_o.device, rcfg)
    _, flat_pts, flat_dirs = _sample_points(rays_o, rays_d, t1)
    sigma_b, rgb_b = _field(params, pack, spec, cfg, mode,
                            flat_pts[inv_take], flat_dirs[inv_take])
    exact = ops.ray_march(occ.occ, rays_o.contiguous(), rays_d.contiguous(),
                          t1, early_stop)
    return _composite(sigma_b, rgb_b, take, valid_cons, delta1, rcfg,
                      early_stop, active=exact.reshape(-1))[0]


def _effective_chunk(n_rays: int, chunk: int) -> int:
    return min(chunk, -(-n_rays // 128) * 128)


def _pad_frame(chunk: int, device: torch.device, *arrays):
    """(N, k) arrays -> (each as (C, chunk, k), mask (C, chunk, 1): 1.0 on
    a real row) on `device`, zero-padded."""
    n = np.asarray(arrays[0]).reshape(-1, 3).shape[0]
    c = _effective_chunk(n, chunk)
    n_chunks = -(-n // c)
    pad = ((0, n_chunks * c - n), (0, 0))

    def _p(a):
        a = np.asarray(a, np.float32).reshape(n, -1)
        return torch.from_numpy(np.pad(a, pad)).reshape(n_chunks, c, -1) \
            .to(device)
    return tuple(_p(a) for a in arrays) + (_p(np.ones((n, 1))),)


# Device-staged held-out test sets (and their cull plans), keyed by array
# identity (and device). An episode loop evaluates the SAME views once per
# episode: staging once keeps every later evaluation free of host->device
# ray copies and plan rebuilds. Cached entries pin their source arrays so
# ids cannot be recycled; both caches are bounded (oldest out).
_TEST_STAGE_CACHE: Dict[Tuple, Tuple] = {}
_PLAN_CACHE: Dict[Tuple, Tuple] = {}
_CACHE_CAP = 8


def _cache_put(cache: Dict, key, value) -> None:
    if key not in cache and len(cache) >= _CACHE_CAP:
        cache.pop(next(iter(cache)))  # dicts iterate in insertion order
    cache[key] = value


def _stage_test_set(dataset, chunk: int, device: torch.device):
    """(ro, rd, gt (C, chunk, 3), mask (C, chunk, 1), pixel values) of the
    test views staged FLAT on `device`: views are independent rays, so a
    small test set is a single chunk."""
    key = (id(dataset.test_rays_o), chunk, device)
    hit = _TEST_STAGE_CACHE.get(key)
    if hit is not None and hit[0] is dataset.test_rays_o:
        return hit[1]
    staged = _pad_frame(chunk, device, dataset.test_rays_o.reshape(-1, 3),
                        dataset.test_rays_d.reshape(-1, 3),
                        dataset.test_rgb.reshape(-1, 3))
    staged = staged + (int(dataset.test_rgb.size),)
    _cache_put(_TEST_STAGE_CACHE, key, (dataset.test_rays_o, staged))
    return staged


def _test_set_plan(dataset, occ: OccupancyGrid, rcfg, chunk: int,
                   cfg: NGPConfig) -> CullPlan:
    """The cull plan of the staged test set, baked on the grid's device."""
    key = (id(dataset.test_rays_o), id(occ.occ), rcfg, chunk, cfg)
    hit = _PLAN_CACHE.get(key)
    if hit is not None and hit[0] is dataset.test_rays_o \
            and hit[1] is occ.occ:
        return hit[2]
    ro, rd, mask = (a.numpy() for a in _pad_frame(
        chunk, torch.device("cpu"), dataset.test_rays_o.reshape(-1, 3),
        dataset.test_rays_d.reshape(-1, 3)))
    plan = build_cull_plan(occ, ro, rd, mask, rcfg, cfg)
    _cache_put(_PLAN_CACHE, key, (dataset.test_rays_o, occ.occ, plan))
    return plan


class FastRenderEngine:
    """Bundles (params, spec, occupancy, mode) into frame calls.

    `pack=` serves a prebuilt `FusedPack` verbatim (deployable artifacts
    load their packed codes from disk); by default the pack is quantized
    from (params, spec) at construction. Runs on the card unless
    `device="cpu"`; every tensor it is given must already live there.
    """

    def __init__(self, params: Dict, cfg: NGPConfig, rcfg,
                 spec: Optional[NGPQuantSpec] = None,
                 occ: Optional[OccupancyGrid] = None, mode: str = "fused",
                 chunk: int = 4096, budget: Optional[int] = None,
                 early_stop: bool = True, pack: Optional[FusedPack] = None,
                 device: DeviceLike = None):
        assert mode in ("reference", "fused"), mode
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.rcfg = dataclasses.replace(rcfg, stratified=False)
        self.spec = no_quant_spec(cfg, self.device) if spec is None else spec
        self.occ = occ
        self.mode = mode
        self.chunk = chunk
        self.early_stop = early_stop
        if pack is None and mode == "fused":
            pack = build_fused_pack(params, cfg, self.spec)
        self.pack = pack if mode == "fused" else None
        if self.pack is not None:
            check_device(self.pack.layers[ngp_linear_names(cfg)[0]]["b"],
                         self.device, "the fused pack")
        if occ is not None:
            check_device(occ.occ, self.device, "the occupancy grid")
        self._budget = budget
        self._budget_cache: Dict[Tuple, int] = {}

    def _resolve_budget(self, rays_o, rays_d) -> Optional[int]:
        """Per-chunk sample budget: explicit > cached per ray content >
        derived from the rays (`cull_budget`, exact for them)."""
        if self.occ is None:
            return None
        if self._budget is not None:
            return self._budget
        ro = np.asarray(rays_o, np.float32).reshape(-1, 3)
        rd = np.asarray(rays_d, np.float32).reshape(-1, 3)
        key = (ro.shape[0], hash(ro.tobytes()), hash(rd.tobytes()))
        hit = self._budget_cache.get(key)
        if hit is None:
            c = _effective_chunk(ro.shape[0], self.chunk)
            hit = cull_budget(self.occ, ro, rd, self.rcfg, c)
            if len(self._budget_cache) >= 8:
                self._budget_cache.pop(next(iter(self._budget_cache)))
            self._budget_cache[key] = hit
        return hit

    def render_rays(self, rays_o, rays_d) -> torch.Tensor:
        """One-chunk render -> color (R, 3) on the engine's device."""
        budget = self._resolve_budget(rays_o, rays_d)
        ro = torch.as_tensor(np.asarray(rays_o, np.float32)).to(self.device)
        rd = torch.as_tensor(np.asarray(rays_d, np.float32)).to(self.device)
        color, _ = fast_render_rays(
            self.params, ro, rd, self.cfg, self.rcfg, self.spec, self.occ,
            self.mode, self.pack, budget, early_stop=self.early_stop,
        )
        return color

    def render_frame(self, rays_o, rays_d) -> torch.Tensor:
        """Full frame -> (N, 3) colors, chunk by chunk."""
        n = np.asarray(rays_o).reshape(-1, 3).shape[0]
        budget = self._resolve_budget(rays_o, rays_d)
        ro, rd, _ = _pad_frame(self.chunk, self.device, rays_o, rays_d)
        colors = frame_colors(
            self.params, self.pack, self.spec, self.occ, ro, rd, self.cfg,
            self.rcfg, self.mode, budget, self.early_stop,
        )
        return colors.reshape(-1, 3)[:n]

    def _frame_se(self, plan: Optional[CullPlan], ro, rd, gt, mask,
                  budget: Optional[int]) -> torch.Tensor:
        """Masked squared error over staged chunks, one device scalar: each
        chunk rendered under its plan row (with a plan) or the march under
        `budget`."""
        se = []
        for c in range(ro.shape[0]):
            color, _, _ = _chunk_color(
                self.params, self.pack, self.spec, self.occ, ro[c], rd[c],
                self.cfg, self.rcfg, self.mode, budget, self.early_stop,
                plan_row=None if plan is None else plan.row(c))
            se.append(torch.sum(((color - gt[c]) ** 2) * mask[c]))
        return torch.stack(se).sum()

    @torch.no_grad()
    def frame_se(self, rays_o, rays_d, gt,
                 budget: Optional[int] = None) -> torch.Tensor:
        """Masked squared error of a full frame: ONE device scalar."""
        if budget is None:
            budget = self._resolve_budget(rays_o, rays_d)
        ro, rd, g, m = _pad_frame(self.chunk, self.device, rays_o, rays_d,
                                  gt)
        return self._frame_se(None, ro, rd, g, m, budget)

    def test_views_budget(self, dataset) -> Optional[int]:
        """The exact per-chunk budget the staged test set renders under
        (the cull plan's B), None without an occupancy grid."""
        if self.occ is None:
            return None
        return _test_set_plan(dataset, self.occ, self.rcfg, self.chunk,
                              self.cfg).budget

    @torch.no_grad()
    def evaluate_psnr(self, dataset) -> float:
        """Mean PSNR over held-out views.

        The test set (and its cull plan) is staged on the device once; the
        squared error of every chunk is summed there and one scalar moves
        to the host. An explicit engine `budget` overrides the plan: the
        march renders under that cap instead."""
        from repro_torch.nerf.train import psnr  # train imports this module

        ro, rd, gt, mask, total_px = _stage_test_set(dataset, self.chunk,
                                                     self.device)
        plan, budget = None, None
        if self.occ is not None:
            if self._budget is not None:
                budget = self._budget
            else:
                plan = _test_set_plan(dataset, self.occ, self.rcfg,
                                      self.chunk, self.cfg)
        se = self._frame_se(plan, ro, rd, gt, mask, budget)
        return psnr(float(se) / total_px)
