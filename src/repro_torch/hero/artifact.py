"""QuantArtifact: the deployable output of a HERO search.

Bundles everything a render service needs to serve one (scene, policy):
the float parameters, the policy bits + calibration ranges (the quant spec
is re-derived on load), the packed `FusedPack` (sub-byte weight and
hash-table code words, loaded verbatim), the baked occupancy grid, and the
hardware-target metadata + metrics recorded at compile.

`save`/`load` use one directory: `arrays.npz` + `manifest.json` with
per-array sha256 and a schema version, the JAX package's schema v2 exactly:
this port reads directories the JAX package wrote, and writes directories
whose manifest sha256s equal the reference's for the same arrays. A schema
v1 directory (the pre-packing layout: int8 weight codes, f32 carriers) is
verified against its own manifest and then upgraded: the pack is rebuilt
from the verified float parameters by the same deterministic
`build_fused_pack` a v2 compile uses, and `model_bytes` re-measured from
what schema v2 stores.

`compile_artifact` lowers a searched (env, policy bits) pair to an artifact
on the env's device: the QAT finetune, the env's fused PSNR, the policy
simulated on the env's hardware target, the pack, the occupancy grid.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.kernels.repack import DEFAULT_TILE_BK, unrepack_planar
from repro_torch.nerf.fast_render import (
    FastRenderEngine,
    FusedPack,
    build_fused_pack,
    fused_pack_stored_bytes,
    repack_fused_pack,
)
from repro_torch.nerf.hash_encoding import HashEncodingConfig
from repro_torch.nerf.ngp import (
    NGPConfig,
    NGPQuantSpec,
    make_quant_units,
    spec_from_policy,
)
from repro_torch.nerf.occupancy import OccupancyGrid, bake_occupancy_cached
from repro_torch.nerf.render import RenderConfig
from repro_torch.quant.packing import PackedTensor
from repro_torch.quant.policy import QuantPolicy

SCHEMA_VERSION = 2
# npz key separator: parameter names themselves contain "/" ("sigma/0").
_SEP = "::"


@dataclasses.dataclass
class QuantArtifact:
    """Serialized deployable bundle for one (scene, policy) pair."""

    scene: str
    bits: List[int]
    cfg: NGPConfig
    rcfg: RenderConfig
    scene_cfg: Dict  # SceneConfig (as a dict) the metrics were measured on
    params: Dict  # float weights, {top: {sub: tensor}}
    act_ranges: torch.Tensor  # (n_linear, 2) calibrated activation ranges
    pack: FusedPack  # packed integer inference form
    occ: OccupancyGrid
    hardware: Dict  # hardware-target description of the search target
    metrics: Dict  # psnr / latency_cycles / model_bytes / fqr at compile
    schema_version: int = SCHEMA_VERSION

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.occ.occ.device

    def spec(self) -> NGPQuantSpec:
        """Quant spec re-derived from (bits, act_ranges)."""
        units = make_quant_units(self.cfg)
        policy = QuantPolicy.uniform(units, 8).with_bits(list(self.bits))
        return spec_from_policy(self.cfg, policy, self.act_ranges)

    def engine(self, **kw) -> FastRenderEngine:
        """Fused render engine over the LOADED pack (codes served
        verbatim), on the artifact's device."""
        kw.setdefault("mode", "fused")
        kw.setdefault("device", self.device)
        return FastRenderEngine(self.params, self.cfg, self.rcfg,
                                spec=self.spec(), occ=self.occ,
                                pack=self.pack, **kw)

    def stored_model_bytes(self) -> int:
        """Exact bytes of the quantized model payload as stored on disk."""
        return fused_pack_stored_bytes(self.pack)

    def resident_bytes(self) -> int:
        """In-memory bytes of everything the artifact keeps resident
        (float params + packed codes + staged compute forms + occupancy +
        calibration): what the serve engine's LRU cache charges."""

        def nb(v) -> int:
            if isinstance(v, PackedTensor):
                return nb(v.words) + nb(v.scale) + nb(v.offset)
            return int(v.numel() * v.element_size())

        total = nb(self.act_ranges) + nb(self.occ.occ)
        for sub in self.params.values():
            total += sum(nb(v) for v in sub.values())
        for lyr in self.pack.layers.values():
            total += sum(nb(v) for v in lyr.values())
        total += sum(nb(t) for t in self.pack.hash_tables.values())
        total += sum(nb(v) for v in self.pack.compute.values())
        return total

    def cache_key(self) -> str:
        """Cheap stable identity: (scene, hardware, policy bits)."""
        hw = (self.hardware.get("name", "?")
              if isinstance(self.hardware, dict) else str(self.hardware))
        return f"{self.scene}/{hw}/b" + "".join(str(int(b)) for b in self.bits)

    # ------------------------------------------------------------------
    # Serialization
    # ------------------------------------------------------------------
    def _arrays(self) -> Tuple[Dict[str, np.ndarray], Dict[str, Dict]]:
        """-> (flat array dict, packed-tensor metadata by prefix). A
        `PackedTensor` at key K becomes K::pt::words/scale/offset, always
        in the planar storage order."""
        def host(t) -> np.ndarray:
            return t.detach().cpu().numpy()

        out: Dict[str, np.ndarray] = {"act_ranges": host(self.act_ranges)}
        packed: Dict[str, Dict] = {}

        def emit(key, v):
            if isinstance(v, PackedTensor):
                v = unrepack_planar(v)
                out[f"{key}{_SEP}pt{_SEP}words"] = host(v.words)
                out[f"{key}{_SEP}pt{_SEP}scale"] = host(v.scale)
                out[f"{key}{_SEP}pt{_SEP}offset"] = host(v.offset)
                packed[key] = {"bits": int(v.bits),
                               "shape": [int(s) for s in v.shape],
                               "layout": "planar"}
            else:
                out[key] = host(v)

        for top, sub in self.params.items():
            for k, v in sub.items():
                out[f"params{_SEP}{top}{_SEP}{k}"] = host(v)
        for name, lyr in self.pack.layers.items():
            for k, v in lyr.items():
                emit(f"pack{_SEP}{name}{_SEP}{k}", v)
        for name, t in self.pack.hash_tables.items():
            emit(f"packtab{_SEP}{name}", t)
        out["occ"] = host(self.occ.occ)
        return out, packed

    def save(self, path) -> Path:
        """Write the bundle to directory `path` (npz first, manifest last,
        both via tmp + rename so a crash never leaves a loadable lie)."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        arrays, packed_meta = self._arrays()
        manifest = {
            "schema_version": SCHEMA_VERSION,
            "packed_tensors": packed_meta,
            "scene": self.scene,
            "bits": [int(b) for b in self.bits],
            "cfg": dataclasses.asdict(self.cfg),
            "rcfg": dataclasses.asdict(self.rcfg),
            "scene_cfg": self.scene_cfg,
            "pack_modes": list(self.pack.modes),
            "occ": {
                "resolution": self.occ.resolution,
                "threshold": self.occ.threshold,
                "occupied_fraction": self.occ.occupied_fraction,
            },
            "hardware": self.hardware,
            "metrics": self.metrics,
            "arrays": {
                k: {"shape": list(v.shape), "dtype": str(v.dtype),
                    "sha256": _sha(v)}
                for k, v in arrays.items()
            },
        }
        tmp_npz = path / "arrays.npz.tmp"
        with open(tmp_npz, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp_npz, path / "arrays.npz")
        tmp_manifest = path / "manifest.json.tmp"
        tmp_manifest.write_text(json.dumps(manifest, indent=2))
        os.replace(tmp_manifest, path / "manifest.json")
        return path

    @staticmethod
    def load(path, layout: str = f"tile:{DEFAULT_TILE_BK}",
             device: DeviceLike = None) -> "QuantArtifact":
        """Load a saved bundle onto `device` (the card unless
        `device="cpu"`). Integrity (array-set match + per-array sha256
        against the directory's own manifest) is verified before anything
        is built. `layout` picks the compute repack staged after
        verification; "planar" serves the bare storage form. A schema-v1
        bundle comes back upgraded to schema 2 (module docstring)."""
        dev = resolve_device(device)
        path = Path(path)
        manifest = json.loads((path / "manifest.json").read_text())
        version = int(manifest.get("schema_version", -1))
        if version > SCHEMA_VERSION or version < 1:
            raise ValueError(
                f"artifact {path} has schema_version={version}; this build "
                f"reads <= {SCHEMA_VERSION}"
            )
        with np.load(path / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}

        want = manifest["arrays"]
        if set(want) != set(arrays):
            raise ValueError(
                f"artifact {path}: manifest/npz array sets differ "
                f"(missing {sorted(set(want) - set(arrays))}, "
                f"unexpected {sorted(set(arrays) - set(want))})"
            )
        for k, meta in want.items():
            if _sha(arrays[k]) != meta["sha256"]:
                raise ValueError(f"artifact {path}: array {k!r} failed its "
                                 "sha256 integrity check")

        def tensor(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.array(a)).to(dev)

        cfg_d = dict(manifest["cfg"])
        cfg = NGPConfig(hash=HashEncodingConfig(**cfg_d.pop("hash")), **cfg_d)
        rcfg = RenderConfig(**manifest["rcfg"])
        packed_meta = manifest.get("packed_tensors", {})

        def take_packed(prefix: str) -> PackedTensor:
            meta = packed_meta[prefix]
            return PackedTensor(
                words=tensor(arrays[f"{prefix}{_SEP}pt{_SEP}words"]),
                scale=tensor(arrays[f"{prefix}{_SEP}pt{_SEP}scale"]),
                offset=tensor(arrays[f"{prefix}{_SEP}pt{_SEP}offset"]),
                bits=int(meta["bits"]),
                shape=tuple(int(s) for s in meta["shape"]),
                layout=str(meta.get("layout", "planar")),
            )

        params: Dict[str, Dict] = {}
        layers: Dict[str, Dict] = {}
        tables: Dict = {}
        for k, v in arrays.items():
            parts = k.split(_SEP)
            if len(parts) >= 2 and parts[-2] == "pt":
                continue  # component of a PackedTensor, handled below
            if parts[0] == "params":
                params.setdefault(parts[1], {})[parts[2]] = tensor(v)
            elif parts[0] == "pack":
                layers.setdefault(parts[1], {})[parts[2]] = tensor(v)
            elif parts[0] == "packtab":
                tables[parts[1]] = tensor(v)
        for prefix in packed_meta:
            parts = prefix.split(_SEP)
            if parts[0] == "pack":
                layers.setdefault(parts[1], {})[parts[2]] = take_packed(prefix)
            elif parts[0] == "packtab":
                tables[parts[1]] = take_packed(prefix)

        occ_meta = manifest["occ"]
        bits = [int(b) for b in manifest["bits"]]
        act_ranges = tensor(arrays["act_ranges"])
        metrics = dict(manifest["metrics"])
        if version == 1:
            # The stored pack is the legacy int8/f32 form: re-pack from
            # the verified params through the deterministic build path a
            # v2 compile uses, and re-measure what v2 stores.
            units = make_quant_units(cfg)
            policy = QuantPolicy.uniform(units, 8).with_bits(bits)
            spec = spec_from_policy(cfg, policy, act_ranges)
            pack = build_fused_pack(params, cfg, spec, layout=layout)
            metrics["model_bytes"] = float(fused_pack_stored_bytes(pack))
        else:
            pack = FusedPack(layers=layers, hash_tables=tables,
                             modes=tuple(manifest["pack_modes"]))
            if layout != "planar":
                pack = repack_fused_pack(pack, layout)
        return QuantArtifact(
            scene=manifest["scene"],
            bits=bits,
            cfg=cfg,
            rcfg=rcfg,
            scene_cfg=dict(manifest["scene_cfg"]),
            params=params,
            act_ranges=act_ranges,
            pack=pack,
            occ=OccupancyGrid(
                occ=tensor(arrays["occ"]),
                resolution=int(occ_meta["resolution"]),
                threshold=float(occ_meta["threshold"]),
                occupied_fraction=float(occ_meta["occupied_fraction"]),
            ),
            hardware=manifest["hardware"],
            metrics=metrics,
            schema_version=SCHEMA_VERSION,
        )


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Compile: (env, policy bits) -> QuantArtifact
# ---------------------------------------------------------------------------
def compile_artifact(
    env,  # NGPQuantEnv (typed loosely to avoid an import cycle)
    bits: Optional[Sequence[int]] = None,
    finetune_steps: Optional[int] = None,
) -> QuantArtifact:
    """Lower a searched policy to a deployable bundle, on the env's device.

    Runs the same QAT finetune + fused PSNR evaluation the env's episode
    path uses, simulates the policy on the env's hardware target, packs
    the finetuned weights to integer inference form, and bundles the
    occupancy grid. `bits=None` compiles the uniform 8-bit policy.
    """
    from repro_torch.nerf.train import finetune_ngp

    if bits is None:
        bits = [8] * env.n_units
    bits = [int(b) for b in bits]
    steps = env.ecfg.finetune_steps if finetune_steps is None else finetune_steps

    policy = QuantPolicy.uniform(env.units, 8).with_bits(bits)
    spec = spec_from_policy(env.cfg, policy, env.act_ranges)
    ft_params, _ = finetune_ngp(
        dict(env.params), env.dataset, env.cfg, env.rcfg, env.tcfg, spec,
        steps, device=env.device,
    )
    psnr = env.eval_psnr(ft_params, spec)
    lat = env.simulate_policy(policy)
    occ = env.occ
    if occ is None:  # reference-backend env: bake for the fused artifact
        occ = bake_occupancy_cached(
            env.params, env.cfg, resolution=env.ecfg.occ_resolution,
            threshold=env.ecfg.occ_threshold,
        )
    pack = build_fused_pack(ft_params, env.cfg, spec)
    # MEASURED payload bytes. The simulator's model_bytes goes through the
    # same shared size function (`repro_torch.quant.packing`), so the two
    # are equal, but the artifact records what it stores.
    model_bytes = fused_pack_stored_bytes(pack)
    return QuantArtifact(
        scene=env.scene_name,
        bits=bits,
        cfg=env.cfg,
        rcfg=env.rcfg,
        scene_cfg=dataclasses.asdict(env.dataset.cfg),
        params=ft_params,
        act_ranges=env.act_ranges,
        pack=pack,
        occ=occ,
        hardware=env.target.describe(),
        metrics={
            "psnr": float(psnr),
            "latency_cycles": float(lat.total_cycles),
            "model_bytes": float(model_bytes),
            "fqr": float(policy.fqr()),
            "finetune_steps": int(steps),
        },
    )
