"""Quantization policy containers.

A *unit* is one quantization decision: either a hash-table level (weights
only, f_w/a = 1 per Eq. 2), an MLP layer's weights, or an MLP layer's
activations. A *policy* is a bit-width assignment for every unit, plus the
FQR model-size metric (Eq. 13).

These are plain python containers used on the host by the search loop; the
bit widths reach the forward pass as the tensors of an `NGPQuantSpec`.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict, Iterable, List, Sequence


class UnitKind(enum.Enum):
    HASH_LEVEL = "hash_level"  # NGP hash-table level (or LM embedding band)
    WEIGHT = "weight"  # linear-layer weights
    ACTIVATION = "activation"  # linear-layer input activations


@dataclasses.dataclass
class QuantUnit:
    """One quantizable unit and the observation-space metadata (Eqs. 1-2)."""

    name: str
    kind: UnitKind
    layer_type: int  # L_i: 0 = linear, 1 = hash/embedding
    d_in: int  # d_in (MLP) or d_emb (hash: embedding dim F)
    d_out: int  # d_out (MLP) or number of hash entries T
    param_size: int  # W_i weight count (MLP) or level index l_i (hash)
    index: int  # i: position in the episode walk
    bits: int = 8  # current assignment

    def observation(self, prev_action: float) -> List[float]:
        """Seven-dimensional observation vector.

        MLP  (Eq. 1): (L_i, d_in, d_out, W_i, i, a_{i-1}, f_w/a)
        Hash (Eq. 2): (L_i, d_emb, n_entries, level, i, a_{i-1}, 1)
        """
        f_wa = 0.0 if self.kind == UnitKind.ACTIVATION else 1.0
        return [
            float(self.layer_type),
            float(self.d_in),
            float(self.d_out),
            float(self.param_size),
            float(self.index),
            float(prev_action),
            f_wa,
        ]


@dataclasses.dataclass
class QuantPolicy:
    """Bit-width assignment over an ordered list of units."""

    units: List[QuantUnit]

    # ----- construction -------------------------------------------------
    @staticmethod
    def uniform(units: Sequence[QuantUnit], bits: int) -> "QuantPolicy":
        out = [dataclasses.replace(u, bits=int(bits)) for u in units]
        return QuantPolicy(units=out)

    def with_bits(self, bits: Sequence[int]) -> "QuantPolicy":
        assert len(bits) == len(self.units)
        out = [dataclasses.replace(u, bits=int(b)) for u, b in zip(self.units, bits)]
        return QuantPolicy(units=out)

    # ----- access -------------------------------------------------------
    def bits_by_name(self) -> Dict[str, int]:
        return {u.name: u.bits for u in self.units}

    def bits_for(self, name: str) -> int:
        for u in self.units:
            if u.name == name:
                return u.bits
        raise KeyError(name)

    def hash_level_bits(self) -> List[int]:
        return [u.bits for u in self.units if u.kind == UnitKind.HASH_LEVEL]

    def weight_bits(self) -> List[int]:
        return [u.bits for u in self.units if u.kind == UnitKind.WEIGHT]

    def activation_bits(self) -> List[int]:
        return [u.bits for u in self.units if u.kind == UnitKind.ACTIVATION]

    # ----- metrics ------------------------------------------------------
    def fqr(self) -> float:
        """Feature Quantization Rate, Eq. 13: mean bit width over units."""
        return fqr([u.bits for u in self.units])

    def model_bits(self) -> int:
        """Total parameter storage in bits under this policy.

        Hash levels store d_out entries x d_in features; weight units store
        param_size weights; activation units store nothing.
        """
        total = 0
        for u in self.units:
            if u.kind == UnitKind.HASH_LEVEL:
                total += u.d_out * u.d_in * u.bits
            elif u.kind == UnitKind.WEIGHT:
                total += u.param_size * u.bits
        return total

    # ----- serialization -------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            [
                {
                    "name": u.name,
                    "kind": u.kind.value,
                    "layer_type": u.layer_type,
                    "d_in": u.d_in,
                    "d_out": u.d_out,
                    "param_size": u.param_size,
                    "index": u.index,
                    "bits": u.bits,
                }
                for u in self.units
            ]
        )

    @staticmethod
    def from_json(s: str) -> "QuantPolicy":
        raw = json.loads(s)
        return QuantPolicy(
            units=[
                QuantUnit(
                    name=r["name"],
                    kind=UnitKind(r["kind"]),
                    layer_type=r["layer_type"],
                    d_in=r["d_in"],
                    d_out=r["d_out"],
                    param_size=r["param_size"],
                    index=r["index"],
                    bits=r["bits"],
                )
                for r in raw
            ]
        )


def fqr(bits: Iterable[int]) -> float:
    """Eq. 13: FQR = (sum_i b_i) / M."""
    bits = list(bits)
    if not bits:
        return 0.0
    return sum(bits) / len(bits)
