"""Collective bytes, op census and roofline terms of a recorded step.

The counterpart of `repro/distributed/hlo_analysis.py`. There they are
read from compiled HLO text; here from the trace `hlo_counters.Recorder`
records of one step at one rank (per-rank shapes, the collectives with
their groups), by the same byte accounting per collective kind (N = the
ranks of the op's group, s = bytes on one rank):

  all-gather       : (N-1)/N * output
  all-reduce       : ring = 2*(N-1)/N * s
  reduce-scatter   : (N-1)/N * s (s = the unreduced input)
  all-to-all       : (N-1)/N * s
  collective-permute (broadcast, send, receive): s

Per-rank *link* bytes under a bidirectional-ring model, as there. Op
names in the census are aten's ("aten.mm", "aten.copy_", ...), and a
hand-written kernel's are "kernel.<name>".
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.distributed.hlo_counters import Trace, link_bytes

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, float]  # per-device link bytes
    wire_bytes: float  # sum over kinds
    details: List[Tuple[str, float, int]]  # (kind, bytes, group_size)

    @property
    def total_bytes(self) -> float:
        return self.wire_bytes


def parse_collectives(trace: Trace, n_devices: int = 1) -> CollectiveStats:
    """The collectives of `trace`, counted by kind with their link bytes
    (a record without a group taken as `n_devices` ranks)."""
    counts: Dict[str, int] = {}
    bbk: Dict[str, float] = {}
    details = []
    for r in trace.records:
        if r.kind not in _COLLECTIVES:
            continue
        N = max(r.group or n_devices, 1)
        link = link_bytes(r.kind, r.out_bytes, r.in_bytes, N)
        counts[r.kind] = counts.get(r.kind, 0) + int(round(r.calls))
        bbk[r.kind] = bbk.get(r.kind, 0.0) + link
        details.append((r.kind, link, N))
    return CollectiveStats(counts=counts, bytes_by_kind=bbk,
                           wire_bytes=float(sum(bbk.values())),
                           details=details)


def op_census(trace: Trace, ops: Tuple[str, ...] = (
        "aten.mm", "aten.bmm", "aten.copy_", "aten.clone")
        ) -> Dict[str, int]:
    """How many times each of `ops` ran (a view is not recorded: it
    counts 0)."""
    census: Dict[str, int] = {}
    for r in trace.records:
        if r.op in ops:
            census[r.op] = census.get(r.op, 0) + int(round(r.calls))
    return census


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """NVIDIA H100 SXM5 80 GB (NVIDIA's datasheet: 989 TFLOP/s dense
    bf16 on the tensor cores, 3.35 TB/s of HBM3, 80 GB; NVLink 4, 900
    GB/s a card in both directions, 450 GB/s each way), the rates
    `hero/targets.py`'s H100 preset reads. One link rate for every mesh
    axis: the dry-run's `pod` axis is taken at NVLink's rate too."""

    name: str = "h100-sxm"
    peak_flops_bf16: float = 989e12  # FLOP/s
    hbm_bw: float = 3.35e12  # B/s
    ici_bw: float = 450e9  # B/s, NVLink 4 one direction
    hbm_bytes: float = 80e9


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower bound: perfectly-overlapped terms -> max; report max."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """(useful compute time) / (achievable step time)."""
        if self.step_time_s == 0 or self.hlo_flops == 0:
            return 0.0
        useful_compute_s = (self.model_flops / self.hlo_flops) * self.compute_s
        return useful_compute_s / self.step_time_s

    def as_dict(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_terms(
    cost: Dict[str, float],
    collectives: CollectiveStats,
    n_devices: int,
    chip: ChipSpec = ChipSpec(),
    model_flops: float = 0.0,
    flops_are_global: bool = True,
) -> RooflineTerms:
    """The three terms from a cost dict ({"flops", "bytes accessed"}) and
    the collective parse; `flops_are_global=False` takes per-device
    numbers, as the recorded trace gives them."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    if flops_are_global:
        per_dev_flops = flops / n_devices
        per_dev_bytes = byts / n_devices
    else:
        per_dev_flops = flops
        per_dev_bytes = byts
    return RooflineTerms(
        compute_s=per_dev_flops / chip.peak_flops_bf16,
        memory_s=per_dev_bytes / chip.hbm_bw,
        collective_s=collectives.wire_bytes / chip.ici_bw,
        hlo_flops=per_dev_flops * n_devices,
        hlo_bytes=per_dev_bytes * n_devices,
        collective_bytes=collectives.wire_bytes,
        model_flops=model_flops,
    )
