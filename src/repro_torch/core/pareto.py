"""Pareto bookkeeping for the closed-loop HERO search.

The RL search scalarizes accuracy and cost into one reward (Eq. 8), which
is the right signal for the agent but throws away the shape of the
trade-off surface: two policies with equal reward can sit at very
different (latency, PSNR, model-size) corners. The closed loop keeps the
full surface instead — every evaluated policy is offered to a
`ParetoFrontier`, dominated entries are pruned, and the survivors are the
search product (what an accelerator designer actually picks from, cf.
FlexNeRFer / Gen-NeRF design-space sweeps).

Objectives are fixed: latency (minimize), PSNR (maximize), model bytes
(minimize). `model_bytes` is the PACKED payload size: every simulator
feeding this frontier computes it through the shared size function in
`repro_torch.quant.packing` (bit-plane words for <= 8-bit units, f32 carriers
above), which is byte-identical to what a compiled `QuantArtifact`
stores on disk for the same policy — the search objective IS the shipped
artifact size, not an analytic proxy. Cross-scene frontiers compare
*normalized* objectives
(latency ratio and PSNR delta against that scene's all-8-bit baseline)
so points from scenes of different intrinsic difficulty live on one
surface; `ParetoPoint.scene`/`budget` tags keep provenance.

Invariants (pinned by tests/test_torch_search.py against the reference):
  - no point on the frontier dominates another frontier point;
  - every rejected point is dominated by some frontier point;
  - the frontier is a permutation-invariant function of the input set.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ParetoPoint:
    """One evaluated policy. `latency`/`model_bytes` are minimized,
    `psnr` maximized. For cross-scene (normalized) frontiers, `latency`
    holds the latency *ratio* and `psnr` the PSNR *delta* vs the scene's
    8-bit baseline."""

    latency: float
    psnr: float
    model_bytes: float
    bits: Tuple[int, ...] = ()
    scene: str = ""
    budget: Optional[float] = None  # latency budget active when found
    reward: Optional[float] = None  # Eq. 8 scalarization, for reference

    def objectives(self) -> Tuple[float, float, float]:
        """Minimization form: (latency, -psnr, model_bytes)."""
        return (self.latency, -self.psnr, self.model_bytes)

    def dominates(self, other: "ParetoPoint") -> bool:
        """Weak Pareto dominance with at least one strict objective."""
        a, b = self.objectives(), other.objectives()
        return all(x <= y for x, y in zip(a, b)) and any(
            x < y for x, y in zip(a, b)
        )

    def dominates_or_ties(self, other: "ParetoPoint") -> bool:
        a, b = self.objectives(), other.objectives()
        return all(x <= y for x, y in zip(a, b))

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["bits"] = list(self.bits)
        return d

    @staticmethod
    def from_json(d: Dict) -> "ParetoPoint":
        d = dict(d)
        d["bits"] = tuple(int(b) for b in d.get("bits", ()))
        return ParetoPoint(**d)


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """Hard feasibility bounds a candidate must satisfy before it is even
    offered to the frontier (the paper's latency target, generalized)."""

    max_latency: Optional[float] = None
    min_psnr: Optional[float] = None
    max_model_bytes: Optional[float] = None

    def feasible(self, p: ParetoPoint) -> bool:
        if self.max_latency is not None and p.latency > self.max_latency:
            return False
        if self.min_psnr is not None and p.psnr < self.min_psnr:
            return False
        if (
            self.max_model_bytes is not None
            and p.model_bytes > self.max_model_bytes
        ):
            return False
        return True

    def feasible_mask(
        self,
        latency: np.ndarray,
        psnr: np.ndarray,
        model_bytes: np.ndarray,
    ) -> np.ndarray:
        """Vectorized feasibility over (K,) metric arrays."""
        ok = np.ones(np.shape(latency), bool)
        if self.max_latency is not None:
            ok &= np.asarray(latency) <= self.max_latency
        if self.min_psnr is not None:
            ok &= np.asarray(psnr) >= self.min_psnr
        if self.max_model_bytes is not None:
            ok &= np.asarray(model_bytes) <= self.max_model_bytes
        return ok


class ParetoFrontier:
    """Incremental non-dominated set over (latency, PSNR, model bytes).

    Insertion is O(n) against the current frontier; the frontier is the
    same set of objective vectors for any insertion order (ties — equal
    objective vectors — all survive, since dominance requires one strict
    inequality).
    """

    def __init__(
        self,
        points: Iterable[ParetoPoint] = (),
        constraints: ConstraintSet = ConstraintSet(),
    ):
        self.constraints = constraints
        self._points: List[ParetoPoint] = []
        for p in points:
            self.insert(p)

    # ------------------------------------------------------------------
    @property
    def points(self) -> List[ParetoPoint]:
        return list(self._points)

    def __len__(self) -> int:
        return len(self._points)

    def __iter__(self):
        return iter(self._points)

    # ------------------------------------------------------------------
    def insert(self, p: ParetoPoint) -> bool:
        """Offer one candidate. Returns True iff it joined the frontier
        (it was feasible and not dominated); dominated incumbents are
        evicted."""
        if not self.constraints.feasible(p):
            return False
        for q in self._points:
            if q.dominates(p):
                return False
        self._points = [q for q in self._points if not p.dominates(q)]
        self._points.append(p)
        return True

    def extend(self, points: Iterable[ParetoPoint]) -> int:
        """Offer many candidates; returns how many were admitted (note an
        admitted point may later be evicted by a better one in the same
        batch — the *final* frontier is order-independent)."""
        return sum(1 for p in points if self.insert(p))

    # ------------------------------------------------------------------
    def dominated_by_frontier(self, p: ParetoPoint) -> bool:
        return any(q.dominates(p) for q in self._points)

    def objective_set(self) -> set:
        """Frozen view used by the permutation-invariance tests."""
        return {p.objectives() for p in self._points}

    def best_by_reward(self) -> Optional[ParetoPoint]:
        scored = [p for p in self._points if p.reward is not None]
        return max(scored, key=lambda p: p.reward) if scored else None

    # ------------------------------------------------------------------
    def hypervolume(
        self, ref: Optional[Tuple[float, float, float]] = None
    ) -> float:
        """Exact dominated hypervolume against a reference point
        (latency_ref, psnr_ref, bytes_ref) with psnr_ref a LOWER bound.

        Grid-compression sweep: project every frontier point onto the
        sorted unique coordinate grid and mark covered cells — exact for
        the frontier sizes the search produces (tens of points), no
        Monte Carlo noise, so it is usable as a CI regression metric.
        """
        if not self._points:
            return 0.0
        # Minimization form; ref must be weakly worse than every point.
        pts = np.asarray([p.objectives() for p in self._points], np.float64)
        if ref is None:
            r = pts.max(axis=0)
        else:
            r = np.asarray([ref[0], -ref[1], ref[2]], np.float64)
        pts = pts[np.all(pts <= r, axis=1)]
        if pts.size == 0:
            return 0.0
        pts = np.minimum(pts, r)

        edges = [np.unique(np.concatenate([pts[:, d], [r[d]]])) for d in range(3)]
        widths = [np.diff(e) for e in edges]
        if any(w.size == 0 for w in widths):
            return 0.0  # zero extent along some objective
        covered = np.zeros([len(w) for w in widths], bool)
        for p in pts:
            ix = [int(np.searchsorted(edges[d], p[d])) for d in range(3)]
            covered[ix[0]:, ix[1]:, ix[2]:] = True
        wx, wy, wz = widths
        cell = wx[:, None, None] * wy[None, :, None] * wz[None, None, :]
        return float((cell * covered).sum())

    # ------------------------------------------------------------------
    # Checkpoint format (JSON, auditable)
    # ------------------------------------------------------------------
    def to_json(self) -> Dict:
        return {
            "constraints": dataclasses.asdict(self.constraints),
            "points": [p.to_json() for p in self._points],
        }

    @staticmethod
    def from_json(d: Dict) -> "ParetoFrontier":
        f = ParetoFrontier(constraints=ConstraintSet(**d.get("constraints", {})))
        # Restore verbatim (already mutually non-dominated).
        f._points = [ParetoPoint.from_json(p) for p in d.get("points", [])]
        return f

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.to_json(), indent=2))

    @staticmethod
    def load(path) -> "ParetoFrontier":
        return ParetoFrontier.from_json(json.loads(Path(path).read_text()))


def pareto_filter(points: Sequence[ParetoPoint]) -> List[ParetoPoint]:
    """Non-dominated subset of an arbitrary point set (one-shot helper)."""
    return ParetoFrontier(points).points
