"""TOPSIS decision analysis (paper Section V-B, Algorithm 1 lines 2-7).

Paper variant: column-normalise the decision matrix, drop constraint
violators (the reduced matrix F''), take the per-objective minimum as the
ideal point, and pick the solution with the minimum Euclidean distance to
it.  The classical TOPSIS closeness coefficient (distance to anti-ideal /
(d+ + d-)) is provided as an option; the paper uses ideal-distance only and
that is the default everywhere."""
from __future__ import annotations

import math

import numpy as np


def column_normalise(F: np.ndarray) -> np.ndarray:
    """Vector (L2) column normalisation -- standard TOPSIS step 1."""
    F = np.asarray(F, float)
    norms = np.linalg.norm(F, axis=0)
    norms = np.where(norms == 0, 1.0, norms)
    return F / norms


def topsis_rank(F: np.ndarray,
                feasible: np.ndarray | None = None,
                weights: np.ndarray | None = None,
                use_anti_ideal: bool = False) -> np.ndarray:
    """Full TOPSIS preference order: feasible row indices, best first.

    Same normalisation/weighting/distance as ``topsis_select`` -- the
    selection is ``rank[0]`` -- but exposing the whole ordering lets the
    fault-tolerant runtime walk "next-best feasible split" without
    re-running the analysis after each failure.

    F: (n, m) objective matrix, all objectives minimised.
    feasible: optional boolean mask; infeasible rows are removed before the
      ideal point is computed (the paper's F' -> F'' reduction).
    weights: optional per-objective weights applied after normalisation.
    """
    F = np.asarray(F, float)
    n = F.shape[0]
    if feasible is None:
        feasible = np.ones(n, bool)
    idx = np.where(feasible)[0]
    if idx.size == 0:
        raise ValueError("TOPSIS: no feasible solutions")
    Fn = column_normalise(F)[idx]
    if weights is not None:
        Fn = Fn * np.asarray(weights, float)
    ideal = Fn.min(axis=0)
    d_plus = np.sqrt(((Fn - ideal) ** 2).sum(axis=1))
    if use_anti_ideal:
        anti = Fn.max(axis=0)
        d_minus = np.sqrt(((Fn - anti) ** 2).sum(axis=1))
        denom = d_plus + d_minus
        denom = np.where(denom == 0, 1.0, denom)
        # maximise closeness == minimise -closeness (stable sort keeps the
        # first-listed solution on ties, matching argmax/argmin semantics)
        order = np.argsort(-d_minus / denom, kind="stable")
    else:
        order = np.argsort(d_plus, kind="stable")
    return idx[order]


def topsis_select(F: np.ndarray,
                  feasible: np.ndarray | None = None,
                  weights: np.ndarray | None = None,
                  use_anti_ideal: bool = False) -> int:
    """Return the index (into F's rows) of the TOPSIS-chosen solution.

    See ``topsis_rank`` for parameter semantics; this is ``rank[0]``."""
    return int(topsis_rank(F, feasible=feasible, weights=weights,
                           use_anti_ideal=use_anti_ideal)[0])


def link_weights(bandwidth_ratio: float,
                 base: tuple[float, float, float] = (1.0, 1.0, 1.0)
                 ) -> np.ndarray:
    """Per-objective TOPSIS weights for a re-pick under a changed link.

    ``bandwidth_ratio`` is planned/current bandwidth (> 1 means the link
    degraded).  The latency objective f1 carries the upload term I|l1 / B
    linearly, so its weight scales by the full ratio; client energy f2
    contains the radio term (also ~1/B) diluted by compute energy, so it
    scales by sqrt(ratio); the memory objective f3 is link-independent.
    Under a degraded link this steers the pick toward splits with smaller
    boundary payloads; ratio 1 reduces to ``base`` (classic TOPSIS)."""
    r = float(bandwidth_ratio)
    if not np.isfinite(r) or r <= 0:
        raise ValueError(f"bandwidth_ratio must be positive, got {r}")
    w = np.asarray(base, float).copy()
    w[0] *= r
    w[1] *= math.sqrt(r)
    return w


def chain_link_weights(bandwidth_ratios,
                       base: tuple[float, float, float] = (1.0, 1.0, 1.0)
                       ) -> np.ndarray:
    """Per-objective weights for a chain re-pick under per-hop degradation.

    ``bandwidth_ratios`` holds one planned/current ratio per hop.  The
    pipeline latency term is dominated by the slowest unit, and every hop's
    payload enters f1/f2 through the same 1/B structure as the two-tier
    case, so the re-weighting is driven by the *worst* hop: a chain is as
    degraded as its most degraded link.  Degenerates to ``link_weights``
    for a single hop."""
    ratios = [float(r) for r in bandwidth_ratios]
    if not ratios:
        raise ValueError("chain_link_weights needs >= 1 bandwidth ratio")
    return link_weights(max(ratios), base=base)
