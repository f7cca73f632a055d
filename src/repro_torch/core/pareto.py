"""Pareto-dominance utilities: fast non-dominated sort, crowding distance,
and an exhaustive reference front (tractable here because the genome is a
single split index -- used as ground truth in tests)."""
from __future__ import annotations

import numpy as np


def dominates(a: np.ndarray, b: np.ndarray) -> bool:
    """a Pareto-dominates b (minimisation): <= everywhere and < somewhere."""
    return bool(np.all(a <= b) and np.any(a < b))


def non_dominated_sort(F: np.ndarray) -> list[np.ndarray]:
    """Deb's fast non-dominated sort.

    F: (n, m) objective matrix (minimisation).
    Returns a list of fronts, each an index array; front 0 is the Pareto set.
    """
    n = F.shape[0]
    # Vectorised domination matrix: dom[i, j] = i dominates j.
    le = np.all(F[:, None, :] <= F[None, :, :], axis=2)
    lt = np.any(F[:, None, :] < F[None, :, :], axis=2)
    dom = le & lt
    n_dominators = dom.sum(axis=0)          # how many dominate each point
    fronts: list[np.ndarray] = []
    remaining = np.ones(n, bool)
    counts = n_dominators.astype(np.int64).copy()
    while remaining.any():
        current = np.where(remaining & (counts == 0))[0]
        if current.size == 0:  # numerical ties; dump the rest as one front
            current = np.where(remaining)[0]
        fronts.append(current)
        remaining[current] = False
        counts = counts - dom[current].sum(axis=0)
    return fronts


def pareto_front_mask(F: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows of F (minimisation)."""
    n = F.shape[0]
    mask = np.ones(n, bool)
    for i in range(n):
        if not mask[i]:
            continue
        d = np.all(F <= F[i], axis=1) & np.any(F < F[i], axis=1)
        if d.any():
            mask[i] = False
    return mask


def crowding_distance(F: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance within one front.

    Boundary solutions get +inf; interior ones the normalised Manhattan
    distance between their objective-space neighbours."""
    n, m = F.shape
    if n <= 2:
        return np.full(n, np.inf)
    dist = np.zeros(n)
    for j in range(m):
        order = np.argsort(F[:, j], kind="stable")
        fj = F[order, j]
        span = fj[-1] - fj[0]
        dist[order[0]] = np.inf
        dist[order[-1]] = np.inf
        if span > 0:
            dist[order[1:-1]] += (fj[2:] - fj[:-2]) / span
    return dist


def exhaustive_pareto(F: np.ndarray) -> np.ndarray:
    """Indices of the true Pareto set of F (reference implementation)."""
    return np.where(pareto_front_mask(F))[0]
