"""NSGA-II (Deb et al. 2002) over an integer genome.

The paper's genome is the split index l1 in [1, L-1]; we implement the
general integer-box case (genome = vector of ints within per-gene bounds) so
beyond-paper extensions (per-layer precision, multi-cut pipelines) reuse the
same optimiser.  Elitism, binary-tournament mating on (rank, crowding),
uniform crossover and bounded random-reset/creep mutation.

Deterministic given the seed; pure numpy (host-side optimiser -- the
objective evaluation is vectorised and, for TPU plans, derives from the
compiled-HLO cost tables)."""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.pareto import crowding_distance, non_dominated_sort

# Lifetime GA-run count.  The failover tests assert that a standby-tier
# re-pick is a cached-front TOPSIS pass with NO optimiser re-run by
# reading this before/after the recovery.
RUN_COUNT = 0


@dataclasses.dataclass(frozen=True)
class NSGA2Config:
    pop_size: int = 64
    generations: int = 60
    crossover_prob: float = 0.9
    mutation_prob: float = 0.2      # per-gene
    creep_prob: float = 0.5         # creep (+-step) vs random-reset mutation
    creep_step: int = 2
    seed: int = 0


@dataclasses.dataclass
class NSGA2Result:
    pareto_genomes: np.ndarray      # (n, g) unique non-dominated genomes
    pareto_F: np.ndarray            # (n, m) their objectives
    population: np.ndarray          # final population (pop, g)
    population_F: np.ndarray
    history: list[float]            # per-generation hypervolume proxy


def _tournament(rng, rank, crowd):
    n = rank.shape[0]
    a = rng.integers(0, n, n)
    b = rng.integers(0, n, n)
    a_wins = (rank[a] < rank[b]) | ((rank[a] == rank[b]) & (crowd[a] > crowd[b]))
    return np.where(a_wins, a, b)


def _rank_and_crowd(F: np.ndarray):
    fronts = non_dominated_sort(F)
    rank = np.empty(F.shape[0], np.int64)
    crowd = np.empty(F.shape[0])
    for r, idx in enumerate(fronts):
        rank[idx] = r
        crowd[idx] = crowding_distance(F[idx])
    return rank, crowd, fronts


def nsga2(evaluate: Callable[[np.ndarray], np.ndarray],
          lower: np.ndarray, upper: np.ndarray,
          config: NSGA2Config = NSGA2Config()) -> NSGA2Result:
    """Minimise a vector objective over an integer box [lower, upper].

    evaluate: (pop, g) int genomes -> (pop, m) objectives.  Infeasible
    genomes should be penalised by the caller (we keep the optimiser
    constraint-agnostic; SmartSplit applies the paper's constraints both as
    a penalty here and as the TOPSIS filter, matching Algorithm 1 where the
    reduced matrix F'' drops constraint-violating solutions)."""
    global RUN_COUNT
    RUN_COUNT += 1
    lower = np.asarray(lower, np.int64)
    upper = np.asarray(upper, np.int64)
    g = lower.shape[0]
    rng = np.random.default_rng(config.seed)
    # Stratified (latin-hypercube style) initialisation: per gene, evenly
    # spaced values in [lower, upper] independently shuffled across rows.
    # Small domains are fully covered at init; large ones evenly seeded.
    # Includes both box corners, covering the common boundary optima.
    n = config.pop_size
    pop = np.empty((n, g), np.int64)
    for j in range(g):
        vals = np.rint(np.linspace(lower[j], upper[j], n)).astype(np.int64)
        rng.shuffle(vals)
        pop[:, j] = vals
    F = np.asarray(evaluate(pop), float)
    history: list[float] = []
    # Offline archive: every evaluated (genome, F) pair.  The returned
    # Pareto set is the non-dominated subset of the archive, so a front
    # member visited once is never lost to selection churn.
    arch_G = [pop.copy()]
    arch_F = [F.copy()]

    for _ in range(config.generations):
        rank, crowd, _ = _rank_and_crowd(F)
        parents = pop[_tournament(rng, rank, crowd)]
        # Uniform crossover between consecutive parent pairs.
        child = parents.copy()
        pairs = child.reshape(-1, 2, g) if config.pop_size % 2 == 0 else None
        if pairs is not None:
            swap = (rng.random(pairs.shape[::2]) < 0.5)[:, None, :] \
                & (rng.random((pairs.shape[0], 1, 1)) < config.crossover_prob)
            a, b = pairs[:, 0].copy(), pairs[:, 1].copy()
            pairs[:, 0] = np.where(swap[:, 0], b, a)
            pairs[:, 1] = np.where(swap[:, 0], a, b)
            child = pairs.reshape(-1, g)
        # Mutation: creep or reset.
        mut = rng.random(child.shape) < config.mutation_prob
        creep = rng.random(child.shape) < config.creep_prob
        step = rng.integers(-config.creep_step, config.creep_step + 1,
                            child.shape)
        reset = rng.integers(lower, upper + 1, size=child.shape)
        child = np.where(mut, np.where(creep, child + step, reset), child)
        child = np.clip(child, lower, upper)
        childF = np.asarray(evaluate(child), float)
        arch_G.append(child.copy())
        arch_F.append(childF.copy())
        # Elitist environmental selection over parents + children.
        allP = np.concatenate([pop, child])
        allF = np.concatenate([F, childF])
        rank, crowd, fronts = _rank_and_crowd(allF)
        chosen: list[int] = []
        for idx in fronts:
            if len(chosen) + idx.size <= config.pop_size:
                chosen.extend(idx.tolist())
            else:
                take = config.pop_size - len(chosen)
                order = np.argsort(-crowd[idx], kind="stable")
                chosen.extend(idx[order[:take]].tolist())
                break
        sel = np.array(chosen)
        pop, F = allP[sel], allF[sel]
        # Convergence proxy: sum of front-0 normalised objective means.
        history.append(float(F[rank[sel] == 0].mean()))

    # Offline result: non-dominated subset of everything evaluated.
    G_all = np.concatenate(arch_G)
    F_arch = np.concatenate(arch_F)
    G_uniq, first = np.unique(G_all, axis=0, return_index=True)
    F_uniq = F_arch[first]
    _, _, fronts = _rank_and_crowd(F_uniq)
    front0 = fronts[0]
    return NSGA2Result(pareto_genomes=G_uniq[front0], pareto_F=F_uniq[front0],
                       population=pop, population_F=F, history=history)
