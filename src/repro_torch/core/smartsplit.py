"""SmartSplit (paper Algorithm 1): NSGA-II Pareto set -> TOPSIS pick.

Also provides the exhaustive solver (the split index is one integer, so the
true Pareto front is enumerable -- the paper uses a GA because its framing
is generic; we keep both and test that NSGA-II recovers the exhaustive
front, then use the GA for the multi-cut beyond-paper genome where
enumeration explodes)."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.chainplan import ChainPlan
from repro_torch.core.chainplan import SplitPlan as SplitPlan  # noqa: F401  (re-export)
from repro_torch.core.costs import (ModelProfile, evaluate_objectives,
                              feasible_mask)
from repro_torch.core.dtype_policy import resolve_wire_dtype
from repro_torch.core.hardware import TwoTierHardware
from repro_torch.core.nsga2 import NSGA2Config, NSGA2Result, nsga2
from repro_torch.core.pareto import exhaustive_pareto
from repro_torch.core.topsis import link_weights, topsis_select

_PENALTY = 1e30


def _two_tier_plan(profile: ModelProfile, hw: TwoTierHardware,
                   l1: int, pareto_l1: np.ndarray,
                   pareto_F: np.ndarray, F_all: np.ndarray,
                   wire: str) -> ChainPlan:
    """Package a picked K=2 split as the unified chain plan."""
    return ChainPlan(model=profile.name, num_layers=profile.num_layers,
                     cuts=(l1,),
                     objectives=tuple(float(x) for x in F_all[l1]),
                     pareto_cuts=np.asarray(pareto_l1,
                                            np.int64).reshape(-1, 1),
                     pareto_F=pareto_F,
                     links=(hw.link,),
                     tiers=(hw.client.name, hw.server.name),
                     wire_dtypes=(wire,))


def smartsplit(profile: ModelProfile, hw: TwoTierHardware,
               config: NSGA2Config = NSGA2Config(),
               weights: np.ndarray | None = None,
               use_anti_ideal: bool = False,
               f3_mode: str = "full",
               wire: str | None = None) -> SplitPlan:
    """Paper Algorithm 1.

    Line 1:   O <- NSGA2(F)          (Pareto set of split indices)
    Lines 2-7: TOPSIS over the Pareto set with constraint filtering.

    ``wire`` is the boundary wire-dtype policy the objectives are priced
    under (default: env resolution; ``follow`` = the storage dtype, the
    legacy numbers bit-for-bit).  An ``int8`` wire shrinks the upload
    term ~4x, so the pick can move toward earlier, bigger boundaries.
    """
    wire = resolve_wire_dtype(wire, storage=profile.dtype, hop=0)
    F_all = evaluate_objectives(profile, hw, f3_mode, wire)   # (L+1, 3)
    feas_all = feasible_mask(profile, hw)
    L = profile.num_layers

    def evaluate(genomes: np.ndarray) -> np.ndarray:
        l1 = genomes[:, 0]
        F = F_all[l1].copy()
        # Penalise constraint violations so the GA steers feasible; TOPSIS
        # re-applies the filter exactly (Algorithm 1's F'' reduction).
        F[~feas_all[l1]] += _PENALTY
        return F

    # With stratified init, pop_size >= |domain| makes the archive front
    # provably exact for the paper's single-gene genome (the GA's search
    # matters for the beyond-paper multi-cut genomes).
    if config.pop_size < L - 1:
        config = dataclasses.replace(config, pop_size=L - 1)
    result: NSGA2Result = nsga2(evaluate, lower=np.array([1]),
                                upper=np.array([L - 1]), config=config)
    pareto_l1 = result.pareto_genomes[:, 0]
    pareto_F = F_all[pareto_l1]
    feas = feasible_mask(profile, hw)[pareto_l1]
    pick = topsis_select(pareto_F, feasible=feas, weights=weights,
                         use_anti_ideal=use_anti_ideal)
    l1 = int(pareto_l1[pick])
    return _two_tier_plan(profile, hw, l1, pareto_l1, pareto_F, F_all,
                          wire)


def repick_split(plan: SplitPlan, profile: ModelProfile,
                 hw: TwoTierHardware, *,
                 bandwidth: float | None = None,
                 exclude: tuple[int, ...] = (),
                 weights: np.ndarray | None = None,
                 f3_mode: str = "full") -> SplitPlan:
    """Runtime TOPSIS re-pick over a plan's already-computed Pareto front.

    The GA never re-runs: ``plan.pareto_indices`` is the front computed at
    plan time, and split-index Pareto optimality is bandwidth-independent
    for the paper's cost structure (every objective row is affine in 1/B
    through the same boundary term, so dominance among front members is
    re-decided by TOPSIS, not re-enumeration).  This re-evaluates only the
    closed-form objective matrix under the *current* link bandwidth --
    vectorised numpy over <= L rows, microseconds -- and re-runs the
    selection with link-degradation re-weighting (``topsis.link_weights``).

    bandwidth: current effective bytes/s (EWMA estimate); None keeps the
      planning bandwidth and just re-selects (e.g. after an ``exclude``).
    exclude: split indices already tried and failed for this inference --
      the degradation loop walks the front without repeating itself.
    weights: explicit TOPSIS weights; default derives them from the
      planned/current bandwidth ratio.

    Raises ValueError when no feasible non-excluded front member remains
    (the caller falls back or surfaces the outage)."""
    ratio = 1.0
    if bandwidth is not None:
        ratio = hw.link.bandwidth / bandwidth
        hw = hw.with_link_bandwidth(bandwidth)
    wire = plan.wire_dtypes[0] if plan.wire_dtypes else None
    F_all = evaluate_objectives(profile, hw, f3_mode, wire)
    idx = np.asarray(plan.pareto_indices, int)
    feas = feasible_mask(profile, hw)[idx]
    if exclude:
        feas &= ~np.isin(idx, np.asarray(list(exclude), int))
    if weights is None and ratio != 1.0:
        weights = link_weights(ratio)
    pick = topsis_select(F_all[idx], feasible=feas, weights=weights)
    l1 = int(idx[pick])
    return dataclasses.replace(
        plan, cuts=(l1,),
        objectives=tuple(float(x) for x in F_all[l1]),
        pareto_F=F_all[idx],
        links=(hw.link,),
        tiers=(hw.client.name, hw.server.name))


# ---------------------------------------------------------------------------
# Memoised chain plans (per model x tier-chain x dtype x wire).
# ---------------------------------------------------------------------------
# Standby-tier failover must not pay an NSGA-II run on the recovery path:
# the runtime prewarms the standby chains' plans here at construction, and
# a breaker-open failover is then one cached-front TOPSIS re-pick
# (``multicut.repick_chain``).  The cache key captures everything the
# optimiser's objective matrix depends on.

_PLAN_CACHE: dict[tuple, ChainPlan] = {}
_CACHE_HITS = 0
_CACHE_MISSES = 0


def _plan_cache_key(profile: ModelProfile, hw, *, microbatches: int,
                    f3_mode: str, wire) -> tuple:
    from repro_torch.core.hardware import ChainHardware
    if not isinstance(hw, ChainHardware):            # TwoTierHardware
        from repro_torch.core.hardware import chain_of
        hw = chain_of(hw)
    wire_key = wire if isinstance(wire, (str, type(None))) else tuple(wire)
    return (profile.name, profile.num_layers, profile.dtype,
            tuple(int(b) for b in profile.boundary()),
            tuple(t.name for t in hw.tiers),
            tuple((link.name, float(link.bandwidth)) for link in hw.links),
            int(microbatches), f3_mode, wire_key)


def cached_chain_plan(profile: ModelProfile, hw, *, microbatches: int = 1,
                      f3_mode: str = "full",
                      wire=None, **kwargs) -> ChainPlan:
    """``multicut.smartsplit_chain`` behind a per-(model, tier-chain,
    dtype, wire) memo.  First call per key runs the full planner
    (exhaustive or NSGA-II); every later call -- notably the failover
    path re-picking onto a standby chain -- returns the cached plan with
    its Pareto front intact, so recovery never re-runs the GA."""
    global _CACHE_HITS, _CACHE_MISSES
    key = _plan_cache_key(profile, hw, microbatches=microbatches,
                          f3_mode=f3_mode, wire=wire)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _CACHE_HITS += 1
        return plan
    _CACHE_MISSES += 1
    from repro_torch.core.multicut import smartsplit_chain
    plan = smartsplit_chain(profile, hw, microbatches=microbatches,
                            f3_mode=f3_mode, wire=wire, **kwargs)
    _PLAN_CACHE[key] = plan
    return plan


def clear_plan_cache() -> None:
    """Drop every memoised plan (tests and long-lived servers after a
    profile change)."""
    global _CACHE_HITS, _CACHE_MISSES
    _PLAN_CACHE.clear()
    _CACHE_HITS = 0
    _CACHE_MISSES = 0


def plan_cache_stats() -> dict[str, int]:
    return {"hits": _CACHE_HITS, "misses": _CACHE_MISSES,
            "size": len(_PLAN_CACHE)}


def smartsplit_exhaustive(profile: ModelProfile, hw: TwoTierHardware,
                          weights: np.ndarray | None = None,
                          use_anti_ideal: bool = False,
                          f3_mode: str = "full",
                          wire: str | None = None) -> SplitPlan:
    """Ground-truth Algorithm 1 with the GA replaced by enumeration."""
    wire = resolve_wire_dtype(wire, storage=profile.dtype, hop=0)
    F_all = evaluate_objectives(profile, hw, f3_mode, wire)
    feas = feasible_mask(profile, hw)
    L = profile.num_layers
    candidates = np.arange(1, L)                        # 1 <= l1 <= L-1
    Fc = F_all[candidates]
    # True Pareto front among feasible candidates.
    feas_c = feas[candidates]
    Fp = Fc.copy()
    Fp[~feas_c] += _PENALTY
    front = exhaustive_pareto(Fp)
    pareto_l1 = candidates[front]
    pick = topsis_select(F_all[pareto_l1], feasible=feas[pareto_l1],
                         weights=weights, use_anti_ideal=use_anti_ideal)
    l1 = int(pareto_l1[pick])
    return _two_tier_plan(profile, hw, l1, pareto_l1, F_all[pareto_l1],
                          F_all, wire)
