"""Beyond-paper: K-cut SmartSplit over a CHAIN of tiers.

The paper splits once between two tiers.  Real fleets have more stages
(device -> edge accelerator -> regional pod -> core pod); the natural
generalisation is a genome of K-1 ordered cut points over a chain of K
tiers -- exactly the multi-gene integer case the NSGA-II implementation
was built for, where exhaustive enumeration is C(L-1, K-1) and stops being
free (K=4, L=80: ~80k points; K=6: ~24M).

Two evaluators live here:

* ``evaluate_multicut`` -- the original beyond-paper chain evaluator
  (bills every tier, normalised peak memory as f3).  Kept verbatim for
  M=1 so its pinned tests stay bit-stable; gains a ``microbatches``
  pipeline term.
* ``smartsplit_chain`` -- the unified planner over
  ``costs.evaluate_chain_objectives`` (paper-faithful objective
  semantics: download excluded from f1, terminal tier exempt from f2,
  first-tier memory as f3).  At K=2 it reproduces ``smartsplit()``
  bit-for-bit; this is what the chain runtime executes and re-picks
  against (``repick_chain``).

Both planners return the unified ``ChainPlan`` (``MultiCutPlan`` is an
alias of it).
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np

from repro_torch.core.chainplan import ChainPlan
from repro_torch.core.chainplan import MultiCutPlan as MultiCutPlan  # noqa: F401
from repro_torch.core.costs import (FRAME_HEADER_BYTES, ModelProfile,
                              _codec_passes, _codec_time,
                              chain_feasible_mask,
                              evaluate_chain_objectives, pipeline_latency,
                              resolve_chain_wire)
from repro_torch.core.hardware import ChainHardware as ChainHardware  # noqa: F401
from repro_torch.core.hardware import TwoTierHardware, chain_of
from repro_torch.core.nsga2 import NSGA2Config, nsga2
from repro_torch.core.pareto import exhaustive_pareto
from repro_torch.core.topsis import chain_link_weights, topsis_select

_PENALTY = 1e30

# Above this many exhaustive candidates, smartsplit_chain switches from
# enumeration (provably exact front) to NSGA-II.
_EXHAUSTIVE_LIMIT = 50_000


def _stage_tables(profile: ModelProfile, hw: ChainHardware):
    """Cumulative per-layer tables used by the vectorised evaluator."""
    flops = np.concatenate([[0.0], np.cumsum(
        [l.flops for l in profile.layers])])
    mem = profile.cum_mem()
    bound = profile.boundary()
    return flops, mem, bound


def evaluate_multicut(profile: ModelProfile, hw: ChainHardware,
                      genomes: np.ndarray,
                      microbatches: int = 1, wire=None) -> np.ndarray:
    """genomes: (n, K-1) cut points (unsorted ok; sorted internally).
    Returns (n, 3) objectives with constraint penalties applied.

    ``microbatches`` > 1 replaces the sequential latency sum with the
    pipelined fill-and-drain term (``costs.pipeline_latency``) and adds
    the per-hop framing energy the M-way split costs; M=1 keeps the
    historical numbers bit-for-bit.  ``wire`` prices each hop's bytes in
    its wire format (plus the codec passes on adjacent tiers); the
    default ``follow`` resolution keeps the storage bytes unchanged."""
    L = profile.num_layers
    K = len(hw.tiers)
    flops, mem, bound = _stage_tables(profile, hw)
    ws = resolve_chain_wire(wire, len(hw.links), profile.dtype)
    cuts = np.sort(np.asarray(genomes, np.int64), axis=1)
    n = cuts.shape[0]
    edges = np.concatenate([np.zeros((n, 1), np.int64), cuts,
                            np.full((n, 1), L, np.int64)], axis=1)
    lat = np.zeros(n)
    en = np.zeros(n)
    peak = np.zeros(n)
    stage_T = np.zeros((n, K))
    hop_T = np.zeros((n, K - 1))
    for k, tier in enumerate(hw.tiers):
        f_k = flops[edges[:, k + 1]] - flops[edges[:, k]]
        m_k = mem[edges[:, k + 1]] - mem[edges[:, k]]
        if tier.is_roofline:
            t_k = np.maximum(f_k / tier.peak_flops, m_k / tier.hbm_bw)
            e_k = (f_k * tier.pj_per_flop
                   + m_k * tier.pj_per_hbm_byte) * 1e-12
        else:
            t_k = m_k / tier.compute_scale
            e_k = tier.compute_power_w() * t_k
        lat += t_k
        en += e_k
        peak = np.maximum(peak, m_k / tier.memory_budget)
        stage_T[:, k] = t_k
    for k, link in enumerate(hw.links):
        b_k = profile.wire_boundary(ws[k])[edges[:, k + 1]]
        t_l = b_k / link.bandwidth
        lat += t_l
        hop_T[:, k] = t_l
        if link.pj_per_byte:
            en += b_k * link.pj_per_byte * 1e-12
        else:
            en += link.upload_power_w(link.bandwidth) * t_l
        enc_p, dec_p = _codec_passes(ws[k], profile.dtype)
        if enc_p:
            b_raw = bound[edges[:, k + 1]]
            for t_i, passes in ((k, enc_p), (k + 1, dec_p)):
                tier = hw.tiers[t_i]
                t_c = _codec_time(tier, passes * b_raw)
                lat += t_c
                stage_T[:, t_i] += t_c
                if tier.is_roofline:
                    en += passes * b_raw * tier.pj_per_hbm_byte * 1e-12
                else:
                    en += tier.compute_power_w() * t_c
    if microbatches > 1:
        bws = np.array([link.bandwidth for link in hw.links])
        lat = pipeline_latency(stage_T, hop_T, microbatches,
                               link_bandwidths=bws)
        extra = (microbatches - 1) * FRAME_HEADER_BYTES
        for link in hw.links:
            if link.pj_per_byte:
                en += extra * link.pj_per_byte * 1e-12
            else:
                en += link.upload_power_w(link.bandwidth) \
                    * (extra / link.bandwidth)
    F = np.stack([lat, en, peak], axis=1)
    # constraints: non-empty stages, memory budgets
    widths = np.diff(edges, axis=1)
    bad = (widths < 1).any(axis=1) | (peak > 1.0)
    F[bad] += _PENALTY
    return F


def _chain_plan(profile: ModelProfile, hw: ChainHardware,
                cuts: tuple[int, ...], F_pick: np.ndarray,
                pareto_cuts: np.ndarray, pareto_F: np.ndarray,
                microbatches: int = 1,
                wire_dtypes: tuple[str, ...] = ()) -> ChainPlan:
    return ChainPlan(model=profile.name, num_layers=profile.num_layers,
                     cuts=cuts,
                     objectives=tuple(float(v) for v in F_pick),
                     pareto_cuts=np.asarray(pareto_cuts, np.int64),
                     pareto_F=np.asarray(pareto_F, float),
                     links=tuple(hw.links),
                     tiers=tuple(t.name for t in hw.tiers),
                     microbatches=microbatches,
                     wire_dtypes=wire_dtypes)


def smartsplit_multicut(profile: ModelProfile, hw: ChainHardware,
                        config: NSGA2Config | None = None,
                        microbatches: int = 1, wire=None) -> ChainPlan:
    """Algorithm 1 with the K-cut genome (original chain evaluator)."""
    L = profile.num_layers
    K = len(hw.tiers)
    ws = resolve_chain_wire(wire, len(hw.links), profile.dtype)
    config = config or NSGA2Config(pop_size=128, generations=80, seed=0)
    lower = np.ones(K - 1, np.int64)
    upper = np.full(K - 1, L - 1, np.int64)
    res = nsga2(lambda g: evaluate_multicut(profile, hw, g, microbatches,
                                            ws),
                lower, upper, config)
    F = evaluate_multicut(profile, hw, res.pareto_genomes, microbatches,
                          ws)
    feas = F[:, 0] < _PENALTY / 2
    pick = topsis_select(F, feasible=feas)
    cuts = tuple(int(c) for c in np.sort(res.pareto_genomes[pick]))
    return _chain_plan(profile, hw, cuts, F[pick],
                       np.sort(res.pareto_genomes, axis=1), F,
                       microbatches, ws)


def _chain_candidates(L: int, K: int) -> np.ndarray:
    """All strictly-increasing K-1 cut vectors in [1, L-1] -- (n, K-1)."""
    return np.array(list(itertools.combinations(range(1, L), K - 1)),
                    np.int64).reshape(-1, K - 1)


def smartsplit_chain(profile: ModelProfile,
                     hw: ChainHardware | TwoTierHardware, *,
                     microbatches: int = 1,
                     config: NSGA2Config | None = None,
                     weights: np.ndarray | None = None,
                     use_anti_ideal: bool = False,
                     f3_mode: str = "full",
                     wire=None) -> ChainPlan:
    """Algorithm 1 over a K-tier chain with paper-faithful objectives.

    The unified planner: pass a ``TwoTierHardware`` (wrapped via
    ``chain_of``) and the result is identical to ``smartsplit()`` /
    ``smartsplit_exhaustive()`` -- same objective rows, same Pareto
    front, same TOPSIS pick -- because ``evaluate_chain_objectives``
    degenerates bit-exactly at K=2, M=1.  For larger K the cut-vector
    space is enumerated while C(L-1, K-1) stays small and handed to
    NSGA-II beyond that."""
    if isinstance(hw, TwoTierHardware):
        hw = chain_of(hw)
    L = profile.num_layers
    K = hw.num_tiers
    if K - 1 > L - 1:
        raise ValueError(
            f"smartsplit_chain: {K} tiers need >= {K} layers, "
            f"model {profile.name} has {L}")
    ws = resolve_chain_wire(wire, len(hw.links), profile.dtype)
    n_combos = math.comb(L - 1, K - 1)
    if n_combos <= _EXHAUSTIVE_LIMIT:
        genomes = _chain_candidates(L, K)
        F = evaluate_chain_objectives(profile, hw, genomes, f3_mode,
                                      microbatches, ws)
        feas = chain_feasible_mask(profile, hw, genomes)
        Fp = F.copy()
        Fp[~feas] += _PENALTY
        front = exhaustive_pareto(Fp)
        pareto_cuts = genomes[front]
        pareto_F = F[front]
        feas_front = feas[front]
    else:
        config = config or NSGA2Config(pop_size=128, generations=80,
                                       seed=0)
        lower = np.ones(K - 1, np.int64)
        upper = np.full(K - 1, L - 1, np.int64)

        def evaluate(g: np.ndarray) -> np.ndarray:
            F = evaluate_chain_objectives(profile, hw, g, f3_mode,
                                          microbatches, ws)
            F[~chain_feasible_mask(profile, hw, g)] += _PENALTY
            return F

        res = nsga2(evaluate, lower, upper, config)
        pareto_cuts = np.sort(res.pareto_genomes, axis=1)
        pareto_F = evaluate_chain_objectives(profile, hw, pareto_cuts,
                                             f3_mode, microbatches, ws)
        feas_front = chain_feasible_mask(profile, hw, pareto_cuts)
    pick = topsis_select(pareto_F, feasible=feas_front, weights=weights,
                         use_anti_ideal=use_anti_ideal)
    cuts = tuple(int(c) for c in pareto_cuts[pick])
    return _chain_plan(profile, hw, cuts, pareto_F[pick], pareto_cuts,
                       pareto_F, microbatches, ws)


def repick_chain(plan: ChainPlan, profile: ModelProfile,
                 hw: ChainHardware | TwoTierHardware, *,
                 bandwidths=None,
                 exclude: tuple[tuple[int, ...], ...] = (),
                 weights: np.ndarray | None = None,
                 f3_mode: str = "full") -> ChainPlan:
    """TOPSIS re-pick over a chain plan's cached Pareto front.

    The K-tier generalisation of ``smartsplit.repick_split``: the front
    (``plan.pareto_cuts``) never gets re-enumerated; the objective rows
    are re-priced under the current per-hop bandwidth estimates and the
    selection re-runs with per-hop degradation re-weighting
    (``topsis.chain_link_weights`` -- driven by the worst hop's
    planned/current ratio).

    bandwidths: per-hop current bytes/s; ``None`` entries keep that
      hop's planning bandwidth.  ``None`` overall keeps every hop.
    exclude: cut vectors already tried and failed for this inference.

    Raises ValueError when no feasible non-excluded front member remains
    (the caller merges a stage or surfaces the outage)."""
    if isinstance(hw, TwoTierHardware):
        hw = chain_of(hw)
    ratios = [1.0] * len(hw.links)
    if bandwidths is not None:
        for k, b in enumerate(bandwidths):
            if b is not None:
                ratios[k] = hw.links[k].bandwidth / float(b)
        hw = hw.with_link_bandwidths(bandwidths)
    cand = np.asarray(plan.pareto_cuts, np.int64)
    if cand.size == 0:
        raise ValueError("repick_chain: plan carries no cached front")
    wire = plan.wire_dtypes or None
    F = evaluate_chain_objectives(profile, hw, cand, f3_mode,
                                  plan.microbatches, wire)
    feas = chain_feasible_mask(profile, hw, cand)
    if exclude:
        tried = {tuple(int(c) for c in cuts) for cuts in exclude}
        feas &= np.array([tuple(int(c) for c in row) not in tried
                          for row in cand])
    if weights is None and any(r != 1.0 for r in ratios):
        weights = chain_link_weights(ratios)
    pick = topsis_select(F, feasible=feas, weights=weights)
    cuts = tuple(int(c) for c in cand[pick])
    return dataclasses.replace(
        plan, cuts=cuts,
        objectives=tuple(float(v) for v in F[pick]),
        pareto_F=F,
        links=tuple(hw.links),
        tiers=tuple(t.name for t in hw.tiers))
