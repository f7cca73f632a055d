"""Fault-tolerant split execution of a CNN over a chain of tiers: the
PyTorch port of ``repro.runtime.runtime``'s ``ChainRuntime``, held by the
tests to its events, virtual clock and counters.

Stage k runs on tier k exactly as ``models.cnn.apply_split`` would; its
boundary is encoded for hop k's wire format, crosses a ``FaultyLink``
through the reliable transfer layer (runtime/transfer.py) and is decoded
for stage k+1.  When a hop exhausts its retries or a tier fails, the
runtime walks the degradation ladder of ``ChainRuntime``'s docstring
instead of failing the request.  A two-tier split is the K=2 chain
(``core.hardware.paper_chain(2)``).  Every recovery action lands in the
structured ``EventLog``: the invariant tests and the chaos harness both
key on it.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.chainplan import ChainPlan
from repro_torch.core.costs import (ModelProfile, _tier_compute_time,
                                    resolve_chain_wire)
from repro_torch.core.dtype_policy import conv_dtype
from repro_torch.core.hardware import (ChainHardware, TwoTierHardware,
                                       chain_of, standby_chain)
from repro_torch.core.multicut import repick_chain
from repro_torch.core.smartsplit import cached_chain_plan
from repro_torch.models import cnn as cnn_lib
from repro_torch.runtime import events as ev
from repro_torch.runtime.breakers import OPEN, CircuitBreaker, tier_breakers
from repro_torch.runtime.events import Event, EventLog
from repro_torch.runtime.faults import FaultyLink, VirtualClock
from repro_torch.runtime.link_estimator import EwmaLinkEstimator, chain_estimators
from repro_torch.runtime.tier_faults import (FaultyTier, TierCrash, TierError,
                                             TierShed)
from repro_torch.runtime.transfer import (RetryPolicy, TransferFailed,
                                          send_with_retry)
from repro_torch.runtime.wire import decode_boundary, encode_boundary
from repro_torch.spans import span


class SplitUnrecoverable(RuntimeError):
    """A hop or a tier failed and no rung of the ladder was left: the
    request cannot complete."""


def microbatch_slices(batch: int, microbatches: int
                      ) -> list[tuple[int, int]]:
    """Contiguous [start, stop) microbatch slices of a batch: an even
    split with the remainder spread over the leading microbatches.

    Exposed so references can be computed at the same granularity --
    library convs and matmuls are not bitwise batch-size-invariant, so an
    M-microbatch chain run is bit-identical to a single-device run
    *sliced the same way* (and to the plain batched run only at M=1)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    M = max(1, min(int(microbatches), batch))
    sizes = [batch // M + (1 if i < batch % M else 0) for i in range(M)]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    return [(int(offsets[i]), int(offsets[i + 1])) for i in range(M)]


def links_and_clock(hw: ChainHardware, links: list[FaultyLink] | None
                    ) -> tuple[list[FaultyLink], VirtualClock]:
    """The chain's links and the virtual clock they share: ``links`` as
    given, else fault-free links at ``hw``'s nominal bandwidths on one new
    clock.  Raises unless there is one link a hop."""
    if links is None:
        clock = VirtualClock()
        links = [FaultyLink(link.bandwidth, clock=clock)
                 for link in hw.links]
    else:
        links = list(links)
        clock = links[0]._clock if links else VirtualClock()
    if len(links) != hw.num_tiers - 1:
        raise ValueError(
            f"{hw.num_tiers} tiers need {hw.num_tiers - 1} links, "
            f"got {len(links)}")
    return links, clock


def tier_guards(hw: ChainHardware, tier_faults: list[FaultyTier] | None,
                breakers: list[CircuitBreaker] | None, log: EventLog
                ) -> tuple[list[FaultyTier] | None,
                           list[CircuitBreaker] | None]:
    """The per-tier fault models and circuit breakers, checked to hold
    one a tier.  With fault models and no breakers, ``tier_breakers``
    builds them (threshold 3, cooldown 1 s) on ``log``.  The lists are
    returned as given, so every runtime handed them shares them."""
    if tier_faults is not None and len(tier_faults) != hw.num_tiers:
        raise ValueError(
            f"{hw.num_tiers} tiers need {hw.num_tiers} tier-fault "
            f"models, got {len(tier_faults)}")
    if breakers is None and tier_faults is not None:
        breakers = tier_breakers([t.name for t in hw.tiers], log=log)
    if breakers is not None and len(breakers) != hw.num_tiers:
        raise ValueError(
            f"{hw.num_tiers} tiers need {hw.num_tiers} breakers, "
            f"got {len(breakers)}")
    return tier_faults, breakers


def hop_stats(runtimes: list[ChainRuntime], k: int, wire_dtype: str,
              estimator: EwmaLinkEstimator, link: FaultyLink) -> dict:
    """Hop ``k``'s stats record, its counters summed over ``runtimes``:
    one runtime, or a serving engine's bucket runtimes, which share the
    hop's link and estimator."""
    wire_bytes = sum(rt.hop_wire_bytes[k] for rt in runtimes)
    goodput = sum(rt.hop_goodput_bytes[k] for rt in runtimes)
    return {
        "hop": k,
        "wire_dtype": wire_dtype,
        "attempts": sum(rt.hop_attempts[k] for rt in runtimes),
        "wire_bytes": wire_bytes,
        "goodput_bytes": goodput,
        "raw_bytes": sum(rt.hop_raw_bytes[k] for rt in runtimes),
        "retransmitted_bytes": wire_bytes - goodput,
        "merges": sum(rt.hop_merges[k] for rt in runtimes),
        "est_bandwidth": estimator.bandwidth,
        "degradation": estimator.degradation(),
        "link": link.counters(),
    }


class ChainResources:
    """Persistent per-tier / per-link next-free times on the virtual
    clock, shared across requests (and across the per-bucket runtimes of
    a serving engine).

    Without one, ``ChainRuntime.infer`` resets its resource model per
    request, so consecutive requests serialise completely: request i+1's
    client stage cannot start before request i's makespan.  Passing one
    ``ChainResources`` instance to the runtime makes tier/link
    availability *outlive* the request: while request i's boundary
    payload is in flight on hop k, request i+1's client stage runs on
    tier 0 -- the cross-request generalisation of the microbatch
    pipeline, priced on the same virtual clock.  Indexed by ORIGINAL
    tier/hop ids (merges never renumber)."""

    def __init__(self, num_tiers: int, num_links: int, start: float = 0.0):
        if num_links != num_tiers - 1:
            raise ValueError(
                f"{num_tiers} tiers need {num_tiers - 1} links, "
                f"got {num_links}")
        self.tier_free = [float(start)] * num_tiers
        self.link_free = [float(start)] * num_links

    @property
    def busy_until(self) -> float:
        """Latest committed claim on any tier or link."""
        return max(self.tier_free + self.link_free)


@dataclasses.dataclass(frozen=True)
class ChainInferenceResult:
    """One request's outcome through the N-stage pipeline."""

    logits: torch.Tensor
    cuts: tuple[int, ...]          # cut vector the request finished under
    planned_cuts: tuple[int, ...]  # active plan's cuts when it began
    degraded: bool                 # any merge / re-pick happened
    merged_hops: tuple[int, ...]   # original hop ids collapsed this request
    attempts: int                  # wire attempts across all hops
    chain_elapsed_s: float         # virtual makespan (pipeline schedule)
    wire_bytes: int
    goodput_bytes: int
    microbatches: int              # M actually used (<= batch size)
    events: tuple[Event, ...]
    # per-microbatch completion times on the virtual clock; the serving
    # engine maps one request to one microbatch, so request i's own
    # end-to-end latency is microbatch_finish_s[i], not the batch makespan
    microbatch_finish_s: tuple[float, ...] = ()

    @property
    def retransmitted_bytes(self) -> int:
        return self.wire_bytes - self.goodput_bytes


class _Route:
    """The request's active chain: its stage edges, and the ORIGINAL
    tier id of each stage and hop id of each hop, so the resource model
    and counters survive merges.  A restart builds a new one from a
    plan's edges."""

    __slots__ = ("edges", "tiers", "hops")

    def __init__(self, edges):
        self.edges = list(edges)
        self.tiers = list(range(len(self.edges) - 1))
        self.hops = list(range(len(self.edges) - 2))

    def fold(self, p: int) -> int:
        """Fold stage p + 1 into stage p: the cut between them and the
        tier and hop after it drop out.  Returns the dropped hop's id."""
        del self.edges[p + 1]
        del self.tiers[p + 1]
        return self.hops.pop(p)


@dataclasses.dataclass
class _Request:
    """One request's wire totals and its way down the ladder so far."""

    attempts: int = 0
    retries: int = 0
    wire_bytes: int = 0
    goodput_bytes: int = 0
    merged: tuple[int, ...] = ()              # hop ids folded away
    tried: tuple[tuple[int, ...], ...] = ()   # cut vectors that failed
    repicked: bool = False
    fell_back: bool = False


@dataclasses.dataclass(frozen=True)
class _Failure:
    """A stage or a hop that failed, and the rungs it may take."""

    t: float                  # when, on the virtual clock
    cause: Exception | None   # None: an open breaker turned the stage away
    stage: int                # the failed stage's or hop's route position
    tier: int                 # the tier a failover replaces
    merge_at: int | None      # the stage that may absorb the next one
    repick: bool              # False for a persistent tier failure
    hop: int | None           # the failed hop's id; None for a stage


class ChainRuntime:
    """Executes a ``ChainPlan`` over K tiers and K-1 (possibly faulty)
    links with microbatch pipelining.

    Every hop gets its own ``FaultyLink`` (all on one shared
    ``VirtualClock``) and its own EWMA bandwidth estimator.  The input
    batch is split into M microbatches; hop transfers are scheduled
    against a per-tier / per-link resource model, so microbatch m+1's
    stage-k compute overlaps microbatch m's downstream hops exactly as
    ``core.costs.pipeline_latency`` prices it.  Numerics are
    schedule-independent: each microbatch's samples walk the same layers
    whatever the timing, so concatenated logits stay bit-identical to the
    single-device reference.

    Degradation ladder (six rungs) when a hop exhausts its retries or a
    tier fails a stage (``tier_faults`` crash/shed, open breaker):

    1. **retry** -- the transfer layer's bounded retries with backoff
       (link failures only; a crashed tier is not retried in place).
    2. **stage merge** -- fold the stage across the dead resource onto
       the upstream tier (collapse the cut) if the merged stage fits
       that tier's memory budget; the dead hop/tier drops out of the
       chain for the rest of the request and later microbatches.  For
       K=2 this is exactly the on-device fallback.
    3. **chain re-pick** -- TOPSIS over the plan's cached Pareto front
       under the current per-hop bandwidth estimates
       (``core.multicut.repick_chain``), never repeating a failed cut
       vector; the request restarts its current microbatch from tier 0.
       Skipped for *persistent* tier failures (open breaker, active
       crash window): every cut vector routes through every tier, so a
       re-pick onto the same dead box would be futile.
    4. **tier failover** -- swap the failed tier for its registered
       warm standby (``core.hardware.standby_for``) and re-pick from
       the standby chain's memoised Pareto front
       (``core.smartsplit.cached_chain_plan``) in one TOPSIS pass --
       never an NSGA-II re-run on the recovery path.
    5. **full on-device fallback** -- run the whole model on tier 0
       when it fits the device memory budget.
    6. ``SplitUnrecoverable`` when nothing remains.

    A tier failure takes rungs 2-6.  A hop failure takes rungs 4-5 only
    when the tier-fault layer is active (``tier_faults``/``breakers``
    passed, as the serving engine and the CLI's ``--tier-faults`` do);
    without it (the CLI otherwise, the examples) a dead hop goes merge ->
    re-pick -> unrecoverable.

    microbatches: pipeline depth M (default: REPRO_CHAIN_MICROBATCH env,
      else the plan's own ``microbatches`` field); clamped to the batch.
    merge_fallback: None (default) = merge allowed iff the merged stage
      fits the tier's memory budget; True/False forces the decision.
    wire: per-hop boundary wire formats -- one policy string for every
      hop or a K-1 sequence.  None resolves plan.wire_dtypes if the plan
      carries them, else ``REPRO_LINK{k}_WIRE_DTYPE`` / ``REPRO_WIRE_
      DTYPE`` per hop; ``follow`` ships the storage dtype bit for bit.
      Indexed by ORIGINAL hop id, so merges keep surviving hops' formats.
    resources: optional shared ``ChainResources``.  The serving engine
      passes one (pipelined mode): tier/link next-free times persist
      across requests -- and across every runtime holding the same
      instance -- so back-to-back requests overlap on the pipeline
      exactly like microbatches of one request do (pass
      ``infer(x, at=arrival)``).  The CLI passes none: every request
      starts from a fresh chain.
    estimators: optional shared per-hop EWMA estimator list (the serving
      engine shares one set across its per-bucket runtimes: the hops are
      the same physical links, so bandwidth evidence should pool).
    profile_batch: how many samples ``profile``'s byte/flop terms
      describe.  The serving engine passes 1: it plans per sample and
      dispatches batches of any size, so a microbatch's compute time is
      proportional to its own sample count.  The CLI passes none: the
      profile covers the whole request batch, and each of M microbatches
      costs 1/M of it.
    tier_faults: optional per-tier ``FaultyTier`` models (length K,
      shared virtual clock) vetting every stage execution -- crash
      windows, stragglers, memory-pressure shedding.
    breakers: optional per-tier ``CircuitBreaker`` list gating dispatch;
      auto-built (threshold 3, cooldown 1s) when ``tier_faults`` is
      given.  An open breaker at request start triggers a *proactive*
      failover next to the EWMA-driven proactive re-pick.
    standby: allow rung-4 standby-tier failover (default True).  The
      standby chains' Pareto fronts are prewarmed at construction so the
      failover itself is cache-hit + TOPSIS only.
    """

    def __init__(self, model: str | list, params, plan: ChainPlan,
                 profile: ModelProfile,
                 hw: ChainHardware | TwoTierHardware, *,
                 links: list[FaultyLink] | None = None,
                 policy: RetryPolicy = RetryPolicy(),
                 dtype: str | None = None,
                 wire=None,
                 microbatches: int | None = None,
                 merge_fallback: bool | None = None,
                 estimator_alpha: float = 0.3,
                 resplit_ratio: float = 2.0,
                 jitter_seed: int = 0,
                 resources: ChainResources | None = None,
                 estimators: list[EwmaLinkEstimator] | None = None,
                 profile_batch: int | None = None,
                 tier_faults: list[FaultyTier] | None = None,
                 breakers: list[CircuitBreaker] | None = None,
                 standby: bool = True,
                 log: EventLog | None = None):
        if isinstance(hw, TwoTierHardware):
            hw = chain_of(hw)
        self.layers = cnn_lib.CNN_MODELS[model] if isinstance(model, str) \
            else model
        if profile.num_layers != len(self.layers):
            raise ValueError(
                f"profile has {profile.num_layers} layers, model has "
                f"{len(self.layers)}: plan and runtime would disagree")
        if plan.num_tiers != hw.num_tiers:
            raise ValueError(
                f"plan has {plan.num_tiers} tiers, hardware has "
                f"{hw.num_tiers}")
        self.params = params
        self.plan = plan                     # active (may be re-picked)
        self.profile = profile
        self.hw = hw
        self.links, self.clock = links_and_clock(hw, links)
        self.policy = policy
        self.dtype = dtype
        self._storage = conv_dtype(dtype)
        if wire is None and plan.wire_dtypes:
            wire = plan.wire_dtypes
        self.wire_dtypes = resolve_chain_wire(wire, len(self.links),
                                              self._storage)
        if microbatches is None:
            microbatches = int(os.environ.get("REPRO_CHAIN_MICROBATCH",
                                              plan.microbatches))
        if microbatches < 1:
            raise ValueError(
                f"microbatches must be >= 1, got {microbatches}")
        self.microbatches = microbatches
        self.merge_fallback = merge_fallback
        self.resplit_ratio = float(resplit_ratio)
        if resources is not None and \
                len(resources.link_free) != len(self.links):
            raise ValueError(
                f"resources model {len(resources.link_free)} links, "
                f"chain has {len(self.links)}")
        self.resources = resources
        if profile_batch is not None and profile_batch < 1:
            raise ValueError(
                f"profile_batch must be >= 1, got {profile_batch}")
        self.profile_batch = profile_batch
        if estimators is not None and len(estimators) != len(self.links):
            raise ValueError(
                f"{len(estimators)} estimators for {len(self.links)} links")
        self.estimators = estimators if estimators is not None \
            else chain_estimators(
                [link.bandwidth for link in hw.links], alpha=estimator_alpha)
        self.log = log if log is not None else EventLog()
        self._jitter_rng = np.random.default_rng(jitter_seed)
        self._cm = profile.cum_mem()
        self._cf = profile.cum_flops()
        self.tier_faults, self.breakers = tier_guards(hw, tier_faults,
                                                      breakers, self.log)
        self.standby = bool(standby)
        # The failover / on-device rungs extend the LINK-failure ladder
        # only when the tier-fault layer is active.
        self._protected = self.tier_faults is not None \
            or self.breakers is not None
        if self.standby and self._protected:
            # Prewarm the standby chains' Pareto fronts now (the one
            # place the full planner may run) so a breaker-open failover
            # later is a pure cached-front TOPSIS pass.
            for k in range(hw.num_tiers):
                self._standby_plan(k)
        # aggregate counters (the chaos harness reads these)
        self.n_requests = 0
        self.n_recovered = 0
        self.n_merges = 0
        self.n_repicks = 0
        self.n_proactive = 0
        self.n_failovers = 0
        self.n_fallback_device = 0
        n_hops = len(self.links)
        self.hop_attempts = [0] * n_hops
        self.hop_wire_bytes = [0] * n_hops
        self.hop_goodput_bytes = [0] * n_hops
        self.hop_raw_bytes = [0] * n_hops
        self.hop_merges = [0] * n_hops

    # -- stages --------------------------------------------------------
    def _run(self, x, start: int, stop: int):
        with span("chain/stage"):
            return cnn_lib.apply_cnn(self.layers, self.params, x,
                                     start=start, stop=stop, dtype=self.dtype)

    def _stage_seconds(self, tier_id: int, start: int, stop: int,
                       size: int, M: int) -> float:
        """Compute seconds of layers [start, stop) on a tier for one of M
        microbatches of ``size`` samples (the same cost model the planner
        priced the chain with; ``profile_batch`` says whether the profile
        covers the whole batch or that many samples)."""
        tier = self.hw.tiers[tier_id]
        mem = float(self._cm[stop] - self._cm[start])
        fl = float(self._cf[stop] - self._cf[start])
        whole = float(_tier_compute_time(tier, mem, fl, mem))
        if self.profile_batch is None:
            return whole / M
        return whole * (size / self.profile_batch)

    def _vet(self, route: _Route, s: int, start: int, t_start: float,
             dt: float) -> tuple[float, _Failure | None]:
        """Gate stage ``s`` of ``route`` (layers [start, its stop) from
        ``t_start``, modelled at ``dt`` seconds) through its tier's
        breaker and fault model.  Returns the seconds the stage takes (a
        straggler stretches them) and None, or ``dt`` and the failure."""
        tier_id, stop = route.tiers[s], route.edges[s + 1]
        if self.breakers is not None \
                and not self.breakers[tier_id].allow(t_start):
            return dt, _Failure(t_start, None, s, tier_id, merge_at=None,
                                repick=False, hop=None)
        if self.tier_faults is None:
            return dt, None
        try:
            actual = self.tier_faults[tier_id].execute(
                t_start, dt,
                mem_bytes=float(self._cm[stop] - self._cm[start]))
        except TierError as fail:
            t_fail = t_start + fail.elapsed_s
            kind = ev.TIER_SHED if isinstance(fail, TierShed) \
                else ev.TIER_CRASH
            self.log.emit(kind, t_fail, tier=tier_id, stage=s,
                          error=str(fail))
            if self.breakers is not None:
                self.breakers[tier_id].record_failure(t_fail)
            persistent = isinstance(fail, TierCrash) \
                and self.tier_faults[tier_id].in_crash_window(t_fail)
            return dt, _Failure(t_fail, fail, s, tier_id,
                                merge_at=s - 1 if s > 0 else None,
                                repick=not persistent, hop=None)
        if actual > dt:
            self.log.emit(ev.TIER_SLOW, t_start, tier=tier_id, stage=s,
                          modelled_s=dt, actual_s=actual)
            dt = actual
        if self.breakers is not None:
            self.breakers[tier_id].record_success(t_start + dt)
        return dt, None

    def _count_hop(self, req: _Request, hop_id: int, raw_bytes: int,
                   attempts: int, wire_bytes: int,
                   goodput_bytes: int) -> None:
        req.attempts += attempts
        req.wire_bytes += wire_bytes
        req.goodput_bytes += goodput_bytes
        self.hop_attempts[hop_id] += attempts
        self.hop_wire_bytes[hop_id] += wire_bytes
        self.hop_goodput_bytes[hop_id] += goodput_bytes
        self.hop_raw_bytes[hop_id] += raw_bytes

    # -- the degradation ladder ----------------------------------------
    def _bandwidths(self) -> list[float]:
        return [est.bandwidth for est in self.estimators]

    def _repick(self, exclude: tuple[tuple[int, ...], ...],
                kind: str) -> ChainPlan | None:
        try:
            new = repick_chain(self.plan, self.profile, self.hw,
                               bandwidths=self._bandwidths(),
                               exclude=exclude)
        except ValueError:
            return None
        if kind == ev.PROACTIVE_RESPLIT and new.cuts == self.plan.cuts:
            return None                      # estimate agrees with plan
        self.log.emit(kind, self.clock.now,
                      old_cuts=list(self.plan.cuts),
                      new_cuts=list(new.cuts),
                      est_bandwidths=self._bandwidths(),
                      degradation=max(est.degradation()
                                      for est in self.estimators))
        return new

    def _maybe_proactive_repick(self) -> None:
        if max(est.degradation() for est in self.estimators) \
                < self.resplit_ratio:
            return
        new = self._repick(exclude=(), kind=ev.PROACTIVE_RESPLIT)
        if new is not None:
            self.plan = new
            self.n_proactive += 1

    def _standby_plan(self, tier_id: int):
        """(standby hardware, memoised base plan) for replacing tier
        ``tier_id``, or (None, None) when it has no registered standby.
        First call per chain runs the planner; later calls (the failover
        path) hit ``core.smartsplit``'s plan cache."""
        new_hw = standby_chain(self.hw, tier_id)
        if new_hw is None:
            return None, None
        base = cached_chain_plan(self.profile, new_hw,
                                 microbatches=self.plan.microbatches,
                                 wire=self.wire_dtypes)
        return new_hw, base

    def _failover(self, tier_id: int, t: float) -> ChainPlan | None:
        """Swap tier ``tier_id`` for its warm standby: one TOPSIS pass
        over the standby chain's cached front under the current per-hop
        bandwidth estimates -- never an NSGA-II re-run.  Mutates the
        runtime's hardware/plan/fault state on success; None when no
        standby exists (or standby failover is disabled)."""
        if not self.standby:
            return None
        old = self.hw.tiers[tier_id].name
        new_hw, base = self._standby_plan(tier_id)
        if new_hw is None:
            return None
        try:
            new = repick_chain(base, self.profile, new_hw,
                               bandwidths=self._bandwidths())
        except ValueError:
            return None
        self.hw = new_hw
        self.plan = new
        if self.tier_faults is not None:
            # the standby starts healthy: fault-free model, same clock
            self.tier_faults[tier_id] = FaultyTier(
                new_hw.tiers[tier_id].name, clock=self.clock)
        if self.breakers is not None:
            self.breakers[tier_id].reset()
        self.n_failovers += 1
        self.log.emit(ev.TIER_FAILOVER, t, tier=tier_id, old_tier=old,
                      new_tier=new_hw.tiers[tier_id].name,
                      cuts=list(new.cuts))
        return new

    def _maybe_proactive_failover(self) -> None:
        """An open breaker at request start triggers failover *before*
        dispatch -- the tier-side analogue of the EWMA-driven proactive
        re-pick (don't burn a request against a box known to be down)."""
        if self.breakers is None:
            return
        t = self.clock.now
        for tier_id, br in enumerate(self.breakers):
            if br.state == OPEN and t < br.opened_at + br.cooldown_s:
                if self._failover(tier_id, t) is not None:
                    self.n_proactive += 1

    def _merge_ok(self, tier_id: int, start: int, merged_stop: int) -> bool:
        if self.merge_fallback is not None:
            return self.merge_fallback
        mem = float(self._cm[merged_stop] - self._cm[start])
        return mem <= self.hw.tiers[tier_id].memory_budget

    def _merge(self, route: _Route, req: _Request, f: _Failure) -> bool:
        """Rung 2: fold the stage after ``f.merge_at`` onto that stage's
        tier when the merged stage fits its memory budget.  The tier
        recomputes the folded layers from the boundary it already holds
        (the transfer was bit-exact)."""
        p = f.merge_at
        tier = route.tiers[p]
        cut, merged_stop = route.edges[p + 1], route.edges[p + 2]
        if not self._merge_ok(tier, route.edges[p], merged_stop):
            return False
        hop = route.fold(p)
        extra = {} if f.hop is None else {"attempts": f.cause.attempts}
        self.log.emit(ev.STAGE_MERGE, f.t, hop=hop, tier=tier, cut=cut,
                      merged_stop=merged_stop, **extra)
        self.n_merges += 1
        self.hop_merges[hop] += 1
        req.merged += (hop,)
        return True

    def _fall_back(self, req: _Request, f: _Failure) -> bool:
        """Rung 5: run the whole model on the device tier, once a
        request, when it fits the device's memory budget."""
        fits = float(self._cm[-1]) <= self.hw.tiers[0].memory_budget
        if req.fell_back or not fits:
            return False
        where = {"tier": f.tier, "stage": f.stage} if f.hop is None \
            else {"hop": f.hop}
        self.log.emit(ev.FALLBACK_DEVICE, f.t, **where)
        self.n_fallback_device += 1
        req.fell_back = True
        return True

    def _unrecoverable(self, req: _Request, f: _Failure):
        """Rung 6: log the request's end and raise."""
        tried = [list(c) for c in req.tried]
        if f.hop is None:
            self.log.emit(ev.UNRECOVERABLE, f.t, tier=f.tier, tried=tried)
            msg = (f"tier {f.tier} failed; merge, re-pick, failover and "
                   f"on-device fallback all unavailable")
        else:
            self.log.emit(ev.UNRECOVERABLE, f.t, tried=tried,
                          merged=list(req.merged))
            msg = (f"hop {f.hop} failed; stage merge infeasible and chain "
                   f"Pareto front exhausted (tried {list(req.tried)})")
        raise SplitUnrecoverable(msg) from f.cause

    def _recover(self, route: _Route, req: _Request,
                 f: _Failure) -> _Route | None:
        """Walk the ladder after failure ``f``.  None when a merge folded
        ``route`` in place: the microbatch goes on at stage
        ``f.merge_at`` from the boundary it holds.  Otherwise the route
        on which it restarts from tier 0."""
        if f.merge_at is not None and self._merge(route, req, f):
            return None
        new = None
        if f.repick:
            req.tried += (tuple(self.plan.cuts),)
            new = self._repick(exclude=req.tried, kind=ev.REPICK)
            if new is not None:
                self.plan = new
                self.n_repicks += 1
        if new is None and (f.hop is None or self._protected):
            new = self._failover(f.tier, f.t)
            if new is not None:
                req.tried = ()
            elif self._fall_back(req, f):
                return _Route((0, len(self.layers)))
        if new is None:
            self._unrecoverable(req, f)
        req.repicked = True
        return _Route(new.edges)

    # -- the request loop ----------------------------------------------
    def infer(self, x, *, at: float | None = None) -> ChainInferenceResult:
        """Run one request through the chain (or raise
        SplitUnrecoverable).

        Microbatches are processed in order against the per-tier /
        per-link resource model -- valid because each microbatch only
        waits on its own upstream ops and on earlier microbatches'
        claims of the same resource (FIFO per tier/link), so m-major
        traversal reproduces the chronological schedule.  Fault draws
        happen per hop in microbatch order (deterministic per seed).

        ``at`` schedules the request's arrival on the virtual clock
        (default: now).  With a shared ``ChainResources``, an arrival
        earlier than the previous request's makespan overlaps it --
        the serving engine's cross-request pipelining; stages still
        start no earlier than both the arrival and the tier's previous
        claim, so the schedule stays FIFO-valid per resource."""
        self.n_requests += 1
        mark = len(self.log)
        self._maybe_proactive_repick()
        self._maybe_proactive_failover()
        planned_cuts = self.plan.cuts
        L = len(self.layers)
        t0 = self.clock.now if at is None else float(at)
        slices = microbatch_slices(int(x.shape[0]), self.microbatches)
        M = len(slices)
        if self.resources is None:           # per-request resource model
            tier_free = [t0] * self.hw.num_tiers
            link_free = [t0] * len(self.links)
        else:                                # persists across requests
            tier_free = self.resources.tier_free
            link_free = self.resources.link_free

        route = _Route(self.plan.edges)
        req = _Request()
        outs = []
        mb_finish: list[float] = []
        finish = t0
        for lo, hi in slices:
            x_m = x[lo:hi]
            cur, layer, s, ready = x_m, 0, 0, t0
            while True:
                tier_id, stop = route.tiers[s], route.edges[s + 1]
                t_start = max(tier_free[tier_id], ready)
                dt = self._stage_seconds(tier_id, layer, stop, hi - lo, M)
                failed = None
                if stop > layer:
                    dt, failed = self._vet(route, s, layer, t_start, dt)
                    if failed is None:
                        cur = self._run(cur, layer, stop)
                    else:
                        tier_free[tier_id] = failed.t
                if failed is None:
                    tier_free[tier_id] = ready = t_start + dt
                    layer = stop
                    if layer == L:
                        break
                    hop_id = route.hops[s]
                    w = self.wire_dtypes[hop_id]
                    data, meta = encode_boundary(cur, w)
                    tx = max(link_free[hop_id], ready)
                    if w != self._storage:
                        self.log.emit(ev.WIRE_ENCODE, tx,
                                      what=f"hop{hop_id}@l={layer}", wire=w,
                                      raw_bytes=meta.raw_bytes,
                                      payload_bytes=len(data))
                    try:
                        out = send_with_retry(
                            self.links[hop_id], data, self.policy,
                            rng=self._jitter_rng, log=self.log,
                            what=f"hop{hop_id}@l={layer}", at=tx,
                            framed=meta.framed)
                    except TransferFailed as fail:
                        link_free[hop_id] = tx + fail.elapsed_s
                        req.retries += fail.attempts
                        self._count_hop(req, hop_id, meta.raw_bytes,
                                        fail.attempts, fail.wire_bytes, 0)
                        self.estimators[hop_id].observe(0.0, fail.elapsed_s)
                        failed = _Failure(tx + fail.elapsed_s, fail, s,
                                          route.tiers[s + 1], merge_at=s,
                                          repick=True, hop=hop_id)
                    else:
                        link_free[hop_id] = ready = tx + out.elapsed_s
                        req.retries += out.attempts - 1
                        self._count_hop(req, hop_id, meta.raw_bytes,
                                        out.attempts, out.wire_bytes,
                                        out.goodput_bytes)
                        self.estimators[hop_id].observe(
                            out.goodput_bytes, out.success_elapsed_s)
                        cur = decode_boundary(out.payload, meta)
                        s += 1
                        continue
                ready = failed.t
                new = self._recover(route, req, failed)
                if new is None:          # merged: go on upstream
                    s = failed.merge_at
                else:                    # restart from tier 0
                    route, cur, layer, s = new, x_m, 0, 0
            outs.append(cur)
            mb_finish.append(ready)
            finish = max(finish, ready)
        self.clock.advance_to(finish)
        logits = outs[0] if M == 1 else torch.cat(outs, dim=0)
        degraded = bool(req.merged) or req.repicked or req.fell_back
        if degraded or req.retries:
            self.n_recovered += 1
        return ChainInferenceResult(
            logits=logits, cuts=tuple(route.edges[1:-1]),
            planned_cuts=planned_cuts, degraded=degraded,
            merged_hops=req.merged, attempts=req.attempts,
            chain_elapsed_s=finish - t0, wire_bytes=req.wire_bytes,
            goodput_bytes=req.goodput_bytes, microbatches=M,
            events=tuple(self.log.since(mark)),
            microbatch_finish_s=tuple(mb_finish))

    # -- reporting ------------------------------------------------------
    def stats(self) -> dict:
        """Aggregate counters + per-hop counters + event histogram."""
        return {
            "requests": self.n_requests,
            "recovered": self.n_recovered,
            "merges": self.n_merges,
            "repicks": self.n_repicks,
            "proactive_resplits": self.n_proactive,
            "failovers": self.n_failovers,
            "fallback_device": self.n_fallback_device,
            "active_cuts": list(self.plan.cuts),
            "active_tiers": [t.name for t in self.hw.tiers],
            "microbatches": self.microbatches,
            "tiers": None if self.tier_faults is None else
                [ft.counters() for ft in self.tier_faults],
            "breakers": None if self.breakers is None else
                [br.counters() for br in self.breakers],
            "hops": [hop_stats([self], k, self.wire_dtypes[k],
                               self.estimators[k], self.links[k])
                     for k in range(len(self.links))],
            "events": self.log.counts(),
        }
