"""Fault-tolerant split-execution runtime (the PyTorch port of
``repro.runtime.runtime``; the control flow is the same line for line,
only the tensor touch points differ).

``models.cnn.apply_split`` assumes the client->server link never fails;
``SplitRuntime`` wraps the same client/boundary/server walk in a recovery
loop so one link hiccup no longer hangs the "optimal" split:

1. client stage runs layers [0, l1) exactly as ``apply_split`` would;
2. the boundary payload crosses a ``FaultyLink`` through the reliable
   transfer layer (crc32 + per-attempt timeout + bounded retries with
   exponential backoff, see runtime/transfer.py);
3. on success the server stage runs [l1, L) on the delivered (verified,
   bit-identical) payload;
4. on retry exhaustion the runtime degrades *gracefully*: if the client
   memory budget admits the whole model it continues from the boundary
   activation on-device (bit-identical logits, latency paid instead of an
   error); otherwise it re-picks the next-best feasible split from the
   plan's cached Pareto front via TOPSIS with link-weight re-weighting
   (``core.smartsplit.repick_split`` -- microseconds, no GA re-run) and
   tries again, never repeating a failed split index.

An EWMA estimator (runtime/link_estimator.py) folds every observed
transfer into an effective-bandwidth estimate; sustained degradation
triggers a *proactive* re-split at the next request instead of burning
retries against a link the runtime already knows is bad.  Every recovery
action lands in the structured ``EventLog`` -- the invariant tests and
the chaos harness (benchmarks/robustness_bench.py) both key on it.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.chainplan import ChainPlan
from repro_torch.core.costs import (ModelProfile, _tier_compute_time,
                              resolve_chain_wire)
from repro_torch.core.dtype_policy import conv_dtype, resolve_wire_dtype
from repro_torch.core.hardware import (ChainHardware, NetworkState,
                                 TwoTierHardware, chain_of, standby_chain,
                                 standby_for)
from repro_torch.core.multicut import repick_chain
from repro_torch.core.smartsplit import (SplitPlan, cached_chain_plan,
                                   repick_split)
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
from repro_torch.runtime.wire import (decode_boundary, encode_boundary,
                                      host_bytes, tensor_from_bytes)
from repro_torch.spans import span


class SplitUnrecoverable(RuntimeError):
    """Transfer failed, on-device fallback infeasible, Pareto front
    exhausted: the request cannot complete."""


@dataclasses.dataclass(frozen=True)
class InferenceResult:
    """One request's outcome + the recovery evidence behind it."""

    logits: torch.Tensor
    split_index: int             # split that actually produced the logits
    planned_split: int           # active plan's split when the request began
    degraded: bool               # any fallback / re-pick happened
    on_device: bool              # completed without the server stage
    attempts: int                # wire attempts across all splits tried
    link_elapsed_s: float        # virtual link time (transfers + backoff)
    wire_bytes: int              # bytes put on the wire (incl. retransmits)
    goodput_bytes: int           # useful bytes delivered
    events: tuple[Event, ...]    # this request's slice of the event log

    @property
    def retransmitted_bytes(self) -> int:
        return self.wire_bytes - self.goodput_bytes


class SplitRuntime:
    """Executes a ``SplitPlan`` for one CNN over a (possibly faulty) link.

    model: a name from ``cnn.CNN_MODELS`` or an explicit layer list.
    params: the layer parameters (``cnn.init_cnn``).
    plan: the optimiser's pick, with its cached Pareto front.
    profile: the ``ModelProfile`` the plan was computed from (same dtype
      policy and input shape -- re-pick feasibility is judged against it).
    hw: the planning environment (client memory budget, nominal link).
    link: the channel to execute against (default: a fault-free
      ``FaultyLink`` at the plan's nominal bandwidth).
    policy: transfer-layer retry/timeout/backoff knobs.
    device_fallback: None (default) = allowed iff the whole model fits the
      client memory budget; True/False forces the decision (benches use
      False to exercise the re-pick path on roomy clients).
    resplit_ratio: proactive re-split trigger -- re-pick before the next
      request once planned/estimated bandwidth exceeds this.
    wire: boundary wire format (``fp32``/``bf16``/``int8``/``follow``).
      None resolves plan.wire_dtypes[0] if the plan carries one, else the
      ``REPRO_LINK0_WIRE_DTYPE`` / ``REPRO_WIRE_DTYPE`` env; ``follow``
      (the default everywhere) ships the storage dtype -- the legacy
      bit-identical path.
    """

    def __init__(self, model: str | list, params, plan: SplitPlan,
                 profile: ModelProfile, hw: TwoTierHardware, *,
                 link: FaultyLink | None = None,
                 policy: RetryPolicy = RetryPolicy(),
                 dtype: str | None = None,
                 wire: str | None = None,
                 device_fallback: bool | None = None,
                 estimator_alpha: float = 0.3,
                 resplit_ratio: float = 2.0,
                 jitter_seed: int = 0,
                 tier_faults: list[FaultyTier] | None = None,
                 breakers: list[CircuitBreaker] | None = None,
                 standby: bool = True,
                 log: EventLog | None = None):
        self.layers = cnn_lib.CNN_MODELS[model] if isinstance(model, str) \
            else model
        if profile.num_layers != len(self.layers):
            raise ValueError(
                f"profile has {profile.num_layers} layers, model has "
                f"{len(self.layers)}: plan and runtime would disagree")
        self.params = params
        self.plan = plan                     # active (may be re-picked)
        self.profile = profile
        self.hw = hw
        self.link = link if link is not None \
            else FaultyLink(hw.link.bandwidth)
        self.policy = policy
        self.dtype = dtype
        self._storage = conv_dtype(dtype)
        if wire is None and plan.wire_dtypes:
            wire = plan.wire_dtypes[0]
        self.wire = resolve_wire_dtype(wire, storage=self._storage, hop=0)
        self.device_fallback = device_fallback
        self.resplit_ratio = float(resplit_ratio)
        self.estimator = EwmaLinkEstimator(hw.link.bandwidth,
                                           alpha=estimator_alpha)
        self.net = NetworkState(hw.link)
        self.log = log if log is not None else EventLog()
        self._jitter_rng = np.random.default_rng(jitter_seed)
        if tier_faults is not None and len(tier_faults) != 2:
            raise ValueError(
                f"SplitRuntime takes 2 tier-fault models (client, "
                f"server), got {len(tier_faults)}")
        self.tier_faults = tier_faults
        if breakers is None and tier_faults is not None:
            breakers = tier_breakers([hw.client.name, hw.server.name],
                                     log=self.log)
        if breakers is not None and len(breakers) != 2:
            raise ValueError(
                f"SplitRuntime takes 2 breakers, got {len(breakers)}")
        self.breakers = breakers
        self.standby = bool(standby)
        self._cm = profile.cum_mem()
        # aggregate counters (the chaos harness reads these)
        self.n_requests = 0
        self.n_recovered = 0        # completed despite >= 1 failed attempt
        self.n_fallback_device = 0
        self.n_repicks = 0
        self.n_proactive = 0
        self.n_failovers = 0
        # per-hop transfer counters (one hop here; the chain runtime has
        # K-1 -- same stats schema so the chaos artifact can always say
        # *which* hop degraded)
        self.hop_attempts = 0
        self.hop_wire_bytes = 0
        self.hop_goodput_bytes = 0
        self.hop_raw_bytes = 0      # storage-dtype size of sent boundaries

    # -- stages --------------------------------------------------------
    def _run(self, x, start: int, stop: int):
        return cnn_lib.apply_cnn(self.layers, self.params, x, start=start,
                                 stop=stop, dtype=self.dtype)

    @staticmethod
    def _serialize(arr: torch.Tensor) -> tuple[bytes, torch.Tensor]:
        return host_bytes(arr), arr

    @staticmethod
    def _deserialize(data: bytes, like: torch.Tensor) -> torch.Tensor:
        return tensor_from_bytes(data, like.dtype, like.shape, like.device)

    # -- degradation helpers -------------------------------------------
    def _device_ok(self) -> bool:
        if self.device_fallback is not None:
            return self.device_fallback
        full_mem = float(self.profile.cum_mem()[-1])
        return full_mem <= self.hw.client.memory_budget

    def _repick(self, exclude: tuple[int, ...],
                kind: str) -> SplitPlan | None:
        """Next-best feasible split under the current bandwidth estimate;
        None when the front is exhausted."""
        try:
            new = repick_split(self.plan, self.profile, self.hw,
                               bandwidth=self.estimator.bandwidth,
                               exclude=exclude)
        except ValueError:
            return None
        if kind == ev.PROACTIVE_RESPLIT and \
                new.split_index == self.plan.split_index:
            return None                      # estimate agrees with plan
        self.log.emit(kind, self.link.clock,
                      old_split=self.plan.split_index,
                      new_split=new.split_index,
                      est_bandwidth=self.estimator.bandwidth,
                      degradation=self.estimator.degradation())
        return new

    def _maybe_proactive_resplit(self) -> None:
        if self.estimator.degradation() < self.resplit_ratio:
            return
        new = self._repick(exclude=(), kind=ev.PROACTIVE_RESPLIT)
        if new is not None:
            self.plan = new
            self.n_proactive += 1

    def _vet_server(self, l1: int):
        """Breaker-gate + fault-vet the server stage for one request.

        None = healthy (dispatch).  Otherwise ``(transient, cause)`` for
        the degradation ladder: ``transient`` False means the tier is
        known-down (open breaker, active crash window) and a cut re-pick
        onto the same box would be futile."""
        t = self.link.clock
        if self.breakers is not None and not self.breakers[1].allow(t):
            return False, "breaker_open"
        if self.tier_faults is None:
            return None
        ft = self.tier_faults[1]
        mem = float(self._cm[-1] - self._cm[l1])
        try:
            # compute_s=0: SplitRuntime's clock accounts link time only,
            # so the model vets (crash / shed) without stretching time.
            ft.execute(t, 0.0, mem_bytes=mem)
        except TierError as fail:
            kind = ev.TIER_SHED if isinstance(fail, TierShed) \
                else ev.TIER_CRASH
            self.log.emit(kind, t, tier=1, split=l1, error=str(fail))
            if self.breakers is not None:
                self.breakers[1].record_failure(t)
            transient = not (isinstance(fail, TierCrash)
                             and ft.in_crash_window(t))
            return transient, kind
        if self.breakers is not None:
            self.breakers[1].record_success(t)
        return None

    def _tier_failover(self) -> SplitPlan | None:
        """Swap the server for its warm standby and TOPSIS re-pick over
        the plan's cached front (never a GA re-run); None when disabled
        or no standby is registered for the current server."""
        if not self.standby:
            return None
        spare = standby_for(self.hw.server)
        if spare is None:
            return None
        old = self.hw.server.name
        hw = dataclasses.replace(self.hw, server=spare)
        try:
            new = repick_split(self.plan, self.profile, hw,
                               bandwidth=self.estimator.bandwidth)
        except ValueError:
            return None
        self.hw = hw
        if self.tier_faults is not None:
            self.tier_faults[1] = FaultyTier(spare.name)
        if self.breakers is not None:
            self.breakers[1].reset()
        self.n_failovers += 1
        self.log.emit(ev.TIER_FAILOVER, self.link.clock, tier=1,
                      old_tier=old, new_tier=spare.name,
                      new_split=new.split_index)
        return new

    # -- the request loop ----------------------------------------------
    def infer(self, x) -> InferenceResult:
        """Run one request to completion (or raise SplitUnrecoverable).

        The returned logits are bit-identical to the fault-free
        ``apply_split`` run whenever the executed split equals the planned
        one (clean transfer after any retries, or on-device continuation);
        a re-picked split is a *different* placement of the same exact
        computation -- still the fault-free logits of that split."""
        self.n_requests += 1
        mark = len(self.log)
        self._maybe_proactive_resplit()
        planned = self.plan.split_index
        L = len(self.layers)
        attempts = 0
        wire = goodput = 0
        t0 = self.link.clock
        tried: tuple[int, ...] = ()
        tier_degraded = False
        l1 = planned
        while True:
            boundary = self._run(x, 0, l1)
            if l1 == L:                      # everything on the client
                logits = boundary
                on_device = True
                break
            data, meta = encode_boundary(boundary, self.wire)
            if self.wire != self._storage:
                self.log.emit(ev.WIRE_ENCODE, self.link.clock,
                              what=f"boundary@l1={l1}", wire=self.wire,
                              raw_bytes=meta.raw_bytes,
                              payload_bytes=len(data))
            try:
                out = send_with_retry(self.link, data, self.policy,
                                      rng=self._jitter_rng, log=self.log,
                                      what=f"boundary@l1={l1}",
                                      framed=meta.framed)
                attempts += out.attempts
                wire += out.wire_bytes
                goodput += out.goodput_bytes
                self.hop_attempts += out.attempts
                self.hop_wire_bytes += out.wire_bytes
                self.hop_goodput_bytes += out.goodput_bytes
                self.hop_raw_bytes += meta.raw_bytes
                self.estimator.observe(out.goodput_bytes,
                                       out.success_elapsed_s)
                self.net.update(self.estimator.bandwidth)
                verdict = self._vet_server(l1)
                if verdict is None:
                    logits = self._run(
                        decode_boundary(out.payload, meta), l1, L)
                    on_device = False
                    break
                # Server-tier degradation ladder: re-pick (transient
                # failures only) -> standby failover -> on-device
                # fallback -> give up.
                tier_degraded = True
                tried = tried + (l1,)
                transient, cause = verdict
                if transient:
                    new = self._repick(exclude=tried, kind=ev.REPICK)
                    if new is not None:
                        self.plan = new
                        self.n_repicks += 1
                        l1 = new.split_index
                        continue
                new = self._tier_failover()
                if new is not None:
                    self.plan = new
                    l1 = new.split_index
                    tried = ()
                    continue
                if self._device_ok():
                    self.log.emit(ev.FALLBACK_DEVICE, self.link.clock,
                                  split=l1, cause=cause)
                    self.n_fallback_device += 1
                    logits = self._run(boundary, l1, L)
                    on_device = True
                    break
                self.log.emit(ev.UNRECOVERABLE, self.link.clock,
                              tried=list(tried), cause=cause)
                raise SplitUnrecoverable(
                    f"server tier failed ({cause}); no standby, "
                    f"on-device fallback infeasible and Pareto front "
                    f"exhausted")
            except TransferFailed as fail:
                attempts += fail.attempts
                wire += fail.wire_bytes
                self.hop_attempts += fail.attempts
                self.hop_wire_bytes += fail.wire_bytes
                self.hop_raw_bytes += meta.raw_bytes
                # the link burned fail.elapsed_s and delivered nothing
                self.estimator.observe(0.0, fail.elapsed_s)
                self.net.update(self.estimator.bandwidth, outage=True)
                tried = tried + (l1,)
                if self._device_ok():
                    self.log.emit(ev.FALLBACK_DEVICE, self.link.clock,
                                  split=l1, attempts=fail.attempts)
                    self.n_fallback_device += 1
                    logits = self._run(boundary, l1, L)
                    on_device = True
                    break
                new = self._repick(exclude=tried, kind=ev.REPICK)
                if new is None:
                    self.log.emit(ev.UNRECOVERABLE, self.link.clock,
                                  tried=list(tried))
                    raise SplitUnrecoverable(
                        f"transfer failed at splits {list(tried)}; "
                        f"on-device fallback infeasible and Pareto front "
                        f"exhausted") from fail
                self.plan = new
                self.n_repicks += 1
                l1 = new.split_index
        self.net.update(self.estimator.bandwidth, outage=False)
        degraded = bool(tried) or l1 != planned or tier_degraded
        if degraded or attempts > 1:
            self.n_recovered += 1
        return InferenceResult(
            logits=logits, split_index=l1, planned_split=planned,
            degraded=degraded, on_device=on_device, attempts=attempts,
            link_elapsed_s=self.link.clock - t0, wire_bytes=wire,
            goodput_bytes=goodput,
            events=tuple(self.log.since(mark)))

    # -- reporting ------------------------------------------------------
    def stats(self) -> dict:
        """Aggregate counters + link counters + event-kind histogram."""
        return {
            "requests": self.n_requests,
            "recovered": self.n_recovered,
            "fallback_device": self.n_fallback_device,
            "repicks": self.n_repicks,
            "proactive_resplits": self.n_proactive,
            "failovers": self.n_failovers,
            "active_split": self.plan.split_index,
            "est_bandwidth": self.estimator.bandwidth,
            "degradation": self.estimator.degradation(),
            "link": self.link.counters(),
            "tiers": None if self.tier_faults is None else
                [ft.counters() for ft in self.tier_faults],
            "breakers": None if self.breakers is None else
                [br.counters() for br in self.breakers],
            "hops": [{
                "hop": 0,
                "wire_dtype": self.wire,
                "attempts": self.hop_attempts,
                "wire_bytes": self.hop_wire_bytes,
                "goodput_bytes": self.hop_goodput_bytes,
                "raw_bytes": self.hop_raw_bytes,
                "retransmitted_bytes": (self.hop_wire_bytes
                                        - self.hop_goodput_bytes),
                "est_bandwidth": self.estimator.bandwidth,
                "degradation": self.estimator.degradation(),
                "link": self.link.counters(),
            }],
            "events": self.log.counts(),
        }


# ---------------------------------------------------------------------------
# N-tier chain execution
# ---------------------------------------------------------------------------
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


class ChainResources:
    """Persistent per-tier / per-link next-free times on the virtual
    clock, shared across requests (and across the per-bucket runtimes of
    a serving engine).

    ``ChainRuntime.infer`` normally resets its resource model per
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


class ChainRuntime:
    """Executes a ``ChainPlan`` over K tiers and K-1 (possibly faulty)
    links with microbatch pipelining.

    The generalisation of ``SplitRuntime``: every hop gets its own
    ``FaultyLink`` (all on one shared ``VirtualClock``) and its own EWMA
    bandwidth estimator.  The input batch is split into M microbatches;
    hop transfers are scheduled against a per-tier / per-link resource
    model, so microbatch m+1's stage-k compute overlaps microbatch m's
    downstream hops exactly as ``core.costs.pipeline_latency`` prices it.
    Numerics are schedule-independent: each microbatch's samples walk the
    same layers whatever the timing, so concatenated logits stay
    bit-identical to the single-device reference.

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

    Rungs 4-5 extend the link-failure ladder only when the tier-fault
    layer is active (``tier_faults``/``breakers`` passed); unprotected
    runtimes keep the legacy merge -> re-pick -> unrecoverable contract.

    microbatches: pipeline depth M (default: REPRO_CHAIN_MICROBATCH env,
      else the plan's own ``microbatches`` field); clamped to the batch.
    merge_fallback: None (default) = merge allowed iff the merged stage
      fits the tier's memory budget; True/False forces the decision.
    wire: per-hop boundary wire formats -- one policy string for every
      hop or a K-1 sequence.  None resolves plan.wire_dtypes if the plan
      carries them, else ``REPRO_LINK{k}_WIRE_DTYPE`` / ``REPRO_WIRE_
      DTYPE`` per hop; ``follow`` ships the storage dtype (legacy path).
      Indexed by ORIGINAL hop id, so merges keep surviving hops' formats.
    resources: optional shared ``ChainResources``.  Default None keeps
      the legacy per-request resource model (every request starts from a
      fresh chain).  With an instance, tier/link next-free times persist
      across requests -- and across every runtime holding the same
      instance -- so back-to-back requests overlap on the pipeline
      exactly like microbatches of one request do (the serving engine's
      cross-request pipelining; pass ``infer(x, at=arrival)``).
    estimators: optional shared per-hop EWMA estimator list (the serving
      engine shares one set across its per-bucket runtimes: the hops are
      the same physical links, so bandwidth evidence should pool).
    profile_batch: how many samples ``profile``'s byte/flop terms
      describe.  Default None keeps the legacy rule (the profile covers
      the whole request batch; each of M microbatches costs 1/M of it);
      an explicit value makes microbatch compute time proportional to
      the slice's own sample count -- a per-sample profile
      (``profile_batch=1``) then prices variable-size batches correctly.
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
        self.links = links
        self.clock = clock
        self.policy = policy
        self.dtype = dtype
        self._storage = conv_dtype(dtype)
        if wire is None and plan.wire_dtypes:
            wire = plan.wire_dtypes
        self.wire_dtypes = resolve_chain_wire(wire, len(links),
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
        if tier_faults is not None and len(tier_faults) != hw.num_tiers:
            raise ValueError(
                f"{hw.num_tiers} tiers need {hw.num_tiers} tier-fault "
                f"models, got {len(tier_faults)}")
        self.tier_faults = tier_faults
        if breakers is None and tier_faults is not None:
            breakers = tier_breakers([t.name for t in hw.tiers],
                                     log=self.log)
        if breakers is not None and len(breakers) != hw.num_tiers:
            raise ValueError(
                f"{hw.num_tiers} tiers need {hw.num_tiers} breakers, "
                f"got {len(breakers)}")
        self.breakers = breakers
        self.standby = bool(standby)
        # The failover / on-device rungs extend the LINK-failure ladder
        # only when the tier-fault layer is active: an unprotected
        # runtime keeps the legacy merge -> re-pick -> unrecoverable
        # contract.
        self._protected = tier_faults is not None or breakers is not None
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

    def _stage_seconds(self, tier_id: int, start: int, stop: int) -> float:
        """Whole-batch compute seconds for layers [start, stop) on a tier
        (the same cost model the planner priced the chain with)."""
        tier = self.hw.tiers[tier_id]
        mem = float(self._cm[stop] - self._cm[start])
        fl = float(self._cf[stop] - self._cf[start])
        return float(_tier_compute_time(tier, mem, fl, mem))

    # -- degradation helpers -------------------------------------------
    def _merge_ok(self, tier_id: int, start: int, merged_stop: int) -> bool:
        if self.merge_fallback is not None:
            return self.merge_fallback
        mem = float(self._cm[merged_stop] - self._cm[start])
        return mem <= self.hw.tiers[tier_id].memory_budget

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

    def _device_fallback_ok(self) -> bool:
        """May the whole model run on the device tier (ladder rung 5)?"""
        return float(self._cm[-1]) <= self.hw.tiers[0].memory_budget

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
        batch = int(x.shape[0])
        slices = microbatch_slices(batch, self.microbatches)
        M = len(slices)

        # Active chain structure, keyed to ORIGINAL tier/hop ids so the
        # resource model and counters survive merges.
        edges = list(self.plan.edges)
        tiers = list(range(len(edges) - 1))
        hops = list(range(len(edges) - 2))
        if self.resources is None:           # per-request resource model
            tier_free = [t0] * self.hw.num_tiers
            link_free = [t0] * len(self.links)
        else:                                # persists across requests
            tier_free = self.resources.tier_free
            link_free = self.resources.link_free

        attempts = 0
        retries = 0
        wire = goodput = 0
        merged: tuple[int, ...] = ()
        tried: tuple[tuple[int, ...], ...] = ()
        repicked = False
        fell_back = False
        outs = []
        mb_finish: list[float] = []
        finish = t0
        for m in range(M):
            x_m = x[slices[m][0]:slices[m][1]]
            cur = x_m
            layer = 0
            s = 0
            ready = t0
            while True:
                tier_id = tiers[s]
                stop = edges[s + 1]
                t_start = max(tier_free[tier_id], ready)
                # Legacy: the profile describes the WHOLE batch, so each
                # of the M microbatches costs 1/M of it.  A serving
                # engine plans per sample (profile_batch=1) and then
                # dispatches variable-size batches, so its microbatch
                # cost scales with the slice's own sample count instead.
                if self.profile_batch is None:
                    dt = self._stage_seconds(tier_id, layer, stop) / M
                else:
                    size = slices[m][1] - slices[m][0]
                    dt = self._stage_seconds(tier_id, layer, stop) \
                        * (size / self.profile_batch)
                # Breaker gate + tier-fault vetting before the stage runs.
                tier_fail: TierError | None = None
                rejected = False
                if stop > layer and self.breakers is not None \
                        and not self.breakers[tier_id].allow(t_start):
                    rejected = True
                    t_fail = t_start
                elif stop > layer and self.tier_faults is not None:
                    try:
                        actual = self.tier_faults[tier_id].execute(
                            t_start, dt,
                            mem_bytes=float(self._cm[stop]
                                            - self._cm[layer]))
                        if actual > dt:
                            self.log.emit(ev.TIER_SLOW, t_start,
                                          tier=tier_id, stage=s,
                                          modelled_s=dt, actual_s=actual)
                            dt = actual
                        if self.breakers is not None:
                            self.breakers[tier_id].record_success(
                                t_start + dt)
                    except TierError as fail:
                        tier_fail = fail
                        t_fail = t_start + fail.elapsed_s
                if rejected or tier_fail is not None:
                    # Tier-failure ladder: upstream stage merge ->
                    # cached-front re-pick (transient failures only) ->
                    # standby failover -> on-device fallback -> give up.
                    tier_free[tier_id] = t_fail
                    ready = t_fail
                    persistent = rejected
                    if tier_fail is not None:
                        kind = ev.TIER_SHED \
                            if isinstance(tier_fail, TierShed) \
                            else ev.TIER_CRASH
                        self.log.emit(kind, t_fail, tier=tier_id,
                                      stage=s, error=str(tier_fail))
                        if self.breakers is not None:
                            self.breakers[tier_id].record_failure(t_fail)
                        persistent = isinstance(tier_fail, TierCrash) \
                            and self.tier_faults[tier_id] \
                            .in_crash_window(t_fail)
                    if not rejected and s > 0 and \
                            self._merge_ok(tiers[s - 1], edges[s - 1],
                                           edges[s + 1]):
                        # Fold the failed stage back onto the upstream
                        # tier: it recomputes [layer, stop) from the
                        # boundary it already holds (the transfer was
                        # bit-exact), and the dead tier drops out of
                        # the chain for the rest of the request.
                        dead_hop = hops[s - 1]
                        self.log.emit(ev.STAGE_MERGE, t_fail,
                                      hop=dead_hop, tier=tiers[s - 1],
                                      cut=edges[s],
                                      merged_stop=edges[s + 1])
                        self.n_merges += 1
                        self.hop_merges[dead_hop] += 1
                        merged = merged + (dead_hop,)
                        del edges[s]
                        del tiers[s]
                        del hops[s - 1]
                        s -= 1
                        continue
                    if not persistent:
                        tried = tried + (tuple(self.plan.cuts),)
                        new = self._repick(exclude=tried, kind=ev.REPICK)
                        if new is not None:
                            self.plan = new
                            self.n_repicks += 1
                            repicked = True
                            edges = list(new.edges)
                            tiers = list(range(len(edges) - 1))
                            hops = list(range(len(edges) - 2))
                            cur = x_m
                            layer = 0
                            s = 0
                            ready = t_fail
                            continue
                    new = self._failover(tier_id, t_fail)
                    if new is not None:
                        repicked = True
                        tried = ()
                        edges = list(new.edges)
                        tiers = list(range(len(edges) - 1))
                        hops = list(range(len(edges) - 2))
                        cur = x_m
                        layer = 0
                        s = 0
                        ready = t_fail
                        continue
                    if not fell_back and self._device_fallback_ok():
                        self.log.emit(ev.FALLBACK_DEVICE, t_fail,
                                      tier=tier_id, stage=s)
                        self.n_fallback_device += 1
                        fell_back = True
                        edges = [0, L]
                        tiers = [0]
                        hops = []
                        cur = x_m
                        layer = 0
                        s = 0
                        ready = t_fail
                        continue
                    self.log.emit(ev.UNRECOVERABLE, t_fail, tier=tier_id,
                                  tried=[list(c) for c in tried])
                    raise SplitUnrecoverable(
                        f"tier {tier_id} failed; merge, re-pick, "
                        f"failover and on-device fallback all "
                        f"unavailable") from tier_fail
                if stop > layer:
                    cur = self._run(cur, layer, stop)
                tier_free[tier_id] = t_start + dt
                ready = t_start + dt
                layer = stop
                if layer == L:
                    break
                hop_id = hops[s]
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
                    link_free[hop_id] = tx + out.elapsed_s
                    ready = tx + out.elapsed_s
                    attempts += out.attempts
                    retries += out.attempts - 1
                    wire += out.wire_bytes
                    goodput += out.goodput_bytes
                    self.hop_attempts[hop_id] += out.attempts
                    self.hop_wire_bytes[hop_id] += out.wire_bytes
                    self.hop_goodput_bytes[hop_id] += out.goodput_bytes
                    self.hop_raw_bytes[hop_id] += meta.raw_bytes
                    self.estimators[hop_id].observe(out.goodput_bytes,
                                                    out.success_elapsed_s)
                    cur = decode_boundary(out.payload, meta)
                    s += 1
                except TransferFailed as fail:
                    t_fail = tx + fail.elapsed_s
                    link_free[hop_id] = t_fail
                    ready = t_fail
                    attempts += fail.attempts
                    retries += fail.attempts
                    wire += fail.wire_bytes
                    self.hop_attempts[hop_id] += fail.attempts
                    self.hop_wire_bytes[hop_id] += fail.wire_bytes
                    self.hop_raw_bytes[hop_id] += meta.raw_bytes
                    self.estimators[hop_id].observe(0.0, fail.elapsed_s)
                    if self._merge_ok(tier_id, edges[s], edges[s + 2]):
                        self.log.emit(ev.STAGE_MERGE, t_fail,
                                      hop=hop_id, tier=tier_id,
                                      cut=edges[s + 1],
                                      merged_stop=edges[s + 2],
                                      attempts=fail.attempts)
                        self.n_merges += 1
                        self.hop_merges[hop_id] += 1
                        merged = merged + (hop_id,)
                        del edges[s + 1]
                        del tiers[s + 1]
                        del hops[s]
                        # stay on stage s: the loop's next pass computes
                        # the folded layers [layer, new stop) on this tier
                        continue
                    tried = tried + (tuple(self.plan.cuts),)
                    new = self._repick(exclude=tried, kind=ev.REPICK)
                    if new is None and self._protected:
                        # ladder rungs 4/5 (tier-fault deployments):
                        # fail the dead hop's downstream tier over to
                        # its standby, else run fully on the device
                        new = self._failover(tiers[s + 1], t_fail)
                        if new is not None:
                            tried = ()
                        elif not fell_back and self._device_fallback_ok():
                            self.log.emit(ev.FALLBACK_DEVICE, t_fail,
                                          hop=hop_id)
                            self.n_fallback_device += 1
                            fell_back = True
                            edges = [0, L]
                            tiers = [0]
                            hops = []
                            cur = x_m
                            layer = 0
                            s = 0
                            ready = t_fail
                            continue
                    elif new is not None:
                        self.plan = new
                        self.n_repicks += 1
                    if new is None:
                        self.log.emit(ev.UNRECOVERABLE, t_fail,
                                      tried=[list(c) for c in tried],
                                      merged=list(merged))
                        raise SplitUnrecoverable(
                            f"hop {hop_id} failed; stage merge infeasible "
                            f"and chain Pareto front exhausted "
                            f"(tried {list(tried)})") from fail
                    repicked = True
                    # restart this microbatch from tier 0 on the new cuts
                    edges = list(new.edges)
                    tiers = list(range(len(edges) - 1))
                    hops = list(range(len(edges) - 2))
                    cur = x_m
                    layer = 0
                    s = 0
                    ready = t_fail
            outs.append(cur)
            mb_finish.append(ready)
            finish = max(finish, ready)
        self.clock.advance_to(finish)
        logits = outs[0] if M == 1 else torch.cat(outs, dim=0)
        degraded = bool(merged) or repicked or fell_back
        if degraded or retries:
            self.n_recovered += 1
        return ChainInferenceResult(
            logits=logits, cuts=tuple(edges[1:-1]),
            planned_cuts=planned_cuts, degraded=degraded,
            merged_hops=merged, attempts=attempts,
            chain_elapsed_s=finish - t0, wire_bytes=wire,
            goodput_bytes=goodput, microbatches=M,
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
            "hops": [{
                "hop": k,
                "wire_dtype": self.wire_dtypes[k],
                "attempts": self.hop_attempts[k],
                "wire_bytes": self.hop_wire_bytes[k],
                "goodput_bytes": self.hop_goodput_bytes[k],
                "raw_bytes": self.hop_raw_bytes[k],
                "retransmitted_bytes": (self.hop_wire_bytes[k]
                                        - self.hop_goodput_bytes[k]),
                "merges": self.hop_merges[k],
                "est_bandwidth": self.estimators[k].bandwidth,
                "degradation": self.estimators[k].degradation(),
                "link": self.links[k].counters(),
            } for k in range(len(self.links))],
            "events": self.log.counts(),
        }
