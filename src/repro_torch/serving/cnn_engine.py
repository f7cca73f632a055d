"""Batched CNN split-serving engine (the paper's workload, under load):
the PyTorch port of ``repro.serving.cnn_engine``.  The control flow is the
same line for line; the tensors are torch tensors on the engine's device
(``device="cuda"`` by default, raising without a card), whose type picks
the kernels, so the engine takes no ``backend``.

``serving.engine.Engine`` batches transformer decode; this engine serves
the paper's actual workload -- split CNN inference between a phone-class
client and one or more server tiers -- from a *stream* of requests
instead of one synchronous call at a time:

* **Bounded queue with backpressure.**  ``submit`` rejects with a named
  ``QueueFullError`` (and counts the shed) once the pending depth hits
  ``max_queue`` (``REPRO_SERVE_QUEUE_DEPTH``) -- queue-based load
  leveling with an explicit shed policy rather than unbounded growth.
* **Bucketed batch packing.**  Compatible requests -- same
  ``(model, resolution, storage dtype, wire formats)`` -- pack into
  batches of up to ``max_batch`` (``REPRO_SERVE_MAX_BATCH``).
  Heterogeneous input resolutions are fine: each resolution is its own
  bucket with its own chain plan (the conv planner handles arbitrary
  geometry).  A batch only packs requests that
  have *arrived* by its launch time -- no clairvoyant batching.
* **Cross-request pipelining.**  Each request rides its own microbatch
  through ``runtime.ChainRuntime`` against a **shared**
  ``ChainResources`` (per-tier / per-link next-free times on the
  virtual clock), so while batch i's boundary payload is in flight on
  the ``FaultyLink``, batch i+1 is running its client stage -- the
  PR-6 within-request microbatch pipeline generalised across requests.
  ``pipelined=False`` (``REPRO_SERVE_PIPELINED=0``) serialises
  everything: the sequential baseline the serving bench compares
  against.
* **Deadlines.**  ``submit(..., deadline_s=...)`` bounds a request's
  end-to-end virtual latency: requests that cannot start in time are
  expired before wasting compute, and requests that finish late are
  flagged (``status == "expired"``) -- both land in the shared
  ``EventLog`` as ``deadline_expired`` events.
* **Fault tolerance for free.**  Execution goes through
  ``ChainRuntime``, so retries, stage merges, and Pareto-front re-picks
  all work mid-stream; a re-pick triggered by one batch never corrupts
  later queued batches (each request's samples still walk every layer).
* **Breaker-aware dispatch.**  Pass ``tier_faults`` (and optionally
  ``breakers``) and every bucket runtime shares ONE ``FaultyTier`` list
  and ONE ``CircuitBreaker`` per tier: a tier that trips while serving
  bucket A is already open when bucket B dispatches, so B fails over
  proactively instead of burning a doomed attempt.  A standby-tier
  failover in one bucket resets the shared breaker and heals the shared
  fault model -- later batches from *any* bucket ride the spare.

Numerics: in pipelined mode (the default) one request = one microbatch,
so every request's logits are computed at its own batch size and are
**bit-identical** to ``apply_split`` / a direct ``ChainRuntime`` run on
that request alone, whatever else is in flight around it.  The
sequential baseline fuses each batch into one stage call (library convs
and matmuls are not batch-size-invariant, so fused logits can differ in
the last ulp -- it is a throughput baseline, not the serving path).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from repro_torch.core.costs import ModelProfile, resolve_chain_wire
from repro_torch.core.dtype_policy import conv_dtype
from repro_torch.core.hardware import (ChainHardware, TwoTierHardware,
                                       chain_of, paper_chain)
from repro_torch.core.multicut import smartsplit_chain
from repro_torch.device import resolve_device
from repro_torch.models import cnn as cnn_lib
from repro_torch.models.profiles import cnn_profile
from repro_torch.runtime import events as ev
from repro_torch.runtime.breakers import CircuitBreaker
from repro_torch.runtime.events import EventLog
from repro_torch.runtime.faults import FaultyLink
from repro_torch.runtime.tier_faults import FaultyTier
from repro_torch.runtime.link_estimator import chain_estimators
from repro_torch.runtime.runtime import (ChainInferenceResult,
                                         ChainResources, ChainRuntime,
                                         SplitUnrecoverable, hop_stats,
                                         links_and_clock, tier_guards)
from repro_torch.runtime.transfer import RetryPolicy
from repro_torch.spans import span

MAX_BATCH_ENV = "REPRO_SERVE_MAX_BATCH"
QUEUE_DEPTH_ENV = "REPRO_SERVE_QUEUE_DEPTH"
PIPELINED_ENV = "REPRO_SERVE_PIPELINED"


class QueueFullError(RuntimeError):
    """Request rejected: the bounded queue is at ``max_queue`` depth.

    Backpressure is explicit -- the caller sheds or retries later; the
    engine never buffers unboundedly.  The rejected ``CnnRequest`` (with
    ``status == "shed"``) is attached as ``request``."""

    def __init__(self, msg: str, request: "CnnRequest"):
        super().__init__(msg)
        self.request = request


class DeadlineExceeded(RuntimeError):
    """Named marker for deadline misses (recorded, never raised by the
    engine itself: a late result is flagged, not destroyed)."""


@dataclasses.dataclass
class CnnRequest:
    """One inference request: a single sample plus its SLO bookkeeping.

    status walks ``queued`` -> ``served`` | ``expired`` | ``failed``;
    ``shed`` requests were never queued.  All times are virtual-clock
    seconds; ``latency_s`` is end-to-end (arrival -> own microbatch
    finish, queueing included)."""

    rid: int
    model: str
    x: Any                          # one sample, e.g. (C, H, W), on device
    arrival_s: float
    deadline_s: float | None
    bucket: tuple
    status: str = "queued"
    logits: Any = None              # this sample's output row (a tensor)
    start_s: float = 0.0
    finish_s: float = 0.0
    latency_s: float = 0.0
    result: ChainInferenceResult | None = None

    @property
    def done(self) -> bool:
        return self.status in ("served", "expired", "failed")


class _Bucket:
    """Per-(model, resolution, dtype, wire) serving state: the chain
    plan for that geometry and the runtime that executes it (sharing the
    engine's links, resources, estimators, and event log)."""

    def __init__(self, key: tuple, prof: ModelProfile, rt: ChainRuntime):
        self.key = key
        self.prof = prof
        self.rt = rt
        self.pending: list[CnnRequest] = []
        self.served = 0
        self.batches = 0


class CnnServingEngine:
    """Batched, pipelined, fault-tolerant CNN split serving.

    models: ``{name: params}`` (layers looked up in ``cnn.CNN_MODELS``)
      or ``{name: (layers, params)}`` for explicit layer lists; the
      params must already sit on ``device``.
    hw / tiers: the serving chain -- an explicit ``ChainHardware`` (or
      ``TwoTierHardware``), else ``paper_chain(tiers)`` with ``tiers``
      defaulting to ``REPRO_CHAIN_TIERS`` (2 = the paper's phone/cloud).
    max_batch: batch packing limit per bucket (``REPRO_SERVE_MAX_BATCH``,
      default 4).
    max_queue: bounded queue depth across all buckets
      (``REPRO_SERVE_QUEUE_DEPTH``, default 64); beyond it ``submit``
      sheds with ``QueueFullError``.
    pipelined: cross-request pipelining via a shared ``ChainResources``
      + one microbatch per request (``REPRO_SERVE_PIPELINED``, default
      on).  ``False`` is the sequential synchronous-RPC baseline:
      whole-batch fused stages, no microbatching, and every batch waits
      out the previous one's full makespan.
    dtype / wire / policy: as in ``ChainRuntime`` (engine-wide; dtype
      and wire are part of the bucket key).
    device: where requests' samples are placed and computed (default
      ``cuda``, which raises without a card; ``cpu`` runs the kernels'
      plain versions).
    links: per-hop ``FaultyLink``s on one shared clock (default: fault
      free at the chain's nominal bandwidths) -- inject faults here.
    tier_faults: one ``FaultyTier`` per tier (compute-side faults),
      shared by every bucket runtime -- one health model per physical
      tier, not per bucket.
    breakers: one ``CircuitBreaker`` per tier, likewise shared; default
      when ``tier_faults`` is given: ``tier_breakers`` on this engine's
      event log.
    standby: allow standby-tier failover inside the bucket runtimes
      (see ``ChainRuntime``); the swap heals the shared fault model so
      all buckets benefit.
    """

    def __init__(self, models, *,
                 hw: ChainHardware | TwoTierHardware | None = None,
                 tiers: int | None = None,
                 max_batch: int | None = None,
                 max_queue: int | None = None,
                 pipelined: bool | None = None,
                 dtype: str | None = None, wire=None,
                 device: str | torch.device = "cuda",
                 policy: RetryPolicy = RetryPolicy(),
                 links: list[FaultyLink] | None = None,
                 tier_faults: list[FaultyTier] | None = None,
                 breakers: list[CircuitBreaker] | None = None,
                 standby: bool = True,
                 merge_fallback: bool | None = None,
                 estimator_alpha: float = 0.3,
                 jitter_seed: int = 0,
                 log: EventLog | None = None):
        self._models: dict[str, tuple[list, Any]] = {}
        for name, val in dict(models).items():
            if isinstance(val, tuple) and len(val) == 2 \
                    and isinstance(val[0], list):
                self._models[name] = val
            else:
                self._models[name] = (cnn_lib.CNN_MODELS[name], val)
        if hw is None:
            if tiers is None:
                tiers = int(os.environ.get("REPRO_CHAIN_TIERS", 2))
            hw = paper_chain(tiers)
        elif isinstance(hw, TwoTierHardware):
            hw = chain_of(hw)
        self.hw = hw
        if max_batch is None:
            max_batch = int(os.environ.get(MAX_BATCH_ENV, 4))
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        if max_queue is None:
            max_queue = int(os.environ.get(QUEUE_DEPTH_ENV, 64))
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        if pipelined is None:
            pipelined = os.environ.get(PIPELINED_ENV, "1") != "0"
        self.pipelined = bool(pipelined)
        self.device = resolve_device(device)
        self.policy = policy
        self._storage = conv_dtype(dtype)
        self._wire = wire
        self._wire_key = resolve_chain_wire(wire, len(hw.links),
                                            self._storage)
        self.links, self.clock = links_and_clock(hw, links)
        self.resources = ChainResources(hw.num_tiers, len(self.links)) \
            if self.pipelined else None
        self.estimators = chain_estimators(
            [link.bandwidth for link in hw.links], alpha=estimator_alpha)
        self.merge_fallback = merge_fallback
        self.estimator_alpha = estimator_alpha
        self.jitter_seed = int(jitter_seed)
        self.log = log if log is not None else EventLog()
        # One FaultyTier + one breaker per *physical* tier, shared across
        # every bucket runtime (built here so per-bucket ChainRuntimes
        # don't each auto-build their own disconnected set).
        self.tier_faults, self.breakers = tier_guards(
            hw, None if tier_faults is None else list(tier_faults),
            None if breakers is None else list(breakers), self.log)
        self.standby = bool(standby)
        self._buckets: dict[tuple, _Bucket] = {}
        self._seq_free = 0.0    # sequential mode: prior batch's makespan
        self._rid = 0
        # engine counters (stats() reads these)
        self.n_submitted = 0
        self.n_served = 0
        self.n_shed = 0
        self.n_expired = 0
        self.n_expired_queued = 0   # expired before dispatch (phase=queued)
        self.n_expired_mid = 0      # finished past deadline (in_flight)
        self.n_failed = 0
        self.n_batches = 0
        self._batch_sizes: list[int] = []
        self._latencies: list[float] = []
        self._t_first_arrival = float("inf")
        self._t_last_finish = 0.0

    # -- admission ------------------------------------------------------
    @property
    def n_pending(self) -> int:
        return sum(len(b.pending) for b in self._buckets.values())

    def submit(self, x, model: str | None = None, *,
               deadline_s: float | None = None,
               at: float | None = None) -> CnnRequest:
        """Enqueue one sample (shape = the model's input shape, no batch
        dim; a leading batch dim of 1 is squeezed).  ``at`` stamps the
        arrival on the virtual clock (default: now); ``deadline_s`` is a
        relative end-to-end SLO.  Raises ``QueueFullError`` when the
        bounded queue is at depth -- the shed is counted either way."""
        with span("serve/submit"):
            if model is None:
                if len(self._models) != 1:
                    raise ValueError(
                        f"engine serves {sorted(self._models)}: pass model=")
                model = next(iter(self._models))
            if model not in self._models:
                raise ValueError(f"unknown model {model!r}; registered: "
                                 f"{sorted(self._models)}")
            with span("serve/upload"):
                x = torch.as_tensor(x, device=self.device)
            if x.ndim == 4 and x.shape[0] == 1:
                x = x[0]
            if deadline_s is not None and deadline_s <= 0:
                raise ValueError(f"deadline_s must be positive, "
                                 f"got {deadline_s}")
            arrival = self.clock.now if at is None else float(at)
            self._rid += 1
            self.n_submitted += 1
            key = (model, tuple(int(s) for s in x.shape), self._storage,
                   self._wire_key)
            req = CnnRequest(rid=self._rid, model=model, x=x,
                             arrival_s=arrival, deadline_s=deadline_s,
                             bucket=key)
            if self.n_pending >= self.max_queue:
                req.status = "shed"
                self.n_shed += 1
                self.log.emit(ev.QUEUE_SHED, arrival, rid=req.rid,
                              depth=self.n_pending, max_queue=self.max_queue)
                raise QueueFullError(
                    f"queue depth {self.n_pending} >= max_queue "
                    f"{self.max_queue}: request {req.rid} shed", req)
            self._bucket_for(key).pending.append(req)
            return req

    def _bucket_for(self, key: tuple) -> _Bucket:
        bucket = self._buckets.get(key)
        if bucket is not None:
            return bucket
        model, shape, _, _ = key
        layers, params = self._models[model]
        prof = cnn_profile(model, batch=1, in_shape=shape,
                           dtype=self._storage, layers=layers)
        # Pipelined: one microbatch per request, so each request's convs
        # run at batch 1 -- bit-identical to apply_split of that sample
        # alone.  Sequential is the synchronous-RPC baseline: the whole
        # batch is one fused stage call, no pipelining anywhere.
        n_micro = self.max_batch if self.pipelined else 1
        plan = smartsplit_chain(prof, self.hw, microbatches=n_micro,
                                wire=self._wire)
        rt = ChainRuntime(
            layers, params, plan, prof, self.hw, links=self.links,
            policy=self.policy, dtype=self._storage,
            wire=self._wire, microbatches=n_micro,
            tier_faults=self.tier_faults, breakers=self.breakers,
            standby=self.standby,
            merge_fallback=self.merge_fallback,
            estimator_alpha=self.estimator_alpha,
            jitter_seed=self.jitter_seed + len(self._buckets),
            resources=self.resources, estimators=self.estimators,
            profile_batch=1, log=self.log)
        bucket = _Bucket(key, prof, rt)
        self._buckets[key] = bucket
        return bucket

    # -- scheduling -----------------------------------------------------
    def _earliest_start(self, arrival: float) -> float:
        free0 = self.resources.tier_free[0] if self.pipelined \
            else self._seq_free
        return max(arrival, free0)

    def _expire(self, req: CnnRequest, t: float, phase: str) -> None:
        req.status = "expired"
        self.n_expired += 1
        if phase == "queued":
            self.n_expired_queued += 1
        else:
            self.n_expired_mid += 1
        self.log.emit(ev.DEADLINE_EXPIRED, t, rid=req.rid, phase=phase,
                      arrival_s=req.arrival_s, deadline_s=req.deadline_s)

    def step(self) -> bool:
        """Dispatch one batch (FIFO across buckets by head arrival).
        Returns False when nothing is pending."""
        with span("serve/step"):
            live = [b for b in self._buckets.values() if b.pending]
            if not live:
                return False
            bucket = min(live, key=lambda b: b.pending[0].arrival_s)
            batch: list[CnnRequest] = []
            start: float | None = None
            while bucket.pending and len(batch) < self.max_batch:
                req = bucket.pending[0]
                est = self._earliest_start(req.arrival_s) if start is None \
                    else start
                if req.deadline_s is not None \
                        and est > req.arrival_s + req.deadline_s:
                    # cannot possibly meet its SLO: expire before computing
                    bucket.pending.pop(0)
                    self._expire(req, est, phase="queued")
                    if start is None:
                        return True      # head changed; re-pick the bucket
                    continue
                if start is None:
                    start = est
                elif req.arrival_s > start:
                    break                # not arrived by launch time
                bucket.pending.pop(0)
                batch.append(req)
            if not batch:
                return True              # expired the head(s); queue shrank
            xb = torch.stack([r.x for r in batch])
            try:
                # outside ``infer``, so a range around it keeps its self time
                with span("chain/infer"):
                    res = bucket.rt.infer(xb, at=start)
            except SplitUnrecoverable:
                for r in batch:
                    r.status = "failed"
                    r.start_s = start
                self.n_failed += len(batch)
                self.n_batches += 1
                self._batch_sizes.append(len(batch))
                return True
            finish = start + res.chain_elapsed_s
            if not self.pipelined:
                self._seq_free = max(self._seq_free, finish)
            per_request = len(res.microbatch_finish_s) == len(batch)
            for i, req in enumerate(batch):
                req.logits = res.logits[i]
                req.result = res
                req.start_s = start
                req.finish_s = res.microbatch_finish_s[i] if per_request \
                    else finish
                req.latency_s = req.finish_s - req.arrival_s
                if req.deadline_s is not None \
                        and req.latency_s > req.deadline_s:
                    self._expire(req, req.finish_s, phase="in_flight")
                else:
                    req.status = "served"
                    self.n_served += 1
                    bucket.served += 1
                    self._latencies.append(req.latency_s)
                self._t_first_arrival = min(self._t_first_arrival,
                                            req.arrival_s)
                self._t_last_finish = max(self._t_last_finish, req.finish_s)
            self.n_batches += 1
            bucket.batches += 1
            self._batch_sizes.append(len(batch))
            return True

    def run_until_idle(self) -> None:
        while self.step():
            pass

    # -- reporting ------------------------------------------------------
    def stats(self) -> dict:
        """Engine counters + latency percentiles + per-hop link stats
        (same per-hop schema as ``ChainRuntime.stats()["hops"]``)."""
        runtimes = [b.rt for b in self._buckets.values()]
        span = max(self._t_last_finish - self._t_first_arrival, 0.0) \
            if self.n_served else 0.0
        hops = []
        for k in range(len(self.links)):
            hop = hop_stats(runtimes, k, self._wire_key[k],
                            self.estimators[k], self.links[k])
            link = hop.pop("link")           # last, as the JAX engine has it
            hop["goodput_Bps"] = hop["goodput_bytes"] / span if span > 0 \
                else 0.0
            hop["link"] = link
            hops.append(hop)
        lat = np.asarray(self._latencies) if self._latencies else \
            np.zeros(1)
        return {
            "submitted": self.n_submitted,
            "queued": self.n_pending,
            "served": self.n_served,
            "shed": self.n_shed,
            "queue_shed": self.n_shed,
            "deadline_expired": self.n_expired,
            "deadline_pre_dispatch": self.n_expired_queued,
            "deadline_mid_flight": self.n_expired_mid,
            "failed": self.n_failed,
            "batches": self.n_batches,
            "avg_batch_size": float(np.mean(self._batch_sizes))
            if self._batch_sizes else 0.0,
            "pipelined": self.pipelined,
            "max_batch": self.max_batch,
            "max_queue": self.max_queue,
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99)),
            "virtual_span_s": span,
            "requests_per_s": self.n_served / span if span > 0 else 0.0,
            "recovered": sum(rt.n_recovered for rt in runtimes),
            "merges": sum(rt.n_merges for rt in runtimes),
            "repicks": sum(rt.n_repicks for rt in runtimes),
            "proactive_resplits": sum(rt.n_proactive for rt in runtimes),
            "failovers": sum(rt.n_failovers for rt in runtimes),
            "fallback_device": sum(rt.n_fallback_device
                                   for rt in runtimes),
            "tiers": None if self.tier_faults is None else
                [ft.counters() for ft in self.tier_faults],
            "breakers": None if self.breakers is None else
                [br.counters() for br in self.breakers],
            "buckets": [{
                "model": b.key[0], "in_shape": list(b.key[1]),
                "dtype": b.key[2], "wire": list(b.key[3]),
                "cuts": list(b.rt.plan.cuts),
                "tiers": [t.name for t in b.rt.hw.tiers],
                "pending": len(b.pending), "served": b.served,
                "batches": b.batches,
            } for b in self._buckets.values()],
            "hops": hops,
            "events": self.log.counts(),
        }
