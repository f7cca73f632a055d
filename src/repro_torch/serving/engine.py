"""Batched serving engine (the paper's kind: inference): the PyTorch port
of ``repro.serving.engine``.

Bucketed batch-synchronous serving: requests queue up, the scheduler packs
same-length prompts into batches (bucketing keeps the shared-position KV
cache design exact), one prefill fills the cache, then a decode loop emits
tokens greedily (or by temperature sampling) until every row hit its stop
condition.  The JAX package jits prefill and decode; here they are plain
calls on the engine's device (``device="cuda"`` by default, raising
without a card).

The engine serves a model object: ``init_cache(batch, max_len, dtype,
device)``, ``prefill(tokens, cache)`` and ``decode(tokens, cache)``, each
of the last two returning the last position's logits and the cache
(``models/granite_hybrid.py::GraniteHybrid``).  A ``ModelConfig`` and its
params are wrapped in ``TransformerLM``, which calls
``transformer.forward`` and ``decode_step`` as the engine always has.

Under a profiler the engine opens ``lm/batch`` (one ``run_batch``: every
span of the batch nests in it), ``lm/prefill``, ``lm/decode`` (one
step) and ``lm/sample`` (the logits' copy to the host and the pick).
``stats`` counts batches, prompt tokens (``prefill_tokens``), generated
tokens (``tokens``) and decode steps (``decode_steps``).

Sampling: greedy decoding is ``argmax`` on the host, as in the JAX
package, and its tokens are the ones to hold against ``repro``'s.
Temperature sampling draws from one ``torch.Generator`` per request,
seeded with the request id, a fresh draw each step; ``jax.random``'s
stream cannot be reproduced, so sampled tokens are the port's own.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.spans import span


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    done: bool = False
    output: list[int] = dataclasses.field(default_factory=list)
    enqueue_t: float = 0.0
    finish_t: float = 0.0
    # a list to collect the request's logits rows in (numpy fp32, the
    # prefill's last position then each decode step's), or None
    logits: list | None = None


class BucketScheduler:
    """Groups pending requests by exact prompt length; emits batches of at
    most ``max_batch``, FIFO within a bucket, from the largest bucket
    (``policy="largest"``, the JAX package's: throughput) or from the
    bucket whose first request came first (``"oldest"``: under open-loop
    arrivals of several lengths, largest-first leaves the short buckets
    waiting behind batch after batch of the long one)."""

    POLICIES = ("largest", "oldest")

    def __init__(self, max_batch: int = 8, policy: str = "largest"):
        if policy not in self.POLICIES:
            raise ValueError(f"scheduling policy {policy!r} is not one of "
                             f"{self.POLICIES}")
        self.max_batch, self.policy = max_batch, policy
        self.pending: dict[int, list[Request]] = defaultdict(list)

    def add(self, req: Request) -> None:
        # perf_counter, not time.time(): queue/latency deltas must be
        # monotonic (wall clock can step backwards under NTP adjustment)
        req.enqueue_t = time.perf_counter()
        self.pending[len(req.prompt)].append(req)

    def next_batch(self) -> list[Request] | None:
        if not self.pending:
            return None
        if self.policy == "largest":
            length = max(self.pending, key=lambda k: len(self.pending[k]))
        else:
            length = min(self.pending,
                         key=lambda k: self.pending[k][0].enqueue_t)
        bucket = self.pending[length]
        batch, self.pending[length] = bucket[:self.max_batch], \
            bucket[self.max_batch:]
        if not self.pending[length]:
            del self.pending[length]
        return batch or None

    @property
    def n_pending(self) -> int:
        return sum(len(v) for v in self.pending.values())


class TransformerLM:
    """A ``ModelConfig`` decoder and its params (``transformer.init_params``
    or ``params_from_numpy``) as the engine's model object."""

    def __init__(self, cfg: ModelConfig, params):
        if cfg.is_encoder:
            raise ValueError("serving engine drives decoder archs")
        self.cfg, self.params = cfg, params

    def init_cache(self, batch: int, max_len: int, dtype, device):
        return T.init_cache(self.cfg, batch, max_len, dtype, device)

    def prefill(self, tokens, cache):
        logits, cache, _ = T.forward(self.cfg, self.params,
                                     {"tokens": tokens}, mode="prefill",
                                     cache=cache)
        return logits[:, -1, :], cache

    def decode(self, tok, cache):
        logits, cache = T.decode_step(self.cfg, self.params, tok, cache)
        return logits[:, -1, :], cache


class Engine:
    """Serves ``model``: a model object (``init_cache``, ``prefill``,
    ``decode``), or a ``ModelConfig`` with its ``params`` already on
    ``device`` (wrapped in ``TransformerLM``); ``schedule`` is the
    ``BucketScheduler`` policy."""

    def __init__(self, model, params=None, *, max_len: int = 512,
                 max_batch: int = 8, dtype=torch.float32,
                 device: str | torch.device = "cuda",
                 schedule: str = "largest"):
        if isinstance(model, ModelConfig):
            model = TransformerLM(model, params)
            self.cfg, self.params = model.cfg, params
        self.model = model
        self.max_len, self.dtype = max_len, dtype
        self.device = resolve_device(device)
        self.scheduler = BucketScheduler(max_batch, schedule)
        self._rid = 0
        self.stats: dict[str, float] = {"batches": 0, "tokens": 0,
                                        "prefill_tokens": 0,
                                        "decode_steps": 0,
                                        "latency_p50_s": 0.0,
                                        "latency_p99_s": 0.0}
        self._latencies: list[float] = []

    def _prefill(self, tokens, cache):
        return self.model.prefill(tokens, cache)

    def _decode(self, tok, cache):
        return self.model.decode(tok, cache)

    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               temperature: float = 0.0) -> Request:
        self._rid += 1
        req = Request(rid=self._rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens,
                      temperature=temperature)
        self.scheduler.add(req)
        return req

    @staticmethod
    def _sample(logits: np.ndarray, reqs: list[Request],
                gens: list[torch.Generator | None]) -> np.ndarray:
        if all(r.temperature == 0.0 for r in reqs):
            return np.argmax(logits, axis=-1)
        out = np.empty(len(reqs), np.int64)
        for i, r in enumerate(reqs):
            if r.temperature == 0.0:
                out[i] = int(np.argmax(logits[i]))
            else:
                p = torch.softmax(torch.from_numpy(logits[i]).double()
                                  / r.temperature, dim=-1)
                out[i] = int(torch.multinomial(p, 1, generator=gens[i]))
        return out

    def _pick(self, logits: torch.Tensor, reqs: list[Request], gens,
              active) -> np.ndarray:
        """The next token of each row: the logits' copy to the host, each
        collecting request's row kept, and the pick."""
        with span("lm/sample"):
            host = logits.cpu().numpy()
            for i, r in enumerate(reqs):
                if r.logits is not None and active[i]:
                    r.logits.append(host[i])
            return self._sample(host, reqs, gens)

    def run_batch(self, reqs: list[Request]) -> None:
        with span("lm/batch"):
            self._run_batch(reqs)

    def _run_batch(self, reqs: list[Request]) -> None:
        B = len(reqs)
        plen = len(reqs[0].prompt)
        toks = torch.tensor([r.prompt for r in reqs], dtype=torch.long,
                            device=self.device)
        with span("lm/prefill"):
            cache = self.model.init_cache(B, self.max_len, self.dtype,
                                          self.device)
            logits, cache = self._prefill(toks, cache)
        self.stats["prefill_tokens"] += B * plen
        gens = [torch.Generator().manual_seed(r.rid) if r.temperature
                else None for r in reqs]
        max_new = max(r.max_new_tokens for r in reqs)
        cur = self._pick(logits, reqs, gens, [True] * B)
        for i, r in enumerate(reqs):
            r.output.append(int(cur[i]))
            # the prefill-sampled token is output too
            self.stats["tokens"] += 1
        for step in range(1, max_new):
            active = np.array([len(r.output) < r.max_new_tokens
                               for r in reqs])
            if not active.any() or plen + step >= self.max_len:
                break
            tok = torch.as_tensor(cur, dtype=torch.long,
                                  device=self.device)[:, None]
            with span("lm/decode"):
                logits, cache = self._decode(tok, cache)
            self.stats["decode_steps"] += 1
            cur = self._pick(logits, reqs, gens, active)
            for i, r in enumerate(reqs):
                if active[i]:
                    r.output.append(int(cur[i]))
                    self.stats["tokens"] += 1
        now = time.perf_counter()
        for r in reqs:
            r.done = True
            r.finish_t = now
            self._latencies.append(now - r.enqueue_t)
        self.stats["batches"] += 1
        self.stats["latency_p50_s"] = float(
            np.percentile(self._latencies, 50))
        self.stats["latency_p99_s"] = float(
            np.percentile(self._latencies, 99))

    def step(self) -> list[Request]:
        """Serve the scheduler's next batch; the requests served (none
        when nothing is pending)."""
        batch = self.scheduler.next_batch()
        if batch is not None:
            self.run_batch(batch)
        return batch or []

    def run_until_idle(self) -> None:
        while (batch := self.scheduler.next_batch()) is not None:
            self.run_batch(batch)
