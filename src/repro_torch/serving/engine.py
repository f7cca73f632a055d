"""Batched serving engine (the paper's kind: inference): the PyTorch port
of ``repro.serving.engine``.

Bucketed batch-synchronous serving: requests queue up, the scheduler packs
same-length prompts into batches (bucketing keeps the shared-position KV
cache design exact), one prefill fills the cache, then a decode loop emits
tokens greedily (or by temperature sampling) until every row hit its stop
condition.  The JAX package jits prefill and decode; here they are plain
calls on the engine's device (``device="cuda"`` by default, raising
without a card).

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


class BucketScheduler:
    """Groups pending requests by exact prompt length; emits batches of at
    most ``max_batch``."""

    def __init__(self, max_batch: int = 8):
        self.max_batch = max_batch
        self.pending: dict[int, list[Request]] = defaultdict(list)

    def add(self, req: Request) -> None:
        # perf_counter, not time.time(): queue/latency deltas must be
        # monotonic (wall clock can step backwards under NTP adjustment)
        req.enqueue_t = time.perf_counter()
        self.pending[len(req.prompt)].append(req)

    def next_batch(self) -> list[Request] | None:
        if not self.pending:
            return None
        # largest bucket first (throughput), FIFO within bucket
        length = max(self.pending, key=lambda k: len(self.pending[k]))
        bucket = self.pending[length]
        batch, self.pending[length] = bucket[:self.max_batch], \
            bucket[self.max_batch:]
        if not self.pending[length]:
            del self.pending[length]
        return batch or None

    @property
    def n_pending(self) -> int:
        return sum(len(v) for v in self.pending.values())


class Engine:
    """params: the port's transformer params (``transformer.init_params``
    or ``params_from_numpy``), already on ``device``."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 512,
                 max_batch: int = 8, dtype=torch.float32,
                 device: str | torch.device = "cuda"):
        if cfg.is_encoder:
            raise ValueError("serving engine drives decoder archs")
        self.cfg, self.params = cfg, params
        self.max_len, self.dtype = max_len, dtype
        self.device = resolve_device(device)
        self.scheduler = BucketScheduler(max_batch)
        self._rid = 0
        self.stats: dict[str, float] = {"batches": 0, "tokens": 0,
                                        "prefill_tokens": 0,
                                        "latency_p50_s": 0.0,
                                        "latency_p99_s": 0.0}
        self._latencies: list[float] = []

    def _prefill(self, tokens, cache):
        logits, cache, _ = T.forward(self.cfg, self.params,
                                     {"tokens": tokens}, mode="prefill",
                                     cache=cache)
        return logits[:, -1, :], cache

    def _decode(self, tok, cache):
        logits, cache = T.decode_step(self.cfg, self.params, tok, cache)
        return logits[:, -1, :], cache

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

    def run_batch(self, reqs: list[Request]) -> None:
        B = len(reqs)
        plen = len(reqs[0].prompt)
        toks = torch.tensor([r.prompt for r in reqs], dtype=torch.long,
                            device=self.device)
        cache = T.init_cache(self.cfg, B, self.max_len, self.dtype,
                             self.device)
        logits, cache = self._prefill(toks, cache)
        self.stats["prefill_tokens"] += B * plen
        gens = [torch.Generator().manual_seed(r.rid) if r.temperature
                else None for r in reqs]
        max_new = max(r.max_new_tokens for r in reqs)
        cur = self._sample(logits.cpu().numpy(), reqs, gens)
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
            logits, cache = self._decode(tok, cache)
            cur = self._sample(logits.cpu().numpy(), reqs, gens)
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

    def run_until_idle(self) -> None:
        while (batch := self.scheduler.next_batch()) is not None:
            self.run_batch(batch)
