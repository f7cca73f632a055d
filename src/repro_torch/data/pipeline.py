"""Synthetic data pipeline: deterministic token/embedding batches with
background prefetch and mesh-aware placement.

The paper needs no dataset (its metric surface is systems-level), but the
end-to-end training driver does: this generates a reproducible synthetic
language-modelling stream (Zipf-ish unigram mixture with a induced bigram
structure so the loss actually decreases) and, for frontend archs, frame /
patch embeddings."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticLM:
    """Deterministic synthetic LM stream with learnable structure:
    next-token depends on current token via a fixed random permutation,
    mixed with noise -- a model that learns p(next|cur) reaches a loss well
    below uniform."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, noise: float = 0.3):
        self.cfg, self.batch, self.seq_len = cfg, batch, seq_len
        self.noise = noise
        rng = np.random.default_rng(seed)
        V = cfg.vocab_size
        self.perm = rng.permutation(V)
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        V = self.cfg.vocab_size
        B, S = self.batch, self.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        for t in range(1, S + 1):
            follow = self.perm[toks[:, t - 1]]
            noise = rng.integers(0, V, B)
            use_noise = rng.random(B) < self.noise
            toks[:, t] = np.where(use_noise, noise, follow)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 "loss_mask": np.ones((B, S), np.float32)}
        if self.cfg.frontend == "audio":
            emb = rng.standard_normal((B, S, self.cfg.d_model),
                                      np.float32) * 0.02
            batch = {"prefix_embeds": emb, "labels": toks[:, 1:],
                     "loss_mask": np.ones((B, S), np.float32)}
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with bounded queue (CPU pipeline overlap
    with device compute)."""

    def __init__(self, it: Iterator[dict], depth: int = 2,
                 place=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._place = place or (lambda x: x)
        self._stop = False

        def work():
            for item in it:
                if self._stop:
                    return
                self._q.put(self._place(item))
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop = True
