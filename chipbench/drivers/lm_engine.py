"""Drives ``repro_torch.serving.engine.Engine`` serving the hybrid
language model of ``repro_torch.models.granite_hybrid``: bucketed
prefill, then greedy decode through the cache.

Set-up draws the weights from the seed on the card (a generator a layer),
checks the model's configuration against the file's, builds the engine
with every argument explicit, and warms up each prompt length at batch 1
and at the largest batch, the flash kernel's build included.  The window
offers the mix's requests at their due times (open loop), the prompts'
lengths the mix's in a seeded order and their ids uniform over the
vocabulary, and serves one batch at a time (``Engine.step``, the bucket
the mix's ``schedule`` picks); it closes
once every request due in it is answered.  A request is timed from its
due time to its last logits on the host.  ``window["images"]`` counts the
answered requests, as the harness reads it.

What decides ``correct``: ``program_checks`` holds the engine's and the
model's counters to the mix (no assignment dropped, the mix's new tokens
for every request, every batch one of the mix's lengths, every admitted
request answered); ``reference_checks`` holds the logits of two answered
requests a prompt length, chosen by the seed before the window, to the
plain reference (``chipbench.reference.granite_hybrid``) teacher-forced
on the program's tokens: the last prompt position's and every generated
position's, so prefill and every decode step through the cache are held
to one full forward."""
from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from chipbench import counts, lm_counts, traffic
from chipbench.reference import granite_hybrid as ref

STORAGE = {"bf16": torch.bfloat16}
WARM_TOKENS = 2        # new tokens of each warm-up batch


def prompt_lengths(mix: dict, n: int, seed: int) -> np.ndarray:
    """The n requests' prompt lengths: each length's share of n by its
    weight (largest remainders), in an order drawn from the seed, so
    every seed offers the same lengths as it offers the same gaps."""
    w = np.asarray(mix["length_weights"], float)
    share = n * w / w.sum()
    k = np.floor(share).astype(int)
    k[np.argsort(k - share)[:n - k.sum()]] += 1
    out = np.repeat(np.asarray(mix["prompt_lengths"]), k)
    np.random.default_rng([int(seed), 3]).shuffle(out)
    return out


class System:
    """The system under test for one cell."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from repro_torch.models import granite_hybrid as gh
        from repro_torch.serving.engine import Engine

        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        self.storage = STORAGE[config["storage_dtype"]]
        self.cfg = gh.GraniteHybridConfig.from_dict(config)
        for k, v in config.items():
            if hasattr(self.cfg, k) and getattr(self.cfg, k) != \
                    (tuple(v) if isinstance(v, list) else v):
                raise RuntimeError(f"the model's {k} is not the "
                                   f"configuration's")
        self.model = gh.GraniteHybrid(
            self.cfg, gh.init_params(self.cfg, self.seed, self.device,
                                     self.storage))
        self.new_tokens = mix["new_tokens"]
        self.engine = Engine(
            self.model, max_len=max(mix["prompt_lengths"]) + self.new_tokens,
            max_batch=mix["max_batch"], dtype=self.storage,
            device=self.device, schedule=mix["schedule"])
        self._ids = np.random.default_rng([self.seed, 4])
        self.prefills: list[tuple] = []    # every batch's (size, length)
        for length in mix["prompt_lengths"]:
            for b in (1, mix["max_batch"]):
                for _ in range(b):
                    self.engine.submit(self._prompt(length), WARM_TOKENS)
                self._step()
        self.kept: list[dict] = []
        self.shed = 0

    # -- the program's entry points, with the benchmark's spans ----------
    def spans(self) -> list[tuple]:
        """(owner, name, label) of each function the traced run wraps:
        none, the program's own spans are read."""
        return []

    def _prompt(self, length: int) -> list[int]:
        return self._ids.integers(0, self.cfg.vocab_size, length).tolist()

    def _step(self) -> list:
        """One batch; it ends with its last logits' copy to the host."""
        served = self.engine.step()
        if served:
            self.prefills.append((len(served), len(served[0].prompt)))
        return served

    # -- the measured window ---------------------------------------------
    def window(self, seconds: float, meter=None,
               span=contextlib.nullcontext) -> dict:
        """Serve the mix's requests due in ``seconds`` inside ``span()``,
        until each is answered; what the window did, by the host clock,
        the card's joules over it (``meter``, where given), and the
        counts the per-layer metrics divide by."""
        due = traffic.due_times(self.mix, seconds, self.seed)
        lengths = prompt_lengths(self.mix, len(due), self.seed)
        check = self._chosen(lengths)
        stats0 = dict(self.engine.stats)
        n0 = len(self.prefills)
        e0 = meter.joules() if meter is not None else None
        with span():
            out = self._open(due, lengths, check)
        e1 = meter.joules() if meter is not None else None
        stats = {k: self.engine.stats[k] - stats0[k]
                 for k in ("batches", "tokens", "prefill_tokens",
                           "decode_steps")}
        prefills = self.prefills[n0:]
        decodes = [(b, s + j) for b, s in prefills
                   for j in range(self.new_tokens - 1)]
        self.window_tokens = (out["images"], stats["tokens"])
        out.update(
            joules=None if meter is None else e1 - e0,
            engine=stats, prefills=prefills,
            flash_least_s=sum(
                counts.least_seconds(lm_counts.flash_call(
                    self.config, b, s, self.config["storage_dtype"]))
                for b, s in prefills) * lm_counts.layer_types(
                    self.config).count("attention"),
            model_flops=lm_counts.model_flops(self.config, prefills,
                                              decodes))
        return out

    def _chosen(self, lengths: np.ndarray) -> set[int]:
        """The requests whose logits are checked: ``check_per_bucket`` of
        each prompt length, drawn from the seed."""
        rng = np.random.default_rng([self.seed, 5])
        out = set()
        for length in self.mix["prompt_lengths"]:
            idx = np.flatnonzero(lengths == length)
            k = min(self.mix["check_per_bucket"], len(idx))
            out |= {int(i) for i in rng.choice(idx, k, replace=False)}
        return out

    def _open(self, due, lengths, check) -> dict:
        lat, queue, late = [], [], 0.0
        answered = batches = k = 0
        ends: list[float] = []
        waiting: dict[int, tuple] = {}     # rid -> (index, due)
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            while k < len(due) and due[k] <= now:
                late = max(late, now - due[k])
                if self.engine.scheduler.n_pending >= self.mix["max_queue"]:
                    self.shed += 1
                else:
                    req = self.engine.submit(self._prompt(int(lengths[k])),
                                             self.new_tokens)
                    if k in check:
                        req.logits = []
                    waiting[req.rid] = (k, float(due[k]))
                k += 1
            if self.engine.scheduler.n_pending:
                start = time.perf_counter() - t0
                served = self._step()
                t = time.perf_counter() - t0
                answered += len(served)
                batches += 1
                ends.append(t)
                for r in served:
                    _, d = waiting.pop(r.rid)
                    lat.append(r.finish_t - t0 - d)
                    queue.append(start - d)
                    if r.logits is not None:
                        self.kept.append(dict(
                            prompt=r.prompt, output=list(r.output),
                            batch=len(served),
                            logits=torch.from_numpy(np.stack(r.logits))))
            elif k < len(due):
                wait = due[k] - (time.perf_counter() - t0)
                if wait > 1e-3:
                    time.sleep(wait - 5e-4)
            else:
                break
        t = time.perf_counter() - t0
        return dict(images=answered, batches=batches, elapsed_s=t,
                    attempted=len(due), latencies_s=lat, queue_s=queue,
                    late_s=late, batch_ends_s=ends)

    # -- what decides ``correct`` ------------------------------------------
    def program_checks(self) -> dict:
        """The engine's and the model's counters against the mix:
        (value, limit) pairs, each exact."""
        answered, tokens = self.window_tokens
        lengths = set(self.mix["prompt_lengths"])
        return {
            "dropped_assignments": (self.model.dropped(), 0),
            "tokens_short": (abs(tokens - self.new_tokens * answered)
                             + sum(abs(len(k["output"]) - self.new_tokens)
                                   for k in self.kept), 0),
            "bucket_lengths_differ": (sum(n not in lengths
                                          for _, n in self.prefills), 0),
            "unserved": (self.shed + self.engine.scheduler.n_pending, 0),
        }

    def free(self) -> list[dict]:
        """Drop the program's state; the checked requests stay."""
        kept = self.kept
        del self.engine, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return kept

    def reference_checks(self, kept: list[dict], *, control=None) -> dict:
        """The checked requests' logits against the plain reference,
        teacher-forced on the program's tokens: each row's widest gap
        over the row's largest reference logit, the worst row.  With
        ``control`` (a storage type below the configuration's) the
        reference computed in it takes the program's place."""
        side = "program" if control is None else "control"
        out = self.readings(kept, control)
        out["logit_err"] = out.pop(side)
        out.pop("control", None)
        out.pop("program", None)
        return out

    def readings(self, kept: list[dict], control=None) -> dict:
        """``logit_err`` of the program (``"program"``) and, with
        ``control``, of the reference in that storage type
        (``"control"``), each against one reference computation; the
        rows compared and the router's near-ties in the reference."""
        if not kept:
            return {"program": math.inf, "control": math.inf, "rows": 0,
                    "requests": 0, "batch_sizes": []}
        seqs = [torch.tensor(k["prompt"] + k["output"][:-1]) for k in kept]
        rows = [slice(len(k["prompt"]) - 1, None) for k in kept]

        def reference(storage):
            return ref.forward(self.config, self.seed, seqs,
                               device=self.device, rows=rows,
                               store=ref.store_as(storage))
        want, ties = reference(self.storage)
        sides = {"program": [k["logits"].to(self.device) for k in kept]}
        if control is not None:
            sides["control"] = reference(control)[0]
        out = {name: max(float(((g - w).abs().amax(-1)
                                / w.abs().amax(-1)).max())
                         for g, w in zip(got, want))
               for name, got in sides.items()}
        out.update(rows=sum(len(w) for w in want), requests=len(kept),
                   router_near_ties=ties,
                   prompt_lengths=sorted(len(k["prompt"]) for k in kept),
                   batch_sizes=sorted({k["batch"] for k in kept}))
        return out
