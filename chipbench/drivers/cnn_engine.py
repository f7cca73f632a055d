"""Drives ``repro_torch.serving.cnn_engine.CnnServingEngine``: the paper's
split CNNs served from a queue of single-image uploads.

Set-up makes the weights and an image pool from the seed, builds the
engine with every argument explicit (no ``REPRO_*`` variable can change a
cell), checks the plan's cuts against the configuration, and warms up
every batch size the mix will dispatch.  The window drives
``CnnServingEngine.submit`` and ``CnnServingEngine.step`` in sequential
mode (one fused stage call a batch), each step followed by a synchronise,
so a request's logits are ready when its step returns.
``program_checks`` holds the engine's counters to the configuration and
``reference_checks`` the sampled batches' logits to the plain reference
(``chipbench.reference.cnn``)."""
from __future__ import annotations

import collections
import contextlib
import time

import torch

from chipbench import counts, inputs, traffic
from chipbench.reference import cnn as ref
from chipbench.reference import codec

STORAGE = {"bf16": torch.bfloat16}
WARM_ROUNDS = 2          # dispatches of each batch size before the window


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class System:
    """The system under test for one cell."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from repro_torch.core.hardware import paper_chain
        from repro_torch.models import cnn as cnn_lib
        from repro_torch.runtime.transfer import RetryPolicy
        from repro_torch.serving.cnn_engine import CnnServingEngine

        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        self.in_shape = tuple(config["input_shape"])
        self.net = ref.layers(config["arch"])
        self.cuts = tuple(config["cuts"])
        self.storage = STORAGE[config["storage_dtype"]]
        layers = cnn_lib.CNN_MODELS[config["model"]]
        if [l.kind for l in layers] != [l["kind"] for l in self.net]:
            raise RuntimeError(f"the system's {config['model']} layers are "
                               f"not the configuration's")
        hw = paper_chain(config["chain"]["paper_chain"])
        if [t.name for t in hw.tiers] != config["chain"]["tiers"] or \
                [l.bandwidth for l in hw.links] != \
                config["chain"]["link_bytes_per_s"]:
            raise RuntimeError("the system's chain is not the "
                               "configuration's")
        params = inputs.make_weights(self.net, self.in_shape, self.seed,
                                     self.device, self.storage)
        retry = config["retry"]
        self.engine = CnnServingEngine(
            {config["model"]: (layers, params)}, hw=hw,
            max_batch=mix["max_batch"], max_queue=mix["max_queue"],
            pipelined=False, dtype=config["storage_dtype"],
            wire=tuple(config["wire"]),
            policy=RetryPolicy(max_attempts=retry["max_attempts"],
                               timeout_s=retry["timeout_s"]),
            device=self.device)
        self.pool = inputs.make_pool(mix["pool_images"], self.in_shape,
                                     self.seed, self.device)
        self.order = traffic.ImageOrder(len(self.pool), self.seed)
        self.kept = traffic.Reservoir(mix["check_batches"], self.seed)
        self.dispatched: list[int] = []     # every batch's size, in order
        self.inflight: collections.deque = collections.deque()
        self.flops_per_image = counts.model_flops(self.net, self.in_shape)
        sizes = range(1, mix["max_batch"] + 1) if mix["loop"] == "open" \
            else [mix["max_batch"]]
        for k in sizes:
            for _ in range(WARM_ROUNDS):
                for _ in range(k):
                    self._submit()
                self._step()

    # -- the program's entry points, with the benchmark's spans ----------
    def spans(self) -> list[tuple]:
        """(owner, name, label) of each function the traced run wraps."""
        from repro_torch.models import cnn as cnn_lib
        from repro_torch.runtime import runtime as rt
        from repro_torch.serving import cnn_engine as ce
        return [(ce.CnnServingEngine, "step", "engine.step"),
                (ce.CnnServingEngine, "submit", "engine.submit"),
                (rt.ChainRuntime, "infer", "runtime.infer"),
                (rt.ChainRuntime, "_run", "runtime.stage"),
                (rt, "encode_boundary", "wire.encode"),
                (rt, "send_with_retry", "transfer.send"),
                (rt, "decode_boundary", "wire.decode"),
                (cnn_lib, "_conv2d", "kernels.conv2d")]

    def _submit(self, at: float | None = None, due: float = 0.0) -> None:
        from repro_torch.serving.cnn_engine import QueueFullError
        i = self.order.next()
        try:
            req = self.engine.submit(self.pool[i], at=at)
        except QueueFullError:
            return                  # shed: the engine counts it
        self.inflight.append((req, i, due))

    def _step(self) -> list[tuple]:
        """Dispatch one batch and wait for its logits; the requests served."""
        self.engine.step()
        _sync(self.device)
        done = []
        while self.inflight and self.inflight[0][0].done:
            done.append(self.inflight.popleft())
        if done:
            self.dispatched.append(len(done))
        return done

    def _keep(self, done: list[tuple]) -> None:
        res = done[0][0].result
        self.kept.offer(lambda: dict(
            images=[i for _, i, _ in done], logits=res.logits.clone(),
            cuts=tuple(res.cuts), merged=tuple(res.merged_hops)))

    # -- the measured window ---------------------------------------------
    def window(self, seconds: float, meter=None,
               span=contextlib.nullcontext) -> dict:
        """Serve the mix for ``seconds`` inside ``span()``; what the window
        did, by the host clock, and the card's joules over it (``meter``,
        where given)."""
        before = self.engine.stats()
        n0 = len(self.dispatched)
        e0 = meter.joules() if meter is not None else None
        with span():
            out = self._closed(seconds) if self.mix["loop"] == "closed" \
                else self._open(seconds)
        e1 = meter.joules() if meter is not None else None
        after = self.engine.stats()
        out.update(
            joules=None if meter is None else e1 - e0,
            wire_bytes=[b["wire_bytes"] - a["wire_bytes"]
                        for a, b in zip(before["hops"], after["hops"])],
            engine_served=after["served"] - before["served"],
            engine_batches=after["batches"] - before["batches"],
            conv_least_s=sum(
                counts.least_seconds(c)
                for b in self.dispatched[n0:n0 + out["batches"]]
                for c in counts.conv_calls(
                    self.net, self.in_shape, cuts=self.cuts, batch=b,
                    storage=self.config["storage_dtype"])),
            flops_per_image=self.flops_per_image)
        self._drain()
        return out

    def _closed(self, seconds: float) -> dict:
        images = batches = 0
        ends: list[float] = []
        t0 = time.perf_counter()
        for _ in range(self.mix["clients"]):
            self._submit()
        while True:
            done = self._step()
            t = time.perf_counter() - t0
            if done:
                self._keep(done)
                images += len(done)
                batches += 1
                ends.append(t)
            if t >= seconds:
                break
            for _ in done:
                self._submit()
        return dict(images=images, batches=batches, elapsed_s=t,
                    attempted=images, latencies_s=[], queue_s=[],
                    batch_ends_s=ends)

    def _open(self, seconds: float) -> dict:
        due = traffic.due_times(self.mix, seconds, self.seed)
        lat, queue, late = [], [], 0.0
        images = batches = k = 0
        ends: list[float] = []
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            while k < len(due) and due[k] <= now:
                late = max(late, now - due[k])
                self._submit(at=float(due[k]), due=float(due[k]))
                k += 1
            if self.inflight:
                start = time.perf_counter() - t0
                done = self._step()
                t = time.perf_counter() - t0
                if done:
                    self._keep(done)
                    images += len(done)
                    batches += 1
                    ends.append(t)
                for _, _, d in done:
                    lat.append(t - d)
                    queue.append(start - d)
            elif k < len(due):
                wait = due[k] - (time.perf_counter() - t0)
                if wait > 1e-3:
                    time.sleep(wait - 5e-4)
            else:
                break
        t = time.perf_counter() - t0
        return dict(images=images, batches=batches, elapsed_s=t,
                    attempted=len(due), latencies_s=lat, queue_s=queue,
                    late_s=late, batch_ends_s=ends)

    def _drain(self) -> None:
        """Serve what is still queued: no request is left unanswered."""
        while self.inflight:
            self._step()

    # -- what decides ``correct`` ------------------------------------------
    def program_checks(self) -> dict:
        """The engine's own counters against what the configuration
        states: (value, limit) pairs, each exact."""
        s = self.engine.stats()
        boundary = ref.shapes(self.net, self.in_shape)
        want = [sum(codec.payload_bytes((b, *boundary[c]))
                    for b in self.dispatched) for c in self.cuts]
        got = [h["wire_bytes"] for h in s["hops"]]
        cuts_ok = all(b["cuts"] == list(self.cuts) for b in s["buckets"]) \
            and all(k["cuts"] == self.cuts and not k["merged"]
                    for k in self.kept.items)
        wires_ok = [h["wire_dtype"] for h in s["hops"]] == \
            list(self.config["wire"])
        return {
            "cuts_differ": (0 if cuts_ok and wires_ok else 1, 0),
            "merges_repicks": (s["merges"] + s["repicks"]
                               + s["proactive_resplits"] + s["failovers"]
                               + s["fallback_device"], 0),
            "wire_bytes_gap": (max(abs(g - w) for g, w in zip(got, want)),
                               0),
            "retries": (sum(h["attempts"] for h in s["hops"])
                        - len(s["hops"]) * len(self.dispatched), 0),
            "unserved": (s["submitted"] - s["served"], 0),
        }

    def free(self) -> list[dict]:
        """Drop the program's state; the sampled batches stay."""
        kept = self.kept.items
        del self.engine
        self.inflight.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return kept

    def reference_checks(self, kept: list[dict], *, control=None) -> dict:
        """The sampled rows' logits against the plain reference: the widest
        gap of a row, over the row's largest reference logit.  With
        ``control`` (a storage type below the configuration's) the
        reference computed in it takes the program's place: its logits are
        the ones judged."""
        params = inputs.make_weights(self.net, self.in_shape, self.seed,
                                     self.device, self.storage)
        store = ref.store_as(self.storage)
        err, rows = 0.0, 0
        for k in kept:
            x = self.pool[k["images"]].to(self.device)
            want = ref.forward(self.net, params, x, cuts=self.cuts,
                               store=store)
            got = k["logits"].float() if control is None else ref.forward(
                self.net, params, x, cuts=self.cuts,
                store=ref.store_as(control))
            err = max(err, float(((got - want).abs().amax(dim=1)
                                  / want.abs().amax(dim=1)).max()))
            rows += len(k["images"])
        return {"logit_err": err, "rows": rows,
                "batch_sizes": sorted({len(k["images"]) for k in kept})}
