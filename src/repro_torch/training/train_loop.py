"""Training driver of the PyTorch port: data pipeline -> train step ->
metrics + checkpoints, the counterpart of ``repro.training.train_loop``.

Eager torch takes the place of ``jax.jit``.  The batches are made by
``SyntheticLM`` in the prefetch thread and placed there too: pinned host
memory and ``non_blocking`` copies on the card, so building the next batch
overlaps the current step.  The loss is read back to the host only on log
steps, as the JAX driver reads ``float(metrics["loss"])``."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.partition import make_train_step
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    log_every: int = 10
    ckpt_every: int = 0              # 0 = only final
    ckpt_dir: str = ""
    seed: int = 0
    dtype: str = "float32"
    adamw: opt.AdamWConfig = dataclasses.field(
        default_factory=lambda: opt.AdamWConfig(lr=1e-3, warmup_steps=20,
                                                total_steps=200))


def placer(device: torch.device) -> Callable[[dict], dict]:
    """The prefetcher's ``place`` hook: a numpy batch as tensors on
    ``device`` (on the card through contiguous pinned memory, so each
    copy is one asynchronous transfer)."""
    if device.type != "cuda":
        return lambda b: {k: torch.from_numpy(np.asarray(v)).to(device)
                          for k, v in b.items()}
    return lambda b: {
        k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
        .to(device, non_blocking=True) for k, v in b.items()}


def train(cfg: ModelConfig, tcfg: TrainConfig,
          log: Callable[[str], None] = print,
          device: str | torch.device = "cuda") -> dict:
    """Train ``cfg`` for ``tcfg.steps`` steps on ``device`` (default the
    card; raises without one) from ``init_params`` at ``tcfg.seed``."""
    dev = resolve_device(device)
    params = T.init_params(cfg, tcfg.seed, getattr(torch, tcfg.dtype), dev)
    opt_state = opt.init_state(params)
    step_fn = make_train_step(cfg, tcfg.adamw)

    data = Prefetcher(iter(SyntheticLM(cfg, tcfg.batch, tcfg.seq_len,
                                       seed=tcfg.seed)), place=placer(dev))
    losses = []
    t0 = time.time()
    for step in range(tcfg.steps):
        batch = next(data)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            log(f"step {step:5d} loss {loss:.4f} "
                f"ce {float(metrics['ce']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({(time.time() - t0):.1f}s)")
        if tcfg.ckpt_every and tcfg.ckpt_dir \
                and step and step % tcfg.ckpt_every == 0:
            ckpt.save(tcfg.ckpt_dir, step, params, opt_state)
    data.close()
    if tcfg.ckpt_dir:
        ckpt.save(tcfg.ckpt_dir, tcfg.steps, params, opt_state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "wall_s": time.time() - t0}
