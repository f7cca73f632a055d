"""AdamW of the PyTorch port: ``repro.training.optimizer``'s formula,
operation for operation -- decoupled weight decay added to the Adam
direction, global grad-norm clipping, linear warmup + cosine schedule, and
fp32 moments whatever the parameter dtype.

Not ``torch.optim.AdamW``: that applies the decay as a separate multiply
of the parameter and adds ``eps`` after dividing by the bias correction,
so the two drift apart.

The update is in place, leaf by leaf: ``params``, ``mu`` and ``nu`` are
written through, the gradients are used as scratch space (they hold
nothing useful afterwards), and each leaf needs at most one temporary of
its size (two for a bf16 leaf, whose fp32 gradient is a copy).  The
schedule, the clip scale and the bias corrections are fp32 tensors on the
parameters' device, as JAX computes them from its int32 step, so no step
reads a value back to the host."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Any
    nu: Any


def init_state(params) -> AdamWState:
    some = leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=some.device),
        mu=tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                      device=t.device), params),
        nu=tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                      device=t.device), params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """fp32 learning rate at an int32 step tensor."""
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _global_norm(tree) -> torch.Tensor:
    total = 0
    for g in leaves(tree):
        total = total + torch.square(g.float()).sum()
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState):
    """Update ``params``, ``state.mu`` and ``state.nu`` in place (``grads``
    is scratch).  Returns (params, new_state, {"grad_norm", "lr"}), the
    trees the same objects as given."""
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip else None
    step = state.step + 1
    b1, b2 = cfg.betas
    lr = schedule(cfg, state.step)
    step32 = step.float()
    bc1 = 1 - torch.pow(b1, step32)
    bc2 = 1 - torch.pow(b2, step32)
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(state.mu), leaves(state.nu),
                          strict=True):
        g = g if g.dtype == torch.float32 else g.float()
        if scale is not None:
            g.mul_(scale)
        tmp = torch.mul(g, 1 - b1)                      # (1-b1) g
        m.mul_(b1).add_(tmp)
        torch.mul(g, 1 - b2, out=tmp).mul_(g)           # (1-b2) g g
        v.mul_(b2).add_(tmp)
        torch.div(v, bc2, out=tmp).sqrt_().add_(cfg.eps)
        torch.div(m, bc1, out=g).div_(tmp)              # mhat / (..+eps)
        tmp.copy_(p).mul_(cfg.weight_decay)             # wd p
        g.add_(tmp).mul_(lr)                            # lr delta
        if p.dtype == torch.float32:
            p.sub_(g)
        else:
            p.copy_(tmp.copy_(p).sub_(g))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": gnorm, "lr": lr}
