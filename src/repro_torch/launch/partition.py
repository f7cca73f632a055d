"""Step functions and the split boundary of a transformer: the port of
``repro.launch.partition``'s ``make_train_step``, ``make_prefill_step``,
``make_encode_step``, ``make_decode_step`` and ``split_boundary_struct``,
on one device.  The rest of that module (GSPMD partition specs, sharded
inputs and caches) waits for the port's mesh tooling."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dtype_policy import conv_dtype, policy_torch_dtype
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as opt
from repro_torch.tree import tree_map


class BoundaryStruct(NamedTuple):
    shape: tuple[int, ...]
    dtype: torch.dtype


def split_boundary_struct(cfg: ModelConfig, batch: int, seq_len: int,
                          dtype: str | None = None
                          ) -> tuple[BoundaryStruct, int]:
    """The tensor that crosses the client->server link under a SmartSplit
    placement, serialized in the storage-policy dtype.

    Returns ``(struct, nbytes)``: the boundary hidden state's shape
    (batch, seq_len, d_model) and torch dtype, and its wire size in bytes,
    which is exactly the I|l1 the dtype-aware cost model feeds Eq. 4."""
    tdt = policy_torch_dtype(conv_dtype(dtype))
    shape = (batch, seq_len, cfg.d_model)
    itemsize = torch.empty((), dtype=tdt).element_size()
    return BoundaryStruct(shape, tdt), int(np.prod(shape)) * itemsize


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------
def _trainable(tree):
    """Each leaf as a detached alias of its storage that requires grad."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def loss_and_grads(cfg: ModelConfig, params, batch):
    """``loss_fn`` and its gradient: (loss, metrics, trainable, grads),
    where ``trainable`` is ``params`` with its blocks as per-layer views
    (``transformer.unstack_blocks``), each a detached alias of its
    storage, and ``grads`` the gradient tree of the same structure (zeros
    for a leaf the loss does not reach, as ``jax.grad`` gives)."""
    trainable = _trainable(T.unstack_blocks(params))
    loss, metrics = T.loss_fn(cfg, trainable, batch)
    loss.backward()
    grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                     else t.grad, trainable)
    return loss.detach(), metrics, trainable, grads


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: forward, ``backward()``, then AdamW in place.

    The step differentiates per-layer views of the stacked weights
    (``transformer.unstack_blocks``), so each layer's gradient is its own
    tensor and the update writes through to the stacks; the returned
    ``params`` and moments are the objects passed in.  ``metrics`` holds
    ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` as 0-d tensors on
    the device: nothing is read back to the host."""
    ocfg = ocfg or opt.AdamWConfig()

    def train_step(params, opt_state, batch):
        loss, metrics, trainable, grads = loss_and_grads(cfg, params,
                                                         batch)
        _, state, om = opt.apply_updates(
            ocfg, trainable, grads,
            opt.AdamWState(opt_state.step, T.unstack_blocks(opt_state.mu),
                           T.unstack_blocks(opt_state.nu)))
        return params, opt_state._replace(step=state.step), {
            "loss": loss, "ce": metrics["ce"].detach(),
            "aux": metrics["aux"].detach(), **om}
    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch, cache):
        logits, cache, _ = T.forward(cfg, params, batch, mode="prefill",
                                     cache=cache)
        return logits[:, -1:], cache
    return prefill_step


def make_encode_step(cfg: ModelConfig):
    """Encoder-only archs: prefill == full forward, no cache."""
    def encode_step(params, batch):
        logits, _, _ = T.forward(cfg, params, batch, mode="prefill")
        return logits
    return encode_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, tokens, cache):
        return T.decode_step(cfg, params, tokens, cache)
    return serve_step
