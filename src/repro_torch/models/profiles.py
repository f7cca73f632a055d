"""Analytic per-layer cost profiles of the paper's CNNs.

The counterpart of ``repro.models.profiles``: ``cnn_profile`` builds the
``ModelProfile`` the SmartSplit optimiser consumes, with layer
granularity = PyTorch module, exactly as the paper counts;
``transformer_profile`` (a verbatim copy) profiles a transformer config
block by block."""
from __future__ import annotations

import numpy as np

from repro_torch.core.costs import LayerProfile, ModelProfile
from repro_torch.core.dtype_policy import conv_dtype
from repro_torch.core.dtype_policy import dtype_bytes as policy_bytes
from repro_torch.models import cnn as cnn_lib


def cnn_profile(name: str, batch: int = 1,
                dtype_bytes: int | None = None,
                in_shape: tuple = cnn_lib.INPUT_SHAPE,
                dtype: str | None = None,
                layers: list | None = None) -> ModelProfile:
    """Analytic profile under a storage-dtype policy.

    ``dtype`` (``fp32`` | ``bf16``; default resolves ``REPRO_CONV_DTYPE``)
    scales every byte term -- weights, activations, boundary payloads, the
    input upload -- so NSGA-II/TOPSIS sees the memory and transfer costs
    the bf16 execution path actually incurs.  ``dtype_bytes`` overrides
    the per-element size directly.  ``layers`` profiles an explicit layer
    list under ``name`` instead of looking the name up in
    ``CNN_MODELS``."""
    policy = conv_dtype(dtype)
    if dtype_bytes is None:
        dtype_bytes = policy_bytes(policy)
    else:
        policy = {4: "fp32", 2: "bf16"}.get(dtype_bytes, policy)
    if layers is None:
        layers = cnn_lib.CNN_MODELS[name]
    shapes = cnn_lib.shapes_through(layers, in_shape)
    profs = []
    shape = in_shape
    for layer, out_shape in zip(layers, shapes):
        flops, params = cnn_lib.layer_flops_params(layer, shape)
        act = float(np.prod(out_shape)) * dtype_bytes * batch
        profs.append(LayerProfile(
            name=f"{name}.{len(profs)}.{layer.kind}", kind=layer.kind,
            flops=flops * batch, param_bytes=params * dtype_bytes,
            act_bytes=act, boundary_bytes=act,
            # int8-wire scale groups: channel axis for (C, H, W) feature
            # maps, per-tensor for flat activations (runtime convention in
            # kernels.quant.default_channel_axis)
            boundary_channels=float(out_shape[0])
            if len(out_shape) >= 3 else 1.0))
        shape = out_shape
    return ModelProfile(
        name=name, layers=tuple(profs),
        input_bytes=float(np.prod(in_shape)) * dtype_bytes * batch,
        dtype=policy,
        input_channels=float(in_shape[0]) if len(in_shape) >= 3 else 1.0)


# ---------------------------------------------------------------------------
# Transformer architectures (assigned pool)
# ---------------------------------------------------------------------------
def transformer_profile(cfg, *, seq_len: int, batch: int,
                        mode: str = "prefill",
                        dtype_bytes: int = 2) -> ModelProfile:
    """Per-block profile for a ``configs.base.ModelConfig``.

    mode: 'prefill' (process seq_len tokens) or 'decode' (one token against
    a cache of seq_len).  The boundary payload if split after block i is the
    hidden state (batch, tokens, d_model) plus, for decode, nothing extra --
    recurrent/KV state lives on whichever side owns the layer; state that
    must *migrate* at plan time is charged via ``state_bytes`` so the
    optimiser sees the cost of cutting inside a recurrent stack."""
    from repro_torch.configs.base import ModelConfig  # local import, no cycle
    assert isinstance(cfg, ModelConfig)
    tokens = batch * (seq_len if mode == "prefill" else 1)
    d = cfg.d_model
    hidden_bytes = float(tokens * d) * dtype_bytes
    profs = []
    for i, block in enumerate(cfg.block_kinds()):
        flops = cfg.block_flops(block, seq_len=seq_len, batch=batch,
                                mode=mode)
        params = cfg.block_params(block)
        state = cfg.block_state_bytes(block, batch=batch,
                                      dtype_bytes=dtype_bytes)
        profs.append(LayerProfile(
            name=f"{cfg.name}.{i}.{block}", kind=block,
            flops=flops, param_bytes=params * dtype_bytes,
            act_bytes=hidden_bytes, boundary_bytes=hidden_bytes,
            state_bytes=state,
            boundary_channels=float(d)))  # per-feature int8 scales
    # Embedding + unembedding bracket the stack; fold them into first/last.
    embed_flops = 0.0
    unembed_flops = 2.0 * tokens * d * cfg.padded_vocab
    profs[0] = LayerProfile(
        name=profs[0].name, kind=profs[0].kind,
        flops=profs[0].flops + embed_flops,
        param_bytes=profs[0].param_bytes + cfg.padded_vocab * d * dtype_bytes,
        act_bytes=profs[0].act_bytes, boundary_bytes=profs[0].boundary_bytes,
        state_bytes=profs[0].state_bytes,
        boundary_channels=profs[0].boundary_channels)
    last = profs[-1]
    profs[-1] = LayerProfile(
        name=last.name, kind=last.kind, flops=last.flops + unembed_flops,
        param_bytes=last.param_bytes
        + (0 if cfg.tie_embeddings else cfg.padded_vocab * d * dtype_bytes),
        act_bytes=last.act_bytes, boundary_bytes=last.boundary_bytes,
        state_bytes=last.state_bytes,
        boundary_channels=last.boundary_channels)
    input_bytes = float(batch * (seq_len if mode == "prefill" else 1)) * 4
    return ModelProfile(name=f"{cfg.name}:{mode}", layers=tuple(profs),
                        input_bytes=max(input_bytes, 1.0),
                        dtype={4: "fp32", 2: "bf16"}.get(dtype_bytes,
                                                         "fp32"),
                        input_follows_dtype=False)   # int32 token ids
