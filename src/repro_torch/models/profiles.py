"""Analytic per-layer cost profiles of the paper's CNNs.

The counterpart of ``repro.models.profiles.cnn_profile``: builds the
``ModelProfile`` the SmartSplit optimiser consumes, with layer
granularity = PyTorch module, exactly as the paper counts."""
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
