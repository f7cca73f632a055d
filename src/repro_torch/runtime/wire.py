"""Boundary wire codec: (de)serialize split-boundary activations in a
wire format decoupled from the storage dtype.

The counterpart of ``repro.runtime.wire``, with payload bytes identical
to it for the same host values:

* a float wire (``fp32``/``bf16``) ships the raw bytes of the tensor in
  that dtype -- bfloat16 travels as its 16-bit patterns (numpy has no
  bfloat16, so the tensor is viewed as int16 on the way out and back);
* ``int8`` ships a two-part ``pack_frames`` buffer of (fp32 per-channel
  scales, int8 values), whose per-part crc32s let the transfer layer
  attribute corruption to the scales frame vs the data frame.

``decode_boundary`` restores the storage dtype on the encoding tensor's
device; a fault-free encode/decode is bit-identical to
``kernels.quant.boundary_roundtrip`` of the same tensor."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dtype_policy import policy_torch_dtype
from repro_torch.kernels.quant import (default_channel_axis,
                                       dequantize_boundary,
                                       quantize_boundary)
from repro_torch.runtime.transfer import pack_frames, unpack_frames

# Part labels for framed int8 payloads -- the chaos harness keys on these
# to count scales-frame vs data-frame corruption hits.
INT8_FRAME_LABELS = ("scales", "data")


@dataclasses.dataclass(frozen=True)
class BoundaryMeta:
    """Receiver-side description of one encoded boundary payload.

    Travels out of band: shape/dtype/axis/device are plan facts both
    endpoints already agree on -- only the payload crosses the (faulty)
    link."""

    wire: str                    # concrete wire format of the payload
    storage: torch.dtype         # dtype decode restores
    shape: tuple[int, ...]
    device: torch.device = torch.device("cpu")   # where decode lands
    axis: int | None = None      # int8 scale-group axis (None = per-tensor)
    framed: tuple[str, ...] | None = None  # pack_frames labels (int8 only)
    raw_bytes: int = 0           # storage-dtype serialized size (stats)


def host_bytes(t: torch.Tensor) -> bytes:
    """The tensor's raw bytes in its own dtype (bfloat16 as its bits)."""
    host = t.detach().to("cpu").contiguous()
    if host.dtype == torch.bfloat16:
        host = host.view(torch.int16)
    return host.numpy().tobytes()


def tensor_from_bytes(data: bytes, dtype: torch.dtype, shape,
                      device: torch.device) -> torch.Tensor:
    """Invert ``host_bytes``.  ``np.frombuffer`` gives read-only memory,
    so the host array is copied before it becomes a tensor."""
    np_dtype = {torch.float32: np.float32, torch.bfloat16: np.int16,
                torch.int8: np.int8}[dtype]
    host = torch.from_numpy(np.frombuffer(data, np_dtype).copy())
    if dtype == torch.bfloat16:
        host = host.view(torch.bfloat16)
    return host.reshape(tuple(shape)).to(device)


def encode_boundary(arr: torch.Tensor, wire: str
                    ) -> tuple[bytes, BoundaryMeta]:
    """Encode ``arr`` for the wire; returns ``(payload, meta)``.

    ``wire`` must be concrete (``fp32``/``bf16``/``int8``) -- resolve
    ``follow`` with ``core.dtype_policy.resolve_wire_dtype`` first.  When
    the wire format equals the tensor's dtype the payload is its raw
    bytes (the legacy path)."""
    shape = tuple(int(d) for d in arr.shape)
    raw_bytes = int(arr.numel()) * arr.element_size()
    if wire == "int8":
        axis = default_channel_axis(arr.ndim)
        q, scales = quantize_boundary(arr, axis)
        payload = pack_frames(host_bytes(scales), host_bytes(q))
        return payload, BoundaryMeta(
            wire=wire, storage=arr.dtype, shape=shape, device=arr.device,
            axis=axis, framed=INT8_FRAME_LABELS, raw_bytes=raw_bytes)
    tdt = policy_torch_dtype(wire)
    sent = arr if arr.dtype == tdt else arr.to(tdt)
    return host_bytes(sent), BoundaryMeta(
        wire=wire, storage=arr.dtype, shape=shape, device=arr.device,
        raw_bytes=raw_bytes)


def decode_boundary(payload: bytes, meta: BoundaryMeta) -> torch.Tensor:
    """Invert ``encode_boundary`` back to a tensor in the storage dtype
    on ``meta.device``.  Decoding an uncorrupted payload reproduces
    ``boundary_roundtrip(arr, meta.wire)`` bit-for-bit."""
    if meta.wire == "int8":
        s_b, q_b = unpack_frames(payload, meta.framed or INT8_FRAME_LABELS)
        q = tensor_from_bytes(q_b, torch.int8, meta.shape, meta.device)
        scales = tensor_from_bytes(s_b, torch.float32, (-1,), meta.device)
        return dequantize_boundary(q, scales, meta.axis,
                                   out_dtype=meta.storage)
    x = tensor_from_bytes(payload, policy_torch_dtype(meta.wire), meta.shape,
                          meta.device)
    return x if x.dtype == meta.storage else x.to(meta.storage)
