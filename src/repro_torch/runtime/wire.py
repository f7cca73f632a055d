"""Boundary wire codec: (de)serialize split-boundary activations in a
wire format decoupled from the storage dtype.

The counterpart of ``repro.runtime.wire``, with payload bytes identical
to it for the same host values:

* a float wire (``fp32``/``bf16``) ships the raw bytes of the tensor in
  that dtype -- bfloat16 travels as its 16-bit patterns (numpy has no
  bfloat16, so the tensor is viewed as int16 on the way out and back);
* ``int8`` ships a two-part ``pack_frames`` buffer of (fp32 per-channel
  scales, int8 values), whose per-part crc32s let the transfer layer
  attribute corruption to the scales frame vs the data frame.  The codec
  writes both parts into one buffer (``kernels.quant.quantize_packed``),
  which crosses to the host in one asynchronous copy into pinned memory
  and one wait on the stream; the decoder puts the two verified frames
  into one pinned buffer of the same layout, which crosses back in one
  copy that the dequantize kernel reads.

``decode_boundary`` restores the storage dtype on the encoding tensor's
device; a fault-free encode/decode is bit-identical to
``kernels.quant.boundary_roundtrip`` of the same tensor."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.dtype_policy import policy_torch_dtype
from repro_torch.kernels.quant import (default_channel_axis,
                                       dequantize_packed, quantize_packed,
                                       scale_count, values_offset)
from repro_torch.runtime.transfer import pack_frames, unpack_frames
from repro_torch.spans import span

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


def _to_host(buf: torch.Tensor) -> torch.Tensor:
    """``buf`` in host memory: a device buffer in one asynchronous copy into
    pinned memory (PyTorch's caching host allocator), then one wait on the
    stream."""
    with span("codec/to_host"):
        if buf.device.type == "cpu":
            return buf
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        torch.cuda.current_stream(buf.device).synchronize()
        return host


def encode_boundary(arr: torch.Tensor, wire: str
                    ) -> tuple[bytes, BoundaryMeta]:
    """Encode ``arr`` for the wire; returns ``(payload, meta)``.

    ``wire`` must be concrete (``fp32``/``bf16``/``int8``) -- resolve
    ``follow`` with ``core.dtype_policy.resolve_wire_dtype`` first.  When
    the wire format equals the tensor's dtype the payload is its raw
    bytes (the legacy path)."""
    with span("codec/encode"):
        shape = tuple(int(d) for d in arr.shape)
        raw_bytes = int(arr.numel()) * arr.element_size()
        if wire == "int8":
            axis = default_channel_axis(arr.ndim)
            groups = scale_count(shape, axis)
            host = memoryview(_to_host(quantize_packed(arr, axis)).numpy())
            with span("codec/pack"):
                payload = pack_frames(host[:4 * groups],
                                      host[values_offset(groups):])
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
    with span("codec/decode"):
        if meta.wire == "int8":
            s_b, q_b = unpack_frames(memoryview(payload),
                                     meta.framed or INT8_FRAME_LABELS)
            groups = scale_count(meta.shape, meta.axis)
            off, n = values_offset(groups), math.prod(meta.shape)
            if len(s_b) != 4 * groups or len(q_b) != n:
                raise ValueError(f"decode_boundary: frames of {len(s_b)} "
                                 f"and {len(q_b)} bytes for {groups} "
                                 f"scales and {n} values")
            with span("codec/upload"):
                host = torch.empty(off + n, dtype=torch.uint8,
                                   pin_memory=meta.device.type == "cuda")
                h = host.numpy()
                h[:4 * groups] = np.frombuffer(s_b, np.uint8)
                h[off:] = np.frombuffer(q_b, np.uint8)
                return dequantize_packed(
                    host.to(meta.device, non_blocking=True),
                    meta.shape, meta.axis, meta.storage)
        x = tensor_from_bytes(payload, policy_torch_dtype(meta.wire),
                              meta.shape, meta.device)
        return x if x.dtype == meta.storage else x.to(meta.storage)
