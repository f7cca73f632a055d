"""The conv-path storage-dtype policy (fp32 | bf16).

SmartSplit's objectives are dominated by bytes: per-layer memory on the
client, and the boundary activation shipped across the link.  Storing conv
weights/activations in bf16 -- while keeping the kernel's fp32 accumulator
-- halves the bytes every conv reads and writes and halves the
split-boundary transfer payload.

One policy string is plumbed end to end:

* kernels (``repro_torch.kernels.conv2d``): cast storage, accumulate fp32;
* models (``repro_torch.models.cnn.apply_cnn``): activations flow in the
  policy dtype, boundary payloads are serialized in it;
* cost model (``repro_torch.models.profiles`` /
  ``repro_torch.core.costs``): memory and transfer terms scale with
  ``dtype_bytes`` so the optimiser can choose splits that are only
  feasible at bf16.

Resolution order everywhere: explicit ``dtype=`` argument, else the
``REPRO_CONV_DTYPE`` env var, else ``fp32``.  ``fp32`` is the no-downcast
default: tensors keep whatever dtype they already have.

On top of the storage policy sits the *wire*-dtype tier: the format a
split-boundary activation takes while crossing a link may differ from the
format it is stored/computed in.  ``REPRO_WIRE_DTYPE`` picks the chain-wide
wire policy (``follow`` ships the storage dtype unchanged -- the legacy
path, bit-identical); ``REPRO_LINK{k}_WIRE_DTYPE`` overrides it for hop
``k`` (a WiFi device->edge hop wants int8 while an Ethernet edge->core hop
may not).  ``int8`` means per-channel symmetric quantization: a 1-byte
payload element plus one fp32 scale per channel (see
``repro_torch.kernels.quant``), priced by ``core.costs`` and executed by
``runtime.wire``.
"""
from __future__ import annotations

import os

ENV_VAR = "REPRO_CONV_DTYPE"

CONV_DTYPES = ("fp32", "bf16")

WIRE_ENV_VAR = "REPRO_WIRE_DTYPE"

# "follow" = ship the storage dtype as-is (no re-encode; the default and
# the bit-identical legacy behaviour).  The rest force a wire format.
WIRE_DTYPES = ("follow", "fp32", "bf16", "int8")

_DTYPE_BYTES = {"fp32": 4, "bf16": 2}

# Bytes per *payload* element on the wire (scales/framing priced separately
# by core.costs for int8).
WIRE_PAYLOAD_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


def conv_dtype(dtype: str | None = None) -> str:
    """Resolve the storage-dtype policy *now* (mirrors ``conv_backend``).

    Explicit argument wins, else ``REPRO_CONV_DTYPE``, else ``fp32``."""
    d = dtype or os.environ.get(ENV_VAR, "fp32")
    if d not in CONV_DTYPES:
        source = "dtype argument" if dtype else ENV_VAR
        raise ValueError(f"{source} must be one of {CONV_DTYPES}, got {d!r}")
    return d


def dtype_bytes(policy: str) -> int:
    """Bytes per element stored under ``policy``."""
    return _DTYPE_BYTES[conv_dtype(policy)]


def policy_torch_dtype(policy: str):
    """The torch dtype tensors are stored in under ``policy``.

    Imported lazily so the numpy-only core modules stay torch-free."""
    import torch

    return {"fp32": torch.float32, "bf16": torch.bfloat16}[conv_dtype(policy)]


# ---------------------------------------------------------------------------
# Wire-dtype tier
# ---------------------------------------------------------------------------
def _check_wire(value: str, source: str) -> str:
    if value not in WIRE_DTYPES:
        raise ValueError(
            f"{source} must be one of {WIRE_DTYPES}, got {value!r}")
    return value


def wire_dtype(wire: str | None = None, hop: int | None = None) -> str:
    """Resolve the wire-dtype policy *now* (may still be ``follow``).

    Explicit argument wins, else the per-hop ``REPRO_LINK{hop}_WIRE_DTYPE``
    env var (when ``hop`` is given -- mirrors the per-hop fault knobs),
    else chain-wide ``REPRO_WIRE_DTYPE``, else ``follow``."""
    if wire is not None:
        return _check_wire(wire, "wire argument")
    if hop is not None:
        per_hop = os.environ.get(f"REPRO_LINK{hop}_WIRE_DTYPE")
        if per_hop is not None:
            return _check_wire(per_hop, f"REPRO_LINK{hop}_WIRE_DTYPE")
    return _check_wire(os.environ.get(WIRE_ENV_VAR, "follow"), WIRE_ENV_VAR)


def resolve_wire_dtype(wire: str | None = None, *,
                       storage: str | None = None,
                       hop: int | None = None) -> str:
    """The concrete wire format for one hop: ``fp32 | bf16 | int8``.

    ``follow`` (the default policy) resolves to the storage dtype, i.e. the
    boundary crosses the link exactly as stored -- the legacy byte stream."""
    w = wire_dtype(wire, hop=hop)
    if w == "follow":
        return conv_dtype(storage)
    return w


def wire_payload_bytes_per_elem(wire: str) -> int:
    """Bytes per payload element for a concrete (non-``follow``) format."""
    try:
        return WIRE_PAYLOAD_BYTES[wire]
    except KeyError:
        raise ValueError(
            f"wire format must be one of {tuple(WIRE_PAYLOAD_BYTES)}, "
            f"got {wire!r}") from None
