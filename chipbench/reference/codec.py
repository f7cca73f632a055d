"""The int8 boundary codec in plain PyTorch: what a split's receiver
decodes.

Per-channel symmetric int8 for feature maps (channel axis 1, the group
spanning the whole batch), one scale for a flat tensor:

    absmax_c = max |x_c|
    scale_c  = absmax_c * fl32(1/127)      (1.0 for an all-zero group)
    q        = clip(round_half_even(x / scale_c), -127, 127)
    x'       = q * scale_c, stored in the storage dtype

The scale is the rounded product by fl32(1/127), and x / scale a true
division by a tensor, as the wire's contract states."""
from __future__ import annotations

import torch

INV127 = float.fromhex("0x1.020408p-7")


def _scales(absmax: torch.Tensor) -> torch.Tensor:
    inv = torch.full_like(absmax, INV127)
    return torch.where(absmax > 0.0, absmax * inv, torch.ones_like(absmax))


def roundtrip(x: torch.Tensor, store) -> torch.Tensor:
    """The boundary ``x`` (fp32 holding storage values) after an int8
    encode and decode, rounded to the storage by ``store``."""
    if x.ndim >= 3:
        red = tuple(a for a in range(x.ndim) if a != 1)
        shape = [1] * x.ndim
        shape[1] = x.shape[1]
        scale = _scales(x.abs().amax(dim=red)).reshape(shape)
    else:
        scale = _scales(x.abs().amax().reshape(()))
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0)
    return store(q * scale)


def payload_bytes(shape: tuple[int, ...]) -> int:
    """Bytes one encoded boundary puts on the wire in one attempt: the
    two-part frame (u32 part count, then a u32 length and a u32 crc32 a
    part), the fp32 scales, the int8 values, and the transfer's own
    8-byte header (crc32 and length)."""
    groups = shape[1] if len(shape) >= 3 else 1
    values = 1
    for d in shape:
        values *= int(d)
    return 4 + 2 * 8 + 4 * groups + values + 8
