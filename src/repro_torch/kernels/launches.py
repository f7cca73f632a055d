"""Launch counters of the CUDA kernels.

Each wrapper adds one to its kernel's count right after the launch is
accepted, and nowhere else: the CPU path (the plain versions) never
counts.  A caller resets the counts, runs a path, and reads them back to
show that the path went through the kernels."""
from __future__ import annotations

KERNELS = ("conv2d_dense", "conv2d_dense_ws", "conv2d_depthwise",
           "quantize", "dequantize", "flash_attention", "rwkv6_wkv",
           "mamba2_ssd")

COUNTS: dict[str, int] = {name: 0 for name in KERNELS}


def add(name: str) -> None:
    COUNTS[name] += 1


def reset() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def snapshot() -> dict[str, int]:
    return dict(COUNTS)
