"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and raise when no CUDA device
is present: they never carry on silently on the CPU.  The CPU runs only
when the caller asks for it (``device="cpu"``), and then every kernel
wrapper takes its plain PyTorch version."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run the plain PyTorch "
            f"versions on the CPU")
    return dev


def strict_fp32() -> None:
    """Keep fp32 matmuls and cuDNN convs in full fp32 on the card (the
    cuDNN default is TF32, which keeps about three decimal digits)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
