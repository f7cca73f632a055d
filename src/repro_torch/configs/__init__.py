"""Config registry of the port: importing this package registers the
architectures whose mixers the port's sequence kernels compute (Qwen3-4B's
attention, RWKV6-7B's WKV, Zamba2-7B's Mamba2 SSD and shared attention).
``base`` is a copy of ``repro.configs.base`` with its imports rewritten;
each config module is a copy of the JAX package's."""
from repro_torch.configs import qwen3_4b, rwkv6_7b, zamba2_7b  # noqa: F401
from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      all_configs, get_config, shape_skips)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "all_configs",
           "get_config", "shape_skips"]
