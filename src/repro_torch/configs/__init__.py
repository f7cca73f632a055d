"""Config registry of the port: importing this package registers every
assigned architecture, as ``repro.configs`` does.  ``base`` is a copy of
``repro.configs.base`` with its imports rewritten; each config module is a
copy of the JAX package's."""
from repro_torch.configs import (granite_moe_3b_a800m, hubert_xlarge,
                                 internvl2_76b, kimi_k2_1t_a32b,
                                 moonshot_v1_16b_a3b, phi3_mini_3_8b,
                                 qwen3_4b, rwkv6_7b, starcoder2_15b,
                                 zamba2_7b)
from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      all_configs, get_config, shape_skips)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "all_configs",
           "get_config", "shape_skips"]
