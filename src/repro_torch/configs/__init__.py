"""Model configurations the port carries (its own copies of the JAX
package's numbers). Importing this package registers them all."""

from .base import (INPUT_SHAPES, InputShape, LayerGroups, ModelConfig,
                   get_config, list_configs, pattern_groups, register,
                   smoke_variant, uniform_groups)

# import every arch module so the registry is populated
from . import (command_r_35b, dbrx_132b, gemma3_27b, llama2_7b,  # noqa
               llama3_2_1b, llama4_maverick_400b_a17b, musicgen_medium,
               paligemma_3b, recurrentgemma_2b, rwkv6_7b, starcoder2_7b)

__all__ = ["INPUT_SHAPES", "InputShape", "LayerGroups", "ModelConfig",
           "get_config", "list_configs", "pattern_groups", "register",
           "smoke_variant", "uniform_groups"]
