"""Model configurations the port carries (its own copies of the JAX
package's numbers)."""

from .base import ModelConfig, get_config, smoke_variant, uniform_groups

__all__ = ["ModelConfig", "get_config", "smoke_variant", "uniform_groups"]
