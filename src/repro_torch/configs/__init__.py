"""The port's own copies of the reference's model configurations."""
from .base import ModelConfig, all_configs, get_config

__all__ = ["ModelConfig", "all_configs", "get_config"]
