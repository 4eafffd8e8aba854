"""Architecture configs — one module per ported architecture."""
from repro_torch.configs.base import ARCH_IDS, ModelConfig, get_config

__all__ = ["ARCH_IDS", "ModelConfig", "get_config"]
