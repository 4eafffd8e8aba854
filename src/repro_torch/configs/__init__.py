"""Architecture configs — one module per ported architecture."""
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig, ShapeCell, all_cells,
                                      cells_for, get_config)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeCell", "all_cells", "cells_for",
           "get_config"]
