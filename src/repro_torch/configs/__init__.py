"""Architecture configs (assigned pool) + input shapes + registry."""

from .registry import (ARCH_IDS, all_archs, get_config, get_smoke_config,
                       serving_config, shape_supported)
from .shapes import SHAPES, InputShape

__all__ = ["ARCH_IDS", "all_archs", "get_config", "get_smoke_config",
           "serving_config", "shape_supported", "SHAPES", "InputShape"]
