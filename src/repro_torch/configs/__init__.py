"""Arch configs. ``get_config(name)`` loads CONFIG from the module."""
from repro_torch.configs.base import (ARCHS, PAPER_ARCHS, SHAPES,
                                      ModelConfig, OVSFConfig, ShapeConfig,
                                      get_config, get_smoke_config,
                                      smoke_variant)

__all__ = ["ARCHS", "PAPER_ARCHS", "SHAPES", "ModelConfig", "OVSFConfig",
           "ShapeConfig", "get_config", "get_smoke_config", "smoke_variant"]
