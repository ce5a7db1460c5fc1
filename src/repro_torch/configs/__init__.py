from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      applicable, reduced)
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "applicable",
           "get_arch", "reduced"]
