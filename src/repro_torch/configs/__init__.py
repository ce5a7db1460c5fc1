from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      applicable, reduced)
from repro_torch.configs.registry import (ARCHS, all_cells, get_arch,
                                          get_shape)

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "all_cells",
           "applicable", "get_arch", "get_shape", "reduced"]
