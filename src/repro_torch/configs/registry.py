"""Architecture registry: ``get_arch("<id>")`` and ``get_arch("<id>-smoke")``.

Holds all ten archs of the reference: the dense yi-9b, qwen3-8b,
stablelm-3b and starcoder2-15b, the moe deepseek-moe-16b and
deepseek-v3-671b (MLA), the ssm mamba2-1.3b, the hybrid
recurrentgemma-9b, the encoder-decoder seamless-m4t-large-v2 and the vlm
llava-next-mistral-7b."""

from __future__ import annotations

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      applicable, reduced)
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek_moe_16b
from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek_v3_671b
from repro_torch.configs.llava_next_mistral_7b import \
    CONFIG as _llava_next_mistral_7b
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2_1_3b
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3_8b
from repro_torch.configs.recurrentgemma_9b import \
    CONFIG as _recurrentgemma_9b
from repro_torch.configs.seamless_m4t_large_v2 import \
    CONFIG as _seamless_m4t_large_v2
from repro_torch.configs.stablelm_3b import CONFIG as _stablelm_3b
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2_15b
from repro_torch.configs.yi_9b import CONFIG as _yi_9b

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (_yi_9b, _qwen3_8b, _stablelm_3b, _starcoder2_15b,
                        _deepseek_moe_16b, _deepseek_v3_671b, _mamba2_1_3b,
                        _recurrentgemma_9b, _seamless_m4t_large_v2,
                        _llava_next_mistral_7b)}


def get_arch(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get_arch(name[: -len("-smoke")]))
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> list[tuple[ModelConfig, ShapeConfig, bool, str]]:
    """All 40 (arch x shape) cells with applicability verdicts."""
    cells = []
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            ok, why = applicable(arch, shape)
            cells.append((arch, shape, ok, why))
    return cells
