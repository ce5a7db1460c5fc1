"""Architecture registry: ``get_arch("<id>")`` and ``get_arch("<id>-smoke")``.

Holds the archs the port serves so far (dense yi-9b, ssm mamba2-1.3b,
hybrid recurrentgemma-9b); the others join with their families."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2_1_3b
from repro_torch.configs.recurrentgemma_9b import \
    CONFIG as _recurrentgemma_9b
from repro_torch.configs.yi_9b import CONFIG as _yi_9b

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (_yi_9b, _mamba2_1_3b, _recurrentgemma_9b)}


def get_arch(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get_arch(name[: -len("-smoke")]))
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
