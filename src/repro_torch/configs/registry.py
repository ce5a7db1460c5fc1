"""Architecture registry: ``get_arch("<id>")`` and ``get_arch("<id>-smoke")``.

Holds the archs the port serves so far; the others join with their
families."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.yi_9b import CONFIG as _yi_9b

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (_yi_9b,)}


def get_arch(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get_arch(name[: -len("-smoke")]))
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
