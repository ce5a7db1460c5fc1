"""Deterministic synthetic data (the serving prompt's source).

Batches are a pure function of ``(seed, step)`` via numpy Philox counters,
the same rule as the reference package, so both give the same tokens."""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _rng(seed: int, step: int, salt: int = 0) -> np.random.Generator:
    key = (np.uint64(seed) << np.uint64(32)) ^ np.uint64(step * 2 + 1)
    return np.random.Generator(np.random.Philox(key=[key, np.uint64(salt)]))


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int) -> dict:
    """Token batch of a decoder-only arch at a given step (host numpy),
    data seed 0 on a single process, as the reference's default."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"make_batch: family {cfg.family!r} is not ported yet")
    rng = _rng(0, step)
    t = rng.integers(0, cfg.vocab_size,
                     size=(shape.global_batch, shape.seq_len + 1),
                     dtype=np.int32)
    return {"tokens": t[:, :-1], "targets": t[:, 1:]}
