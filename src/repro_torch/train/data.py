"""Deterministic synthetic data pipeline.

Batches are a pure function of ``(seed, step)`` via numpy Philox
counters, the same rule as the reference package, so both give the same
arrays, and a resumed or migrated task regenerates exactly the batch
stream it would have seen.  A background prefetch thread overlaps host
batch generation with device compute.  Every family of the reference has
its batch: tokens and targets; for vlm also ``img_emb``, the stubbed image
frontend's patch embeddings spliced in front of the text; for encdec the
stubbed speech frontend's frame embeddings ``src_emb`` and the target's
``tgt_tokens`` and ``tgt_targets``.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class DataConfig:
    seed: int = 0
    process_index: int = 0
    process_count: int = 1


def _rng(seed: int, step: int, salt: int = 0) -> np.random.Generator:
    key = (np.uint64(seed) << np.uint64(32)) ^ np.uint64(step * 2 + 1)
    return np.random.Generator(np.random.Philox(key=[key, np.uint64(salt)]))


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
               data_cfg: DataConfig | None = None,
               batch_override: Optional[int] = None,
               seq_override: Optional[int] = None) -> dict:
    """Training batch for (arch, shape) at a given step (host numpy).
    encdec: ``S`` source frames and ``max(S * tgt_ratio, 8)`` target
    tokens; vlm: ``max(S - num_image_tokens, 8)`` text tokens after the
    image's ``num_image_tokens`` embeddings."""
    dc = data_cfg or DataConfig()
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    B_local = B // dc.process_count
    rng = _rng(dc.seed, step, dc.process_index)

    def toks(*s):
        return rng.integers(0, cfg.vocab_size, size=s, dtype=np.int32)

    if cfg.family == "encdec":
        T = max(int(S * cfg.tgt_ratio), 8)
        tgt = toks(B_local, T + 1)
        return {
            "src_emb": rng.standard_normal(
                (B_local, S, cfg.d_model), dtype=np.float32) * 0.02,
            "tgt_tokens": tgt[:, :-1],
            "tgt_targets": tgt[:, 1:],
        }
    if cfg.family == "vlm":
        Stext = max(S - cfg.num_image_tokens, 8)
        t = toks(B_local, Stext + 1)
        return {
            "tokens": t[:, :-1],
            "targets": t[:, 1:],
            "img_emb": rng.standard_normal(
                (B_local, cfg.num_image_tokens, cfg.d_model),
                dtype=np.float32) * 0.02,
        }
    t = toks(B_local, S + 1)
    return {"tokens": t[:, :-1], "targets": t[:, 1:]}


class PrefetchingLoader:
    """Iterator with a background producer thread (depth-bounded queue)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: DataConfig | None = None, start_step: int = 0,
                 depth: int = 2, batch_override: Optional[int] = None,
                 seq_override: Optional[int] = None):
        self.cfg, self.shape = cfg, shape
        self.data_cfg = data_cfg or DataConfig()
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._overrides = (batch_override, seq_override)
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        step = self.step
        bo, so = self._overrides
        while not self._stop.is_set():
            b = make_batch(self.cfg, self.shape, step, self.data_cfg, bo, so)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, b = self._q.get()
        self.step = step + 1
        return b

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()
