"""Shared builder: (arch x shape) -> a step and its abstract arguments, on
one device.  The port of ``repro.launch.steps``.

Used by the dry run (the step must run at the cell's full shape on the
meta device), the roofline analyzer (depth probes) and the drivers.
``shape.kind`` selects the step:

    train   -> fn(params, opt_state, batch) -> (params, opt_state, metrics)
    prefill -> fn(params, batch)            -> (logits, caches)
    decode  -> fn(params, token, pos, caches) -> (logits, caches)

``abstract_args`` are meta tensors; ``materialize(device, seed)`` gives
real ones, so one cell runs on the meta device, on the CPU and on the
card.  The reference's ``mesh`` and ``policy`` (its sharding rules) wait
for a port over several devices.  Donation is in place: a train step
updates the parameters and moments it was given (``donate_argnums``
(0, 1), as the reference donates them), a decode step writes the caches
it was given (3,).  Training runs the plain forwards only (no kernel has
a backward), as the reference's default ``train_impl="naive"`` does.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import (ModelBundle, analytic_param_count,
                                          build_model, input_specs)
from repro_torch.serve.kvcache import init_caches_from_specs
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import tree_map

# Above this parameter count, Adam moments are stored as 8-bit, as the
# reference does (deepseek-v3-671b).
INT8_MOMENTS_ABOVE = 100e9


@dataclass
class CellProgram:
    cfg: ModelConfig
    shape: ShapeConfig
    fn: Callable
    abstract_args: Tuple[Any, ...]
    bundle: ModelBundle
    opt_cfg: Optional[OptConfig] = None
    donate_argnums: Tuple[int, ...] = ()

    def materialize(self, device="cuda", seed: int = 0) -> tuple:
        """The step's arguments on ``device`` (the card unless the caller
        asks for another): parameters from ``seed``, zero moments, a batch
        of random tokens (embeddings N(0, 0.02)) from a generator seeded by
        ``seed``; a decode step gets empty caches (every ``kv_pos`` unset)
        and position ``seq_len - 1``."""
        dev = resolve_device(device)
        params = self.bundle.init(seed, device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)

        def fill(t):
            if t.dtype.is_floating_point:
                return torch.randn(t.shape, generator=gen, device=dev,
                                   dtype=torch.float32).mul_(0.02).to(t.dtype)
            return torch.randint(0, self.cfg.vocab_size, t.shape,
                                 generator=gen, device=dev, dtype=t.dtype)

        kind = self.shape.kind
        if kind == "train":
            _, _, batch = self.abstract_args
            return (params, init_opt_state(self.opt_cfg, params),
                    tree_map(fill, batch))
        if kind == "prefill":
            return params, tree_map(fill, self.abstract_args[1])
        _, token, _, caches = self.abstract_args
        pos = torch.tensor(self.shape.seq_len - 1, dtype=torch.int32,
                           device=dev)
        return (params, fill(token), pos,
                init_caches_from_specs(caches, dev))


def opt_config_for(cfg: ModelConfig) -> OptConfig:
    n = analytic_param_count(cfg)
    mdt = "int8" if n > INT8_MOMENTS_ABOVE else "float32"
    return OptConfig(moment_dtype=mdt)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, *, remat: str = "full",
               prefill_impl: str = "blockwise", decode_impl: str = "naive",
               mla_absorb: bool = True, num_microbatches: int = 1,
               prefill_chunk: int = 1024) -> CellProgram:
    """The cell's step on one device.  The defaults are the plain
    implementations, as the reference's are; ``prefill_impl`` and
    ``decode_impl`` "kernel" put prefill on K2/K3/K4 and decode on K1."""
    bundle = build_model(cfg, prefill_impl=prefill_impl,
                         decode_impl=decode_impl, prefill_chunk=prefill_chunk,
                         remat=remat, mla_absorb=mla_absorb)
    specs = input_specs(cfg, shape)
    params_abs = bundle.init(0, device="meta")

    if shape.kind == "train":
        opt_cfg = opt_config_for(cfg)
        step = make_train_step(bundle, opt_cfg,
                               num_microbatches=num_microbatches)
        return CellProgram(
            cfg=cfg, shape=shape, fn=step, bundle=bundle, opt_cfg=opt_cfg,
            abstract_args=(params_abs, init_opt_state(opt_cfg, params_abs),
                           specs["batch"]),
            donate_argnums=(0, 1))

    if shape.kind == "prefill":
        return CellProgram(cfg=cfg, shape=shape, fn=bundle.prefill_fn,
                           bundle=bundle,
                           abstract_args=(params_abs, specs["batch"]))

    if shape.kind != "decode":
        raise ValueError(f"unknown shape kind {shape.kind!r}")

    def decode(params, token, pos, caches):
        return bundle.decode_fn(params, token, pos, caches, inplace=True)

    return CellProgram(
        cfg=cfg, shape=shape, fn=decode, bundle=bundle,
        abstract_args=(params_abs, specs["token"], specs["pos"],
                       specs["caches"]),
        donate_argnums=(3,))


def sweep(out_path: str, key: Callable[[dict], str], todo: List[dict],
          run: Callable[[dict], dict], report: Callable, *,
          force: bool = False) -> Dict[str, dict]:
    """The resumable sweep of the dry run and the roofline: ``run(probe)``
    for each probe record of ``todo`` whose ``key`` has no "ok" or
    "skipped" record in the JSON list at ``out_path`` (every probe with
    ``force``), the file rewritten after each run; ``report(i, n, record,
    seconds)`` prints its line.  Returns the records by key."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    results: Dict[str, dict] = {}
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            results = {key(r): r for r in json.load(f)}
    for i, probe in enumerate(todo):
        done = results.get(key(probe))
        if done is not None and done["status"] in ("ok", "skipped"):
            continue
        t0 = time.perf_counter()
        rec = run(probe)
        results[key(rec)] = rec
        with open(out_path, "w") as f:
            json.dump(list(results.values()), f, indent=1)
        report(i, len(todo), rec, time.perf_counter() - t0)
    return results
