"""One (arch x shape x mesh) cell -> a step, its abstract arguments
and their layouts.  The port of ``repro.launch.steps``.

Used by the dry run (the step must run at the cell's full shape on the
meta device), the roofline analyzer (depth probes) and the drivers.
``shape.kind`` selects the step:

    train   -> fn(params, opt_state, batch) -> (params, opt_state, metrics)
    prefill -> fn(params, batch)            -> (logits, caches)
    decode  -> fn(params, token, pos, caches) -> (logits, caches)

``abstract_args`` are meta tensors; ``materialize(device, seed)`` gives
real ones, so one cell runs on the meta device, on the CPU and on the
card.  With a ``mesh`` (a ``DeviceMesh``) and a ``policy`` the cell
carries the rules' layouts, ``in_placements`` and ``out_placements``
(trees of ``sharding.rules.NamedSharding``, as the reference's
``in_shardings``/``out_shardings``): ``materialize`` and ``distribute``
lay the arguments out by them (DTensors), the step runs on DTensors, and
its outputs come back in ``out_placements`` (a train step's parameters
and moments in the layout they came in, the caches in the rules' cache
layout).  Without a mesh it is the one-device cell.  Donation is in place: a train step
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
from repro_torch.sharding.rules import (NamedSharding, P, ShardingRules,
                                        scale_spec)
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
    mesh: Any = None
    policy: Optional[str] = None
    in_placements: Optional[Tuple[Any, ...]] = None
    out_placements: Any = None

    def distribute(self, args: tuple) -> tuple:
        """``args`` (plain tensors, the same on every rank) laid out by
        ``in_placements`` as DTensors, each rank keeping its own shards
        (no communication); as they are without a mesh."""
        if self.mesh is None:
            return args
        return tuple(_laid_out(a, s, compact=True)
                     for a, s in zip(args, self.in_placements))

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
            args = (params, init_opt_state(self.opt_cfg, params),
                    tree_map(fill, batch))
        elif kind == "prefill":
            args = params, tree_map(fill, self.abstract_args[1])
        else:
            _, token, _, caches = self.abstract_args
            pos = torch.tensor(self.shape.seq_len - 1, dtype=torch.int32,
                               device=dev)
            args = (params, fill(token), pos,
                    init_caches_from_specs(caches, dev))
        return self.distribute(args)


def opt_config_for(cfg: ModelConfig) -> OptConfig:
    n = analytic_param_count(cfg)
    mdt = "int8" if n > INT8_MOMENTS_ABOVE else "float32"
    return OptConfig(moment_dtype=mdt)


def _laid_out(tree, shardings, compact: bool = False):
    """Each leaf of ``tree`` in its ``NamedSharding``'s layout (a plain
    tensor, the same on every rank, becomes a DTensor first, each rank
    keeping its own slice).  ``compact`` copies a local shard that is a
    slice of a larger storage into storage of its own, so that the
    whole tensor is not kept alive (and not counted) for it."""
    from torch.distributed.tensor import DTensor, Replicate

    def lay(t, s):
        if t is None or s is None:
            return t
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, s.mesh, [Replicate()] * s.mesh.ndim,
                                   run_check=False)
        pl = s.placements_for(t.shape)
        if t.placements != pl:
            t = t.redistribute(s.mesh, pl)
        loc = t._local_tensor
        if compact and (loc.untyped_storage().nbytes()
                        > loc.numel() * loc.element_size()):
            t = DTensor.from_local(loc.clone(), s.mesh, pl, run_check=False,
                                   shape=t.shape, stride=t.stride())
        return t

    return tree_map(lay, tree, shardings)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
               policy: str = "fsdp_tp", remat: str = "full",
               prefill_impl: str = "blockwise", decode_impl: str = "naive",
               mla_absorb: bool = True, num_microbatches: int = 1,
               prefill_chunk: int = 1024) -> CellProgram:
    """The cell's step, on one device without ``mesh``, else over it with
    the rules of ``policy`` ("tp", "fsdp_tp" or "fsdp").  The defaults
    are the plain implementations, as the reference's are;
    ``prefill_impl`` and ``decode_impl`` "kernel" put prefill on K2/K3/K4
    and decode on K1 (on a mesh, each rank's local shards)."""
    rules = ShardingRules(cfg, mesh, policy) if mesh is not None else None
    dp_axes = rules.batch_axes if rules is not None else ()
    bundle = build_model(cfg, prefill_impl=prefill_impl,
                         decode_impl=decode_impl, prefill_chunk=prefill_chunk,
                         remat=remat, mla_absorb=mla_absorb, mesh=mesh,
                         dp_axes=dp_axes)
    specs = input_specs(cfg, shape)
    params_abs = bundle.init(0, device="meta")
    on = dict(mesh=mesh, policy=policy if mesh is not None else None)
    p_sh = rules.param_shardings(params_abs) if rules is not None else None

    if shape.kind == "train":
        opt_cfg = opt_config_for(cfg)
        step = make_train_step(bundle, opt_cfg,
                               num_microbatches=num_microbatches,
                               mesh=mesh, dp_axes=dp_axes)
        opt_abs = init_opt_state(opt_cfg, params_abs)
        args = (params_abs, opt_abs, specs["batch"])
        if rules is None:
            return CellProgram(cfg=cfg, shape=shape, fn=step, bundle=bundle,
                               opt_cfg=opt_cfg, abstract_args=args,
                               donate_argnums=(0, 1))
        opt_sh = {"m": p_sh, "v": p_sh,
                  "count": NamedSharding(mesh, P())}
        if opt_cfg.moment_dtype == "int8":
            sc = tree_map(lambda s: NamedSharding(mesh, scale_spec(s.spec)),
                          p_sh)
            opt_sh["m_scale"] = opt_sh["v_scale"] = sc
        out_sh = (p_sh, opt_sh, None)

        def train(params, opt_state, batch):
            params, opt_state, metrics = step(params, opt_state, batch)
            return (_laid_out(params, p_sh), _laid_out(opt_state, opt_sh),
                    metrics)

        return CellProgram(
            cfg=cfg, shape=shape, fn=train, bundle=bundle, opt_cfg=opt_cfg,
            abstract_args=args, donate_argnums=(0, 1),
            in_placements=(p_sh, opt_sh,
                           rules.shardings_for(specs["batch"], "batch")),
            out_placements=out_sh, **on)

    if shape.kind == "prefill":
        args = (params_abs, specs["batch"])
        if rules is None:
            return CellProgram(cfg=cfg, shape=shape, fn=bundle.prefill_fn,
                               bundle=bundle, abstract_args=args)
        # the output caches take the rules' cache layout (batch and kv
        # heads, or the sequence where the heads do not divide), worked
        # out from the caches of a one-device plain run on the meta device
        plain = build_model(cfg, prefill_impl="blockwise",
                            prefill_chunk=prefill_chunk, remat=remat,
                            mla_absorb=mla_absorb)
        with torch.no_grad():
            caches_abs = plain.prefill_fn(*args)[1]
        c_sh = rules.shardings_for(caches_abs, "cache")

        def prefill(params, batch):
            logits, caches = bundle.prefill_fn(params, batch)
            return logits, _laid_out(caches, c_sh)

        return CellProgram(
            cfg=cfg, shape=shape, fn=prefill, bundle=bundle,
            abstract_args=args,
            in_placements=(p_sh, rules.shardings_for(specs["batch"],
                                                     "batch")),
            out_placements=(None, c_sh), **on)

    if shape.kind != "decode":
        raise ValueError(f"unknown shape kind {shape.kind!r}")

    def decode(params, token, pos, caches):
        return bundle.decode_fn(params, token, pos, caches, inplace=True)

    args = (params_abs, specs["token"], specs["pos"], specs["caches"])
    if rules is None:
        return CellProgram(cfg=cfg, shape=shape, fn=decode, bundle=bundle,
                           abstract_args=args, donate_argnums=(3,))
    c_sh = rules.shardings_for(specs["caches"], "cache")
    tok_sh = NamedSharding(mesh, P(rules._batch_dim(shape.global_batch)))
    return CellProgram(
        cfg=cfg, shape=shape, fn=decode, bundle=bundle, abstract_args=args,
        donate_argnums=(3,),
        in_placements=(p_sh, tok_sh, NamedSharding(mesh, P()), c_sh),
        out_placements=(None, c_sh), **on)


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
