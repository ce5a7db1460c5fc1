"""Train-step builders.

Two execution modes, mirroring the paper's request-splitting design
(§3.4):

* ``make_train_step``        — one fused step: accumulate gradients over
  K microbatches, then apply AdamW.  Preemption granularity is the whole
  step.
* ``make_chunked_train_fns`` — ``grad_init``, ``grad_step`` and
  ``apply_step`` as *separate* programs the runtime dispatches per
  microbatch, so the monitor can synchronize and preempt between chunks
  (the paper's Fig 9).

Gradients come from ``value_and_grad``, the counterpart of
``jax.value_and_grad`` over the parameter tree: ``torch.autograd.grad``
over detached copies of the leaves (views of the same storage), so the
parameters are neither mutated nor marked as requiring grad, and any
thread can run it (the monitor's worker does).  Not
``torch.func.grad_and_value``: it differentiates with
``create_graph=True`` (so that transforms nest), which keeps the
backward's intermediates alive until the gradients return; at yi-9b's
full width that held 20.2 GB above the training state for one
microbatch of 2 x 1024 tokens against 8.0 GB here
(``train_memory.py`` on an H100).  It also refuses the saved-tensor
hooks of ``torch.utils.checkpoint`` (``remat="full"``).

The same operations in the same order run in both modes (accumulate in
``accum_dtype``, divide by K, round to ``grad_reduce_dtype``, AdamW), so a
fused step and K chunks give the same bits.  Parameters, optimizer state
and the accumulator are updated in place: the caller gives them up, as it
donates them to the reference's jitted steps, and the card holds one copy
of each.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.model_zoo import ModelBundle
from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                         init_opt_state, reduce_grad)
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

_ACCUM = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def value_and_grad(bundle: ModelBundle) -> Callable:
    """``f(params, batch) -> (grads, loss, metrics)`` of ``bundle.loss_fn``:
    the gradients have the parameters' tree and dtypes."""
    loss_fn = bundle.loss_fn

    def f(params, batch):
        batch = _on(params, batch)
        leaves, treedef = tree_flatten(params)
        ps = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(treedef, ps), batch)
            grads = torch.autograd.grad(loss, ps)
        metrics = tree_map(torch.Tensor.detach, metrics)
        return tree_unflatten(treedef, list(grads)), loss.detach(), metrics
    return f


def _on(params: Any, batch: dict) -> dict:
    """The batch's arrays as tensors on the parameters' device."""
    dev = tree_flatten(params)[0][0].device
    return tree_map(lambda x: torch.as_tensor(x, device=dev), batch)


def _accumulate(acc: Any, grads: Any) -> Any:
    """acc += grads, in place (each gradient widened exactly to acc's
    dtype)."""
    tree_map(lambda a, g: a.add_(g), acc, grads)
    return acc


def _average(opt_cfg: OptConfig, acc: Any, k: int) -> Any:
    """acc / k in ``grad_reduce_dtype``, one leaf at a time (the reference
    divides, then rounds; this keeps one f32 leaf alive, not a tree)."""
    return tree_map(lambda a: reduce_grad(opt_cfg, a / k), acc)


def _split_microbatches(batch: dict, k: int) -> list:
    def r(x):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} is not a multiple of {k} "
                             "microbatches")
        return x.reshape(k, b // k, *x.shape[1:])

    mbs = tree_map(r, batch)
    return [tree_map(lambda x: x[i], mbs) for i in range(k)]


def make_train_step(bundle: ModelBundle, opt_cfg: OptConfig,
                    num_microbatches: int = 1,
                    accum_dtype: str = "float32") -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating params and opt_state in place."""
    vg = value_and_grad(bundle)
    adt = _ACCUM[accum_dtype]

    def step(params, opt_state, batch):
        if num_microbatches == 1:
            grads, _, metrics = vg(params, batch)
            metrics = dict(metrics)
        else:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                 device=p.device), params)
            loss_sum = None
            mbs = _split_microbatches(_on(params, batch), num_microbatches)
            for mb in mbs:
                g, loss, _ = vg(params, mb)
                acc = _accumulate(acc, g)
                del g
                loss_sum = loss if loss_sum is None else loss_sum + loss
            grads = _average(opt_cfg, acc, num_microbatches)
            del acc
            loss = loss_sum / num_microbatches
            metrics = {"loss": loss, "aux_loss": torch.zeros_like(loss)}
        params, opt_state, stats = apply_updates(opt_cfg, params, grads,
                                                 opt_state)
        metrics.update(stats)
        return params, opt_state, metrics

    return step


def make_chunked_train_fns(bundle: ModelBundle, opt_cfg: OptConfig,
                           accum_dtype: str = "float32"):
    """Chunk-granular training (the paper's sync-splitting, §3.4 / Fig 9).

    grad_init(params) -> grad_acc (zeros in ``accum_dtype``);
    grad_step(params, grad_acc, microbatch) -> (grad_acc', loss)
        one microbatch forward+backward, accumulated into grad_acc;
    apply_step(params, opt_state, grad_acc, k) -> (params', opt_state',
        stats) — AdamW with the averaged accumulated gradient.

    grad_step adds into ``grad_acc`` and apply_step updates ``params`` and
    ``opt_state`` in place.  The runtime dispatches
    these as individual EXECUTE requests, so eviction and checkpoint
    requests wait at most one microbatch."""
    vg = value_and_grad(bundle)
    adt = _ACCUM[accum_dtype]

    def grad_init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                              device=p.device), params)

    def grad_step(params, grad_acc, microbatch):
        g, loss, _ = vg(params, microbatch)
        return _accumulate(grad_acc, g), loss

    def apply_step(params, opt_state, grad_acc, k):
        return apply_updates(opt_cfg, params, _average(opt_cfg, grad_acc, k),
                             opt_state)

    return grad_init, grad_step, apply_step


def make_train_state(bundle: ModelBundle, opt_cfg: OptConfig, seed: int,
                     device="cuda"):
    """(params, opt_state): parameters from ``seed`` on ``device`` (the
    card unless the caller asks for the CPU) and zero moments."""
    params = bundle.init(seed, device=device)
    return params, init_opt_state(opt_cfg, params)
