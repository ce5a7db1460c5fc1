"""Train, prefill and decode steps over a (2, 2) ``("data", "model")``
mesh of four gloo ranks (``launch.steps.build_cell(..., mesh)``).

* yi-9b-smoke's f32 train step under "tp", "fsdp_tp" and "fsdp" on the
  reference's initial weights (``testing.params_from_jax``): the loss
  within 1e-5 of the reference's ``loss_fn``, the updated parameters
  within 1e-5 (relative to a leaf's largest value) of the one-rank port
  step's, and the parameters in the rules' placements after the step;
* deepseek-moe-16b-smoke (f32, ``capacity_factor`` 8, so no pair is
  dropped) under the "local" and "a2a" expert-parallel dispatches: the
  loss within 1e-4 of the reference's local dispatch, as
  ``tests/test_train.py::test_moe_a2a_matches_local_dispatch`` holds it;
* mamba2-1.3b-smoke's f32 gradients on a batch of one row under
  "fsdp_tp" within 1e-5 (relative to a leaf's largest value) of the
  mesh-less gradients;
* yi-9b-smoke's prefill and decode cells: the last-token logits of a
  prefill and of the decode step after it within 1e-5 (relative to the
  largest logit) of the mesh-less cells', with its 4 kv heads over
  "model" and with 1 kv head, whose cache the rules shard over its slots
  (each rank writes the slots it holds, then gathers them to attend).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing import run_ranks  # noqa: E402

POLICIES = ("tp", "fsdp_tp", "fsdp")
DISPATCH = ("local", "a2a")
B, S = 8, 16
LOSS_TOL, PARAM_REL_TOL, MOE_LOSS_TOL, LOGIT_REL_TOL = 1e-5, 1e-5, 1e-4, 1e-5


def _cfgs(get_arch):
    """(yi-9b-smoke, deepseek-moe-16b-smoke) in f32, the MoE at
    capacity factor 8, from either package's ``get_arch``."""
    yi = dataclasses.replace(get_arch("yi-9b-smoke"), dtype="float32")
    moe = get_arch("deepseek-moe-16b-smoke")
    moe = dataclasses.replace(moe, dtype="float32", moe=dataclasses.replace(
        moe.moe, capacity_factor=8.0))
    return yi, moe


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _train(cfg, mesh, policy, params, batch):
    """One train step (one microbatch) on the given weights: (loss,
    updated parameters, the parameters' placements before and after)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import build_cell
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.tree import tree_leaves, tree_map

    cell = build_cell(cfg, ShapeConfig("t", "train", S, B), mesh,
                      policy=policy)
    params = tree_map(torch.clone, params)
    args = cell.distribute((params, init_opt_state(cell.opt_cfg, params),
                            batch))
    before = [getattr(t, "placements", None) for t in tree_leaves(args[0])]
    p, _, m = cell.fn(*args)
    after = [getattr(t, "placements", None) for t in tree_leaves(p)]
    return (float(_full(m["loss"])), tree_map(_full, p), before == after)


def _serve(cfg, mesh, seed):
    """Last-token logits of a prefill of ``B`` x ``S`` random tokens and
    of one decode step after it (parameters from ``seed``)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import _laid_out, build_cell

    cells = {k: build_cell(cfg, ShapeConfig(k, k, S, B), mesh,
                           prefill_impl="kernel", decode_impl="kernel")
             for k in ("prefill", "decode")}
    params, batch = cells["prefill"].materialize("cpu", seed)
    with torch.no_grad():
        logits, caches = cells["prefill"].fn(params, batch)
        tok = _full(logits).argmax(-1).to(torch.int32)
        if mesh is not None:
            tok = _laid_out(tok, cells["decode"].in_placements[1])
        step, _ = cells["decode"].fn(params, tok, torch.tensor(S), caches)
    return _full(logits), _full(step)


def _one_row(mesh):
    """mamba2-1.3b-smoke's f32 gradients on a batch of one row (its
    dimension replicated over "data", the fsdp weights' products partial
    there) under "fsdp_tp", relative to the mesh-less gradients."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_arch("mamba2-1.3b-smoke"), dtype="float32")
    shape = ShapeConfig("t", "train", S, 1)
    grads = []
    for m in (None, mesh):
        cell = build_cell(cfg, shape, m, policy="fsdp_tp")
        params, _, batch = cell.materialize("cpu", 0)
        grads.append(tree_leaves(value_and_grad(cell.bundle)(params,
                                                             batch)[0]))
    return max(float((_full(g) - w).abs().max()
                     / w.abs().max().clamp_min(1e-30))
               for g, w in zip(grads[1], grads[0]))


def _ranks_body(rank, world, yi_params, moe_params, batch):
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.testing import params_from_jax
    from repro_torch.tree import tree_leaves

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    yi, moe = _cfgs(get_arch)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    params = params_from_jax(yi_params)
    _, want, _ = _train(yi, None, None, params, batch)
    for policy in POLICIES:
        loss, got, kept = _train(yi, mesh, policy, params, batch)
        rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  for a, b in zip(tree_leaves(got), tree_leaves(want)))
        out[("yi", policy)] = {"loss": loss, "param_rel": rel, "kept": kept}
    out["one_row"] = _one_row(mesh)
    params = params_from_jax(moe_params)
    for dispatch in DISPATCH:
        cfg = dataclasses.replace(moe, moe_dispatch=dispatch)
        out[("moe", dispatch)] = _train(cfg, mesh, "fsdp_tp", params,
                                        batch)[0]
    for name, cfg in (("serve", yi),
                      ("serve_mqa", dataclasses.replace(yi, num_kv_heads=1))):
        ref = _serve(cfg, None, 0)
        got = _serve(cfg, mesh, 0)
        out[name] = [float((g - r).abs().max() / r.abs().max())
                     for g, r in zip(got, ref)]
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's initial weights (numpy), a batch and its losses on
    them."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_arch as jget_arch
    from repro.models import build_model as jbuild_model

    jyi, jmoe = _cfgs(jget_arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jyi.vocab_size, (B, S)).astype(np.int32)
    tgts = rng.integers(0, jyi.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "targets": tgts}
    out = {"batch": batch}
    for name, cfg in (("yi", jyi), ("moe", jmoe)):
        bundle = jbuild_model(cfg)
        params = bundle.init(jax.random.PRNGKey(0))
        with jax.default_matmul_precision("highest"):
            _, metrics = bundle.loss_fn(params, {
                k: jax.numpy.asarray(v) for k, v in batch.items()})
        out[name] = (jax.tree.map(np.asarray, params),
                     float(metrics["loss"]))
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    return run_ranks(_ranks_body, 4, tmp_path_factory.mktemp("step"),
                     reference["yi"][0], reference["moe"][0],
                     reference["batch"], timeout=240.0)


@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_train_step_matches_the_reference_loss(ranks, reference,
                                                       policy):
    want = reference["yi"][1]
    for r in ranks:
        assert abs(r[("yi", policy)]["loss"] - want) <= LOSS_TOL


@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_update_matches_the_one_rank_step(ranks, policy):
    for r in ranks:
        assert r[("yi", policy)]["param_rel"] <= PARAM_REL_TOL


@pytest.mark.parametrize("policy", POLICIES)
def test_parameters_keep_the_rules_placements(ranks, policy):
    assert all(r[("yi", policy)]["kept"] for r in ranks)


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_expert_parallel_matches_the_reference_local_dispatch(
        ranks, reference, dispatch):
    want = reference["moe"][1]
    for r in ranks:
        assert abs(r[("moe", dispatch)] - want) <= MOE_LOSS_TOL


@pytest.mark.parametrize("case", ["serve", "serve_mqa"])
def test_prefill_and_decode_logits_match_the_mesh_less_cells(ranks, case):
    for r in ranks:
        assert max(r[case]) <= LOGIT_REL_TOL, r[case]


def test_one_row_gradients_match_the_mesh_less_step(ranks):
    for r in ranks:
        assert r["one_row"] <= PARAM_REL_TOL, r["one_row"]
