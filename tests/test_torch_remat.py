"""``remat="dots"`` in the port: each repetition of a segment (an encoder
or decoder layer of the encoder-decoder) runs under non-reentrant
``torch.utils.checkpoint`` with a selective-checkpoint policy that saves
the outputs of the products without batch dimensions (``aten.mm``,
``aten.addmm``: the weight projections) and recomputes the rest, as the
reference's ``dots_with_no_batch_dims_saveable`` does.

For six family smokes in f32 (dense, moe, ssm, hybrid, encoder-decoder,
vlm):

* the loss under "dots" equals the loss under "none" to the bit, and each
  gradient leaf is within 1e-6 of the leaf's largest value (the bar
  ``test_torch_train.py::test_remat_full_matches_none`` sets for "full",
  whose recomputation may sum in another order);
* the same loss and gradients match the reference's ``jax.grad`` with
  ``remat="dots"`` on shared weights, at the training-parity tolerances
  (loss 1e-5 relative, every gradient leaf 1e-4 of its largest value);
* the bytes kept for the backward order full < dots < none: the tensors
  that ``saved_tensors_hooks`` see (outside a checkpoint, and each
  checkpoint's inputs) plus the outputs the "dots" policy saves, the
  parameters' own storage not counted; every tensor "dots" saves inside a
  segment is an ``mm``/``addmm`` output.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.checkpoint import CheckpointPolicy  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.testing import params_from_jax  # noqa: E402
from repro_torch.train import make_batch  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.tree import tree_unflatten  # noqa: E402

SMOKES = ["yi-9b-smoke", "deepseek-moe-16b-smoke", "mamba2-1.3b-smoke",
          "recurrentgemma-9b-smoke", "seamless-m4t-large-v2-smoke",
          "llava-next-mistral-7b-smoke"]
SHAPE = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=4)
LOSS_REL_TOL, GRAD_REL_TOL = 1e-5, 1e-4
REMAT_TOL = 1e-6
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _shared(arch):
    """(reference config, reference params, port config, port params,
    batch), f32."""
    jcfg = dataclasses.replace(jget_arch(arch), dtype="float32")
    tcfg = dataclasses.replace(get_arch(arch), dtype="float32")
    jp = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, jp, tcfg, params_from_jax(jp), make_batch(tcfg, SHAPE, 0)


@pytest.mark.parametrize("arch", SMOKES)
def test_dots_matches_none_and_the_reference(arch):
    jcfg, jp, tcfg, tp, batch = _shared(arch)
    g0, l0, _ = value_and_grad(build_model(tcfg))(tp, batch)
    g1, l1, _ = value_and_grad(build_model(tcfg, remat="dots"))(tp, batch)
    assert float(l1) == float(l0)
    for a, c in zip(tree_leaves(g0), tree_leaves(g1)):
        assert (a - c).abs().max() <= REMAT_TOL * max(a.abs().max(), 1e-30)

    jvg = jax.jit(jax.value_and_grad(jbuild(jcfg, remat="dots").loss_fn,
                                     has_aux=True))
    with jax.default_matmul_precision("highest"):
        (jl, _), jg = jvg(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(l1) - float(jl)) <= LOSS_REL_TOL * abs(float(jl))
    la, lb = tree_leaves(g1), jax.tree.leaves(jg)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        b = np.asarray(b, np.float32)
        assert np.abs(a.numpy() - b).max() <= GRAD_REL_TOL * max(
            np.abs(b).max(), 1e-30)


def _product_bytes(func, args) -> int:
    """Bytes of an mm (a @ b) or addmm (bias + a @ b) output."""
    a, b = args[-2], args[-1]
    return a.shape[0] * b.shape[1] * a.element_size()


def _saved_bytes(cfg, params, batch, remat, monkeypatch):
    """(bytes kept for the backward after the forward, the ops whose
    outputs the "dots" policy saved)."""
    policy_saved = []

    def recording_policy(ctx, func, *args, **kwargs):
        decision = dots_policy(ctx, func, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            policy_saved.append((func, _product_bytes(func, args)))
        return decision

    dots_policy = transformer.dots_policy
    monkeypatch.setattr(transformer, "dots_policy", recording_policy)
    leaves, treedef = tree_flatten(params)
    ps = [t.detach().requires_grad_(True) for t in leaves]
    own = {t.untyped_storage()._cdata for t in ps}
    hooked = {}

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in own:
            hooked[st._cdata] = st.nbytes()
        return t

    bundle = build_model(cfg, remat=remat)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = bundle.loss_fn(tree_unflatten(treedef, ps), batch)
    total = sum(hooked.values()) + sum(n for _, n in policy_saved)
    del loss
    return total, [f for f, _ in policy_saved]


@pytest.mark.parametrize("arch", SMOKES)
def test_dots_keeps_more_than_full_and_less_than_none(arch, monkeypatch):
    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    params = build_model(cfg).init(0, device="cpu")
    batch = make_batch(cfg, SHAPE, 0)
    got = {r: _saved_bytes(cfg, params, batch, r, monkeypatch)
           for r in ("full", "dots", "none")}
    assert got["full"][0] < got["dots"][0] < got["none"][0]
    assert not got["full"][1] and not got["none"][1]
    saved_ops = got["dots"][1]
    assert saved_ops and set(saved_ops) <= _DOTS
