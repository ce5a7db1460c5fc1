"""``repro_torch.launch.steps.build_cell`` against the reference's
``repro.launch.steps.build_cell`` on the trivial mesh, for the six family
smokes of ``tests/test_launch_small.py`` at its ``TINY`` shapes, in f32 on
shared weights (the reference's ``init`` through ``params_from_jax``).

Each cell runs with its defaults on both sides (``remat="full"``, naive
training attention, blockwise prefill, plain decode; absorbed MLA decode).
Tolerances, as the existing parity tests hold each family
(``tests/test_torch_model.py``, ``test_torch_mla.py``,
``test_torch_encdec.py``, ``test_torch_vlm.py``, ``test_torch_train.py``):

* train (2 microbatches): the loss within ``LOSS_REL_TOL`` 1e-5 relative;
  the parameters after the AdamW step held to the reference's as
  ``test_torch_train.py`` holds them: in each leaf at least 99.9% within
  ``APPLY_TOL`` 1e-6 and every one within 2.2 lr (the first step moves a
  weight by about lr whatever the gradient's size, so a gradient within
  rounding of zero may move it the other way; a step that left the
  weights where they were, or moved them the wrong way, is off by lr or
  2 lr nearly everywhere); the step counts equal;
* prefill: the last-token logits within ``F32_TOL`` 1e-4 absolute;
* decode: one step's logits within ``F32_TOL`` from the same caches (ring
  positions ``pos - cap .. pos - 1``, states and k/v drawn from a seeded
  numpy RNG).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.mesh import compat_make_mesh  # noqa: E402
from repro.launch.steps import build_cell as jbuild_cell  # noqa: E402
from repro.launch.steps import opt_config_for as jopt_config_for  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.train.optimizer import init_opt_state as jinit_opt  # noqa: E402
from repro.train.optimizer import lr_at as jlr_at  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.testing import (opt_state_from_jax,  # noqa: E402
                                 params_from_jax, to_numpy)
from repro_torch.tree import tree_leaves  # noqa: E402

MESH = compat_make_mesh((1, 1), ("data", "model"))

TINY = {
    "train": dict(name="train_4k", seq_len=32, global_batch=4),
    "prefill": dict(name="prefill_32k", seq_len=64, global_batch=2),
    "decode": dict(name="decode_32k", seq_len=64, global_batch=2),
}

FAMILY_REPS = ["yi-9b-smoke", "deepseek-v3-671b-smoke", "mamba2-1.3b-smoke",
               "recurrentgemma-9b-smoke", "seamless-m4t-large-v2-smoke",
               "llava-next-mistral-7b-smoke"]

F32_TOL = 1e-4
LOSS_REL_TOL = 1e-5
APPLY_TOL = 1e-6
PARAM_LR_TOL = 2.2          # x lr of the step


def _shapes(kind):
    t = TINY[kind]
    return (dataclasses.replace(JSHAPES[t["name"]], seq_len=t["seq_len"],
                                global_batch=t["global_batch"]),
            dataclasses.replace(SHAPES[t["name"]], seq_len=t["seq_len"],
                                global_batch=t["global_batch"]))


def _np_like(spec, rng, vocab, name=""):
    """Seeded numpy inputs for one abstract leaf of the reference: tokens
    in the vocabulary, ``kv_pos`` the ring positions of ``pos`` 63, floats
    N(0, 0.5) (embeddings N(0, 0.02))."""
    shape = tuple(spec.shape)
    if np.issubdtype(np.dtype(spec.dtype), np.integer):
        if name == "kv_pos":
            cap = shape[-1]
            pos = np.arange(63 - cap, 63)
            ring = np.empty(cap, np.int32)
            ring[pos % cap] = pos
            return np.broadcast_to(ring, shape).astype(np.int32)
        return rng.integers(0, vocab, size=shape).astype(np.int32)
    scale = 0.02 if name in ("src_emb", "img_emb") else 0.5
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _fill(tree, rng, vocab, name=""):
    if isinstance(tree, dict):
        return {k: _fill(v, rng, vocab, k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_fill(v, rng, vocab, name) for v in tree)
    return _np_like(tree, rng, vocab, name)


@pytest.mark.parametrize("arch", FAMILY_REPS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_cell_matches_the_reference(arch, kind):
    jcfg = dataclasses.replace(jget_arch(arch), dtype="float32")
    tcfg = dataclasses.replace(get_arch(arch), dtype="float32")
    jshape, tshape = _shapes(kind)
    nmb = 2 if kind == "train" else 1
    jcell = jbuild_cell(jcfg, jshape, MESH, num_microbatches=nmb)
    tcell = build_cell(tcfg, tshape, num_microbatches=nmb)
    assert tcell.donate_argnums == jcell.donate_argnums
    jparams = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(0)))
    tparams = params_from_jax(jparams)
    rng = np.random.default_rng(0)
    step = jcell.jitted()

    if kind == "train":
        jopt = jax.tree.map(np.asarray,
                            jinit_opt(jopt_config_for(jcfg), jparams))
        batch = _fill(jcell.abstract_args[2], rng, jcfg.vocab_size)
        jp, jo, jm = step(jparams, jopt, batch)
        tp, to, tm = tcell.fn(tparams, opt_state_from_jax(jopt),
                              params_from_jax(batch))
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= LOSS_REL_TOL * abs(want)
        assert int(to["count"]) == int(jo["count"]) == 1
        lr = float(jlr_at(jopt_config_for(jcfg), jax.numpy.int32(1)))
        for a, b in zip(tree_leaves(to_numpy(tp)),
                        jax.tree.leaves(jax.tree.map(np.asarray, jp))):
            assert a.shape == b.shape
            err = np.abs(a - b.astype(np.float32))
            assert (err <= APPLY_TOL).mean() >= 0.999
            assert err.max() <= PARAM_LR_TOL * lr
        return

    if kind == "prefill":
        batch = _fill(jcell.abstract_args[1], rng, jcfg.vocab_size)
        jl, _ = step(jparams, batch)
        tl, _ = tcell.fn(tparams, params_from_jax(batch))
    else:
        _, tok, _, caches = jcell.abstract_args
        token = _fill(tok, rng, jcfg.vocab_size)
        caches = _fill(caches, rng, jcfg.vocab_size)
        pos = np.int32(63)
        jl, _ = step(jparams, token, pos, caches)
        tl, _ = tcell.fn(tparams, torch.from_numpy(token), torch.tensor(pos),
                         params_from_jax(caches))
    assert tl.shape == jl.shape
    assert np.max(np.abs(np.asarray(jl, np.float32) - to_numpy(tl))) \
        < F32_TOL
