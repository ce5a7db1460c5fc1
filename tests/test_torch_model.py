"""The dense LM of the PyTorch port against the reference on shared weights.

``yi-9b-smoke`` in f32 on the reference's own ``init`` (converted with
``params_from_jax``): prefill logits and caches, then 8 greedy decode steps
with equal tokens.  In bf16 the prefill logits are compared against a
tolerance only.  Also: configs, prompts and parameter shapes equal the
reference's.

Tolerances: f32 logits/caches 1e-4 absolute (observed ~3e-6 on logits of
magnitude ~4); bf16 prefill logits 3e-2 of the largest logit (observed
~1.3e-2: both sides round every matmul to bf16, in different orders).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.model_zoo import analytic_param_count  # noqa: E402
from repro.train.data import make_batch as jmake_batch  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.testing import (caches_from_jax, params_from_jax,  # noqa: E402
                                 to_numpy)
from repro_torch.train import make_batch  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

F32_TOL = 1e-4
BF16_REL_TOL = 3e-2

_SHARED = {}


def _shared(dtype):
    """(jax bundle, jax params, port bundle, port params) for yi-9b-smoke."""
    if dtype not in _SHARED:
        jcfg = dataclasses.replace(jget_arch("yi-9b-smoke"), dtype=dtype)
        tcfg = dataclasses.replace(get_arch("yi-9b-smoke"), dtype=dtype)
        jb = jbuild(jcfg)
        jp = jb.init(jax.random.PRNGKey(0))
        tb = build_model(tcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp))
        _SHARED[dtype] = (jb, jp, tb, tp)
    return _SHARED[dtype]


def _prompt(B=2, S=16, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _f(x):
    return np.asarray(x, np.float32)


def test_configs_equal_reference():
    for name in ("yi-9b", "yi-9b-smoke"):
        assert dataclasses.asdict(get_arch(name)) == \
            dataclasses.asdict(jget_arch(name))


def test_prompt_tokens_equal_reference():
    for name, S, B, step in (("yi-9b-smoke", 8, 2, 0), ("yi-9b", 512, 8, 0),
                             ("yi-9b-smoke", 16, 4, 3)):
        ours = make_batch(get_arch(name), ShapeConfig("p", "train", S, B),
                          step)
        ref = jmake_batch(jget_arch(name), JShape("p", "train", S, B), step)
        for key in ("tokens", "targets"):
            np.testing.assert_array_equal(ours[key], ref[key])


def test_param_shapes_and_count_equal_reference():
    cfg = get_arch("yi-9b")
    tparams = build_model(cfg).init(0, device="meta")
    jparams = jax.eval_shape(jbuild(jget_arch("yi-9b")).init,
                             jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in tree_leaves(tparams)] == \
        [tuple(s.shape) for s in jax.tree.leaves(jparams)]
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tparams))
    assert cfg.param_count() == analytic_param_count(jget_arch("yi-9b"))


def test_cache_specs_equal_reference():
    cfg = get_arch("yi-9b")
    ts = build_model(cfg).cache_specs(8, 640)
    js = jbuild(jget_arch("yi-9b")).cache_specs(8, 640)
    assert [tuple(t.shape) for t in tree_leaves(ts)] == \
        [tuple(s.shape) for s in jax.tree.leaves(js)]


def test_f32_prefill_and_greedy_decode_match_reference():
    jb, jp, tb, tp = _shared("float32")
    toks = _prompt()
    jl, jc = jb.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert np.max(np.abs(_f(jl) - to_numpy(tl))) < F32_TOL
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.max(np.abs(_f(a) - to_numpy(b).astype(np.float32))) \
            < F32_TOL
    jdec = jax.jit(jb.decode_fn)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tl.argmax(-1).to(torch.int32)
    for i in range(8):
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        jl, jc = jdec(jp, jtok, jnp.int32(16 + i), jc)
        tl, tc = tb.decode_fn(tp, ttok, 16 + i, tc, inplace=True)
        assert np.max(np.abs(_f(jl) - to_numpy(tl))) < F32_TOL
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
    np.testing.assert_array_equal(np.asarray(jc[0][0]["kv_pos"]),
                                  tc[0][0]["kv_pos"].numpy())


def test_caches_convert_both_ways():
    """The reference's prefill cache, decoded by the port, and the port's
    prefill cache, decoded by the reference, give the same next logits."""
    jb, jp, tb, tp = _shared("float32")
    toks = _prompt(seed=1)
    jl, jc = jb.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    tl, tc_own = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    jl2, _ = jb.decode_fn(jp, tok, jnp.int32(16), jc)
    tc = caches_from_jax(jax.tree.map(np.asarray, jc))
    tl2, _ = tb.decode_fn(tp, torch.from_numpy(np.array(tok)), 16, tc)
    assert np.max(np.abs(_f(jl2) - to_numpy(tl2))) < F32_TOL
    jc_from_port = jax.tree.map(jnp.asarray, to_numpy(tc_own))
    jl3, _ = jb.decode_fn(jp, tok, jnp.int32(16), jc_from_port)
    assert np.max(np.abs(_f(jl3) - to_numpy(tl2))) < F32_TOL


def test_bf16_prefill_logits_within_tolerance():
    jb, jp, tb, tp = _shared("bfloat16")
    toks = _prompt(seed=2)
    jl, _ = jb.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    ref = _f(jl)
    assert np.max(np.abs(ref - to_numpy(tl))) < BF16_REL_TOL * np.abs(
        ref).max()


def test_generate_matches_reference_generate():
    from repro.serve.serve_step import generate as jgenerate

    jb, jp, tb, tp = _shared("float32")
    toks = _prompt(seed=3)
    jt = jgenerate(jb, jp, {"tokens": jnp.asarray(toks)}, 6)
    tt = generate(tb, tp, {"tokens": torch.from_numpy(toks)}, 6)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())


def test_decode_without_inplace_leaves_caches_untouched():
    _, _, tb, tp = _shared("float32")
    toks = torch.from_numpy(_prompt(seed=4))
    logits, caches = tb.prefill_fn(tp, {"tokens": toks})
    snapshot = tree_map(torch.clone, caches)
    tok = logits.argmax(-1).to(torch.int32)
    _, new = tb.decode_fn(tp, tok, 16, caches)
    for a, b in zip(tree_leaves(caches), tree_leaves(snapshot)):
        assert torch.equal(a, b)
    assert not torch.equal(new[0][0]["kv_pos"], caches[0][0]["kv_pos"])


@pytest.mark.parametrize("prefill_impl", ["naive", "blockwise"])
def test_plain_paths_agree_with_default_path(prefill_impl):
    """On the CPU the kernel wrappers run their plain versions; the
    explicitly plain bundle gives the same logits."""
    cfg = dataclasses.replace(get_arch("yi-9b-smoke"), dtype="float32")
    kern = build_model(cfg)
    plain = build_model(cfg, prefill_impl=prefill_impl, decode_impl="naive",
                        prefill_chunk=8)
    params = kern.init(1, device="cpu")
    toks = torch.from_numpy(_prompt(seed=5))
    lk, ck = kern.prefill_fn(params, {"tokens": toks})
    lp, cp = plain.prefill_fn(params, {"tokens": toks})
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=F32_TOL)
    tok = lk.argmax(-1).to(torch.int32)
    lk, _ = kern.decode_fn(params, tok, 16, ck)
    lp, _ = plain.decode_fn(params, tok, 16, cp)
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=F32_TOL)


def test_init_is_deterministic_per_seed():
    cfg = get_arch("yi-9b-smoke")
    a = build_model(cfg).init(7, device="cpu")
    b = build_model(cfg).init(7, device="cpu")
    c = build_model(cfg).init(8, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert not torch.equal(a["embed"]["embedding"], c["embed"]["embedding"])
