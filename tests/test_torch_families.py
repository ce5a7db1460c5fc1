"""The ssm (mamba2-1.3b) and hybrid (recurrentgemma-9b) families of the
PyTorch port against the reference, and served through the runtime.

* configs, parameter shapes and dtypes, and cache specs equal the
  reference's at full width; the hybrid plan has its remainder segment;
* the weight and cache bridges keep each leaf's dtype (a bf16 config's
  float32 leaves stay float32);
* whole-model parity in f32 on the reference's own ``init`` for
  mamba2-1.3b-smoke, recurrentgemma-9b-smoke and a 5-layer recurrentgemma
  variant (which builds the remainder segment): prefill logits and caches
  within 1e-4 absolute (observed below 1e-5), then 8 greedy decode steps
  with equal tokens.  The prompt (24) is longer than the smoke window
  (16), so attention's ring wraps;
* bf16 prefill logits within a fraction of the largest logit: 3e-2 for
  mamba2 (observed 0.012-0.017 over 6 prompts), 5e-2 for recurrentgemma
  (observed 0.015-0.032: besides every matmul, the reference rounds its
  GeGLU and gate ``gelu`` to bf16 inside, where PyTorch computes them in
  f32 and rounds once);
* a runtime-served ``ServeTask`` of each smoke arch gives ``generate``'s
  tokens, with and without an evict/resume, on ``device="cpu"``.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.model_zoo import analytic_param_count  # noqa: E402
from repro.models.transformer import plan_segments as jplan  # noqa: E402
from repro_torch.chaos import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.core import (FunkyRuntime, SliceAllocator,  # noqa: E402
                              TaskImage, TaskStatus)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import plan_segments  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    caches_from_jax, params_from_jax, to_numpy)
from repro_torch.train import make_batch  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

FULL = ("mamba2-1.3b", "recurrentgemma-9b")
F32_TOL = 1e-4
BF16_REL_TOL = {"mamba2-1.3b-smoke": 3e-2, "recurrentgemma-9b-smoke": 5e-2}
PROMPT = 24


def _cfg(name, dtype=None, layers=None, ref=False):
    cfg = (jget_arch if ref else get_arch)(name)
    ch = {}
    if dtype:
        ch["dtype"] = dtype
    if layers:
        ch["num_layers"] = layers
    return dataclasses.replace(cfg, **ch)


def _f(x):
    return np.asarray(x, np.float32)


def _dtype_name(d) -> str:
    return str(d).removeprefix("torch.")


# ---------------------------------------------------------------------------
# Configs, shapes, dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FULL)
def test_configs_equal_reference(name):
    for n in (name, name + "-smoke"):
        assert dataclasses.asdict(get_arch(n)) == \
            dataclasses.asdict(jget_arch(n))


@pytest.mark.parametrize("name", FULL)
def test_param_shapes_dtypes_and_count_equal_reference(name):
    """At full width, in bf16: the f32 leaves (Mamba2's dt_bias, A_log,
    D_skip; RG-LRU's b_a, b_x, lambda_p) are f32 in the port's init too."""
    cfg = get_arch(name)
    tparams = build_model(cfg).init(0, device="meta")
    jparams = jax.eval_shape(jbuild(jget_arch(name)).init,
                             jax.random.PRNGKey(0))
    tl, jl = tree_leaves(tparams), jax.tree.leaves(jparams)
    assert [tuple(t.shape) for t in tl] == [tuple(s.shape) for s in jl]
    assert [_dtype_name(t.dtype) for t in tl] == [str(s.dtype) for s in jl]
    assert {_dtype_name(t.dtype) for t in tl} == {"bfloat16", "float32"}
    assert cfg.param_count() == analytic_param_count(jget_arch(name))


@pytest.mark.parametrize("name", FULL)
def test_cache_specs_equal_reference(name):
    ts = build_model(get_arch(name)).cache_specs(8, 2560 + 128)
    js = jbuild(jget_arch(name)).cache_specs(8, 2560 + 128)
    assert [(tuple(t.shape), _dtype_name(t.dtype)) for t in tree_leaves(ts)] \
        == [(tuple(s.shape), str(s.dtype)) for s in jax.tree.leaves(js)]


@pytest.mark.parametrize("name,layers,plan", [
    ("recurrentgemma-9b", None, [(12, "rec rec attn"), (1, "rec rec")]),
    ("recurrentgemma-9b-smoke", None, [(1, "rec rec attn")]),
    ("recurrentgemma-9b-smoke", 5, [(1, "rec rec attn"), (1, "rec rec")]),
    ("mamba2-1.3b", None, [(48, "ssm")]),
])
def test_plans_equal_reference(name, layers, plan):
    segs = plan_segments(_cfg(name, layers=layers))
    assert [(s.count, " ".join(b.mixer for b in s.blocks)) for s in segs] \
        == plan
    jsegs = jplan(_cfg(name, layers=layers, ref=True))
    assert [(s.count, [dataclasses.asdict(b) for b in s.blocks])
            for s in segs] == \
        [(s.count, [dataclasses.asdict(b) for b in s.blocks]) for s in jsegs]


# ---------------------------------------------------------------------------
# The bridges keep each leaf's dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("mamba2-1.3b-smoke",
                                  "recurrentgemma-9b-smoke"))
def test_bridges_keep_float32_leaves_in_a_bf16_config(name):
    jb = jbuild(jget_arch(name))
    jp = jb.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    jd = [str(x.dtype) for x in jax.tree.leaves(jp)]
    assert "float32" in jd and "bfloat16" in jd
    assert [_dtype_name(t.dtype) for t in tree_leaves(tp)] == jd
    toks = np.random.default_rng(0).integers(0, 512, (2, PROMPT)).astype(
        np.int32)
    _, jc = jb.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    tc = caches_from_jax(jax.tree.map(np.asarray, jc))
    cd = [str(x.dtype) for x in jax.tree.leaves(jc)]
    assert "float32" in cd                 # ssm_state / h
    assert [_dtype_name(t.dtype) for t in tree_leaves(tc)] == cd
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        np.testing.assert_array_equal(_f(a), to_numpy(b).astype(np.float32))


# ---------------------------------------------------------------------------
# Whole-model parity on shared weights
# ---------------------------------------------------------------------------

def _shared(name, dtype, layers=None):
    jcfg = _cfg(name, dtype, layers, ref=True)
    tcfg = _cfg(name, dtype, layers)
    jb = jbuild(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    tb = build_model(tcfg)
    return jb, jp, tb, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("name,layers", [
    ("mamba2-1.3b-smoke", None), ("recurrentgemma-9b-smoke", None),
    ("recurrentgemma-9b-smoke", 5)])
def test_f32_prefill_and_greedy_decode_match_reference(name, layers):
    jb, jp, tb, tp = _shared(name, "float32", layers)
    toks = np.random.default_rng(1).integers(0, 512, (2, PROMPT)).astype(
        np.int32)
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
        jl, jc = jdec(jp, jtok, jnp.int32(PROMPT + i), jc)
        tl, tc = tb.decode_fn(tp, ttok, PROMPT + i, tc, inplace=True)
        assert np.max(np.abs(_f(jl) - to_numpy(tl))) < F32_TOL
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        assert np.max(np.abs(_f(a) - to_numpy(b).astype(np.float32))) \
            < F32_TOL


@pytest.mark.parametrize("name", ("mamba2-1.3b-smoke",
                                  "recurrentgemma-9b-smoke"))
def test_bf16_prefill_logits_within_tolerance(name):
    jb, jp, tb, tp = _shared(name, "bfloat16")
    toks = np.random.default_rng(2).integers(0, 512, (2, PROMPT)).astype(
        np.int32)
    jl, _ = jb.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    ref = _f(jl)
    assert np.max(np.abs(ref - to_numpy(tl))) < BF16_REL_TOL[name] * np.abs(
        ref).max()


def test_decode_without_inplace_leaves_the_caches_alone():
    tb = build_model(get_arch("recurrentgemma-9b-smoke"))
    params = tb.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, PROMPT)).astype(np.int32))
    logits, caches = tb.prefill_fn(params, {"tokens": toks})
    before = [t.clone() for t in tree_leaves(caches)]
    tok = logits.argmax(-1).to(torch.int32)
    _, new = tb.decode_fn(params, tok, PROMPT, caches)
    for a, b in zip(before, tree_leaves(caches)):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(new)))


# ---------------------------------------------------------------------------
# Served through FunkyRuntime -> FunkyCL -> Monitor
# ---------------------------------------------------------------------------

def _image(arch):
    return TaskImage(name="svc", kind="serve", arch=arch, prompt_len=PROMPT,
                     global_batch=2, total_steps=6, tokens_per_step=2, seed=0)


def _oracle(image):
    cfg = get_arch(image.arch)
    bundle = build_model(cfg)
    params = bundle.init(image.seed, device="cpu")
    prompt = make_batch(cfg, ShapeConfig("p", "train", image.prompt_len,
                                         image.global_batch), 0)["tokens"]
    n = image.total_steps * image.tokens_per_step
    toks = generate(bundle, params, {"tokens": torch.from_numpy(prompt)},
                    n + 1)
    return toks[:, n].tolist()


@pytest.mark.parametrize("arch", ("mamba2-1.3b-smoke",
                                  "recurrentgemma-9b-smoke"))
@pytest.mark.parametrize("evict", [False, True])
def test_runtime_serves_generate_tokens(arch, evict):
    image = _image(arch)
    # a delay on every EXECUTE keeps the task alive long enough to be
    # evicted between steps; it changes no value
    plan = FaultPlan([FaultSpec(site="monitor.execute", kind="delay",
                                every=1, max_fires=10 ** 6, delay_s=0.005)])
    rt = FunkyRuntime("n0", SliceAllocator("n0", 1, device="cpu"),
                      chaos=plan if evict else None)
    rt.create("t", image)
    rt.start("t")
    rec = rt.tasks["t"]
    if evict:
        deadline = time.time() + 60
        while rec.guest_state.step < 2 and time.time() < deadline:
            time.sleep(0.001)
        stats = rt.evict("t")
        assert 0 < rec.guest_state.step < image.total_steps
        assert stats["n_dirty"] == 4       # params, token, pos, caches
        rt.resume("t")
    assert rt.wait("t", timeout=120) is TaskStatus.DONE, rec.error
    assert rec.guest_state.user["last_token"] == _oracle(image)
