"""The remaining dense archs of the PyTorch port against the reference:
qwen3-8b (per-head q/k RMSNorm), stablelm-3b (LayerNorm, rotary on a
quarter of head dim 80, MHA) and starcoder2-15b (LayerNorm, plain GELU
MLP, 48 query heads over 4 kv heads: group 12).

* configs equal the reference's; at full width the parameter tree has the
  reference's keys, shapes and dtypes (``q_norm``, ``k_norm``, LayerNorm's
  ``bias`` included) and the same parameter count; the cache specs match;
* LayerNorm (``norm_fwd``), ``rmsnorm_1d`` and the qk-norm'd
  ``_project_qkv`` against the reference's in f32 (1e-5 absolute) and bf16
  (2e-2 absolute: both round the same f32 value once, so one bf16 ulp);
* whole-model parity in f32 on the reference's own ``init`` for each
  ``-smoke`` arch, a stablelm-3b-smoke variant at head dim 80 (the smoke
  configs use 16) and a starcoder2-15b-smoke variant at group 12: prefill
  logits and caches within 1e-4 absolute, then 8 greedy decode steps with
  equal tokens;
* ``lm_loss`` within 1e-5 relative and every gradient leaf within 1e-4 of
  max|g| against ``jax.grad`` (``tests/test_torch_train.py``'s
  ``grads_against_reference``), with and without a loss mask;
* the paged engine's f32 transcripts equal the JAX engine's on its
  weights for qwen3-8b and starcoder2-15b (f32 variants registered in both
  packages' ``ARCHS`` for this module only);
* the slice as a whole on ``device="cpu"``: ``TaskImage(arch=...)`` served
  by ``FunkyRuntime`` gives ``generate``'s tokens, an ``EngineServeTask``
  drains the router, and ``make_cluster`` deploys all three to done.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import FunkyCL as JFunkyCL  # noqa: E402
from repro.core import Monitor as JMonitor  # noqa: E402
from repro.core import SliceAllocator as JSliceAllocator  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model_zoo import analytic_param_count  # noqa: E402
from repro.serve.engine import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve.engine import ServeRequest as JServeRequest  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.core import (EngineServeTask, FunkyCL,  # noqa: E402
                              FunkyRuntime, Monitor, SliceAllocator,
                              TaskImage, TaskStatus, make_cluster)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.scaling.serving import reset_router  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      ServeRequest)
from repro_torch.serve.equivalence import run_transcript  # noqa: E402
from repro_torch.testing import (caches_from_jax,  # noqa: E402
                                 params_from_jax, to_numpy)
from repro_torch.train import make_batch  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_train import grads_against_reference  # noqa: E402

NAMES = ("qwen3-8b", "stablelm-3b", "starcoder2-15b")
SMOKE = tuple(f"{n}-smoke" for n in NAMES)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL = 1e-4
PROMPT = 24
# variants no smoke config reaches: stablelm's head dim 80 and
# starcoder2's group 12 (12 query heads over 1 kv head)
VARIANTS = {"stablelm-3b-smoke-hd80": ("stablelm-3b-smoke",
                                       dict(head_dim=80)),
            "starcoder2-15b-smoke-g12": ("starcoder2-15b-smoke",
                                         dict(num_heads=12, num_kv_heads=1))}


def _f(x):
    return np.asarray(x, np.float32)


def _paths(tree, prefix=()):
    """(key path, shape, dtype) of every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [p for i, t in enumerate(tree) for p in _paths(t,
                                                              prefix + (i,))]
    return [(prefix, tuple(tree.shape),
             str(tree.dtype).removeprefix("torch."))]


def _cfgs(name, **ch):
    """(reference config, port config) of an arch, a smoke arch or a
    variant, with the changes ``ch`` (e.g. ``dtype``)."""
    base, extra = VARIANTS.get(name, (name, {}))
    return (dataclasses.replace(jget_arch(base), **extra, **ch),
            dataclasses.replace(get_arch(base), **extra, **ch))


def _shared(name, dtype="float32"):
    jc, tc = _cfgs(name, dtype=dtype)
    jb = jbuild(jc)
    jp = jb.init(jax.random.PRNGKey(0))
    return jb, jp, build_model(tc), params_from_jax(
        jax.tree.map(np.asarray, jp))


# ---------------------------------------------------------------------------
# Configs, parameter trees, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_configs_equal_reference(name):
    for n in (name, name + "-smoke"):
        assert dataclasses.asdict(get_arch(n)) == \
            dataclasses.asdict(jget_arch(n))
        assert get_arch(n).source == jget_arch(n).source


@pytest.mark.parametrize("name", NAMES)
def test_param_tree_and_count_equal_reference(name):
    cfg = get_arch(name)
    tparams = build_model(cfg).init(0, device="meta")
    jparams = jax.eval_shape(jbuild(jget_arch(name)).init,
                             jax.random.PRNGKey(0))
    assert _paths(tparams) == _paths(jparams)
    keys = {p[0][-1] for p in _paths(tparams)}
    assert ("q_norm" in keys) == cfg.qk_norm
    assert ("bias" in keys) == (cfg.norm_kind == "layernorm")
    assert cfg.param_count() == analytic_param_count(jget_arch(name))
    assert cfg.param_count() == {"qwen3-8b": 8_190_735_360,
                                 "stablelm-3b": 2_795_443_200,
                                 "starcoder2-15b": 15_956_127_744}[name]


@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_equal_reference(name):
    ts = build_model(get_arch(name)).cache_specs(8, 512 + 128)
    js = jbuild(jget_arch(name)).cache_specs(8, 512 + 128)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in tree_leaves(ts)] == \
        [(tuple(s.shape), str(s.dtype)) for s in jax.tree.leaves(js)]


# ---------------------------------------------------------------------------
# The new layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_and_rmsnorm_1d_match_reference(dtype):
    jc, tc = _cfgs("stablelm-3b-smoke", dtype=dtype)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jout = jlayers.norm_fwd(jc, {"scale": jnp.asarray(scale, dtype),
                                 "bias": jnp.asarray(bias, dtype)},
                            jnp.asarray(x, dtype))
    tp = {"scale": torch.from_numpy(scale).to(TDT[dtype]),
          "bias": torch.from_numpy(bias).to(TDT[dtype])}
    tout = tlayers.norm_fwd(tc, tp, torch.from_numpy(x).to(TDT[dtype]))
    assert tout.dtype == TDT[dtype]
    assert np.abs(_f(jout) - to_numpy(tout)).max() < TOL[dtype]
    stacked = tlayers.init_norm(tc, 64, torch.device("cpu"), count=3)
    assert sorted(stacked) == ["bias", "scale"]
    assert torch.equal(stacked["scale"], torch.ones(3, 64, dtype=TDT[dtype]))
    assert torch.equal(stacked["bias"], torch.zeros(3, 64, dtype=TDT[dtype]))
    assert sorted(tlayers.init_norm(get_arch("yi-9b"), 8, torch.device("meta"))) == \
        ["scale"]
    jr = jlayers.rmsnorm_1d(jnp.asarray(x, dtype), jnp.asarray(scale, dtype))
    tr = tlayers.rmsnorm_1d(torch.from_numpy(x).to(TDT[dtype]),
                            tp["scale"])
    assert tr.dtype == TDT[dtype]
    assert np.abs(_f(jr) - to_numpy(tr)).max() < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_norm_project_qkv_matches_reference(dtype):
    """q and k normalised per head before RoPE, with scales other than
    ones; every caller (training, prefill, dense and per-lane decode, the
    paged decode) projects through this one function."""
    jc, tc = _cfgs("qwen3-8b-smoke", dtype=dtype)
    p = jattn.init_gqa(jc, jax.random.PRNGKey(3))
    rng = np.random.default_rng(1)
    p["q_norm"] = jnp.asarray(1 + 0.2 * rng.standard_normal(16), dtype)
    p["k_norm"] = jnp.asarray(1 + 0.2 * rng.standard_normal(16), dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    assert sorted(tp) == ["k_norm", "q_norm", "wk", "wo", "wq", "wv"]
    stacked = tattn.init_gqa(tc, torch.device("meta"), None, count=2)
    assert tuple(stacked["q_norm"].shape) == (2, 16)
    assert tuple(stacked["k_norm"].shape) == (2, 16)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    pos = np.arange(3, 10, dtype=np.int32)
    jq = jattn._project_qkv(jc, p, jnp.asarray(x, dtype), jnp.asarray(pos))
    tq = tattn._project_qkv(tc, tp, torch.from_numpy(x).to(TDT[dtype]),
                            torch.from_numpy(pos))
    for a, b in zip(jq, tq):
        assert b.dtype == TDT[dtype]
        assert np.abs(_f(a) - to_numpy(b)).max() < TOL[dtype]


# ---------------------------------------------------------------------------
# Whole-model parity on shared weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SMOKE + tuple(VARIANTS))
def test_f32_prefill_and_greedy_decode_match_reference(name):
    jb, jp, tb, tp = _shared(name)
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


def test_caches_convert_both_ways():
    jb, jp, tb, tp = _shared("stablelm-3b-smoke-hd80")
    toks = np.random.default_rng(2).integers(0, 512, (2, 8)).astype(np.int32)
    _, jc = jb.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    tc = caches_from_jax(jax.tree.map(np.asarray, jc))
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(_f(a), to_numpy(b).astype(np.float32))


@pytest.mark.parametrize("name", SMOKE)
def test_lm_loss_and_grads_match_reference(name):
    grads_against_reference(name, "cpu")


# ---------------------------------------------------------------------------
# The paged engine against the JAX engine (f32, shared weights)
# ---------------------------------------------------------------------------

ENGINE_ARCHS = ("qwen3-8b", "starcoder2-15b")
PROMPT_LEN, PAGE = 8, 4


def _requests(cls):
    rng = np.random.Generator(np.random.Philox(2))
    return [cls(rid=f"r{i}", prompt=rng.integers(0, 100, PROMPT_LEN),
                max_new_tokens=n) for i, n in enumerate([6, 8, 4, 7, 5, 8])]


@pytest.fixture(scope="module")
def engine_ref():
    """``<arch>-f32`` in both packages' ``ARCHS``; per arch the JAX
    engine's weights and transcript (2 lanes, pages of 4, 6 requests)."""
    mp = pytest.MonkeyPatch()
    for mod in (jcfg, tcfg):
        for name in ENGINE_ARCHS:
            mp.setitem(mod.ARCHS, f"{name}-f32", dataclasses.replace(
                mod.ARCHS[name], name=f"{name}-f32", dtype="float32"))
    out = {}
    for name in ENGINE_ARCHS:
        mon = JMonitor("ref", JSliceAllocator("n0", 1))
        eng = JEngine(f"{name}-f32-smoke", JFunkyCL(mon), slots=2,
                      prompt_len=PROMPT_LEN, max_new_tokens=8,
                      page_size=PAGE)
        eng.setup()
        params = params_from_jax(jax.tree.map(
            np.asarray, eng.cl.read_buffer("params")))
        for r in _requests(JServeRequest):
            eng.submit(r)
        eng.run_until_drained()
        out[name] = (params, {rid: list(rec.tokens)
                              for rid, rec in eng.completed.items()})
        mon.vfpga_exit()
    yield out
    mp.undo()


@pytest.mark.parametrize("name", ENGINE_ARCHS)
def test_paged_engine_transcripts_match_the_reference(engine_ref, name):
    params, want = engine_ref[name]

    def make():
        mon = Monitor("port", SliceAllocator("n0", 1, device="cpu"),
                      telemetry=MetricsRegistry())
        eng = ContinuousBatchingEngine(f"{name}-f32-smoke", FunkyCL(mon),
                                       slots=2, prompt_len=PROMPT_LEN,
                                       max_new_tokens=8, page_size=PAGE)
        eng.setup()
        eng.cl.write_buffer("params", params).wait()
        return mon, eng

    got, eng = run_transcript(make, lambda: _requests(ServeRequest))
    assert eng.paged
    assert got == want


# ---------------------------------------------------------------------------
# The slice as a whole: TaskImage, EngineServeTask, make_cluster
# ---------------------------------------------------------------------------

def _serve_image(arch, name="svc"):
    return TaskImage(name=name, kind="serve", arch=arch, prompt_len=PROMPT,
                     global_batch=2, total_steps=3, tokens_per_step=2,
                     seed=0)


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


@pytest.mark.parametrize("arch", SMOKE)
def test_runtime_serves_generate_tokens(arch):
    image = _serve_image(arch)
    rt = FunkyRuntime("n0", SliceAllocator("n0", 1, device="cpu"))
    rt.create("t", image)
    rt.start("t")
    rec = rt.tasks["t"]
    assert rt.wait("t", timeout=120) is TaskStatus.DONE, rec.error
    assert rec.guest_state.user["last_token"] == _oracle(image)
    rt.delete("t")


def test_engine_serve_task_drains_the_router():
    name = "svc-dense-archs"
    im = TaskImage(name=name, kind="engine-serve", arch="stablelm-3b-smoke",
                   prompt_len=PROMPT_LEN, global_batch=2, max_new_tokens=8,
                   page_size=PAGE, total_steps=10 ** 9, seed=0)
    router = reset_router(name)
    rt = FunkyRuntime("n0", SliceAllocator("n0", 1, device="cpu"))
    rec = rt.create("e", im)
    assert isinstance(rec.task, EngineServeTask)
    rt.start("e")
    for r in _requests(ServeRequest):
        router.submit(r)
    router.close()
    assert rt.wait("e", timeout=120) is TaskStatus.DONE, rec.error
    assert rec.guest_state.user["completed"] == 6
    assert {rid: len(c.tokens) for rid, c in router.completed.items()} == \
        {r.rid: r.max_new_tokens for r in _requests(ServeRequest)}
    rt.delete("e")


def test_make_cluster_deploys_the_three_archs(tmp_path):
    images = {a: _serve_image(a, name=a) for a in SMOKE}
    cl = make_cluster(num_nodes=1, slices_per_node=3, images=images,
                      device="cpu", ckpt_root=str(tmp_path))
    try:
        orch = cl.orchestrator
        orch.start(tick_interval=0.01)
        for a in SMOKE:
            orch.submit(a, priority=0)
        assert orch.wait_all(timeout=120)
        assert sorted(d.status for d in orch.deployments.values()) == \
            ["done"] * 3
    finally:
        cl.stop()
