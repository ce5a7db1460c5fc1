"""The encoder-decoder family of the PyTorch port (seamless-m4t-large-v2,
``models/encdec.py``) against the reference.

* the config equals the reference's; at full width the parameter tree has
  the reference's keys, shapes and dtypes and the same count
  (1,632,256,000); the cache specs match (``self``, ``cross_k``,
  ``cross_v``);
* on shared f32 weights (``params_from_jax``), for the smoke arch and a
  variant at the true head shape (16/16 heads of 64): ``encode``, then
  ``encdec_prefill``'s logits and its three cache leaves within 1e-4
  absolute, 8 greedy ``encdec_decode`` steps with equal tokens, and
  ``generate``'s 8 tokens equal the reference's;
* ``encdec_loss`` within 1e-5 relative and every gradient leaf within
  1e-4 of max|g| against ``jax.grad``;
* ``make_batch``'s encdec batch is array-equal to the reference's;
* K1's plain version over a cross cache (``kv_pos`` 0..S_src-1, the query
  at S_src - 1) and ``cross_attn_fwd``'s decode route equal the
  reference's naive non-causal cross attention; the prefill route's
  ``"kernel"`` (K2's plain version on the CPU) at Sq != Skv too;
* the Funky entry points as the reference has them: ``ServeTask`` prefills
  ``{"tokens"}`` only and so ends FAILED on a seamless image, as the
  reference's does; a ``TrainTask`` step runs to DONE with the
  reference's loss (the port's task on the reference's initial weights);
  the bundle's ``decode_paged_fn`` raises (the reference's engine does
  not serve the family).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.models as tmodels  # noqa: E402
from repro.configs import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import FunkyRuntime as JFunkyRuntime  # noqa: E402
from repro.core import SliceAllocator as JSliceAllocator  # noqa: E402
from repro.core import TaskImage as JTaskImage  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.model_zoo import analytic_param_count  # noqa: E402
from repro.serve.serve_step import generate as jgenerate  # noqa: E402
from repro.train.data import make_batch as jmake_batch  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.core import (FunkyRuntime, SliceAllocator,  # noqa: E402
                              TaskImage, TaskStatus)
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.testing import params_from_jax, to_numpy  # noqa: E402
from repro_torch.train import make_batch  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_train import _assert_grads_close  # noqa: E402

NAME = "seamless-m4t-large-v2"
SMOKE = NAME + "-smoke"
F32_TOL = 1e-4
LOSS_REL_TOL, GRAD_REL_TOL = 1e-5, 1e-4
SEQ = 32          # make_batch's S: 32 source frames, a target of 8
# the true head shape (16/16 heads of 64) at the smoke width's 4 layers
VARIANTS = {SMOKE + "-h16": (SMOKE, dict(d_model=128, num_heads=16,
                                         num_kv_heads=16, head_dim=64))}


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


def cfgs(name, **ch):
    """(reference config, port config) of an arch, a smoke arch or a
    variant, with the changes ``ch`` (e.g. ``dtype``)."""
    base, extra = VARIANTS.get(name, (name, {}))
    return (dataclasses.replace(jget_arch(base), **extra, **ch),
            dataclasses.replace(get_arch(base), **extra, **ch))


def shared(name, dtype="float32"):
    """Both bundles and the reference's initial weights in both forms."""
    jc, tc = cfgs(name, dtype=dtype)
    jb = jbuild(jc)
    jp = jb.init(jax.random.PRNGKey(0))
    return jb, jp, build_model(tc), params_from_jax(
        jax.tree.map(np.asarray, jp))


def prompt(cfg, B=2, S=SEQ):
    """make_batch's prompt keys as numpy: encdec src_emb + tgt_tokens,
    vlm tokens + img_emb."""
    b = make_batch(cfg, ShapeConfig("p", "train", S, B), 0)
    keys = (("src_emb", "tgt_tokens") if cfg.family == "encdec"
            else ("tokens", "img_emb"))
    return {k: b[k] for k in keys}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@pytest.fixture
def f32_archs():
    """``<name>-f32`` of both families in both packages' ``ARCHS`` for
    one test."""
    mp = pytest.MonkeyPatch()
    for mod in (jcfg, tcfg):
        for name in (NAME, "llava-next-mistral-7b"):
            mp.setitem(mod.ARCHS, f"{name}-f32", dataclasses.replace(
                mod.ARCHS[name], name=f"{name}-f32", dtype="float32"))
    yield mp
    mp.undo()


def on_reference_weights(mp, arch, seed=0):
    """The port's ``build_model`` gives bundles whose ``init`` returns
    the reference's initial weights for ``arch`` at ``seed`` (what the
    reference's ``ServeTask``/``TrainTask`` draw), so a port task and a
    reference task start from the same state."""
    jp = jbuild(jget_arch(arch)).init(jax.random.PRNGKey(seed))
    shared_params = params_from_jax(jax.tree.map(np.asarray, jp))
    real = tmodels.build_model

    def patched(cfg, **kw):
        bundle = real(cfg, **kw)
        return dataclasses.replace(bundle, init=lambda s, device="cuda": (
            tree_map(lambda t: t.to(device).clone(), shared_params)))

    mp.setattr(tmodels, "build_model", patched)


def reference_train_loss(image):
    """The reference's ``TrainTask`` run to DONE: its final loss."""
    rt = JFunkyRuntime("n0", JSliceAllocator("n0", 1))
    rt.create("t", JTaskImage(**{f.name: getattr(image, f.name) for f in
                                 dataclasses.fields(JTaskImage)
                                 if f.name != "opt"}))
    rt.start("t")
    assert rt.wait("t", timeout=120).value == "done"
    loss = rt.tasks["t"].guest_state.user["final_loss"]
    rt.delete("t")
    return loss


def port_train_loss(image):
    rt = FunkyRuntime("n0", SliceAllocator("n0", 1, device="cpu"))
    rec = rt.create("t", image)
    rt.start("t")
    assert rt.wait("t", timeout=120) is TaskStatus.DONE, rec.error
    loss = rec.guest_state.user["final_loss"]
    rt.delete("t")
    return loss


# ---------------------------------------------------------------------------
# Config, parameter tree, caches, data
# ---------------------------------------------------------------------------

def test_config_equals_reference():
    for n in (NAME, SMOKE):
        assert dataclasses.asdict(get_arch(n)) == \
            dataclasses.asdict(jget_arch(n))
    assert get_arch(NAME).source == "arXiv:2308.11596; unverified"


def test_param_tree_and_count_equal_reference():
    tparams = build_model(get_arch(NAME)).init(0, device="meta")
    jparams = jax.eval_shape(jbuild(jget_arch(NAME)).init,
                             jax.random.PRNGKey(0))
    assert _paths(tparams) == _paths(jparams)
    assert sorted(tparams) == ["dec_final_norm", "dec_stack", "embed",
                               "enc_final_norm", "enc_stack"]
    assert get_arch(NAME).param_count() == \
        analytic_param_count(jget_arch(NAME)) == 1_632_256_000


def test_cache_specs_equal_reference():
    ts = build_model(get_arch(NAME)).cache_specs(8, 384)
    js = jbuild(jget_arch(NAME)).cache_specs(8, 384)
    assert _paths(ts) == [(p, s, str(d)) for p, s, d in _paths(js)]
    assert sorted(ts) == ["cross_k", "cross_v", "self"]
    assert tuple(ts["cross_k"].shape) == (24, 8, 384, 16, 64)


@pytest.mark.parametrize("step", [0, 3])
def test_make_batch_equals_reference(step):
    S = ShapeConfig("s", "train", 64, 4)
    got = make_batch(get_arch(SMOKE), S, step)
    want = jmake_batch(jget_arch(SMOKE), JShapeConfig("s", "train", 64, 4),
                       step)
    assert sorted(got) == ["src_emb", "tgt_targets", "tgt_tokens"]
    assert got["tgt_tokens"].shape == (4, 16)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# Cross attention: K1 and K2's plain versions on the new routes
# ---------------------------------------------------------------------------

def test_plain_k1_over_a_cross_cache_matches_reference_naive():
    rng = np.random.default_rng(4)
    B, S, H, hd = 2, 48, 16, 64
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for _ in range(2))
    want = jattn.sdpa_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=False, q_pos=jnp.arange(1),
                            kv_pos=jnp.arange(S))
    kv_pos, pos = tencdec.cross_positions(torch.from_numpy(k))
    assert kv_pos.tolist() == list(range(S)) and pos.tolist() == [S - 1]
    got = decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), pos, kv_pos)
    assert np.abs(_f(want) - to_numpy(got)).max() < 1e-5


@pytest.mark.parametrize("Sq,impl", [(1, "kernel"), (5, "kernel"),
                                     (5, "blockwise")])
def test_cross_attn_fwd_matches_reference(Sq, impl):
    """The decode route (Sq 1: K1's plain version over the cross cache) and
    the prefill routes (K2's plain version, blockwise) at Sq != Skv."""
    jc, tc = cfgs(SMOKE + "-h16", dtype="float32")
    p = jencdec.init_cross_attn(jc, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, Sq, 128)).astype(np.float32)
    mem = rng.standard_normal((2, 24, 128)).astype(np.float32)
    jk, jv = jencdec.cross_kv(jc, p, jnp.asarray(mem))
    want = jencdec.cross_attn_fwd(jc, p, jnp.asarray(x), jk, jv)
    tk, tv = tencdec.cross_kv(tc, tp, torch.from_numpy(mem))
    pos = tencdec.cross_positions(tk) if Sq == 1 else None
    got = tencdec.cross_attn_fwd(tc, tp, torch.from_numpy(x), tk, tv,
                                 impl=impl, chunk=8, positions=pos)
    assert np.abs(_f(want) - to_numpy(got)).max() < 1e-5


# ---------------------------------------------------------------------------
# Whole-model parity on shared weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", (SMOKE,) + tuple(VARIANTS))
def test_encode_matches_reference(name):
    jb, jp, tb, tp = shared(name)
    src = prompt(tb.cfg)["src_emb"]
    want = jencdec.encode(jb.cfg, jp, jnp.asarray(src), impl="blockwise")
    for impl in ("kernel", "blockwise", "naive"):
        got = tencdec.encode(tb.cfg, tp, torch.from_numpy(src), impl=impl)
        assert np.abs(_f(want) - to_numpy(got)).max() < F32_TOL


@pytest.mark.parametrize("name", (SMOKE,) + tuple(VARIANTS))
def test_f32_prefill_and_greedy_decode_match_reference(name):
    jb, jp, tb, tp = shared(name)
    b = prompt(tb.cfg)
    T = b["tgt_tokens"].shape[1]
    jl, jc = jb.prefill_fn(jp, jbatch(b))
    tl, tc = tb.prefill_fn(tp, tbatch(b))
    assert sorted(tc) == ["cross_k", "cross_v", "self"]
    assert np.max(np.abs(_f(jl) - to_numpy(tl))) < F32_TOL
    assert _paths(tc) == [(p, s, str(d)) for p, s, d in _paths(jc)]
    for a, c in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        assert np.max(np.abs(_f(a) - to_numpy(c).astype(np.float32))) \
            < F32_TOL
    jdec = jax.jit(jb.decode_fn)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tl.argmax(-1).to(torch.int32)
    for i in range(8):
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        jl, jc = jdec(jp, jtok, jnp.int32(T + i), jc)
        tl, tc = tb.decode_fn(tp, ttok, T + i, tc, inplace=i % 2 == 0)
        assert np.max(np.abs(_f(jl) - to_numpy(tl))) < F32_TOL
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
    for a, c in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        assert np.max(np.abs(_f(a) - to_numpy(c).astype(np.float32))) \
            < F32_TOL


@pytest.mark.parametrize("name", (SMOKE,) + tuple(VARIANTS))
def test_generate_matches_reference(name):
    jb, jp, tb, tp = shared(name)
    b = prompt(tb.cfg)
    want = jgenerate(jb, jp, jbatch(b), 8)
    got = generate(tb, tp, tbatch(b), 8)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # the plain path (blockwise prefill, plain decode) gives them too
    plain = build_model(tb.cfg, prefill_impl="blockwise",
                        decode_impl="naive")
    np.testing.assert_array_equal(np.asarray(want),
                                  generate(plain, tp, tbatch(b), 8).numpy())


def test_decode_copies_only_the_self_cache():
    _, _, tb, tp = shared(SMOKE)
    _, c = tb.prefill_fn(tp, tbatch(prompt(tb.cfg)))
    before = tree_map(torch.clone, c)
    tok = torch.zeros(2, dtype=torch.int32)
    _, c2 = tb.decode_fn(tp, tok, 8, c)
    for a, b in zip(tree_leaves(c), tree_leaves(before)):
        assert torch.equal(a, b)
    assert c2["cross_k"] is c["cross_k"] and c2["self"] is not c["self"]
    assert not torch.equal(c2["self"]["kv_pos"], c["self"]["kv_pos"])


def test_encdec_loss_and_grads_match_reference():
    from repro_torch.train.train_step import value_and_grad

    jb, jp, tb, tp = shared(SMOKE)
    batch = make_batch(tb.cfg, ShapeConfig("t", "train", SEQ, 2), 0)
    rng = np.random.default_rng(3)
    masked = dict(batch, loss_mask=(rng.random(batch["tgt_targets"].shape)
                                    < 0.7).astype(np.float32))
    jvg = jax.jit(jax.value_and_grad(jb.loss_fn, has_aux=True))
    for b in (batch, masked):
        with jax.default_matmul_precision("highest"):
            (jl, _), jg = jvg(jp, jbatch(b))
        g, loss, metrics = value_and_grad(tb)(tp, b)
        assert abs(float(loss) - float(jl)) <= LOSS_REL_TOL * abs(float(jl))
        assert float(metrics["aux_loss"]) == 0.0
        _assert_grads_close(g, jg, GRAD_REL_TOL)


# ---------------------------------------------------------------------------
# The Funky entry points, as the reference has them
# ---------------------------------------------------------------------------

def test_serve_task_fails_on_a_seamless_image_as_the_reference():
    """Both packages' ``ServeTask`` prefill ``{"tokens"}``, which an
    encoder-decoder has not: the task ends FAILED."""
    im = dict(name="svc", kind="serve", arch=SMOKE, prompt_len=16,
              global_batch=2, total_steps=2, tokens_per_step=2)
    jrt = JFunkyRuntime("n0", JSliceAllocator("n0", 1))
    jrt.create("t", JTaskImage(**im))
    jrt.start("t")
    assert jrt.wait("t", timeout=120).value == "failed"
    jrt.delete("t")
    rt = FunkyRuntime("n0", SliceAllocator("n0", 1, device="cpu"))
    rt.create("t", TaskImage(**im))
    rt.start("t")
    assert rt.wait("t", timeout=120) is TaskStatus.FAILED
    assert rt.tasks["t"].error
    rt.delete("t")


def test_train_task_step_has_the_reference_loss(f32_archs):
    arch = NAME + "-f32-smoke"
    image = TaskImage(name="t", kind="train", arch=arch, seq_len=SEQ,
                      global_batch=2, total_steps=1, chunks=1, seed=0)
    want = reference_train_loss(image)
    on_reference_weights(f32_archs, arch)
    got = port_train_loss(image)
    assert abs(got - want) <= LOSS_REL_TOL * abs(want)


def test_no_paged_decode():
    bundle = build_model(get_arch(SMOKE))
    with pytest.raises(NotImplementedError, match="no paged decode"):
        bundle.decode_paged_fn(None, None, None, None, None)
    from repro_torch.models.transformer import plan_segments

    with pytest.raises(ValueError, match="models/encdec.py"):
        plan_segments(get_arch(SMOKE))
