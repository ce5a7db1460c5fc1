"""Training in the PyTorch port: the cases of ``tests/test_train.py`` on the
port (convergence, microbatch equivalence, chunked == fused, data, the
schedule, 8-bit Adam; MoE is not ported), and parity with the reference
package on shared f32 weights (``dataclasses.replace(cfg,
dtype="float32")``, the reference's ``init`` through ``params_from_jax``).

Tolerances (observed on the CPU in parentheses):
* ``lm_loss``: loss within 1e-5 relative (2e-7 to 3e-7); every gradient
  leaf within max|dg| / max|g| <= 1e-4 (2e-6 to 6e-6), with and without
  a ``loss_mask``, for yi-9b-smoke, mamba2-1.3b-smoke and
  recurrentgemma-9b-smoke;
* ``apply_updates`` from the same numpy params, grads and state: f32 and
  bf16 moments, params and moments within 1e-6 absolute; int8 moments,
  params within 1e-6, each quantised moment within one quantisation step
  (|dq| <= 1) and the f32 row scales within 1e-5 relative;
* four TrainTask-sized chunked steps (seq 32, batch 4, 2 chunks) against
  the reference's fused step: per-step loss within 1e-4 relative;
* ``make_batch`` and ``PrefetchingLoader``: equal arrays.
The ``gpu`` case holds one ``grad_step`` on the card against the
reference on the CPU to the same bounds, and the ``apply`` after it: its
gradients are not the reference's bits, and Adam's first step moves a
weight by about lr whatever the gradient's size, so a gradient within
rounding of zero may move it the other way.  So 99.9% of the params
within 1e-6 and every one within 2.2 lr (the CPU port against the
reference: 5 of 70k beyond 1e-6, the largest 7.5e-6, lr 1.5e-4).
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
from repro.train import DataConfig as JDataConfig  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402
from repro.train import PrefetchingLoader as JLoader  # noqa: E402
from repro.train import apply_updates as japply  # noqa: E402
from repro.train import make_batch as jmake_batch  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train.optimizer import init_opt_state as jinit_opt  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.testing import (opt_state_from_jax,  # noqa: E402
                                 params_from_jax)
from repro_torch.train import (DataConfig, OptConfig,  # noqa: E402
                               PrefetchingLoader, apply_updates,
                               init_opt_state, lr_at, make_batch,
                               make_chunked_train_fns, make_train_state,
                               make_train_step)
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

SHAPE = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=8)
OC = OptConfig(warmup_steps=2, decay_steps=50, moment_dtype="float32")
ARCHS = ("yi-9b-smoke", "mamba2-1.3b-smoke", "recurrentgemma-9b-smoke")
LOSS_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-4
APPLY_TOL = 1e-6
STEP_LOSS_REL_TOL = 1e-4


def _bundle(arch="yi-9b-smoke", **kw):
    return build_model(get_arch(arch), **kw)


def _tree_close(a, b, tol):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.float() - y.float()).abs().max().item()
        assert d <= tol, d


def _tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


def _clone(tree):
    """A copy to hand to a step, which updates its arguments in place."""
    return tree_map(torch.clone, tree)


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------

def test_loss_decreases():
    cfg = get_arch("yi-9b-smoke")
    b = _bundle()
    params, opt = make_train_state(b, OC, 0, device="cpu")
    step = make_train_step(b, OC)
    first = last = None
    for i in range(12):
        batch = make_batch(cfg, SHAPE, i % 2)   # reuse 2 batches -> must fit
        params, opt, m = step(params, opt, batch)
        if first is None:
            first = float(m["loss"])
        last = float(m["loss"])
    assert last < first


def test_microbatch_split_equivalence():
    """mb=1 vs mb=4 give (nearly) identical updates — the paper's claim
    that chunk splitting costs no accuracy (Fig 9)."""
    cfg = get_arch("yi-9b-smoke")
    b = _bundle()
    params, opt = make_train_state(b, OC, 1, device="cpu")
    batch = make_batch(cfg, SHAPE, 0)
    p1, o1, m1 = make_train_step(b, OC, num_microbatches=1)(
        _clone(params), _clone(opt), batch)
    p4, o4, m4 = make_train_step(b, OC, num_microbatches=4)(params, opt,
                                                             batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 5e-2
    _tree_close(p1, p4, 2e-2)   # bf16 params, f32 accum


def test_chunked_fns_match_fused_step():
    """The chunked programs run the fused step's operations in its order:
    the same bits (the reference holds them within 1e-6)."""
    cfg = get_arch("yi-9b-smoke")
    b = _bundle()
    params, opt = make_train_state(b, OC, 2, device="cpu")
    batch = make_batch(cfg, SHAPE, 3)
    p_f, o_f, _ = make_train_step(b, OC, num_microbatches=2)(
        _clone(params), _clone(opt), batch)
    grad_init, grad_step, apply_step = make_chunked_train_fns(b, OC)
    acc = grad_init(params)
    for c in range(2):
        mb = {k: v[c * 4:(c + 1) * 4] for k, v in batch.items()}
        acc2, loss = grad_step(params, acc, mb)
        assert acc2 is acc                      # accumulated in place
    p_c, o_c, _ = apply_step(params, opt, acc, 2)
    assert tree_leaves(p_c)[0] is tree_leaves(params)[0]
    _tree_equal(p_f, p_c)
    _tree_equal(o_f, o_c)


def test_remat_full_matches_none():
    """``remat="full"`` recomputes each repetition in the backward: the same
    loss, and gradients within 1e-6 of the largest (the recomputation
    sums in another order); ``"dots"`` is not ported."""
    cfg = dataclasses.replace(get_arch("recurrentgemma-9b-smoke"),
                              dtype="float32")
    params = build_model(cfg).init(0, device="cpu")
    batch = make_batch(cfg, SHAPE, 0)
    g0, l0, _ = value_and_grad(build_model(cfg))(params, batch)
    g1, l1, _ = value_and_grad(build_model(cfg, remat="full"))(params, batch)
    assert float(l0) == float(l1)
    for a, c in zip(tree_leaves(g0), tree_leaves(g1)):
        assert (a - c).abs().max() <= 1e-6 * max(a.abs().max(), 1e-30)
    with pytest.raises(NotImplementedError):
        value_and_grad(build_model(cfg, remat="dots"))(params, batch)


def test_training_refuses_the_kernels():
    """No kernel has a backward: training's attention runs a plain
    version only."""
    from repro_torch.models.attention import gqa_fwd

    cfg = get_arch("yi-9b-smoke")
    params = build_model(cfg).init(0, device="cpu")
    p = tree_map(lambda t: t[0], params["segments"][0]["blocks"][0]["attn"])
    with pytest.raises(ValueError):
        gqa_fwd(cfg, p, torch.zeros((1, 8, cfg.d_model)), impl="kernel")


def test_data_pipeline_deterministic():
    cfg = get_arch("yi-9b-smoke")
    b1 = make_batch(cfg, SHAPE, 5, DataConfig(seed=3))
    b2 = make_batch(cfg, SHAPE, 5, DataConfig(seed=3))
    b3 = make_batch(cfg, SHAPE, 6, DataConfig(seed=3))
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_data_families():
    b = make_batch(get_arch("mamba2-1.3b-smoke"), SHAPE, 0)
    assert b["tokens"].shape == (8, 32)
    for family in ("vlm", "encdec"):
        cfg = dataclasses.replace(get_arch("yi-9b-smoke"), family=family)
        with pytest.raises(NotImplementedError, match="not ported yet"):
            make_batch(cfg, SHAPE, 0)


def test_prefetching_loader():
    cfg = get_arch("yi-9b-smoke")
    loader = PrefetchingLoader(cfg, SHAPE, DataConfig(seed=1), depth=2)
    b0 = next(loader)
    b1 = next(loader)
    loader.close()
    ref0 = make_batch(cfg, SHAPE, 0, DataConfig(seed=1))
    np.testing.assert_array_equal(b0["tokens"], ref0["tokens"])
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_lr_schedule():
    oc = OptConfig(peak_lr=1e-3, min_lr=1e-4, warmup_steps=10,
                   decay_steps=100)
    assert float(lr_at(oc, torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(lr_at(oc, torch.tensor(10, dtype=torch.int32)))
               - 1e-3) < 1e-9
    assert float(lr_at(oc, torch.tensor(100, dtype=torch.int32))) <= 1.1e-4


def test_int8_adam_converges_like_f32():
    """8-bit Adam (log-quantized v) tracks f32 Adam on a regression."""
    gen = torch.Generator().manual_seed(0)
    W_true = torch.randn((32, 16), generator=gen)
    X = torch.randn((128, 32), generator=gen)
    Y = X @ W_true

    def loss_fn(p):
        return torch.mean((X @ p["w"] - Y) ** 2)

    final = {}
    for mdt in ("float32", "int8"):
        oc = OptConfig(peak_lr=5e-2, warmup_steps=5, decay_steps=200,
                       weight_decay=0.0, moment_dtype=mdt)
        params = {"w": torch.zeros((32, 16))}
        st = init_opt_state(oc, params)
        for _ in range(200):
            params, st, _ = apply_updates(
                oc, params, torch.func.grad(loss_fn)(params), st)
        final[mdt] = float(loss_fn(params))
    assert final["int8"] < max(final["float32"] * 10, 1e-3)
    # the state is genuinely 8-bit + scales
    st = init_opt_state(OptConfig(moment_dtype="int8"),
                        {"w": torch.zeros((8, 4))})
    assert st["m"]["w"].dtype == torch.int8
    assert st["v_scale"]["w"].shape == (8, 2)
    assert st["count"].dtype == torch.int32 and st["count"].ndim == 0


# ---------------------------------------------------------------------------
# parity with the reference package on shared weights
# ---------------------------------------------------------------------------

def _shared(arch):
    """(jax bundle, jax params, port bundle, port params), f32."""
    jcfg = dataclasses.replace(jget_arch(arch), dtype="float32")
    tcfg = dataclasses.replace(get_arch(arch), dtype="float32")
    jb = jbuild(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    return jb, jp, build_model(tcfg), params_from_jax(
        jax.tree.map(np.asarray, jp))


def _batch(B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
            "targets": rng.integers(0, 512, (B, S)).astype(np.int32),
            "loss_mask": (rng.random((B, S)) > 0.3).astype(np.float32)}


def _assert_grads_close(ours, ref, tol):
    la, lb = tree_leaves(ours), jax.tree.leaves(ref)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        b = np.asarray(b, np.float32)
        err = np.abs(a.float().numpy() - b).max()
        assert err <= tol * max(np.abs(b).max(), 1e-30), (a.shape, err)


def grads_against_reference(arch, device):
    """The port's loss and gradients on ``device`` against the reference's
    on the CPU, with and without a loss mask."""
    jb, jp, tb, tp = _shared(arch)
    tp = tree_map(lambda t: t.to(device), tp)
    jvg = jax.jit(jax.value_and_grad(jb.loss_fn, has_aux=True))
    vg = value_and_grad(tb)
    full = _batch()
    for batch in ({k: full[k] for k in ("tokens", "targets")}, full):
        (jl, _), jg = jvg(jp, {k: jnp.asarray(v) for k, v in batch.items()})
        g, loss, _ = vg(tp, batch)
        assert abs(float(loss) - float(jl)) <= LOSS_REL_TOL * abs(float(jl))
        _assert_grads_close(tree_map(lambda t: t.cpu(), g), jg,
                            GRAD_REL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    grads_against_reference(arch, "cpu")


def _opt_inputs(moment_dtype, seed=0):
    """Numpy params, grads and a non-trivial optimizer state (count 3,
    moments drawn at random in the moment format) of two leaves: a
    stacked (8, 4, 6) weight (updated slice by slice) and a norm scale
    (no weight decay)."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 4, 6), "scale": (6,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
             for k, s in shapes.items()}
    st = jax.tree.map(np.asarray, jinit_opt(
        JOptConfig(moment_dtype=moment_dtype), params))
    st["count"] = np.asarray(3, np.int32)
    if moment_dtype == "int8":
        for k, s in shapes.items():
            st["m"][k] = rng.integers(-127, 128, s).astype(np.int8)
            st["v"][k] = rng.integers(-127, 128, s).astype(np.int8)
            st["m_scale"][k] = (rng.random(s[:-1] + (1,)) * 1e-2 + 1e-3
                                ).astype(np.float32)
            lo = np.log(rng.random(s[:-1] + (1,)) * 1e-4 + 1e-6)
            st["v_scale"][k] = np.concatenate(
                [lo, np.full_like(lo, 4.0)], -1).astype(np.float32)
    else:
        for k, s in shapes.items():
            m = (rng.standard_normal(s) * 0.1).astype(np.float32)
            v = (rng.random(s) * 0.01).astype(np.float32)
            st["m"][k] = np.asarray(jnp.asarray(m, moment_dtype))
            st["v"][k] = np.asarray(jnp.asarray(v, moment_dtype))
    return params, grads, st


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_apply_updates_matches_reference(moment_dtype):
    params, grads, st = _opt_inputs(moment_dtype)
    jcfg = JOptConfig(warmup_steps=2, decay_steps=100,
                      moment_dtype=moment_dtype)
    tcfg = OptConfig(warmup_steps=2, decay_steps=100,
                     moment_dtype=moment_dtype)
    jp, jst, jstats = japply(jcfg, params, grads, st)
    tp, tst, tstats = apply_updates(
        tcfg, params_from_jax(params), params_from_jax(grads),
        opt_state_from_jax(st))
    assert int(tst["count"]) == int(jst["count"]) == 4
    assert abs(float(tstats["grad_norm"]) - float(jstats["grad_norm"])) \
        <= 1e-6 * float(jstats["grad_norm"])
    assert abs(float(tstats["lr"]) - float(jstats["lr"])) <= 1e-12
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=APPLY_TOL)
        for mom in ("m", "v"):
            ours = tst[mom][k]
            ref = np.asarray(jst[mom][k])
            if moment_dtype == "int8":
                assert ours.dtype == torch.int8
                assert np.abs(ours.numpy().astype(np.int32)
                              - ref.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(ours.float().numpy(),
                                           np.asarray(ref, np.float32),
                                           rtol=0, atol=APPLY_TOL)
        if moment_dtype == "int8":
            for sc in ("m_scale", "v_scale"):
                np.testing.assert_allclose(tst[sc][k].numpy(),
                                           np.asarray(jst[sc][k]),
                                           rtol=1e-5, atol=0)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_blocked_update_equals_whole_leaf(moment_dtype, monkeypatch):
    """Updating a leaf a block of last-dim rows at a time changes no
    bit."""
    from repro_torch.train import optimizer

    params, grads, st = _opt_inputs(moment_dtype, seed=1)
    cfg = OptConfig(warmup_steps=2, decay_steps=100,
                    moment_dtype=moment_dtype)

    def run(block):
        monkeypatch.setattr(optimizer, "_UPDATE_BLOCK", block)
        p, s = params_from_jax(params), opt_state_from_jax(st)
        return apply_updates(cfg, p, params_from_jax(grads), s)[:2]

    _tree_equal(run(1 << 30), run(6))           # one row a block


def test_opt_state_from_jax_keeps_dtypes():
    _, _, st = _opt_inputs("int8")
    ours = opt_state_from_jax(st)
    assert ours["count"].dtype == torch.int32 and ours["count"].ndim == 0
    assert ours["m"]["w"].dtype == torch.int8
    assert ours["v_scale"]["w"].shape == (8, 4, 2)
    _, _, st16 = _opt_inputs("bfloat16")
    assert opt_state_from_jax(st16)["m"]["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        opt_state_from_jax({"m": st["m"], "v": st["v"]})


def test_chunked_steps_match_reference_fused_step():
    """Four TrainTask-sized steps (the image's defaults: seq 32, batch 4,
    2 chunks, its OptConfig) of the port's chunked programs against the
    reference's fused step from the same weights and batches."""
    jb, jp, tb, tp = _shared("yi-9b-smoke")
    jcfg = JOptConfig(warmup_steps=2, decay_steps=100)
    tcfg = OptConfig(warmup_steps=2, decay_steps=100)
    cfg = get_arch("yi-9b-smoke")
    shape = ShapeConfig("task", "train", 32, 4)
    jstep = jax.jit(jmake_train_step(jb, jcfg, num_microbatches=2))
    jo = jinit_opt(jcfg, jp)
    grad_init, grad_step, apply_step = make_chunked_train_fns(tb, tcfg)
    to = init_opt_state(tcfg, tp)
    for s in range(4):
        batch = make_batch(cfg, shape, s)
        jp, jo, jm = jstep(jp, jo, batch)
        acc, losses = grad_init(tp), []
        for c in range(2):
            acc, loss = grad_step(tp, acc, {k: v[c * 2:(c + 1) * 2]
                                            for k, v in batch.items()})
            losses.append(float(loss))
        tp, to, _ = apply_step(tp, to, acc, 2)
        ref = float(jm["loss"])
        assert abs(np.mean(losses) - ref) <= STEP_LOSS_REL_TOL * abs(ref), s


def test_make_batch_and_loader_equal_reference():
    for name, S, B, step, seed in (("yi-9b-smoke", 32, 8, 0, 0),
                                   ("mamba2-1.3b-smoke", 16, 4, 5, 3),
                                   ("yi-9b", 1024, 8, 2, 0)):
        ours = make_batch(get_arch(name), ShapeConfig("s", "train", S, B),
                          step, DataConfig(seed=seed))
        ref = jmake_batch(jget_arch(name), JShape("s", "train", S, B), step,
                          JDataConfig(seed=seed))
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(ours[k], ref[k])
    # overrides and a process shard
    kw = dict(batch_override=6, seq_override=12)
    ours = make_batch(get_arch("yi-9b-smoke"), SHAPE, 4,
                      DataConfig(seed=2, process_index=1, process_count=2),
                      **kw)
    ref = jmake_batch(jget_arch("yi-9b-smoke"), JShape("s", "train", 32, 8),
                      4, JDataConfig(seed=2, process_index=1,
                                     process_count=2), **kw)
    assert ours["tokens"].shape == (3, 12)
    np.testing.assert_array_equal(ours["tokens"], ref["tokens"])
    jshape = JShape("s", "train", 32, 8)
    loader = PrefetchingLoader(get_arch("yi-9b-smoke"), SHAPE,
                               DataConfig(seed=4), start_step=2)
    jloader = JLoader(jget_arch("yi-9b-smoke"), jshape, JDataConfig(seed=4),
                      start_step=2)
    try:
        for _ in range(3):
            a, b = next(loader), next(jloader)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["targets"], b["targets"])
    finally:
        loader.close()
        jloader.close()
    assert not loader._thread.is_alive()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_grad_step_and_apply_on_card_match_reference(cuda):
    """One ``grad_step`` and one ``apply`` of yi-9b-smoke in f32 on the
    card against the reference on the CPU (no TF32)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    grads_against_reference("yi-9b-smoke", cuda)
    jb, jp, tb, tp = _shared("yi-9b-smoke")
    jcfg = JOptConfig(warmup_steps=2, decay_steps=100)
    tcfg = OptConfig(warmup_steps=2, decay_steps=100)
    batch = {k: v for k, v in _batch(B=2).items() if k != "loss_mask"}
    jg = jax.grad(lambda p: jb.loss_fn(p, batch)[0])(jp)
    jp2, _, _ = japply(jcfg, jp, jg, jinit_opt(jcfg, jp))
    grad_init, grad_step, apply_step = make_chunked_train_fns(tb, tcfg)
    tp = tree_map(lambda t: t.to(cuda), tp)
    acc, _ = grad_step(tp, grad_init(tp), batch)
    tp2, _, _ = apply_step(tp, init_opt_state(tcfg, tp), acc, 1)
    # a gradient within rounding of zero may take either sign: Adam's first
    # step moves a weight by about lr either way, so params are held to lr
    lr = float(lr_at(tcfg, torch.tensor(1)))
    for a, b in zip(tree_leaves(tp2), jax.tree.leaves(jp2)):
        b = np.asarray(b)
        err = np.abs(a.cpu().numpy() - b)
        assert (err <= APPLY_TOL).mean() >= 0.999
        assert err.max() <= 2.2 * lr
