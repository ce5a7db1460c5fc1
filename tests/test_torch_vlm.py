"""The VLM family of the PyTorch port (llava-next-mistral-7b: the dense
plan with precomputed image embeddings spliced in front of the text)
against the reference.

* the config equals the reference's; at full width the parameter tree has
  the reference's keys, shapes and dtypes and the same count
  (7,241,732,096); ``plan_segments`` plans it as dense; the cache specs
  match;
* on shared f32 weights (``params_from_jax``): ``lm_prefill`` with
  ``img_emb`` (logits and caches within 1e-4 absolute), then 8 greedy
  decode steps from position tokens + ``num_image_tokens`` with equal
  tokens; ``generate`` with the image gives the reference's 8 tokens, and
  so does the plain path;
* ``lm_loss`` with the image (the loss over the text positions only),
  within 1e-5 relative, every gradient leaf within 1e-4 of max|g|
  against ``jax.grad``, with and without a loss mask;
* ``make_batch``'s vlm batch is array-equal to the reference's;
* the Funky entry points as the reference has them: its ``ServeTask`` and
  its paged engine pass ``{"tokens"}`` only, so they serve llava as text
  (``ServeTask``: ``max(prompt_len - num_image_tokens, 8)`` tokens of
  ``make_batch``); the port's give the reference's tokens on the
  reference's initial weights (f32); a ``TrainTask`` step, image and
  all, runs to DONE with the reference's loss.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import FunkyCL as JFunkyCL  # noqa: E402
from repro.core import FunkyRuntime as JFunkyRuntime  # noqa: E402
from repro.core import Monitor as JMonitor  # noqa: E402
from repro.core import SliceAllocator as JSliceAllocator  # noqa: E402
from repro.core import TaskImage as JTaskImage  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.model_zoo import analytic_param_count  # noqa: E402
from repro.serve.engine import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve.engine import ServeRequest as JServeRequest  # noqa: E402
from repro.serve.serve_step import generate as jgenerate  # noqa: E402
from repro.train.data import make_batch as jmake_batch  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.core import (FunkyCL, FunkyRuntime, Monitor,  # noqa: E402
                              SliceAllocator, TaskImage, TaskStatus)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import plan_segments  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      ServeRequest)
from repro_torch.serve.equivalence import run_transcript  # noqa: E402
from repro_torch.testing import params_from_jax, to_numpy  # noqa: E402
from repro_torch.train import make_batch  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_encdec import (F32_TOL, GRAD_REL_TOL,  # noqa: E402,F401
                               LOSS_REL_TOL, _f, _paths, f32_archs,
                               jbatch, on_reference_weights,
                               port_train_loss, prompt,
                               reference_train_loss, shared, tbatch)
from test_torch_train import _assert_grads_close  # noqa: E402

NAME = "llava-next-mistral-7b"
SMOKE = NAME + "-smoke"
SEQ = 32                # make_batch's S: 8 image embeddings, 24 tokens
PROMPT_LEN, PAGE = 8, 4


# ---------------------------------------------------------------------------
# Config, parameter tree, caches, data
# ---------------------------------------------------------------------------

def test_config_equals_reference_and_plans_dense():
    for n in (NAME, SMOKE):
        assert dataclasses.asdict(get_arch(n)) == \
            dataclasses.asdict(jget_arch(n))
    cfg = get_arch(NAME)
    assert cfg.source == "hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified"
    assert cfg.num_image_tokens == 2880
    segs = plan_segments(cfg)
    assert len(segs) == 1 and segs[0].count == 32
    assert [b.mixer for b in segs[0].blocks] == ["attn"]


def test_param_tree_and_count_equal_reference():
    tparams = build_model(get_arch(NAME)).init(0, device="meta")
    jparams = jax.eval_shape(jbuild(jget_arch(NAME)).init,
                             jax.random.PRNGKey(0))
    assert _paths(tparams) == _paths(jparams)
    assert get_arch(NAME).param_count() == \
        analytic_param_count(jget_arch(NAME)) == 7_241_732_096


def test_cache_specs_equal_reference():
    ts = build_model(get_arch(NAME)).cache_specs(8, 3072 + 128)
    js = jbuild(jget_arch(NAME)).cache_specs(8, 3072 + 128)
    assert _paths(ts) == [(p, s, str(d)) for p, s, d in _paths(js)]


@pytest.mark.parametrize("step", [0, 5])
def test_make_batch_equals_reference(step):
    got = make_batch(get_arch(SMOKE), ShapeConfig("s", "train", SEQ, 4),
                     step)
    want = jmake_batch(jget_arch(SMOKE), JShapeConfig("s", "train", SEQ, 4),
                       step)
    assert sorted(got) == ["img_emb", "targets", "tokens"]
    assert got["tokens"].shape == (4, SEQ - 8)
    assert got["img_emb"].shape == (4, 8, 64)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    # at full width: 2880 image positions, 192 text tokens of 3072
    b = make_batch(get_arch(NAME), ShapeConfig("s", "train", 3072, 1), 0)
    assert b["tokens"].shape == (1, 192)
    assert b["img_emb"].shape == (1, 2880, 4096)


# ---------------------------------------------------------------------------
# Whole-model parity on shared weights
# ---------------------------------------------------------------------------

def test_f32_prefill_with_image_and_greedy_decode_match_reference():
    jb, jp, tb, tp = shared(SMOKE)
    b = prompt(tb.cfg)
    pos = b["tokens"].shape[1] + tb.cfg.num_image_tokens
    jl, jc = jb.prefill_fn(jp, jbatch(b))
    tl, tc = tb.prefill_fn(tp, tbatch(b))
    assert np.max(np.abs(_f(jl) - to_numpy(tl))) < F32_TOL
    # the image takes positions 0..7: the caches hold 32 written slots
    assert int((tc[0][0]["kv_pos"][0] < 2 ** 30).sum()) == pos
    for a, c in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        assert tuple(a.shape) == tuple(c.shape)
        assert np.max(np.abs(_f(a) - to_numpy(c).astype(np.float32))) \
            < F32_TOL
    # the image moves the logits: the splice is not a no-op
    text_only, _ = tb.prefill_fn(tp, {"tokens": torch.from_numpy(
        b["tokens"])})
    assert np.max(np.abs(to_numpy(text_only) - to_numpy(tl))) > 1e-3
    jdec = jax.jit(jb.decode_fn)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tl.argmax(-1).to(torch.int32)
    for i in range(8):
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        jl, jc = jdec(jp, jtok, jnp.int32(pos + i), jc)
        tl, tc = tb.decode_fn(tp, ttok, pos + i, tc, inplace=True)
        assert np.max(np.abs(_f(jl) - to_numpy(tl))) < F32_TOL
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())


def test_generate_with_image_matches_reference():
    """``generate`` starts decoding at tokens + num_image_tokens, as the
    reference's; the plain path gives the same tokens."""
    jb, jp, tb, tp = shared(SMOKE)
    b = prompt(tb.cfg)
    want = np.asarray(jgenerate(jb, jp, jbatch(b), 8))
    np.testing.assert_array_equal(want, generate(tb, tp, tbatch(b),
                                                 8).numpy())
    plain = build_model(tb.cfg, prefill_impl="blockwise",
                        decode_impl="naive")
    np.testing.assert_array_equal(want, generate(plain, tp, tbatch(b),
                                                 8).numpy())


def test_lm_loss_with_image_and_grads_match_reference():
    jb, jp, tb, tp = shared(SMOKE)
    batch = make_batch(tb.cfg, ShapeConfig("t", "train", SEQ, 2), 0)
    rng = np.random.default_rng(3)
    masked = dict(batch, loss_mask=(rng.random(batch["targets"].shape)
                                    < 0.7).astype(np.float32))
    jvg = jax.jit(jax.value_and_grad(jb.loss_fn, has_aux=True))
    for b in (batch, masked):
        with jax.default_matmul_precision("highest"):
            (jl, _), jg = jvg(jp, jbatch(b))
        g, loss, _ = value_and_grad(tb)(tp, b)
        assert abs(float(loss) - float(jl)) <= LOSS_REL_TOL * abs(float(jl))
        _assert_grads_close(g, jg, GRAD_REL_TOL)
    # the image positions carry no loss: targets of the text only
    assert batch["targets"].shape == batch["tokens"].shape


# ---------------------------------------------------------------------------
# The Funky entry points, as the reference has them (text only)
# ---------------------------------------------------------------------------

def test_serve_task_serves_text_only_with_the_reference_tokens(f32_archs):
    arch = NAME + "-f32-smoke"
    im = dict(name="svc", kind="serve", arch=arch, prompt_len=20,
              global_batch=2, total_steps=3, tokens_per_step=2, seed=0)
    jrt = JFunkyRuntime("n0", JSliceAllocator("n0", 1))
    jrt.create("t", JTaskImage(**im))
    jrt.start("t")
    assert jrt.wait("t", timeout=120).value == "done"
    want = jrt.tasks["t"].guest_state.user["last_token"]
    jrt.delete("t")
    on_reference_weights(f32_archs, arch)
    rt = FunkyRuntime("n0", SliceAllocator("n0", 1, device="cpu"))
    rec = rt.create("t", TaskImage(**im))
    rt.start("t")
    assert rt.wait("t", timeout=120) is TaskStatus.DONE, rec.error
    assert rec.guest_state.user["last_token"] == want
    rt.delete("t")


def _requests(cls):
    rng = np.random.Generator(np.random.Philox(2))
    return [cls(rid=f"r{i}", prompt=rng.integers(0, 100, PROMPT_LEN),
                max_new_tokens=n) for i, n in enumerate([6, 8, 4, 7, 5])]


def test_paged_engine_serves_text_only_with_the_reference_tokens(f32_archs):
    arch = NAME + "-f32-smoke"
    mon = JMonitor("ref", JSliceAllocator("n0", 1))
    jeng = JEngine(arch, JFunkyCL(mon), slots=2, prompt_len=PROMPT_LEN,
                   max_new_tokens=8, page_size=PAGE)
    jeng.setup()
    params = params_from_jax(jax.tree.map(
        np.asarray, jeng.cl.read_buffer("params")))
    for r in _requests(JServeRequest):
        jeng.submit(r)
    jeng.run_until_drained()
    want = {rid: list(rec.tokens) for rid, rec in jeng.completed.items()}
    mon.vfpga_exit()

    def make():
        mon = Monitor("port", SliceAllocator("n0", 1, device="cpu"),
                      telemetry=MetricsRegistry())
        eng = ContinuousBatchingEngine(arch, FunkyCL(mon), slots=2,
                                       prompt_len=PROMPT_LEN,
                                       max_new_tokens=8, page_size=PAGE)
        eng.setup()
        eng.cl.write_buffer("params", params).wait()
        return mon, eng

    got, eng = run_transcript(make, lambda: _requests(ServeRequest))
    assert eng.paged
    assert got == want


def test_train_task_step_with_the_image_has_the_reference_loss(f32_archs):
    arch = NAME + "-f32-smoke"
    image = TaskImage(name="t", kind="train", arch=arch, seq_len=SEQ,
                      global_batch=2, total_steps=1, chunks=1, seed=0)
    want = reference_train_loss(image)
    on_reference_weights(f32_archs, arch)
    got = port_train_loss(image)
    assert abs(got - want) <= LOSS_REL_TOL * abs(want)
