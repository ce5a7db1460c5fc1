"""deepseek-moe-16b served by the PyTorch port on the CPU: the paged
engine against the JAX engine, and the slice as a whole.

* the paged engine's f32 transcripts equal the JAX engine's on its
  weights (``deepseek-moe-16b-f32`` registered in both packages' ``ARCHS``
  for this module only; 2 lanes, pages of 4, 6 requests); the JAX engine
  decodes each lane alone (a vmap), the port routes the lanes together
  with ``moe_fwd``'s ``live`` (padded to ``DECODE_ROWS`` rows);
* ``TaskImage(arch="deepseek-moe-16b-smoke")`` served by ``FunkyRuntime``
  gives ``generate``'s tokens, uninterrupted and with one evict/resume
  between steps;
* an ``EngineServeTask`` drains its router; ``make_cluster`` deploys the
  serve image to done.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.core import FunkyCL as JFunkyCL  # noqa: E402
from repro.core import Monitor as JMonitor  # noqa: E402
from repro.core import SliceAllocator as JSliceAllocator  # noqa: E402
from repro.serve.engine import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve.engine import ServeRequest as JServeRequest  # noqa: E402
from repro_torch.chaos import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.core import (EngineServeTask, FunkyCL,  # noqa: E402
                              FunkyRuntime, Monitor, SliceAllocator,
                              TaskImage, TaskStatus, make_cluster)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.scaling.serving import reset_router  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      ServeRequest)
from repro_torch.serve.equivalence import run_transcript  # noqa: E402
from repro_torch.testing import params_from_jax  # noqa: E402
from repro_torch.train import make_batch  # noqa: E402

NAME = "deepseek-moe-16b"
SMOKE = NAME + "-smoke"
PROMPT = 24
PROMPT_LEN, PAGE = 8, 4


def _requests(cls):
    rng = np.random.Generator(np.random.Philox(2))
    return [cls(rid=f"r{i}", prompt=rng.integers(0, 100, PROMPT_LEN),
                max_new_tokens=n) for i, n in enumerate([6, 8, 4, 7, 5, 8])]


# ---------------------------------------------------------------------------
# The paged engine against the JAX engine (f32, shared weights)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_ref():
    """``deepseek-moe-16b-f32`` in both packages' ``ARCHS``; the JAX
    engine's weights and transcript."""
    mp = pytest.MonkeyPatch()
    for mod in (jcfg, tcfg):
        mp.setitem(mod.ARCHS, f"{NAME}-f32", dataclasses.replace(
            mod.ARCHS[NAME], name=f"{NAME}-f32", dtype="float32"))
    mon = JMonitor("ref", JSliceAllocator("n0", 1))
    eng = JEngine(f"{NAME}-f32-smoke", JFunkyCL(mon), slots=2,
                  prompt_len=PROMPT_LEN, max_new_tokens=8, page_size=PAGE)
    eng.setup()
    params = params_from_jax(jax.tree.map(
        np.asarray, eng.cl.read_buffer("params")))
    for r in _requests(JServeRequest):
        eng.submit(r)
    eng.run_until_drained()
    want = {rid: list(rec.tokens) for rid, rec in eng.completed.items()}
    mon.vfpga_exit()
    yield params, want
    mp.undo()


def test_paged_engine_transcripts_match_the_reference(engine_ref):
    params, want = engine_ref

    def make():
        mon = Monitor("port", SliceAllocator("n0", 1, device="cpu"),
                      telemetry=MetricsRegistry())
        eng = ContinuousBatchingEngine(f"{NAME}-f32-smoke", FunkyCL(mon),
                                       slots=2, prompt_len=PROMPT_LEN,
                                       max_new_tokens=8, page_size=PAGE)
        eng.setup()
        eng.cl.write_buffer("params", params).wait()
        return mon, eng

    got, eng = run_transcript(make, lambda: _requests(ServeRequest))
    assert eng.paged
    assert len(got) == 6
    assert got == want


# ---------------------------------------------------------------------------
# The slice as a whole: TaskImage, EngineServeTask, make_cluster
# ---------------------------------------------------------------------------

def _serve_image(name="svc"):
    return TaskImage(name=name, kind="serve", arch=SMOKE, prompt_len=PROMPT,
                     global_batch=2, total_steps=4, tokens_per_step=2,
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


@pytest.mark.parametrize("evict", [False, True])
def test_runtime_serves_generate_tokens(evict):
    image = _serve_image()
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
    rt.delete("t")


def test_engine_serve_task_drains_the_router():
    name = "svc-moe"
    im = TaskImage(name=name, kind="engine-serve", arch=SMOKE,
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


def test_make_cluster_deploys_the_serve_image(tmp_path):
    cl = make_cluster(num_nodes=1, slices_per_node=1,
                      images={SMOKE: _serve_image(SMOKE)}, device="cpu",
                      ckpt_root=str(tmp_path))
    try:
        orch = cl.orchestrator
        orch.start(tick_interval=0.01)
        orch.submit(SMOKE, priority=0)
        assert orch.wait_all(timeout=120)
        assert [d.status for d in orch.deployments.values()] == ["done"]
    finally:
        cl.stop()
