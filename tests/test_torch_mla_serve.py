"""deepseek-v3-671b (MLA) served by the PyTorch port on the CPU: the paged
engine over a pool of latent pages against the JAX engine, and the slice
as a whole.

* the page pool takes the MLA cache: ``ckv`` and ``k_pe`` are paged beside
  ``kv_pos`` (page layout, gather through a block-table row, prefill
  scatter, written page, scrub, extract/install, compaction), and any
  other leaf without a token axis is still refused;
* the paged engine's f32 transcripts equal the JAX engine's on its weights
  (``deepseek-v3-671b-f32`` registered in both packages' ``ARCHS`` for
  this module only; 2 lanes, pages of 4, 6 requests): single-step, 4
  steps fused with one EXECUTE ahead, and single-step evicted and resumed
  every 3 iterations; the JAX engine gathers each lane's latent cache and
  decodes it alone (a vmap), the port decodes every lane over the pool in
  place (``mla_decode_paged``, absorbed, as the reference's default);
* ``TaskImage(arch="deepseek-v3-671b-smoke")`` served by ``FunkyRuntime``
  gives ``generate``'s tokens, uninterrupted and with one evict/resume
  between steps; an ``EngineServeTask`` drains its router;
  ``make_cluster`` deploys the serve image to done.
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
from repro_torch.models.attention import _INVALID_POS  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.scaling.serving import reset_router  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.serve import kvcache  # noqa: E402
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      ServeRequest)
from repro_torch.serve.equivalence import run_transcript  # noqa: E402
from repro_torch.testing import params_from_jax  # noqa: E402

NAME = "deepseek-v3-671b"
SMOKE = NAME + "-smoke"
PROMPT = 24
PROMPT_LEN, PAGE = 8, 4


def _requests(cls):
    rng = np.random.Generator(np.random.Philox(2))
    return [cls(rid=f"r{i}", prompt=rng.integers(0, 100, PROMPT_LEN),
                max_new_tokens=n) for i, n in enumerate([6, 8, 4, 7, 5, 8])]


# ---------------------------------------------------------------------------
# The page pool over latent leaves
# ---------------------------------------------------------------------------

def test_pool_pages_the_latent_cache():
    """A one-lane prefill cache of the smoke model (P 8) onto a pool of 6
    pages of 4: the specs, a scatter and the lane's gather (its prefill
    back, unmapped pages INVALID), the written page, a scrub, a staged
    extract/install and a compaction move whole latent pages."""
    cfg = get_arch(SMOKE)
    bundle = build_model(cfg, cache_margin=0)
    specs = bundle.cache_specs(1, PROMPT_LEN)
    pool_abs = kvcache.pool_specs_from_lane_cache(specs, 6, PAGE, PROMPT_LEN)
    L0, r, rope = 1, cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    seg0 = pool_abs[0][0]
    assert tuple(seg0["ckv"].shape) == (7, L0, PAGE, r)
    assert tuple(seg0["k_pe"].shape) == (7, L0, PAGE, rope)
    assert tuple(seg0["kv_pos"].shape) == (7, L0, PAGE)
    pool = kvcache.init_caches_from_specs(pool_abs, "cpu")
    params = bundle.init(0, device="cpu")
    toks = torch.arange(PROMPT_LEN, dtype=torch.int32)[None] * 7 % 512
    _, pf = bundle.prefill_fn(params, {"tokens": toks})
    kvcache.scatter_prefill(pool, [4, 1], pf, page_size=PAGE,
                            prompt_len=PROMPT_LEN)
    row = torch.tensor([4, 1, -1], dtype=torch.int32)
    lane = kvcache.gather_lane_cache(pool, row, page_size=PAGE)
    for si in range(2):
        got, want = lane[si][0], pf[si][0]
        for name in ("ckv", "k_pe"):
            assert tuple(got[name].shape)[-3] == 1
            assert torch.equal(got[name][..., :PROMPT_LEN, :], want[name])
        assert torch.equal(got["kv_pos"][..., :PROMPT_LEN], want["kv_pos"])
        assert (got["kv_pos"][..., PROMPT_LEN:] == _INVALID_POS).all()
    page = kvcache.extract_written_page(lane, 1, page_size=PAGE)
    assert torch.equal(page[1][0]["ckv"], pool[1][0]["ckv"][1])
    staged = kvcache.extract_pool_pages(pool, [4, 1])
    kvcache.compact_pool(pool, [4], [0])
    assert torch.equal(pool[0][0]["k_pe"][0], staged[0][0]["k_pe"][0])
    kvcache.scrub_pages(pool, [0])
    assert (pool[1][0]["kv_pos"][0] == _INVALID_POS).all()
    kvcache.install_pool_pages(pool, staged, [2, 3])
    assert torch.equal(pool[1][0]["ckv"][3], staged[1][0]["ckv"][1])
    with pytest.raises(ValueError, match="cannot page cache leaf 'h'"):
        kvcache.pool_specs_from_lane_cache(
            {"h": torch.empty((1, 2, 8), device="meta")}, 6, PAGE, 8)


# ---------------------------------------------------------------------------
# The paged engine against the JAX engine (f32, shared weights)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_ref():
    """``deepseek-v3-671b-f32`` in both packages' ``ARCHS``; the JAX
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


RUNS = {"single_step": (dict(), 0),
        "fused4_async1": (dict(fuse_steps=4, async_depth=1), 0),
        "evict_resume_every_3": (dict(), 3)}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_paged_engine_transcripts_match_the_reference(engine_ref, run):
    params, want = engine_ref
    kw, every = RUNS[run]

    def make():
        mon = Monitor("port", SliceAllocator("n0", 1, device="cpu"),
                      telemetry=MetricsRegistry())
        eng = ContinuousBatchingEngine(f"{NAME}-f32-smoke", FunkyCL(mon),
                                       slots=2, prompt_len=PROMPT_LEN,
                                       max_new_tokens=8, page_size=PAGE,
                                       **kw)
        eng.setup()
        eng.cl.write_buffer("params", params).wait()
        return mon, eng

    evicts = []

    def evict_resume(eng, mon, i):
        # the monitor-level evict + resume of ``evict_resume_every``, while
        # lanes are in flight; the pool's latent pages go to the host
        if every and i % every == 0 and eng.active_count:
            evicts.append(mon.evict())
            mon.resume()

    got, eng = run_transcript(make, lambda: _requests(ServeRequest),
                              step_hook=evict_resume)
    assert eng.paged
    assert got == want
    eng.pool.check_invariants()
    if kw.get("fuse_steps", 1) > 1:
        assert eng.program_execs.get("decode_multi", 0) > 0
    assert len(evicts) >= (2 if every else 0)


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
    prompt = make_batch_tokens(cfg, image)
    n = image.total_steps * image.tokens_per_step
    toks = generate(bundle, params, {"tokens": torch.from_numpy(prompt)},
                    n + 1)
    return toks[:, n].tolist()


def make_batch_tokens(cfg, image):
    from repro_torch.train import make_batch

    return make_batch(cfg, ShapeConfig("p", "train", image.prompt_len,
                                       image.global_batch), 0)["tokens"]


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
    name = "svc-mla"
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
    assert rec.task.engine.paged
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
