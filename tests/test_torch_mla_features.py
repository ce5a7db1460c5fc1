"""The paged engine's features over latent pages: deepseek-v3-671b (MLA)
with the prefix cache, speculative decode and the prefill/decode
handoff, against the JAX engine.

``deepseek-v3-671b-f32`` is registered in both packages' ``ARCHS`` for
this module only; every run serves its smoke in float32 with 2 lanes,
prompts of 8 and pages of 4, the port engine on the JAX engine's weights
(``write_buffer``).  The reference's engine pages any cache leaf with a
token axis, so it runs all three over ``ckv``/``k_pe`` pages:

* the prefix cache (``prefill_chunk`` at one lane over latent pages):
  cold, partial-hit and full-hit admissions on a tight pool give the JAX
  prefix engine's transcripts and ``prefix_stats`` (hits, pages saved);
* speculative decode with a self-draft of k 2 (the draft decodes dense
  per-lane latent rings, ``mla_decode``'s per-lane positions): the JAX
  engine's transcripts and ``spec_stats`` (accept rate, tokens per
  verify), which equal the prefix engine's tokens (both greedy);
* a prefill replica and a fused decode replica behind one
  ``TransferQueue`` (``xfer_extract``/``xfer_install`` of latent pages):
  the JAX pair's transcripts, handoff, fallback and byte counters and
  router pops, and the port's aggregated engine's tokens (the workload of
  ``test_torch_disagg.py``'s pair: its prompts, these lengths).

Each JAX engine runs once, in a module fixture.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.core import FunkyCL as JFunkyCL  # noqa: E402
from repro.core import Monitor as JMonitor  # noqa: E402
from repro.core import SliceAllocator as JSliceAllocator  # noqa: E402
from repro.scaling.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro.scaling.serving import RequestRouter as JRouter  # noqa: E402
from repro.serve.disagg import TransferQueue as JTransferQueue  # noqa: E402
from repro.serve.engine import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve.engine import ServeRequest as JServeRequest  # noqa: E402
from repro.serve.engine import SpecConfig as JSpecConfig  # noqa: E402
from repro_torch.core import FunkyCL, Monitor, SliceAllocator  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve.disagg import (M_HANDOFF,  # noqa: E402
                                      M_HANDOFF_FALLBACK, M_TRANSFER_BYTES)
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      ServeRequest, SpecConfig)
from repro_torch.serve.equivalence import (  # noqa: E402
    assert_transcripts_equal, run_transcript)
from repro_torch.testing import params_from_jax  # noqa: E402
from test_torch_disagg import (PAGE, PROMPT_LEN, _counter,  # noqa: E402
                               make_requests, run_disagg)

NAME = "deepseek-v3-671b"
ARCH = NAME + "-f32-smoke"
COUNTERS = (M_HANDOFF, M_HANDOFF_FALLBACK, M_TRANSFER_BYTES)
TOKENS = [4, 6, 5, 3, 6, 4]


def _prompts():
    """Six prompts: p0 three times, p1 twice, and one sharing p0's first
    page only."""
    rng = np.random.Generator(np.random.Philox(21))
    p = [rng.integers(0, 100, PROMPT_LEN) for _ in range(3)]
    q = p[0].copy()
    q[PAGE:] = p[2][PAGE:]
    return [p[0], p[0], p[1], q, p[0], p[1]]


def _requests(cls):
    return [cls(rid=f"r{i}", prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(), TOKENS))]


def _jax_engine(engine_id, reg=None, **kw):
    mon = JMonitor(engine_id, JSliceAllocator("n0", 1), telemetry=reg)
    eng = JEngine(ARCH, JFunkyCL(mon), slots=2, prompt_len=PROMPT_LEN,
                  max_new_tokens=8, page_size=PAGE, registry=reg,
                  engine_id=engine_id, **kw)
    eng.setup()
    return mon, eng


def _weights(eng, bufs=("params",)):
    return {b: params_from_jax(jax.tree.map(np.asarray,
                                            eng.cl.read_buffer(b)))
            for b in bufs}


def _jax_run(**kw):
    """The JAX engine's transcript, its prefix and spec stats and its
    weights (the draft's too for a speculative engine)."""
    mon, eng = _jax_engine("mla-ref", **kw)
    w = _weights(eng, ("params", "draft_params") if kw.get("spec")
                 else ("params",))
    for r in _requests(JServeRequest):
        eng.submit(r)
    eng.run_until_drained()
    mon.vfpga_exit()
    return ({rid: list(c.tokens) for rid, c in eng.completed.items()},
            eng.prefix_stats(), eng.spec_stats(), w)


def _factory(weights, **kw):
    def make():
        reg = MetricsRegistry()
        mon = Monitor("mla-feat", SliceAllocator("n0", 1, device="cpu"),
                      telemetry=reg)
        eng = ContinuousBatchingEngine(
            ARCH, FunkyCL(mon), slots=2, prompt_len=PROMPT_LEN,
            max_new_tokens=8, registry=reg, page_size=PAGE, **kw)
        eng.setup()
        for buf, tree in weights.items():
            eng.cl.write_buffer(buf, tree).wait()
        return mon, eng
    return make


def _port_requests():
    return _requests(ServeRequest)


@pytest.fixture(scope="module")
def ref():
    """The f32 arch in both packages; the JAX prefix and self-draft
    engines' runs, and the JAX pair's on the disagg workload, on one set
    of weights (every JAX engine draws its weights from seed 0)."""
    mp = pytest.MonkeyPatch()
    for mod in (jcfg, tcfg):
        mp.setitem(mod.ARCHS, f"{NAME}-f32", dataclasses.replace(
            mod.ARCHS[NAME], name=f"{NAME}-f32", dtype="float32"))
    out = {"prefix": _jax_run(prefix_cache=True, pool_pages=10),
           "spec": _jax_run(spec=JSpecConfig(k=2))}

    def jmake(reg, engine_id, **kw):
        return _jax_engine(engine_id, reg, **kw)

    got, tq, reg, router, pops = run_disagg(
        TOKENS, 3, make=jmake, registry=JRegistry, router_cls=JRouter,
        queue_cls=JTransferQueue, request_cls=JServeRequest)
    snap = reg.snapshot()["counters"]
    out["pair"] = {"transcript": got, "pops": pops, "torn": tq.torn,
                   "counters": {n: snap[f"{n}{{service=svc}}"]
                                for n in COUNTERS}}
    yield out
    mp.undo()


def test_prefix_cache_over_latent_pages_equals_the_jax_engine(ref):
    want, want_stats, _, w = ref["prefix"]
    got, eng = run_transcript(_factory(w, prefix_cache=True, pool_pages=10),
                              _port_requests)
    assert_transcripts_equal(got, want, context="port vs JAX prefix engine")
    stats = eng.prefix_stats()
    assert stats == want_stats
    assert stats["hits"] >= 1 and stats["partial_hits"] >= 1
    assert stats["cached_tokens"] > 0


def test_self_draft_over_latent_pages_equals_the_jax_engine(ref):
    want, _, want_stats, w = ref["spec"]
    # greedy: the prefix engine's tokens (each the plain engine's)
    assert_transcripts_equal(want, ref["prefix"][0],
                             context="JAX self-draft vs prefix engine")
    got, eng = run_transcript(_factory(w, spec=SpecConfig(k=2)),
                              _port_requests)
    assert_transcripts_equal(got, want, context="port vs JAX spec engine")
    stats = eng.spec_stats()
    assert stats == want_stats
    assert stats["accept_rate"] == 1.0                  # a self-draft
    assert stats["tokens_per_lane_iteration"] > 1.0


def test_handoff_of_latent_pages_equals_the_jax_pair(ref):
    want = ref["pair"]
    w = ref["prefix"][3]["params"]
    mon, eng = _factory({"params": w})()
    for r in make_requests(TOKENS, seed=3):
        eng.submit(r)
    eng.run_until_drained()
    mon.vfpga_exit()
    assert want["transcript"] == {rid: list(c.tokens)
                                  for rid, c in eng.completed.items()}

    def make(reg, engine_id, slots=2, max_new=8, **kw):
        mon = Monitor(engine_id, SliceAllocator("n0", 1, device="cpu"),
                      telemetry=reg)
        eng = ContinuousBatchingEngine(
            ARCH, FunkyCL(mon), slots=slots, prompt_len=PROMPT_LEN,
            max_new_tokens=max_new, registry=reg, page_size=PAGE,
            engine_id=engine_id, **kw)
        eng.setup()
        eng.cl.write_buffer("params", w).wait()
        return mon, eng

    got, tq, reg, router, pops = run_disagg(TOKENS, 3, make=make)
    assert got == want["transcript"]
    counters = {n: _counter(reg, n) for n in COUNTERS}
    assert counters == want["counters"]
    assert counters[M_HANDOFF] > 0 and counters[M_TRANSFER_BYTES] > 0
    assert pops == want["pops"]
    assert router.duplicates == 0 and tq.torn == want["torn"] == 0
