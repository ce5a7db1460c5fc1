"""The reference's public names that the port carries with its semantics,
against the JAX package on the CPU.

* ``configs``: ``all_cells()`` gives the reference's 40 (arch, shape,
  verdict) cells, ``get_shape`` its shapes (``KeyError`` on an unknown
  one), ``ModelConfig.active_param_count`` its count for all ten archs;
* ``core``: ``VSlice.name``, ``SliceAllocator.owned_by`` and
  ``ProgramCache.get_program`` (with ``in``);
* ``serve``: ``ContinuousBatchingEngine.kv_stats()`` after every
  iteration of the same requests on yi-9b-smoke in f32 (the port's pool
  holds one sink page more: its ``pool_bytes`` is the reference's plus one
  ``page_bytes``, every other key equal); ``generate`` greedy at
  temperature 0 (today's tokens), and above it reproducible from a
  generator's seed; ``sample_token``'s draws from fixed logits against
  ``softmax(logits / T)`` (chi-square, 20 000 draws).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.core import FunkyCL as JFunkyCL  # noqa: E402
from repro.core import Monitor as JMonitor  # noqa: E402
from repro.core import SliceAllocator as JSliceAllocator  # noqa: E402
from repro.core.programs import Program as JProgram  # noqa: E402
from repro.core.programs import ProgramCache as JProgramCache  # noqa: E402
from repro.serve.engine import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve.engine import ServeRequest as JServeRequest  # noqa: E402
from repro_torch.core import (FunkyCL, Monitor, Program,  # noqa: E402
                              ProgramCache, SliceAllocator)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve import generate, sample_token  # noqa: E402
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      ServeRequest)
from repro_torch.testing import params_from_jax  # noqa: E402

ARCH_NAMES = sorted(jcfg.ARCHS)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def _cells(mod):
    return sorted((a.name, s.name, ok, why) for a, s, ok, why
                  in mod.all_cells())


def test_all_cells_match_the_reference():
    got, want = _cells(tcfg), _cells(jcfg)
    assert len(got) == 40
    assert got == want


@pytest.mark.parametrize("shape", sorted(jcfg.SHAPES))
def test_get_shape_matches_the_reference(shape):
    got, want = tcfg.get_shape(shape), jcfg.get_shape(shape)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.tokens == want.tokens


def test_get_shape_raises_on_an_unknown_shape():
    with pytest.raises(KeyError):
        jcfg.get_shape("train_999")
    with pytest.raises(KeyError, match="train_999"):
        tcfg.get_shape("train_999")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_active_param_count_matches_the_reference(arch):
    got = tcfg.get_arch(arch).active_param_count()
    assert got == jcfg.get_arch(arch).active_param_count()
    assert got <= tcfg.get_arch(arch).param_count()


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------

def test_vslice_name_and_owned_by_match_the_reference():
    ref = JSliceAllocator("n3", 3)
    port = SliceAllocator("n3", 3, device="cpu")
    names = [s.name for s in port.slices]
    assert names == [s.name for s in ref.slices] == \
        ["n3/vslice0", "n3/vslice1", "n3/vslice2"]
    for alloc in (ref, port):
        a = alloc.vfpga_init("t1")
        alloc.vfpga_init("t2")
        b = alloc.vfpga_init("t1")
        assert [s.name for s in alloc.owned_by("t1")] == [a.name, b.name]
        assert alloc.owned_by("nobody") == []
        alloc.vfpga_free(a)
        assert [s.name for s in alloc.owned_by("t1")] == [b.name]


def test_get_program_matches_the_reference():
    for cache, cls in ((JProgramCache(), JProgram),
                       (ProgramCache(), Program)):
        first = cls("p", lambda x: x)
        cache.register(first)
        assert "p" in cache and "q" not in cache
        assert cache.get_program("p") is first
        second = cls("p", lambda x: x + 1)
        cache.register(second)           # the latest registration wins
        assert cache.get_program("p") is second
        with pytest.raises(KeyError):
            cache.get_program("q")


# ---------------------------------------------------------------------------
# serve: kv_stats, generate, sample_token
# ---------------------------------------------------------------------------

ARCH = "yi-9b-f32-smoke"
PROMPT_LEN, PAGE, SLOTS, MAX_NEW = 8, 4, 2, 8


@pytest.fixture(scope="module")
def f32_arch():
    mp = pytest.MonkeyPatch()
    for mod in (jcfg, tcfg):
        base = mod.ARCHS["yi-9b"]
        mp.setitem(mod.ARCHS, "yi-9b-f32", dataclasses.replace(
            base, name="yi-9b-f32", dtype="float32"))
    yield ARCH
    mp.undo()


def _requests(cls):
    rng = np.random.Generator(np.random.Philox(5))
    return [cls(rid=f"r{i}", prompt=rng.integers(0, 100, n),
                max_new_tokens=m)
            for i, (n, m) in enumerate([(8, 6), (5, 8), (8, 3), (3, 7)])]


def test_kv_stats_match_the_reference_engine(f32_arch):
    """The two engines step in lockstep over the same requests on the same
    weights; after every iteration their ``kv_stats`` agree."""
    kw = dict(slots=SLOTS, prompt_len=PROMPT_LEN, page_size=PAGE,
              max_new_tokens=MAX_NEW)
    jmon = JMonitor("ref", JSliceAllocator("n0", 1))
    jeng = JEngine(f32_arch, JFunkyCL(jmon), **kw)
    jeng.setup()
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jeng.cl.read_buffer("params")))
    mon = Monitor("port", SliceAllocator("n0", 1, device="cpu"),
                  telemetry=MetricsRegistry())
    eng = ContinuousBatchingEngine(f32_arch, FunkyCL(mon), **kw)
    eng.setup()
    eng.cl.write_buffer("params", params).wait()
    try:
        for r in _requests(JServeRequest):
            jeng.submit(r)
        for r in _requests(ServeRequest):
            eng.submit(r)
        seen, steps = set(), 0
        while not (jeng.idle and eng.idle):
            jeng.step()
            eng.step()
            steps += 1
            got, want = eng.kv_stats(), jeng.kv_stats()
            assert got["pool_bytes"] == want["pool_bytes"] + \
                want["page_bytes"]
            assert {k: v for k, v in got.items() if k != "pool_bytes"} == \
                {k: v for k, v in want.items() if k != "pool_bytes"}
            seen.add(got["pages_used"])
            assert steps < 200
        assert max(seen) > 0 and got["pages_used"] == 0
        assert {rid: list(c.tokens) for rid, c in eng.completed.items()} \
            == {rid: list(c.tokens) for rid, c in jeng.completed.items()}
    finally:
        jmon.vfpga_exit()
        mon.vfpga_exit()


def _greedy_loop(bundle, params, batch, n):
    """Today's greedy loop: prefill, then argmax and decode ``n`` times."""
    logits, caches = bundle.prefill_fn(params, batch)
    pos = batch["tokens"].shape[1]
    toks = []
    for i in range(n):
        tok = logits.argmax(dim=-1).to(torch.int32)
        toks.append(tok)
        logits, caches = bundle.decode_fn(params, tok, pos + i, caches,
                                          inplace=True)
    return torch.stack(toks, dim=1)


@pytest.fixture(scope="module")
def smoke():
    bundle = build_model(tcfg.get_arch("yi-9b-smoke"))
    params = bundle.init(3, device="cpu")
    rng = np.random.Generator(np.random.Philox(11))
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, 512, (2, 8)).astype(np.int32))}
    return bundle, params, batch


def test_generate_at_temperature_zero_is_the_greedy_loop(smoke):
    bundle, params, batch = smoke
    with torch.no_grad():
        want = _greedy_loop(bundle, params, batch, 6)
    got = generate(bundle, params, batch, 6)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    g = torch.Generator().manual_seed(1)
    assert torch.equal(generate(bundle, params, batch, 6, temperature=0.0,
                                generator=g), want)


def test_generate_samples_reproducibly_from_its_generator(smoke):
    bundle, params, batch = smoke

    def run(seed):
        return generate(bundle, params, batch, 12, temperature=1.5,
                        generator=torch.Generator().manual_seed(seed))

    a, b, c = run(7), run(7), run(8)
    assert a.shape == (2, 12) and a.dtype == torch.int32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.equal(generate(bundle, params, batch, 12, temperature=1.5),
                       run(0))                  # None: seeded 0


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_sample_token_draws_from_the_tempered_softmax(temperature):
    from scipy.stats import chisquare

    logits = torch.tensor([1.2, -0.3, 0.0, 2.1, 0.7, -1.5, 0.4, 1.0])
    n = 20_000
    draws = sample_token(logits.expand(n, -1),
                         torch.Generator().manual_seed(123), temperature)
    assert draws.shape == (n,) and draws.dtype == torch.int32
    counts = np.bincount(draws.numpy(), minlength=logits.numel())
    p = torch.softmax(logits.double() / temperature, -1).numpy()
    assert chisquare(counts, p * n).pvalue > 1e-3
    greedy = sample_token(logits.expand(3, -1), None, 0.0)
    assert greedy.tolist() == [3, 3, 3]
