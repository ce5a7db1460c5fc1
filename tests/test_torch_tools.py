"""The ported tools (``tools/*_torch.py``) against the JAX package's on the
CPU:

* ``trace_dump_torch`` prints what ``tools/trace_dump.py`` prints, with
  the same return code (or the same exception), for the summary,
  ``--trace`` and ``--check`` over the same documents: a port tracer's
  export of a served run with a cross-trace link, one with the linked
  spans only (no EXECUTE span), and two malformed ones (an orphaned span,
  an event without ``ph``); on a malformed document both CLIs exit 1;
* ``smoke_all_torch``: its ``make_batch`` is the reference's, and
  ``run_arch`` on the reference's initial weights (``params_from_jax``)
  in f32 gives the reference's ``loss_fn`` within 1e-5 relative, for the
  ten reduced archs;
* ``cluster_smoke_torch`` reaches ``CLUSTER SMOKE OK``.
"""

import ast
import copy
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.core import FunkyCL, Monitor, SliceAllocator  # noqa: E402
from repro_torch.obs import Tracer, export_chrome_trace  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.scaling.serving import RequestRouter  # noqa: E402
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      ServeRequest)
from repro_torch.testing import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        f"_tool_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


trace_dump = _load("tools/trace_dump.py")
trace_dump_torch = _load("tools/trace_dump_torch.py")
smoke_all_torch = _load("tools/smoke_all_torch.py")
cluster_smoke_torch = _load("tools/cluster_smoke_torch.py")


# ---------------------------------------------------------------------------
# trace_dump_torch against tools/trace_dump.py
# ---------------------------------------------------------------------------

def _linked(tracer):
    """Two one-span traces, the second linked to the first (the
    orchestrator's migration pair)."""
    pre = tracer.event_span("orch.migrate_out", trace_id="mig-out",
                            cid="c1", node="node0")
    pre.finish()
    post = tracer.event_span("orch.migrate_in", trace_id="mig-in", cid="c1",
                             node="node1")
    post.link(pre, relation="migrates")
    post.finish()


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    """name -> (path, a trace id of it)."""
    tmp = tmp_path_factory.mktemp("traces")
    tracer = Tracer(capacity=4096)
    mon = Monitor("trace", SliceAllocator("n0", 1, device="cpu"),
                  telemetry=MetricsRegistry(), tracer=tracer)
    eng = ContinuousBatchingEngine("yi-9b-smoke", FunkyCL(mon), slots=2,
                                   prompt_len=8, page_size=4,
                                   max_new_tokens=4, engine_id="trace")
    eng.setup()
    router = RequestRouter("trace", registry=eng.registry, kv_aware=False,
                           tracer=tracer)
    rng = np.random.Generator(np.random.Philox(4))
    try:
        for i in range(3):
            router.submit(ServeRequest(rid=f"r{i}",
                                       prompt=rng.integers(0, 512, 8),
                                       max_new_tokens=3))
        while router.outstanding() or not eng.idle:
            eng.pump(router)
    finally:
        mon.vfpga_exit()
    _linked(tracer)
    served = json.loads(json.dumps(tracer.chrome_trace()))
    links = Tracer()
    _linked(links)
    orphan = copy.deepcopy(served)
    ev = next(e for e in orphan["traceEvents"] if e.get("ph") == "X"
              and e["args"]["parent_id"] != 0)
    ev["args"]["parent_id"] = 10 ** 6
    no_ph = copy.deepcopy(served)
    del next(e for e in no_ph["traceEvents"] if e.get("ph") == "X")["ph"]
    out = {}
    for name, doc, tid in (("served", served, "r1"),
                           ("links_only", None, "mig-in"),
                           ("orphan", orphan, "r0"),
                           ("no_ph", no_ph, "r2")):
        path = tmp / f"{name}.json"
        if doc is None:
            export_chrome_trace(links, str(path))
        else:
            path.write_text(json.dumps(doc))
        out[name] = (str(path), tid)
    return out


def _run(main, argv, capsys):
    try:
        rc = main(argv)
    except Exception as e:  # noqa: BLE001 - compared with the reference's
        rc = (type(e).__name__, str(e))
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("doc", ["served", "links_only", "orphan", "no_ph"])
@pytest.mark.parametrize("mode", ["summary", "trace", "missing_trace",
                                  "check"])
def test_trace_dump_torch_prints_what_the_reference_prints(docs, doc, mode,
                                                          capsys):
    path, tid = docs[doc]
    argv = {"summary": [path], "trace": [path, "--trace", tid],
            "missing_trace": [path, "--trace", "nope"],
            "check": [path, "--check"]}[mode]
    want = _run(trace_dump.main, argv, capsys)
    got = _run(trace_dump_torch.main, argv, capsys)
    assert got == want
    if mode in ("summary", "trace"):
        assert got[0] == 0 and got[1]
    if mode == "check":
        # the served run passes; the linked spans alone hold no EXECUTE;
        # the malformed documents raise in validation
        want_rc = {"served": 0, "links_only": 1}.get(doc)
        if want_rc is None:
            assert got[0][0] == "ValueError"
        else:
            assert got[0] == want_rc


def test_trace_dump_torch_links_of_reads_the_migration_link(docs):
    doc = trace_dump_torch.load(docs["served"][0])
    linked = [lk for evs in trace_dump_torch.spans_by_trace(doc).values()
              for ev in evs for lk in trace_dump_torch.links_of(ev)]
    assert [lk["relation"] for lk in linked] == ["migrates"]


def test_both_clis_exit_1_on_a_malformed_document(docs):
    path = docs["no_ph"][0]
    outs = [subprocess.run([sys.executable, str(ROOT / "tools" / tool),
                            path, "--check"], cwd=ROOT, capture_output=True,
                           text=True, timeout=120)
            for tool in ("trace_dump.py", "trace_dump_torch.py")]
    assert [o.returncode for o in outs] == [1, 1]
    assert outs[0].stdout == outs[1].stdout == ""
    assert all("ValueError: event missing 'ph'" in o.stderr for o in outs)


# ---------------------------------------------------------------------------
# smoke_all_torch against the reference's loss
# ---------------------------------------------------------------------------

def _reference_make_batch():
    """``make_batch`` of ``tools/smoke_all.py`` (a script that runs every
    arch when imported): its function definition alone, executed."""
    tree = ast.parse((ROOT / "tools" / "smoke_all.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "make_batch")
    ns = {"jnp": jnp}
    exec(compile(ast.Module([fn], []), "smoke_all.py", "exec"), ns)
    return ns["make_batch"]


def _f32(mod, name):
    return dataclasses.replace(mod.reduced(mod.ARCHS[name]), dtype="float32")


@pytest.mark.parametrize("name", sorted(jcfg.ARCHS))
def test_smoke_all_torch_loss_matches_the_reference(name):
    jc, tc = _f32(jcfg, name), _f32(tcfg, name)
    want_batch = _reference_make_batch()(jc)
    got_batch = smoke_all_torch.make_batch(tc)
    assert set(got_batch) == set(want_batch)
    for k, x in want_batch.items():
        y = got_batch[k]
        assert str(y.dtype).split(".")[-1] == str(x.dtype)
        assert np.array_equal(y.float().numpy(),
                              np.asarray(x, np.float32)), k
    b = jbuild_model(jc)
    params = b.init(jax.random.key(0))
    want, _ = b.loss_fn(params, want_batch)
    got = smoke_all_torch.run_arch(
        tc, params=params_from_jax(jax.tree.map(np.asarray, params)),
        device="cpu")
    assert abs(got["loss"] - float(want)) <= 1e-5 * abs(float(want))
    assert got["grad_loss"] == pytest.approx(got["loss"], rel=1e-6)
    assert got["launches"] == dict.fromkeys(
        ("K1", "K1p", "K2", "K3", "K4"), 0)     # the CPU launches nothing


def test_smoke_all_torch_main_counts_failures():
    out = smoke_all_torch.main(["yi-9b", "mamba2-1.3b"], device="cpu",
                               log=lambda *a: None)
    assert out["fails"] == 0
    assert all(np.isfinite(out[n]["loss"]) for n in ("yi-9b", "mamba2-1.3b"))


# ---------------------------------------------------------------------------
# cluster_smoke_torch
# ---------------------------------------------------------------------------

def test_cluster_smoke_torch_is_ok(tmp_path, capsys):
    out = cluster_smoke_torch.main(device="cpu", ckpt_root=str(tmp_path))
    assert out["ok"] and capsys.readouterr().out.rstrip().endswith(
        "CLUSTER SMOKE OK")
    assert set(out["deployments"].values()) == {"done"}
    assert out["migrated"] == {"status": "done", "step": 6}
    assert out["restored"]["status"] == "done"
    assert out["restored"]["step"] == cluster_smoke_torch.CKPT_IMAGE.total_steps
