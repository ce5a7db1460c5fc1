"""The ported examples (``examples_torch/``) through their ``main`` on
``device="cpu"``, at the reference's smoke images, under the gates the
card's ``examples`` phase holds them to:

* quickstart trains its image to DONE (cut to 20 of its 100 steps) with a
  final loss under the first step's, and its FunkyCL request counts
  (``n_EXECUTE``, ``n_TRANSFER``) equal the JAX runtime's for the same
  image cut to 3 steps;
* checkpoint_restore's job, checkpointed, its node failed and restored
  on the other node, ends with an uninterrupted run's ``final_params``,
  bit for bit;
* preemptive_cluster evicts a batch job, and every job ends DONE at its
  last step;
* elastic_serving's request list is the reference's ``open_loop`` trace
  for the same parameters; the service (cut to 3 s at 10 req/s) serves
  every request once, drains back to one replica and leaves no thread,
  and sampled requests' tokens equal one engine's alone.

Without ``device`` every script asks for the card, and raises on a host
without one.  Waits are on conditions, never on sleeps.
"""

import importlib.util
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        f"_port_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


quickstart = _load("examples_torch/quickstart.py")
checkpoint_restore = _load("examples_torch/checkpoint_restore.py")
preemptive_cluster = _load("examples_torch/preemptive_cluster.py")
elastic_serving = _load("examples_torch/elastic_serving.py")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")


@pytest.mark.parametrize("entry", [
    "quickstart.main", "checkpoint_restore.main", "preemptive_cluster.main",
    "elastic_serving.main", "checkpoint_restore.uninterrupted",
    "elastic_serving.replica_rate", "elastic_serving.engine_alone"])
def test_the_default_device_is_the_card(no_card, entry):
    mod, name = entry.split(".")
    fn = getattr(globals()[mod], name)
    args = ({"r0": [1, 2, 3]}, {"r0": 2}) if name == "engine_alone" else ()
    with pytest.raises(RuntimeError, match="cuda"):
        fn(*args)


def _assert_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_trains_to_done(tmp_path):
    kw = dict(device="cpu", ckpt_root=str(tmp_path), interval_s=0.2)
    first = quickstart.main(total_steps=1, **kw)
    out = quickstart.main(total_steps=20, **kw)
    assert out["status"] == "done" and out["step"] == 20
    assert out["final_loss"] < first["final_loss"]
    # init_state, then a step: grad_init, 4 microbatches, apply
    assert out["n_EXECUTE"] == 1 + 20 * (1 + 4 + 1)


def test_quickstart_counts_match_the_jax_runtime(tmp_path):
    import dataclasses

    from repro.core import TaskImage as JTaskImage
    from repro.core import TaskStatus as JTaskStatus
    from repro.core import make_cluster as jmake_cluster
    from repro.train import OptConfig as JOptConfig

    steps = 3
    port = quickstart.main(total_steps=steps, device="cpu",
                           ckpt_root=str(tmp_path / "port"), interval_s=0.2)
    im = quickstart.IMAGE
    jim = JTaskImage(
        name=im.name, kind=im.kind, arch=im.arch, seq_len=im.seq_len,
        global_batch=im.global_batch, total_steps=steps, chunks=im.chunks,
        opt=JOptConfig(**dataclasses.asdict(im.opt)))
    cl = jmake_cluster(num_nodes=1, slices_per_node=1,
                       images={jim.name: jim},
                       ckpt_root=str(tmp_path / "ref"))
    try:
        rt = cl.nodes["node0"].runtime
        rt.create("demo", jim)
        rt.start("demo")
        assert rt.wait("demo", timeout=300) is JTaskStatus.DONE
        m = rt.tasks["demo"].monitor.metrics
    finally:
        cl.stop()
    assert (port["n_EXECUTE"], port["n_TRANSFER"]) == \
        (int(m["n_EXECUTE"]), int(m["n_TRANSFER"]))


def test_quickstart_runs_from_another_directory(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / "quickstart.py"),
         "--device", "cpu", "--steps", "2"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "finished 2 steps" in out.stdout


# ---------------------------------------------------------------------------
# checkpoint_restore and preemptive_cluster
# ---------------------------------------------------------------------------

def test_checkpoint_restore_recovers_an_uninterrupted_run(tmp_path):
    kw = dict(device="cpu", ckpt_root=str(tmp_path))
    out = checkpoint_restore.main(**kw)
    assert out["status"] == "done"
    assert out["step"] == checkpoint_restore.IMAGE.total_steps
    assert out["recovered_node"] != out["failed_node"]
    assert 1 <= out["snapshot_step"] < out["step"]
    assert [r["cid"] for r in out["restored"]] == ["task-0001"]
    _assert_equal(out["final_params"],
                  checkpoint_restore.uninterrupted(**kw))


def test_preemptive_cluster_evicts_and_every_job_finishes(tmp_path):
    out = preemptive_cluster.main(device="cpu", ckpt_root=str(tmp_path))
    images = preemptive_cluster.IMAGES
    assert out["preemptions"] >= 1
    for cid, job in out["jobs"].items():
        assert job["status"] == "done"
        assert job["step"] == images[job["image"]].total_steps
    evicted = out["jobs"][out["evicted"][0]]
    assert evicted["image"] == "batch-job"
    kinds = [ev for ev, _, _ in out["events"]]
    # the prod job deploys after the eviction; the evicted job comes back
    assert kinds.index("evict") < max(
        i for i, (ev, cid, _) in enumerate(out["events"])
        if ev == "deploy")
    assert {"resume", "migrate"} & set(kinds)


# ---------------------------------------------------------------------------
# elastic_serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate,duration,seed", [
    (elastic_serving.REQUEST_RATE, elastic_serving.DURATION_S, 7),
    (10.0, 3.0, 7), (40.0, 9.0, 3)])
def test_elastic_request_list_is_the_reference_trace(rate, duration, seed):
    from repro.scaling.loadgen import burst_rate, open_loop

    got = elastic_serving.requests(rate, duration, seed)
    want = open_loop(burst_rate(0.6 * rate, 6.0, duration / 3, duration / 3),
                     duration, seed=seed, mean_service_s=1.0 / rate,
                     tokens_range=(3, 9))
    assert len(got) == len(want) > 0
    assert [(r.rid, r.arrival_t, r.service_s, r.n_tokens) for r in got] == \
        [(r.rid, r.arrival_t, r.service_s, r.n_tokens) for r in want]


def test_elastic_serving_serves_every_request_once(tmp_path):
    before = set(threading.enumerate())
    out = elastic_serving.main(device="cpu", request_rate=10.0,
                               duration_s=3.0, ckpt_root=str(tmp_path))
    assert out["served"] == out["completed"] == out["requests"] > 0
    assert out["duplicates"] == 0
    assert out["replicas_after_drain"] == 1 and not out["clones_left"]
    assert sum(r["completed"] for r in out["replicas"].values()) == \
        out["requests"]
    assert out["admissions"] >= out["requests"]
    assert out["decode_steps"] > 0
    for key in ("ttft_s", "tbt_s", "latency_s"):
        assert 0 < out[key]["p50"] <= out[key]["p99"]
    deadline = time.time() + 10
    while True:
        left = [t.name for t in threading.enumerate()
                if t not in before and t.is_alive()]
        if not left or time.time() > deadline:
            break
        time.sleep(0.01)
    assert not left, left
    rids = sorted(out["tokens"])[:4]
    alone = elastic_serving.engine_alone(
        {r: out["prompts"][r] for r in rids},
        {r: out["n_tokens"][r] for r in rids}, device="cpu")
    assert alone == {r: out["tokens"][r] for r in rids}


def test_replica_rate_measures_a_closed_loop():
    out = elastic_serving.replica_rate(seconds=2.0, device="cpu")
    assert out["requests"] > 0 and out["seconds"] >= 2.0
    assert out["requests_per_s"] == out["requests"] / out["seconds"]
