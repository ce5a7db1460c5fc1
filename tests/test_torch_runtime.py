"""The slice as a whole: FunkyRuntime -> FunkyCL -> Monitor serving
yi-9b-smoke through ServeTask on ``device="cpu"``.

The served ``last_token`` equals the port's own greedy ``generate`` on the
same weights (``init_params`` draws them from ``image.seed``), with and
without an evict/resume in the middle of the run.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.chaos import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.core import (FunkyRuntime, MonitorState,  # noqa: E402
                              SliceAllocator, TaskImage, TaskStatus)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.train import make_batch  # noqa: E402

IMAGE = TaskImage(name="svc", kind="serve", arch="yi-9b-smoke", prompt_len=8,
                  global_batch=2, total_steps=10, tokens_per_step=2, seed=0)
N_TOKENS = IMAGE.total_steps * IMAGE.tokens_per_step


def _runtime(delay_s=0.0):
    # a delay on every EXECUTE keeps the task alive long enough to be
    # evicted between steps; it changes no value
    plan = (FaultPlan([FaultSpec(site="monitor.execute", kind="delay",
                                 every=1, max_fires=10 ** 6,
                                 delay_s=delay_s)])
            if delay_s else None)
    return FunkyRuntime("n0", SliceAllocator("n0", 1, device="cpu"),
                        chaos=plan)


def _oracle(image=IMAGE):
    cfg = get_arch(image.arch)
    bundle = build_model(cfg)
    params = bundle.init(image.seed, device="cpu")
    prompt = make_batch(cfg, ShapeConfig("p", "train", image.prompt_len,
                                         image.global_batch), 0)["tokens"]
    toks = generate(bundle, params, {"tokens": torch.from_numpy(prompt)},
                    N_TOKENS + 1)
    return toks[:, N_TOKENS].tolist()


def _serve(rt, cid="t", evict_at=None):
    rt.create(cid, IMAGE)
    rt.start(cid)
    stats = None
    rec = rt.tasks[cid]
    if evict_at is not None:
        deadline = time.time() + 60
        while rec.guest_state.step < evict_at and time.time() < deadline:
            time.sleep(0.001)
        stats = rt.evict(cid)
        stats["at_step"] = rec.guest_state.step
        assert rec.status is TaskStatus.EVICTED
        assert rec.monitor.state is MonitorState.EVICTED
        rt.resume(cid)
    assert rt.wait(cid, timeout=120) is TaskStatus.DONE, rec.error
    return rec, stats


def test_runtime_serves_to_done_with_generate_tokens():
    rt = _runtime()
    rec, _ = _serve(rt)
    assert rec.guest_state.step == IMAGE.total_steps
    assert rec.guest_state.user["last_token"] == _oracle()
    ex = rec.monitor.metrics
    assert ex["n_EXECUTE"] == 2 + N_TOKENS          # init, prefill, decodes
    # decode's signature cache is warm after its first EXECUTE
    assert ex["exec_sig_cache_hits"] >= N_TOKENS - 1
    # the task released its slice and its device buffers
    assert rec.monitor.state is MonitorState.EXITED
    assert rt.allocator.free_count() == 1


def test_evict_resume_mid_serve_gives_the_same_tokens():
    rt = _runtime(delay_s=0.005)
    rec, stats = _serve(rt, evict_at=3)
    assert 0 < stats["at_step"] < IMAGE.total_steps
    # params and caches are DIRTY (written by EXECUTEs); the prompt is SYNC
    assert stats["n_dirty"] == 4                    # params, token, pos, caches
    assert stats["saved_bytes"] > 0 and stats["skipped_bytes"] > 0
    assert rec.guest_state.user["last_token"] == _oracle()


def test_two_evictions_and_resumes():
    rt = _runtime(delay_s=0.005)
    rt.create("t", IMAGE)
    rt.start("t")
    rec = rt.tasks["t"]
    for at in (2, 6):
        deadline = time.time() + 60
        while rec.guest_state.step < at and time.time() < deadline:
            time.sleep(0.001)
        rt.evict("t")
        assert rt.allocator.free_count() == 1
        rt.resume("t")
    assert rt.wait("t", timeout=120) is TaskStatus.DONE, rec.error
    assert rec.guest_state.user["last_token"] == _oracle()


def test_memory_cap_refuses_the_task():
    rt = FunkyRuntime("n0", SliceAllocator("n0", 1, mem_cap_bytes=1 << 16,
                                           device="cpu"))
    rt.create("t", IMAGE)
    rt.start("t")
    assert rt.wait("t", timeout=60) is TaskStatus.FAILED
    assert "memory cap" in repr(rt.tasks["t"].error)


def test_kill_releases_the_slice():
    rt = _runtime(delay_s=0.005)
    rt.create("t", IMAGE)
    rt.start("t")
    rec = rt.tasks["t"]
    deadline = time.time() + 60
    while rec.guest_state.step < 1 and time.time() < deadline:
        time.sleep(0.001)
    rt.kill("t")
    assert rec.status is TaskStatus.REMOVED
    assert rt.allocator.free_count() == 1
    rt.delete("t")
    assert "t" not in rt.tasks


def test_unported_task_kinds_raise():
    """Every kind of the reference is ported: ``train`` gives a
    ``TrainTask``, and a kind that no package knows raises ``ValueError``,
    as in the reference."""
    from repro_torch.core import TrainTask

    task = TaskImage(name="x", kind="train").instantiate()
    assert isinstance(task, TrainTask)
    assert task.program_ids() == ("init_state", "grad_init", "grad_step",
                                  "apply")
    with pytest.raises(ValueError):
        TaskImage(name="x", kind="no-such-kind").instantiate()


def test_engine_serve_instantiates_an_engine_task():
    from repro_torch.core import EngineServeTask

    task = TaskImage(name="x", kind="engine-serve").instantiate()
    assert isinstance(task, EngineServeTask) and task.drained


def test_served_prompt_is_the_reference_prompt():
    """ServeTask's prompt comes from make_batch, whose Philox rule gives
    the reference's tokens (tests/test_torch_model.py checks equality)."""
    cfg = get_arch(IMAGE.arch)
    p = make_batch(cfg, ShapeConfig("p", "train", 8, 2), 0)["tokens"]
    assert p.shape == (2, 8) and p.dtype == np.int32
    assert ((0 <= p) & (p < cfg.vocab_size)).all()
