"""Device layer of the PyTorch port: Monitor, FunkyCL, BufferTable.

The cases of tests/test_monitor.py and tests/test_buffer_state.py that the
ServeTask path exercises, on ``device="cpu"``: MEMORY cap refusal,
TRANSFER round trips with no aliasing after an in-place EXECUTE, the
execute-signature cache, DIRTY-only evict/resume, checkpoint, and the
EXECUTE retry path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.chaos import FaultPlan, FaultSpec, InjectedFault  # noqa: E402
from repro_torch.core import (BufferState, BufferTable,  # noqa: E402
                              DeviceMemoryExceeded, FunkyCL, FunkyRequest,
                              GuestState, Monitor, MonitorError,
                              MonitorState, NoSliceAvailable, Program,
                              RequestKind, SliceAllocator)

CPU = "cpu"


def _spec(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _double_inplace(x):
    return x.mul_(2.0)


def _monitor(mem_cap=1 << 20, chaos=None, retry=None):
    alloc = SliceAllocator("n0", 1, mem_cap_bytes=mem_cap, device=CPU)
    m = Monitor("task0", alloc, chaos=chaos, retry=retry)
    m.vfpga_init(Program("double", lambda x: x * 2.0), (_spec(8),))
    return m


def _read(cl, buff):
    return np.asarray(cl.read_buffer(buff))


def test_execute_and_buffer_states():
    m = _monitor()
    cl = FunkyCL(m)
    cl.clCreateBuffer("x", _spec(8))
    cl.write_buffer("x", np.arange(8, dtype=np.float32))
    cl.clEnqueueKernel("double", ("x",), ("x",))
    cl.clFinish()
    assert m.buffers.get("x").state is BufferState.DIRTY
    np.testing.assert_array_equal(_read(cl, "x"),
                                  np.arange(8, dtype=np.float32) * 2)
    assert m.buffers.get("x").state is BufferState.SYNC
    m.vfpga_exit()
    assert m.state is MonitorState.EXITED


def test_memory_cap_enforced():
    m = _monitor(mem_cap=100)
    cl = FunkyCL(m)
    with pytest.raises(DeviceMemoryExceeded):
        cl.clCreateBuffer("big", _spec(1000))
        cl.clFinish()
    cl2 = FunkyCL(m)
    cl2.clCreateBuffer("small", _spec(4, dtype=torch.bfloat16))   # 8 bytes
    cl2.clFinish()
    assert "small" in m.buffers and "big" not in m.buffers


def test_foreign_buffer_and_unknown_program_rejected():
    m = _monitor()
    cl = FunkyCL(m)
    with pytest.raises(MonitorError):
        cl.clEnqueueKernel("double", ("nope",), ("nope",))
        cl.clFinish()
    cl = FunkyCL(m)
    cl.clCreateBuffer("x", _spec(8))
    cl.write_buffer("x", np.zeros(8, np.float32))
    with pytest.raises(MonitorError):
        cl.clEnqueueKernel("evil", ("x",), ("x",))
        cl.clFinish()


def test_transfers_never_alias_after_an_inplace_execute():
    """h2d copies in and d2h copies out: an in-place EXECUTE writes neither
    the guest's array nor a value read back earlier (on a CPU device
    ``torch.from_numpy`` / ``.numpy()`` would share the memory)."""
    alloc = SliceAllocator("n0", 1, device=CPU)
    m = Monitor("t", alloc)
    m.vfpga_init(Program("double", _double_inplace, inplace_argnums=(0,)),
                 (_spec(8),), donate_argnums=(0,))
    cl = FunkyCL(m)
    cl.clCreateBuffer("x", _spec(8))
    host = np.ones(8, np.float32)
    cl.write_buffer("x", host)
    first = cl.read_buffer("x")
    cl.clEnqueueKernel("double", ("x",), ("x",), donate=True)
    cl.clFinish()
    np.testing.assert_array_equal(host, np.ones(8, np.float32))
    np.testing.assert_array_equal(np.asarray(first), np.ones(8))
    np.testing.assert_array_equal(_read(cl, "x"), np.full(8, 2.0))


def test_evict_resume_preserves_values_and_frees_slot():
    alloc = SliceAllocator("n0", 1, device=CPU)
    m = Monitor("t", alloc)
    m.vfpga_init(Program("double", lambda x: x * 2.0), (_spec(8),))
    cl = FunkyCL(m)
    cl.clCreateBuffer("x", _spec(8))
    cl.write_buffer("x", np.ones(8, np.float32))
    cl.clEnqueueKernel("double", ("x",), ("x",))
    cl.clFinish()
    assert alloc.free_count() == 0
    stats = m.evict()
    assert alloc.free_count() == 1            # slot released
    assert stats["n_dirty"] == 1
    assert m.state is MonitorState.EVICTED
    m.resume()
    np.testing.assert_array_equal(_read(FunkyCL(m), "x"), np.full(8, 2.0))


def test_evict_skips_clean_buffers():
    m = _monitor()
    cl = FunkyCL(m)
    cl.clCreateBuffer("input", _spec(8))
    cl.write_buffer("input", np.ones(8, np.float32))   # SYNC after h2d
    cl.clFinish()
    stats = m.evict()
    assert stats["saved_bytes"] == 0
    assert stats["skipped_bytes"] == 32


def test_donated_inplace_roundtrip_survives_evict_resume():
    """The resumed device copy is fresh: further in-place EXECUTEs do not
    write the saved host copy."""
    alloc = SliceAllocator("n0", 1, device=CPU)
    m = Monitor("t", alloc)
    m.vfpga_init(Program("double", _double_inplace, inplace_argnums=(0,)),
                 (_spec(8),), donate_argnums=(0,))
    cl = FunkyCL(m)
    cl.clCreateBuffer("x", _spec(8))
    cl.write_buffer("x", np.ones(8, np.float32))
    for _ in range(3):
        cl.clEnqueueKernel("double", ("x",), ("x",), donate=True)
    cl.clFinish()
    keys = [(pid, d) for (pid, _, d) in m.programs._compiled.keys()]
    assert keys.count(("double", (0,))) == 1 and ("double", ()) not in keys
    m.evict()
    saved = m.buffers.get("x").host_value
    m.resume()
    cl2 = FunkyCL(m)
    cl2.clEnqueueKernel("double", ("x",), ("x",), donate=True)
    cl2.clFinish()
    np.testing.assert_array_equal(np.asarray(saved), np.full(8, 8.0))
    np.testing.assert_array_equal(_read(cl2, "x"), np.full(8, 16.0))


def test_inplace_program_must_be_donated():
    m = _monitor()
    m.register_program(Program("dbl_", _double_inplace, inplace_argnums=(0,)),
                       (_spec(8),), donate_argnums=(0,))
    cl = FunkyCL(m)
    cl.clCreateBuffer("x", _spec(8))
    cl.write_buffer("x", np.ones(8, np.float32))
    with pytest.raises(ValueError):
        cl.clEnqueueKernel("dbl_", ("x",), ("x",))       # not donated
        cl.clFinish()
    np.testing.assert_array_equal(_read(FunkyCL(m), "x"), np.ones(8))


def test_checkpoint_keep_running():
    m = _monitor()
    cl = FunkyCL(m)
    cl.clCreateBuffer("x", _spec(8))
    cl.write_buffer("x", np.ones(8, np.float32))
    cl.clEnqueueKernel("double", ("x",), ("x",))
    cl.clFinish()
    snap = m.checkpoint(GuestState(step=3), keep_running=True)
    assert m.state is MonitorState.RUNNING and snap.step == 3
    np.testing.assert_array_equal(np.asarray(snap.buffers["x"]),
                                  np.full(8, 2.0))
    cl.clEnqueueKernel("double", ("x",), ("x",))
    cl.clFinish()
    np.testing.assert_array_equal(_read(cl, "x"), np.full(8, 4.0))
    np.testing.assert_array_equal(np.asarray(snap.buffers["x"]),
                                  np.full(8, 2.0))


def test_no_slice_available():
    alloc = SliceAllocator("n0", 1, device=CPU)
    Monitor("a", alloc).vfpga_init(Program("id", lambda x: x), (_spec(2),))
    with pytest.raises(NoSliceAvailable):
        Monitor("b", alloc).vfpga_init(Program("id2", lambda x: x),
                                       (_spec(2),))


def test_worker_that_cannot_select_its_card_fails_requests(monkeypatch):
    """A worker whose card cannot be selected answers each request with
    that error; the guest must not wait forever."""
    def refuse(device):
        raise RuntimeError(f"cannot select {device}")

    monkeypatch.setattr(torch.cuda, "set_device", refuse)
    alloc = SliceAllocator("n0", 1, device=CPU)
    alloc.slices[0].device = torch.device("cuda", 0)
    m = Monitor("task0", alloc)
    m.vfpga_init(Program("double", lambda x: x * 2.0), (_spec(8),))
    cl = FunkyCL(m)
    with pytest.raises(RuntimeError, match="cannot select cuda:0"):
        cl.clCreateBuffer("x", _spec(8))
        cl.clFinish()
    assert "x" not in m.buffers


def test_sync_drains_only_buffers_written_since_last_sync():
    m = _monitor()
    cl = FunkyCL(m)
    cl.clCreateBuffer("a", _spec(8))
    cl.clCreateBuffer("b", _spec(8))
    cl.write_buffer("a", np.ones(8, np.float32))
    cl.write_buffer("b", np.ones(8, np.float32))
    cl.clFinish()
    assert m.buffers.unsynced_count() == 0
    cl.clEnqueueKernel("double", ("a",), ("a",))
    req = FunkyRequest(kind=RequestKind.SYNC)
    m.submit(req)
    req.completion.wait()
    assert req.completion.phases["synced_buffers"] == 1
    assert m.buffers.unsynced_count() == 0


def test_exec_signature_cache_hit_and_invalidation():
    m = _monitor()
    cl = FunkyCL(m)
    cl.clCreateBuffer("x", _spec(8))
    cl.write_buffer("x", np.ones(8, np.float32))
    c1 = cl.clEnqueueKernel("double", ("x",), ("x",))
    c2 = cl.clEnqueueKernel("double", ("x",), ("x",))
    cl.clFinish()
    assert c1.phases["sig_hit"] is False and c2.phases["sig_hit"] is True
    assert m.metrics["exec_sig_cache_hits"] == 1
    misses0 = m.programs.stats["misses"]
    cl.write_buffer("x", np.ones(4, np.float32))    # reshape
    c3 = cl.clEnqueueKernel("double", ("x",), ("x",))
    cl.clFinish()
    assert c3.phases["sig_hit"] is False
    assert m.programs.stats["misses"] == misses0 + 1
    np.testing.assert_array_equal(_read(cl, "x"), np.full(4, 2.0))


def test_same_shape_h2d_keeps_signature_cache_warm():
    m = _monitor()
    cl = FunkyCL(m)
    cl.clCreateBuffer("x", _spec(8))
    for i in range(3):
        cl.write_buffer("x", np.full(8, float(i), np.float32))
        cl.clEnqueueKernel("double", ("x",), ("x",))
    cl.clFinish()
    assert m.metrics["exec_sig_cache_hits"] >= 2


def test_shape_changing_program_never_replays_stale_entry():
    m = _monitor()
    m.register_program(Program("grow", lambda x: torch.cat([x, x])),
                       (_spec(8),))
    cl = FunkyCL(m)
    cl.clCreateBuffer("x", _spec(8))
    cl.write_buffer("x", np.ones(8, np.float32))
    for _ in range(3):
        cl.clEnqueueKernel("grow", ("x",), ("x",))
    cl.clFinish()
    assert _read(cl, "x").shape == (64,)


def test_execute_retries_transient_faults():
    plan = FaultPlan([FaultSpec(site="monitor.execute", kind="error", at=1)])
    m = _monitor(chaos=plan)
    cl = FunkyCL(m)
    cl.clCreateBuffer("x", _spec(8))
    cl.write_buffer("x", np.ones(8, np.float32))
    cl.clEnqueueKernel("double", ("x",), ("x",))
    cl.clFinish()
    np.testing.assert_array_equal(_read(cl, "x"), np.full(8, 2.0))
    assert m.telemetry.counter("monitor_execute_retries_total").value == 1
    assert plan.fired == [("monitor.execute", "error", "task0:double")]


def test_execute_fails_after_the_retry_budget():
    from repro_torch.chaos import RetryPolicy

    plan = FaultPlan([FaultSpec(site="monitor.execute", kind="error",
                                every=1, max_fires=10)])
    m = _monitor(chaos=plan, retry=RetryPolicy(max_attempts=2,
                                               base_backoff_s=0.0))
    cl = FunkyCL(m)
    cl.clCreateBuffer("x", _spec(8))
    cl.write_buffer("x", np.ones(8, np.float32))
    with pytest.raises(InjectedFault):
        cl.clEnqueueKernel("double", ("x",), ("x",))
        cl.clFinish()
    assert m.telemetry.counter("monitor_execute_failed_total").value == 1
    np.testing.assert_array_equal(_read(FunkyCL(m), "x"), np.ones(8))


def test_telemetry_counts_requests():
    m = _monitor()
    cl = FunkyCL(m)
    cl.clCreateBuffer("x", _spec(8))
    cl.write_buffer("x", np.ones(8, np.float32))
    cl.clEnqueueKernel("double", ("x",), ("x",))
    cl.clFinish()
    snap = m.telemetry.snapshot()["counters"]
    assert snap["monitor_requests_total{kind=EXECUTE}"] == 1
    assert snap["monitor_transfer_bytes_total{direction=h2d}"] == 32


# ---------------------------------------------------------------------------
# BufferTable
# ---------------------------------------------------------------------------

def test_buffer_table_evicts_dirty_bytes_only_and_restores_copies():
    t = BufferTable()
    t.register("a", _spec(4, 4))
    t.register("b", _spec(4, 4))
    val = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    t.on_h2d("a", val.numpy(), val.clone())
    t.on_h2d("b", val.numpy(), val.clone())
    t.on_execute_write("a", val * 2)
    stats = t.evict_device_state()
    assert stats == {"saved_bytes": 64, "skipped_bytes": 64, "n_dirty": 1,
                     "paged_saved_pages": 0, "paged_total_pages": 0}
    assert all(t.get(i).device_value is None for i in ("a", "b"))
    t.restore_device_state(torch.device("cpu"))
    dev = t.get("a").device_value
    dev.add_(1.0)                                  # in place on the device
    torch.testing.assert_close(t.get("a").host_value, val * 2)


def test_buffer_snapshot_roundtrip():
    t = BufferTable()
    t.register("params", _spec(4, 4))
    val = np.arange(16, dtype=np.float32).reshape(4, 4)
    t.on_h2d("params", val, torch.from_numpy(val.copy()))
    t.on_execute_write("params", torch.from_numpy(val * 2))
    t.evict_device_state()
    t2 = BufferTable()
    t2.load_snapshot(t.host_snapshot())
    t2.restore_device_state(torch.device("cpu"))
    np.testing.assert_array_equal(t2.get("params").device_value.numpy(),
                                  val * 2)
    assert t.versions() == {"params": 2}
