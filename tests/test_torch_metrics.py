"""The port's telemetry registry (``repro_torch.scaling.metrics``): every
case of ``tests/test_metrics.py``.  The port's ``snapshot`` also carries
the event ring (``events``), which its engine and CRI tests read.

Telemetry registry: quantiles, windowing, ring-buffer eviction, and
simulated-clock injection (live plane and simulator must emit one schema)."""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.scaling.metrics import (Counter, Gauge,  # noqa: E402
                                         Histogram, MetricsRegistry,
                                         TimeSeries, metric_key)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_metric_key_label_ordering():
    assert metric_key("m", {}) == "m"
    assert (metric_key("m", {"b": "2", "a": "1"})
            == metric_key("m", {"a": "1", "b": "2"})
            == "m{a=1,b=2}")


def test_counter_monotonic():
    c = Counter()
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)


def test_gauge_set_add():
    g = Gauge()
    g.set(4)
    g.add(-1.5)
    assert g.value == 2.5


def test_labeled_gauge_values_selects_by_label():
    """(label_dict, value) pairs let a KV-aware router pick the engine
    with the most free pages without parsing flattened keys."""
    from repro_torch.scaling.metrics import MetricsRegistry

    reg = MetricsRegistry()
    reg.gauge("kv_free_pages", service="svc", engine="e0").set(10.0)
    reg.gauge("kv_free_pages", service="svc", engine="e1").set(3.0)
    reg.gauge("kv_free_pages", service="other", engine="e2").set(99.0)
    reg.gauge("kv_free_pages", service="svc").set(10.0)   # service rollup
    got = reg.labeled_gauge_values("kv_free_pages", service="svc")
    per_engine = {lbl["engine"]: v for lbl, v in got if "engine" in lbl}
    assert per_engine == {"e0": 10.0, "e1": 3.0}
    assert max(per_engine, key=per_engine.get) == "e0"


def test_histogram_quantiles():
    clock = FakeClock()
    h = Histogram(clock, window_s=60.0)
    for v in range(1, 101):          # 1..100
        h.observe(float(v))
    assert h.count == 100
    assert abs(h.quantile(0.50) - 50.5) < 1e-9
    assert abs(h.quantile(0.95) - 95.05) < 1e-9
    assert abs(h.quantile(0.99) - 99.01) < 1e-9
    s = h.summary()
    assert s["max"] == 100.0 and s["window_count"] == 100


def test_histogram_window_eviction_keeps_cumulative():
    clock = FakeClock()
    h = Histogram(clock, window_s=10.0)
    h.observe(1000.0)                # at t=0
    clock.t = 5.0
    h.observe(1.0)
    clock.t = 11.0                   # first sample now out of window
    h.observe(2.0)
    assert sorted(h.window_values()) == [1.0, 2.0]
    assert h.count == 3              # cumulative survives eviction
    assert h.sum == 1003.0
    clock.t = 100.0
    assert h.window_values() == []
    assert math.isnan(h.quantile(0.5))


def test_histogram_bounded_memory():
    clock = FakeClock()
    h = Histogram(clock, window_s=float("inf"), max_samples=16)
    for v in range(100):
        h.observe(float(v))
    assert len(h.window_values()) == 16          # ring kept newest
    assert min(h.window_values()) == 84.0
    assert h.count == 100


def test_timeseries_ring_eviction():
    clock = FakeClock()
    ts = TimeSeries(clock, capacity=4)
    for i in range(10):
        clock.t = float(i)
        ts.record(i * 10.0)
    assert len(ts) == 4
    assert ts.points() == [(6.0, 60.0), (7.0, 70.0), (8.0, 80.0),
                           (9.0, 90.0)]
    assert ts.window(7.0, 8.5) == [(7.0, 70.0), (8.0, 80.0)]


def test_timeseries_time_weighted_mean():
    clock = FakeClock()
    ts = TimeSeries(clock, capacity=16)
    ts.record(2.0, t=0.0)
    ts.record(4.0, t=10.0)           # 2 held for 10s
    ts.record(4.0, t=20.0)           # 4 held for 10s
    assert abs(ts.time_weighted_mean() - 3.0) < 1e-9


def test_histogram_window_override_is_order_independent():
    """A reader that merely gets the histogram first (signals path) must
    not pin the window; the writer's explicit window_s always wins."""
    clock = FakeClock()
    reg = MetricsRegistry(clock=clock)
    reader = reg.histogram("request_latency_seconds", service="svc")
    assert reader.window_s == 60.0                 # default on create
    writer = reg.histogram("request_latency_seconds", window_s=10.0,
                           service="svc")
    assert writer is reader and reader.window_s == 10.0
    writer.observe(1.0)
    clock.t = 11.0
    assert writer.window_values() == []            # 10s window in force


def test_registry_get_or_create_identity():
    reg = MetricsRegistry()
    a = reg.counter("x_total", service="a")
    b = reg.counter("x_total", service="a")
    c = reg.counter("x_total", service="b")
    assert a is b and a is not c


def test_simulated_clock_injection():
    """Samples must carry the injected (virtual) clock, not wall time."""
    sim = {"now": 0.0}
    reg = MetricsRegistry(clock=lambda: sim["now"])
    h = reg.histogram("request_latency_seconds", window_s=5.0, service="svc")
    ts = reg.series("replicas_ts", service="svc")
    sim["now"] = 100.0
    h.observe(0.3)
    ts.record(2)
    sim["now"] = 104.0
    assert h.window_values() == [0.3]
    sim["now"] = 106.0               # window measured in virtual time
    assert h.window_values() == []
    assert ts.points() == [(100.0, 2.0)]
    snap = reg.snapshot()
    assert snap["ts"] == 106.0


def test_to_prometheus_text():
    reg = MetricsRegistry(clock=FakeClock(1.0))
    reg.counter("requests_total", service="svc").inc(3)
    reg.gauge("queue_depth", service="svc").set(2)
    reg.gauge("running_tasks").set(1)
    h = reg.histogram("request_latency_seconds", service="svc")
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    text = reg.to_prometheus_text()
    lines = text.splitlines()
    assert "# TYPE requests_total counter" in lines
    assert 'requests_total{service="svc"} 3' in lines
    assert "# TYPE queue_depth gauge" in lines
    assert 'queue_depth{service="svc"} 2' in lines
    assert "running_tasks 1" in lines                  # label-free metric
    assert "# TYPE request_latency_seconds summary" in lines
    assert ('request_latency_seconds{service="svc",quantile="0.5"} 0.2'
            in lines)
    assert 'request_latency_seconds_count{service="svc"} 3' in lines
    assert 'request_latency_seconds_sum{service="svc"} 0.6' in lines
    assert text.endswith("\n")


def test_prometheus_families_are_contiguous_and_escaped():
    reg = MetricsRegistry()
    # interleave creation order across two families
    reg.gauge("queue_depth", service="svc").set(1)
    reg.gauge("utilization", service="svc").set(0.5)
    reg.gauge("queue_depth", service="svc", engine="e0").set(2)
    reg.counter("requests_total", service='we"ird\nsvc').inc()
    lines = reg.to_prometheus_text().splitlines()
    qd = [i for i, l in enumerate(lines) if l.startswith("queue_depth")]
    assert qd == list(range(qd[0], qd[0] + len(qd)))   # one contiguous block
    assert 'requests_total{service="we\\"ird\\nsvc"} 1' in lines


def test_prometheus_empty_histogram_is_nan_not_crash():
    reg = MetricsRegistry()
    reg.histogram("request_latency_seconds", service="svc")
    text = reg.to_prometheus_text()
    assert 'quantile="0.99"} NaN' in text


def test_flight_record_ring_and_order():
    clock = FakeClock()
    reg = MetricsRegistry(clock=clock, flight_capacity=4)
    for i in range(6):
        clock.t = float(i)
        reg.record_event("evict", task=f"t{i}")
    dump = reg.flight_record()
    assert len(dump["events"]) == 4                    # ring bound
    assert [e[2]["task"] for e in dump["events"]] == ["t2", "t3", "t4", "t5"]
    assert [e[0] for e in dump["events"]] == [2.0, 3.0, 4.0, 5.0]
    assert dump["ts"] == 5.0


def test_flight_record_series_tail():
    clock = FakeClock()
    reg = MetricsRegistry(clock=clock)
    ts = reg.series("replicas_ts", service="svc")
    for i in range(100):
        clock.t = float(i)
        ts.record(i)
    dump = reg.flight_record(series_tail=8)
    tail = dump["series_tail"]["replicas_ts{service=svc}"]
    assert len(tail) == 8 and tail[-1] == (99.0, 99.0)


def test_snapshot_schema():
    reg = MetricsRegistry(clock=FakeClock(7.0))
    reg.counter("requests_total", service="svc").inc()
    reg.gauge("queue_depth", service="svc").set(3)
    reg.histogram("request_latency_seconds", service="svc").observe(0.1)
    reg.series("replicas_ts", service="svc").record(1)
    snap = reg.snapshot()
    assert set(snap) == {"ts", "counters", "gauges", "histograms", "series"}
    assert snap["counters"]["requests_total{service=svc}"] == 1.0
    assert snap["gauges"]["queue_depth{service=svc}"] == 3.0
    hist = snap["histograms"]["request_latency_seconds{service=svc}"]
    assert {"count", "p50", "p95", "p99", "mean", "max"} <= set(hist)
    assert snap["series"]["replicas_ts{service=svc}"] == [(7.0, 1.0)]

def test_prometheus_drops_nonfinite_gauge_tombstones():
    """NaN/inf gauges are in-process tombstones (evacuate() poisons
    spec_accept_rate); a literal ``nan`` sample breaks strict scrapers, so
    the exporter must drop the series — header and all."""
    reg = MetricsRegistry()
    reg.gauge("spec_accept_rate", service="svc").set(math.nan)
    reg.gauge("kv_occupancy", service="svc").set(math.inf)
    reg.gauge("queue_depth", service="svc").set(2.0)
    text = reg.to_prometheus_text()
    assert 'queue_depth{service="svc"} 2' in text
    assert "spec_accept_rate" not in text
    assert "kv_occupancy" not in text
    # the tombstone stays visible in-process (that's its job)
    snap = reg.snapshot()
    assert math.isnan(snap["gauges"]["spec_accept_rate{service=svc}"])
    # histogram quantiles legitimately report NaN ("no data in window")
    reg.histogram("request_latency_seconds", service="svc")
    assert 'quantile="0.99"} NaN' in reg.to_prometheus_text()


def test_quantile_clamps_out_of_range_q():
    clock = FakeClock()
    h = Histogram(clock, window_s=60.0)
    h.observe(1.0)
    h.observe(3.0)
    assert h.quantile(2.0) == 3.0        # q > 1 clamps to max, no IndexError
    assert h.quantile(-1.0) == 1.0       # q < 0 clamps to min
    assert h.quantile(1.0) == 3.0


def test_empty_pruned_window_sentinel_is_nan():
    """The documented contract: a fully-pruned window yields NaN quantiles
    (not 0, not a crash) while the cumulative count/sum survive."""
    clock = FakeClock()
    h = Histogram(clock, window_s=5.0)
    h.observe(2.0)
    clock.t = 100.0                      # sample aged out of the window
    assert h.window_values() == []
    for q in (0.0, 0.5, 0.99, 1.0):
        assert math.isnan(h.quantile(q))
    s = h.summary()
    assert s["count"] == 1 and s["window_count"] == 0
    assert math.isnan(s["p50"]) and math.isnan(s["p99"])


def test_event_seq_monotonic_and_capped_under_concurrent_writers():
    import threading

    reg = MetricsRegistry(flight_capacity=64)
    n_threads, per = 8, 100

    def spam(k):
        for i in range(per):
            reg.record_event("spam", thread=k, i=i)

    threads = [threading.Thread(target=spam, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    evs = reg.flight_record()["events"]
    assert len(evs) == 64                          # ring cap held
    seqs = [e[3] for e in evs]
    assert seqs == sorted(seqs)                    # total order recoverable
    assert len(set(seqs)) == len(seqs)             # no duplicate seq
    assert seqs[-1] == n_threads * per - 1         # every write numbered


def test_flight_record_to_file_round_trip(tmp_path):
    import json

    clock = FakeClock()
    reg = MetricsRegistry(clock=clock)
    reg.record_event("engine_admit", rid="r0", slot=1)
    clock.t = 2.0
    reg.record_event("engine_retire", rid="r0")
    reg.series("replicas_ts", service="svc").record(1.0)
    path = str(tmp_path / "flight.json")
    assert reg.flight_record_to_file(path, engine="eng0",
                                     error="boom") == path
    doc = json.loads((tmp_path / "flight.json").read_text())
    assert doc["context"] == {"engine": "eng0", "error": "boom"}
    kinds = [e["kind"] for e in doc["events"]]
    assert kinds == ["engine_admit", "engine_retire"]
    assert [e["seq"] for e in doc["events"]] == [0, 1]
    assert doc["events"][0]["fields"] == {"rid": "r0", "slot": 1}
    assert doc["series_tail"]["replicas_ts{service=svc}"] == [[2.0, 1.0]]
