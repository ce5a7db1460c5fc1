"""Dependency-free telemetry registry the monitor publishes to.

A copy of the part of the reference package's registry that the monitor,
the chaos hooks, the serving engine and the request router use: counters,
gauges (with a per-label lookup for KV-aware routing), windowed
histograms, a bounded event ring, and one snapshot of them all. The
clock is injectable, so a replayed trace can stamp samples with virtual
time.

Types:

* ``Counter``      monotonically increasing float (requests_total, ...)
* ``Gauge``        last-write-wins float (queue_depth, replicas, ...)
* ``Histogram``    windowed samples with p50/p95/p99 (request latency)

All metrics are identified by ``name`` plus sorted key=value labels, printed
Prometheus-style: ``request_latency_seconds{service=svc}``.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

Clock = Callable[[], float]


def metric_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class Gauge:
    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float):
        self.value = float(value)

    def add(self, delta: float):
        with self._lock:
            self.value += delta


class Histogram:
    """Sliding-window sample reservoir with exact quantiles.

    Samples older than ``window_s`` (by the registry clock) are evicted
    lazily on observe/quantile; a bounded ring keeps worst-case memory flat
    under sustained load. Cumulative count/sum survive eviction so rates can
    still be derived from snapshots.
    """

    def __init__(self, clock: Clock, window_s: float = 60.0,
                 max_samples: int = 4096):
        self._clock = clock
        self.window_s = window_s
        self._samples: deque = deque(maxlen=max_samples)   # (t, value)
        self.count = 0            # cumulative, never evicted
        self.sum = 0.0
        # writers (monitor workers) race readers (snapshots) on the
        # deque; guard every touch
        self._lock = threading.Lock()

    def observe(self, value: float):
        now = self._clock()
        with self._lock:
            self.count += 1
            self.sum += value
            self._samples.append((now, float(value)))
            self._prune(now)

    def _prune(self, now: float):
        cutoff = now - self.window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def window_values(self) -> List[float]:
        with self._lock:
            self._prune(self._clock())
            return [v for _, v in self._samples]

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile over the current window.

        Sentinel contract: an *empty* window (nothing observed yet, or all
        samples pruned by ``window_s``) returns ``math.nan`` — never raises
        and never reports a stale value.  Consumers must treat NaN as "no
        data".  ``q`` is
        clamped to [0, 1] so an out-of-range request cannot index past the
        sample list."""
        vals = sorted(self.window_values())
        if not vals:
            return math.nan
        if len(vals) == 1:
            return vals[0]
        q = min(1.0, max(0.0, q))
        pos = q * (len(vals) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1 - frac) + vals[hi] * frac

    def summary(self) -> dict:
        """Windowed summary.  On an empty (fully pruned) window every
        statistic is the NaN sentinel while cumulative ``count``/``sum``
        survive and ``window_count`` is 0 — same contract as
        ``quantile``."""
        vals = self.window_values()
        out = {"count": self.count, "sum": self.sum,
               "window_count": len(vals)}
        if vals:
            out.update(mean=sum(vals) / len(vals), max=max(vals),
                       p50=self.quantile(0.50), p95=self.quantile(0.95),
                       p99=self.quantile(0.99))
        else:
            out.update(mean=math.nan, max=math.nan, p50=math.nan,
                       p95=math.nan, p99=math.nan)
        return out


class MetricsRegistry:
    """Get-or-create metric store; thread-safe, clock-injectable.

    Live components pass nothing (wall clock); a replay passes
    ``clock=lambda: sim.now`` so every sample carries virtual time.
    """

    def __init__(self, clock: Optional[Clock] = None,
                 flight_capacity: int = 4096):
        self.clock: Clock = clock or time.time
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # gauge key -> (name, sorted label items), for label lookups
        self._gauge_labels: Dict[str, Tuple[str, tuple]] = {}
        # flight recorder: bounded ring of notable events (faults,
        # execute retries and failures) for post-mortem dumps.
        # Guarded by its own lock so event bursts never contend with the
        # metric get-or-create path; the deque maxlen enforces the cap
        # even under concurrent writers.
        self._events: deque = deque(maxlen=flight_capacity)
        self._events_lock = threading.Lock()
        self._event_seq = 0

    # -- get-or-create accessors -------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        key = metric_key(name, labels)
        with self._lock:
            if key not in self._counters:
                self._counters[key] = Counter()
            return self._counters[key]

    def gauge(self, name: str, **labels) -> Gauge:
        key = metric_key(name, labels)
        with self._lock:
            if key not in self._gauges:
                self._gauges[key] = Gauge()
                self._gauge_labels[key] = (name, tuple(sorted(
                    labels.items())))
            return self._gauges[key]

    def histogram(self, name: str, **labels) -> Histogram:
        key = metric_key(name, labels)
        with self._lock:
            if key not in self._histograms:
                self._histograms[key] = Histogram(self.clock)
            return self._histograms[key]

    def labeled_gauge_values(self, name: str, **labels,
                             ) -> List[Tuple[Dict[str, str], float]]:
        """``(label_dict, value)`` of every gauge of family ``name`` whose
        labels contain ``labels`` (e.g. each engine's ``kv_free_pages`` of
        a service)."""
        want = set(labels.items())
        with self._lock:
            return [(dict(items), self._gauges[key].value)
                    for key, (mname, items) in self._gauge_labels.items()
                    if mname == name and want <= set(items)]

    # -- flight recorder ----------------------------------------------------
    def record_event(self, kind: str, **fields):
        """Append a (t, kind, fields, seq) event to the post-mortem ring.
        ``seq`` is a monotonic sequence number assigned under the event
        lock, so total order is recoverable even when the injected clock is
        coarse (virtual time) or two threads race on the same instant.
        Not for per-token hot paths."""
        with self._events_lock:
            seq = self._event_seq
            self._event_seq += 1
            self._events.append((self.clock(), kind, fields, seq))

    def flight_record_to_file(self, path: str, **context) -> str:
        """Write ``snapshot()`` plus the caller's context (e.g. the failing
        engine and the error) as JSON to ``path``: the event ring outlives
        the process that crashed."""
        import json

        dump = self.snapshot()
        dump["events"] = [{"t": t, "kind": kind, "fields": fields, "seq": seq}
                          for t, kind, fields, seq in dump["events"]]
        dump["context"] = {k: str(v) for k, v in context.items()}
        with open(path, "w") as f:
            json.dump(dump, f, default=str)
        return path

    def snapshot(self) -> dict:
        """Every metric's value and the event ring (ts = injected clock)."""
        with self._events_lock:
            events = list(self._events)
        with self._lock:
            return {
                "ts": self.clock(),
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.summary()
                               for k, h in self._histograms.items()},
                "events": events,
            }
