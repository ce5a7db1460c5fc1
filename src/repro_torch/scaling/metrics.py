"""Dependency-free telemetry registry shared by both execution planes
(a copy of the reference package's ``scaling/metrics.py``).

The live runtime (``Monitor``, ``NodeAgent``, ``Orchestrator``, the
serving engine) and the discrete-event ``Simulator`` publish into the
*same* metric types with the *same* naming schema; the only difference is
the injected clock: wall time for the live plane, the simulator's virtual
``now`` for replayed traces.  That symmetry is what lets the autoscaler
run unchanged against either plane.

Types:

* ``Counter``      monotonically increasing float (requests_total, ...)
* ``Gauge``        last-write-wins float (queue_depth, replicas, ...)
* ``Histogram``    windowed samples with p50/p95/p99 (request latency)
* ``TimeSeries``   fixed-capacity ring buffer of (t, value) observations

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
        # writers (monitor workers, drive loop) race readers (autoscaler
        # reconcile thread) on the deque; guard every touch
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
        and never reports a stale value.  Consumers (autoscaler signals,
        the Prometheus exporter) must treat NaN as "no data".  ``q`` is
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


class TimeSeries:
    """Ring buffer of (t, value); oldest points evicted at capacity."""

    def __init__(self, clock: Clock, capacity: int = 1024):
        self._clock = clock
        self.capacity = capacity
        self._points: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, value: float, t: Optional[float] = None):
        with self._lock:
            self._points.append((self._clock() if t is None else t,
                                 float(value)))

    def points(self) -> List[Tuple[float, float]]:
        with self._lock:
            return list(self._points)

    def window(self, t0: float, t1: float) -> List[Tuple[float, float]]:
        return [(t, v) for t, v in self.points() if t0 <= t <= t1]

    def __len__(self):
        return len(self._points)

    def time_weighted_mean(self) -> float:
        """Mean of a step function sampled at the recorded points."""
        pts = self.points()
        if not pts:
            return math.nan
        if len(pts) == 1:
            return pts[0][1]
        area = 0.0
        for (t0, v0), (t1, _) in zip(pts, pts[1:]):
            area += v0 * (t1 - t0)
        span = pts[-1][0] - pts[0][0]
        return area / span if span > 0 else pts[-1][1]


class MetricsRegistry:
    """Get-or-create metric store; thread-safe, clock-injectable.

    Live components pass nothing (wall clock); the simulator passes
    ``clock=lambda: sim.now`` so every sample carries virtual time and the
    emitted schema is identical across planes.
    """

    def __init__(self, clock: Optional[Clock] = None,
                 flight_capacity: int = 4096):
        self.clock: Clock = clock or time.time
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._series: Dict[str, TimeSeries] = {}
        # key -> (bare name, sorted label items); lets the Prometheus
        # exporter re-quote labels without parsing flattened keys
        self._meta: Dict[str, Tuple[str, Tuple[Tuple[str, str], ...]]] = {}
        # flight recorder: bounded ring of notable events (admissions,
        # retirements, evictions, scaling actions) for post-mortem dumps.
        # Guarded by its own lock so event bursts never contend with the
        # metric get-or-create path; the deque maxlen enforces the cap
        # even under concurrent writers.
        self._events: deque = deque(maxlen=flight_capacity)
        self._events_lock = threading.Lock()
        self._event_seq = 0

    def _remember(self, key: str, name: str, labels: Dict[str, str]):
        self._meta[key] = (name, tuple(sorted(labels.items())))

    # -- get-or-create accessors -------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        key = metric_key(name, labels)
        with self._lock:
            if key not in self._counters:
                self._counters[key] = Counter()
                self._remember(key, name, labels)
            return self._counters[key]

    def gauge(self, name: str, **labels) -> Gauge:
        key = metric_key(name, labels)
        with self._lock:
            if key not in self._gauges:
                self._gauges[key] = Gauge()
                self._remember(key, name, labels)
            return self._gauges[key]

    def histogram(self, name: str, window_s: Optional[float] = None,
                  max_samples: Optional[int] = None, **labels) -> Histogram:
        """Get-or-create; an explicit ``window_s``/``max_samples`` always
        wins, so configuration is order-independent — a reader that merely
        gets the histogram first (e.g. ``signals_from_registry``) cannot
        pin the defaults."""
        key = metric_key(name, labels)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = Histogram(self.clock,
                              window_s=60.0 if window_s is None else window_s,
                              max_samples=max_samples or 4096)
                self._histograms[key] = h
                self._remember(key, name, labels)
            else:
                if window_s is not None:
                    h.window_s = window_s
                if max_samples is not None \
                        and max_samples != h._samples.maxlen:
                    with h._lock:
                        h._samples = deque(h._samples,
                                           maxlen=max_samples)
            return h

    def series(self, name: str, capacity: int = 1024, **labels) -> TimeSeries:
        key = metric_key(name, labels)
        with self._lock:
            if key not in self._series:
                self._series[key] = TimeSeries(self.clock, capacity=capacity)
                self._remember(key, name, labels)
            return self._series[key]

    def drop_series(self, name: str, **labels) -> None:
        """Remove one time series (e.g. a finished task's progress
        history) so per-entity series don't accumulate forever."""
        key = metric_key(name, labels)
        with self._lock:
            self._series.pop(key, None)
            if (key not in self._counters and key not in self._gauges
                    and key not in self._histograms):
                self._meta.pop(key, None)

    def gauge_values(self, name: str, **labels) -> Dict[str, float]:
        """All gauges of one metric family whose labels contain ``labels``
        — e.g. every replica's ``kv_pages_in_use_ratio`` for a service, so
        a drive loop can aggregate per-engine gauges into the service-level
        signal the autoscaler reads."""
        want = set(labels.items())
        out = {}
        with self._lock:
            for key, g in self._gauges.items():
                mname, items = self._meta.get(key, (None, ()))
                if mname == name and want <= set(items):
                    out[key] = g.value
        return out

    def labeled_gauge_values(self, name: str, **labels,
                             ) -> List[Tuple[Dict[str, str], float]]:
        """Like ``gauge_values`` but returns ``(label_dict, value)`` pairs,
        so a caller can select on a specific label (e.g. pick the engine
        with the most ``kv_free_pages``) without parsing flattened keys."""
        want = set(labels.items())
        out = []
        with self._lock:
            for key, g in self._gauges.items():
                mname, items = self._meta.get(key, (None, ()))
                if mname == name and want <= set(items):
                    out.append((dict(items), g.value))
        return out

    # -- flight recorder ----------------------------------------------------
    def record_event(self, kind: str, **fields):
        """Append a (t, kind, fields, seq) event to the post-mortem ring.
        ``seq`` is a monotonic sequence number assigned under the event
        lock, so total order is recoverable even when the injected clock is
        coarse (virtual time) or two threads race on the same instant.
        Not for per-token hot paths — admissions, retirements, evictions,
        scaling decisions and the like."""
        with self._events_lock:
            seq = self._event_seq
            self._event_seq += 1
            self._events.append((self.clock(), kind, fields, seq))

    def flight_record(self, series_tail: int = 64) -> dict:
        """Post-mortem dump: the event ring plus the tail of every time
        series — everything needed to reconstruct 'what just happened'
        after an SLO blowup, without scraping histories elsewhere."""
        with self._events_lock:
            events = list(self._events)
        with self._lock:
            series = {k: s.points()[-series_tail:]
                      for k, s in self._series.items()}
        return {"ts": self.clock(), "events": events,
                "series_tail": series}

    def flight_record_to_file(self, path: str, series_tail: int = 64,
                              **context) -> str:
        """Serialize ``flight_record()`` (plus caller context, e.g. the
        crashing engine id and exception text) to a JSON file.  Invoked on
        engine crash paths so the event ring survives the process."""
        import json

        dump = self.flight_record(series_tail=series_tail)
        dump["events"] = [
            {"t": t, "kind": kind, "fields": fields, "seq": seq}
            for t, kind, fields, seq in dump["events"]]
        if context:
            dump["context"] = {k: str(v) for k, v in context.items()}
        with open(path, "w") as f:
            json.dump(dump, f, default=str)
        return path

    # -- export ------------------------------------------------------------
    @staticmethod
    def _prom_quote(items: Tuple[Tuple[str, str], ...]) -> str:
        """Prometheus-quoted label string (escaped backslash/quote/newline)."""
        if not items:
            return ""
        def esc(v) -> str:
            return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))
        return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in items) + "}"

    def to_prometheus_text(self) -> str:
        """Prometheus exposition format (text/plain; version 0.0.4).

        Counters and gauges map directly; histograms are exported as
        summaries (windowed quantiles + cumulative _sum/_count).  Samples
        are grouped per metric family (one # TYPE header, contiguous
        lines), as strict parsers require.  Time series are post-mortem
        artifacts and are served by ``flight_record`` instead."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
            meta = dict(self._meta)

        families: Dict[str, List[str]] = {}
        order: List[Tuple[str, str]] = []    # (name, kind) in first-seen order

        def family(key: str, kind: str) -> Tuple[str, List[str], tuple]:
            name, items = meta.get(key, (key, ()))
            if name not in families:
                families[name] = []
                order.append((name, kind))
            return name, families[name], items

        for key, c in counters:
            name, fam, items = family(key, "counter")
            fam.append(f"{name}{self._prom_quote(items)} {c.value:g}")
        for key, g in gauges:
            # NaN/inf gauges are tombstones (e.g. ``evacuate()`` poisons
            # spec_accept_rate so a stale value can't steer the autoscaler)
            # — meaningful in-process, but a literal ``nan`` sample breaks
            # strict Prometheus scrapers, so non-finite gauges are dropped
            # from the export.  (Histogram quantiles keep NaN: summaries
            # legitimately report "no data in window".)
            if not math.isfinite(g.value):
                continue
            name, fam, items = family(key, "gauge")
            fam.append(f"{name}{self._prom_quote(items)} {g.value:g}")
        for key, h in hists:
            name, fam, items = family(key, "summary")
            for q in (0.5, 0.95, 0.99):
                v = h.quantile(q)
                lab = self._prom_quote(items + (("quantile", f"{q:g}"),))
                fam.append(f"{name}{lab} "
                           f"{'NaN' if math.isnan(v) else f'{v:g}'}")
            lab = self._prom_quote(items)
            fam.append(f"{name}_sum{lab} {h.sum:g}")
            fam.append(f"{name}_count{lab} {h.count:g}")

        lines: List[str] = []
        for name, kind in order:
            lines.append(f"# TYPE {name} {kind}")
            lines.extend(families[name])
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """One schema for live and simulated runs (ts = injected clock).
        The event ring is ``flight_record()``'s."""
        with self._lock:
            return {
                "ts": self.clock(),
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.summary()
                               for k, h in self._histograms.items()},
                "series": {k: s.points() for k, s in self._series.items()},
            }
