"""Span-based tracing with an injectable clock (a copy of the reference
package's ``obs/tracer.py``: pure host code).

One `Tracer` serves both planes: the live serving path clocks spans with
``time.perf_counter`` (the default), while the virtual-clock
``ServingSimulator`` injects ``lambda: self.now`` so simulated traces carry
deterministic virtual timestamps.  A *trace* is a tree of *spans* keyed by a
caller-chosen ``trace_id`` (the request rid for request traces, an
``engine:itN`` key for per-iteration decode traces, ``"cluster"`` for the
orchestration plane).

Retention is bounded two ways:

* a ring of the most recent ``capacity`` finished traces, admitted with
  probability ``sample_rate`` (seeded ``random.Random`` — deterministic
  under a fixed seed), and
* a keep-slowest heap of the ``keep_slowest`` finished traces with the
  largest root-span duration, which are retained *regardless* of the
  probabilistic decision — slow outliers are exactly the traces worth
  keeping.

Spans are cheap plain objects; when a ``Tracer`` is absent every call site
degrades to ``span=None`` and the serving path pays nothing.
"""

from __future__ import annotations

import heapq
import itertools
import json
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional


class Span:
    """One timed operation inside a trace.  ``end()`` is idempotent."""

    __slots__ = ("trace", "span_id", "parent_id", "name", "labels",
                 "start_t", "end_t")

    def __init__(self, trace: "Trace", span_id: int, parent_id: int,
                 name: str, labels: Dict[str, Any], start_t: float):
        self.trace = trace
        self.span_id = span_id
        self.parent_id = parent_id          # 0 == root (no parent)
        self.name = name
        self.labels = labels
        self.start_t = start_t
        self.end_t: Optional[float] = None

    def child(self, name: str, t0: Optional[float] = None,
              **labels: Any) -> "Span":
        return self.trace.span(name, parent=self, t0=t0, **labels)

    def annotate(self, **labels: Any) -> "Span":
        self.labels.update(labels)
        return self

    def end(self, t: Optional[float] = None) -> "Span":
        if self.end_t is None:
            self.end_t = self.trace.clock() if t is None else t
        return self

    @property
    def duration(self) -> float:
        end = self.end_t if self.end_t is not None else self.trace.clock()
        return max(0.0, end - self.start_t)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.end()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r} id={self.span_id} "
                f"parent={self.parent_id} dur={self.duration:.6f})")


class Trace:
    """A bounded tree of spans sharing one trace_id.

    Span storage is a ring (``max_spans``) so a runaway producer cannot
    grow a trace without bound; the root span is held separately and never
    evicted.  New spans default their parent to the root, so the tree stays
    connected even when a call site lacks the precise parent.
    """

    def __init__(self, tracer: "Tracer", trace_id: str, name: str,
                 labels: Dict[str, Any], max_spans: int = 4096,
                 sampled: bool = True):
        self.tracer = tracer
        self.trace_id = trace_id
        self.name = name
        self.clock: Callable[[], float] = tracer.clock
        self.sampled = sampled
        self._lock = threading.Lock()
        self._ids = itertools.count(2)      # 1 is the root
        self._spans: deque = deque(maxlen=max_spans)
        self.dropped_spans = 0
        self.finished = False
        # cross-trace links: a recovery trace points back at the trace it
        # continues (pre-crash / pre-evacuation), so tooling can stitch a
        # request's whole lifetime into one timeline
        self.links: List[Dict[str, Any]] = []
        self.root = Span(self, 1, 0, name, dict(labels), self.clock())

    def link(self, other: "Trace", relation: str = "follows") -> "Trace":
        """Record that this trace ``relation``s ``other`` (e.g. a replayed
        request's new trace ``recovers`` its crashed predecessor)."""
        self.links.append({"trace_id": other.trace_id,
                           "name": other.name,
                           "relation": relation})
        return self

    def span(self, name: str, parent: Optional[Span] = None,
             t0: Optional[float] = None, **labels: Any) -> Span:
        pid = (parent.span_id if parent is not None else self.root.span_id)
        with self._lock:
            sid = next(self._ids)
            sp = Span(self, sid, pid, name, labels,
                      self.clock() if t0 is None else t0)
            if len(self._spans) == self._spans.maxlen:
                self.dropped_spans += 1
            self._spans.append(sp)
        return sp

    def spans(self) -> List[Span]:
        """Root first, then retained spans in creation order."""
        with self._lock:
            return [self.root] + list(self._spans)

    def find_spans(self, name: str) -> List[Span]:
        return [s for s in self.spans() if s.name == name]

    def finish(self, t: Optional[float] = None, **labels: Any) -> "Trace":
        """End the root span and hand the trace to tracer retention."""
        if not self.finished:
            self.finished = True
            self.root.annotate(**labels).end(t)
            self.tracer._retire(self)
        return self

    @property
    def duration(self) -> float:
        return self.root.duration

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "sampled": self.sampled,
            "finished": self.finished,
            "dropped_spans": self.dropped_spans,
            "duration": self.duration,
            "links": list(self.links),
            "spans": [{
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "name": s.name,
                "start": s.start_t,
                "end": s.end_t,
                "labels": dict(s.labels),
            } for s in self.spans()],
        }


class Tracer:
    """Factory + bounded retention for traces.

    ``clock`` is injectable (virtual time in the simulator); ``seed`` makes
    the probabilistic sampler deterministic.  Live (unfinished) traces are
    tracked separately so an export mid-run still sees in-flight requests.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None, *,
                 capacity: int = 256, sample_rate: float = 1.0,
                 keep_slowest: int = 8, max_spans_per_trace: int = 4096,
                 seed: int = 0):
        self.clock = clock if clock is not None else time.perf_counter
        self.capacity = capacity
        self.sample_rate = float(sample_rate)
        self.keep_slowest = keep_slowest
        self.max_spans_per_trace = max_spans_per_trace
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._slow: list = []                      # min-heap (dur, seq, trace)
        self._seq = itertools.count()
        self._live: Dict[int, Trace] = {}
        self.started = 0
        self.finished = 0

    def start_trace(self, name: str, trace_id: Optional[str] = None,
                    sampled: Optional[bool] = None, **labels: Any) -> Trace:
        with self._lock:
            n = next(self._seq)
            if sampled is None:
                sampled = (self.sample_rate >= 1.0
                           or self._rng.random() < self.sample_rate)
            tr = Trace(self, trace_id if trace_id is not None else f"t{n}",
                       name, labels, max_spans=self.max_spans_per_trace,
                       sampled=sampled)
            self._live[id(tr)] = tr
            self.started += 1
        return tr

    def _retire(self, tr: Trace) -> None:
        with self._lock:
            self._live.pop(id(tr), None)
            self.finished += 1
            if tr.sampled:
                self._ring.append(tr)
            if self.keep_slowest > 0:
                item = (tr.duration, next(self._seq), tr)
                if len(self._slow) < self.keep_slowest:
                    heapq.heappush(self._slow, item)
                elif item[0] > self._slow[0][0]:
                    heapq.heapreplace(self._slow, item)

    def traces(self, include_live: bool = True) -> List[Trace]:
        """Retained traces (ring ∪ keep-slowest), oldest root first."""
        with self._lock:
            out = list(self._ring)
            seen = {id(t) for t in out}
            for _, _, t in self._slow:
                if id(t) not in seen:
                    out.append(t)
                    seen.add(id(t))
            if include_live:
                out.extend(t for t in self._live.values()
                           if id(t) not in seen)
        out.sort(key=lambda t: t.root.start_t)
        return out

    def find(self, trace_id: str) -> Optional[Trace]:
        for t in self.traces():
            if t.trace_id == trace_id:
                return t
        return None

    def event_span(self, name: str, trace_id: Optional[str] = None,
                   **labels: Any) -> Trace:
        """One-shot single-span trace; ``finish()`` it when done (or use as
        a context manager via the returned trace's root span)."""
        return self.start_trace(name, trace_id=trace_id, sampled=True,
                                **labels)

    # -- export ----------------------------------------------------------
    def chrome_trace(self, include_live: bool = True) -> Dict[str, Any]:
        from .export import chrome_trace_events
        return chrome_trace_events(self.traces(include_live=include_live))

    def export(self, path: str, include_live: bool = True) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(include_live=include_live), f)
        return path
