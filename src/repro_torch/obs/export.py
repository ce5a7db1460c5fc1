"""Chrome-trace-event exporter (loadable in Perfetto / chrome://tracing); a
copy of the reference package's ``obs/export.py``.

Emits the JSON object format ``{"traceEvents": [...]}`` with complete
(``ph: "X"``) events plus ``ph: "M"`` metadata naming each process and
thread.  Mapping:

* one *process* (pid) per trace — process_name is ``"<name> <trace_id>"``,
* one *thread* (tid) per span-name prefix (the segment before the first
  ``.``), so ``router.queue``, ``engine.admit`` and ``monitor.execute``
  land on separate, labelled rows,
* ``ts``/``dur`` in microseconds of the trace's (possibly virtual) clock,
* ``args`` carries the span labels plus ``span_id``/``parent_id`` so the
  original tree is recoverable from the export alone.

Unfinished spans are exported with ``dur`` measured to the trace clock's
now, flagged with ``args.unfinished``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def chrome_trace_events(traces: Iterable[Any]) -> Dict[str, Any]:
    events: List[Dict[str, Any]] = []
    for pid, tr in enumerate(traces, start=1):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"{tr.name} {tr.trace_id}"}})
        tids: Dict[str, int] = {}
        links = getattr(tr, "links", None) or []
        for sp in tr.spans():
            prefix = sp.name.split(".", 1)[0]
            tid = tids.get(prefix)
            if tid is None:
                tid = tids[prefix] = len(tids) + 1
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": tid,
                               "args": {"name": prefix}})
            end = sp.end_t if sp.end_t is not None else tr.clock()
            args = {k: _jsonable(v) for k, v in sp.labels.items()}
            args["span_id"] = sp.span_id
            args["parent_id"] = sp.parent_id
            args["trace_id"] = tr.trace_id
            if sp.end_t is None:
                args["unfinished"] = True
            if links and sp.parent_id == 0:
                # cross-trace links ride on the root event: a recovery
                # trace names the trace it continues
                args["links"] = json.dumps(links)
            events.append({
                "name": sp.name,
                "cat": prefix,
                "ph": "X",
                "ts": sp.start_t * 1e6,
                "dur": max(0.0, end - sp.start_t) * 1e6,
                "pid": pid,
                "tid": tid,
                "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(tracer: Any, path: str,
                        include_live: bool = True) -> str:
    """Write a tracer's retained traces to ``path`` as Chrome-trace JSON."""
    doc = chrome_trace_events(tracer.traces(include_live=include_live))
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def validate_chrome_trace(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Sanity-check an exported document; returns summary stats.

    Raises ``ValueError`` on malformed events or a disconnected span tree
    (a parent_id that resolves to no span in the same trace).
    """
    if "traceEvents" not in doc:
        raise ValueError("missing traceEvents")
    spans_by_trace: Dict[Any, Dict[int, int]] = {}
    complete = 0
    for ev in doc["traceEvents"]:
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event missing {field!r}: {ev}")
        if ev["ph"] == "M":
            continue
        if ev["ph"] != "X":
            raise ValueError(f"unexpected ph {ev['ph']!r}")
        if "ts" not in ev or "dur" not in ev:
            raise ValueError(f"complete event missing ts/dur: {ev}")
        complete += 1
        args = ev.get("args", {})
        tid_key = (ev["pid"], args.get("trace_id"))
        spans_by_trace.setdefault(tid_key, {})[args["span_id"]] = \
            args["parent_id"]
    for key, spans in spans_by_trace.items():
        roots = [s for s, p in spans.items() if p == 0]
        if len(roots) != 1:
            raise ValueError(f"trace {key}: expected 1 root, got {roots}")
        for sid, pid_ in spans.items():
            if pid_ != 0 and pid_ not in spans:
                raise ValueError(
                    f"trace {key}: span {sid} orphaned (parent {pid_})")
    return {"traces": len(spans_by_trace), "spans": complete}
