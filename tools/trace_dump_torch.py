#!/usr/bin/env python
"""Inspect / validate a Chrome-trace JSON exported by repro_torch.obs (the
JAX package's ``tools/trace_dump.py`` on the PyTorch port: the same
output and exit codes on the same document).

Usage:
    python tools/trace_dump_torch.py TRACE.json            # summary + span table
    python tools/trace_dump_torch.py TRACE.json --check    # CI validation mode
    python tools/trace_dump_torch.py TRACE.json --trace r7 # one trace's span tree

Load the same file interactively in Perfetto (https://ui.perfetto.dev) or
chrome://tracing — one row ("process") per trace, one track per span-name
prefix (router / engine / monitor / execute / orch / sim).

``--check`` exits non-zero unless the file parses, every event carries
valid ``ph``/``ts``/``pid``/``tid`` fields, each trace's spans form one
connected tree, and at least one EXECUTE span has non-zero device time.
"""

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.obs import validate_chrome_trace  # noqa: E402


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spans_by_trace(doc: dict) -> dict:
    out = defaultdict(list)
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        out[ev.get("args", {}).get("trace_id", ev["pid"])].append(ev)
    return out


def check(doc: dict) -> int:
    stats = validate_chrome_trace(doc)       # raises on malformed events
    execs = [ev for ev in doc["traceEvents"]
             if ev.get("ph") == "X" and ev["name"] == "monitor.execute"]
    devs = [ev for ev in doc["traceEvents"]
            if ev.get("ph") == "X" and ev["name"] == "execute.device"
            and ev.get("dur", 0) > 0]
    print(f"ok: {stats['traces']} traces, {stats['spans']} spans, "
          f"{len(execs)} EXECUTE spans, {len(devs)} with device time")
    if not execs:
        print("FAIL: no monitor.execute span in trace", file=sys.stderr)
        return 1
    if not devs:
        print("FAIL: no execute.device span with non-zero duration",
              file=sys.stderr)
        return 1
    return 0


def links_of(ev: dict) -> list:
    """Cross-trace links carried on a root event (JSON-encoded in args)."""
    raw = ev.get("args", {}).get("links")
    if not raw:
        return []
    try:
        return json.loads(raw)
    except (TypeError, ValueError):
        return []


def print_tree(events: list) -> None:
    by_id = {ev["args"]["span_id"]: ev for ev in events}
    kids = defaultdict(list)
    for ev in events:
        kids[ev["args"]["parent_id"]].append(ev)
    for vs in kids.values():
        vs.sort(key=lambda e: e["ts"])

    def walk(ev, depth):
        ms = ev.get("dur", 0) / 1000.0
        labels = {k: v for k, v in ev["args"].items()
                  if k not in ("span_id", "parent_id", "trace_id", "links")}
        print(f"  {'  ' * depth}{ev['name']:<28} {ms:10.3f} ms  {labels}")
        # cross-trace links (recovery timeline): show which earlier trace
        # this one continues, right under its root
        for link in links_of(ev):
            print(f"  {'  ' * (depth + 1)}"
                  f"~~ {link.get('relation', 'follows')} trace "
                  f"{link.get('trace_id')} ({link.get('name', '?')})")
        for child in kids.get(ev["args"]["span_id"], []):
            walk(child, depth + 1)

    for root in kids.get(0, []):
        walk(root, 0)
    orphans = [ev for ev in events
               if ev["args"]["parent_id"] not in by_id
               and ev["args"]["parent_id"] != 0]
    for ev in orphans:
        walk(ev, 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="Chrome-trace JSON file")
    ap.add_argument("--check", action="store_true",
                    help="validate for CI: parse, field check, >=1 EXECUTE "
                         "span with non-zero device time")
    ap.add_argument("--trace", default=None,
                    help="print the span tree of one trace_id")
    args = ap.parse_args(argv)
    doc = load(args.path)
    if args.check:
        return check(doc)
    groups = spans_by_trace(doc)
    if args.trace is not None:
        if args.trace not in groups:
            print(f"trace {args.trace!r} not found; have: "
                  f"{sorted(map(str, groups))[:20]}", file=sys.stderr)
            return 1
        print(f"trace {args.trace}:")
        print_tree(groups[args.trace])
        return 0
    print(f"{len(groups)} traces, "
          f"{sum(len(v) for v in groups.values())} spans")
    for tid, evs in sorted(groups.items(), key=lambda kv: str(kv[0])):
        root = min(evs, key=lambda e: e["ts"])
        dur_ms = root.get("dur", 0) / 1000.0
        roots = [ev for ev in evs if ev["args"].get("parent_id") == 0]
        link_note = ""
        for r in roots:
            for link in links_of(r):
                link_note += (f"  ~~ {link.get('relation', 'follows')} "
                              f"{link.get('trace_id')}")
        print(f"  {str(tid):<24} {root['name']:<16} "
              f"{len(evs):4d} spans  {dur_ms:10.3f} ms{link_note}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
