#!/usr/bin/env python3
"""Served decode of two checkouts, in turns, on one CUDA card.

    python3 tools/ab_serve.py OTHER_CHECKOUT [--pairs 4]
                              [--keys yi recurrentgemma]

Runs each checkout's own ``chip_smoke.py`` serve phases (``_serve``:
full-width weights from seed 0, batch 8, one prefill and 32 decode tokens
through ``FunkyRuntime`` -> ``ServeTask`` -> ``FunkyCL`` -> ``Monitor``,
with its launch-count gate) for each key of ``--keys``, then the yi-9b
warm decode step of its profile phase (``_profile``), in a process of its
own per run: ``--pairs`` pairs, alternating which checkout runs first
(other, this, this, other, ...).  Each run prints one JSON line: per key
the median EXECUTE time of a served decode token, the served decode
tokens/s, and the warm decode step.  Compare the two checkouts only
within one run of this script.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(tree: Path, keys) -> dict:
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke as cs

    state: dict = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for key in keys:
            cs._serve(state, key)
        cs._profile(state, "yi")
    out = {"tree": str(tree)}
    for line in buf.getvalue().splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if rec.get("phase") == "serve":
            out[f"{rec['arch']}_served_decode_token_s_median"] = \
                rec["decode_token_s_median"]
            out[f"{rec['arch']}_served_decode_tokens_per_s"] = \
                rec["decode_tokens_per_s"]
        elif rec.get("phase") == "profile":
            out[f"{rec['arch']}_decode_step_warm_s"] = \
                rec["decode_step_warm_s"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--keys", nargs="+", default=["yi", "recurrentgemma"])
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker.resolve(), a.keys)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    other = a.other.resolve()
    pair = [(other, "other"), (ROOT, "this")]
    order = [run for i in range(a.pairs)
             for run in (pair if i % 2 == 0 else pair[::-1])]
    for tree, label in order:
        out = subprocess.run(
            [sys.executable, __file__, str(other), "--keys", *a.keys,
             "--worker", str(tree)],
            capture_output=True, text=True, timeout=900, cwd=tree)
        if out.returncode:
            raise RuntimeError(f"{label} run failed:\n{out.stderr[-3000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": label, "card": card, **rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
