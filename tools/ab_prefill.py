#!/usr/bin/env python3
"""Warm prefill of one full-width arch from two checkouts, in turns, on one
CUDA card.

    python3 tools/ab_prefill.py OTHER_CHECKOUT [--arch mamba2-1.3b]
                                [--prompt 1024]

Runs the port of each checkout (``<dir>/src``) in a process of its own,
in the order other, this, this, other: random weights from seed 0, batch
8, the kernel path, through ``chip_smoke.prefill_runner`` (the prefill
the profile phases time).  Each run prints one JSON line: the median of
five warm prefills (host clock, closed on ``torch.cuda.synchronize``) and
``chip_smoke._trace_summary`` of one traced prefill (device time, busy
share, the time of each kernel of the port).  Compare the two checkouts
only within one run of this script.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(tree: Path, arch: str, S: int) -> dict:
    sys.path[:0] = [str(tree / "src")]
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    sys.path.insert(0, str(ROOT))
    from chip_smoke import SEED, _trace_summary, prefill_runner, timed

    cfg = get_arch(arch)
    bundle = build_model(cfg)
    params = bundle.init(SEED, device="cuda")
    prefill, _ = prefill_runner(cfg, bundle, params, S)
    with torch.no_grad():
        prefill()
        prefill()
        walls = [timed(prefill, 1) for _ in range(5)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = timed(prefill, 1)
    return {"tree": str(tree), "arch": arch, "prompt_len": S, "batch": 8,
            "prefill_warm_s_median": statistics.median(walls),
            "prefill_warm_s": walls,
            "prefill_trace": _trace_summary(prof, wall, 1)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker.resolve(), a.arch, a.prompt)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    other = a.other.resolve()
    for tree, label in ((other, "other"), (ROOT, "this"), (ROOT, "this"),
                        (other, "other")):
        out = subprocess.run(
            [sys.executable, __file__, str(other), "--arch", a.arch,
             "--prompt", str(a.prompt), "--worker", str(tree)],
            capture_output=True, text=True, timeout=600, cwd=tree)
        if out.returncode:
            raise RuntimeError(f"{label} run failed:\n{out.stderr[-3000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": label, "card": card, **rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
