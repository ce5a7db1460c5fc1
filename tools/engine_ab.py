#!/usr/bin/env python3
"""The serving engine's decode, one tree against another, on one CUDA card.

    python3 tools/engine_ab.py OTHER    # OTHER and this tree in turns

Each run is a process of its own that imports its tree's ``chip_smoke.py``
and ``repro_torch``.  It builds the kernels (``phase_env``), serves the
engine phase's 24 requests as that phase's run (a) does
(``_engine_served``: full-width yi-9b, 8 lanes, single-step, through the
runtime), then serves them once more on a monitor and, at iteration 6,
times and traces one warm decode step (``_paged_logit_check``: wall,
device ms, busy share, launches).  The runs go other, this, this, other;
each prints one JSON line.  Compare two trees only within one run of this
script.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUN_A = ("wall_s", "ttft_p50_s", "ttft_p99_s", "tbt_p50_s",
         "decode_tokens_per_s", "decode_steps", "prefills", "preemptions",
         "program_device_s", "host_device_split", "launches")


def worker(tree: Path) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.core import FunkyCL, Monitor, SliceAllocator
    from repro_torch.scaling.metrics import MetricsRegistry
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.equivalence import run_transcript

    state: dict = {}
    cs.phase_env(state)
    arch = cs.ENGINE["arch"]
    cfg = get_arch(arch)
    _, a = cs._engine_served(arch, "cuda", 1, 0, "a")
    checks = []

    def factory():
        mon = Monitor("engine-ab", SliceAllocator(
            "node0", 1, mem_cap_bytes=64 << 30, device="cuda"),
            telemetry=MetricsRegistry())
        eng = ContinuousBatchingEngine(arch, FunkyCL(mon), seed=cs.SEED,
                                       engine_id="engine-ab",
                                       **cs._engine_kw())
        eng.setup()
        return mon, eng

    def hook(eng, mon, i):
        if i == 6:
            checks.append(cs._paged_logit_check(eng, mon, cfg))

    run_transcript(factory, lambda: cs.engine_requests(cfg.vocab_size),
                   step_hook=hook)
    return {"run_a": {k: a.get(k) for k in RUN_A}, "warm_step": checks[0]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, nargs="?", help="the other tree")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("engine_ab: no CUDA card", file=sys.stderr)
        return 2
    if a.worker:
        print(json.dumps(worker(a.worker.resolve()), default=str))
        return 0
    if a.other is None:
        ap.error("give the other tree")
    other = a.other.resolve()
    for tree, label in ((other, "other"), (ROOT, "this"), (ROOT, "this"),
                        (other, "other")):
        out = subprocess.run(
            [sys.executable, __file__, "--worker", str(tree)],
            capture_output=True, text=True, timeout=900, cwd=tree)
        if out.returncode:
            raise RuntimeError(f"{label} run failed:\n{out.stderr[-3000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": label, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
