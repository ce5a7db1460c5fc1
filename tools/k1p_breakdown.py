#!/usr/bin/env python3
"""Where K1's paged entry (``decode_attention_paged``) spends its time, on
one CUDA card.

    python3 tools/k1p_breakdown.py              # the split of this tree
    python3 tools/k1p_breakdown.py --ab OTHER   # OTHER and this tree in turns

Split: builds ``src/repro_torch/kernels/csrc/decode_attention.cu`` as it
is, once as the kernel and once per measurement probe the source defines
(``-DK1P_PROBE=n``: the bf16 paged kernel stopped after one of its steps),
one ``nvcc`` each, all started together.  At the engine's decode shape
(B 8, pages of 16, table width 36, 32/4 heads, hd 128, bf16), with every
lane inactive (the floor), at ``prefill_chunk``'s one lane and at
speculative verify's first window (``chip_smoke.py``'s ``path``,
``chunk_b1``, ``verify_w0``), it checks the kernel against the plain
version under each plan (the wrapper's ``paged_plan``, one CTA a (lane,
kv head), and clusters of 4, 8 and 12 pages a CTA) and times every copy
under each plan, in turns (forward, then backward), as device time from a
``torch.profiler`` trace; beside them the dense entry on the same lanes
gathered (``gather_lane``), the same bytes without a table.  The probes
compute wrong values on purpose; only their time is read.

A/B: runs each tree's own wrapper in a process of its own, in the order
other, this, this, other, at those shapes (and the engine's in f32) and
at K1's dense rows (yi-9b, hd 256, the draft and reserved lanes), and
prints one JSON line per run.  Compare two trees only within one run of this script.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k1p_breakdown"

# name -> (B, ps, max_blocks, NP, Hq, Hkv, hd, positions key, inactive)
PAGED = {
    "path": (8, 16, 36, 288, 32, 4, 128, "engine", ()),
    "inactive": (8, 16, 36, 288, 32, 4, 128, "engine", tuple(range(8))),
    "chunk_b1": (1, 16, 5, 40, 32, 4, 128, "b1", ()),
    "verify_w0": (8, 16, 11, 88, 32, 4, 128, "verify", ()),
}
# K1's dense rows: name -> (B, cap, Hq, Hkv, hd, pos, window)
DENSE = {
    "yi9b": (8, 640, 32, 4, 128, 600, 0),
    "hd256": (8, 2048, 16, 1, 256, 2600, 2048),
    "draft": (8, 163, 32, 4, 128, [128, 150, 131, 140, 159, 129, 133, 147],
              0),
    "reserved": (8, 160, 32, 4, 128,
                 [131, 140, 159, 129, 133, 147, 128, 150], 0),
}
# copy -> extra nvcc flags
COPIES = {
    "kernel": [],
    "empty": ["-DK1P_PROBE=1"],
    "prologue": ["-DK1P_PROBE=2"],
    "copies": ["-DK1P_PROBE=3"],
    "no cluster merge": ["-DK1P_PROBE=4"],
    "no p.v products": ["-DK1P_PROBE=5"],
    "no score products": ["-DK1P_PROBE=6"],
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def paged_inputs(cs, name, n_sets=12, dtype="bfloat16"):
    B, ps, mb, NP, Hq, Hkv, hd, key, inactive = PAGED[name]
    pos = {"engine": cs.ENGINE_PAGED_POS, "b1": [53],
           "verify": cs.VERIFY_PAGED_POS}[key]
    return cs._paged_inputs(B, ps, mb, NP, Hq, Hkv, hd, pos, dtype,
                            inactive, n_sets=n_sets)


def build_copies() -> dict:
    """One nvcc per copy, all started together; copy -> the paged entry."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops

    OUT.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "decode_attention.cu"
    procs = {}
    for i, (name, flags) in enumerate(COPIES.items()):
        so = OUT / f"v{i}.so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-I",
             str(build.CSRC), "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).decode_attention_paged_fwd
        fn.argtypes = list(ops._PAGED_ARGTYPES)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def split() -> int:
    import torch

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels.build import DTYPE_CODES
    from repro_torch.kernels.common import raise_on_error, stream_of
    from repro_torch.kernels.decode_attention.ops import (
        MAX_CLUSTER, decode_attention, paged_plan, sm_count)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_paged_ref, gather_lane)

    smi = card()
    fns = build_copies()
    summary = {}
    for name in PAGED:
        sets, kvp, bt, posv, kept, mapped = paged_inputs(cs, name)
        B, ps, mb = bt.shape[0], kvp.shape[1], bt.shape[1]
        Hq, Hkv, hd = sets[0][0].shape[2], sets[0][1].shape[2], \
            sets[0][1].shape[3]
        cap = mb * ps
        route, chunk, nclu = paged_plan(B, Hkv, mb, ps, torch.bfloat16,
                                        sm_count(posv.device))
        plans = {f"wrapper ({route})": (chunk, nclu), "one CTA": (cap, 1)}
        for ppc in (4, 8, 12):
            if 1 < -(-mb // ppc) <= MAX_CLUSTER:
                plans[f"{ppc} pages a CTA"] = (ppc * ps, -(-mb // ppc))
        outs = [torch.empty_like(q) for q, _, _ in sets]

        def call(fn, plan, i):
            q, k, v = sets[i]
            raise_on_error("decode_attention_paged", fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), kvp.data_ptr(),
                bt.data_ptr(), posv.data_ptr(), outs[i].data_ptr(),
                DTYPE_CODES["bfloat16"], B, mb, ps, Hq, Hkv, hd,
                k.stride(0), kvp.stride(0), 0, 0.0, plan[0], plan[1],
                stream_of(q)))

        q, k, v = sets[0]
        ref = decode_attention_paged_ref(q, k, v, kvp, bt, posv).float()
        errs = {}
        for plan in plans:
            call(fns["kernel"], plans[plan], 0)
            errs[plan] = (outs[0].float() - ref).abs().max().item()
            if errs[plan] > 2e-2:
                raise AssertionError(f"{name} {plan}: error {errs[plan]}")
        runs = [(c, p) for c in fns for p in plans]
        times: dict = {}
        idx = [(i,) for i in range(len(sets))]
        for c, p in runs + runs[::-1]:
            ms = cs.device_ms(lambda i: call(fns[c], plans[p], i), idx)
            times.setdefault(f"{c} | {p}", []).append(ms)
        # the same lanes gathered into dense per-lane caches
        dense = []
        for q, k, v in sets:
            g = [gather_lane(k, v, kvp, bt[b]) for b in range(B)]
            dense.append((q, torch.cat([x[0] for x in g]),
                          torch.cat([x[1] for x in g]),
                          torch.stack([x[2] for x in g]).int()))
        times["dense entry, gathered"] = [cs.device_ms(
            lambda q, kd, vd, kp: decode_attention(q, kd, vd, posv, kp),
            dense)]
        med = {key: statistics.median(v) for key, v in times.items()}
        summary[name] = med
        print(json.dumps({"shape": name, "card": smi, "plans": plans,
                          "kept_slots": kept, "mapped_pages": mapped,
                          "max_abs_err": errs, "device_ms": med,
                          "runs": times}), flush=True)
    print(json.dumps({"card": smi, "device_ms": summary}), flush=True)
    return 0


def worker(tree: Path) -> dict:
    """This process's tree's wrappers at the paged shapes and the dense
    rows: device ms of one call (median of three traces)."""
    sys.path[:0] = [str(tree / "src")]
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_paged)

    rec = {}
    cases = [(n, "bfloat16") for n in PAGED] + [("path", "float32")]
    for name, dtype in cases:
        sets, kvp, bt, posv, _, _ = paged_inputs(cs, name, dtype=dtype)
        key = f"paged {name}" + ("" if dtype == "bfloat16" else " f32")
        rec[key] = statistics.median(cs.device_ms(
            lambda q, k, v: decode_attention_paged(q, k, v, kvp, bt, posv),
            sets) for _ in range(3))
    for name, (B, cap, Hq, Hkv, hd, pos, window) in DENSE.items():
        sets, kv_pos, posv = cs._decode_inputs(B, cap, Hq, Hkv, hd, pos,
                                               "bfloat16")
        rec[f"dense {name}"] = statistics.median(cs.device_ms(
            lambda q, k, v: decode_attention(q, k, v, posv, kv_pos,
                                             window=window), sets)
            for _ in range(3))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", type=Path, help="the other tree")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k1p_breakdown: no CUDA card", file=sys.stderr)
        return 2
    if a.worker:
        print(json.dumps(worker(a.worker.resolve())))
        return 0
    if not a.ab:
        return split()
    smi, other = card(), a.ab.resolve()
    for tree, label in ((other, "other"), (ROOT, "this"), (ROOT, "this"),
                        (other, "other")):
        out = subprocess.run(
            [sys.executable, __file__, "--worker", str(tree)],
            capture_output=True, text=True, timeout=600, cwd=tree)
        if out.returncode:
            raise RuntimeError(f"{label} run failed:\n{out.stderr[-3000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": label, "card": smi, "device_ms": rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
