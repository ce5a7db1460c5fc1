#!/usr/bin/env python3
"""Where the device memory of a training step goes, on one CUDA card.

    python3 train_memory.py                  # needs one card

Builds ``chip_smoke.py``'s training cut (yi-9b at full width, 8 of its 48
layers, seq 1024, microbatches of 2, the TrainTask image's AdamW with f32
moments) and runs the chunked programs as a ``TrainTask`` runs them, one
stage at a time: ``grad_init``, four ``grad_step``s, the average and
``apply`` (in place).  Before each stage it resets the allocator's peak;
after it, it prints one JSON line with the bytes allocated before, the
stage's peak, the bytes left and the bytes of the CUDA tensors Python
can reach beyond the training state.  The same for one microbatch's
gradients through ``torch.func.grad_and_value`` (which the port does
not use), beside the port's ``torch.autograd.grad`` on detached leaves
(``grad_step``).  For the first ``grad_step`` it also
records the allocator's history and prints the largest blocks live at
that stage's peak, by the innermost frame of the repository that
allocated them.  The last line names the card and its power limit.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

LAYERS, SEQ, MICRO, CHUNKS = 8, 1024, 2, 4


def _gb(n):
    return round(n / 1e9, 3)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_memory: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import TaskImage
    from repro_torch.models import build_model
    from repro_torch.train import make_batch, make_chunked_train_fns
    from repro_torch.train import make_train_state
    from repro_torch.train.train_step import _on
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_arch("yi-9b"), num_layers=LAYERS)
    oc = TaskImage(name="t", kind="train").opt
    bundle = build_model(cfg)
    params, opt = make_train_state(bundle, oc, 0, device="cuda")
    grad_init, grad_step, apply_step = make_chunked_train_fns(bundle, oc)
    batch = make_batch(cfg, ShapeConfig("t", "train", SEQ, MICRO * CHUNKS),
                       0)
    mbs = [{k: v[i * MICRO:(i + 1) * MICRO] for k, v in batch.items()}
           for i in range(CHUNKS)]

    def reachable_beyond_state():
        """Bytes of the CUDA tensors Python reaches, less the state's."""
        gc.collect()
        state = {t.data_ptr() for t in tree_leaves((params, opt, acc))}
        seen = {}
        for o in gc.get_objects():
            if isinstance(o, torch.Tensor) and o.is_cuda and \
                    o.data_ptr() not in state:
                st = o.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values())

    acc = None

    def stage(name, fn, record=False):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if record:
            torch.cuda.memory._record_memory_history(
                stacks="python", max_entries=1000000)
        res = fn()
        torch.cuda.synchronize()
        if record:
            snap = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            _summarise(snap)
        print(json.dumps({"stage": name, "before_gb": _gb(before),
                          "peak_gb": _gb(torch.cuda.max_memory_allocated()),
                          "after_gb": _gb(torch.cuda.memory_allocated()),
                          "reachable_beyond_state_gb":
                              _gb(reachable_beyond_state())}),
              flush=True)
        return res

    acc = stage("grad_init", lambda: grad_init(params))
    for i, mb in enumerate(mbs):
        acc, _ = stage(f"grad_step{i}",
                       lambda mb=mb: grad_step(params, acc, mb),
                       record=(i == 0))
    stage("apply", lambda: apply_step(params, opt, acc, CHUNKS))

    def func_grads():
        return torch.func.grad_and_value(bundle.loss_fn, has_aux=True)(
            params, _on(params, mbs[0]))

    g = stage("torch_func_grads", func_grads)
    del g
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


def _summarise(snap):
    """At the recorded stage's peak: the live blocks by the innermost
    frame of the repository that allocated them."""
    events = [ev for trace in snap["device_traces"] for ev in trace
              if ev["action"] in ("alloc", "free_completed")]
    total = peak = at = 0
    for i, ev in enumerate(events):
        total += ev["size"] if ev["action"] == "alloc" else -ev["size"]
        if total > peak:
            peak, at = total, i
    live = {}
    for ev in events[:at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        else:
            live.pop(ev["addr"], None)
    by_frame = Counter()
    for ev in live.values():
        frames = [f for f in ev.get("frames", ())
                  if "repro_torch" in f.get("filename", "")]
        key = (f"{os.path.basename(frames[0]['filename'])}:"
               f"{frames[0]['line']} {frames[0]['name']}"
               if frames else "outside the repository")
        by_frame[key] += ev["size"]
    rows = [{"frame": k, "gb": _gb(v)} for k, v in by_frame.most_common(25)]
    print(json.dumps({"recorded_peak_gb_above_start": _gb(peak),
                      "largest": rows}), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
