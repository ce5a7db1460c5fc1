"""Quickstart on the PyTorch port: train a small LM end to end under the
Funky runtime (``examples/quickstart.py`` of the JAX package).

Everything the task does (buffer allocation, data transfers, train-step
launches, synchronization) flows through the FunkyCL API into the
per-task monitor, so the job is preemptible and checkpointable from step
one.

    python examples_torch/quickstart.py                 # on the CUDA card
    python examples_torch/quickstart.py --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import TaskImage, TaskStatus, make_cluster  # noqa: E402
from repro_torch.train import OptConfig  # noqa: E402

IMAGE = TaskImage(
    name="quickstart", kind="train", arch="yi-9b-smoke",
    seq_len=64, global_batch=8, total_steps=100, chunks=4,
    opt=OptConfig(peak_lr=3e-3, warmup_steps=10, decay_steps=100),
)


def main(image: TaskImage = IMAGE, arch: str = None,
         total_steps: int = None, mem_cap_bytes: int = 8 << 30,
         device=None, interval_s: float = 1.0, ckpt_root: str = None
         ) -> dict:
    """Train ``image`` (its ``arch`` and ``total_steps`` replaced where
    given) to DONE on one node of one vSlice of ``mem_cap_bytes``.
    Returns what it prints; raises if the task does not end DONE."""
    if arch is not None:
        image = dataclasses.replace(image, arch=arch)
    if total_steps is not None:
        image = dataclasses.replace(image, total_steps=total_steps)
    cluster = make_cluster(num_nodes=1, slices_per_node=1,
                           images={image.name: image},
                           mem_cap_bytes=mem_cap_bytes, ckpt_root=ckpt_root,
                           device=device)
    runtime = cluster.nodes["node0"].runtime
    try:
        print("deploying training task (unikernel boot + program setup)...")
        runtime.create("demo", image)
        runtime.start("demo")
        t0 = time.perf_counter()
        rec = runtime.tasks["demo"]
        while True:
            status = runtime.wait("demo", timeout=interval_s)
            print(f"  step {rec.guest_state.step}/{image.total_steps} "
                  f"(EXECUTEs: {int(rec.monitor.metrics['n_EXECUTE'])})",
                  flush=True)
            if status in (TaskStatus.DONE, TaskStatus.FAILED,
                          TaskStatus.REMOVED):
                break
        wall = time.perf_counter() - t0
        if status is not TaskStatus.DONE:
            raise RuntimeError(f"quickstart: the task ended {status}: "
                               f"{rec.error!r}")
        m = rec.monitor.metrics
        out = {"arch": image.arch, "status": status.value,
               "step": rec.guest_state.step,
               "total_steps": image.total_steps, "wall_s": wall,
               "final_loss": rec.guest_state.user["final_loss"],
               "n_EXECUTE": int(m["n_EXECUTE"]),
               "n_TRANSFER": int(m["n_TRANSFER"]),
               "reconfig_seconds": m["reconfig_seconds"]}
        print(f"finished {image.total_steps} steps in {wall:.1f}s; "
              f"final loss {out['final_loss']:.4f}")
        print(f"monitor stats: reconfig={out['reconfig_seconds']:.2f}s "
              f"transfers={out['n_TRANSFER']}")
        if out["step"] != image.total_steps or \
                not math.isfinite(out["final_loss"]):
            raise RuntimeError(f"quickstart: ended at step {out['step']} "
                               f"with loss {out['final_loss']}")
        return out
    finally:
        cluster.stop()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=IMAGE.arch)
    ap.add_argument("--steps", type=int, default=IMAGE.total_steps)
    ap.add_argument("--mem-cap-gib", type=float, default=8.0)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    a = ap.parse_args()
    main(arch=a.arch, total_steps=a.steps,
         mem_cap_bytes=int(a.mem_cap_gib * (1 << 30)), device=a.device)
