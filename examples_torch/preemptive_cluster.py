"""Preemptive scheduling on the PyTorch port (paper Fig 10;
``examples/preemptive_cluster.py`` of the JAX package): a high-priority
job evicts a low-priority one on a fully occupied 2-node cluster; the
evicted job later resumes or migrates to a freed slot and completes with
its state intact.

    python examples_torch/preemptive_cluster.py            # on the CUDA card
    python examples_torch/preemptive_cluster.py --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (Policy, TaskImage, TaskStatus,  # noqa: E402
                              make_cluster)

IMAGES = {
    "batch-job": TaskImage(name="batch-job", kind="train", arch="yi-9b-smoke",
                           seq_len=32, global_batch=4, total_steps=20,
                           chunks=2),
    "prod-job": TaskImage(name="prod-job", kind="train", arch="qwen3-8b-smoke",
                          seq_len=32, global_batch=4, total_steps=4,
                          chunks=2),
}


def main(images: dict = None, batch_arch: str = None, prod_arch: str = None,
         mem_cap_bytes: int = 8 << 30, device=None, ckpt_root: str = None,
         timeout_s: float = 3600.0) -> dict:
    """Two priority-0 ``batch-job`` tasks fill both slices; once both run,
    a priority-10 ``prod-job`` arrives under ``Policy.PRE_MG``.  The
    images' archs are replaced where given.  Returns what it prints."""
    images = dict(images or IMAGES)
    for name, arch in (("batch-job", batch_arch), ("prod-job", prod_arch)):
        if arch is not None:
            images[name] = dataclasses.replace(images[name], arch=arch)
    cluster = make_cluster(num_nodes=2, slices_per_node=1, images=images,
                           policy=Policy.PRE_MG, mem_cap_bytes=mem_cap_bytes,
                           ckpt_root=ckpt_root, device=device)
    orch = cluster.orchestrator
    orch.start(tick_interval=0.02)

    def recs(cid):
        return [r for nd in cluster.nodes.values()
                for r in list(nd.runtime.tasks.values()) if r.cid == cid]

    try:
        print("submitting 2 low-priority batch jobs (fill the cluster)...")
        low = [orch.submit("batch-job", priority=0) for _ in range(2)]
        deadline = time.time() + timeout_s
        # both slices are taken once both guests finished their setup
        while not all(any(r.status is TaskStatus.RUNNING for r in recs(c))
                      for c in low):
            bad = [c for c in low if orch.deployments[c].status == "failed"
                   or any(r.status is TaskStatus.FAILED for r in recs(c))]
            if bad or time.time() > deadline:
                raise RuntimeError(f"preemptive_cluster: the batch jobs did "
                                   f"not both start: {bad}")
            time.sleep(0.001)
        print("submitting a high-priority prod job -> should evict a batch "
              "job")
        high = orch.submit("prod-job", priority=10)

        if not orch.wait_all(timeout=timeout_s):
            raise RuntimeError("preemptive_cluster: the jobs did not finish")
        print("\nevent log (orchestrator):")
        events = []
        for ts, ev, kw in orch.events:
            if ev in ("evict", "resume", "migrate", "deploy", "done"):
                print(f"  {ev:8s} {kw}")
                events.append((ev, kw.get("cid"), kw.get("node")))
        jobs = {}
        for cid in low + [high]:
            d = orch.deployments[cid]
            done = [r for r in recs(cid) if r.status is TaskStatus.DONE]
            jobs[cid] = {"image": d.image_ref, "status": d.status,
                         "latency_s": d.end_time - d.submit_time,
                         "step": (done[0].guest_state.step if done
                                  else None)}
            print(f"{cid}: {d.status}, latency {jobs[cid]['latency_s']:.1f}s")
        evicted = [cid for ev, cid, _ in events if ev == "evict"]
        print(f"\npreemptions: {len(evicted)} "
              f"(the batch job resumed with its training state intact)")
        out = {"events": events, "jobs": jobs, "evicted": evicted,
               "preemptions": len(evicted)}
        bad = [c for c, j in jobs.items() if j["status"] != "done"
               or j["step"] != images[j["image"]].total_steps]
        if bad or not evicted:
            raise RuntimeError(f"preemptive_cluster: {len(evicted)} "
                               f"evictions; jobs not done at their last "
                               f"step: {bad}")
        return out
    finally:
        orch.stop()
        cluster.stop()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-arch", default=IMAGES["batch-job"].arch)
    ap.add_argument("--prod-arch", default=IMAGES["prod-job"].arch)
    ap.add_argument("--mem-cap-gib", type=float, default=8.0)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    a = ap.parse_args()
    main(batch_arch=a.batch_arch, prod_arch=a.prod_arch,
         mem_cap_bytes=int(a.mem_cap_gib * (1 << 30)), device=a.device)
