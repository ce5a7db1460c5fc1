"""End-to-end live-cluster smoke on the PyTorch port (the JAX package's
``tools/cluster_smoke.py``): deploy train + serve tasks on 2 nodes, then
evict / resume on the other node / checkpoint / kill / restore through the
full stack.  Ends on ``CLUSTER SMOKE OK``; a failed check raises.

    python tools/cluster_smoke_torch.py                  # on the CUDA card
    python tools/cluster_smoke_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (Policy, TaskImage, TaskStatus,  # noqa: E402
                              make_cluster)

IMAGES = {
    "train-small": TaskImage(name="train-small", kind="train",
                             arch="yi-9b-smoke", seq_len=16, global_batch=4,
                             total_steps=6, chunks=2),
    "serve-small": TaskImage(name="serve-small", kind="serve",
                             arch="yi-9b-smoke", prompt_len=8, global_batch=2,
                             total_steps=4, tokens_per_step=2),
}
CKPT_IMAGE = TaskImage(name="ck", kind="train", arch="yi-9b-smoke",
                       seq_len=16, global_batch=4, total_steps=60, chunks=2)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"cluster_smoke: {what}")


def _await_step(rec, step, timeout_s):
    """Polls the guest's step counter until it reaches ``step``."""
    deadline = time.time() + timeout_s
    while rec.guest_state.step < step:
        if rec.status in (TaskStatus.FAILED, TaskStatus.REMOVED,
                          TaskStatus.DONE) or time.time() > deadline:
            raise RuntimeError(f"cluster_smoke: {rec.cid} stopped at step "
                               f"{rec.guest_state.step}: {rec.status} "
                               f"{rec.error!r}")
        time.sleep(0.001)


def main(images: dict = None, ckpt_image: TaskImage = CKPT_IMAGE,
         mem_cap_bytes: int = 8 << 30, device=None, ckpt_root: str = None,
         timeout_s: float = 180.0) -> dict:
    images = dict(images or IMAGES)
    out = {}
    cl = make_cluster(num_nodes=2, slices_per_node=1, images=images,
                      policy=Policy.PRE_MG, mem_cap_bytes=mem_cap_bytes,
                      ckpt_root=ckpt_root, device=device)
    orch = cl.orchestrator
    orch.start(tick_interval=0.01)
    try:
        orch.submit("train-small", priority=0)
        orch.submit("serve-small", priority=1)
        ok = orch.wait_all(timeout=timeout_s)
        print("all done:", ok)
        for cid, d in orch.deployments.items():
            print(" ", cid, d.status)
    finally:
        orch.stop()
        cl.stop()
    out["deployments"] = {c: d.status for c, d in orch.deployments.items()}
    _check(ok and set(out["deployments"].values()) == {"done"},
           f"deployments {out['deployments']}")

    cl2 = make_cluster(num_nodes=2, slices_per_node=1, images=images,
                       mem_cap_bytes=mem_cap_bytes, ckpt_root=ckpt_root,
                       device=device)
    try:
        rt = cl2.nodes["node0"].runtime
        rec = rt.create("m1", images["train-small"])
        rt.start("m1")
        # evict a task that is running: wait for its first step
        _await_step(rec, 1, timeout_s)
        stats = rt.evict("m1")
        print("evict stats:", {k: round(v, 4) if isinstance(v, float) else v
                               for k, v in stats.items()})
        _check(rt.status("m1") is TaskStatus.EVICTED,
               f"m1 {rt.status('m1')} after its evict")
        rt2 = cl2.nodes["node1"].runtime
        rt2.resume("m1", source=rt)
        st = rt2.wait("m1", timeout=timeout_s)
        print("after migrate:", st, "final step:",
              rt2.tasks["m1"].guest_state.step)
        _check(st is TaskStatus.DONE, f"m1 {st} after its migration")
        out["migrated"] = {"status": st.value,
                           "step": rt2.tasks["m1"].guest_state.step}
        rt.tasks.pop("c1", None)
        rt.create("c1", ckpt_image)
        rt.start("c1")
        path = rt.checkpoint("c1")
        print("ckpt:", path)
        rt.kill("c1")
        rt2.restore("c2", path)
        st = rt2.wait("c2", timeout=timeout_s)
        print("restored task:", st, rt2.tasks["c2"].guest_state.step)
        _check(st is TaskStatus.DONE, f"c2 {st} after its restore")
        out["restored"] = {"status": st.value, "snapshot": path,
                           "step": rt2.tasks["c2"].guest_state.step}
    finally:
        cl2.stop()
    print("CLUSTER SMOKE OK")
    out["ok"] = True
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mem-cap-gib", type=float, default=8.0)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    a = ap.parse_args()
    main(mem_cap_bytes=int(a.mem_cap_gib * (1 << 30)), device=a.device)
