"""Checkpoint and restore on the PyTorch port (paper §3.5;
``examples/checkpoint_restore.py`` of the JAX package): a snapshot of a
running training job, a simulated node failure, and the job restored on
the surviving node, ending with the bits of an uninterrupted run.

    python examples_torch/checkpoint_restore.py            # on the CUDA card
    python examples_torch/checkpoint_restore.py --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import TaskImage, TaskStatus, make_cluster  # noqa: E402

IMAGE = TaskImage(name="job", kind="train", arch="yi-9b-smoke", seq_len=32,
                  global_batch=4, total_steps=12, chunks=2, seed=42)


def _image(image, arch):
    return image if arch is None else dataclasses.replace(image, arch=arch)


def _await(cond, what, timeout_s, failed=lambda: None):
    """Polls ``cond`` every millisecond; raises on ``failed()`` (a message)
    or after ``timeout_s``."""
    deadline = time.time() + timeout_s
    while not cond():
        why = failed()
        if why:
            raise RuntimeError(f"checkpoint_restore: {why} waiting for "
                               f"{what}")
        if time.time() > deadline:
            raise RuntimeError(f"checkpoint_restore: timed out waiting for "
                               f"{what}")
        time.sleep(0.001)


def uninterrupted(image: TaskImage = IMAGE, arch: str = None,
                  mem_cap_bytes: int = 8 << 30, device=None,
                  ckpt_root: str = None):
    """``final_params`` of one uninterrupted run of the image on one node."""
    image = _image(image, arch)
    cluster = make_cluster(num_nodes=1, slices_per_node=1,
                           images={image.name: image},
                           mem_cap_bytes=mem_cap_bytes, ckpt_root=ckpt_root,
                           device=device)
    try:
        rt = cluster.nodes["node0"].runtime
        rt.create("ref", image)
        rt.start("ref")
        rec = rt.tasks["ref"]
        if rt.wait("ref", timeout=3600) is not TaskStatus.DONE:
            raise RuntimeError(f"checkpoint_restore: the uninterrupted run "
                               f"ended {rec.status}: {rec.error!r}")
        return rec.guest_state.user["final_params"]
    finally:
        cluster.stop()


def main(image: TaskImage = IMAGE, arch: str = None,
         mem_cap_bytes: int = 8 << 30, device=None, ckpt_root: str = None,
         timeout_s: float = 3600.0) -> dict:
    """Runs the job on two nodes, checkpoints it once its guest took a
    step, fails its node and waits for the restored job to finish on the
    other.  Returns what it prints and the recovered ``final_params``."""
    image = _image(image, arch)
    cluster = make_cluster(num_nodes=2, slices_per_node=1,
                           images={image.name: image},
                           mem_cap_bytes=mem_cap_bytes, ckpt_root=ckpt_root,
                           device=device)
    orch = cluster.orchestrator
    rt_by_node = {n: nd.runtime for n, nd in cluster.nodes.items()}
    orch.start(tick_interval=0.02)
    try:
        cid = orch.submit(image.name)

        def rec():
            node = orch._sched_tasks[cid].node_id
            return None if node is None else rt_by_node[node].tasks.get(cid)

        def failed():
            r = rec()
            if orch.deployments[cid].status == "failed" or (
                    r is not None and r.status is TaskStatus.FAILED):
                return f"{cid} failed: {r.error if r else None!r}"
            return None

        # the task has made progress once its guest took a step
        _await(lambda: rec() is not None and rec().guest_state.step >= 1,
               "the first step", timeout_s, failed)
        node = orch._sched_tasks[cid].node_id
        print(f"task running on {node}; taking a checkpoint...")
        t0 = time.perf_counter()
        path = orch.checkpoint(cid)
        ckpt_s = time.perf_counter() - t0
        snap_step = int(path.rsplit("-step", 1)[1])
        print(f"  snapshot at {path}")

        print(f"simulating failure of {node}...")
        t0 = time.perf_counter()
        orch.handle_node_failure(node)
        if not orch.wait_all(timeout=timeout_s):
            raise RuntimeError("checkpoint_restore: the job did not finish")
        recover_s = time.perf_counter() - t0
        d = orch.deployments[cid]
        print(f"task status after recovery: {d.status}")

        out = {"arch": image.arch, "failed_node": node, "snapshot": path,
               "snapshot_step": snap_step, "checkpoint_s": ckpt_s,
               "recover_s": recover_s, "status": d.status,
               "restored": [e[2] for e in orch.events
                            if e[1] == "restored"],
               "recovered_node": None, "step": None, "final_loss": None,
               "final_params": None}
        for n, rt in rt_by_node.items():
            r = rt.tasks.get(cid)
            if n != node and r is not None and \
                    r.status is TaskStatus.DONE:
                out.update(recovered_node=n, step=r.guest_state.step,
                           final_loss=r.guest_state.user["final_loss"],
                           final_params=r.guest_state.user["final_params"])
                print(f"recovered on {n}: completed step "
                      f"{out['step']}/{image.total_steps}, "
                      f"loss {out['final_loss']:.4f}")
        if out["step"] != image.total_steps or d.status != "done":
            raise RuntimeError(f"checkpoint_restore: no task recovered to "
                               f"step {image.total_steps} on a surviving "
                               f"node ({d.status}, {out['restored']})")
        return out
    finally:
        orch.stop()
        cluster.stop()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=IMAGE.arch)
    ap.add_argument("--mem-cap-gib", type=float, default=8.0)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    a = ap.parse_args()
    main(arch=a.arch, mem_cap_bytes=int(a.mem_cap_gib * (1 << 30)),
         device=a.device)
