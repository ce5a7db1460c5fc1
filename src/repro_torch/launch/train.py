"""Training driver: a model trained for a few steps, natively or *under
the Funky runtime*.  The port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch yi-9b-smoke --steps 20 --batch 8 --seq 64 --chunks 4 \\
        --device cpu

Under Funky (the default) the training loop is a ``TrainTask`` guest whose
every device interaction flows through its monitor (one microbatch an
EXECUTE), so it is preemptible and checkpointable.  ``--native`` calls
``make_train_step`` directly (the port's counterpart of the reference's
jitted step): the pair is the paper's Fig 4 virtualisation-overhead
experiment.  Both draw their weights from ``--seed`` and report
``final_loss``, the last microbatch's loss; the task draws its batches
from seed 0, as the reference's does, so at ``--seed 0`` the two train on
the same batches and end on the same bits.  ``--device`` defaults to the
card.
"""

from __future__ import annotations

import argparse
import tempfile
import time

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import TaskImage, TaskStatus, make_cluster
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.serve import MEM_CAP_BYTES
from repro_torch.models import build_model
from repro_torch.train import (DataConfig, OptConfig, make_batch,
                               make_train_state, make_train_step)


def opt_config(args) -> OptConfig:
    return OptConfig(warmup_steps=10, decay_steps=max(args.steps, 20))


def run_native(args) -> dict:
    cfg = get_arch(args.arch)
    dev = resolve_device(args.device)
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    bundle = build_model(cfg)
    oc = opt_config(args)
    params, opt = make_train_state(bundle, oc, args.seed, device=dev)
    step = make_train_step(bundle, oc, num_microbatches=args.chunks)
    t0 = time.perf_counter()
    losses = []
    for i in range(args.steps):
        batch = make_batch(cfg, shape, i, DataConfig(seed=args.seed))
        params, opt, m = step(params, opt, batch)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            losses.append(float(m["loss"]))
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"lr {float(m['lr']):.2e}", flush=True)
    synchronize(dev)
    dt = time.perf_counter() - t0
    return {"seconds": dt, "loss_first": losses[0], "loss_last": losses[-1],
            "final_loss": float(m.get("last_loss", m["loss"]))}


def run_funky(args) -> dict:
    image = TaskImage(
        name="cli-train", kind="train", arch=args.arch, seq_len=args.seq,
        global_batch=args.batch, total_steps=args.steps, chunks=args.chunks,
        seed=args.seed, opt=opt_config(args))
    with tempfile.TemporaryDirectory(prefix="funky-train-") as root:
        cluster = make_cluster(num_nodes=1, slices_per_node=1,
                               images={"cli-train": image},
                               mem_cap_bytes=MEM_CAP_BYTES,
                               ckpt_root=root, device=args.device)
        try:
            rt = cluster.nodes["node0"].runtime
            t0 = time.perf_counter()
            rt.create("train0", image)
            rt.start("train0")
            status = rt.wait("train0", timeout=36000)
            dt = time.perf_counter() - t0
            rec = rt.tasks["train0"]
            if status is not TaskStatus.DONE:
                raise SystemExit(f"task ended {status}: {rec.error}")
            mon = rec.monitor
            out = {"seconds": dt, "steps": rec.guest_state.step,
                   "final_loss": rec.guest_state.user.get("final_loss"),
                   "n_execute": int(mon.metrics["n_EXECUTE"]),
                   "n_transfer": int(mon.metrics["n_TRANSFER"])}
            rt.delete("train0")
            del rec, mon
        finally:
            cluster.stop()
    print(f"done: {out['steps']} steps in {dt:.1f}s | "
          f"final_loss={out['final_loss']:.4f} | "
          f"requests: EXECUTE={out['n_execute']} "
          f"TRANSFER={out['n_transfer']}", flush=True)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b-smoke")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--native", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = run_native(args) if args.native else run_funky(args)
    print(out, flush=True)
    return out


if __name__ == "__main__":
    main()
