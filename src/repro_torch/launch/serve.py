"""Serving driver: batched greedy decoding under the Funky runtime.  The
port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-8b-smoke --batch 4 --prompt-len 16 --tokens 64 \\
        --device cpu

The task is a ``ServeTask`` image (``kind="serve"``) run to DONE through
``make_cluster`` -> ``FunkyRuntime``: on the card its prefill runs K2 on
every attention layer and each decoded token K1 (the plain versions on
the CPU).  ``--device`` defaults to the card.
"""

from __future__ import annotations

import argparse
import statistics
import tempfile
import time

from repro_torch.core import TaskImage, TaskStatus, make_cluster

# the task's slice: room for a full-width model on one card
MEM_CAP_BYTES = 64 << 30


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--tokens-per-step", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def image_of(args: argparse.Namespace) -> TaskImage:
    steps = max(args.tokens // args.tokens_per_step, 1)
    return TaskImage(
        name="cli-serve", kind="serve", arch=args.arch,
        global_batch=args.batch, prompt_len=args.prompt_len,
        total_steps=steps, tokens_per_step=args.tokens_per_step)


def main(argv=None) -> dict:
    """Serves the image to DONE; prints and returns its record: tokens
    decoded, wall seconds and tokens/s, the monitor's EXECUTE seconds of
    the prefill and of each decode step (one token for the batch), and
    each lane's last token."""
    args = parse_args(argv)
    image = image_of(args)
    with tempfile.TemporaryDirectory(prefix="funky-serve-") as root:
        cluster = make_cluster(num_nodes=1, slices_per_node=1,
                               images={"cli-serve": image},
                               mem_cap_bytes=MEM_CAP_BYTES,
                               ckpt_root=root, device=args.device)
        try:
            rt = cluster.nodes["node0"].runtime
            t0 = time.perf_counter()
            rt.create("serve0", image)
            rt.start("serve0")
            status = rt.wait("serve0", timeout=36000)
            dt = time.perf_counter() - t0
            rec = rt.tasks["serve0"]
            if status is not TaskStatus.DONE:
                raise SystemExit(f"task ended {status}: {rec.error}")
            ex = rec.monitor.metrics_hist["EXECUTE"]  # init, prefill, decodes
            last = rec.guest_state.user.get("last_token")
            rt.delete("serve0")
            del rec
        finally:
            cluster.stop()
    n_tok = image.total_steps * image.tokens_per_step * image.global_batch
    out = {"arch": args.arch, "device": args.device, "batch": args.batch,
           "prompt_len": args.prompt_len,
           "new_tokens": image.total_steps * image.tokens_per_step,
           "tokens": n_tok, "seconds": dt, "tokens_per_s": n_tok / dt,
           "init_s": ex[0], "prefill_s": ex[1],
           "decode_step_s_median": statistics.median(ex[2:]),
           "decode_tokens_per_s": n_tok / sum(ex[2:]),
           "last_token": last}
    print(f"decoded {n_tok} tokens in {dt:.1f}s ({n_tok / dt:.1f} tok/s) | "
          f"last tokens: {last}", flush=True)
    return out


if __name__ == "__main__":
    main()
