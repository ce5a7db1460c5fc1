#!/usr/bin/env python3
"""Where the device memory of a train step goes without a mesh and on a
one-rank mesh, on one CUDA card.

    python3 tools/mesh_memory.py [policy]     # needs one card

Builds ``chip_smoke.py``'s mesh-phase train cell (yi-9b at full width, 8
of its 48 layers, seq 1024, batch 8 in 2 microbatches, ``remat="full"``)
with ``launch.steps.build_cell``, once without a mesh and once on a
(1, 1) ``("data", "model")`` mesh of a one-rank NCCL group (``policy``,
default "tp"), and runs one step of each with the allocator's history
recorded: one JSON line each with the bytes allocated before, the step's
peak, and the live blocks at that peak by the innermost frame of the
repository that allocated them (``train_memory._summarise``).  The last
line names the card and its power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("mesh_memory: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import _depth_cut, _free_cuda
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    from train_memory import _gb, _summarise

    policy = argv[0] if argv else "tp"
    shape = ShapeConfig("mesh_train", "train", 1024, 8)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        with _depth_cut("yi-9b", 8) as arch:
            cfg = get_arch(arch)
            for where, m in (("mesh_less", None), (policy, mesh)):
                _free_cuda()
                cell = build_cell(cfg, shape, m, policy=policy,
                                  num_microbatches=2)
                args = cell.materialize("cuda", 0)
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.memory._record_memory_history(
                    stacks="python", max_entries=1000000)
                out = cell.fn(*args)
                torch.cuda.synchronize()
                snap = torch.cuda.memory._snapshot()
                torch.cuda.memory._record_memory_history(enabled=None)
                print(json.dumps({"step": where, "before_gb": _gb(before),
                                  "peak_gb": _gb(
                                      torch.cuda.max_memory_allocated())}),
                      flush=True)
                _summarise(snap)
                del cell, args, out, snap
    finally:
        dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
