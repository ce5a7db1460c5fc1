#!/usr/bin/env python3
"""The roofline's lower bound for each serving and training cell that
``chip_smoke.py`` measures, on one H100 SXM.

    python3 tools/roofline_cells.py

``repro_torch.launch.roofline.analyze_cell`` prices each cell's step on
the meta device (nothing is computed or allocated; no card is needed):
the larger of the matrix-product FLOPs the step needs over the dtype's
peak (no recomputation; attention over the query-key pairs its mask
keeps) and the analytic HBM traffic over 3.35 TB/s.  ``op_compute_ms`` is
the plain step's own count over the same peak (the whole S x S computed
and masked).  A served prefill is one batch of ``prompt`` tokens; a
served decode step is one token for the batch over caches of ``prompt +
128`` (the ``ServeTask``'s cache margin); the train step is the ``train``
phase's cut in full (its 4 microbatches cost what one batch does).  One
JSON object per line.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.launch.roofline import analyze_cell  # noqa: E402

MARGIN = 128
# cell: (arch, layers (None: full depth), batch, prompt or seq, kinds)
CELLS = {
    "serve-yi9b": ("yi-9b", None, 8, 512, ("prefill", "decode")),
    "serve-mamba2": ("mamba2-1.3b", None, 8, 1024, ("prefill", "decode")),
    "serve-recurrentgemma": ("recurrentgemma-9b", None, 8, 2560,
                             ("prefill", "decode")),
    "serve-qwen3": ("qwen3-8b", None, 8, 512, ("prefill", "decode")),
    "serve-stablelm": ("stablelm-3b", None, 8, 512, ("prefill", "decode")),
    "serve-starcoder2": ("starcoder2-15b", None, 8, 512,
                         ("prefill", "decode")),
    "serve-deepseek-moe": ("deepseek-moe-16b", None, 8, 512,
                           ("prefill", "decode")),
    "serve-seamless": ("seamless-m4t-large-v2", None, 8, 1024,
                       ("prefill",)),
    "serve-llava": ("llava-next-mistral-7b", None, 8, 3072,
                    ("prefill", "decode")),
    "mla-deepseekv3": ("deepseek-v3-671b", 4, 8, 512, ("prefill", "decode")),
    "train-yi9b": ("yi-9b", 8, 8, 1024, ("train",)),
    "launch-qwen3": ("qwen3-8b", 18, 8, 512, ("prefill", "decode")),
}


def main() -> int:
    for cell, (arch, layers, batch, seq, kinds) in CELLS.items():
        cfg = get_arch(arch)
        if layers is not None:
            cfg = dataclasses.replace(
                cfg, num_layers=layers,
                name=f"{cfg.name}-{layers}of{cfg.num_layers}")
        for kind in kinds:
            s = seq + MARGIN if kind == "decode" else seq
            shape = ShapeConfig(f"{cell}-{kind}", kind, s, batch)
            # the train cell is run (a) of the train phase: no remat; a
            # prompt off the blockwise chunk (1024) prefills naively, at
            # the same FLOPs
            rec = analyze_cell(cfg, shape,
                               remat="none" if kind == "train" else "full",
                               prefill_impl="naive" if seq % 1024
                               else "blockwise")
            print(json.dumps({
                "cell": cell, "kind": kind, "arch": cfg.name,
                "batch": batch, "seq": s,
                "bound_ms": rec["step_seconds_lower_bound"] * 1e3,
                "bound_by": rec["bottleneck"],
                "compute_ms": rec["compute_s"] * 1e3,
                "op_compute_ms": rec["op_compute_s"] * 1e3,
                "memory_ms": rec["memory_s"] * 1e3,
                "flops": rec["required_flops"],
                "memory_bytes": rec["memory_detail"]["total"],
                "model_flops": rec["model_flops_per_device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
