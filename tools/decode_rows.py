#!/usr/bin/env python3
"""The paged decode's row count ``DECODE_ROWS``, measured at each candidate.

    python3 tools/decode_rows.py [R ...]      # default: 64 32 16 64

``lm_decode_paged`` runs every row-wise product at ``DECODE_ROWS`` rows
(a replica's lanes padded with idle rows to a multiple of it).  For each
R in turn (the first repeated last, to show the drift of one call) this
sets that default and runs ``chip_smoke.py``'s engine on yi-9b at its
engine phase's cut (12 of 48 layers, full width, weights from seed 0)
twice on a monitor (``chip_smoke._engine_wide``): at 8 lanes on run (a)'s
24 requests, and at 64 lanes on run (d)'s 64 (``ENGINE_D``).  Each prints
the decode tokens/s (tokens over the decode EXECUTEs' device seconds),
the wall, and one warm decode step with every lane busy: its ms, device
ms and busy share from a trace (``_paged_logit_check``), K1 paged's
launches by shape, and whether the first 24 requests' tokens equal the
first R's.  One JSON object per line, the card's name and power limit
first.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def log(**kw):
    print(json.dumps(kw, default=str), flush=True)


def main(argv) -> int:
    import torch

    import chip_smoke as c
    from repro_torch.models import transformer

    if not torch.cuda.is_available():
        print("decode_rows: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    log(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    c.phase_env({})
    rs = [int(a) for a in argv] or [64, 32, 16, 64]
    first = None
    with c._depth_cut(c.ENGINE["arch"], c.ENGINE["layers"]) as arch:
        for R in rs:
            transformer.DECODE_ROWS = R
            transformer.lm_decode_paged.__kwdefaults__["rows"] = R
            for tag, ec in (("8_lanes", c.ENGINE), ("64_lanes", c.ENGINE_D)):
                tokens, st, chk = c._engine_wide(arch, "cuda", ec)
                a = {r: tokens[r] for r in sorted(tokens)[:24]}
                if first is None:
                    first = a
                log(rows=R, run=tag, lanes=ec["slots"],
                    requests=ec["n_requests"],
                    decode_tokens_per_s=st["decode_tokens_per_s"],
                    wall_s=st["wall_s"], decode_steps=st["decode_steps"],
                    step_warm_ms=chk["decode_step_warm_s"] * 1e3,
                    step_device_ms=chk["decode_trace"]["device_ms"],
                    step_busy=chk["decode_trace"].get("busy_share"),
                    logit_rel_err=chk["logit_rel_err"],
                    k1p_by_shape=st["k1p_by_shape"],
                    first_24_equal_first_run=a == first)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
