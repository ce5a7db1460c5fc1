#!/usr/bin/env python3
"""Does a lane's decode keep its bits across batch sizes on the card?

    python3 tools/batch_invariance.py

The paged engine decodes every lane of a replica in one batch, so the
disaggregated pair (a prefill replica of 2 lanes, a decode replica of 14)
gives the tokens of the 8-lane mixed engine only if each lane's arithmetic
does not depend on the batch.  For yi-9b's decode shapes in bf16 this
prints, for each batch size, the largest difference of row 0 against the
8-row batch: the five projections and the head as the model calls them
(``x @ w`` on (B, 1, K) activations), K1's paged entry (lane 0 at 36 and
37 pages of 16, the wrapper's plan) in bf16 and in f32, and the
elementwise and reduction steps around them (RMSNorm, softmax over the
vocabulary, argmax).  Zero everywhere means batch-invariant.  The batches
run to 32: ``lm_decode_paged`` pads a replica of 1-16 lanes to 16 rows
and one of 17-32 lanes to 32, so row 0's bits at 16 against 32 rows say
whether a lane decodes alike in both.  One JSON object per line, the
card's name and power limit first.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BATCHES = (1, 2, 8, 14, 16, 17, 24, 32)
ROWS = max(BATCHES)


def log(**kw):
    print(json.dumps(kw), flush=True)


def main() -> int:
    import torch

    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_paged, paged_plan, sm_count)
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import init_norm, norm_fwd

    if not torch.cuda.is_available():
        print("batch_invariance: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    log(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rows(fn, K):
        """max|row 0 at batch B - row 0 at batch 8| for each B."""
        x = torch.randn((ROWS, 1, K), generator=g, device="cuda").to(bf)
        ref = fn(x[:8])[0].float()
        return {B: (fn(x[:B])[0].float() - ref).abs().max().item()
                for B in BATCHES}

    for name, K, N in (("wq", 4096, 4096), ("wk", 4096, 512),
                       ("w_up", 4096, 11008), ("w_down", 11008, 4096),
                       ("wo", 4096, 4096), ("lm_head", 4096, 64000)):
        w = (torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
             ).to(bf)
        log(op=name, K=K, N=N, row0_diff=rows(lambda x: x @ w, K))
    cfg = get_arch("yi-9b")
    norm = init_norm(cfg, 4096, "cuda")
    log(op="norm", row0_diff=rows(lambda x: norm_fwd(cfg, norm, x), 4096))
    log(op="softmax_argmax_64000", row0_diff=rows(
        lambda x: torch.cat([x.float().softmax(-1),
                             x.argmax(-1, keepdim=True).float()], -1),
        64000))

    # K1 paged: lane 0 (pos 517, 33 pages) in batches of 1-32 lanes, tables
    # of 36 and 37 pages of 16 over one pool, under the wrapper's plan
    ps, Hq, Hkv, hd, NP = 16, 32, 4, 128, 1200
    k = torch.randn((NP, ps, Hkv, hd), generator=g, device="cuda")
    v = torch.randn((NP, ps, Hkv, hd), generator=g, device="cuda")
    q = torch.randn((ROWS, 1, Hq, hd), generator=g, device="cuda")
    kvp = torch.arange(NP * ps, device="cuda", dtype=torch.int32).view(
        NP, ps) % (37 * ps)
    perm = torch.randperm(NP, generator=torch.Generator().manual_seed(1))
    bt = torch.full((ROWS, 37), -1, dtype=torch.int32)
    pos = torch.full((ROWS,), 517, dtype=torch.int32)
    for b in range(ROWS):
        n = 517 // ps + 1
        pages = perm[(b * n) % (NP - n):(b * n) % (NP - n) + n]
        bt[b, :n] = pages.to(torch.int32)
        kvp[pages.cuda()] = (torch.arange(n * ps, device="cuda",
                                          dtype=torch.int32)
                             .view(n, ps))
    bt, pos = bt.cuda(), pos.cuda()
    for dt in (bf, torch.float32):
        qd, kd, vd = (t.to(dt) for t in (q, k, v))
        ref = decode_attention_paged(qd[:8], kd, vd, kvp,
                                     bt[:8, :36].contiguous(),
                                     pos[:8])[0].float()
        out = {}
        for B in BATCHES:
            for mb in (36, 37):
                o = decode_attention_paged(qd[:B], kd, vd, kvp,
                                           bt[:B, :mb].contiguous(), pos[:B])
                out[f"B{B}_mb{mb}"] = {
                    "plan": list(paged_plan(B, Hkv, mb, ps, dt,
                                            sm_count(q.device))),
                    "diff": (o[0].float() - ref).abs().max().item()}
        log(op="K1_paged_lane0", dtype=str(dt).removeprefix("torch."),
            row0_diff=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
