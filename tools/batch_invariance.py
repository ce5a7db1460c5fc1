#!/usr/bin/env python3
"""Does a lane's decode keep its bits across batch sizes on the card?

    python3 tools/batch_invariance.py

The paged engine decodes every lane of a replica in one batch, so the
disaggregated pair (a prefill replica of 2 lanes, a decode replica of 14)
gives the tokens of the 8-lane mixed engine only if each lane's arithmetic
does not depend on the batch.  For yi-9b's decode shapes in bf16 this
prints, for each batch size, the largest difference of row 0 against the
8-row batch: the five projections and the head as a plain ``x @ w`` on
(B, 1, K) activations (``row0_diff``) and as ``lm_decode_paged`` runs
them (``row0_diff_blocked``: the batch padded with zero rows to a
multiple of ``DECODE_ROWS`` and run ``DECODE_ROWS`` rows at a time,
``layers.by_rows``), K1's paged entry (lane 0 at 36 and 37 pages of 16,
the wrapper's plan) in bf16 and in f32, the elementwise and reduction
steps around them (RMSNorm, softmax over the vocabulary, argmax), and
one full-width deepseek-moe-16b MoE block as the paged decode runs it
(``moe_fwd(live=...)`` a block of ``DECODE_ROWS`` rows at a time, at the
experts' capacity of ``max(8, live)`` slots, the live lanes' count), and
the same block at a fixed capacity of ``DECODE_ROWS`` slots
(``row0_diff_capacity_r``), with both forms' device ms at 8 and 64 live
lanes.  Zero
everywhere means batch-invariant.  The batches run to 128: at
``DECODE_ROWS`` 64 a replica of 1-64 lanes runs one block of 64 rows and
one of 65-128 two, so the blocked columns at 8 against 65 and 128 say
whether a lane decodes alike at R and 2R rows.  One JSON object per line,
the card's name and power limit first.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

BATCHES = (1, 2, 8, 14, 16, 17, 24, 32, 64, 65, 128)
ROWS = max(BATCHES)


def log(**kw):
    print(json.dumps(kw), flush=True)


def main() -> int:
    import torch

    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_paged, paged_plan, sm_count)
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import by_rows, init_norm, norm_fwd
    import chip_smoke
    from repro_torch.models import moe as M
    from repro_torch.models.layers import mlp_fwd
    from repro_torch.models.transformer import DECODE_ROWS as R

    if not torch.cuda.is_available():
        print("batch_invariance: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    log(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rows(fn, K, x=None):
        """max|row 0 at batch B - row 0 at batch 8| for each B."""
        if x is None:
            x = torch.randn((ROWS, 1, K), generator=g, device="cuda").to(bf)
        ref = fn(x[:8])[0].float()
        return {B: (fn(x[:B])[0].float() - ref).abs().max().item()
                for B in BATCHES}

    def padded(x):
        """``x`` with zero rows up to a multiple of ``R``, as the paged
        decode pads its lanes with idle rows."""
        pad = -x.shape[0] % R
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    log(decode_rows=R)
    for name, K, N in (("wq", 4096, 4096), ("wk", 4096, 512),
                       ("w_up", 4096, 11008), ("w_down", 11008, 4096),
                       ("wo", 4096, 4096), ("lm_head", 4096, 64000)):
        w = (torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
             ).to(bf)
        x = torch.randn((ROWS, 1, K), generator=g, device="cuda").to(bf)
        log(op=name, K=K, N=N, row0_diff=rows(lambda x: x @ w, K, x),
            row0_diff_blocked=rows(
                lambda x: by_rows(R, lambda xb: xb @ w, padded(x)), K, x))
    # one deepseek-moe-16b MoE block (64 experts of 1408, top 6, 2 shared)
    # as lm_decode_paged runs it: blocks of R rows, each routing its live
    # lanes at capacity max(8, live); and at a fixed capacity of R slots
    mcfg = get_arch("deepseek-moe-16b")
    m = mcfg.moe
    moe = M.init_moe(mcfg, torch.device("cuda"),
                     torch.Generator(device="cuda").manual_seed(1))

    def moe_capacity_r(xb, live):
        """``moe_fwd(live=live)`` with the experts' capacity from the
        block's R rows rather than from the live count."""
        x2d = xb.reshape(-1, xb.shape[-1])
        E, cap = m.num_experts, max(M._capacity(
            1, m.top_k, m.num_experts, m.capacity_factor), xb.shape[0])
        _, top_e, gates = M._route(x2d, moe["router"], m.top_k)
        order, slot = M._slots(top_e, cap, 0, E)
        xs = M._gather_rows(x2d, order, slot, m.top_k, E * cap)
        ys = M._experts(xs.reshape(E, cap, -1), moe["w_gate"], moe["w_up"],
                        moe["w_down"])
        out = M._combine(ys.reshape(E * cap, -1), order, slot,
                         gates).reshape(xb.shape)
        return out + mlp_fwd(M._shared_cfg(mcfg), moe["shared"], xb)

    forms = {
        "blocked": lambda xb, live: M.moe_fwd(mcfg, moe, xb, live=live,
                                              aux=False)[0],
        "capacity_r": moe_capacity_r}

    def moe_rows(form):
        def run(x):
            n, xp = x.shape[0], padded(x)
            return torch.cat([form(xp[i:i + R], min(R, n - i))
                              for i in range(0, xp.shape[0], R)])
        return run

    with torch.no_grad():
        x = torch.randn((ROWS, 1, mcfg.d_model), generator=g,
                        device="cuda").to(bf)
        block_ms = {
            f"{name}_live{live}": chip_smoke.device_ms(
                lambda: form(x[:R], live), [()])
            for name, form in forms.items() for live in (8, R)}
        log(op="moe_block_deepseek-moe-16b", rows=R,
            row0_diff_blocked=rows(moe_rows(forms["blocked"]),
                                   mcfg.d_model, x),
            row0_diff_capacity_r=rows(moe_rows(forms["capacity_r"]),
                                      mcfg.d_model, x),
            block_device_ms=block_ms)
    cfg = get_arch("yi-9b")
    norm = init_norm(cfg, 4096, "cuda")
    log(op="norm", row0_diff=rows(lambda x: norm_fwd(cfg, norm, x), 4096))
    log(op="softmax_argmax_64000", row0_diff=rows(
        lambda x: torch.cat([x.float().softmax(-1),
                             x.argmax(-1, keepdim=True).float()], -1),
        64000))

    # K1 paged: lane 0 (pos 517, 33 pages) in batches of 1-128 lanes, tables
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
