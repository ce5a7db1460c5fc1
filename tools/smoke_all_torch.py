"""Quick all-arch smoke driver on the PyTorch port (the JAX package's
``tools/smoke_all.py``): for each of the ten archs, ``reduced``, the loss,
a prefill, one decode step and the gradient, each checked finite; one
``OK loss=...`` line an arch.  The exit code is the number of failures.

    python tools/smoke_all_torch.py                      # on the CUDA card
    python tools/smoke_all_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def make_batch(cfg, B=2, S=32, device="cpu"):
    """The reference's batch: zero tokens, unit targets, embeddings of
    0.01 in bf16."""
    dev = torch.device(device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    if cfg.family == "encdec":
        T = max(int(S * cfg.tgt_ratio), 8)
        return {"src_emb": torch.ones((B, S, cfg.d_model),
                                      dtype=torch.bfloat16,
                                      device=dev) * 0.01,
                "tgt_tokens": full((B, T), 0, torch.int32),
                "tgt_targets": full((B, T), 1, torch.int32)}
    if cfg.family == "vlm":
        return {"tokens": full((B, S), 0, torch.int32),
                "targets": full((B, S), 1, torch.int32),
                "img_emb": torch.ones((B, cfg.num_image_tokens, cfg.d_model),
                                      dtype=torch.bfloat16,
                                      device=dev) * 0.01}
    return {"tokens": full((B, S), 0, torch.int32),
            "targets": full((B, S), 1, torch.int32)}


def _wrappers():
    """The kernel wrappers by name; each counts its launches."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_paged)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    return {"K1": decode_attention, "K1p": decode_attention_paged,
            "K2": flash_attention, "K3": ssd_scan, "K4": rglru_scan}


def run_arch(cfg, params=None, device=None, seed: int = 0) -> dict:
    """Loss, prefill, one decode step and the gradient of ``cfg`` on
    ``make_batch``'s batch, with ``params`` (moved to ``device``) or
    weights from ``seed``.  Raises where one is not finite.  Returns the
    loss, the gradient's loss and the kernel launches of the prefill and
    the decode step (the loss and the gradient run the plain paths)."""
    dev = resolve_device(device)
    b = build_model(cfg)
    if params is None:
        params = b.init(seed, device=dev)
    else:
        params = tree_map(lambda t: t.to(dev), params)
    batch = make_batch(cfg, device=dev)
    with torch.no_grad():
        loss, _ = b.loss_fn(params, batch)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"loss {float(loss)}")
    if cfg.family == "encdec":
        pre_batch = {"src_emb": batch["src_emb"],
                     "tgt_tokens": batch["tgt_tokens"]}
    elif cfg.family == "vlm":
        pre_batch = {"tokens": batch["tokens"], "img_emb": batch["img_emb"]}
    else:
        pre_batch = {"tokens": batch["tokens"]}
    wrappers = _wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    with torch.no_grad():
        logits, caches = b.prefill_fn(params, pre_batch)
        tok = logits.argmax(-1).to(torch.int32)
        S0 = pre_batch.get("tgt_tokens", pre_batch.get("tokens")).shape[1]
        logits2, caches = b.decode_fn(params, tok, S0, caches)
    launches = {k: w.launches - before[k] for k, w in wrappers.items()}
    if not bool(torch.isfinite(logits).all() and
                torch.isfinite(logits2).all()):
        raise AssertionError("non-finite logits")
    grads, gloss, _ = value_and_grad(b)(params, batch)
    if not all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads)):
        raise AssertionError("non-finite grad")
    return {"loss": float(loss), "grad_loss": float(gloss),
            "launches": launches}


def main(names=None, device=None, log=print) -> dict:
    """``run_arch`` over ``names`` (default: every arch, ``reduced``);
    one line an arch.  Returns {name: result or the error's text} and the
    number of failures under ``"fails"``."""
    out, fails = {}, 0
    for name in names or list(ARCHS):
        cfg = reduced(ARCHS[name])
        try:
            out[name] = run_arch(cfg, device=device)
            log(f"{name:28s} OK  loss={out[name]['loss']:.3f}  "
                f"launches={out[name]['launches']}")
        except Exception as e:  # noqa: BLE001 - one line per failing arch
            fails += 1
            out[name] = f"{type(e).__name__}: {e}"
            log(f"{name:28s} FAIL: {out[name]}")
            traceback.print_exc(limit=4)
    out["fails"] = fails
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help="archs (default: all ten)")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    a = ap.parse_args()
    sys.exit(main(a.names, device=a.device)["fails"])
