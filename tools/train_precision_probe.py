#!/usr/bin/env python3
"""Where an f32 training forward on the card leaves the CPU's, and the
exact answer.

    python3 tools/train_precision_probe.py [--arch yi-9b-smoke] [--e]

Runs the port's f32 ``loss_fn`` of the arch (weights from seed 0, the
training tests' batch shape: 2 x 32 tokens from ``numpy`` seed 0) on the
card and on the CPU, and in float64 on the CPU (the exact answer at f32's
needs).  A ``TorchDispatchMode`` records the output of every aten op in
order; the card's run is held op by op against the CPU's (the same op
sequence), and the script prints the first op whose relative gap
(max|card - cpu| / max|cpu|) exceeds 1e-6, the five largest gaps, the
three losses and their gaps to float64, then the loss and gradient gaps to
float64 under each matmul-precision setting the installation has (the
legacy ``allow_tf32`` flags, ``fp32_precision`` of torch >= 2.9, the BLAS
library), and a plain f32 GEMM's error against float64 (TF32 shows as
~1e-3, IEEE f32 as ~1e-6).  Nothing here imports the reference package:
``tests/test_torch_train.py::test_card_f32_loss_and_grads_against_float64``
puts the reference's loss beside these.  One JSON object per line, the
card's name and power limit first.

``--e`` also runs ``chip_smoke.py``'s train (e) at its shape (full-width
yi-9b cut to 2 layers, one row of 256 tokens): the host's CPU (model, its
AVX2 and AVX-512 flags, ATen's capability), then the CPU reference in a
child process under each kernel choice: the host's defaults in f32,
ATen and MKL pinned to AVX2 (``chip_smoke.PINNED_CPU_ENV``, the one (e)
gates against) and to AVX-512 in f32, and the AVX2 pins in float64 (the
exact answer at f32's needs), each with its loss bits, gradient digest
and seconds, and the card's f32 step against each (the gaps (e) gates
at 1e-5 and 1e-4).  Two hosts whose defaults differ print other default
digests and the same pinned ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

GAP = 1e-6


def log(**kw):
    print(json.dumps(kw, default=str), flush=True)


def _settings(torch):
    out = {"allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
           "float32_matmul_precision": torch.get_float32_matmul_precision()}
    for name, obj in (("fp32_precision", torch.backends),
                      ("matmul.fp32_precision", torch.backends.cuda.matmul),
                      ("cudnn.fp32_precision", torch.backends.cudnn)):
        out[name] = getattr(obj, "fp32_precision", "absent")
    try:
        out["blas"] = str(torch.backends.cuda.preferred_blas_library())
    except Exception as e:  # noqa: BLE001 - reported, not fatal
        out["blas"] = repr(e)
    return out


def _record(torch, fn):
    """Run ``fn`` and return (its result, [(op name, output as f64 CPU)])."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    rec = []

    class Rec(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    rec.append((str(func.overloadpacket.__name__),
                                t.detach().to("cpu", torch.float64)))
                    break
            return out

    with Rec():
        res = fn()
    return res, rec


def _gap(torch, a, b):
    if b.numel() == 0:
        return 0.0
    den = b.abs().max().item()
    return (a - b).abs().max().item() / den if den else 0.0


def train_e(torch):
    """(e) at its shape under each CPU kernel choice, against the card."""
    import os
    import tempfile

    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    from repro_torch.models import build_model
    from repro_torch.train import OptConfig, make_batch, make_chunked_train_fns
    from repro_torch.configs import ShapeConfig
    from repro_torch.tree import tree_leaves, tree_map

    tc = c.TRAIN
    log(cpu=c.cpu_host(),
        cpu_capability=torch.backends.cpu.get_cpu_capability(),
        torch_threads=torch.get_num_threads())
    cfg = c._train_e_cfg(tc["arch"], tc["e_layers"])
    bundle = build_model(cfg)
    grad_init, grad_step, _ = make_chunked_train_fns(bundle, OptConfig())
    batch = make_batch(cfg, ShapeConfig("e", "train", tc["e_seq"], 1), 0)
    p = tree_map(lambda x: x.cuda(), bundle.init(c.SEED, device="cpu"))
    g_card, l_card = grad_step(p, grad_init(p), batch)
    g_card = [t.cpu() for t in tree_leaves(g_card)]
    del p
    avx512 = {"ATEN_CPU_CAPABILITY": "avx512", "MKL_CBWR": "AVX512,STRICT",
              "OMP_NUM_THREADS": "8", "MKL_NUM_THREADS": "8"}
    runs = [("host_default_f32", {}, "float32"),
            ("pinned_avx2_f32 (the reference)", c.PINNED_CPU_ENV, "float32"),
            ("pinned_avx512_f32", avx512, "float32"),
            ("pinned_avx2_f64", c.PINNED_CPU_ENV, "float64")]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "g.pt")
        for name, env, dtype in runs:
            ref = c.finish_reference(c.start_reference(
                tc["arch"], tc["e_layers"], tc["e_seq"], path, dtype=dtype,
                env=env))
            g = torch.load(path, mmap=True, weights_only=True)
            worst = max(_gap(torch, a, b) for a, b in zip(g_card,
                                                           tree_leaves(g)))
            del g
            log(cpu_reference=name, env=env, **ref,
                card_loss=float(l_card),
                loss_rel_gap=abs(float(l_card) - ref["loss_unrounded"])
                / abs(ref["loss_unrounded"]), worst_grad_rel_gap=worst)


def main(argv=None) -> int:
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b-smoke")
    ap.add_argument("--e", action="store_true",
                    help="also chip_smoke.py's train (e) under each CPU "
                    "kernel choice")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_precision_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    log(card=card, torch=torch.__version__, cuda=torch.version.cuda,
        settings=_settings(torch))
    if args.e:              # first, under the settings chip_smoke.py keeps
        train_e(torch)
    cfg = dataclasses.replace(get_arch(args.arch), dtype="float32")
    bundle = build_model(cfg)
    params = bundle.init(0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 512, (2, 32)).astype(np.int32),
             "targets": rng.integers(0, 512, (2, 32)).astype(np.int32)}

    def run(dev, dtype):
        p = tree_map(lambda t: t.to(dev, dtype) if t.is_floating_point()
                     else t.to(dev), params)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.no_grad():
            return _record(torch, lambda: bundle.loss_fn(p, b)[0])

    loss64, _ = run("cpu", torch.float64)
    loss_cpu, rec_cpu = run("cpu", torch.float32)
    loss_card, rec_card = run("cuda", torch.float32)
    gaps, first = [], None
    for i, ((op, x), (op_c, x_c)) in enumerate(zip(rec_card, rec_cpu)):
        if op != op_c or x.shape != x_c.shape:
            raise AssertionError(f"op {i}: card {op} {tuple(x.shape)}, cpu "
                                 f"{op_c} {tuple(x_c.shape)}")
        g = _gap(torch, x, x_c)
        gaps.append((g, i, op, list(x.shape)))
        if first is None and g > GAP:
            first = {"index": i, "op": op, "shape": list(x.shape),
                     "rel_gap": g,
                     "ops_before": [r[0] for r in rec_card[max(0, i - 3):i]]}
    gaps.sort(reverse=True)
    exact = float(loss64)
    log(ops=len(rec_card), ops_cpu=len(rec_cpu), first_op_over_1e6=first,
        largest=[{"rel_gap": g, "index": i, "op": op, "shape": s}
                 for g, i, op, s in gaps[:5]])
    log(loss_f64=exact, loss_cpu=float(loss_cpu), loss_card=float(loss_card),
        cpu_rel_gap=abs(float(loss_cpu) - exact) / abs(exact),
        card_rel_gap=abs(float(loss_card) - exact) / abs(exact))

    # the loss and every gradient leaf on the card, against float64, under
    # each precision setting this installation has
    vg = value_and_grad(bundle)
    b64 = {k: torch.as_tensor(v) for k, v in batch.items()}
    p64 = tree_map(lambda t: t.double() if t.is_floating_point() else t,
                   params)
    g64, l64, _ = vg(p64, b64)
    variants = [("default", lambda: None)]
    if hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        variants += [
            ("matmul.fp32_precision=ieee", lambda: setattr(
                torch.backends.cuda.matmul, "fp32_precision", "ieee")),
            ("fp32_precision=ieee", lambda: setattr(
                torch.backends, "fp32_precision", "ieee"))]
    variants += [("allow_tf32=False", lambda: setattr(
        torch.backends.cuda.matmul, "allow_tf32", False)),
        ("blas=cublas", lambda: torch.backends.cuda.preferred_blas_library(
            "cublas")),
        ("blas=cublaslt", lambda: torch.backends.cuda.preferred_blas_library(
            "cublaslt"))]
    for name, apply in variants:
        try:
            apply()
        except Exception as e:  # noqa: BLE001 - reported, not fatal
            log(variant=name, error=repr(e))
            continue
        pc = tree_map(lambda t: t.cuda(), params)
        g, loss, _ = vg(pc, b64)
        worst = max(_gap(torch, a.cpu().double(), b)
                    for a, b in zip(tree_leaves(g), tree_leaves(g64)))
        a = torch.randn(64, 4096, generator=torch.Generator().manual_seed(1))
        w = torch.randn(4096, 4096, generator=torch.Generator().manual_seed(2))
        mm = _gap(torch, (a.cuda() @ w.cuda()).cpu().double(),
                  a.double() @ w.double())
        log(variant=name, settings=_settings(torch), loss=float(loss),
            loss_rel_gap=abs(float(loss) - float(l64)) / abs(float(l64)),
            worst_grad_rel_gap=worst, gemm_rel_gap=mm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
