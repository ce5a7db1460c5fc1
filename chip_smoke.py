#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # all phases, one CUDA card

Phases (any failure raises and exits non-zero; no phase's failure is
caught):

1. environment: card name and power limit, torch/CUDA versions, and the
   parallel ``nvcc`` build of every kernel from ``src/repro_torch/kernels``;
2. kernels against their plain PyTorch versions on the card, at the serving
   path's shapes, bf16 and f32, with the tolerances below; times of kernel,
   plain version and PyTorch's ``scaled_dot_product_attention`` (a yardstick
   only: the port never calls it) beside each kernel's bound;
3. serving at full width: ``FunkyRuntime`` -> ``FunkyCL`` -> ``Monitor``
   serves full-width yi-9b (random weights from a seed) to DONE; the kernel
   launch counts must rise by 48 per prefill and 48 per decoded token;
4. kernel path against plain path at full width (prefill + 4 decode steps
   on one set of weights), after phase 3's weights are freed;
5. where the time goes at full width: a warm prefill and warm decode steps
   of the kernel path, timed, then traced with ``torch.profiler`` (device
   busy share, launches, the kernels that take the device time);
6. evict/resume on the card at yi-9b-smoke: tokens equal an uninterrupted
   run and the plain greedy loop.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches on the main path and its numbers.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
PEAK_BYTES_S = 3.35e12                       # H100 SXM HBM3
PEAK_FLOP_S = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 / f32 (no TF32)
# kernel vs plain version: |kernel - plain| <= ATOL + RTOL * |plain|, by
# (kernel, dtype).  The plain version rounds scores and probabilities to the
# working type where the kernels keep f32, so bf16 differs by a few bf16
# ulps.  K2's largest errors sit in the first causal rows, which average few
# keys and so have outputs of order 1; K1 averages 256-640 slots, its
# outputs are about 0.05, and its bound is tighter.
TOL = {("K1", "bfloat16"): (5e-3, 1e-2), ("K2", "bfloat16"): (2e-2, 2e-2),
       ("K1", "float32"): (1e-4, 1e-4), ("K2", "float32"): (1e-4, 1e-4)}
LOGIT_REL_TOL = 5e-2     # phase 4: max|logit diff| / max|logit|, bf16
PHASES = ("env", "kernels", "serve", "parity", "profile", "evict")


def log(**kw):
    print(json.dumps(kw, default=str), flush=True)


def bench_ms(fn, arg_sets, reps=20, warmup=2):
    """Median over ``reps`` rounds of the mean time of one call, cycling
    through ``arg_sets`` (distinct inputs, so a call does not find the
    previous call's operands in L2)."""
    import torch

    for _ in range(warmup):
        for a in arg_sets:
            fn(*a)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for a in arg_sets:
            fn(*a)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / len(arg_sets))
    return statistics.median(times)


def check_close(name, out, ref, dtype):
    import torch

    atol, rtol = TOL[name.split()[0], dtype]
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (o - r).abs()
    bad = err > atol + rtol * r.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max abs err {err.max().item()}")
    return err.max().item()


# ---------------------------------------------------------------------------
# 1. environment and build
# ---------------------------------------------------------------------------

def phase_env(state):
    import torch

    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    state["card"] = smi
    print(smi, flush=True)
    t0 = time.perf_counter()
    per_source = build.build()
    wall = time.perf_counter() - t0
    ptxas = {n: [l.strip() for l in rep.splitlines()
                 if "registers" in l or "spill" in l]
             for n, rep in build.ptxas_report.items()}
    log(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), card=smi,
        build_wall_s=wall, build_s=per_source, ptxas=ptxas,
        sources=[str(build.CSRC / f"{n}.cu") for n in build.SOURCES])


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def _flash_case(state, tag, B, S, Hq, Hkv, hd, dtype, causal=True, window=0,
                softcap=0.0, time_it=False):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device="cuda").manual_seed(SEED)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((B, S, H, hd), generator=g, device="cuda").to(dt)
               for H in (Hq, Hkv, Hkv))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = flash_attention(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = check_close(f"K2 {tag}", out, ref, dtype)
    rec = {"case": tag, "shape": [B, S, Hq, Hkv, hd], "dtype": dtype,
           "max_abs_err": err, **kw}
    if time_it:
        # visible (q, k) pairs per head: causal rows see i+1 keys
        vis = sum(min(i + 1, window) if window else i + 1 for i in range(S)) \
            if causal else S * S
        flops = 4 * hd * B * Hq * vis
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bound = max(flops / PEAK_FLOP_S[dtype], nbytes / PEAK_BYTES_S) * 1e3
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rec.update(
            ms=bench_ms(lambda: flash_attention(q, k, v, **kw), [()]),
            plain_ms=bench_ms(lambda: flash_attention_ref(q, k, v, **kw),
                              [()], reps=5),
            library_ms=bench_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), [()]),
            bound_ms=bound,
            bound_by="operations" if flops / PEAK_FLOP_S[dtype]
            > nbytes / PEAK_BYTES_S else "bytes")
    log(phase="kernels", kernel="K2 flash_attention", **rec)
    state.setdefault("k2", {})[tag] = rec


def _ring_kv_pos(cap, pos):
    """kv_pos of a ring cache after positions 0..pos were written: slot s
    holds the newest p <= pos with p % cap == s; unwritten slots 2**30."""
    import torch

    kv = torch.full((cap,), 2 ** 30, dtype=torch.int32)
    for p in range(max(0, pos - cap + 1), pos + 1):
        kv[p % cap] = p
    return kv.cuda()


def _decode_case(state, tag, B, cap, Hq, Hkv, hd, pos, dtype, window=0,
                 softcap=0.0, time_it=False):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dt = getattr(torch, dtype)
    kv_pos = _ring_kv_pos(cap, pos)
    posv = torch.tensor([pos], dtype=torch.int32, device="cuda")
    # several cache copies: timing cycles through them so each launch reads
    # its k/v from device memory, not from L2 (as in a real decode step)
    n_sets = 8
    sets = []
    for _ in range(n_sets):
        q = torch.randn((B, 1, Hq, hd), generator=g, device="cuda").to(dt)
        k = torch.randn((B, cap, Hkv, hd), generator=g, device="cuda").to(dt)
        v = torch.randn((B, cap, Hkv, hd), generator=g, device="cuda").to(dt)
        sets.append((q, k, v))
    q, k, v = sets[0]
    kw = dict(window=window, softcap=softcap)
    out = decode_attention(q, k, v, posv, kv_pos, **kw)
    ref = decode_attention_ref(q, k, v, posv, kv_pos, **kw)
    torch.cuda.synchronize()
    err = check_close(f"K1 {tag}", out, ref, dtype)
    keep = (kv_pos <= pos) & ((pos - kv_pos < window) if window
                              else torch.ones_like(kv_pos, dtype=torch.bool))
    valid = int(keep.sum())
    rec = {"case": tag, "shape": [B, cap, Hq, Hkv, hd], "pos": pos,
           "valid_slots": valid, "dtype": dtype, "max_abs_err": err, **kw}
    if time_it:
        esz = q.element_size()
        nbytes = (2 * B * valid * Hkv * hd + 2 * q.numel()) * esz + cap * 4
        flops = 4 * B * Hq * hd * valid
        bound = max(flops / PEAK_FLOP_S[dtype], nbytes / PEAK_BYTES_S) * 1e3
        mask = keep.view(1, 1, 1, cap)
        lib_sets = [(q.transpose(1, 2).contiguous(),
                     k.transpose(1, 2).contiguous(),
                     v.transpose(1, 2).contiguous()) for q, k, v in sets]
        rec.update(
            ms=bench_ms(lambda q, k, v: decode_attention(q, k, v, posv,
                                                         kv_pos, **kw), sets),
            plain_ms=bench_ms(lambda q, k, v: decode_attention_ref(
                q, k, v, posv, kv_pos, **kw), sets, reps=5),
            library_ms=bench_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), lib_sets),
            bound_ms=bound,
            bound_by="operations" if flops / PEAK_FLOP_S[dtype]
            > nbytes / PEAK_BYTES_S else "bytes")
    log(phase="kernels", kernel="K1 decode_attention", **rec)
    state.setdefault("k1", {})[tag] = rec


def phase_kernels(state):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # K2 at the prefill shape of the serving path, then the variants
    _flash_case(state, "path", 8, 512, 32, 4, 128, "bfloat16", time_it=True)
    _flash_case(state, "path_f32", 8, 512, 32, 4, 128, "float32",
                time_it=True)
    _flash_case(state, "window128", 2, 512, 32, 4, 128, "bfloat16",
                window=128)
    _flash_case(state, "softcap30", 2, 512, 32, 4, 128, "bfloat16",
                softcap=30.0)
    _flash_case(state, "ragged_f32", 2, 500, 8, 2, 64, "float32")
    _flash_case(state, "noncausal_smoke", 2, 40, 4, 4, 16, "float32",
                causal=False)
    # K1 at the decode shape: cap = 512 + 128; 'path' has unwritten slots
    # (pos 600 of 640), 'wrapped' has wrapped the ring (pos 700)
    _decode_case(state, "path", 8, 640, 32, 4, 128, 600, "bfloat16",
                 time_it=True)
    _decode_case(state, "path_f32", 8, 640, 32, 4, 128, 600, "float32",
                 time_it=True)
    _decode_case(state, "wrapped", 8, 640, 32, 4, 128, 700, "bfloat16")
    _decode_case(state, "wrapped_window256", 8, 640, 32, 4, 128, 700,
                 "bfloat16", window=256)
    _decode_case(state, "softcap30", 8, 640, 32, 4, 128, 600, "bfloat16",
                 softcap=30.0)
    _decode_case(state, "smoke_f32", 2, 136, 4, 4, 16, 20, "float32")


# ---------------------------------------------------------------------------
# 3. serving at full width through runtime -> FunkyCL -> Monitor
# ---------------------------------------------------------------------------

def _free_cuda():
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_serve(state):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import (FunkyRuntime, SliceAllocator, TaskImage,
                                  TaskStatus)
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention

    cfg = get_arch("yi-9b")
    im = TaskImage(name="chip-smoke", kind="serve", arch="yi-9b",
                   prompt_len=512, global_batch=8, total_steps=4,
                   tokens_per_step=8, seed=SEED)
    n_tok = im.total_steps * im.tokens_per_step
    rt = FunkyRuntime("node0", SliceAllocator("node0", 1,
                                              mem_cap_bytes=64 << 30,
                                              device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    decode_attention.launches = 0
    t0 = time.perf_counter()
    rt.create("serve0", im)
    rt.start("serve0")
    status = rt.wait("serve0", timeout=600)
    wall = time.perf_counter() - t0
    launches = {"K2": flash_attention.launches,
                "K1": decode_attention.launches}
    rec = rt.tasks["serve0"]
    if status is not TaskStatus.DONE:
        raise RuntimeError(f"serve task ended {status}: {rec.error!r}")
    L = cfg.num_layers
    if launches != {"K2": L, "K1": L * n_tok}:
        raise AssertionError(f"launch counts {launches}, expected K2={L} "
                             f"(one prefill) and K1={L * n_tok}")
    last = rec.guest_state.user["last_token"]
    if len(last) != im.global_batch or not all(
            0 <= t < cfg.vocab_size for t in last):
        raise AssertionError(f"bad last tokens {last}")
    ex = rec.monitor.metrics_hist["EXECUTE"]     # init, prefill, decodes
    if len(ex) != 2 + n_tok:
        raise AssertionError(f"{len(ex)} EXECUTEs, expected {2 + n_tok}")
    decode_s = ex[2:]
    state["launches"] = launches
    log(phase="serve", arch="yi-9b", card=state.get("card"),
        batch=im.global_batch, prompt_len=im.prompt_len, new_tokens=n_tok,
        status=status.value, wall_s=wall, init_params_s=ex[0],
        prefill_s=ex[1], decode_token_s_median=statistics.median(decode_s),
        decode_tokens_per_s=im.global_batch * n_tok / sum(decode_s),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, last_token=last)
    rt.delete("serve0")
    del rec, rt
    _free_cuda()


# ---------------------------------------------------------------------------
# 4. kernel path against plain path at full width
# ---------------------------------------------------------------------------

def phase_parity(state):
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.train import make_batch

    if torch.cuda.memory_allocated() > 1e9:
        raise RuntimeError("phase 3's weights are still on the card")
    cfg = get_arch("yi-9b")
    kern = build_model(cfg)
    plain = build_model(cfg, prefill_impl="naive", decode_impl="naive")
    params = kern.init(SEED, device="cuda")
    toks = torch.as_tensor(make_batch(cfg, ShapeConfig("p", "train", 512, 8),
                                      0)["tokens"]).cuda()
    with torch.no_grad():
        lk, ck = kern.prefill_fn(params, {"tokens": toks})
        lp, cp = plain.prefill_fn(params, {"tokens": toks})
        rels, agree = [], []
        for i in range(5):
            rel = ((lk.float() - lp.float()).abs().max()
                   / lp.float().abs().max()).item()
            rels.append(rel)
            tk, tp = lk.argmax(-1), lp.argmax(-1)
            agree.append((tk == tp).float().mean().item())
            if not ((0 <= tk) & (tk < cfg.vocab_size)).all():
                raise AssertionError("token out of range")
            if i == 4:
                break
            # both paths decode the kernel path's tokens (same inputs)
            tok = tk.to(torch.int32)
            lk, ck = kern.decode_fn(params, tok, 512 + i, ck, inplace=True)
            lp, cp = plain.decode_fn(params, tok, 512 + i, cp, inplace=True)
    log(phase="parity", arch="yi-9b", dtype=cfg.dtype,
        logit_rel_err=rels, token_agreement=agree,
        bound=LOGIT_REL_TOL)
    if max(rels) > LOGIT_REL_TOL:
        raise AssertionError(f"kernel vs plain logits differ by {rels}")
    del ck, cp
    state["full_params"] = params        # reused by the profile phase
    _free_cuda()


# ---------------------------------------------------------------------------
# 5. where the time goes at full width
# ---------------------------------------------------------------------------

def _trace_summary(prof, wall_s, n):
    """Per-call device time, busy share, launches and top kernels of a
    profiled window of ``n`` calls that took ``wall_s`` on the host."""
    from torch.autograd import DeviceType

    dev, launches, top = 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = e.self_device_time_total
            dev += us
            top.append((us, e.count, e.key))
        elif e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                       "cuLaunchKernelEx", "cudaLaunchKernelExC"):
            launches += e.count
    top.sort(reverse=True)
    return {"wall_ms": wall_s * 1e3 / n, "device_ms": dev / 1e3 / n,
            "busy_share": dev / 1e6 / wall_s, "launches": launches / n,
            "top": [{"kernel": k[:90], "ms": us / 1e3 / n, "count": c / n}
                    for us, c, k in top[:8]]}


def phase_profile(state):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.train import make_batch

    cfg = get_arch("yi-9b")
    bundle = build_model(cfg)
    params = state.pop("full_params", None)
    if params is None:
        params = bundle.init(SEED, device="cuda")
    toks = torch.as_tensor(make_batch(cfg, ShapeConfig("p", "train", 512, 8),
                                      0)["tokens"]).cuda()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    run = {}

    def prefill():
        run["logits"], run["caches"] = bundle.prefill_fn(params,
                                                         {"tokens": toks})
        run["pos"] = toks.shape[1]

    def decode():
        tok = run["logits"].argmax(-1).to(torch.int32)
        run["logits"], run["caches"] = bundle.decode_fn(
            params, tok, run["pos"], run["caches"], inplace=True)
        run["pos"] += 1

    def timed(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with torch.no_grad():
        prefill()                                  # warm-up
        prefill_s = timed(prefill, 1)
        with profile(activities=acts) as prof:
            wall = timed(prefill, 1)
        pre = _trace_summary(prof, wall, 1)
        timed(decode, 3)                           # warm-up
        decode_s = timed(decode, 8) / 8
        with profile(activities=acts) as prof:
            wall = timed(decode, 4)
        dec = _trace_summary(prof, wall, 4)
    log(phase="profile", arch="yi-9b", card=state.get("card"), batch=8,
        prompt_len=512, prefill_warm_s=prefill_s,
        decode_step_warm_s=decode_s, decode_tokens_per_s_warm=8 / decode_s,
        prefill_trace=pre, decode_trace=dec)
    del params
    run.clear()
    _free_cuda()


# ---------------------------------------------------------------------------
# 6. evict/resume on the card
# ---------------------------------------------------------------------------

def phase_evict(state):
    import torch

    from repro_torch.chaos import FaultPlan, FaultSpec
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import (FunkyRuntime, SliceAllocator, TaskImage,
                                  TaskStatus)
    from repro_torch.models import build_model
    from repro_torch.serve import generate
    from repro_torch.train import make_batch

    im = TaskImage(name="evict", kind="serve", arch="yi-9b-smoke",
                   prompt_len=8, global_batch=2, total_steps=10,
                   tokens_per_step=2, seed=SEED)

    def serve(evict_at=None):
        # a delay on every EXECUTE keeps the task alive long enough to be
        # evicted between steps; it changes no value
        plan = FaultPlan([FaultSpec(site="monitor.execute", kind="delay",
                                    every=1, max_fires=10 ** 6,
                                    delay_s=0.01)])
        rt = FunkyRuntime("node0", SliceAllocator("node0", 1,
                                                  device="cuda"), chaos=plan)
        rt.create("t", im)
        rt.start("t")
        stats = None
        if evict_at is not None:
            rec = rt.tasks["t"]
            deadline = time.time() + 120
            while rec.guest_state.step < evict_at and time.time() < deadline:
                time.sleep(0.001)
            stats = rt.evict("t")
            stats["evicted_at_step"] = rec.guest_state.step
            rt.resume("t")
        status = rt.wait("t", timeout=300)
        rec = rt.tasks["t"]
        if status is not TaskStatus.DONE:
            raise RuntimeError(f"task ended {status}: {rec.error!r}")
        return rec.guest_state.user["last_token"], stats

    plain_tokens, _ = serve()
    evicted_tokens, stats = serve(evict_at=3)
    if not 0 < stats["evicted_at_step"] < im.total_steps:
        raise AssertionError(f"evict did not land mid-serve: {stats}")
    cfg = get_arch(im.arch)
    bundle = build_model(cfg)
    params = bundle.init(SEED, device="cuda")
    prompt = torch.as_tensor(make_batch(
        cfg, ShapeConfig("p", "train", im.prompt_len, im.global_batch),
        0)["tokens"]).cuda()
    n = im.total_steps * im.tokens_per_step
    oracle = generate(bundle, params, {"tokens": prompt}, n + 1)[:, n]
    log(phase="evict", arch=im.arch, tokens=plain_tokens,
        tokens_evicted=evicted_tokens, oracle=oracle.tolist(),
        evict_stats={k: v for k, v in stats.items()})
    if evicted_tokens != plain_tokens or plain_tokens != oracle.tolist():
        raise AssertionError("evict/resume changed the served tokens")


# ---------------------------------------------------------------------------

def kernel_line(state):
    """The per-kernel summary line (main-path launches from phase 3)."""
    rows = []
    for key, name, kfile, line in (
            ("k2", "flash_attention", "flash_attention", 95),
            ("k1", "decode_attention", "decode_attention", 83)):
        r = state[key]["path"]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{kfile}/kernel.py:{line}",
            "launches": state["launches"]["K2" if key == "k2" else "K1"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return {"kernels": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    state: dict = {}
    t0 = time.perf_counter()
    for p in PHASES:
        t = time.perf_counter()
        globals()[f"phase_{p}"](state)
        log(phase=p, done_s=time.perf_counter() - t)
    print(json.dumps(kernel_line(state)), flush=True)
    print(state.get("card", ""), flush=True)
    log(total_s=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
