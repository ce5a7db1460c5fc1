#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # all phases, one CUDA card
    python3 chip_smoke.py env engine orch    # only these: no kernels
                                             # line, last line "ok": "partial"

Phases (any failure raises and exits non-zero; no phase's failure is
caught):

1. environment: card name and power limit, torch/CUDA versions, and the
   parallel ``nvcc`` build of every kernel from ``src/repro_torch/kernels``;
2. kernels against their plain PyTorch versions on the card, at the serving
   paths' shapes, bf16 and f32, with the tolerances below: K2 and K1 at
   yi-9b's and recurrentgemma-9b's shapes (hd 128 and 256), K1's paged
   entry at the engine's decode shape (8 lanes at ragged positions over
   pages of 16 scattered through a 288-page pool), K3 at mamba2-1.3b's
   (bf16 on its mma route, f32 on the CUDA cores), K4 at
   recurrentgemma-9b's, plus ragged, small and edge cases (K1: wholly
   masked splits, one lane; K1 paged: pages of 4, an inactive lane, a
   position on a page boundary, positions past the mapped span, a window;
   K2: Sq 1/127/129/200, windows ending on a tile
   boundary, hd 16 and 64; K3: chunk 100, the smoke shape); at the path
   shapes two calls of each kernel must give the same bits; times of
   kernel (device time from a trace), plain version and, where one exists,
   a PyTorch call computing the same function (a yardstick only: the port
   never calls it) beside each kernel's bound; for K3 at bf16 also the
   CUDA-core route on the same inputs, held to the same gates (the design
   the mma route replaced, and the route of bf16 off its 16-grain);
3. serving at full width: ``FunkyRuntime`` -> ``FunkyCL`` -> ``Monitor``
   serves full-width yi-9b (random weights from a seed) to DONE; the kernel
   launch counts must rise by 48 per prefill and 48 per decoded token;
4. kernel path against plain path at full width (prefill + 4 decode steps
   on one set of weights), after phase 3's weights are freed; for the
   mamba2 and recurrentgemma paths in f32 and in bf16 (see ``_parity``);
5. where the time goes at full width: a warm prefill and warm decode steps
   of the kernel path, timed, then traced with ``torch.profiler`` (device
   busy share, launches, the kernels that take the device time);
6. evict/resume on the card at yi-9b-smoke: tokens equal an uninterrupted
   run and the plain greedy loop;
7-9. phases 3-5 for full-width mamba2-1.3b (batch 8, prompt 1024, 32
   tokens): K3 48 launches per prefill, no attention kernel;
10-12. phases 3-5 for full-width recurrentgemma-9b (batch 8, prompt 2560,
   32 tokens, so the 2048 window masks in prefill and the ring wraps in
   decode): per prefill K4 26 and K2 12 launches, per token K1 12;
13. evict/resume on the card at mamba2-1.3b-smoke and
   recurrentgemma-9b-smoke;
14. the paged continuous-batching engine at full-width yi-9b
   (``phase_engine``): 24 requests through RequestRouter ->
   EngineServeTask -> FunkyRuntime, single-step and 8 steps fused, and on
   a monitor with evict/resume every 4 iterations; identical tokens,
   exact launch counts (paged K1 48 per decode step, K2 48 per prefill,
   dense K1 none), OOM preemption and compaction, page-granular evicts,
   kernel-path logits against the plain path's, one traced decode step;
15. the CRI layer at full-width yi-9b (``phase_cri``): the same 24
   requests through NodeAgent -> ContainerEngine -> FunkyRuntime on two
   nodes of the card, with a full and an incremental checkpoint to disk
   (the second bit-flipped after publishing), evict and migrate, replicate,
   a hard failure of the replica's node with lease replay, and a restore
   that falls back to the first snapshot; run (a)'s tokens, exact launch
   counts over every replica, seconds and bytes of each operation;
16. the control plane at full-width yi-9b (``phase_orch``): ``make_cluster``
   (two nodes of two slices on the card, PRE_MG) with four mamba2-1.3b
   batch tasks, the service preempting one by Algorithm 1, a
   ``LatencySLOPolicy`` autoscaler scaling it to two replicas and back
   under an open-loop burst (``drive_engine_open_loop``, calibrated from
   run (a)), the clone's node failing while it holds leases (replay,
   resubmit), teardown; every request once, sampled tokens equal one
   engine's, exact launch counts over every engine and batch task,
   scheduler tick and decode-step seconds, threads ended and memory freed;
17. training at full width (``phase_train``): yi-9b cut to 8 of its 48
   layers, seq 1024, global batch 8 in 4 microbatches: (a) the fused
   ``make_train_step`` called directly, (b) the same image as a
   ``TrainTask`` through ``make_cluster`` -> FunkyRuntime -> FunkyCL ->
   Monitor, (c) again, evicted at chunk 2 of 4, resumed, migrated to a
   second slice at chunk 3; fig09's wait from an evict request to the park
   (4 chunks against 1, at 2 layers); (d) the three smoke archs
   checkpointed mid-accumulation and restored in a fresh runtime; (e) one
   ``grad_step`` on the card against the CPU in f32 (2 layers, seq 256).
   Gates: (b) equals (a) bit for bit, (c) equals (b), each (d) an
   uninterrupted run; (e) within 1e-5 (loss) and 1e-4 (gradients); no
   kernel launched; under 150 s and 45 GB.

Each model's weights are freed before the next model's phases.  The last
line of a run of every phase is ``{"ok": true, "device": {...}}`` (of a
subset, ``{"ok": "partial", "phases": [...], ...}``); the line before it is the card's
name and power limit, and the one before that lists every kernel with its
launches on its main path and its numbers.
"""

from __future__ import annotations

import collections
import ctypes
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
# K1 over fewer kept slots than this has outputs of order 1, where the bf16
# plain version's own rounding of the raw scores q.k (bf16 ulp 0.125 at
# |q.k| = 32, hd 256) exceeds the bf16 bound above (on the H100 it was
# 0.012 from the f32 value at pos 20, the kernel 0.005).  Such cases are
# held to the same bound against the plain version run on f32 copies of
# the same inputs.
K1_FEW_SLOTS = 256
# K3: max|y - plain| / max|plain| and max|state - plain| (absolute), as
# tests/test_kernels.py holds the Pallas kernel (f32).  In bf16 both sides
# do the same f32 math on the same bf16 inputs and round y once, so y may
# differ by one bf16 ulp (2**-8 of |y|); the state is f32 on both sides.
K3_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (8e-3, 1e-3)}
K4_TOL = 1e-4            # absolute, h and h_final (f32 in, f32 out)
LOGIT_REL_TOL = 5e-2     # parity: max|logit diff| / max|logit|, bf16
# the same in f32 (mamba2-1.3b read 5.5e-5 on the H100: the kernels' f32
# sums differ from the plain versions' only in order)
PARITY_F32_TOL = 1e-3
PHASES = ("env", "kernels", "serve", "parity", "profile", "evict",
          "serve_mamba2", "parity_mamba2", "profile_mamba2",
          "serve_recurrentgemma", "parity_recurrentgemma",
          "profile_recurrentgemma", "evict_new", "engine", "cri", "orch",
          "train")
# K1's paged entry at the engine's decode shape: one position per lane,
# between 100 and 575 (prompt 512 + 64 tokens)
ENGINE_PAGED_POS = [100, 575, 233, 512, 417, 130, 351, 498]
# the full-width serving paths: arch, prompt length, launches expected per
# prefill and per decoded token (batch 8, 4 steps of 8 tokens)
PATHS = {
    "yi": ("yi-9b", 512, {"K2": 48}, {"K1": 48}),
    "mamba2": ("mamba2-1.3b", 1024, {"K3": 48}, {}),
    "recurrentgemma": ("recurrentgemma-9b", 2560, {"K4": 26, "K2": 12},
                       {"K1": 12}),
}


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


def device_ms(fn, arg_sets, reps=10, expect=None):
    """Device time of one call: the CUDA kernels' time in a
    ``torch.profiler`` trace of ``reps`` rounds over ``arg_sets``, without
    the host dispatch that CUDA events over back-to-back calls include.
    With ``expect``, the trace must show a kernel of that name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    for _ in range(3):      # a trace has come back without its kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for a in arg_sets:
                    fn(*a)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in events)
        if us > 0:
            if expect and not any(expect in e.key for e in events):
                raise AssertionError(f"no {expect} in the trace: "
                                     f"{[e.key[:60] for e in events]}")
            return us / 1e3 / (reps * len(arg_sets))
    raise RuntimeError("three traces recorded no device time")


def check_bitwise(name, fn):
    """Two calls on the same inputs give the same bits."""
    import torch

    a, b = fn(), fn()
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: two calls on the same inputs "
                                 f"differ")
    return True


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
    # K2 builds its TMA tensor maps on every call: their host cost
    encode_ns = build.load("flash_attention", "flash_attention_tensor_map_ns",
                           [ctypes.c_void_p, ctypes.c_int])
    buf = torch.empty(1 << 20, dtype=torch.uint8, device="cuda")
    log(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), card=smi,
        build_wall_s=wall, build_s=per_source, ptxas=ptxas,
        k2_tensor_maps_ns_per_call=encode_ns(buf.data_ptr(), 10000),
        sources=[str(build.CSRC / f"{n}.cu") for n in build.SOURCES])


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def _flash_case(state, tag, B, S, Hq, Hkv, hd, dtype, causal=True, window=0,
                softcap=0.0, time_it=False, repeat=False):
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
    if time_it or repeat:
        rec["bitwise_repeat"] = check_bitwise(
            f"K2 {tag}", lambda: flash_attention(q, k, v, **kw))
    if time_it:
        # visible (q, k) pairs per head: causal rows see i+1 keys
        vis = sum(min(i + 1, window) if window else i + 1 for i in range(S)) \
            if causal else S * S
        flops = 4 * hd * B * Hq * vis
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bound = max(flops / PEAK_FLOP_S[dtype], nbytes / PEAK_BYTES_S) * 1e3
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_kw = {"is_causal": causal}
        if window:              # the same function: a windowed causal mask
            i = torch.arange(S, device="cuda")
            lib_kw = {"attn_mask": (i[None, :] <= i[:, None])
                      & (i[:, None] - i[None, :] < window)}
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, enable_gqa=True, **lib_kw)
        rec.update(
            ms=bench_ms(lambda: flash_attention(q, k, v, **kw), [()]),
            plain_ms=bench_ms(lambda: flash_attention_ref(q, k, v, **kw),
                              [()], reps=5),
            library_ms=bench_ms(lib, [()]),
            device_ms=device_ms(lambda: flash_attention(q, k, v, **kw),
                                [()]),
            library_device_ms=device_ms(lib, [()]),
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
                 softcap=0.0, time_it=False, repeat=False):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          sm_count,
                                                          split_plan)
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
    keep = (kv_pos <= pos) & ((pos - kv_pos < window) if window
                              else torch.ones_like(kv_pos, dtype=torch.bool))
    valid = int(keep.sum())
    out = decode_attention(q, k, v, posv, kv_pos, **kw)
    ref = decode_attention_ref(q, k, v, posv, kv_pos, **kw)
    rec = {"case": tag, "shape": [B, cap, Hq, Hkv, hd], "pos": pos,
           "valid_slots": valid, "dtype": dtype,
           "split": split_plan(B, Hkv, cap, sm_count(q.device)), **kw}
    if valid < K1_FEW_SLOTS and dtype != "float32":
        rec["plain_err"] = (out.float() - ref.float()).abs().max().item()
        ref = decode_attention_ref(q.float(), k.float(), v.float(), posv,
                                   kv_pos, **kw)
        rec["plain"] = "float32 copies of the inputs"
    torch.cuda.synchronize()
    rec["max_abs_err"] = check_close(f"K1 {tag}", out, ref, dtype)
    if time_it:
        rec["bitwise_repeat"] = check_bitwise(
            f"K1 {tag}", lambda: decode_attention(q, k, v, posv, kv_pos,
                                                  **kw))
        esz = q.element_size()
        nbytes = (2 * B * valid * Hkv * hd + 2 * q.numel()) * esz + cap * 4
        flops = 4 * B * Hq * hd * valid
        bound = max(flops / PEAK_FLOP_S[dtype], nbytes / PEAK_BYTES_S) * 1e3
        mask = keep.view(1, 1, 1, cap)
        lib_sets = [(q.transpose(1, 2).contiguous(),
                     k.transpose(1, 2).contiguous(),
                     v.transpose(1, 2).contiguous()) for q, k, v in sets]
        kern = lambda q, k, v: decode_attention(  # noqa: E731
            q, k, v, posv, kv_pos, **kw)
        lib = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=True)
        rec.update(
            ms=bench_ms(kern, sets),
            plain_ms=bench_ms(lambda q, k, v: decode_attention_ref(
                q, k, v, posv, kv_pos, **kw), sets, reps=5),
            library_ms=bench_ms(lib, lib_sets),
            device_ms=device_ms(kern, sets),
            library_device_ms=device_ms(lib, lib_sets),
            bound_ms=bound,
            bound_by="operations" if flops / PEAK_FLOP_S[dtype]
            > nbytes / PEAK_BYTES_S else "bytes")
    log(phase="kernels", kernel="K1 decode_attention", **rec)
    state.setdefault("k1", {})[tag] = rec


def _paged_inputs(B, ps, max_blocks, NP, Hq, Hkv, hd, pos, dtype,
                  inactive=(), n_sets=1, layers=2):
    """K1's paged entry at the engine's layout: ``n_sets`` random pools of
    NP pages stacked over ``layers`` (each page contiguous per layer; the
    kernel reads the last layer's view, pages ``layers`` pages apart) and
    one block table.  Lane b maps the pages positions 0..pos[b] need
    (capped at max_blocks) to distinct pages drawn at random from the pool;
    the rest of its row is -1.  Slots past pos[b] in its last page hold a
    stale position pos[b] + 5; unmapped pages hold position 0, which only
    a kernel that reads them would count."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 4)
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    dt = getattr(torch, dtype)
    kv_pos = np.zeros((NP, layers, ps), np.int32)
    bt = np.full((B, max_blocks), -1, np.int32)
    perm, nxt, kept, mapped = rng.permutation(NP), 0, 0, 0
    for b in range(B):
        if b in inactive:
            continue
        n = min(max_blocks, pos[b] // ps + 1)
        bt[b, :n] = perm[nxt:nxt + n]
        nxt += n
        mapped += n
        for lp, phys in enumerate(bt[b, :n]):
            p = lp * ps + np.arange(ps)
            kv_pos[phys] = np.where(p <= pos[b], p, pos[b] + 5)
            kept += int((p <= pos[b]).sum())
    if nxt > NP:
        raise ValueError("pool too small for the case")
    sets = []
    for _ in range(n_sets):
        q = torch.randn((B, 1, Hq, hd), generator=g, device="cuda").to(dt)
        k, v = (torch.randn((NP, layers, ps, Hkv, hd), generator=g,
                            device="cuda").to(dt)[:, -1] for _ in range(2))
        sets.append((q, k, v))
    kvp = torch.from_numpy(kv_pos).cuda()[:, -1]
    return (sets, kvp, torch.from_numpy(bt).cuda(),
            torch.tensor(pos, dtype=torch.int32, device="cuda"), kept,
            mapped)


def _gather_dense(q, k, v, kvp, bt, posv):
    """The reference engine's way, for comparison only: gather each lane's
    pages into a dense cache (``gather_lane``, as the plain version does),
    then dense K1 lane by lane (lanes have their own positions and kv_pos,
    which the dense entry shares across its batch)."""
    import torch

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import gather_lane

    outs = []
    for b in range(q.shape[0]):
        kd, vd, kv_pos = gather_lane(k, v, kvp, bt[b])
        outs.append(decode_attention(q[b:b + 1], kd, vd, posv[b:b + 1],
                                     kv_pos))
    return torch.cat(outs)


def _paged_case(state, tag, B, ps, max_blocks, NP, Hq, Hkv, hd, pos, dtype,
                inactive=(), window=0, time_it=False):
    import torch

    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_paged
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_paged_ref

    sets, kvp, bt, posv, kept, mapped = _paged_inputs(
        B, ps, max_blocks, NP, Hq, Hkv, hd, pos, dtype, inactive,
        n_sets=12 if time_it else 1)
    q, k, v = sets[0]
    kw = dict(window=window)
    out = decode_attention_paged(q, k, v, kvp, bt, posv, **kw)
    ref = decode_attention_paged_ref(q, k, v, kvp, bt, posv, **kw)
    live = [b for b in range(B) if b not in inactive]
    few = min(min(pos[b] + 1, max_blocks * ps) for b in live)
    rec = {"case": tag, "shape": [B, ps, max_blocks, NP, Hq, Hkv, hd],
           "pos": pos, "inactive": list(inactive), "dtype": dtype,
           "kept_slots": kept, "mapped_pages": mapped, **kw}
    if few < K1_FEW_SLOTS and dtype != "float32":
        rec["plain_err"] = (out.float() - ref.float()).abs().max().item()
        ref = decode_attention_paged_ref(q.float(), k.float(), v.float(),
                                         kvp, bt, posv, **kw)
        rec["plain"] = "float32 copies of the inputs"
    torch.cuda.synchronize()
    rec["max_abs_err"] = check_close(f"K1 paged {tag}", out, ref, dtype)
    for b in inactive:
        if out[b].abs().max().item() != 0.0:
            raise AssertionError(f"K1 paged {tag}: inactive lane {b} is "
                                 "not zeros")
    rec["bitwise_repeat"] = check_bitwise(
        f"K1 paged {tag}",
        lambda: decode_attention_paged(q, k, v, kvp, bt, posv, **kw))
    if time_it:
        esz = q.element_size()
        # k and v of the kept slots, kv_pos of the mapped pages, q, out,
        # the table and the positions
        nbytes = (2 * kept * Hkv * hd + 2 * q.numel()) * esz \
            + 4 * (mapped * ps + bt.numel() + B)
        flops = 4 * Hq * hd * kept
        bound = max(flops / PEAK_FLOP_S[dtype], nbytes / PEAK_BYTES_S) * 1e3
        args = [(q, k, v) for q, k, v in sets]
        kern = lambda q, k, v: decode_attention_paged(  # noqa: E731
            q, k, v, kvp, bt, posv, **kw)
        rec.update(
            ms=bench_ms(kern, args),
            device_ms=device_ms(kern, args, expect="decode_split_kernel"),
            plain_ms=bench_ms(lambda q, k, v: decode_attention_paged_ref(
                q, k, v, kvp, bt, posv, **kw), args, reps=5),
            gather_dense_ms=device_ms(lambda q, k, v: _gather_dense(
                q, k, v, kvp, bt, posv), args),
            library_ms=None, bytes=nbytes, flops=flops, bound_ms=bound,
            bound_by="operations" if flops / PEAK_FLOP_S[dtype]
            > nbytes / PEAK_BYTES_S else "bytes")
    log(phase="kernels", kernel="K1 decode_attention_paged", **rec)
    state.setdefault("k1p", {})[tag] = rec


def _ssd_flops_bytes(B, S, H, P, N, cs, esz):
    """Operations the chunked SSD needs (causal pairs only; C.B^T once per
    batch row and chunk, since B/C are one group) and the bytes it must
    move (x, y, B, C in the input type; dt, A and the state in f32)."""
    cs = min(cs, S)
    pairs = sum(l * (l + 1) // 2 for l in
                (min(cs, S - c0) for c0 in range(0, S, cs)))
    flops = 2 * B * pairs * N + 2 * B * H * pairs * P + 4 * B * H * S * P * N
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * esz \
        + (B * S * H + H + B * H * P * N) * 4
    return flops, nbytes


def _ssd_other_route(x, dt, A, Bm, Cm, cs):
    """K3 at bf16 on the CUDA-core route (what the bf16 path ran before the
    mma route, and what bf16 off the 16-grain takes), called through the C
    entry point on the same inputs.  It bypasses the wrapper and its
    count."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.common import raise_on_error, stream_of
    from repro_torch.kernels.ssd_scan import ops

    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    st = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    fn = build.load("ssd_scan", "ssd_scan_fwd", ops._ARGTYPES)
    raise_on_error("ssd_scan", fn(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), st.data_ptr(),
        build.DTYPE_CODES["bfloat16"], ops.ROUTES["cuda_core"], Bsz, S, H, P,
        N, min(cs, S), stream_of(x)))
    return y, st


def _ssd_gate(what, y, st, ry, rst, dtype):
    """y's max error over max |y| and the state's max absolute error against
    the plain version's; raises past ``K3_TOL`` or on a non-finite output."""
    import torch

    torch.cuda.synchronize()
    if not (torch.isfinite(y.float()).all() and torch.isfinite(st).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    y_rel = ((y.float() - ry.float()).abs().max()
             / ry.float().abs().max()).item()
    st_err = (st - rst).abs().max().item()
    y_tol, st_tol = K3_TOL[dtype]
    if y_rel > y_tol or st_err > st_tol:
        raise AssertionError(f"{what}: y rel err {y_rel} (tol {y_tol}), "
                             f"state err {st_err} (tol {st_tol})")
    return y_rel, st_err


def _ssd_case(state, tag, B, S, H, P, N, cs, dtype, time_it=False):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan.ops import route, ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    dt_ = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    # the served path's operands: dt = softplus(.) > 0, A = -exp(.) < 0
    x = randn(B, S, H, P).to(dt_)
    dt = F.softplus(randn(B, S, H))
    A = -torch.exp(randn(H) * 0.2)
    Bm, Cm = ((randn(B, S, N) * 0.3).to(dt_) for _ in range(2))
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=cs)
    ry, rst = ssd_chunked(x, dt, A, Bm, Cm, chunk=cs)
    y_rel, st_err = _ssd_gate(f"K3 {tag}", y, st, ry, rst, dtype)
    rec = {"case": tag, "shape": [B, S, H, P, N], "chunk": cs,
           "dtype": dtype, "route": route(dt_, P, N), "y_rel_err": y_rel,
           "state_abs_err": st_err,
           "max_abs_err": (y.float() - ry.float()).abs().max().item(),
           "tol": list(K3_TOL[dtype])}
    if rec["route"] == "mma":
        # the CUDA-core route, which bf16 takes off the mma route's 16-grain,
        # on the same bf16 inputs and held to the same gates
        oy, ost = _ssd_other_route(x, dt, A, Bm, Cm, cs)
        rec["cuda_core_y_rel_err"], rec["cuda_core_state_abs_err"] = \
            _ssd_gate(f"K3 {tag} (CUDA-core route)", oy, ost, ry, rst, dtype)
    if time_it:
        rec["bitwise_repeat"] = check_bitwise(
            f"K3 {tag}", lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=cs))
        flops, nbytes = _ssd_flops_bytes(B, S, H, P, N, cs, x.element_size())
        # bf16 takes the mma route, on tensor cores: the bf16 peak applies.
        # f32 runs on the CUDA cores (no TF32): the f32 peak applies.
        t_ops, t_bytes = flops / PEAK_FLOP_S[dtype], nbytes / PEAK_BYTES_S
        symbol = {"mma": "ssd_scan_mma_kernel",
                  "cuda_core": "ssd_scan_kernel"}[rec["route"]]
        rec.update(
            ms=bench_ms(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=cs), [()]),
            device_ms=device_ms(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=cs),
                                [()], expect=symbol),
            plain_ms=bench_ms(lambda: ssd_chunked(x, dt, A, Bm, Cm,
                                                  chunk=cs), [()], reps=5),
            library_ms=None, flops=flops, bytes=nbytes,
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops > t_bytes else "bytes")
        if rec["route"] == "mma":
            rec["cuda_core_device_ms"] = device_ms(
                lambda: _ssd_other_route(x, dt, A, Bm, Cm, cs), [()],
                expect="ssd_scan_kernel")
    log(phase="kernels", kernel="K3 ssd_scan", **rec)
    state.setdefault("k3", {})[tag] = rec


def _rglru_case(state, tag, B, S, W, time_it=False):
    import torch

    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    # the gates' ranges: a in (0, 1), b small
    a = torch.sigmoid(torch.randn((B, S, W), generator=g, device="cuda")) \
        * 0.98
    b = torch.randn((B, S, W), generator=g, device="cuda") * 0.1
    h, hf = rglru_scan(a, b)
    rh, rhf = rglru_scan_ref(a, b)
    torch.cuda.synchronize()
    err = max((h - rh).abs().max().item(), (hf - rhf).abs().max().item())
    if not torch.isfinite(h).all() or err > K4_TOL:
        raise AssertionError(f"K4 {tag}: max abs err {err} (tol {K4_TOL})")
    rec = {"case": tag, "shape": [B, S, W], "dtype": "float32",
           "max_abs_err": err, "tol": K4_TOL}
    if time_it:
        rec["bitwise_repeat"] = check_bitwise(f"K4 {tag}",
                                              lambda: rglru_scan(a, b))
        nbytes = 3 * B * S * W * 4 + B * W * 4
        flops = 2 * B * S * W
        t_ops = flops / PEAK_FLOP_S["float32"]
        t_bytes = nbytes / PEAK_BYTES_S
        rec.update(
            ms=bench_ms(lambda: rglru_scan(a, b), [()]),
            device_ms=device_ms(lambda: rglru_scan(a, b), [()]),
            plain_ms=bench_ms(lambda: rglru_scan_ref(a, b), [()], reps=5),
            library_ms=None, flops=flops, bytes=nbytes,
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops > t_bytes else "bytes")
    log(phase="kernels", kernel="K4 rglru_scan", **rec)
    state.setdefault("k4", {})[tag] = rec


def phase_kernels(state):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # K2 at the prefill shape of the serving path, then the variants
    _flash_case(state, "path", 8, 512, 32, 4, 128, "bfloat16", time_it=True)
    _flash_case(state, "path_f32", 8, 512, 32, 4, 128, "float32",
                time_it=True)
    # ... and at the engine's admissions: one prompt of a bucket (128, 512)
    for P in ENGINE["prompt_buckets"]:
        _flash_case(state, f"engine_p{P}", 1, P, 32, 4, 128, "bfloat16",
                    repeat=True)
    _flash_case(state, "window128", 2, 512, 32, 4, 128, "bfloat16",
                window=128)
    _flash_case(state, "softcap30", 2, 512, 32, 4, 128, "bfloat16",
                softcap=30.0)
    _flash_case(state, "ragged_f32", 2, 500, 8, 2, 64, "float32")
    _flash_case(state, "noncausal_smoke", 2, 40, 4, 4, 16, "float32",
                causal=False)
    # edges of the 64-row q tiles and 64-key kv tiles: one row, one short
    # of and one past a tile, a window ending on a tile boundary; hd 64
    # (the TMA/wgmma kernel's smallest head) and hd 16 (mma.sync route)
    for S in (1, 127, 129, 200):
        _flash_case(state, f"sq{S}", 2, S, 32, 4, 128, "bfloat16")
    _flash_case(state, "sq200_window64", 2, 200, 32, 4, 128, "bfloat16",
                window=64)
    _flash_case(state, "hd64", 2, 300, 8, 2, 64, "bfloat16", window=128)
    _flash_case(state, "hd16", 2, 300, 8, 2, 16, "bfloat16")
    _flash_case(state, "noncausal", 2, 300, 8, 2, 128, "bfloat16",
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
    # yi-9b early in decode: pos 100 of 640, the ranges past it unwritten
    _decode_case(state, "pos100", 8, 640, 32, 4, 128, 100, "bfloat16",
                 time_it=True)
    # recurrentgemma-9b's attention: hd 256, 16 q heads over one kv head,
    # window 2048; prefill of 2560 (the window masks), decode at pos 2600
    # of a 2048-slot ring (wrapped)
    _flash_case(state, "hd256_path", 8, 2560, 16, 1, 256, "bfloat16",
                window=2048, time_it=True)
    _flash_case(state, "hd256_f32", 2, 600, 16, 1, 256, "float32",
                window=256)
    _decode_case(state, "hd256_path", 8, 2048, 16, 1, 256, 2600,
                 "bfloat16", window=2048, time_it=True)
    _decode_case(state, "hd256_f32", 8, 2048, 16, 1, 256, 2600, "float32",
                 window=2048)
    # pos 20 of a 2048-slot ring: 15 of each cluster's 16 CTAs hold only
    # unwritten slots; one lane batch at recurrentgemma's decode shape
    _decode_case(state, "hd256_empty_splits", 8, 2048, 16, 1, 256, 20,
                 "bfloat16")
    _decode_case(state, "hd256_b1", 1, 2048, 16, 1, 256, 2600, "bfloat16",
                 window=2048, time_it=True)
    # K1's paged entry at the engine's decode shape: 8 lanes at ragged
    # positions over pages of 16 scattered through a 288-page pool, table
    # width 36 (prompt 512 + 64 tokens), unmapped tails; then page size 4,
    # an inactive lane, a position on a page boundary, positions past the
    # mapped span, a window
    _paged_case(state, "path", 8, 16, 36, 288, 32, 4, 128,
                ENGINE_PAGED_POS, "bfloat16", time_it=True)
    _paged_case(state, "path_f32", 8, 16, 36, 288, 32, 4, 128,
                ENGINE_PAGED_POS, "float32", time_it=True)
    _paged_case(state, "ps4_inactive_boundary", 4, 4, 40, 160, 32, 4, 128,
                [100, 64, 159, 12], "bfloat16", inactive=(1,))
    _paged_case(state, "past_span", 3, 16, 8, 32, 32, 4, 128,
                [127, 300, 4000], "bfloat16")
    _paged_case(state, "window_hd256", 2, 16, 20, 48, 16, 1, 256,
                [250, 319], "bfloat16", window=100)
    # K3 at mamba2-1.3b's prefill shape (64 heads of 64, state 128, chunk
    # 256; bf16 takes the mma route, f32 the CUDA cores), a ragged S, a
    # chunk that is not a multiple of the mma route's 64-row block, and the
    # smoke shape
    _ssd_case(state, "path", 8, 1024, 64, 64, 128, 256, "bfloat16",
              time_it=True)
    _ssd_case(state, "path_f32", 8, 1024, 64, 64, 128, 256, "float32",
              time_it=True)
    _ssd_case(state, "ragged", 2, 1000, 64, 64, 128, 256, "bfloat16")
    _ssd_case(state, "ragged_f32", 2, 1000, 64, 64, 128, 256, "float32")
    _ssd_case(state, "chunk100", 2, 1000, 64, 64, 128, 100, "bfloat16")
    _ssd_case(state, "smoke", 2, 40, 8, 16, 16, 32, "bfloat16")
    _ssd_case(state, "smoke_f32", 2, 40, 8, 16, 16, 32, "float32")
    # K4 at recurrentgemma-9b's prefill shape and a ragged S/W
    _rglru_case(state, "path", 8, 2560, 4096, time_it=True)
    _rglru_case(state, "ragged", 3, 77, 300)


# ---------------------------------------------------------------------------
# 3. serving at full width through runtime -> FunkyCL -> Monitor
# ---------------------------------------------------------------------------

def _free_cuda():
    import torch

    gc.collect()
    torch.cuda.synchronize()
    # each (thread, stream) that ran a cuBLAS call holds a workspace from
    # the caching allocator; drop them so memory_allocated counts tensors
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def _wrappers():
    """The kernel wrappers by name; each counts its launches."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_paged)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    return {"K1": decode_attention, "K1p": decode_attention_paged,
            "K2": flash_attention, "K3": ssd_scan, "K4": rglru_scan}


def _serve(state, key):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import (FunkyRuntime, SliceAllocator, TaskImage,
                                  TaskStatus)

    arch, prompt_len, per_prefill, per_token = PATHS[key]
    cfg = get_arch(arch)
    im = TaskImage(name="chip-smoke", kind="serve", arch=arch,
                   prompt_len=prompt_len, global_batch=8, total_steps=4,
                   tokens_per_step=8, seed=SEED)
    n_tok = im.total_steps * im.tokens_per_step
    rt = FunkyRuntime("node0", SliceAllocator("node0", 1,
                                              mem_cap_bytes=64 << 30,
                                              device="cuda"))
    wrappers = _wrappers()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    rt.create("serve0", im)
    rt.start("serve0")
    status = rt.wait("serve0", timeout=600)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    rec = rt.tasks["serve0"]
    if status is not TaskStatus.DONE:
        raise RuntimeError(f"serve task ended {status}: {rec.error!r}")
    expected = {k: per_prefill.get(k, 0) + n_tok * per_token.get(k, 0)
                for k in wrappers}
    if launches != expected:
        raise AssertionError(f"{arch}: launch counts {launches}, expected "
                             f"{expected} (one prefill, {n_tok} tokens)")
    last = rec.guest_state.user["last_token"]
    if len(last) != im.global_batch or not all(
            0 <= t < cfg.vocab_size for t in last):
        raise AssertionError(f"bad last tokens {last}")
    ex = rec.monitor.metrics_hist["EXECUTE"]     # init, prefill, decodes
    if len(ex) != 2 + n_tok:
        raise AssertionError(f"{len(ex)} EXECUTEs, expected {2 + n_tok}")
    decode_s = ex[2:]
    state.setdefault("launches", {})[key] = launches
    log(phase="serve", arch=arch, card=state.get("card"),
        batch=im.global_batch, prompt_len=im.prompt_len, new_tokens=n_tok,
        status=status.value, wall_s=wall, init_params_s=ex[0],
        prefill_s=ex[1], decode_token_s_median=statistics.median(decode_s),
        decode_tokens_per_s=im.global_batch * n_tok / sum(decode_s),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, last_token=last)
    rt.delete("serve0")
    del rec, rt
    _free_cuda()


def phase_serve(state):
    _serve(state, "yi")


def phase_serve_mamba2(state):
    _serve(state, "mamba2")


def phase_serve_recurrentgemma(state):
    _serve(state, "recurrentgemma")


# ---------------------------------------------------------------------------
# 4. kernel path against plain path at full width
# ---------------------------------------------------------------------------

def _logit_parity(cfg, S, alt=None):
    """The kernel path and the plain path (and ``alt``, a plain path that
    differs from it only in the order of its sums) on one set of weights:
    prefill, then 4 decode steps of the kernel path's tokens.  Returns the
    weights, max|logit - plain| / max|plain| per step for each path, and
    the kernel path's greedy-token agreement with the plain path."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.train import make_batch

    bundles = {"kernel": build_model(cfg),
               "plain": build_model(cfg, prefill_impl="naive",
                                    decode_impl="naive")}
    if alt is not None:
        bundles["alt"] = alt
    params = bundles["kernel"].init(SEED, device="cuda")
    toks = torch.as_tensor(make_batch(cfg, ShapeConfig("p", "train", S, 8),
                                      0)["tokens"]).cuda()
    rels = {k: [] for k in bundles if k != "plain"}
    agree = []
    with torch.no_grad():
        res = {k: b.prefill_fn(params, {"tokens": toks})
               for k, b in bundles.items()}
        for i in range(5):
            lp = res["plain"][0].float()
            for k in rels:
                rels[k].append(((res[k][0].float() - lp).abs().max()
                                / lp.abs().max()).item())
            tk = res["kernel"][0].argmax(-1)
            agree.append((tk == lp.argmax(-1)).float().mean().item())
            if not ((0 <= tk) & (tk < cfg.vocab_size)).all():
                raise AssertionError("token out of range")
            if i == 4:
                break
            # every path decodes the kernel path's tokens (same inputs)
            tok = tk.to(torch.int32)
            res = {k: bundles[k].decode_fn(params, tok, S + i, res[k][1],
                                           inplace=True)
                   for k in res}
    return params, rels, agree


def _parity(state, key):
    """yi-9b: the served bf16 model, kernel path within LOGIT_REL_TOL of
    the plain path.  mamba2-1.3b and recurrentgemma-9b: in f32, within
    PARITY_F32_TOL; in bf16, within LOGIT_REL_TOL or twice the plain path's
    own spread under a reordering of its sums, whichever is larger (at full
    width these random-weight models amplify one bf16 rounding flip per
    layer into several percent of the logits; see PERF.md)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    if torch.cuda.memory_allocated() > 1e9:
        raise RuntimeError("an earlier phase's weights are still on the card")
    arch, S = PATHS[key][:2]
    cfg = get_arch(arch)
    if key != "yi":
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params, rels, agree = _logit_parity(cfg32, S)
        log(phase="parity", arch=arch, dtype="float32",
            logit_rel_err=rels["kernel"], token_agreement=agree,
            bound=PARITY_F32_TOL)
        if max(rels["kernel"]) > PARITY_F32_TOL:
            raise AssertionError(f"{arch} f32: kernel vs plain logits "
                                 f"differ by {rels['kernel']}")
        del params
        _free_cuda()
    alt = None
    if key == "mamba2":         # the same scan in chunks of 128, not 256
        alt = build_model(dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk_size=128)), prefill_impl="naive",
            decode_impl="naive")
    elif key == "recurrentgemma":   # online-softmax attention, 512-key blocks
        alt = build_model(cfg, prefill_impl="blockwise", decode_impl="naive",
                          prefill_chunk=512)
    params, rels, agree = _logit_parity(cfg, S, alt)
    bounds = [max(LOGIT_REL_TOL, 2 * r) for r in rels.get("alt", [0.0] * 5)]
    log(phase="parity", arch=arch, dtype=cfg.dtype,
        logit_rel_err=rels["kernel"], token_agreement=agree,
        plain_spread=rels.get("alt"), bound=bounds)
    if any(r > b for r, b in zip(rels["kernel"], bounds)):
        raise AssertionError(f"{arch}: kernel vs plain logits differ by "
                             f"{rels['kernel']} (bounds {bounds})")
    state["full_params"] = (key, params)     # reused by the profile phase
    _free_cuda()


def phase_parity(state):
    _parity(state, "yi")


def phase_parity_mamba2(state):
    _parity(state, "mamba2")


def phase_parity_recurrentgemma(state):
    _parity(state, "recurrentgemma")


# ---------------------------------------------------------------------------
# 5. where the time goes at full width
# ---------------------------------------------------------------------------

# the port's kernels in a trace, by the name of their __global__ function
KERNEL_SYMBOLS = {"K1": ("decode_split_kernel",),
                  "K2": ("flash_fwd_tma_kernel", "flash_fwd_mma_kernel",
                         "flash_fwd_kernel"),
                  "K3": ("ssd_scan_mma_kernel", "ssd_scan_kernel"),
                  "K4": ("rglru_scan_kernel",)}


def _trace_summary(prof, wall_s, n):
    """Per-call device time, busy share, launches, the port's kernels' time
    and share, and the top kernels of a profiled window of ``n`` calls that
    took ``wall_s`` on the host."""
    from torch.autograd import DeviceType

    dev, launches, top = 0.0, 0, []
    ours = {k: 0.0 for k in KERNEL_SYMBOLS}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = e.self_device_time_total
            dev += us
            top.append((us, e.count, e.key))
            for k, syms in KERNEL_SYMBOLS.items():
                if any(sym in e.key for sym in syms):
                    ours[k] += us
        elif e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                       "cuLaunchKernelEx", "cudaLaunchKernelExC"):
            launches += e.count
    top.sort(reverse=True)
    return {"wall_ms": wall_s * 1e3 / n, "device_ms": dev / 1e3 / n,
            "busy_share": dev / 1e6 / wall_s, "launches": launches / n,
            "kernels_ms": {k: us / 1e3 / n for k, us in ours.items() if us},
            "kernels_share": {k: us / dev for k, us in ours.items() if us},
            "top": [{"kernel": k[:90], "ms": us / 1e3 / n, "count": c / n}
                    for us, c, k in top[:8]]}


def timed(fn, n):
    """Host seconds of ``n`` calls of ``fn``, closed on a device sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def prefill_runner(cfg, bundle, params, S):
    """The warm prefill the profile phases time: batch 8 of ``S`` tokens
    from ``make_batch``, straight through the bundle's prefill program.
    Returns ``(prefill, run)``; each ``prefill()`` leaves the logits, the
    caches and the position in ``run``."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.train import make_batch

    toks = torch.as_tensor(make_batch(cfg, ShapeConfig("p", "train", S, 8),
                                      0)["tokens"]).cuda()
    run = {}

    def prefill():
        run["logits"], run["caches"] = bundle.prefill_fn(params,
                                                         {"tokens": toks})
        run["pos"] = toks.shape[1]

    return prefill, run


def _profile(state, key):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    arch, S = PATHS[key][:2]
    cfg = get_arch(arch)
    bundle = build_model(cfg)
    owner, params = state.pop("full_params", (None, None))
    if owner != key:
        del params
        _free_cuda()
        params = bundle.init(SEED, device="cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    prefill, run = prefill_runner(cfg, bundle, params, S)

    def decode():
        tok = run["logits"].argmax(-1).to(torch.int32)
        run["logits"], run["caches"] = bundle.decode_fn(
            params, tok, run["pos"], run["caches"], inplace=True)
        run["pos"] += 1

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
    log(phase="profile", arch=arch, card=state.get("card"), batch=8,
        prompt_len=S, prefill_warm_s=prefill_s,
        decode_step_warm_s=decode_s, decode_tokens_per_s_warm=8 / decode_s,
        prefill_trace=pre, decode_trace=dec)
    del params
    run.clear()
    _free_cuda()


def phase_profile(state):
    _profile(state, "yi")


def phase_profile_mamba2(state):
    _profile(state, "mamba2")


def phase_profile_recurrentgemma(state):
    _profile(state, "recurrentgemma")


# ---------------------------------------------------------------------------
# 6. evict/resume on the card
# ---------------------------------------------------------------------------

def _evict(arch, prompt_len):
    import torch

    from repro_torch.chaos import FaultPlan, FaultSpec
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import (FunkyRuntime, SliceAllocator, TaskImage,
                                  TaskStatus)
    from repro_torch.models import build_model
    from repro_torch.serve import generate
    from repro_torch.train import make_batch

    im = TaskImage(name="evict", kind="serve", arch=arch,
                   prompt_len=prompt_len, global_batch=2, total_steps=10,
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
        raise AssertionError(f"{arch}: evict/resume changed the served "
                             f"tokens")


def phase_evict(state):
    _evict("yi-9b-smoke", 8)


def phase_evict_new(state):
    _evict("mamba2-1.3b-smoke", 8)
    # a prompt longer than the smoke window (16): the ring wraps
    _evict("recurrentgemma-9b-smoke", 24)


# ---------------------------------------------------------------------------
# 14. the paged continuous-batching engine at full width
# ---------------------------------------------------------------------------

# full-width yi-9b served through RequestRouter -> EngineServeTask ->
# ContinuousBatchingEngine(paged) -> FunkyCL -> Monitor: 24 requests of
# 64-512 prompt tokens and 8-64 new tokens (seed 0), 8 lanes, pages of 16,
# prompt buckets 128 and 512; a pool of ENGINE["pool_pages"] pages (the
# worst case is 8 x 37) so that lanes are OOM-preempted and the pool
# compacts
ENGINE = dict(arch="yi-9b", slots=8, page_size=16, prompt_buckets=(128, 512),
              prompt_len=512, max_new_tokens=64, pool_pages=160,
              n_requests=24)


def engine_requests(vocab):
    """The engine phase's workload, from seed 0."""
    import numpy as np

    from repro_torch.serve.engine import ServeRequest

    rng = np.random.default_rng(SEED)
    out = []
    for i in range(ENGINE["n_requests"]):
        n_prompt = int(rng.integers(64, 513))
        n_new = int(rng.integers(8, 65))
        out.append(ServeRequest(
            rid=f"q{i:02d}", prompt=rng.integers(0, vocab, n_prompt).astype(
                np.int32), max_new_tokens=n_new))
    return out


def _engine_kw():
    return dict(slots=ENGINE["slots"], prompt_len=ENGINE["prompt_len"],
                max_new_tokens=ENGINE["max_new_tokens"],
                page_size=ENGINE["page_size"],
                pool_pages=ENGINE["pool_pages"],
                prompt_buckets=ENGINE["prompt_buckets"])


def _check_engine_run(tag, cfg, eng, tokens, fuse, launches, device):
    """Every request completed with its token count; the kernels the path
    launched, exactly: paged K1 once a layer per decode step run, K2 once a
    layer per prefill run (recomputations included), nothing else."""
    want = {r.rid: min(r.max_new_tokens, ENGINE["max_new_tokens"])
            for r in engine_requests(cfg.vocab_size)}
    got = {rid: len(t) for rid, t in tokens.items()}
    if got != want:
        raise AssertionError(f"engine {tag}: token counts {got}, expected "
                             f"{want}")
    if any(not 0 <= t < cfg.vocab_size for ts in tokens.values()
           for t in ts):
        raise AssertionError(f"engine {tag}: token out of range")
    pe = eng.program_execs
    steps = pe.get("decode_step", 0) + fuse * pe.get("decode_multi", 0)
    prefills = sum(n for p, n in pe.items() if p.startswith("prefill_admit"))
    L = cfg.num_layers
    expected = {"K1": 0, "K1p": L * steps, "K2": L * prefills, "K3": 0,
                "K4": 0}
    if device == "cuda" and launches != expected:
        raise AssertionError(f"engine {tag}: launch counts {launches}, "
                             f"expected {expected} ({steps} decode steps, "
                             f"{prefills} prefills)")
    return steps, prefills


def _engine_stats(eng, completed, wall, steps, prefills, launches):
    """What the run reports: latency quantiles, throughput, preemptions,
    compactions, the host/device split."""
    import numpy as np

    ttft = [c.ttft_s for c in completed]
    tbt = [t for c in completed for t in c.tbts]
    n_tok = sum(len(c.tokens) for c in completed)
    decode_prog = "decode_multi" if "decode_multi" in eng.program_execs \
        else "decode_step"
    return {"requests": len(completed), "tokens": n_tok, "wall_s": wall,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "tbt_p50_s": float(np.percentile(tbt, 50)),
            "tokens_per_s_e2e": n_tok / wall,
            "decode_tokens_per_s": (n_tok - len(completed))
            / eng.program_device_s[decode_prog],
            "decode_steps": steps, "prefills": prefills,
            "iterations": eng.iterations, "peak_active": eng.peak_active,
            "preemptions": eng.preemptions,
            "auto_compactions": eng.auto_compactions,
            "bt_delta_execs": eng.bt_delta_execs,
            "bt_full_writes": eng.bt_full_writes,
            "program_execs": eng.program_execs,
            "program_device_s": eng.program_device_s,
            "host_device_split": eng.host_device_split(),
            "launches": launches}


def _engine_served(arch, device, fuse, async_depth, tag):
    """One run through the runtime: router -> EngineServeTask -> engine.
    Returns ({rid: tokens}, stats)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import (FunkyRuntime, SliceAllocator, TaskImage,
                                  TaskStatus)
    from repro_torch.scaling.metrics import MetricsRegistry
    from repro_torch.scaling.serving import reset_router

    cfg = get_arch(arch)
    name = f"engine-{tag}"
    im = TaskImage(name=name, kind="engine-serve", arch=arch,
                   global_batch=ENGINE["slots"],
                   prompt_len=ENGINE["prompt_len"],
                   max_new_tokens=ENGINE["max_new_tokens"],
                   page_size=ENGINE["page_size"],
                   kv_pool_pages=ENGINE["pool_pages"],
                   prompt_buckets=ENGINE["prompt_buckets"],
                   total_steps=10 ** 9, seed=SEED, fuse_steps=fuse,
                   async_depth=async_depth)
    reg = MetricsRegistry()
    router = reset_router(name)
    router.registry = reg
    rt = FunkyRuntime("node0", SliceAllocator("node0", 1,
                                              mem_cap_bytes=64 << 30,
                                              device=device), telemetry=reg)
    wrappers = _wrappers()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rt.create("e", im)
    rec = rt.tasks["e"]
    rt.start("e")
    deadline = time.time() + 300
    while rec.status is TaskStatus.CREATED and time.time() < deadline:
        time.sleep(0.01)
    if rec.status is not TaskStatus.RUNNING:
        raise RuntimeError(f"engine task ended {rec.status}: {rec.error!r}")
    # the weights are drawn; the path starts with the first request
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    for r in engine_requests(cfg.vocab_size):
        router.submit(r)
    router.close()
    status = rt.wait("e", timeout=900)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    if status is not TaskStatus.DONE:
        raise RuntimeError(f"engine task ended {status}: {rec.error!r}")
    eng = rec.task.engine
    tokens = {rid: list(c.tokens) for rid, c in router.completed.items()}
    steps, prefills = _check_engine_run(tag, cfg, eng, tokens, fuse,
                                        launches, device)
    stats = _engine_stats(eng, list(router.completed.values()), wall,
                          steps, prefills, launches)
    if device == "cuda":
        stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rt.delete("e")
    del rec, rt, eng
    if device == "cuda":
        _free_cuda()
    return tokens, stats


def _paged_logit_check(eng, mon, cfg):
    """One decode step of every lane on the engine's own pool, on the
    paged kernel path and on ``impl="naive"`` (gather + sdpa_naive), on
    copies of the pool; max|logit diff| / max|logit| over the active
    lanes.  Then the kernel path's step again, warm: timed, and traced
    (device time, busy share, launches).  These launches are comparisons
    and measurements: the counts are restored."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    saved = {k: w.launches for k, w in _wrappers().items()}
    buf = {n: mon.buffers.get(n).device_value
           for n in ("params", "toks", "pos", "block_table", "kv_pool")}
    active = buf["block_table"][:, 0] >= 0
    out = {}
    with torch.no_grad():
        for impl in ("kernel", "naive"):
            b = build_model(cfg, cache_margin=0, decode_impl=impl)
            pool = tree_map(torch.clone, buf["kv_pool"])
            logits, _ = b.decode_paged_fn(buf["params"], buf["toks"][:, 0],
                                          buf["pos"], pool,
                                          buf["block_table"])
            out[impl] = logits.float()[active]
            if impl == "kernel":
                def step():
                    b.decode_paged_fn(buf["params"], buf["toks"][:, 0],
                                      buf["pos"], pool, buf["block_table"])
                step_s = timed(step, 4) / 4
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    wall = timed(step, 3)
                trace = _trace_summary(prof, wall, 3)
            del pool
    for k, w in _wrappers().items():
        w.launches = saved[k]
    ref = out["naive"]
    rel = ((out["kernel"] - ref).abs().max() / ref.abs().max()).item()
    agree = (out["kernel"].argmax(-1) == ref.argmax(-1)).float().mean()
    return {"logit_rel_err": rel, "token_agreement": agree.item(),
            "lanes": int(active.sum()), "bound": LOGIT_REL_TOL,
            "decode_step_warm_s": step_s, "decode_trace": trace}


def _prefill_logit_check(eng, mon, cfg):
    """One admission's prefill per prompt bucket, at the engine's shape
    (batch 1, the first request of the workload that the bucket takes,
    right-padded as the engine pads it), on the engine's weights: the
    kernel path (K2, one launch a layer) against ``prefill_impl="naive"``,
    max|logit diff| / max|logit| of the first token's logits.  These
    launches are comparisons: the counts are restored."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import build_model

    saved = {k: w.launches for k, w in _wrappers().items()}
    params = mon.buffers.get("params").device_value
    dev = mon.buffers.get("toks").device_value.device
    out = []
    with torch.no_grad():
        for P in eng.buckets:
            req = next(r for r in engine_requests(cfg.vocab_size)
                       if eng._pick_bucket(len(r.prompt)) == P)
            prompt = torch.as_tensor(eng._pad_prompt(req.prompt, P),
                                     device=dev)
            logits = {}
            for impl in ("kernel", "naive"):
                b = build_model(cfg, cache_margin=0, prefill_impl=impl)
                n0 = flash_attention.launches
                logits[impl] = b.prefill_fn(params,
                                            {"tokens": prompt})[0].float()
                n = flash_attention.launches - n0
                if n != (cfg.num_layers if impl == "kernel" else 0):
                    raise AssertionError(f"prefill {P} ({impl}): {n} K2 "
                                         "launches")
            ref = logits["naive"]
            out.append({"bucket": P, "rid": req.rid,
                        "prompt_tokens": len(req.prompt),
                        "logit_rel_err": ((logits["kernel"] - ref).abs().max()
                                          / ref.abs().max()).item(),
                        "same_token": bool(logits["kernel"].argmax(-1)
                                           == ref.argmax(-1)),
                        "bound": LOGIT_REL_TOL})
    for k, w in _wrappers().items():
        w.launches = saved[k]
    return out


def _engine_evicting(arch, device, logit_at=6, every=4):
    """Run (c): the same workload through the engine on a monitor, evicted
    and resumed every ``every`` iterations while lanes are in flight
    (``equivalence.run_transcript``); at iteration ``logit_at``, one
    paged-kernel-vs-plain logit check of a decode step and one of each
    bucket's prefill."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import FunkyCL, Monitor, SliceAllocator
    from repro_torch.scaling.metrics import MetricsRegistry
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.equivalence import run_transcript

    cfg = get_arch(arch)
    wrappers = _wrappers()
    evicts, checks, prefill_checks = [], [], []

    def factory():
        mon = Monitor("engine-c", SliceAllocator("node0", 1,
                                                 mem_cap_bytes=64 << 30,
                                                 device=device),
                      telemetry=MetricsRegistry())
        eng = ContinuousBatchingEngine(arch, FunkyCL(mon), seed=SEED,
                                       engine_id="engine-c", **_engine_kw())
        eng.setup()
        for w in wrappers.values():
            w.launches = 0
        return mon, eng

    def hook(eng, mon, i):
        if i == logit_at and device == "cuda":
            checks.append(_paged_logit_check(eng, mon, cfg))
            prefill_checks.extend(_prefill_logit_check(eng, mon, cfg))
        if i % every == 0 and eng.active_count:
            st = mon.evict()
            st["at_iteration"] = i
            st.update({f"resume_{k}": v for k, v in mon.resume().items()})
            evicts.append(st)

    t0 = time.perf_counter()
    tokens, eng = run_transcript(factory,
                                 lambda: engine_requests(cfg.vocab_size),
                                 step_hook=hook)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    steps, prefills = _check_engine_run("evict_resume", cfg, eng, tokens, 1,
                                        launches, device)
    stats = _engine_stats(eng, list(eng.completed.values()), wall, steps,
                          prefills, launches)
    del eng
    if device == "cuda":
        _free_cuda()
    return tokens, stats, evicts, checks, prefill_checks


def phase_engine(state, arch=ENGINE["arch"], device="cuda"):
    """Full-width yi-9b (bf16, random weights from seed 0) served by the
    paged engine three ways: (a) single-step decode and (b) 8 steps fused
    per EXECUTE with one EXECUTE in flight, both through
    RequestRouter -> EngineServeTask -> FunkyRuntime; (c) run (a) on a
    monitor with evict/resume every 4 iterations.  Gates: every request
    completes with its token count, the three transcripts are identical,
    exact launch counts, at least one OOM preemption and one compaction,
    an evict that saves fewer pages than the pool, and the logits of a
    paged decode step and of each bucket's prefill (K2 at batch 1) on the
    kernel path within LOGIT_REL_TOL of the plain path's."""
    a_tok, a = _engine_served(arch, device, 1, 0, "a")
    log(phase="engine", run="a_single_step", card=state.get("card"), **a)
    b_tok, b = _engine_served(arch, device, 8, 1, "b")
    log(phase="engine", run="b_fused8_async1", card=state.get("card"), **b)
    c_tok, c, evicts, checks, prefill_checks = _engine_evicting(arch, device)
    log(phase="engine", run="c_evict_resume_every4", card=state.get("card"),
        evicts=len(evicts), evict_first=evicts[0] if evicts else None,
        evict_last=evicts[-1] if evicts else None, logit_check=checks,
        prefill_logit_check=prefill_checks, **c)
    for tag, tok in (("b", b_tok), ("c", c_tok)):
        if tok != a_tok:
            bad = sorted(r for r in a_tok if tok.get(r) != a_tok[r])
            raise AssertionError(f"engine run {tag}: tokens differ from run "
                                 f"a for {bad}")
    if a["preemptions"] < 1 or a["auto_compactions"] < 1:
        raise AssertionError(
            f"engine run a: {a['preemptions']} preemptions, "
            f"{a['auto_compactions']} compactions (want >= 1 each: shrink "
            "the pool)")
    if not any(0 < e["paged_saved_pages"] < e["paged_total_pages"]
               for e in evicts):
        raise AssertionError("no evict saved fewer pages than the pool")
    if device == "cuda" and (not checks or checks[0]["logit_rel_err"]
                             > LOGIT_REL_TOL):
        raise AssertionError(f"paged kernel vs plain logits: {checks}")
    if device == "cuda" and (
            len(prefill_checks) != len(ENGINE["prompt_buckets"])
            or any(p["logit_rel_err"] > LOGIT_REL_TOL
                   for p in prefill_checks)):
        raise AssertionError(f"prefill kernel vs plain logits: "
                             f"{prefill_checks}")
    state.setdefault("launches", {})["engine"] = a["launches"]
    state["engine"] = {"a": a, "b": b, "c": c}
    state["engine_tokens"] = a_tok


# ---------------------------------------------------------------------------
# 15. the CRI layer: checkpoint, migrate, replicate, crash, restore
# ---------------------------------------------------------------------------

# two nodes on the one card, each with two slices of 36 GiB (node0 holds
# the clone and the restored replica at once; one replica peaks at 18.1
# GB); commands land after these many iterations of the serving replica
CRI = dict(slices=2, mem_cap=36 << 30, ckpt1_at=4, gap=4, wave1=12,
           need_bytes=20e9)


def _decode_ms(eng):
    """(decode EXECUTEs, their seconds) so far: the engine's own count."""
    return (eng.program_execs.get("decode_step", 0),
            eng.program_device_s.get("decode_step", 0.0))


def _interval_ms(a, b):
    n, s = b[0] - a[0], b[1] - a[1]
    return {"decode_steps": n, "decode_step_ms": s / n * 1e3 if n else None}


def phase_cri(state, arch=ENGINE["arch"], device="cuda"):
    """Run (a)'s workload on full-width yi-9b through NodeAgent ->
    ContainerEngine (CRI) -> FunkyRuntime -> FunkyCL -> Monitor on two
    nodes wired as ``make_cluster`` wires them (no orchestrator): deploy
    on node0; checkpoint (snapshot 1, full); checkpoint with ``ckpt.corrupt``
    armed (snapshot 2, incremental: ``params`` referenced, then a byte of
    one of its files flipped); evict and migrate to node1; replicate onto
    node0; node1 fails hard (agent down, ``crash``, the router replays the
    replica's leases); restore on node0 from the newest snapshot of both
    nodes' roots, which falls back to snapshot 1; the last 12 requests
    arrive once the restored replica runs; drain and remove both.  Gates:
    every request completes once with run (a)'s tokens, no duplicates or
    replay mismatches, exact launch counts over every replica's engine,
    snapshot 2 reuses ``params``, the restore falls back with a
    ``restore_fallback`` event.  Snapshots go under a temporary directory,
    deleted at the end."""
    import shutil
    import tempfile

    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    want = state["engine_tokens"]
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="funky-cri-")
    usage = shutil.disk_usage(root)
    log(phase="cri", ckpt_dir=root, disk_total=usage.total,
        disk_used=usage.used, disk_free=usage.free)
    try:
        if usage.free < CRI["need_bytes"]:
            raise RuntimeError(
                f"cri: {usage.free / 1e9:.1f} GB free under {root}; the "
                f"phase writes about 18.5 GB of snapshots (needs "
                f"{CRI['need_bytes'] / 1e9:.0f} GB)")
        _cri(state, cfg, arch, device, want, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if device == "cuda":
            _free_cuda()
    log(phase="cri", phase_s=time.perf_counter() - t_phase)


def _cri(state, cfg, arch, device, want, root):
    import json
    import os

    import torch

    from repro_torch.chaos import FaultPlan, FaultSpec
    from repro_torch.ckpt import snapshot_candidates
    from repro_torch.core import (ContainerEngine, FunkyRuntime, NodeAgent,
                                  SliceAllocator, TaskImage, TaskStatus)
    from repro_torch.scaling.metrics import MetricsRegistry
    from repro_torch.scaling.serving import reset_router

    name = "cri"
    im = TaskImage(name=name, kind="engine-serve", arch=arch,
                   global_batch=ENGINE["slots"],
                   prompt_len=ENGINE["prompt_len"],
                   max_new_tokens=ENGINE["max_new_tokens"],
                   page_size=ENGINE["page_size"],
                   kv_pool_pages=ENGINE["pool_pages"],
                   prompt_buckets=ENGINE["prompt_buckets"],
                   total_steps=10 ** 9, seed=SEED)
    reg = MetricsRegistry()
    plan = FaultPlan(seed=SEED, registry=reg)
    engines, agents = {}, {}
    for nid in ("node0", "node1"):
        rt = FunkyRuntime(nid, SliceAllocator(nid, CRI["slices"],
                                              mem_cap_bytes=CRI["mem_cap"],
                                              device=device),
                          ckpt_root=os.path.join(root, nid), telemetry=reg,
                          chaos=plan)
        engines[nid] = ContainerEngine(rt, {name: im}, peers=engines)
        agents[nid] = NodeAgent(nid, engines[nid], metrics=reg, chaos=plan)
    a0, a1 = agents["node0"], agents["node1"]
    rt0, rt1 = a0.engine.runtime, a1.engine.runtime
    router = reset_router(name)
    router.registry = reg
    wrappers = _wrappers()
    ops, dec = {}, {}
    watched = []                            # records that must not fail

    def op(tag, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        ops[tag] = time.perf_counter() - t
        return out

    def entry(rec, kind):
        return [e[2] for e in rec.timeline if e[1] == kind][-1]

    def wait(cond, what, timeout=900):
        deadline = time.time() + timeout
        while not cond():
            for r in watched:
                if r.status is TaskStatus.FAILED:
                    raise RuntimeError(f"cri: {r.cid} failed while waiting "
                                       f"for {what}: {r.error!r}")
            if time.time() > deadline:
                raise RuntimeError(f"cri: timed out waiting for {what}")
            time.sleep(0.01)

    def iterations(rec, n):
        s = rec.guest_state.step
        wait(lambda: rec.guest_state.step >= s + n, f"{n} iterations")

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    op("deploy", a0.deploy, "r0", name)
    r0 = rt0.tasks["r0"]
    watched.append(r0)
    wait(lambda: r0.status is TaskStatus.RUNNING, "setup")
    ops["deploy_to_running"] = time.perf_counter() - t
    # the weights are drawn; the path starts with the first request
    for w in wrappers.values():
        w.launches = 0
    reqs = engine_requests(cfg.vocab_size)
    t_serve = time.perf_counter()
    for r in reqs[:CRI["wave1"]]:
        router.submit(r)
    eng0 = r0.task.engine
    iterations(r0, CRI["ckpt1_at"])
    p1 = op("checkpoint1", a0.checkpoint, "r0")
    ck1 = entry(r0, "checkpoint")
    iterations(r0, CRI["gap"])
    plan.add(FaultSpec(site="ckpt.corrupt", kind="corrupt", at=1))
    p2 = op("checkpoint2", a0.checkpoint, "r0")
    ck2 = entry(r0, "checkpoint")
    with open(os.path.join(p2, "manifest.json")) as f:
        m2 = json.load(f)
    if (ck2["reused_buffers"] < 1 or m2["buffers"]["params"]
            != os.path.join(p1, "params")):
        raise AssertionError(f"cri: snapshot 2 did not reuse params "
                             f"({ck2}, {m2['buffers']})")
    if [f[:2] for f in plan.fired] != [("ckpt.corrupt", "corrupt")]:
        raise AssertionError(f"cri: corrupt site fired {plan.fired}")
    dec["r0_node0"] = _interval_ms((0, 0.0), _decode_ms(eng0))
    op("evict", a0.evict, "r0")
    ev = entry(r0, "evict")
    op("migrate", a1.migrate_in, "r0", name, source_node="node0")
    if rt1.tasks["r0"] is not r0 or r0.task.engine is not eng0:
        raise AssertionError("cri: the migrated replica lost its engine")
    mark = _decode_ms(eng0)
    iterations(r0, CRI["gap"])
    dec["r0_node1_alone"] = _interval_ms(mark, _decode_ms(eng0))
    op("replicate", a0.replicate_in, "r1", "r0", source_node="node1")
    r1 = rt0.tasks["r1"]
    watched.append(r1)
    rep = entry(r1, "replicated")
    mark0 = _decode_ms(eng0)
    wait(lambda: r1.task.engine is not None, "the clone's setup")
    eng1 = r1.task.engine
    iterations(r0, 2 * CRI["gap"])
    dec["r0_node1_with_r1"] = _interval_ms(mark0, _decode_ms(eng0))
    # node1 fails hard, as Orchestrator.handle_node_failure does it
    t = time.perf_counter()
    a1.fail()
    rt1.crash("r0")
    watched.remove(r0)
    replayed = router.fail_engine("r0")
    ops["node_failure"] = time.perf_counter() - t
    dec["r0_total"] = _interval_ms((0, 0.0), _decode_ms(eng0))
    roots = [rt0.ckpt_root, rt1.ckpt_root]
    newest = snapshot_candidates(roots, "r0")[0]
    if newest != p2:
        raise AssertionError(f"cri: newest snapshot {newest}, want {p2}")
    mark1 = _decode_ms(eng1)
    op("restore", a0.restore, "r0", newest)
    rr = rt0.tasks["r0"]
    watched.append(rr)
    rs, rsd = entry(rr, "restore"), entry(rr, "restored")
    fallbacks = [e for e in reg.flight_record()["events"]
                 if e[1] == "restore_fallback"]
    if rr.latest_snapshot != p1 or len(fallbacks) != 1:
        raise AssertionError(f"cri: restore used {rr.latest_snapshot} with "
                             f"{len(fallbacks)} fallbacks; want {p1}, 1")
    dec["r1_during_restore"] = _interval_ms(mark1, _decode_ms(eng1))
    for r in reqs[CRI["wave1"]:]:
        router.submit(r)
    wait(lambda: rr.task.engine is not None, "the restored replica's setup")
    eng2 = rr.task.engine
    mark1, mark2 = _decode_ms(eng1), _decode_ms(eng2)
    wait(lambda: router.outstanding() == 0, "every request")
    wall = time.perf_counter() - t_serve
    dec["r1_with_restored"] = _interval_ms(mark1, _decode_ms(eng1))
    dec["restored_with_r1"] = _interval_ms(mark2, _decode_ms(eng2))
    launches = {k: w.launches for k, w in wrappers.items()}
    drains = {}
    for cid in ("r1", "r0"):
        drains[cid] = op(f"drain_{cid}", a0.drain, cid)
        op(f"remove_{cid}", a0.remove, cid)
    rt1.delete("r0")                        # the failed node's record
    router.close()
    tokens = {rid: list(c.tokens) for rid, c in router.completed.items()}
    served = {"r0": len(eng0.completed), "r1": len(eng1.completed),
              "r0_restored": len(eng2.completed)}
    engs = (eng0, eng1, eng2)
    steps = sum(e.program_execs.get("decode_step", 0) for e in engs)
    prefills = sum(n for e in engs for p, n in e.program_execs.items()
                   if p.startswith("prefill_admit"))
    L = cfg.num_layers
    expected = {"K1": 0, "K1p": L * steps, "K2": L * prefills, "K3": 0,
                "K4": 0}
    stats = dict(
        wall_s=wall, requests=len(tokens), replayed=replayed,
        replayed_rids=sorted(router.replayed), served_by=served,
        duplicates=router.duplicates,
        replay_mismatches=router.replay_mismatches, decode_steps=steps,
        prefills=prefills, launches=launches, op_s=ops,
        checkpoint1=ck1, checkpoint2=ck2, evict=ev,
        migrate_s=ops["migrate"], replicate=rep, restore=rs,
        restored=rsd, drains=drains, decode=dec,
        node_ops={k: v for k, v in reg.snapshot()["counters"].items()
                  if k.startswith("node_ops_total")})
    if device == "cuda":
        stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(phase="cri", card=state.get("card"), **stats)
    if tokens != want:
        bad = sorted(r for r in want if tokens.get(r) != want[r])
        raise AssertionError(f"cri: tokens differ from run a for {bad}")
    if router.duplicates or router.replay_mismatches:
        raise AssertionError(f"cri: {router.duplicates} duplicates, "
                             f"{router.replay_mismatches} replay mismatches")
    if device == "cuda" and launches != expected:
        raise AssertionError(f"cri: launch counts {launches}, expected "
                             f"{expected} ({steps} decode steps, {prefills} "
                             "prefills)")
    state.setdefault("launches", {})["cri"] = launches
    state["cri"] = stats


# ---------------------------------------------------------------------------
# 16. the orchestrator: Algorithm 1, autoscaling, node failure, open loop
# ---------------------------------------------------------------------------

# make_cluster's two nodes on the one card, two 36 GiB slices each; ``svc``
# is run (a)'s engine image, ``batch`` phase 7's mamba2 ServeTask (batch
# 8, prompt 1024, 4 steps of 8 tokens) at priority 0; the load is
# fig14's live burst: base_frac x the replica rate, 4x it over the middle
# third of the horizon.  The drive keeps the router open tail_s past the
# last arrival: the autoscaler scales in once the p95 window empties, and
# a closed router would end every replica (on an H100 80GB HBM3 at 700 W
# the burst's backlog drained 42-64 s after the last arrival).  Before
# the drive, ab_requests requests of ab_tokens tokens are served with the
# scheduler's tick thread running and parked, in turns
# (``_ab_orch_threads``)
ORCH = dict(slices=2, mem_cap=36 << 30, n_batch=4, batch_steps=4,
            horizon_s=30.0, tail_s=90.0, tokens_range=(8, 65),
            base_frac=0.3, burst=4.0, slo_mult=2.0, asc_interval_s=0.25,
            down_cooldown_s=2.0, tick_s=0.02, sample=4, seed=41,
            ab_requests=4, ab_tokens=24, leak_bytes=32 << 20)


def _orch_calibration(state):
    """The replica rate and SLO from this call's engine run (a), as fig14
    calibrates: an un-queued request costs its B 1 prefill (the mean
    ``prefill_admit_512`` EXECUTE) plus (mean_n - 1) TBTs (run (a)'s TBT
    p50); r = slots / that; the SLO is ``slo_mult`` x that."""
    a = state["engine"]["a"]
    prog = f"prefill_admit_{ENGINE['prompt_len']}"
    ttft = a["program_device_s"][prog] / a["program_execs"][prog]
    tbt = a["tbt_p50_s"]
    lo, hi = ORCH["tokens_range"]
    mean_n = (lo + hi - 1) / 2.0
    one = ttft + (mean_n - 1) * tbt
    return {"ttft_s": ttft, "tbt_s": tbt, "mean_new_tokens": mean_n,
            "uncontended_s": one, "replica_rate": ENGINE["slots"] / one,
            "slo_s": ORCH["slo_mult"] * one}


def phase_orch(state, arch=ENGINE["arch"], device="cuda",
               batch_arch=PATHS["mamba2"][0]):
    """Full-width yi-9b served through the whole control plane:
    ``make_cluster`` -> ``Orchestrator`` (FunkyScheduler, placement,
    autoscaler) -> NodeAgent -> ContainerEngine -> FunkyRuntime ->
    EngineServeTask -> paged engine.  Four mamba2 batch tasks fill the
    four slices; ``svc`` (priority 5) arrives and the scheduler evicts one
    (Algorithm 1), which resumes or migrates when a slice frees and must
    finish with an uninterrupted task's tokens.  Once the batch tasks are
    done, an open-loop burst (``drive_engine_open_loop``) makes the
    ``LatencySLOPolicy`` autoscaler replicate ``svc``; while the clone
    holds leases its node fails (``handle_node_failure``: crash, lease
    replay, resubmit); after the drive the autoscaler scales back in,
    then ``teardown_service`` and ``cluster.stop``.  Gates: every request
    once, no duplicate or replay mismatch, sampled tokens (every replayed
    one among them) equal one engine's, exact launch counts over every
    engine and batch task, 2 replicas at most with a replicate and a
    scale_in, a resubmit or restore after the failure, every thread of
    the phase ended and its device memory freed."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="funky-orch-")
    try:
        stats = _orch(state, arch, device, root, batch_arch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if device == "cuda":
            _free_cuda()
    stats["phase_s"] = time.perf_counter() - t_phase
    log(phase="orch", card=state.get("card"), summary=stats["summary"],
        phase_s=stats["phase_s"])
    state["orch"] = stats


def _interval_decode(marks, n_rep, busy=()):
    """Mean ``decode_step`` EXECUTE ms over the drive's one-second marks
    where ``n_rep`` replicas were deployed and no ``busy`` window (start,
    end on the marks' clock: a replicate, whose clone is not counted yet
    while it copies the weights) overlapped, per engine and pooled."""
    per, tot = {}, [0, 0.0]
    for (t0, r0, m0), (t1, _, m1) in zip(marks, marks[1:]):
        if r0 != n_rep or any(s < t1 and t0 < e for s, e in busy):
            continue
        for k, (n1, s1) in m1.items():
            n0, s0 = m0.get(k, (0, 0.0))
            if n1 > n0:
                e = per.setdefault(k, [0, 0.0])
                e[0] += n1 - n0
                e[1] += s1 - s0
                tot[0] += n1 - n0
                tot[1] += s1 - s0
    return {"decode_steps": tot[0],
            "decode_step_ms": tot[1] / tot[0] * 1e3 if tot[0] else None,
            "per_engine_ms": {k: v[1] / v[0] * 1e3 for k, v in per.items()}}


def _ab_orch_threads(orch, router, eng, paused, vocab):
    """The served decode step with the orchestrator's scheduler thread
    ticking and parked (it blocks on the orchestrator's lock, which the
    caller holds), in the order ticking, parked, parked, ticking: each
    turn serves ``ab_requests`` requests of ``ab_tokens`` tokens through
    the router and reads the engine's mean ``decode_step`` EXECUTE."""
    import numpy as np

    from repro_torch.serve.engine import ServeRequest

    rng = np.random.default_rng(SEED + 1)
    out = []
    for i, park in enumerate((False, True, True, False)):
        if park:
            orch._lock.acquire()
            paused.set()
        try:
            m0 = _decode_ms(eng)
            rids = [f"ab{i}-{j}" for j in range(ORCH["ab_requests"])]
            for rid in rids:
                router.submit(ServeRequest(
                    rid=rid, prompt=rng.integers(0, vocab, ENGINE[
                        "prompt_len"]).astype(np.int32),
                    max_new_tokens=ORCH["ab_tokens"]))
            deadline = time.time() + 300
            while not all(r in router.completed for r in rids):
                if time.time() > deadline:
                    raise RuntimeError("orch: the A/B requests did not "
                                       "complete")
                time.sleep(0.01)
            out.append({"scheduler": "parked" if park else "ticking",
                        **_interval_ms(m0, _decode_ms(eng))})
        finally:
            if park:
                paused.clear()
                orch._lock.release()
    return out


def _orch(state, arch, device, root, m_arch):
    import threading

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import (FunkyCL, Monitor, Policy, SliceAllocator,
                                  TaskImage, TaskStatus, make_cluster)
    from repro_torch.scaling import (Autoscaler, LatencySLOPolicy,
                                     OrchestratorScaler, burst_rate,
                                     drive_engine_open_loop, open_loop,
                                     reset_router, teardown_service,
                                     wait_for_service)
    from repro_torch.scaling.metrics import MetricsRegistry
    from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                          ServeRequest)
    from repro_torch.serve.equivalence import (assert_transcripts_equal,
                                               run_transcript)

    cal = _orch_calibration(state)
    log(phase="orch", card=state.get("card"), calibration=cal)
    cfg = get_arch(arch)
    m_prompt = PATHS["mamba2"][1]
    svc_im = TaskImage(name="svc", kind="engine-serve", arch=arch,
                       global_batch=ENGINE["slots"],
                       prompt_len=ENGINE["prompt_len"],
                       max_new_tokens=ENGINE["max_new_tokens"],
                       page_size=ENGINE["page_size"],
                       kv_pool_pages=ENGINE["pool_pages"],
                       prompt_buckets=ENGINE["prompt_buckets"],
                       total_steps=10 ** 9, seed=SEED)
    batch_im = TaskImage(name="batch", kind="serve", arch=m_arch,
                         prompt_len=m_prompt, global_batch=8,
                         total_steps=ORCH["batch_steps"], tokens_per_step=8,
                         seed=SEED)
    threads_before = set(threading.enumerate())
    if device == "cuda":
        _free_cuda()
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    cluster = make_cluster(num_nodes=2, slices_per_node=ORCH["slices"],
                           images={"svc": svc_im, "batch": batch_im},
                           mem_cap_bytes=ORCH["mem_cap"],
                           policy=Policy.PRE_MG, ckpt_root=root,
                           device=device)
    orch = cluster.orchestrator
    reg = orch.metrics
    ticks = reg.histogram("sched_tick_seconds", window_s=float("inf"),
                          max_samples=1 << 17)
    router = reset_router("svc")
    router.registry = reg
    wrappers = _wrappers()
    seen, running_at = {}, {}            # id(rec) -> rec, first RUNNING t
    stop_scan, paused = threading.Event(), threading.Event()

    def scan():
        # every task record any node holds, kept once seen: scale-in
        # deletes records whose engines the launch counts still need
        while not stop_scan.wait(0.05):
            if paused.is_set():
                continue
            for n in cluster.nodes.values():
                for rec in list(n.runtime.tasks.values()):
                    seen.setdefault(id(rec), rec)
                    if rec.status is TaskStatus.RUNNING:
                        running_at.setdefault(id(rec), time.time())

    def recs(cid):
        return [r for r in list(seen.values()) if r.cid == cid]

    def engines():
        return {f"{r.cid}@{id(r) % 10000}": r.task.engine
                for r in list(seen.values())
                if r.image.kind == "engine-serve"
                and r.task.engine is not None}

    def wait(cond, what, timeout=600):
        deadline = time.time() + timeout
        while not cond():
            bad = [c for c, d in orch.deployments.items()
                   if d.status == "failed"]
            if bad:
                errors = [r.error for c in bad for r in recs(c)]
                raise RuntimeError(f"orch: {bad} failed waiting for {what}: "
                                   f"{errors}")
            if time.time() > deadline:
                raise RuntimeError(f"orch: timed out waiting for {what}")
            time.sleep(0.02)

    scanner = threading.Thread(target=scan, name="orch-scan", daemon=True)
    scanner.start()
    for w in wrappers.values():          # the main path starts here
        w.launches = 0
    t0 = time.perf_counter()
    orch.start(tick_interval=ORCH["tick_s"])
    scaler = None
    try:
        batch = [orch.submit("batch", cid=f"batch-{i}")
                 for i in range(ORCH["n_batch"])]
        wait(lambda: all(any(r.guest_state.step >= 1 for r in recs(b))
                         for b in batch), "the batch tasks' first steps")
        t_batch = time.perf_counter() - t0
        svc = orch.submit("svc", priority=5)
        svc_node = wait_for_service(cluster, orch, svc, timeout_s=600)
        t_svc = time.perf_counter() - t0
        ev = [(e[1], e[2].get("cid")) for e in orch.events]
        evicted = [c for k, c in ev if k == "evict" and c in batch]
        if (len(evicted) != 1
                or ev.index(("evict", evicted[0])) > ev.index(("deploy",
                                                               svc))):
            raise AssertionError(f"orch: no scheduler-decided eviction "
                                 f"before svc's deploy: {ev}")
        wait(lambda: all(orch.deployments[b].status == "done"
                         for b in batch), "the batch tasks")
        t_batch_done = time.perf_counter() - t0
        last = {b: [r.guest_state.user["last_token"] for r in recs(b)
                    if r.status is TaskStatus.DONE] for b in batch}
        want_last = last[[b for b in batch if b != evicted[0]][0]]
        if any(v != want_last for v in last.values()) or \
                len(want_last) != 1:
            raise AssertionError(f"orch: batch tokens differ: {last}")
        b0 = recs(evicted[0])[0]
        b0_evict = [e[2] for e in b0.timeline if e[1] == "evict"][0]
        b0_resume = [e[2] for e in b0.timeline if e[1] == "resume"][0]
        ab = _ab_orch_threads(orch, router, recs(svc)[0].task.engine,
                              paused, cfg.vocab_size)

        scaler = OrchestratorScaler(orch, svc, service="svc")
        asc = Autoscaler(LatencySLOPolicy(slo_p95_s=cal["slo_s"],
                                          growth=2.0),
                         min_replicas=1, max_replicas=2,
                         scale_down_cooldown_s=ORCH["down_cooldown_s"])
        orch.attach_autoscaler(asc, scaler, service="svc",
                               interval_s=ORCH["asc_interval_s"])
        T, r = ORCH["horizon_s"], cal["replica_rate"]
        reqs = open_loop(burst_rate(ORCH["base_frac"] * r, ORCH["burst"],
                                    T / 3, T / 3), T, seed=ORCH["seed"],
                         mean_service_s=1.0 / r,
                         tokens_range=ORCH["tokens_range"])
        failure, marks, timeline = {}, [], []

        def on_tick(now, n_rep, queue, p95):
            marks.append((now, n_rep, {k: _decode_ms(e)
                                       for k, e in engines().items()}))
            timeline.append({"t": now, "replicas": n_rep, "queue": queue,
                             "p95_s": p95, "in_flight": router.in_flight})
            if failure or n_rep < 2 or not scaler.replica_cids:
                return
            clone = scaler.replica_cids[-1]
            node = orch._sched_tasks[clone].node_id
            rec = cluster.nodes[node].runtime.tasks.get(clone)
            if rec is None or rec.task.engine is None:
                return
            with router._lock:
                held = [rid for rid, (_, e) in router._leases.items()
                        if e == clone]
            if not held:
                return
            t = time.perf_counter()
            orch.handle_node_failure(node)
            failure.update(t=now, node=node, cid=clone, leased=len(held),
                           seconds=time.perf_counter() - t)

        t_drive0, t_drive_wall = time.perf_counter(), reg.clock()
        res = drive_engine_open_loop(
            orch, scaler, reqs, duration_s=T + ORCH["tail_s"],
            slo_s=cal["slo_s"],
            service="svc", prompt_len=ENGINE["prompt_len"],
            slots_per_replica=ENGINE["slots"],
            tokens_range=ORCH["tokens_range"], drain_timeout_s=300.0,
            on_tick=on_tick)
        t_drive = time.perf_counter() - t_drive0
        t_drive_end = reg.clock()
        teardown_service(orch, scaler)
    finally:
        router.close()
        cluster.stop()
        stop_scan.set()
        scanner.join()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    events = [e[1] for e in orch.events]

    # -- what the phase reports --------------------------------------------
    engs = engines()
    steps = sum(e.program_execs.get("decode_step", 0) for e in engs.values())
    prefills = sum(n for e in engs.values()
                   for p, n in e.program_execs.items()
                   if p.startswith("prefill_admit"))
    m_prefills = sum(1 for e in orch.events
                     if e[1] == "deploy" and e[2]["cid"] in batch)
    L, mL = cfg.num_layers, get_arch(m_arch).num_layers
    expected = {"K1": 0, "K1p": L * steps, "K2": L * prefills,
                "K3": mL * m_prefills, "K4": 0}
    completed = [router.completed[q.rid] for q in reqs
                 if q.rid in router.completed]
    ttft = [c.ttft_s for c in completed]
    clone0 = [r for r in seen.values() if r.cid == failure.get("cid")
              and any(e[1] == "replicated" for e in r.timeline)]
    rep = ([e[2] for e in clone0[0].timeline if e[1] == "replicated"][0]
           if clone0 else None)

    def setup_s(rec):
        start = [e[0] for e in rec.timeline if e[1] == "start"]
        return (running_at[id(rec)] - start[0]
                if start and id(rec) in running_at else None)

    svc_rec = recs(svc)[0]
    resub = [r for r in seen.values() if r.cid == failure.get("cid")
             and any(e[1] == "start" for e in r.timeline)]
    reconfig = setup_s(resub[0]) if resub else None
    a = state["engine"]["a"]
    ck1 = state.get("cri", {}).get("checkpoint1", {})
    replicas_ts = [(t - t_drive_wall, v) for t, v in reg.series(
        "replicas_ts", service="svc").points()]
    sampled = sorted(set(router.replayed) | set(sorted(res.prompts)
                                               [:ORCH["sample"]]))
    violations = sum(1 for c in completed if c.e2e_s > cal["slo_s"])
    replicating = [(e[0] - e[2]["total_seconds"] - t_drive_wall,
                    e[0] - t_drive_wall)
                   for r in seen.values() for e in r.timeline
                   if e[1] == "replicated"]
    summary = {
        "requests": len(reqs), "served": len(completed),
        "slo_s": cal["slo_s"],
        "slo_attainment": 1 - violations / max(len(completed), 1),
        "violations": violations, "max_replicas": res.max_replicas,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99)),
        "replicas_ts": replicas_ts, "scaled_in_by_autoscaler": any(
            e[1] == "scale_in" and e[0] < t_drive_end
            for e in orch.events),
        "decode_scheduler_ab": ab,
        "scale_out": rep, "preemption": {
            "batch": evicted[0], "evict": b0_evict, "resume": b0_resume},
        "failure": failure, "replayed": sorted(router.replayed),
        "replicating_s": replicating,
        "decode_alone": _interval_decode(marks, 1, replicating),
        "decode_two_replicas": _interval_decode(marks, 2, replicating),
        "decode_engine_phase_ms": a["program_device_s"]["decode_step"]
        / a["program_execs"]["decode_step"] * 1e3,
        "sched_tick_p50_s": ticks.quantile(0.5),
        "sched_tick_p99_s": ticks.quantile(0.99),
        "sched_ticks": ticks.count, "sched_tick_s_total": ticks.sum,
        "sim_params_measured": {
            "host_bw": b0_evict["saved_bytes"] / b0_evict["evict_seconds"],
            "reconfig_s": reconfig, "svc_setup_s": setup_s(svc_rec),
            "disk_bw": (ck1["written_bytes"] / ck1["write_seconds"]
                        if ck1 else None)},
        "decode_steps": steps, "prefills": prefills,
        "mamba2_prefills": m_prefills, "launches": launches,
        "seconds": {"batch_up": t_batch, "svc_up": t_svc,
                    "batch_done": t_batch_done, "drive": t_drive,
                    "wall": wall},
        "served_by": {k: len(e.completed) for k, e in engs.items()},
        "svc_node": svc_node}
    if device == "cuda":
        summary["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the reference's SimParams fields, as this call measured them (the
    # port's SimParams keep the reference's constants)
    log(phase="orch", card=state.get("card"),
        sim_params_measured=summary["sim_params_measured"])
    log(phase="orch", card=state.get("card"), events=events,
        timeline=timeline, decisions=[(d.t, d.current, d.desired, d.reason)
                                      for d in asc.decisions if d.applied],
        **summary)

    # -- gates -------------------------------------------------------------
    if res.served != len(reqs) + len(ab) * ORCH["ab_requests"] or \
            len(completed) != len(reqs):
        raise AssertionError(f"orch: served {len(completed)} of "
                             f"{len(reqs)} ({res.served} with the A/B's)")
    if router.duplicates or router.replay_mismatches:
        raise AssertionError(f"orch: {router.duplicates} duplicates, "
                             f"{router.replay_mismatches} replay mismatches")
    if device == "cuda" and launches != expected:
        raise AssertionError(f"orch: launch counts {launches}, expected "
                             f"{expected} ({steps} decode steps, {prefills} "
                             f"prefills, {m_prefills} mamba2 prefills)")
    # teardown_service scales in whatever still runs, so only events
    # before the drive's end show the autoscaler's own replicate and scale-in
    if res.max_replicas != 2 or not any(
            e[1] == "replicate" and e[0] < t_drive_end
            for e in orch.events) or not summary["scaled_in_by_autoscaler"]:
        raise AssertionError(
            f"orch: max replicas {res.max_replicas}, events before the "
            f"drive's end {[e[1] for e in orch.events if e[0] < t_drive_end]}")
    if not failure:
        raise AssertionError("orch: no replica held a lease while two "
                             "served, so no node failed")
    after = events[events.index("router_replay"):] \
        if "router_replay" in events else []
    if not router.replayed or not ({"restored", "resubmitted"}
                                   & set(after)):
        raise AssertionError(f"orch: the failure replayed "
                             f"{sorted(router.replayed)}; events {events}")

    # -- the sampled requests on one engine --------------------------------
    n_tok = {q.rid: q.n_tokens for q in reqs}
    got = {rid: list(router.completed[rid].tokens) for rid in sampled}
    seen.clear()
    del engs, clone0, resub, svc_rec, b0, cluster, orch, scaler, asc
    reset_router("svc")
    if device == "cuda":
        _free_cuda()
        # no task's weights (mamba2-1.3b: 2.7 GB) and no KV pool (yi-9b:
        # 0.25 GB) may outlive the teardown
        leaked = torch.cuda.memory_allocated() - mem_before
        live = collections.Counter(
            b["size"] for seg in torch.cuda.memory_snapshot()
            for b in seg["blocks"] if b["state"] == "active_allocated")
        log(phase="orch", card=state.get("card"),
            allocated_after_teardown_bytes=leaked,
            live_blocks_by_size=sorted(live.items(), reverse=True)[:20])
        if leaked > ORCH["leak_bytes"]:
            raise AssertionError(f"orch: {leaked / 1e9:.3f} GB still "
                                 "allocated after the teardown (live "
                                 f"blocks by size: {live.most_common(10)})")
    deadline = time.time() + 30
    while True:
        alive = [t.name for t in threading.enumerate()
                 if t not in threads_before and t.is_alive()]
        if not alive or time.time() > deadline:
            break
        time.sleep(0.1)
    if alive:
        raise AssertionError(f"orch: threads still running: {alive}")

    def factory():
        mon = Monitor("orch-ref", SliceAllocator("node0", 1,
                                                 mem_cap_bytes=64 << 30,
                                                 device=device),
                      telemetry=MetricsRegistry())
        eng = ContinuousBatchingEngine(arch, FunkyCL(mon), seed=SEED,
                                       engine_id="orch-ref", **_engine_kw())
        eng.setup()
        return mon, eng

    ref_tokens, eng = run_transcript(factory, lambda: [
        ServeRequest(rid=rid, prompt=res.prompts[rid],
                     max_new_tokens=n_tok[rid]) for rid in sampled])
    del eng
    assert_transcripts_equal(got, ref_tokens, context="orch sampled")
    log(phase="orch", card=state.get("card"), sampled=sampled,
        sampled_equal=True)
    state.setdefault("launches", {})["orch"] = launches
    return {"summary": summary}


# ---------------------------------------------------------------------------
# 17. training at full width
# ---------------------------------------------------------------------------

# yi-9b at full width (d_model 4096, 32/4 heads, hd 128, d_ff 11008, vocab
# 64000, untied head) cut to ``layers`` of its 48: whole, its training
# state (bf16 params, f32 grad_acc, f32 m and v) is about 123 GB, over the
# card's 80; 8 layers hold 1.908 B params, 26.7 GB of state.  The image:
# seq 1024, global batch 8 in ``chunks`` microbatches, the image's default
# OptConfig.  (e) holds the card against the CPU on ``e_layers`` in f32;
# fig09's wait runs at ``fig09_layers`` (chunks 1 would hold the whole
# batch's activations at once); the smoke archs checkpoint and restore.
TRAIN = dict(arch="yi-9b", layers=8, seq_len=1024, global_batch=8, chunks=4,
             total_steps=6, evict_at=(2, 2), migrate_at=(2, 3),
             fig09_layers=2, fig09_sleep_s=0.05, e_layers=2, e_seq=256,
             smoke=("yi-9b-smoke", "mamba2-1.3b-smoke",
                    "recurrentgemma-9b-smoke"),
             smoke_steps=4, smoke_at=(1, 1), mem_cap=48 << 30,
             max_phase_s=150.0, max_peak_gb=45.0)
TRAIN_LOSS_REL_TOL = 1e-5    # (e): |loss card - loss CPU| / |loss CPU|
TRAIN_GRAD_REL_TOL = 1e-4    # (e): max|g card - g CPU| / max|g CPU|, a leaf
PAPER_VIRT_OVERHEAD = 0.074  # the paper's Fig 4 (Alveo U50)


def _train_cut(base, layers, names, suffix="", **kw):
    """Register ``base`` cut to ``layers`` (depth only; ``kw`` may change
    the dtype) in the port's arch registry, so a ``TaskImage`` can name
    it; its name goes on ``names``.  Returns the config."""
    import dataclasses

    from repro_torch.configs import registry

    name = f"{base.name}-{layers}of{base.num_layers}{suffix}"
    cfg = dataclasses.replace(base, name=name, num_layers=layers, **kw)
    names.append(name)
    registry.ARCHS[name] = cfg
    return cfg


def _tree_equal(a, b):
    import torch

    from repro_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _parking_task(rec, points):
    """A TrainTask for ``rec`` that parks its driver right after the chunk
    that leaves the guest at each (step, chunk_idx) of ``points``: it
    clears the run gate the runtime's own park clears, so the next command
    finds the task exactly there.  ``task.parked[point]`` is set then."""
    import threading

    from repro_torch.core import TrainTask

    class Parking(TrainTask):
        def __init__(self, image):
            super().__init__(image)
            self.parked = {p: threading.Event() for p in points}

        def step(self, cl, gs):
            done = super().step(cl, gs)
            at = (gs.step, gs.user.get("chunk_idx", 0))
            if at in self.parked:
                rec.run_gate.clear()
                self.parked[at].set()
            return done

    return Parking(rec.image)


def _await_park(rec, point, timeout=600):
    if not rec.task.parked[point].wait(timeout):
        raise RuntimeError(f"train: {rec.cid} never reached {point}: "
                           f"{rec.status} {rec.error!r}")


def _await_step(rec, step, timeout=600):
    """Polls the guest's step counter (1 ms); the clock when it reached
    ``step``."""
    from repro_torch.core import TaskStatus

    deadline = time.time() + timeout
    while rec.guest_state.step < step:
        if rec.status in (TaskStatus.FAILED, TaskStatus.REMOVED) or \
                time.time() > deadline:
            raise RuntimeError(f"train: {rec.cid} stopped at step "
                               f"{rec.guest_state.step}: {rec.status} "
                               f"{rec.error!r}")
        time.sleep(0.001)
    return time.perf_counter()


def _train_done(rt, cid, timeout=600):
    from repro_torch.core import TaskStatus

    rec = rt.tasks[cid]
    if rt.wait(cid, timeout=timeout) is not TaskStatus.DONE:
        raise RuntimeError(f"train: {cid} ended {rec.status}: {rec.error!r}")
    if rec.guest_state.step != rec.image.total_steps:
        raise AssertionError(f"train: {cid} ended at step "
                             f"{rec.guest_state.step}")
    return rec.guest_state.user["final_params"]


def _train_flops(cfg, seq_len, tokens):
    """Model FLOPs of a training step over ``tokens``: 6 N per token for
    the N parameters that multiply (all but the embedding table, a
    lookup), plus attention's 12 L H hd S per token (QK^T and PV, forward
    and backward, over the whole S x S that the naive attention computes)."""
    from repro_torch.models.model_zoo import analytic_param_count

    n = analytic_param_count(cfg) - cfg.vocab_size * cfg.d_model
    attn = 12 * cfg.num_layers * cfg.num_heads * cfg.head_dim_ * seq_len
    return (6 * n + attn) * tokens, n


def phase_train(state, device="cuda", cut=None):
    """Training at full width: yi-9b cut to ``TRAIN["layers"]`` layers,
    (a) ``make_train_step`` called directly, (b) the same image as a
    ``TrainTask`` through ``make_cluster`` -> FunkyRuntime -> FunkyCL ->
    Monitor, (c) again, evicted mid-accumulation, resumed, then migrated
    to a second slice; fig09's wait from an evict request to the park with
    4 chunks and 1; (d) the smoke archs checkpointed at a chunk boundary
    and restored in a fresh runtime; (e) one ``grad_step`` on the card
    against the CPU in f32.  Gates: (b)'s final params equal (a)'s bit for
    bit, (c)'s equal (b)'s, each of (d) an uninterrupted run's; (e) within
    ``TRAIN_LOSS_REL_TOL`` and ``TRAIN_GRAD_REL_TOL``; no kernel launched
    in the phase (training runs the plain forwards under autograd); the
    phase under ``max_phase_s`` and ``max_peak_gb``.  ``cut`` overrides
    ``TRAIN`` (a rehearsal on the CPU at a small size)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import registry

    tc = dict(TRAIN, **(cut or {}))
    t_phase = time.perf_counter()
    wrappers = _wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    if device == "cuda":
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
    root = tempfile.mkdtemp(prefix="funky-train-")
    names = []
    try:
        stats = _train(tc, device, root, names)
    finally:
        for n in names:
            registry.ARCHS.pop(n, None)
        shutil.rmtree(root, ignore_errors=True)
        if device == "cuda":
            _free_cuda()
    launches = {k: w.launches - before[k] for k, w in wrappers.items()}
    stats["launches"] = launches
    stats["phase_s"] = time.perf_counter() - t_phase
    if device == "cuda":
        stats["peak_gb"] = max(stats["peak_gb_by_run"].values())
        stats["left_allocated_bytes"] = torch.cuda.memory_allocated()
    log(phase="train", card=state.get("card"), summary=stats)
    state.setdefault("launches", {})["train"] = launches
    state["train"] = stats
    if any(launches.values()):
        raise AssertionError(f"train: kernels launched {launches}; "
                             "training runs no kernel")
    if stats["phase_s"] > tc["max_phase_s"]:
        raise AssertionError(f"train: the phase took {stats['phase_s']:.1f}"
                             f" s, over {tc['max_phase_s']} s")
    if stats.get("peak_gb", 0.0) > tc["max_peak_gb"]:
        raise AssertionError(f"train: peak {stats['peak_gb']:.2f} GB, over "
                             f"{tc['max_peak_gb']} GB")


def _train(tc, device, root, names):
    import os

    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import TaskImage, make_cluster
    from repro_torch.core.state import to_host
    from repro_torch.models import build_model
    from repro_torch.train import make_batch, make_train_state, make_train_step

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    peaks, marks = {}, {}

    def peak(run):
        """The allocator's peak since the last call, recorded for ``run``
        (the phase's peak is the largest)."""
        if device == "cuda":
            sync()
            peaks[run] = max(torch.cuda.max_memory_allocated() / 1e9,
                             peaks.get(run, 0.0))
            torch.cuda.reset_peak_memory_stats()

    def mark(run, name):
        """Bytes allocated now and the peak since the last mark, in GB."""
        if device == "cuda":
            sync()
            marks.setdefault(run, {})[name] = (
                torch.cuda.memory_allocated() / 1e9,
                torch.cuda.max_memory_allocated() / 1e9)
            peak(run)

    base = get_arch(tc["arch"])
    cfg = _train_cut(base, tc["layers"], names)
    image = TaskImage(name="train", kind="train", arch=cfg.name,
                      seq_len=tc["seq_len"], global_batch=tc["global_batch"],
                      chunks=tc["chunks"], total_steps=tc["total_steps"],
                      seed=SEED)
    shape = ShapeConfig("train", "train", image.seq_len, image.global_batch)
    n_steps = image.total_steps
    tokens = image.seq_len * image.global_batch
    flops, n_params = _train_flops(cfg, image.seq_len, tokens)
    out = {"arch": cfg.name, "params": n_params + cfg.vocab_size * cfg.d_model,
           "seq_len": image.seq_len, "global_batch": image.global_batch,
           "chunks": image.chunks, "steps": n_steps,
           "moment_dtype": image.opt.moment_dtype,
           "model_flops_per_step": flops}

    # (a) native: the fused step called directly; step 0 warms, 1.. timed
    bundle = build_model(cfg)
    t = time.perf_counter()
    params, opt = make_train_state(bundle, image.opt, SEED, device=device)
    sync()
    out["a_init_s"] = time.perf_counter() - t
    step = make_train_step(bundle, image.opt, num_microbatches=image.chunks)
    losses = []
    params, opt, m = step(params, opt, make_batch(cfg, shape, 0))
    losses.append(float(m["loss"]))
    sync()
    t = time.perf_counter()
    for s in range(1, n_steps):
        params, opt, m = step(params, opt, make_batch(cfg, shape, s))
    sync()
    native_s = time.perf_counter() - t
    losses.append(float(m["loss"]))
    per_step = native_s / (n_steps - 1)
    out["a"] = {"step_s": per_step, "tokens_per_s": tokens / per_step,
                "mfu": (flops / per_step / PEAK_FLOP_S["bfloat16"]
                        if device == "cuda" else None),
                "loss_first_last": losses,
                "grad_norm_last": float(m["grad_norm"])}
    peak("a")
    native = to_host(params)
    if device == "cuda":
        # where a step's time goes: one more step, traced, after (a)'s
        # params were copied out (it changes no compared value)
        out["a"]["trace"] = _train_trace(
            lambda: step(params, opt, make_batch(cfg, shape, n_steps)))
    del params, opt, m, step
    if device == "cuda":
        _free_cuda()
    log(phase="train", run="a", **out["a"])

    def cluster(nodes, sub, im=image):
        return make_cluster(num_nodes=nodes, slices_per_node=1,
                            images={im.name: im}, device=device,
                            mem_cap_bytes=tc["mem_cap"],
                            ckpt_root=os.path.join(root, sub))

    # (b) the same image through the Funky stack, timed as fig04 times it
    cl = cluster(1, "b")
    rt = cl.nodes["node0"].runtime
    rec = rt.create("b", image)
    t = time.perf_counter()
    rt.start("b")
    t1 = _await_step(rec, 1)
    t_first = t1 - t
    t_end = _await_step(rec, n_steps)
    funky = _train_done(rt, "b")
    t_done = time.perf_counter()
    funky_s = t_end - t1
    out["b"] = {"step_s": funky_s / (n_steps - 1),
                "setup_and_first_step_s": t_first,
                "teardown_s": t_done - t_end,
                "overhead": funky_s / native_s - 1,
                "paper_overhead_alveo_u50": PAPER_VIRT_OVERHEAD,
                "final_loss": rec.guest_state.user["final_loss"],
                "equal_to_a": _tree_equal(funky, native)}
    rt.delete("b")
    del rec, rt, cl
    peak("b")
    log(phase="train", run="b", **out["b"])
    if not out["b"]["equal_to_a"]:
        raise AssertionError("train: (b)'s final params differ from (a)'s")
    del native
    if device == "cuda":
        _free_cuda()

    # (c) evicted mid-accumulation, resumed, then migrated to node1's slice
    cl = cluster(2, "c")
    rt0, rt1 = cl.nodes["node0"].runtime, cl.nodes["node1"].runtime
    rec = rt0.create("c", image)
    rec.task = _parking_task(rec, (tc["evict_at"], tc["migrate_at"]))
    mark("c", "start")
    rt0.start("c")
    _await_park(rec, tc["evict_at"])
    mark("c", "parked")
    ev = rt0.evict("c")
    mark("c", "evicted")
    rs = rt0.resume("c")
    mark("c", "resumed")
    _await_park(rec, tc["migrate_at"])
    mark("c", "parked_again")
    t = time.perf_counter()
    mg = rt1.resume("c", source=rt0)
    migrate_s = time.perf_counter() - t
    mark("c", "migrated")
    mg_ev = [kw for _, e, kw in rec.timeline if e == "evict"][-1]
    interrupted = _train_done(rt1, "c")
    mark("c", "done")
    out["c"] = {
        "evict_at": tc["evict_at"], "migrate_at": tc["migrate_at"],
        "evict_s": ev["total_seconds"], "evict_saved_bytes":
            ev["saved_bytes"], "evict_n_dirty": ev["n_dirty"],
        "resume_s": rs["total_seconds"],
        "resume_bytes": rs["restored_bytes"],
        "migrate_s": migrate_s, "migrate_evict_s": mg_ev["total_seconds"],
        "migrate_saved_bytes": mg_ev["saved_bytes"],
        "migrate_resume_s": mg["resume_seconds"],
        "migrate_resume_bytes": mg["restored_bytes"],
        "equal_to_b": _tree_equal(interrupted, funky)}
    rt1.delete("c")
    del rec, rt0, rt1, cl, interrupted
    peak("c")
    log(phase="train", run="c", **out["c"])
    if not out["c"]["equal_to_b"]:
        raise AssertionError("train: (c)'s final params differ from (b)'s")
    del funky
    if device == "cuda":
        _free_cuda()

    # fig09: the wait from an evict request to the park, 4 chunks and 1
    name2 = _train_cut(base, tc["fig09_layers"], names).name
    out["fig09"] = {"arch": name2}
    for k in (tc["chunks"], 1):
        im = TaskImage(name="train", kind="train", arch=name2,
                       seq_len=image.seq_len, global_batch=image.global_batch,
                       chunks=k, total_steps=10 ** 6, seed=SEED)
        cl = cluster(1, f"fig09-{k}", im)
        rt = cl.nodes["node0"].runtime
        rec = rt.create("f", im)
        rt.start("f")
        _await_step(rec, 1)
        time.sleep(tc["fig09_sleep_s"])     # land inside a dispatched step
        t = time.perf_counter()
        ev = rt.evict("f")
        wait = (time.perf_counter() - t - ev["evict_seconds"]
                + ev["sync_wait_seconds"])
        out["fig09"][f"chunks{k}"] = {
            "wait_s": wait, "at": (rec.guest_state.step,
                                   rec.guest_state.user.get("chunk_idx", 0)),
            "evict_s": ev["total_seconds"], "saved_bytes": ev["saved_bytes"]}
        rt.kill("f")                        # the sample is taken
        rt.delete("f")
        del rec, rt, cl
        if device == "cuda":
            _free_cuda()
    w4 = out["fig09"][f"chunks{tc['chunks']}"]["wait_s"]
    w1 = out["fig09"]["chunks1"]["wait_s"]
    out["fig09"]["wait_cut"] = 1 - w4 / w1
    peak("fig09")
    log(phase="train", run="fig09", **out["fig09"])

    # (d) the smoke archs: checkpoint at a chunk boundary, restore in a
    # fresh runtime
    out["d"] = {}
    for arch in tc["smoke"]:
        im = TaskImage(name="smoke", kind="train", arch=arch,
                       total_steps=tc["smoke_steps"], seed=SEED)
        cl = cluster(1, f"d-{arch}", im)
        rt = cl.nodes["node0"].runtime
        rt.create("u", im)
        rt.start("u")
        want = _train_done(rt, "u")
        rec = rt.create("x", im)
        rec.task = _parking_task(rec, (tc["smoke_at"],))
        rt.start("x")
        _await_park(rec, tc["smoke_at"])
        path = rt.checkpoint("x", keep_running=False)
        ck = [kw for _, e, kw in rec.timeline if e == "checkpoint"][-1]
        rt.kill("x")
        fresh = cluster(1, f"d-{arch}-fresh", im)
        rt2 = fresh.nodes["node0"].runtime
        rt2.restore("y", path)
        got = _train_done(rt2, "y")
        out["d"][arch] = {"at": tc["smoke_at"], "bytes": ck["bytes"],
                          "checkpoint_s": ck["total_seconds"],
                          "restore_s": [kw for _, e, kw in
                                        rt2.tasks["y"].timeline
                                        if e == "restored"][-1][
                                            "total_seconds"],
                          "equal": _tree_equal(got, want)}
        del rec, rt, rt2, cl, fresh
        if not out["d"][arch]["equal"]:
            raise AssertionError(f"train: {arch} restored mid-accumulation "
                                 "ends with other params than an "
                                 "uninterrupted run")
    peak("d")
    log(phase="train", run="d", **out["d"])

    # (e) the port's grad_step on the card against the CPU, f32
    out["e"] = _train_card_vs_cpu(tc, base, device, names)
    peak("e")
    log(phase="train", run="e", **out["e"])
    out["peak_gb_by_run"] = peaks
    out["memory_marks_gb"] = marks
    return out


# cuBLAS/CUTLASS GEMM kernels in a trace, by their names
GEMM_SYMBOLS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")


def _train_trace(fn):
    """One call of ``fn`` (a fused train step) under ``torch.profiler``:
    ``_trace_summary``'s numbers plus the device ms of the GEMMs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    res = _trace_summary(prof, wall, 1)
    res["gemm_ms"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and any(g in e.key.lower() for g in GEMM_SYMBOLS)) / 1e3
    return res


def _train_card_vs_cpu(tc, base, device, names):
    """One ``grad_step`` of the port's own function on the CPU and on
    ``device`` from the same weights (drawn on the CPU from the seed,
    copied over), f32, no TF32: the link from the card's path to the CPU
    path the tests hold against the JAX package."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.train import (OptConfig, make_batch,
                                   make_chunked_train_fns)
    from repro_torch.tree import tree_leaves, tree_map

    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train (e): TF32 is enabled")
    cfg = _train_cut(base, tc["e_layers"], names, "-f32", dtype="float32")
    bundle = build_model(cfg)
    grad_init, grad_step, _ = make_chunked_train_fns(bundle, OptConfig())
    batch = make_batch(cfg, ShapeConfig("e", "train", tc["e_seq"], 1), 0)
    t = time.perf_counter()
    p_cpu = bundle.init(SEED, device="cpu")
    init_s = time.perf_counter() - t
    t = time.perf_counter()
    g_cpu, l_cpu = grad_step(p_cpu, grad_init(p_cpu), batch)
    cpu_s = time.perf_counter() - t
    p_dev = tree_map(lambda x: x.to(device), p_cpu)
    del p_cpu
    t = time.perf_counter()
    g_dev, l_dev = grad_step(p_dev, grad_init(p_dev), batch)
    l_dev = float(l_dev)
    dev_s = time.perf_counter() - t
    del p_dev
    loss_rel = abs(l_dev - float(l_cpu)) / abs(float(l_cpu))
    worst = 0.0
    for a, b in zip(tree_leaves(g_dev), tree_leaves(g_cpu)):
        err = (a.cpu() - b).abs().max().item()
        worst = max(worst, err / max(b.abs().max().item(), 1e-30))
    del g_dev, g_cpu
    res = {"arch": cfg.name, "seq_len": tc["e_seq"], "batch": 1,
           "loss_card": l_dev, "loss_cpu": float(l_cpu),
           "loss_rel_err": loss_rel, "grad_rel_err_max": worst,
           "init_cpu_s": init_s, "grad_step_cpu_s": cpu_s,
           "grad_step_card_s": dev_s}
    if loss_rel > TRAIN_LOSS_REL_TOL or worst > TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"train (e): card against CPU {res}")
    return res


# ---------------------------------------------------------------------------

def kernel_line(state):
    """The per-kernel summary line: each kernel's numbers at its path's
    shape (phase 2) and its launches on that path's served run.  ``ms`` and
    ``library_ms`` are device times from a trace (``device_ms``): CUDA events
    over back-to-back calls (``event_ms``) also time the wrapper's host
    dispatch, which exceeds a decode kernel's device time."""
    rows = []
    for key, name, kfile, line, path, case in (
            ("k1", "decode_attention", "decode_attention", 83, "yi", "path"),
            ("k1", "decode_attention", "decode_attention", 83,
             "recurrentgemma", "hd256_path"),
            ("k2", "flash_attention", "flash_attention", 95, "yi", "path"),
            ("k2", "flash_attention", "flash_attention", 95,
             "recurrentgemma", "hd256_path"),
            ("k3", "ssd_scan", "ssd_scan", 88, "mamba2", "path"),
            ("k4", "rglru_scan", "rglru_scan", 59, "recurrentgemma",
             "path")):
        r = state[key][case]
        rows.append({
            "name": name if case == "path" else f"{name} ({case})",
            "route": "cuda", "variant": r.get("route"),
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{kfile}/kernel.py:{line}",
            "launches": state["launches"][path][key.upper()],
            "max_abs_err": r["max_abs_err"], "ms": r["device_ms"],
            "event_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_device_ms")})
    # K2 at yi-9b's shape also runs the engine's, the CRI path's and the
    # orchestrated service's admissions (B 1); K3 the orchestrated batch
    # tasks' prefills
    rows[2]["launches_engine"] = state["launches"]["engine"]["K2"]
    rows[2]["launches_cri"] = state["launches"]["cri"]["K2"]
    rows[2]["launches_orch"] = state["launches"]["orch"]["K2"]
    rows[4]["launches_orch"] = state["launches"]["orch"]["K3"]
    # training runs the plain forwards under autograd: no kernel
    for row, key in zip(rows, ("K1", "K1", "K2", "K2", "K3", "K4")):
        row["launches_train"] = state["launches"]["train"][key]
    r = state["k1p"]["path"]
    rows.append({
        "name": "decode_attention_paged", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:83",
        "launches": state["launches"]["engine"]["K1p"],
        "launches_cri": state["launches"]["cri"]["K1p"],
        "launches_orch": state["launches"]["orch"]["K1p"],
        "max_abs_err": r["max_abs_err"], "ms": r["device_ms"],
        "event_ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None, "gather_dense_ms": r["gather_dense_ms"],
        "launches_train": state["launches"]["train"]["K1p"]})
    return {"kernels": rows}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    phases = argv or PHASES
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}", file=sys.stderr)
        return 2
    state: dict = {}
    t0 = time.perf_counter()
    for p in phases:
        t = time.perf_counter()
        globals()[f"phase_{p}"](state)
        log(phase=p, done_s=time.perf_counter() - t)
    full = tuple(phases) == PHASES
    if full:
        print(json.dumps(kernel_line(state)), flush=True)
    print(state.get("card", ""), flush=True)
    log(total_s=time.perf_counter() - t0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    # a subset skips the kernel checks: its last line must not read as a pass
    print(json.dumps({"ok": True, "device": device} if full else
                     {"ok": "partial", "phases": list(phases),
                      "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
