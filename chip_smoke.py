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
   yi-9b's and recurrentgemma-9b's shapes (hd 128 and 256), K2, K1 and
   K1 paged at stablelm-3b's (hd 80, 32/32 heads), starcoder2-15b's
   (group 12), deepseek-moe-16b's (16/16 heads of 128, group 1; K2 also
   at the engine's B 1 admissions) and, in bf16, qwen3-8b's (32/8), K1's
   paged
   entry at the engine's decode shape (8 lanes at ragged positions over
   pages of 16 scattered through a 288-page pool), at engine run (d)'s
   (``DECODE_ROWS``, 64 lanes) and at twice that (128 lanes), K3 at
   mamba2-1.3b's
   (bf16 on its mma route, f32 on the CUDA cores), K4 at
   recurrentgemma-9b's, plus ragged, small and edge cases (K1: wholly
   masked splits, one lane; K1 paged: pages of 4, an inactive lane, a
   position on a page boundary, positions past the mapped span, a window,
   every lane inactive (the floor, timed), the disagg phase's decode
   replica (14 lanes, tables of 37 pages over 518,
   timed), each case
   logging the route ``paged_plan`` gave it;
   K2: Sq 1/127/129/200, windows ending on a tile
   boundary, hd 16 and 64; K3: chunk 100, the smoke shape), the
   families phase's shapes in bf16 and f32, each timed (K2 at
   seamless-m4t-large-v2's encoder, its cross attention at Sq 256 against
   Skv 1024 and a ragged Sq 200 against Skv 1000, its decoder's prefill
   and llava-next-mistral-7b's 3072 positions; K1 over seamless's self
   ring and its cross cache and at llava's decode), and the
   features phase's call patterns (K1 paged at one lane as
   ``prefill_chunk`` calls it, at verify's 4-step window across page
   boundaries, and K1 dense with per-lane positions at the draft and
   reserved lanes' shapes); at the path
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
14. the paged continuous-batching engine at full-width yi-9b cut to 12
   of its 48 layers (``phase_engine``; the orch phase runs it at full
   depth): 24 requests through RequestRouter ->
   EngineServeTask -> FunkyRuntime, single-step and 8 steps fused, and on
   a monitor with evict/resume every 16 iterations, and (d) 64 requests
   on a 64-lane engine (run (a)'s 24 among them); identical tokens ((d):
   run (a)'s for its 24), exact launch counts (paged K1 12 per decode
   step, K2 12 per prefill, dense K1 none; (d) by shape), OOM preemption
   and compaction, page-granular evicts, kernel-path logits against the
   plain path's at 8 lanes and at 64, one traced decode step of each;
15. the engine's features at full-width yi-9b cut to 12 of its 48
   layers (``phase_features``, budget
   240 s and 45 GB peak, both gated): (d) the engine phase's first 8
   requests untraced and with one Tracer shared by router, engine and
   monitor (same tokens, the Chrome trace validates, per-iteration split
   of the wall time); (e) the prefix cache, 8 requests over two 48-token
   prefixes served cold/partial, again as full hits, and two alone (hits
   equal cold runs, exact paged-K1 launches: 48 per chunk token and per
   decode step); (f) speculative decode, a self-draft k 3 and an
   antigreedy k 2 against plain decode (same tokens, exact K1 paged, K1
   dense and K2 launches, accept rate and decode tokens/s); (g) reserved
   mode on (f)'s requests (exact launches, one decode step's logits
   within LOGIT_REL_TOL of the plain path's);
16. prefill/decode disaggregation at full-width yi-9b cut to 12 of its
   48 layers (``phase_disagg``, budget 150 s and 45 GB, both gated): the
   engine phase's 24 requests
   through one RequestRouter -> a prefill replica (2 lanes, single-step)
   -> the KV handoff (TransferQueue: gather, d2h, h2d, scatter) -> a
   decode replica (14 lanes, 8 steps fused, one EXECUTE ahead), each on
   its own monitor and slice of the card; (a) the tokens of the engine
   phase's run (a) at the same depth (served once first), (b) the same with two transfers torn (each replays through its
   lease; every request once), (c) the decode replica's first step after
   an install, kernel-path logits within LOGIT_REL_TOL of the plain
   path's; exact launches over both replicas;
17. the CRI layer at full-width yi-9b cut to 12 of its 48 layers
   (``phase_cri``): the same 24
   requests through NodeAgent -> ContainerEngine -> FunkyRuntime on two
   nodes of the card, with a full and an incremental checkpoint to disk
   (the second bit-flipped after publishing), evict and migrate, replicate,
   a hard failure of the replica's node with lease replay, and a restore
   that falls back to the first snapshot; run (a)'s tokens at the same
   depth (the disagg phase's reference), exact launch
   counts over every replica, seconds and bytes of each operation;
18. the control plane at full-width yi-9b (``phase_orch``): ``make_cluster``
   (two nodes of two slices on the card, PRE_MG) with four mamba2-1.3b
   batch tasks, the service preempting one by Algorithm 1, a
   ``LatencySLOPolicy`` autoscaler scaling it to two replicas and back
   under an open-loop burst (``drive_engine_open_loop``, calibrated on
   the service's own engine just before it; from the scale-out the
   backlog waits for the clone), the clone's node failing while it holds
   leases (replay, resubmit), teardown; every request once, sampled tokens equal one
   engine's, exact launch counts over every engine and batch task,
   scheduler tick and decode-step seconds, threads ended and memory freed;
19. training at full width (``phase_train``): yi-9b cut to 8 of its 48
   layers, seq 1024, global batch 8 in 4 microbatches: (a) the fused
   ``make_train_step`` called directly, (b) the same image as a
   ``TrainTask`` through ``make_cluster`` -> FunkyRuntime -> FunkyCL ->
   Monitor, (c) again, evicted at chunk 2 of 4, resumed, migrated to a
   second slice at chunk 3; fig09's wait from an evict request to the park
   (4 chunks against 1, at 2 layers); (d) the three smoke archs
   checkpointed mid-accumulation and restored in a fresh runtime; (e) one
   f32 ``grad_step`` on the card (2 layers, seq 256) against the CPU's in
   a child process whose CPU kernels are pinned (``PINNED_CPU_ENV``: the
   same loss bits and gradient digest on every host, printed).  Gates:
   (b) equals (a) bit for bit, (c) equals (b), each (d) an uninterrupted
   run; (e) within 1e-5 (loss) and 1e-4 (gradients); no kernel launched;
   under 150 s and 45 GB;
20. the remaining dense archs (``phase_dense_archs``, budget 200 s,
   gated): qwen3-8b, stablelm-3b and starcoder2-15b at full width cut to
   a quarter of their depth, one after another: (a) served through the runtime
   (batch 8, prompt 512, 32 tokens; K2 L per prefill, K1 L per token),
   (b) kernel path against plain path, (c) the engine phase's
   configuration on its
   first 8 requests through RequestRouter -> EngineServeTask, single-step
   and 8 fused with one EXECUTE ahead (same tokens; K2 L per admission,
   K1 paged L per decode step, dense K1 never), then a paged decode
   step's and each bucket's prefill's logits within LOGIT_REL_TOL;
21. the MoE family (``phase_moe``, budget 150 s and 45 GB peak, both
   gated): deepseek-moe-16b at full width cut to half its depth (14 of
   28 layers: one dense, 13 of 64 routed experts top-6 and 2 shared; MHA
   16/16 heads of 128),
   the dense_archs phase's steps (a)-(d) for one arch: served through the
   runtime (K2 14 per prefill, K1 14 per token), kernel path against plain
   path, the engine on 8 requests single-step and fused (K2 14 per
   admission, K1 paged 14 per decode step), the paged decode step's and
   each bucket's prefill's logits; in the logit checks the plain path
   takes the kernel path's MoE routing, and the rows its own router
   would have routed otherwise are logged (a near-tie of the top-k flips
   on a bf16 rounding difference); the warm decode step's trace and the
   device time of its expert path;
22. MLA (``phase_mla``, budget 120 s and 45 GB peak, both gated):
   deepseek-v3-671b at full width cut to 4 of its 61 layers (3 dense
   MLA + MLP, one MLA + MoE of 256 routed experts top-8 and 1 shared;
   15.1 B parameters), the moe phase's steps with absorbed decode on the
   kernel side and decompressed decode on the plain side: served through
   the runtime, absorbed against decompressed, the engine on 8 requests
   over a pool of latent pages single-step and fused, a paged step's and
   each bucket's prefill's logits, the expert layer's device time; then
   over latent pages (``_mla_features``) (e) a prefix hit with its cold
   run's tokens, (f) a speculative run of k 2 and (g) a prefill replica's
   lanes handed to a decode replica, each with the engine run's tokens;
   MLA has no kernel, and any launch fails the phase;
23. the last two families (``phase_families``, budget 150 s and 45 GB
   peak, both gated), each at full width and depth on random weights:
   (a) seamless-m4t-large-v2 (24 encoder + 24 decoder layers, 16/16
   heads of 64) served through ``generate`` at batch 8 from 1024 source
   frames and a target prompt of 256, 32 new tokens (K2 72 per prefill:
   24 encoder, 24 decoder self, 24 cross at Sq 256 against Skv 1024; K1
   48 per token: 24 self ring, 24 cross cache; exact by shape); (b)
   llava-next-mistral-7b (32 layers, 32/8 heads of 128) served the same
   way from 2880 image embeddings and 192 text tokens (K2 32 per prefill,
   K1 32 per token); (c) for each, the kernel path against the plain path
   (blockwise prefill, plain decode) over the prefill and 4 decode steps,
   within LOGIT_REL_TOL; (d) one warm decode step of each, traced;
24. the launch layer (``phase_launch``, budget 120 s and 45 GB peak, both
   gated), through the entry points a user calls: (a)
   ``repro_torch.launch.serve.main`` serving full-width qwen3-8b cut to 18
   of its 36 layers (batch 8, prompt 512, 64 tokens; K2 18 per prefill,
   K1 18 per token, exactly), its last tokens equal to a ``ServeTask``'s
   on the same image run directly; (c) ``launch.steps.build_cell`` train
   steps at the ``train`` phase's cut (yi-9b at 8 of 48 layers, seq 1024,
   batch 8 in 2 microbatches) with ``remat`` "none", "full" and "dots":
   equal first-step losses, gradient norms within 1e-5, peaks and the
   bytes autograd holds after a forward both ordered full < dots < none;
   (b) fig04's pair through ``launch.train.main``, native and through
   Funky (4 steps of 4 chunks): equal final losses, bit for bit, and the
   overhead; (d) ``launch.roofline``'s bound beside (a)'s prefill, (a)'s
   decode step and (c)'s step, ``launch.dryrun``'s meta-device peak
   beside (c)'s measured ones;
25. the multi-device layer (``phase_mesh``, budget 60 s and 45 GB peak,
   both gated) on a one-rank NCCL group (a ``HashStore``, no network) and
   a (1, 1) ``("data", "model")`` mesh: (a) ``build_cell`` train steps at
   the train phase's cut under "tp", "fsdp_tp" and "fsdp", each equal to
   the mesh-less step to the bit (loss and updated parameters); (b) a
   format-v2 snapshot of yi-9b at 12 of 48 layers restored onto the mesh
   by ``reshard_snapshot_buffers``, then the prefill and decode cells on
   the mesh (batch 8, prompt 512, 32 greedy tokens; K2 and K1 inside
   ``shard_map``): the mesh-less cells' tokens and exact launches; (c)
   one deepseek-moe-16b block's ``moe_fwd`` under "local" and "a2a"
   equal to the mesh-less dispatch to the bit;
26. the ported examples and tools (``phase_examples``, budget 150 s and
   45 GB peak, both gated), each through its own ``main`` at the full
   width of the reference's archs cut in depth: (a)
   ``examples_torch/quickstart.py`` on yi-9b at 2 of 48 layers (seq 64,
   batch 8 in 4 chunks, 100 steps) to DONE, the final loss under the
   first step's; (b) ``preemptive_cluster.py``, two yi-9b batch jobs at 1
   of 48 layers and a qwen3-8b prod job at 1 of 36 under PRE_MG: an
   eviction, every job done, the evicted one at its last step; (c)
   ``checkpoint_restore.py`` on mamba2-1.3b at 4 of 48 layers: the job
   recovered on the surviving node with an uninterrupted run's final
   parameters, bit for bit; (d) ``elastic_serving.py`` on yi-9b at 2 of
   48 layers, its base rate scaled by one replica's measured rate: every
   request once, drained back to one replica, K2 and K1 paged exactly
   over every replica, 16 requests' tokens equal to one engine's alone;
   (e) ``tools/cluster_smoke_torch.py`` to ``CLUSTER SMOKE OK`` and
   ``tools/smoke_all_torch.py`` over the ten reduced archs, launches
   exact by arch; (f) ``tools/trace_dump_torch.py``'s check of phase
   15's Chrome trace.

Each model's weights are freed before the next model's phases.  The last
line of a run of every phase is ``{"ok": true, "device": {...}}`` (of a
subset, ``{"ok": "partial", "phases": [...], ...}``); the line before it is the card's
name and power limit, and the one before that lists every kernel with its
launches on its main path and its numbers.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the H100 SXM's peaks (HBM3 bytes/s; dense bf16 and f32 FLOP/s, no TF32),
# the port's roofline constants (fails outside a checkout of the repo)
from repro_torch.launch.roofline import HBM_BW as PEAK_BYTES_S  # noqa: E402
from repro_torch.launch.roofline import PEAK_FLOP_S  # noqa: E402

SEED = 0
# kernel vs plain version: |kernel - plain| <= ATOL + RTOL * |plain|, by
# (kernel, dtype).  The plain version rounds scores and probabilities to the
# working type where the kernels keep f32, so bf16 differs by a few bf16
# ulps.  K2's largest errors sit in the first causal rows, which average few
# keys and so have outputs of order 1; K1 averages 256-640 slots, its
# outputs are about 0.05, and its bound is tighter.
TOL = {("K1", "bfloat16"): (5e-3, 1e-2), ("K2", "bfloat16"): (2e-2, 2e-2),
       ("K1", "float32"): (1e-4, 1e-4), ("K2", "float32"): (1e-4, 1e-4)}
# K2 at Sq != Skv (cross attention) in bf16 is also held in L2 to the
# plain version on f32 copies of the inputs: ||kernel - plain32|| /
# ||plain32|| <= K2_CROSS_L2.  Its outputs average about Skv keys and are
# small (std about 0.05), where TOL's atol would hide a fault of the Skv
# mask: keys past Skv (zeros from the wgmma route's tensor maps, which load
# whole tiles of K2_TK keys) let into the softmax shrink every output by
# about 1.4 % at Skv 1000.  The script also computes that fault (the plain
# version over k/v zero-padded to a multiple of K2_TK) and fails unless it
# reads above the bound.
K2_CROSS_L2 = 5e-3
K2_TK = 64
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
          "profile_recurrentgemma", "evict_new", "engine", "features",
          "disagg", "cri", "orch", "train", "dense_archs", "moe", "mla",
          "families", "launch", "mesh", "examples")
# K1's paged entry at the engine's decode shape: one position per lane,
# between 100 and 575 (prompt 512 + 64 tokens)
ENGINE_PAGED_POS = [100, 575, 233, 512, 417, 130, 351, 498]
# ... and at speculative verify's first window (8 lanes, table width 11)
VERIFY_PAGED_POS = [157, 142, 129, 174, 131, 136, 150, 166]
# the full-width serving paths: arch, prompt length, launches expected per
# prefill and per decoded token (batch 8, 4 steps of 8 tokens)
PATHS = {
    "yi": ("yi-9b", 512, {"K2": 48}, {"K1": 48}),
    "mamba2": ("mamba2-1.3b", 1024, {"K3": 48}, {}),
    "recurrentgemma": ("recurrentgemma-9b", 2560, {"K4": 26, "K2": 12},
                       {"K1": 12}),
    # the dense_archs phase: qk-norm; LayerNorm, hd 80 (MHA); LayerNorm,
    # GELU, group 12
    "qwen3": ("qwen3-8b", 512, {"K2": 36}, {"K1": 36}),
    "stablelm": ("stablelm-3b", 512, {"K2": 32}, {"K1": 32}),
    "starcoder2": ("starcoder2-15b", 512, {"K2": 40}, {"K1": 40}),
    # the moe phase: MHA 16/16 heads of 128 in every layer
    "deepseek_moe": ("deepseek-moe-16b", 512, {"K2": 28}, {"K1": 28}),
    # the mla phase (4 of 61 layers): MLA has no kernel, none may launch
    "deepseek_v3": ("deepseek-v3-671b", 512, {}, {}),
    # the families phase, served through ``generate``: seamless-m4t-large-v2
    # (1024 source frames, a target prompt of 256: K2 24 encoder + 24 self
    # + 24 cross per prefill, K1 24 self + 24 cross per token) and
    # llava-next-mistral-7b (2880 image + 192 text positions)
    "seamless": ("seamless-m4t-large-v2", 1024, {"K2": 72}, {"K1": 48}),
    "llava": ("llava-next-mistral-7b", 3072, {"K2": 32}, {"K1": 32}),
    # the mesh phase: yi-9b's prefill and decode cells on a one-rank mesh
    # (cut to 12 of 48 layers), K2 and K1 in shard_map on local shards
    "mesh": ("yi-9b", 512, {"K2": 48}, {"K1": 48}),
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
                softcap=0.0, time_it=False, repeat=False, Skv=None):
    """K2 at q (B, S, Hq, hd) over k/v (B, Skv, Hkv, hd); ``Skv`` defaults
    to S (self attention; cross attention passes its source length)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    t0 = time.perf_counter()
    Skv = S if Skv is None else Skv
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((B, L, H, hd), generator=g, device="cuda").to(dt)
               for L, H in ((S, Hq), (Skv, Hkv), (Skv, Hkv)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = flash_attention(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = check_close(f"K2 {tag}", out, ref, dtype)
    rec = {"case": tag, "shape": [B, S, Hq, Hkv, hd], "dtype": dtype,
           "max_abs_err": err, **kw}
    if Skv != S:
        rec["skv"] = Skv
        if dtype != "float32":
            rec.update(_k2_cross_l2(f"K2 {tag}", q, k, v, out, kw))
    if time_it or repeat:
        rec["bitwise_repeat"] = check_bitwise(
            f"K2 {tag}", lambda: flash_attention(q, k, v, **kw))
    if time_it:
        # visible (q, k) pairs per head: causal rows see i+1 keys
        vis = sum(min(i + 1, window or Skv, Skv) for i in range(S)) \
            if causal else S * Skv
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
    rec["case_s"] = time.perf_counter() - t0
    log(phase="kernels", kernel="K2 flash_attention", **rec)
    state.setdefault("k2", {})[tag] = rec


def _k2_cross_l2(name, q, k, v, out, kw):
    """``out``'s L2 distance from the plain version on f32 copies of the
    inputs, relative, against K2_CROSS_L2; and that of the Skv mask's fault
    (keys past Skv, up to a multiple of K2_TK, let in as zeros), which must
    read above the bound."""
    import torch

    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    ref = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    rel = lambda o: ((o.float() - ref).norm() / ref.norm()).item()  # noqa: E731
    rec = {"l2_vs_f32": rel(out), "l2_bound": K2_CROSS_L2}
    if not rec["l2_vs_f32"] <= K2_CROSS_L2:
        raise AssertionError(f"{name}: L2 error {rec['l2_vs_f32']} against "
                             f"f32 copies (bound {K2_CROSS_L2})")
    pad = -k.shape[1] % K2_TK
    if pad:
        z = k.new_zeros((k.shape[0], pad) + tuple(k.shape[2:]))
        fault = flash_attention_ref(q.float(), torch.cat([k, z], 1).float(),
                                    torch.cat([v, z], 1).float(), **kw)
        rec["l2_of_mask_fault"] = rel(fault)
        if not rec["l2_of_mask_fault"] > K2_CROSS_L2:
            raise AssertionError(f"{name}: a mask fault reads "
                                 f"{rec['l2_of_mask_fault']}, within the "
                                 f"bound {K2_CROSS_L2}")
    return rec


def _ring_kv_pos(cap, pos):
    """kv_pos of a ring cache after positions 0..pos were written: slot s
    holds the newest p <= pos with p % cap == s; unwritten slots 2**30."""
    import torch

    kv = torch.full((cap,), 2 ** 30, dtype=torch.int32)
    for p in range(max(0, pos - cap + 1), pos + 1):
        kv[p % cap] = p
    return kv.cuda()


def _lane_kv_pos(cap, pos):
    """kv_pos (B, cap) of per-lane rings, as the engine's draft and
    reserved lanes hold them: lane b's ring holds positions 0..pos[b] at
    slots 0..pos[b] and, past them, rejected lookahead writes at positions
    above pos[b] (then unwritten slots, 2**30)."""
    import torch

    kv = torch.full((len(pos), cap), 2 ** 30, dtype=torch.int32)
    for b, p in enumerate(pos):
        kv[b, :p + 1] = torch.arange(p + 1, dtype=torch.int32)
        kv[b, p + 1:p + 4] = p + 9
    return kv.cuda()


def _decode_inputs(B, cap, Hq, Hkv, hd, pos, dtype, n_sets=8):
    """K1's dense entry's inputs: ``n_sets`` random (q, k, v) (timing
    cycles through them, so each launch reads its k/v from device memory,
    not from L2, as in a real decode step), kv_pos and the positions."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dt = getattr(torch, dtype)
    if isinstance(pos, list):
        kv_pos = _lane_kv_pos(cap, pos)
        posv = torch.tensor(pos, dtype=torch.int32, device="cuda")
    else:
        kv_pos = _ring_kv_pos(cap, pos)
        posv = torch.tensor([pos], dtype=torch.int32, device="cuda")
    sets = []
    for _ in range(n_sets):
        q = torch.randn((B, 1, Hq, hd), generator=g, device="cuda").to(dt)
        k = torch.randn((B, cap, Hkv, hd), generator=g, device="cuda").to(dt)
        v = torch.randn((B, cap, Hkv, hd), generator=g, device="cuda").to(dt)
        sets.append((q, k, v))
    return sets, kv_pos, posv


def _decode_case(state, tag, B, cap, Hq, Hkv, hd, pos, dtype, window=0,
                 softcap=0.0, time_it=False, repeat=False):
    """K1's dense entry.  ``pos`` an int: one ring shared by the batch
    (``_ring_kv_pos``); a list of B positions: per-lane rings
    (``_lane_kv_pos``, kv_pos (B, cap) and pos (B,))."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          sm_count,
                                                          split_plan)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    t0 = time.perf_counter()
    lanes = isinstance(pos, list)
    sets, kv_pos, posv = _decode_inputs(B, cap, Hq, Hkv, hd, pos, dtype)
    q, k, v = sets[0]
    kw = dict(window=window, softcap=softcap)
    qpos = posv[:, None] if lanes else posv
    keep = (kv_pos <= qpos) & ((qpos - kv_pos < window) if window
                               else torch.ones_like(kv_pos, dtype=torch.bool))
    keep = keep.expand(B, cap)
    kept = int(keep.sum())
    few = int(keep.sum(-1).min())
    out = decode_attention(q, k, v, posv, kv_pos, **kw)
    ref = decode_attention_ref(q, k, v, posv, kv_pos, **kw)
    rec = {"case": tag, "shape": [B, cap, Hq, Hkv, hd], "pos": pos,
           "kept_slots": kept, "dtype": dtype,
           "split": split_plan(B, Hkv, cap, sm_count(q.device)), **kw}
    if few < K1_FEW_SLOTS and dtype != "float32":
        rec["plain_err"] = (out.float() - ref.float()).abs().max().item()
        ref = decode_attention_ref(q.float(), k.float(), v.float(), posv,
                                   kv_pos, **kw)
        rec["plain"] = "float32 copies of the inputs"
    torch.cuda.synchronize()
    rec["max_abs_err"] = check_close(f"K1 {tag}", out, ref, dtype)
    if time_it or repeat:
        rec["bitwise_repeat"] = check_bitwise(
            f"K1 {tag}", lambda: decode_attention(q, k, v, posv, kv_pos,
                                                  **kw))
    if time_it:
        esz = q.element_size()
        nbytes = (2 * kept * Hkv * hd + 2 * q.numel()) * esz \
            + 4 * (kv_pos.numel() + posv.numel())
        flops = 4 * Hq * hd * kept
        bound = max(flops / PEAK_FLOP_S[dtype], nbytes / PEAK_BYTES_S) * 1e3
        mask = keep.reshape(B, 1, 1, cap)
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
            device_ms=device_ms(kern, sets, expect="decode_split_kernel"),
            library_device_ms=device_ms(lib, lib_sets),
            bytes=nbytes, flops=flops, bound_ms=bound,
            bound_by="operations" if flops / PEAK_FLOP_S[dtype]
            > nbytes / PEAK_BYTES_S else "bytes")
    rec["case_s"] = time.perf_counter() - t0
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


def _gathered_sdpa_sets(sets, kvp, bt, posv, window):
    """SDPA's operands for the paged yardstick: every lane's pages gathered
    beforehand (``gather_lane``) into (B, H, slots, hd) with a (B, 1, 1,
    slots) mask of its kept slots; the gather is not timed.  An inactive
    lane keeps no slot (SDPA gives it NaN; the kernel zeros)."""
    import torch

    from repro_torch.kernels.decode_attention.ref import gather_lane

    out = []
    for q, k, v in sets:
        ks, vs, keep = [], [], []
        for b in range(q.shape[0]):
            kd, vd, kp = gather_lane(k, v, kvp, bt[b])
            ks.append(kd)
            vs.append(vd)
            p = posv[b]
            keep.append((kp <= p) & ((p - kp < window) if window
                                     else torch.ones_like(kp, dtype=bool)))
        out.append((q.transpose(1, 2).contiguous(),
                    torch.cat(ks).transpose(1, 2).contiguous(),
                    torch.cat(vs).transpose(1, 2).contiguous(),
                    torch.stack(keep)[:, None, None, :]))
    return out


def _paged_case(state, tag, B, ps, max_blocks, NP, Hq, Hkv, hd, pos, dtype,
                inactive=(), window=0, time_it=False):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_paged, paged_plan, sm_count)
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_paged_ref

    t0 = time.perf_counter()
    sets, kvp, bt, posv, kept, mapped = _paged_inputs(
        B, ps, max_blocks, NP, Hq, Hkv, hd, pos, dtype, inactive,
        n_sets=12 if time_it else 1)
    q, k, v = sets[0]
    kw = dict(window=window)
    out = decode_attention_paged(q, k, v, kvp, bt, posv, **kw)
    ref = decode_attention_paged_ref(q, k, v, kvp, bt, posv, **kw)
    live = [b for b in range(B) if b not in inactive]
    few = min((min(pos[b] + 1, max_blocks * ps) for b in live), default=0)
    route, chunk, cluster = paged_plan(B, Hkv, max_blocks, ps, q.dtype,
                                       sm_count(q.device))
    rec = {"case": tag, "shape": [B, ps, max_blocks, NP, Hq, Hkv, hd],
           "pos": pos, "inactive": list(inactive), "dtype": dtype,
           "kept_slots": kept, "mapped_pages": mapped, "route": route,
           "chunk": chunk, "cluster": cluster, **kw}
    if 0 < few < K1_FEW_SLOTS and dtype != "float32":
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
        lib = lambda q, k, v, m: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=m, enable_gqa=True)
        # the yardsticks work lane by lane on the host (one gather and one
        # launch a row): two of the input sets and fewer rounds keep them
        # to seconds at 64 and 128 rows
        few = args[:2]
        rec.update(
            ms=bench_ms(kern, args),
            device_ms=device_ms(kern, args, expect="decode_split_kernel"
                                if route == "slots" else
                                "decode_paged_kernel"),
            plain_ms=bench_ms(lambda q, k, v: decode_attention_paged_ref(
                q, k, v, kvp, bt, posv, **kw), few, reps=3),
            gather_dense_ms=device_ms(lambda q, k, v: _gather_dense(
                q, k, v, kvp, bt, posv), few, reps=3),
            # no PyTorch call reads pages in place: SDPA on lanes gathered
            # beforehand is the yardstick, the gather untimed
            library_ms=None, library_gathered_device_ms=device_ms(
                lib, _gathered_sdpa_sets(sets[:2], kvp, bt, posv, window)),
            yardstick_sets=len(few), timed_sets=len(args),
            bytes=nbytes, flops=flops, bound_ms=bound,
            bound_by="operations" if flops / PEAK_FLOP_S[dtype]
            > nbytes / PEAK_BYTES_S else "bytes")
    rec["case_s"] = time.perf_counter() - t0
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

    from repro_torch.models.transformer import DECODE_ROWS

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
    # width 36 (prompt 512 + 64 tokens), unmapped tails (K1 paged runs
    # over the lanes alone, never the idle rows that pad the decode's
    # products to DECODE_ROWS); then page size 4, an inactive lane, a
    # position on a page boundary, positions past the mapped span, a window
    _paged_case(state, "path", 8, 16, 36, 288, 32, 4, 128, ENGINE_PAGED_POS,
                "bfloat16", time_it=True)
    _paged_case(state, "path_f32", 8, 16, 36, 288, 32, 4, 128,
                ENGINE_PAGED_POS, "float32", time_it=True)
    # the floor: the engine's shape with every lane inactive (launch, table
    # row, merge; no page read)
    _paged_case(state, "floor_inactive", 8, 16, 36, 288, 32, 4, 128,
                ENGINE_PAGED_POS, "bfloat16", inactive=tuple(range(8)),
                time_it=True)
    # the engine phase's run (d): DECODE_ROWS lanes; and twice as many,
    # where the decode runs its products in two blocks of DECODE_ROWS
    for case, lanes in (("engine_d", DECODE_ROWS),
                        ("rows_2r", 2 * DECODE_ROWS)):
        _paged_case(state, case, lanes, 16, 36, 36 * lanes, 32, 4, 128,
                    [ENGINE_PAGED_POS[i % 8] for i in range(lanes)],
                    "bfloat16", time_it=True)
    _paged_case(state, "ps4_inactive_boundary", 4, 4, 40, 160, 32, 4, 128,
                [100, 64, 159, 12], "bfloat16", inactive=(1,))
    _paged_case(state, "past_span", 3, 16, 8, 32, 32, 4, 128,
                [127, 300, 4000], "bfloat16")
    _paged_case(state, "window_hd256", 2, 16, 20, 48, 16, 1, 256,
                [250, 319], "bfloat16", window=100)
    # the features phase's new call patterns: the paged entry at one lane
    # (prefill_chunk: page 3 of a 64-token prompt, a table row of 5 pages
    # of 16), verify's k+1 = 4 steps whose windows cross page boundaries
    # (8 lanes, table width 11 = prompt 128 + 32 + 3), and
    # the dense entry
    # with per-lane positions at the draft lanes' shape (rings of 163
    # slots) and the reserved lanes' (160)
    _paged_case(state, "chunk_b1", 1, 16, 5, 40, 32, 4, 128, [53],
                "bfloat16", time_it=True)
    # the disagg phase's decode replica: 14 lanes, tables of 37 pages of
    # 16 over its 518-page pool
    _paged_case(state, "disagg_decode", 14, 16, 37, 518, 32, 4, 128,
                DISAGG_PAGED_POS, "bfloat16", time_it=True)
    for i in range(4):
        _paged_case(state, f"verify_w{i}", 8, 16, 11, 88, 32, 4, 128,
                    [p + i for p in VERIFY_PAGED_POS], "bfloat16",
                    time_it=i == 0)
    _decode_case(state, "draft", 8, 163, 32, 4, 128,
                 [128, 150, 131, 140, 159, 129, 133, 147], "bfloat16",
                 time_it=True)
    _decode_case(state, "draft_f32", 8, 163, 32, 4, 128,
                 [128, 150, 131, 140, 159, 129, 133, 147], "float32",
                 repeat=True)
    _decode_case(state, "reserved", 8, 160, 32, 4, 128,
                 [131, 140, 159, 129, 133, 147, 128, 150], "bfloat16",
                 time_it=True)
    # the dense_archs phase's shapes, bf16 and f32: stablelm-3b (hd 80 over
    # 32/32 heads, MHA: K1's rows padded to 128 in shared memory, K2's
    # second 64-column sub-tile zero past column 80, scale 80^-0.5) and
    # starcoder2-15b (48/4: group 12, two 8-head n-tiles in K1 paged); K2
    # at the serving prefill, K1 dense at its decode (cap 512 + 128, pos
    # 600), K1 paged at the engine's decode (8 lanes);
    # qwen3-8b's (32/8) in bf16; bf16 timed, f32 checked only
    for tag, Hq, Hkv, hd, dtypes in (
            ("hd80", 32, 32, 80, ("bfloat16", "float32")),
            ("g12", 48, 4, 128, ("bfloat16", "float32")),
            ("qwen3", 32, 8, 128, ("bfloat16",))):
        for dt in dtypes:
            case = f"{tag}_path" + ("_f32" if dt == "float32" else "")
            t = dt == "bfloat16"
            _flash_case(state, case, 8, 512, Hq, Hkv, hd, dt, time_it=t)
            _decode_case(state, case, 8, 640, Hq, Hkv, hd, 600, dt,
                         time_it=t)
            _paged_case(state, case, 8, 16, 36, 288, Hq, Hkv, hd,
                        ENGINE_PAGED_POS, dt, time_it=t)
    # the moe phase's deepseek-moe-16b (MHA, 16/16 heads of 128): the same
    # three shapes, bf16 timed (same bits on repeat), f32 checked against
    # the plain version; K2 also at the engine's B 1 admissions
    for dt in ("bfloat16", "float32"):
        case = "mha128_path" + ("_f32" if dt == "float32" else "")
        t = dt == "bfloat16"
        _flash_case(state, case, 8, 512, 16, 16, 128, dt, time_it=t)
        _decode_case(state, case, 8, 640, 16, 16, 128, 600, dt, time_it=t)
        _paged_case(state, case, 8, 16, 36, 288, 16, 16, 128,
                    ENGINE_PAGED_POS, dt, time_it=t)
    for P in ENGINE["prompt_buckets"]:
        _flash_case(state, f"mha128_engine_p{P}", 1, P, 16, 16, 128,
                    "bfloat16", time_it=True)
    # the families phase's shapes, bf16 and f32, each timed (same bits on
    # repeat): seamless-m4t-large-v2 (16/16 heads of 64) K2 over the
    # encoder's 1024 frames (non-causal), the cross attention at prefill
    # (256 target rows against 1024 frames, non-causal; and a ragged 200
    # against 1000), the decoder's causal prefill of 256; K1 over the
    # decoder's self ring (cap 256 + 128, at pos 270) and over the cross
    # cache (1024 slots, kv_pos 0..1023, pos 1023); llava-next-mistral-7b
    # (32/8 heads of 128) K2 over 2880 image + 192 text positions, causal,
    # and K1 at its decode (cap 3072 + 128, pos 3100)
    for dt in ("bfloat16", "float32"):
        sfx = "_f32" if dt == "float32" else ""
        for case, S, Skv, causal in (("enc", 1024, 1024, False),
                                     ("cross", 256, 1024, False),
                                     ("cross_ragged", 200, 1000, False),
                                     ("dec_prefill", 256, 256, True)):
            _flash_case(state, case + sfx, 8, S, 16, 16, 64, dt,
                        causal=causal, Skv=Skv, time_it=True)
        _flash_case(state, "llava" + sfx, 8, 3072, 32, 8, 128, dt,
                    time_it=True)
        _decode_case(state, "seamless_self" + sfx, 8, 384, 16, 16, 64, 270,
                     dt, time_it=True)
        _decode_case(state, "cross" + sfx, 8, 1024, 16, 16, 64, 1023, dt,
                     time_it=True)
        _decode_case(state, "llava" + sfx, 8, 3200, 32, 8, 128, 3100, dt,
                     time_it=True)
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


def _zero_counts():
    """Zeroes every wrapper's count and tally by shape (K1 dense, K1
    paged, K2) and K1 paged's one-lane count."""
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_paged

    for w in _wrappers().values():
        w.launches = 0
        if hasattr(w, "launches_by_shape"):
            w.launches_by_shape.clear()
    decode_attention_paged.launches_b1 = 0


def _counts():
    """Every wrapper's count, and K1 paged's launches at one lane apart
    (``K1p_b1``, counted by the wrapper and included in ``K1p``)."""
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_paged

    return {**{k: w.launches for k, w in _wrappers().items()},
            "K1p_b1": decode_attention_paged.launches_b1}


def _attn_layers(cfg):
    """Layers whose mixer is GQA attention, each one K2 launch a prefill
    and one K1 (paged) launch a decode step; MLA's layers launch neither
    (K2 takes hd_v == hd only, and MLA decode is plain tensor code, as in
    the reference)."""
    from repro_torch.models.transformer import plan_segments

    return sum(s.count for s in plan_segments(cfg) for b in s.blocks
               if b.mixer == "attn")


def _plain_kw(cfg):
    """The plain path's build options besides its plain impls: MLA has no
    kernel, so its plain path decodes decompressed (the reference's
    baseline) against the kernel path's absorbed form."""
    return {"mla_absorb": False} if cfg.mla.enabled else {}


def _serve(state, key, device="cuda", arch=None, prompt_len=None):
    """``PATHS[key]`` served to DONE through the runtime, with its exact
    launch counts on the card; ``arch`` and ``prompt_len`` override the
    path's (a rehearsal on the CPU, where the wrappers launch nothing)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import (FunkyRuntime, SliceAllocator, TaskImage,
                                  TaskStatus)

    p_arch, p_len, per_prefill, per_token = PATHS[key]
    arch, prompt_len = arch or p_arch, prompt_len or p_len
    cfg = get_arch(arch)
    full = get_arch(p_arch).num_layers
    if device == "cuda" and cfg.num_layers != full:
        # a depth cut of the path's dense arch (``_depth_cut``): one launch
        # a layer, so the counts of its layers
        per_prefill, per_token = ({k: n * cfg.num_layers // full
                                   for k, n in d.items()}
                                  for d in (per_prefill, per_token))
    im = TaskImage(name="chip-smoke", kind="serve", arch=arch,
                   prompt_len=prompt_len, global_batch=8, total_steps=4,
                   tokens_per_step=8, seed=SEED)
    n_tok = im.total_steps * im.tokens_per_step
    rt = FunkyRuntime("node0", SliceAllocator("node0", 1,
                                              mem_cap_bytes=64 << 30,
                                              device=device))
    wrappers = _wrappers()
    if device == "cuda":
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
    if device == "cuda" and launches != expected:
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
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9
        if device == "cuda" else None,
        launches=launches, last_token=last)
    rt.delete("serve0")
    del rec, rt
    if device == "cuda":
        _free_cuda()
    return {"wall_s": wall, "prefill_s": ex[1],
            "decode_token_s_median": statistics.median(decode_s),
            "decode_tokens_per_s": im.global_batch * n_tok / sum(decode_s)}


def phase_serve(state):
    _serve(state, "yi")


def phase_serve_mamba2(state):
    _serve(state, "mamba2")


def phase_serve_recurrentgemma(state):
    _serve(state, "recurrentgemma")


# ---------------------------------------------------------------------------
# 4. kernel path against plain path at full width
# ---------------------------------------------------------------------------

def _logit_parity(cfg, S, alt=None, device="cuda", pin=None):
    """The kernel path and the plain path (and ``alt``, a plain path that
    differs from it only in the order of its sums) on one set of weights:
    prefill, then 4 decode steps of the kernel path's tokens.  Returns the
    weights, max|logit - plain| / max|plain| per step for each path, and
    the kernel path's greedy-token agreement with the plain path.  With
    ``pin`` (``_routing_pin``), the plain path takes the kernel path's MoE
    routing (tags "s<step>_kernel" and "s<step>_naive"), and "unpinned"
    is the kernel path against the plain path on its own routing."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.train import make_batch

    bundles = {"kernel": build_model(cfg),
               "plain": build_model(cfg, prefill_impl="naive",
                                    decode_impl="naive", **_plain_kw(cfg))}
    if alt is not None:
        bundles["alt"] = alt
    if pin is not None:
        bundles["unpinned"] = bundles["plain"]
    params = bundles["kernel"].init(SEED, device=device)
    toks = torch.as_tensor(make_batch(cfg, ShapeConfig("p", "train", S, 8),
                                      0)["tokens"]).to(device)
    rels = {k: [] for k in bundles if k != "plain"}
    agree = []

    def pinned(k, i):
        if pin is None or k not in ("kernel", "plain"):
            return contextlib.nullcontext()
        return pin(f"s{i}_" + ("kernel" if k == "kernel" else "naive"))

    with torch.no_grad():
        res = {}
        for k, b in bundles.items():
            with pinned(k, 0):
                res[k] = b.prefill_fn(params, {"tokens": toks})
        for i in range(5):
            lp = res["plain"][0].float()
            for k in rels:
                # "unpinned": the kernel path against the plain path on
                # its own routing
                out, ref = ((res["kernel"][0].float(), res[k][0].float())
                            if k == "unpinned" else (res[k][0].float(), lp))
                rels[k].append(((out - ref).abs().max()
                                / ref.abs().max()).item())
            tk = res["kernel"][0].argmax(-1)
            agree.append((tk == lp.argmax(-1)).float().mean().item())
            if not ((0 <= tk) & (tk < cfg.vocab_size)).all():
                raise AssertionError("token out of range")
            if i == 4:
                break
            # every path decodes the kernel path's tokens (same inputs)
            tok = tk.to(torch.int32)
            for k in list(res):
                with pinned(k, i + 1):
                    res[k] = bundles[k].decode_fn(params, tok, S + i,
                                                  res[k][1], inplace=True)
    return params, rels, agree


def _parity(state, key, device="cuda", arch=None):
    """yi-9b and the dense_archs phase's archs: the served bf16 model,
    kernel path within LOGIT_REL_TOL of the plain path (``arch``
    overrides the path's, a rehearsal on the CPU).  mamba2-1.3b and
    recurrentgemma-9b: in f32, within
    PARITY_F32_TOL; in bf16, within LOGIT_REL_TOL or twice the plain path's
    own spread under a reordering of its sums, whichever is larger (at full
    width these random-weight models amplify one bf16 rounding flip per
    layer into several percent of the logits; see PERF.md).  MoE archs:
    the plain path takes the kernel path's routing (``_routing_pin``); the
    log adds the kernel path against the plain path on its own routing
    ("unpinned", not gated) and, step by step, the rows whose top-k
    expert set the plain path's router would have picked otherwise."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    if device == "cuda" and torch.cuda.memory_allocated() > 1e9:
        raise RuntimeError("an earlier phase's weights are still on the card")
    p_arch, S = PATHS[key][:2]
    arch = arch or p_arch
    cfg = get_arch(arch)
    if key in ("mamba2", "recurrentgemma"):
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
    routing = {}
    params, rels, agree = _logit_parity(
        cfg, S, alt, device,
        pin=_routing_pin(routing) if cfg.moe.enabled else None)
    bounds = [max(LOGIT_REL_TOL, 2 * r) for r in rels.get("alt", [0.0] * 5)]
    extra = {}
    if cfg.moe.enabled:
        extra = {"unpinned_logit_rel_err": rels["unpinned"],
                 "routing": [_routing_diff(cfg, routing, f"s{i}_kernel",
                                           f"s{i}_naive") for i in range(5)]}
    log(phase="parity", arch=arch, dtype=cfg.dtype,
        logit_rel_err=rels["kernel"], token_agreement=agree,
        plain_spread=rels.get("alt"), bound=bounds, **extra)
    if any(r > b for r, b in zip(rels["kernel"], bounds)):
        raise AssertionError(f"{arch}: kernel vs plain logits differ by "
                             f"{rels['kernel']} (bounds {bounds})")
    if key in ("yi", "mamba2", "recurrentgemma"):
        state["full_params"] = (key, params)     # reused by the profile phase
    del params
    if device == "cuda":
        _free_cuda()
    return {"logit_rel_err": rels["kernel"], "token_agreement": agree,
            **extra}


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
KERNEL_SYMBOLS = {"K1": ("decode_split_kernel", "decode_paged_kernel"),
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
# yi-9b at full width cut to ``layers`` of its 48, as the features,
# disagg and cri phases cut it (its run (a) is their reference
# transcript): the whole script passed 1000 s on a host whose host-bound
# phases ran 25-45% slower than usual; the orch phase still serves the
# engine at full depth
ENGINE = dict(arch="yi-9b", layers=12, slots=8, page_size=16,
              prompt_buckets=(128, 512), prompt_len=512, max_new_tokens=64,
              pool_pages=160, n_requests=24)


# run (d): the engine at 64 lanes, pages enough for every lane's whole
# context (64 x 37), serving 64 requests of the same generator (the first
# 24 are runs (a)-(c)'s)
ENGINE_D = dict(ENGINE, slots=64, pool_pages=64 * 37, n_requests=64)


def engine_requests(vocab, n=ENGINE["n_requests"]):
    """The engine phase's workload (``n`` requests), from seed 0."""
    import numpy as np

    from repro_torch.serve.engine import ServeRequest

    rng = np.random.default_rng(SEED)
    out = []
    for i in range(n):
        n_prompt = int(rng.integers(64, 513))
        n_new = int(rng.integers(8, 65))
        out.append(ServeRequest(
            rid=f"q{i:02d}", prompt=rng.integers(0, vocab, n_prompt).astype(
                np.int32), max_new_tokens=n_new))
    return out


def _engine_kw(ec=ENGINE):
    return dict(slots=ec["slots"], prompt_len=ec["prompt_len"],
                max_new_tokens=ec["max_new_tokens"],
                page_size=ec["page_size"], pool_pages=ec["pool_pages"],
                prompt_buckets=ec["prompt_buckets"])


@contextlib.contextmanager
def _depth_cut(arch, layers):
    """``arch`` cut to ``layers`` layers (depth only, full width),
    registered in the port's arch registry while the block runs; ``arch``
    itself where it has no more than ``layers`` (the smoke archs of a
    rehearsal on the CPU)."""
    from repro_torch.configs import get_arch, registry

    base = get_arch(arch)
    if layers is None or base.num_layers <= layers:
        yield arch
        return
    names = []
    _train_cut(base, layers, names)
    try:
        yield names[0]
    finally:
        registry.ARCHS.pop(names[0], None)


def _reference_tokens(state, arch, device):
    """Run (a)'s tokens at ``arch``: the engine phase's own where ``arch``
    is its model at its depth, else the 24 requests served once
    single-step through the runtime (``_engine_served``), kept in ``state``
    for the next phase at the same cut.  Returns (tokens, where they come
    from)."""
    if arch == state.get("engine_arch") and "engine_tokens" in state:
        return state["engine_tokens"], "engine phase run (a)"
    refs = state.setdefault("reference_tokens", {})
    if arch not in refs:
        refs[arch] = _engine_served(arch, device, 1, 0, "ref")[0]
    return refs[arch], f"run (a) at {arch}"


def _check_engine_run(tag, cfg, eng, tokens, fuse, launches, device,
                      ec=ENGINE):
    """Every request completed with its token count; the kernels the path
    launched, exactly: paged K1 once an attention layer per decode step
    run, K2 once an attention layer per prefill run (recomputations
    included), nothing else (an MLA model: nothing at all)."""
    want = {r.rid: min(r.max_new_tokens, ec["max_new_tokens"])
            for r in engine_requests(cfg.vocab_size, ec["n_requests"])}
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
    L = _attn_layers(cfg)
    expected = {"K1": 0, "K1p": L * steps, "K2": L * prefills, "K3": 0,
                "K4": 0}
    if device == "cuda" and launches != expected:
        raise AssertionError(f"engine {tag}: launch counts {launches}, "
                             f"expected {expected} ({steps} decode steps, "
                             f"{prefills} prefills)")
    return steps, prefills


def _tbt_req_mean_p50(completed):
    """p50 over requests of each one's mean time between tokens.  A fused
    decode commits a span of tokens at once (the gaps inside a span are 0),
    so the p50 over single gaps says nothing there; a request's mean gap is
    its time per token after the first, handoffs included."""
    import numpy as np

    means = [sum(c.tbts) / len(c.tbts) for c in completed if c.tbts]
    return float(np.percentile(means, 50)) if means else None


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
            "tbt_req_mean_p50_s": _tbt_req_mean_p50(completed),
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


def _engine_served(arch, device, fuse, async_depth, tag, ec=ENGINE):
    """One run through the runtime: router -> EngineServeTask -> engine,
    the first ``ec["n_requests"]`` requests on ``ec``'s lanes and pool.
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
                   global_batch=ec["slots"], prompt_len=ec["prompt_len"],
                   max_new_tokens=ec["max_new_tokens"],
                   page_size=ec["page_size"], kv_pool_pages=ec["pool_pages"],
                   prompt_buckets=ec["prompt_buckets"],
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
    for r in engine_requests(cfg.vocab_size, ec["n_requests"]):
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
                                        launches, device, ec)
    stats = _engine_stats(eng, list(router.completed.values()), wall,
                          steps, prefills, launches)
    if device == "cuda":
        stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rt.delete("e")
    del rec, rt, eng
    if device == "cuda":
        _free_cuda()
    return tokens, stats


def _paged_logit_check(eng, mon, cfg, capture=None):
    """One decode step of every lane on the engine's own pool, on the
    paged kernel path and on ``impl="naive"`` (gather + sdpa_naive; MLA:
    gather + decompressed decode against the absorbed form), on copies of
    the pool; max|logit diff| / max|logit| over the active lanes.  The
    kernel path's compared step must launch paged K1 once an attention
    layer and nothing else.  Then that step again, warm: timed, and
    traced (device time, busy share, launches).  These launches are
    comparisons and measurements: the counts are restored.
    ``capture(tag)``, a context manager, wraps each path's compared step
    (tags "kernel", "naive")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_paged
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    saved = {k: w.launches for k, w in _wrappers().items()}
    saved_shape = dict(decode_attention_paged.launches_by_shape)
    buf = {n: mon.buffers.get(n).device_value
           for n in ("params", "toks", "pos", "block_table", "kv_pool")}
    active = buf["block_table"][:, 0] >= 0
    out = {}
    with torch.no_grad():
        for impl in ("kernel", "naive"):
            b = build_model(cfg, cache_margin=0, decode_impl=impl,
                            **(_plain_kw(cfg) if impl == "naive" else {}))
            pool = tree_map(torch.clone, buf["kv_pool"])
            n0 = _counts()
            with capture(impl) if capture else contextlib.nullcontext():
                logits, _ = b.decode_paged_fn(
                    buf["params"], buf["toks"][:, 0], buf["pos"], pool,
                    buf["block_table"])
            out[impl] = logits.float()[active]
            if impl == "kernel":
                launched = {k: n - n0[k] for k, n in _counts().items()}
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
    decode_attention_paged.launches_by_shape.clear()
    decode_attention_paged.launches_by_shape.update(saved_shape)
    want = {**{k: 0 for k in launched}, "K1p": _attn_layers(cfg)}
    if launched != want:
        raise AssertionError(f"{cfg.name}: a paged decode step launched "
                             f"{launched}, expected {want}")
    ref = out["naive"]
    rel = ((out["kernel"] - ref).abs().max() / ref.abs().max()).item()
    agree = (out["kernel"].argmax(-1) == ref.argmax(-1)).float().mean()
    return {"logit_rel_err": rel, "token_agreement": agree.item(),
            "lanes": int(active.sum()),
            "active_rows": active.nonzero().flatten().tolist(),
            "bound": LOGIT_REL_TOL,
            "decode_step_warm_s": step_s, "decode_trace": trace}


def _prefill_logit_check(eng, mon, cfg, capture=None):
    """One admission's prefill per prompt bucket, at the engine's shape
    (batch 1, the first request of the workload that the bucket takes,
    right-padded as the engine pads it), on the engine's weights: the
    kernel path (K2, one launch a layer) against ``prefill_impl="naive"``,
    max|logit diff| / max|logit| of the first token's logits.  These
    launches are comparisons: the counts are restored.  ``capture(tag)``
    wraps each prefill (tags "p<bucket>_kernel", "p<bucket>_naive")."""
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
                with capture(f"p{P}_{impl}") if capture \
                        else contextlib.nullcontext():
                    logits[impl] = b.prefill_fn(
                        params, {"tokens": prompt})[0].float()
                n = flash_attention.launches - n0
                if n != (_attn_layers(cfg) if impl == "kernel" else 0):
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


def _engine_wide(arch, device, ec=ENGINE_D, logit_at=6):
    """Run (d): ``ec``'s requests on ``ec``'s lanes, the engine on a
    monitor (``equivalence.run_transcript``); at iteration ``logit_at``
    (every lane of run (d) busy: its shortest request decodes 8 tokens),
    one paged decode step's kernel-vs-plain logit check, timed and traced
    (``_paged_logit_check``).  Gates: every request's
    token count; K1 paged once an attention layer a decode step, every
    launch at the padded rows of ``ec["slots"]`` lanes; K2 once an
    attention layer an admission, every launch at batch 1 and a prompt
    bucket.  Returns ({rid: tokens}, stats, the logit check)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import FunkyCL, Monitor, SliceAllocator
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_paged
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.scaling.metrics import MetricsRegistry
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.equivalence import run_transcript

    cfg = get_arch(arch)
    checks = []

    def factory():
        mon = Monitor("engine-d", SliceAllocator("node0", 1,
                                                 mem_cap_bytes=64 << 30,
                                                 device=device),
                      telemetry=MetricsRegistry())
        eng = ContinuousBatchingEngine(arch, FunkyCL(mon), seed=SEED,
                                       engine_id="engine-d",
                                       **_engine_kw(ec))
        eng.setup()
        _zero_counts()
        return mon, eng

    def hook(eng, mon, i):
        if i == logit_at:
            checks.append(_paged_logit_check(eng, mon, cfg)
                          if device == "cuda" else {})
            checks[0].update(at_iteration=i, active=eng.active_count)

    t0 = time.perf_counter()
    tokens, eng = run_transcript(
        factory, lambda: engine_requests(cfg.vocab_size, ec["n_requests"]),
        step_hook=hook)
    wall = time.perf_counter() - t0
    launches = _counts()
    launches.pop("K1p_b1")
    steps, prefills = _check_engine_run("d", cfg, eng, tokens, 1, launches,
                                        device, ec)
    stats = _engine_stats(eng, list(eng.completed.values()), wall, steps,
                          prefills, launches)
    rows = ec["slots"]
    L = _attn_layers(cfg)
    k1p = dict(decode_attention_paged.launches_by_shape)
    k2 = dict(flash_attention.launches_by_shape)
    stats.update(rows=rows, k1p_by_shape=[[list(k), n] for k, n in
                                          k1p.items()],
                 k2_by_shape=[[list(k), n] for k, n in k2.items()])
    want_k1p = {(rows, eng.max_blocks): L * steps}
    if device == "cuda" and (
            k1p != want_k1p or sum(k2.values()) != L * prefills
            or any(k[0] != 1 or k[1] not in ec["prompt_buckets"]
                   for k in k2)):
        raise AssertionError(f"engine d: K1 paged by shape {k1p} (want "
                             f"{want_k1p}), K2 by shape {k2} (want "
                             f"{L * prefills} at batch 1 and a bucket)")
    if not checks:
        raise AssertionError(f"engine d: ended before iteration {logit_at}")
    del eng
    if device == "cuda":
        _free_cuda()
    return tokens, stats, checks[0]


def _engine_evicting(arch, device, logit_at=6, every=16):
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
    """yi-9b at full width cut to ``ENGINE["layers"]`` of its 48 layers
    (bf16, random weights from seed 0) served by the
    paged engine four ways: (a) single-step decode and (b) 8 steps fused
    per EXECUTE with one EXECUTE in flight, both through
    RequestRouter -> EngineServeTask -> FunkyRuntime; (c) run (a) on a
    monitor with evict/resume every 16 iterations (each resume copies the
    weights back, 5.26 GB at 12 layers); (d) 64 requests on a 64-lane
    engine on a monitor (``ENGINE_D``).  Gates: every request
    completes with its token count, the three transcripts are identical
    and (d) gives run (a)'s 24 requests run (a)'s tokens,
    exact launch counts ((d): K1 paged and K2 at their shapes), at least
    one OOM preemption and one compaction,
    an evict that saves fewer pages than the pool, and the logits of a
    paged decode step (at 8 lanes and, in (d), at 64) and of each bucket's
    prefill (K2 at batch 1) on the kernel path within LOGIT_REL_TOL of the
    plain path's."""
    with _depth_cut(arch, ENGINE["layers"]) as cut:
        _engine_phase(state, cut, device)


def _engine_phase(state, arch, device):
    a_tok, a = _engine_served(arch, device, 1, 0, "a")
    log(phase="engine", run="a_single_step", card=state.get("card"), **a)
    b_tok, b = _engine_served(arch, device, 8, 1, "b")
    log(phase="engine", run="b_fused8_async1", card=state.get("card"), **b)
    c_tok, c, evicts, checks, prefill_checks = _engine_evicting(arch, device)
    log(phase="engine", run="c_evict_resume_every16", card=state.get("card"),
        evicts=len(evicts), evict_first=evicts[0] if evicts else None,
        evict_last=evicts[-1] if evicts else None, logit_check=checks,
        prefill_logit_check=prefill_checks, **c)
    d_tok, d, d_check = _engine_wide(arch, device)
    log(phase="engine", run="d_64_lanes", card=state.get("card"),
        logit_check=d_check, a_step=checks[0] if checks else None, **d)
    for tag, tok in (("b", b_tok), ("c", c_tok),
                     ("d", {r: d_tok[r] for r in a_tok})):
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
    if device == "cuda" and d_check["logit_rel_err"] > LOGIT_REL_TOL:
        raise AssertionError(f"run d: paged kernel vs plain logits at "
                             f"{d_check['lanes']} lanes: {d_check}")
    if device == "cuda" and (
            len(prefill_checks) != len(ENGINE["prompt_buckets"])
            or any(p["logit_rel_err"] > LOGIT_REL_TOL
                   for p in prefill_checks)):
        raise AssertionError(f"prefill kernel vs plain logits: "
                             f"{prefill_checks}")
    state.setdefault("launches", {})["engine"] = a["launches"]
    state["engine"] = {"a": a, "b": b, "c": c, "d": d}
    state["engine_tokens"], state["engine_arch"] = a_tok, arch


# ---------------------------------------------------------------------------
# 15. the engine's features: tracing, prefix cache, speculative decode,
#     reserved mode
# ---------------------------------------------------------------------------

# yi-9b at full width cut to ``layers`` of its 48 (a whole run took 82-134
# s of a script near its time limit; the decode step is host-bound, so its
# time goes with the depth); (d) the engine phase's configuration and its
# first 8 requests; (e) two
# 48-token system prefixes (3 pages of 16), four requests each with its
# own 16-token tail; (f) and (g) 8 prompts of 128 tokens, 32 new tokens
FEATURES = dict(arch="yi-9b", layers=12, d_requests=8, slots=8,
                page_size=16,
                e_prefix=48, e_tail=16, e_new=16, f_prompt=128, f_new=32,
                f_k=3, f_k_reject=2, logit_at=4, max_phase_s=240,
                max_peak_gb=45, mem_cap=64 << 30)


def _feature_engine(fc, device, tag, tracer=None, **kw):
    """A factory of (monitor, engine) for one run of the phase: the kernel
    counts are zeroed once the engine has drawn its weights, so they count
    the run's own launches only."""
    from repro_torch.core import FunkyCL, Monitor, SliceAllocator
    from repro_torch.scaling.metrics import MetricsRegistry
    from repro_torch.serve.engine import ContinuousBatchingEngine

    def make():
        mon = Monitor(f"features-{tag}", SliceAllocator(
            "node0", 1, mem_cap_bytes=fc["mem_cap"], device=device),
            telemetry=MetricsRegistry(), tracer=tracer)
        eng = ContinuousBatchingEngine(fc["arch"], FunkyCL(mon), seed=SEED,
                                       engine_id=f"features-{tag}", **kw)
        eng.setup()
        _zero_counts()
        return mon, eng
    return make


def _feature_run(fc, device, tag, reqs, hook=None, **kw):
    """One run through ``run_transcript``: ({rid: tokens}, engine, the
    run's launches, wall seconds)."""
    from repro_torch.serve.equivalence import run_transcript

    t0 = time.perf_counter()
    tokens, eng = run_transcript(_feature_engine(fc, device, tag, **kw),
                                 reqs, step_hook=hook)
    wall = time.perf_counter() - t0
    launches = _counts()
    if device == "cuda":
        _free_cuda()
    return tokens, eng, launches, wall


def _expect_launches(tag, launches, expected, device):
    want = {"K1": 0, "K1p": 0, "K1p_b1": 0, "K2": 0, "K3": 0, "K4": 0,
            **expected}
    if device == "cuda" and launches != want:
        raise AssertionError(f"features {tag}: launch counts {launches}, "
                             f"expected {want}")


def _overlap(a0, a1, spans):
    """Seconds of [a0, a1] covered by the disjoint ``spans``."""
    return sum(max(0.0, min(a1, b1) - max(a0, b0)) for b0, b1 in spans)


def _iteration_split(tracer):
    """Where an engine iteration's wall time goes (its ``engine.step``
    trace), in ms: the monitor worker's spans on it (the preparation of
    each EXECUTE, its device phase, the token read), the queue wait net of
    the worker's own busy time (a request waiting while the worker was
    idle: the hand-off), and the engine's host time (the rest).  Medians
    over the iterations, and sums."""
    busy_kinds = ("monitor.execute", "monitor.transfer", "monitor.sync",
                  "monitor.memory")
    rows = []
    for tr in tracer.traces():
        if tr.name != "engine.step" or not tr.finished:
            continue
        spans = tr.spans()[1:]
        busy = [(s.start_t, s.end_t) for s in spans
                if s.name in busy_kinds and s.end_t is not None]
        by = collections.defaultdict(float)
        for s in spans:
            by[s.name] += s.duration
        handoff = sum(s.duration - _overlap(s.start_t, s.end_t, busy)
                      for s in spans if s.name == "monitor.queue_wait")
        worker = sum(b1 - b0 for b0, b1 in busy)
        rows.append({"wall": tr.duration,
                     "engine_host": tr.duration - worker - handoff,
                     "queue_wait": handoff,
                     "execute_prep": by["monitor.execute"]
                     - by["execute.device"],
                     "device": by["execute.device"],
                     "sync": by["monitor.transfer"] + by["monitor.sync"]})
    keys = rows[0].keys() if rows else ()
    return {"iterations": len(rows),
            "median_ms": {k: statistics.median(r[k] for r in rows) * 1e3
                          for k in keys},
            "total_s": {k: sum(r[k] for r in rows) for k in keys}}


def _features_traced(fc, device):
    """(d) the first requests of the engine phase's workload served twice
    through RequestRouter -> engine.pump: untraced, then with one Tracer
    shared by the router, the engine and its monitor."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.obs import Tracer, export_chrome_trace, \
        validate_chrome_trace
    from repro_torch.scaling.serving import RequestRouter

    cfg = get_arch(fc["arch"])
    out = {}
    for traced in (False, True):
        tracer = Tracer(capacity=4096) if traced else None
        mon, eng = _feature_engine(fc, device, "d", tracer=tracer,
                                   **_engine_kw())()
        router = RequestRouter("features-d", registry=eng.registry,
                               kv_aware=False, tracer=tracer)
        t0 = time.perf_counter()
        try:
            for r in engine_requests(cfg.vocab_size)[:fc["d_requests"]]:
                router.submit(r)
            while router.outstanding() or not eng.idle:
                eng.pump(router)
        finally:
            mon.vfpga_exit()
        wall = time.perf_counter() - t0
        tokens = {rid: list(c.tokens) for rid, c in router.completed.items()}
        run = {"wall_s": wall, "tokens": tokens, "launches": _counts(),
               "decode_steps": eng.program_execs.get("decode_step", 0),
               "prefills": sum(n for p, n in eng.program_execs.items()
                               if p.startswith("prefill_admit")),
               "host_device_split": eng.host_device_split()}
        if traced:
            with tempfile.TemporaryDirectory() as tmp:
                path = export_chrome_trace(tracer, f"{tmp}/trace.json")
                with open(path) as f:
                    doc = json.load(f)
            run["chrome_trace"] = validate_chrome_trace(doc)
            run["chrome_trace_events"] = len(doc["traceEvents"])
            trace_doc = doc
            run["iteration_split"] = _iteration_split(tracer)
            adm = [s.duration for t in tracer.traces()
                   for s in t.find_spans("engine.admit")]
            run["admit_ms_median"] = statistics.median(adm) * 1e3
        out["traced" if traced else "untraced"] = run
        del eng
        if device == "cuda":
            _free_cuda()
    L = cfg.num_layers
    for tag, run in out.items():
        _expect_launches(f"(d) {tag}", run["launches"],
                         {"K1p": L * run["decode_steps"],
                          "K2": L * run["prefills"]}, device)
    if out["traced"]["tokens"] != out["untraced"]["tokens"]:
        raise AssertionError("features (d): traced tokens differ from "
                             "untraced")
    if len(out["traced"]["tokens"]) != fc["d_requests"]:
        raise AssertionError("features (d): not every request completed")
    out["traced_over_untraced_wall"] = (out["traced"]["wall_s"]
                                        / out["untraced"]["wall_s"])
    # the examples phase reads it with tools/trace_dump_torch.py
    out["trace_doc"] = trace_doc
    return out


def _prefix_requests(fc, vocab, which=None):
    """(e)'s requests: group g's prefix, then request i's own tail."""
    import numpy as np

    from repro_torch.serve.engine import ServeRequest

    rng = np.random.default_rng(SEED + 22)
    prefixes = [rng.integers(0, vocab, fc["e_prefix"]) for _ in range(2)]
    reqs = []
    for g in range(2):
        for j in range(4):
            tail = rng.integers(0, vocab, fc["e_tail"])
            reqs.append(ServeRequest(
                rid=f"g{g}r{j}", prompt=np.concatenate(
                    [prefixes[g], tail]).astype(np.int32),
                max_new_tokens=fc["e_new"]))
    return [r for r in reqs if which is None or r.rid in which]


def _features_prefix(fc, device):
    """(e) the prefix cache: pass A, one fresh engine serves all 8 (the
    first of each group cold, the other three partial hits of the 3
    prefix pages); pass B, the same engine serves them again (all full
    hits); pass C, one partial-hit request of each group alone on a fresh
    engine.  B's tokens equal A's, C's equal their A twins, and K1's paged
    entry launches once a layer per chunk token and per decode step
    (``prefill_chunk`` feeds a page one token at a time through the paged
    decode at batch 1), K2 never."""
    from repro_torch.configs import get_arch
    from repro_torch.obs import Tracer
    from repro_torch.serve.equivalence import run_transcript

    cfg = get_arch(fc["arch"])
    L, ps = cfg.num_layers, fc["page_size"]
    P = fc["e_prefix"] + fc["e_tail"]
    kw = dict(slots=fc["slots"], prompt_len=P, max_new_tokens=fc["e_new"],
              page_size=ps, prefix_cache=True)
    tracer = Tracer(capacity=4096)
    mon, eng = _feature_engine(fc, device, "e", tracer=tracer, **kw)()
    out, passes = {}, {}
    try:
        for tag in ("A", "B"):
            execs0 = dict(eng.program_execs)
            stats0 = eng.prefix_stats()
            _zero_counts()
            t0 = time.perf_counter()
            for r in _prefix_requests(fc, cfg.vocab_size):
                eng.submit(r)
            eng.run_until_drained()
            wall = time.perf_counter() - t0
            done = eng.drain_completions()
            execs = {p: n - execs0.get(p, 0)
                     for p, n in eng.program_execs.items()}
            passes[tag] = {r.rid: list(r.tokens) for r in done}
            stats = eng.prefix_stats()
            out[tag] = {
                "wall_s": wall,
                "launches": _counts(),
                "chunks": execs.get("prefill_chunk", 0),
                "decode_steps": execs.get("decode_step", 0),
                "hits": stats["hits"] - stats0["hits"],
                "partial_hits": stats["partial_hits"]
                - stats0["partial_hits"],
                "misses": stats["misses"] - stats0["misses"],
                "pages_saved": (stats["cached_tokens"]
                                - stats0["cached_tokens"]) // ps,
                "ttft_s": {r.rid: r.ttft_s for r in done}}
    finally:
        mon.vfpga_exit()
    kinds = collections.defaultdict(list)
    for t in tracer.traces():
        for s in t.find_spans("engine.admit"):
            kinds[s.labels.get("prefix_hit", "?")].append(s.duration * 1e3)
    out["admit_ms"] = {k: {"n": len(v), "median": statistics.median(v)}
                       for k, v in kinds.items()}
    out["prefix_stats"] = eng.prefix_stats()
    del eng
    if device == "cuda":
        _free_cuda()
    twins = ("g0r1", "g1r2")
    c_tok = {}
    out["C"] = {}
    for rid in twins:
        tok, ceng, launches, wall = _feature_run(
            fc, device, f"e{rid}",
            lambda rid=rid: _prefix_requests(fc, cfg.vocab_size, (rid,)),
            **kw)
        c_tok.update(tok)
        out["C"][rid] = {"wall_s": wall, "launches": launches,
                         "chunks": ceng.program_execs.get("prefill_chunk"),
                         "decode_steps": ceng.program_execs.get(
                             "decode_step", 0),
                         "ttft_s": ceng.completed[rid].ttft_s}
    want_chunks = {"A": 2 * (P // ps) + 6 * (fc["e_tail"] // ps), "B": 0}
    for tag in ("A", "B"):
        r = out[tag]
        if r["chunks"] != want_chunks[tag]:
            raise AssertionError(f"features (e) pass {tag}: {r['chunks']} "
                                 f"chunks, expected {want_chunks[tag]}")
        _expect_launches(f"(e) pass {tag}", r["launches"],
                         {"K1p": L * (ps * r["chunks"]
                                      + r["decode_steps"]),
                          "K1p_b1": L * ps * r["chunks"]}, device)
    if (out["A"]["hits"], out["A"]["partial_hits"], out["A"]["misses"]) \
            != (0, 6, 2) or out["B"]["hits"] != 8:
        raise AssertionError(f"features (e): hits {out['A']}, {out['B']}")
    for rid, r in out["C"].items():
        if r["chunks"] != P // ps:
            raise AssertionError(f"features (e) pass C {rid}: "
                                 f"{r['chunks']} chunks")
        _expect_launches(f"(e) pass C {rid}", r["launches"],
                         {"K1p": L * (ps * r["chunks"]
                                      + r["decode_steps"]),
                          "K1p_b1": L * ps * r["chunks"]}, device)
    if passes["B"] != passes["A"]:
        bad = sorted(r for r in passes["A"]
                     if passes["B"].get(r) != passes["A"][r])
        raise AssertionError(f"features (e): full hits differ from pass A "
                             f"for {bad}")
    if any(c_tok[rid] != passes["A"][rid] for rid in twins):
        raise AssertionError("features (e): a request alone differs from "
                             "its pass A twin")
    for rid, t in passes["A"].items():
        if len(t) != fc["e_new"] or not all(0 <= x < cfg.vocab_size
                                            for x in t):
            raise AssertionError(f"features (e): bad tokens for {rid}")
    out["launches"] = {k: sum(r["launches"][k] for r in
                              [out["A"], out["B"], *out["C"].values()])
                       for k in out["A"]["launches"]}
    return out


def _spec_requests(fc, vocab):
    import numpy as np

    from repro_torch.serve.engine import ServeRequest

    rng = np.random.default_rng(SEED + 23)
    return [ServeRequest(rid=f"s{i}", prompt=rng.integers(
        0, vocab, fc["f_prompt"]).astype(np.int32),
        max_new_tokens=fc["f_new"]) for i in range(8)]


def _reserved_logit_check(eng, mon, cfg):
    """One decode step of every lane on the reserved engine's own caches,
    on the kernel path (K1's dense entry, per-lane positions) and on
    ``impl="naive"``, on copies of the caches: max|logit diff| /
    max|logit| over the active lanes.  These launches are comparisons: the
    counts are restored."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    saved = {k: w.launches for k, w in _wrappers().items()}
    buf = {n: mon.buffers.get(n).device_value
           for n in ("params", "toks", "pos", "caches")}
    lanes = sorted(eng._active)
    out = {}
    with torch.no_grad():
        for impl in ("kernel", "naive"):
            b = build_model(cfg, cache_margin=eng.bundle.cache_margin,
                            decode_impl=impl)
            caches = tree_map(torch.clone, buf["caches"])
            logits, _ = b.decode_fn(buf["params"], buf["toks"][:, 0],
                                    buf["pos"], caches, inplace=True)
            out[impl] = logits.float()[lanes]
            del caches
    for k, w in _wrappers().items():
        w.launches = saved[k]
    ref = out["naive"]
    rel = ((out["kernel"] - ref).abs().max() / ref.abs().max()).item()
    agree = (out["kernel"].argmax(-1) == ref.argmax(-1)).float().mean()
    return {"logit_rel_err": rel, "token_agreement": agree.item(),
            "lanes": len(lanes), "bound": LOGIT_REL_TOL}


def _features_spec(fc, device):
    """(f) speculative decode against a plain single-step engine:
    a self-draft ``SpecConfig(k)`` (the draft's weights are the target's)
    and an antigreedy ``SpecConfig(k_reject)`` (forced reject); (g) the
    same requests in reserved mode (``paged=False``).  Gates: both spec
    transcripts equal the plain one; every run's launches exact (plain: K2
    once a layer per admission, K1 paged once a layer per decode step;
    spec: K2 twice a layer per admission (target and draft prefill), per
    iteration at k K1 paged and K1 dense k+1 times a layer; reserved: K2
    once a layer per admission, K1 dense once a layer per decode step);
    reserved mode completes every request once, and one of its decode
    steps' logits on the kernel path are within LOGIT_REL_TOL of the
    plain path's."""
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import SpecConfig

    cfg = get_arch(fc["arch"])
    L = cfg.num_layers
    vocab = cfg.vocab_size
    kw = dict(slots=fc["slots"], prompt_len=fc["f_prompt"],
              max_new_tokens=fc["f_new"], page_size=fc["page_size"])
    reqs = lambda: _spec_requests(fc, vocab)  # noqa: E731
    runs, tokens = {}, {}
    for tag, spec in (("plain", None),
                      ("self_draft", SpecConfig(k=fc["f_k"])),
                      ("antigreedy", SpecConfig(k=fc["f_k_reject"],
                                                draft_mode="antigreedy"))):
        tok, eng, launches, wall = _feature_run(fc, device, f"f{tag}",
                                                reqs, spec=spec, **kw)
        pe = eng.program_execs
        n_tok = sum(len(t) for t in tok.values())
        admits = sum(n for p, n in pe.items() if p.startswith(
            ("prefill_admit_", "prefill_")) and not p.startswith(
                "prefill_chunk"))
        dec_progs = (("decode_step",) if spec is None else
                     tuple(p for p in pe if p.startswith(
                         ("draft_lookahead_", "verify_step_"))))
        dec_s = sum(eng.program_device_s.get(p, 0.0) for p in dec_progs)
        r = {"wall_s": wall, "launches": launches, "admissions": admits,
             "program_execs": dict(pe), "tokens": n_tok,
             "decode_tokens_per_s": (n_tok - len(tok)) / dec_s,
             "decode_device_s": dec_s,
             "host_device_split": eng.host_device_split()}
        if spec is None:
            want = {"K1p": L * pe.get("decode_step", 0), "K2": L * admits}
        else:
            st = eng.spec_stats()
            r["spec_stats"] = st
            r["tokens_per_verify"] = st["tokens_per_lane_iteration"]
            steps = (spec.k + 1) * st["iterations"]
            want = {"K1p": L * steps, "K1": L * steps, "K2": 2 * L * admits}
        _expect_launches(f"(f) {tag}", launches, want, device)
        runs[tag], tokens[tag] = r, tok
        del eng
    for tag in ("self_draft", "antigreedy"):
        if tokens[tag] != tokens["plain"]:
            bad = sorted(r for r in tokens["plain"]
                         if tokens[tag].get(r) != tokens["plain"][r])
            raise AssertionError(f"features (f) {tag}: tokens differ from "
                                 f"plain decode for {bad}")
    checks = []

    def hook(eng, mon, i):
        if i == fc["logit_at"]:
            checks.append(_reserved_logit_check(eng, mon, cfg))

    rkw = {k: v for k, v in kw.items() if k != "page_size"}
    tok, eng, launches, wall = _feature_run(fc, device, "g", reqs, hook=hook,
                                            paged=False, **rkw)
    pe = eng.program_execs
    admits = pe.get(f"prefill_{fc['f_prompt']}", 0)
    _expect_launches("(g) reserved", launches,
                     {"K1": L * pe.get("decode_step", 0), "K2": L * admits},
                     device)
    want_n = {r.rid: fc["f_new"] for r in reqs()}
    if {r: len(t) for r, t in tok.items()} != want_n or admits != 8:
        raise AssertionError(f"features (g): {admits} admissions, token "
                             f"counts {[len(t) for t in tok.values()]}")
    if not checks or checks[0]["logit_rel_err"] > LOGIT_REL_TOL:
        raise AssertionError(f"features (g): reserved kernel vs plain "
                             f"logits {checks}")
    agree = sum(a == b for r in tok for a, b in zip(tok[r],
                                                    tokens["plain"][r]))
    runs["reserved"] = {
        "wall_s": wall, "launches": launches, "admissions": admits,
        "program_execs": dict(pe), "logit_check": checks[0],
        "tokens_agreeing_with_paged": agree,
        "tokens": sum(len(t) for t in tok.values()),
        "decode_tokens_per_s": (sum(len(t) for t in tok.values()) - 8)
        / eng.program_device_s["decode_step"]}
    del eng
    if device == "cuda":
        _free_cuda()
    return runs


def phase_features(state, device="cuda", cut=None):
    """The engine's features at full-width yi-9b cut to ``layers`` layers
    (bf16, random weights from seed 0): (d) tracing, (e) the prefix cache,
    (f) speculative decode and (g) reserved mode (see the functions above
    for each one's gates).  The phase holds under ``max_phase_s`` and
    ``max_peak_gb``.  ``cut`` overrides ``FEATURES`` (a rehearsal on the
    CPU at smoke size)."""
    fc = dict(FEATURES, **(cut or {}))
    with _depth_cut(fc["arch"], fc["layers"]) as arch:
        _features(state, dict(fc, arch=arch), device)


def _features(state, fc, device):
    import torch

    t_phase = time.perf_counter()
    if device == "cuda":
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
    d = _features_traced(fc, device)
    state["features_trace_doc"] = d.pop("trace_doc")
    log(phase="features", run="d_traced", card=state.get("card"),
        **{k: ({kk: vv for kk, vv in v.items() if kk != "tokens"}
               if isinstance(v, dict) else v) for k, v in d.items()})
    e = _features_prefix(fc, device)
    log(phase="features", run="e_prefix_cache", card=state.get("card"), **e)
    f = _features_spec(fc, device)
    log(phase="features", run="f_g_spec_reserved", card=state.get("card"),
        **f)
    launches = collections.Counter()
    for run in (d["untraced"], d["traced"]):
        launches.update(run["launches"])
    launches.update(e["launches"])
    for run in f.values():
        launches.update(run["launches"])
    spec = [f["self_draft"]["launches"], f["antigreedy"]["launches"]]
    stats = {"arch": fc["arch"], "phase_s": time.perf_counter() - t_phase,
             "launches": {k: launches.get(k, 0) for k in _wrappers()},
             # the counts by call pattern, each measured: K1 paged at one
             # lane (the wrapper's own count: prefill_chunk), in the spec
             # runs (which run no decode_step: verify only), and K1 dense
             # in the spec runs (draft lanes) and the reserved run
             "k1p_b1_launches": launches["K1p_b1"],
             "k1p_verify_launches": sum(r["K1p"] for r in spec),
             "k1_draft_launches": sum(r["K1"] for r in spec),
             "k1_reserved_launches": f["reserved"]["launches"]["K1"]}
    if device == "cuda":
        stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        stats["left_allocated_bytes"] = torch.cuda.memory_allocated()
    log(phase="features", card=state.get("card"), summary=stats)
    state.setdefault("launches", {})["features"] = stats["launches"]
    state["features"] = {"d": d, "e": e, "f": f, **stats}
    if device == "cuda" and stats["phase_s"] > fc["max_phase_s"]:
        raise AssertionError(f"features: the phase took "
                             f"{stats['phase_s']:.1f} s, over "
                             f"{fc['max_phase_s']} s")
    if stats.get("peak_gb", 0.0) > fc["max_peak_gb"]:
        raise AssertionError(f"features: peak {stats['peak_gb']:.2f} GB, "
                             f"over {fc['max_peak_gb']} GB")


# ---------------------------------------------------------------------------
# 16. prefill/decode disaggregation: two replicas and the KV handoff
# ---------------------------------------------------------------------------

# fig15's pair for the engine phase's 8 lanes, (slots // 4, 2 * slots -
# slots // 4): a prefill replica of 2 lanes, single-step, and a decode
# replica of 14 lanes, 8 steps fused and one EXECUTE ahead, whose default
# pool holds every lane at its limit; the engine phase's model, pages,
# buckets and caps.  (b) tears the transfers in ``torn_at`` (1-based, over
# the run's transfer attempts).  ``ref_pool`` is the mixed engine's pool
# in a rehearsal.  yi-9b is cut to ``layers`` of its 48, as in the
# features phase.
DISAGG = dict(arch="yi-9b", layers=12, prefill_slots=2, decode_slots=14,
              decode_fuse=8, decode_async=1,
              page_size=ENGINE["page_size"],
              prompt_buckets=ENGINE["prompt_buckets"],
              prompt_len=ENGINE["prompt_len"],
              max_new_tokens=ENGINE["max_new_tokens"],
              n_requests=ENGINE["n_requests"], ref_pool=ENGINE["pool_pages"],
              torn_at=(2, 5), max_phase_s=150,
              max_peak_gb=45, mem_cap=36 << 30)
# K1's paged entry at the decode replica's shape: 14 lanes at ragged
# positions, tables of 37 pages of 16 (prompt 512 + 64
# tokens + the fused span's 7 slots of headroom) over its pool of 14 x 37 =
# 518 pages
DISAGG_PAGED_POS = [100, 575, 233, 512, 417, 130, 351, 498, 160, 289, 540,
                    77, 444, 320]


def _disagg_engine_kw(dc):
    return dict(prompt_len=dc["prompt_len"],
                max_new_tokens=dc["max_new_tokens"],
                page_size=dc["page_size"],
                prompt_buckets=dc["prompt_buckets"], seed=SEED)


def _disagg_requests(dc, vocab):
    """The engine phase's workload (its first ``n_requests``)."""
    return engine_requests(vocab, dc["n_requests"])


def _disagg_reference(dc, device, vocab):
    """The workload on one mixed engine (the engine phase's run (a) lanes
    and pool, on a monitor): the tokens the pair must reproduce when the
    phase runs without the engine phase."""
    from repro_torch.core import FunkyCL, Monitor, SliceAllocator
    from repro_torch.scaling.metrics import MetricsRegistry
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.equivalence import run_transcript

    def factory():
        mon = Monitor("disagg-mixed", SliceAllocator(
            "node0", 1, mem_cap_bytes=dc["mem_cap"], device=device),
            telemetry=MetricsRegistry())
        eng = ContinuousBatchingEngine(
            dc["arch"], FunkyCL(mon), engine_id="disagg-mixed",
            slots=ENGINE["slots"], pool_pages=dc["ref_pool"],
            **_disagg_engine_kw(dc))
        eng.setup()
        return mon, eng

    tokens, eng = run_transcript(factory,
                                 lambda: _disagg_requests(dc, vocab))
    del eng
    if device == "cuda":
        _free_cuda()
    return tokens


def _disagg_pair(dc, device, reg):
    """The two replicas on two slices of the one card, each with its own
    monitor and its weights drawn from seed 0."""
    from repro_torch.core import FunkyCL, Monitor, SliceAllocator
    from repro_torch.serve.engine import ContinuousBatchingEngine

    alloc = SliceAllocator("node0", 2, mem_cap_bytes=dc["mem_cap"],
                           device=device)
    pair = []
    for role, slots, fuse, depth in (
            ("prefill", dc["prefill_slots"], 1, 0),
            ("decode", dc["decode_slots"], dc["decode_fuse"],
             dc["decode_async"])):
        mon = Monitor(f"disagg-{role}", alloc, telemetry=reg)
        eng = ContinuousBatchingEngine(
            dc["arch"], FunkyCL(mon), engine_id=f"disagg-{role}",
            service="disagg", slots=slots, fuse_steps=fuse,
            async_depth=depth, role=role, **_disagg_engine_kw(dc))
        eng.setup()
        pair.append((mon, eng))
    return pair


def _quantiles(xs):
    import numpy as np

    return ({"p50": float(np.percentile(xs, 50)), "max": float(max(xs))}
            if xs else None)


def _disagg_run(dc, device, cfg, pair, reg, reqs, chaos=None, check=None):
    """One drive of the pair: one RequestRouter and one TransferQueue, the
    replicas pumped in turn by this loop (``tests/test_disagg.py``'s
    ``run_disagg``) until every request completed.  ``check`` (a list) gets
    (c): the decode replica's first decode step after its first install,
    kernel path against plain path (``_paged_logit_check``).  Returns
    ({rid: tokens}, stats); the stats' launches are this run's only."""
    import numpy as np

    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_paged
    from repro_torch.scaling.serving import RequestRouter
    from repro_torch.serve.disagg import (M_HANDOFF, M_HANDOFF_FALLBACK,
                                          M_TRANSFER_BYTES, TransferQueue)

    (monP, engP), (monD, engD) = pair
    router = RequestRouter("disagg", registry=reg, kv_aware=False)
    tq = TransferQueue(router=router, registry=reg, service="disagg",
                       chaos=chaos)
    engP.attach_transfer(tq)
    engD.attach_transfer(tq)
    counters = (M_HANDOFF, M_HANDOFF_FALLBACK, M_TRANSFER_BYTES)
    c0 = {n: reg.counter(n, service="disagg").value for n in counters}
    x0 = [(dict(e.program_execs), dict(e.program_device_s))
          for _, e in pair]
    # per handoff: the export's host seconds (gather EXECUTE + d2h read,
    # which waits for it) and the install's completions (h2d, scatter,
    # lane_set), whose device phases are read once the run is over
    exports, installs = [], []

    def export_lane(st, _orig=engP.export_lane):
        t0 = time.perf_counter()
        h = _orig(st)
        exports.append(time.perf_counter() - t0)
        return h

    def import_lane(h, _orig=engD.import_lane):
        n0 = len(engD._step_completions)
        ok = _orig(h)
        if ok:
            installs.append(engD._step_completions[n0:])
        return ok

    engP.export_lane, engD.import_lane = export_lane, import_lane
    _zero_counts()
    t0 = time.perf_counter()
    try:
        for r in reqs:
            router.submit(r)
        for _ in range(100000):
            engP.pump(router)
            if check is not None and not check and len(tq) and engD._free:
                # (c): install, ship the imported rows, drain the replica's
                # queue, then one decode step on both paths
                tq.pump_dest(engD)
                if engD._active and device == "cuda":
                    engD._flush_block_table()
                    engD.cl.clFinish()
                    check.append(_paged_logit_check(engD, monD, cfg))
            engD.pump(router)
            if (not router.outstanding() and engP.idle and engD.idle
                    and len(tq) == 0):
                break
        else:
            raise AssertionError("disagg: the pair did not drain")
        wall = time.perf_counter() - t0
        launches = _counts()
        by_shape = dict(decode_attention_paged.launches_by_shape)
    finally:
        # the wrappers close over their engine: drop them with the run
        del engP.export_lane, engD.import_lane
    completed = list(router.completed.values())
    tokens = {c.rid: list(c.tokens) for c in completed}
    per = {}
    for (role, eng), (pe0, pd0) in zip(
            (("prefill", engP), ("decode", engD)), x0):
        pe = {p: n - pe0.get(p, 0) for p, n in eng.program_execs.items()}
        pd = {p: s - pd0.get(p, 0.0) for p, s in eng.program_device_s.items()}
        prog = "decode_multi" if eng.fuse_steps > 1 else "decode_step"
        per[role] = {
            "decode_steps": eng.fuse_steps * pe.get(prog, 0),
            "admissions": sum(n for p, n in pe.items()
                              if p.startswith("prefill_admit")),
            "decode_device_s": pd.get(prog, 0.0),
            "program_execs": {p: n for p, n in pe.items() if n}}
    # K1 paged's launches by (rows, table width): each replica decodes at
    # its own, 16 rows over 36 pages (prefill) and 37 (decode), so the
    # wrapper's tally counts each replica's launches apart
    L = cfg.num_layers
    want_shape = {}
    for role, eng in (("prefill", engP), ("decode", engD)):
        per[role]["K1p"] = L * per[role]["decode_steps"]
        per[role]["K2"] = L * per[role]["admissions"]
        shape = (eng.slots, eng.max_blocks)
        per[role]["k1p_shape"] = list(shape)
        per[role]["K1p_counted"] = by_shape.get(shape, 0)
        if per[role]["K1p"]:
            want_shape[shape] = want_shape.get(shape, 0) + per[role]["K1p"]
    expected = {"K1": 0, "K1p": sum(p["K1p"] for p in per.values()),
                "K1p_b1": 0, "K2": sum(p["K2"] for p in per.values()),
                "K3": 0, "K4": 0}
    if device == "cuda" and (launches != expected or by_shape != want_shape
                             or len(want_shape) < 2):
        raise AssertionError(f"disagg: launch counts {launches} and by "
                             f"shape {by_shape}, expected {expected} and "
                             f"{want_shape}, one shape per replica ({per})")
    n_tok = sum(len(t) for t in tokens.values())
    ttft = [c.ttft_s for c in completed]
    inst = [sum((c.phases or {}).get("device_s", 0.0) for c in cs)
            for cs in installs]
    decode_s = sum(p["decode_device_s"] for p in per.values())
    stats = {
        "requests": len(completed), "tokens": n_tok, "wall_s": wall,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99)),
        "tbt_req_mean_p50_s": _tbt_req_mean_p50(completed),
        "tokens_per_s_e2e": n_tok / wall,
        # tokens after the first over both replicas' decode device seconds
        "decode_tokens_per_s": (n_tok - len(completed)) / decode_s,
        **{n: reg.counter(n, service="disagg").value - c0[n]
           for n in counters},
        "torn": tq.torn, "duplicates": router.duplicates,
        "replay_mismatches": router.replay_mismatches,
        "export_s": _quantiles(exports),
        "install_device_s": _quantiles(inst),
        "ewma_install_s": tq.stats()["ewma_install_s"],
        "replicas": per, "launches": launches}
    return tokens, stats


def _first_divergence(got, want):
    """{rid: (index of the first differing token, got, want)} of the
    requests whose tokens differ (index 0 is the admission's, index 1 the
    prefill replica's decode step, later ones mostly the decode
    replica's)."""
    out = {}
    for rid in sorted(want):
        a, b = got.get(rid, []), want[rid]
        if a != b:
            i = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                     min(len(a), len(b)))
            out[rid] = (i, a[i:i + 2], b[i:i + 2])
    return out


def phase_disagg(state, device="cuda", cut=None):
    """Prefill/decode disaggregation at full-width yi-9b cut to
    ``layers`` layers (bf16, weights from seed 0 on both replicas): the
    engine phase's 24 requests through RequestRouter -> prefill replica ->
    FunkyCL -> Monitor, then the KV handoff (TransferQueue) -> decode
    replica -> FunkyCL -> Monitor.  (a) the tokens of the engine phase's
    run (a) at the same depth (``_reference_tokens``; of one mixed engine
    in a rehearsal), at least one handoff; (b) the same with the
    transfers in ``torn_at`` torn: each replays through its lease, every
    request completes once with (a)'s tokens; (c) the decode replica's
    first step after its first install, kernel path within LOGIT_REL_TOL of
    the plain path.  Exact launches over both replicas (K2 once a layer
    per admission, K1 paged once a layer per decode step, dense K1 none),
    under ``max_phase_s`` and ``max_peak_gb``.  ``cut`` overrides
    ``DISAGG`` (a rehearsal on the CPU at smoke size)."""
    dc = dict(DISAGG, **(cut or {}))
    with _depth_cut(dc["arch"], dc["layers"]) as arch:
        _disagg(state, dict(dc, arch=arch), device, cut)


def _disagg(state, dc, device, cut):
    import torch

    from repro_torch.chaos import FaultPlan, FaultSpec
    from repro_torch.configs import get_arch
    from repro_torch.scaling.metrics import MetricsRegistry

    cfg = get_arch(dc["arch"])
    t_phase = time.perf_counter()
    if device == "cuda":
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
    if cut is None:
        ref, ref_from = _reference_tokens(state, dc["arch"], device)
    else:
        ref = _disagg_reference(dc, device, cfg.vocab_size)
        ref_from = "one mixed engine in this phase"
    reg = MetricsRegistry()
    pair = _disagg_pair(dc, device, reg)
    try:
        check = []
        a_tok, a = _disagg_run(dc, device, cfg, pair, reg,
                               _disagg_requests(dc, cfg.vocab_size),
                               check=check)
        log(phase="disagg", run="a_handoffs", card=state.get("card"),
            reference=ref_from, logit_check=check, **a)
        # distinct match strings, each in every key (rid "qNN"): specs with
        # equal match strings share one event count
        plan = FaultPlan([FaultSpec(site="kv.transfer", kind="torn", at=n,
                                    match="q" * i)
                          for i, n in enumerate(dc["torn_at"])])
        b_reqs = _disagg_requests(dc, cfg.vocab_size)
        b_tok, b = _disagg_run(dc, device, cfg, pair, reg, b_reqs,
                               chaos=plan)
        log(phase="disagg", run="b_torn", card=state.get("card"),
            fired=plan.fired, **b)
    finally:
        for mon, _ in pair:
            mon.vfpga_exit()
        del pair
    if device == "cuda":
        _free_cuda()
    stats = {"arch": dc["arch"], "phase_s": time.perf_counter() - t_phase,
             "launches": {k: a["launches"].get(k, 0)
                          + b["launches"].get(k, 0) for k in _wrappers()},
             # counted by the wrapper at the decode replica's shape
             "decode_replica_k1p": a["replicas"]["decode"]["K1p_counted"]
             + b["replicas"]["decode"]["K1p_counted"]}
    if device == "cuda":
        stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        stats["left_allocated_bytes"] = torch.cuda.memory_allocated()
    if "engine" in state:
        stats["engine_a"] = {k: state["engine"]["a"][k] for k in (
            "wall_s", "ttft_p50_s", "ttft_p99_s", "tbt_p50_s",
            "tbt_req_mean_p50_s", "decode_tokens_per_s")}
    log(phase="disagg", card=state.get("card"), summary=stats)
    state.setdefault("launches", {})["disagg"] = stats["launches"]
    state["disagg"] = {"a": a, "b": b, "c": check, **stats}
    if a_tok != ref:
        raise AssertionError(f"disagg (a): tokens differ from {ref_from}: "
                             f"{_first_divergence(a_tok, ref)}")
    want_b = {r.rid: ref[r.rid] for r in b_reqs}
    if b_tok != want_b:
        raise AssertionError(f"disagg (b): tokens differ from (a): "
                             f"{_first_divergence(b_tok, want_b)}")
    if a["handoff_total"] < 1:
        raise AssertionError("disagg (a): no lane was handed off")
    if (b["torn"] != len(dc["torn_at"]) or b["duplicates"]
            or b["replay_mismatches"] or b["requests"] != len(b_reqs)):
        raise AssertionError(
            f"disagg (b): torn {b['torn']} (want {len(dc['torn_at'])}), "
            f"duplicates {b['duplicates']}, replay mismatches "
            f"{b['replay_mismatches']}, {b['requests']} of {len(b_reqs)} "
            "requests")
    if device == "cuda" and (not check or check[0]["logit_rel_err"]
                             > LOGIT_REL_TOL):
        raise AssertionError(f"disagg (c): kernel vs plain logits {check}")
    if device == "cuda" and stats["phase_s"] > dc["max_phase_s"]:
        raise AssertionError(f"disagg: the phase took {stats['phase_s']:.1f}"
                             f" s, over {dc['max_phase_s']} s")
    if stats.get("peak_gb", 0.0) > dc["max_peak_gb"]:
        raise AssertionError(f"disagg: peak {stats['peak_gb']:.2f} GB, over "
                             f"{dc['max_peak_gb']} GB")


# ---------------------------------------------------------------------------
# 17. the CRI layer: checkpoint, migrate, replicate, crash, restore
# ---------------------------------------------------------------------------

# two nodes on the one card, each with two slices of 36 GiB (node0 holds
# the clone and the restored replica at once); commands land after these
# many iterations of the serving replica.  yi-9b is cut to ``layers`` of
# its 48 (5.2 GB of weights; at full depth a snapshot of 17.9 GB took 56 s
# to write and hash and the restore 62 s to read and verify, warm, on a
# script near its time limit)
CRI = dict(layers=12, slices=2, mem_cap=36 << 30, ckpt1_at=4, gap=4,
           wave1=12, need_bytes=8e9)


def _decode_ms(eng):
    """(decode EXECUTEs, their seconds) so far: the engine's own count."""
    return (eng.program_execs.get("decode_step", 0),
            eng.program_device_s.get("decode_step", 0.0))


def _interval_ms(a, b):
    n, s = b[0] - a[0], b[1] - a[1]
    return {"decode_steps": n, "decode_step_ms": s / n * 1e3 if n else None}


def phase_cri(state, arch=ENGINE["arch"], device="cuda",
              layers=CRI["layers"]):
    """Run (a)'s workload on full-width yi-9b cut to ``layers`` layers
    through NodeAgent ->
    ContainerEngine (CRI) -> FunkyRuntime -> FunkyCL -> Monitor on two
    nodes wired as ``make_cluster`` wires them (no orchestrator): deploy
    on node0; checkpoint (snapshot 1, full); checkpoint with ``ckpt.corrupt``
    armed (snapshot 2, incremental: ``params`` referenced, then a byte of
    one of its files flipped); evict and migrate to node1; replicate onto
    node0; node1 fails hard (agent down, ``crash``, the router replays the
    replica's leases); restore on node0 from the newest snapshot of both
    nodes' roots, which falls back to snapshot 1; the last 12 requests
    arrive once the restored replica runs; drain and remove both.  Gates:
    every request completes once with run (a)'s tokens at the same depth
    (``_reference_tokens``), no duplicates or
    replay mismatches, exact launch counts over every replica's engine,
    snapshot 2 reuses ``params``, the restore falls back with a
    ``restore_fallback`` event.  Snapshots go under a temporary directory,
    deleted at the end."""
    import shutil
    import tempfile

    from repro_torch.configs import get_arch

    t_phase = time.perf_counter()
    with _depth_cut(arch, layers) as arch:
        cfg = get_arch(arch)
        want, want_from = _reference_tokens(state, arch, device)
        root = tempfile.mkdtemp(prefix="funky-cri-")
        usage = shutil.disk_usage(root)
        log(phase="cri", arch=arch, reference=want_from, ckpt_dir=root,
            disk_total=usage.total, disk_used=usage.used,
            disk_free=usage.free)
        try:
            if usage.free < CRI["need_bytes"]:
                raise RuntimeError(
                    f"cri: {usage.free / 1e9:.1f} GB free under {root}; the "
                    f"phase writes about 5.5 GB of snapshots (needs "
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
# 18. the orchestrator: Algorithm 1, autoscaling, node failure, open loop
# ---------------------------------------------------------------------------

# make_cluster's two nodes on the one card, two 36 GiB slices each; ``svc``
# is run (a)'s engine image, ``batch`` phase 7's mamba2 ServeTask (batch
# 8, prompt 1024, 4 steps of 8 tokens) at priority 0.  Before the drive,
# ab_requests requests of ab_tokens tokens are served with the scheduler's
# tick thread running and parked, in turns (``_ab_orch_threads``); their
# completions calibrate the replica rate and the SLO.  The load is fig14's
# live burst: base_frac x the replica rate, ``burst`` x that (2.4x the
# replica rate) for burst_s from a third of the horizon.  The burst
# overloads one replica, so its p95 crosses the SLO and the autoscaler
# scales out, only while the rate matches the engine: at 1.2x the rate
# over a third of the horizon, calibrated in another phase minutes
# earlier, one run never scaled out.  2.4x holds even if the engine runs
# twice as fast as calibrated, with about as many requests in all.  The
# drive keeps the router open tail_s past the last arrival: the
# autoscaler scales in once the p95 window empties, and a closed router
# would end every replica (on an H100 80GB HBM3 at 700 W the backlog
# drained 37-76 s after the last arrival; the seeded arrivals' work
# varies with the calibrated rate, and the largest drained last).
ORCH = dict(slices=2, mem_cap=36 << 30, n_batch=4, batch_steps=4,
            horizon_s=30.0, tail_s=120.0, tokens_range=(8, 65),
            base_frac=0.3, burst=8.0, burst_s=5.0, slo_mult=2.0,
            asc_interval_s=0.25, down_cooldown_s=2.0, tick_s=0.02,
            sample=4, seed=41, ab_requests=4, ab_tokens=24,
            leak_bytes=32 << 20)


def _orch_calibration(eng, done):
    """The replica rate and SLO as fig14 calibrates them, measured on the
    service's own engine ``eng`` just before the drive, from the A/B
    turns' completed requests ``done``: an un-queued request costs its B 1
    prefill (the engine's mean ``prefill_admit_512`` EXECUTE) plus
    (mean_n - 1) TBTs (the turns' TBT p50); r = slots / that; the SLO is
    ``slo_mult`` x that.  The decode step is host-bound and the host's
    speed drifts, so numbers taken in another phase minutes earlier need
    not hold for this one."""
    import numpy as np

    prog = f"prefill_admit_{ENGINE['prompt_len']}"
    ttft = eng.program_device_s[prog] / eng.program_execs[prog]
    tbt = float(np.percentile([t for c in done for t in c.tbts], 50))
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
    ``LatencySLOPolicy`` autoscaler replicate ``svc`` (from its decision
    the first replica pops nothing, so the backlog waits for the clone);
    while the clone holds leases its node fails (``handle_node_failure``:
    crash, lease replay, resubmit, and the first replica pops again);
    after the drive the autoscaler scales back in,
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
    the router and reads the engine's mean ``decode_step`` EXECUTE.
    Returns the turns and every turn's completed requests."""
    import numpy as np

    from repro_torch.serve.engine import ServeRequest

    rng = np.random.default_rng(SEED + 1)
    out, done = [], []
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
            done += [router.completed[r] for r in rids]
        finally:
            if park:
                paused.clear()
                orch._lock.release()
    return out, done


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
        ab, ab_done = _ab_orch_threads(orch, router,
                                       recs(svc)[0].task.engine, paused,
                                       cfg.vocab_size)
        cal = _orch_calibration(recs(svc)[0].task.engine, ab_done)
        log(phase="orch", card=state.get("card"), calibration=cal,
            engine_phase_tbt_s=state["engine"]["a"]["tbt_p50_s"])

        scaler = OrchestratorScaler(orch, svc, service="svc")
        failure, marks, timeline = {}, [], []
        # the backlog waits for the clone: from the autoscaler's scale-out
        # until the clone's node has failed under its leases, the first
        # replica pops nothing, so the requests that queue while the clone
        # copies the weights go to the clone (else the first replica could
        # drain them before the clone came up, and the clone would hold no
        # lease to fail)
        scaling_out = threading.Event()
        scale_to, pop = scaler.scale_to, router.pop

        def held_scale_to(n):
            if n > scaler.current_replicas():
                scaling_out.set()
            scale_to(n)

        def held_pop(n, engine_id=None):
            if scaling_out.is_set() and not failure and engine_id == svc:
                return []
            return pop(n, engine_id=engine_id)

        scaler.scale_to, router.pop = held_scale_to, held_pop
        asc = Autoscaler(LatencySLOPolicy(slo_p95_s=cal["slo_s"],
                                          growth=2.0),
                         min_replicas=1, max_replicas=2,
                         scale_down_cooldown_s=ORCH["down_cooldown_s"])
        orch.attach_autoscaler(asc, scaler, service="svc",
                               interval_s=ORCH["asc_interval_s"])
        T, r = ORCH["horizon_s"], cal["replica_rate"]
        reqs = open_loop(burst_rate(ORCH["base_frac"] * r, ORCH["burst"],
                                    T / 3, ORCH["burst_s"]), T,
                         seed=ORCH["seed"],
                         mean_service_s=1.0 / r,
                         tokens_range=ORCH["tokens_range"])

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
    # the first drive report at one replica whose p95 breaches the SLO
    breach = next(({"t": x["t"], "p95_over_slo": x["p95_s"] / cal["slo_s"]}
                   for x in timeline if x["replicas"] == 1
                   and x["p95_s"] > cal["slo_s"]), None)
    replicating = [(e[0] - e[2]["total_seconds"] - t_drive_wall,
                    e[0] - t_drive_wall)
                   for r in seen.values() for e in r.timeline
                   if e[1] == "replicated"]
    summary = {
        "requests": len(reqs), "served": len(completed),
        "slo_s": cal["slo_s"],
        "slo_attainment": 1 - violations / max(len(completed), 1),
        "violations": violations, "max_replicas": res.max_replicas,
        "first_breach": breach,
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
        one = [x["p95_s"] for x in timeline
               if x["replicas"] == 1 and x["p95_s"] == x["p95_s"]]
        raise AssertionError(
            f"orch: max replicas {res.max_replicas}, events before the "
            f"drive's end {[e[1] for e in orch.events if e[0] < t_drive_end]}"
            f"; p95 at one replica (the drive's reports) up to "
            f"{max(one, default=None)} s, SLO {cal['slo_s']} s ({cal})")
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
# 19. training at full width
# ---------------------------------------------------------------------------

# yi-9b at full width (d_model 4096, 32/4 heads, hd 128, d_ff 11008, vocab
# 64000, untied head) cut to ``layers`` of its 48: whole, its training
# state (bf16 params, f32 grad_acc, f32 m and v) is about 123 GB, over the
# card's 80; 8 layers hold 1.908 B params, 26.7 GB of state.  The image:
# seq 1024, global batch 8 in ``chunks`` microbatches, the image's default
# OptConfig.  (e) holds the card in f32 on ``e_layers`` against the CPU
# under pinned kernels (``PINNED_CPU_ENV``);
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
    out["e"] = _train_card_vs_cpu(tc, base, device, names, root)
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


# (e)'s CPU reference runs in a child process whose CPU kernels no host
# changes: ATen's vector kernels at AVX2 (``ATEN_CPU_CAPABILITY``; at
# AVX-512 its softmax and reductions sum in another order), MKL's GEMMs
# under conditional numerical reproducibility at AVX2, strict (``MKL_CBWR``;
# by default MKL picks its kernels by the host's ISA, and without STRICT by
# the thread count), and a fixed thread count (ATen's reductions split by
# it).  Every x86 host of the fleet has AVX2.
PINNED_CPU_ENV = {"ATEN_CPU_CAPABILITY": "avx2", "MKL_CBWR": "AVX2,STRICT",
                  "OMP_NUM_THREADS": "8", "MKL_NUM_THREADS": "8"}


def _train_e_cfg(arch, layers):
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    return dataclasses.replace(cfg, name=f"{cfg.name}-{layers}of"
                               f"{cfg.num_layers}-f32", num_layers=layers,
                               dtype="float32")


def _grads_digest(grads):
    """sha256 of the gradients' f32 bytes, leaf by leaf in tree order."""
    import hashlib

    import torch

    from repro_torch.tree import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(grads):
        h.update(t.detach().to("cpu", torch.float32).contiguous()
                 .view(torch.int32).numpy().tobytes())
    return h.hexdigest()


def train_e_reference(arch, layers, seq, out_path, dtype="float32"):
    """(e)'s CPU reference, in the process that calls it: one
    ``grad_step`` of ``arch`` cut to ``layers`` (weights drawn in f32 on
    the CPU from ``SEED``, computed in ``dtype``) on ``make_batch``'s
    batch of one row of ``seq`` tokens.  Writes the gradients, rounded to
    f32, to ``out_path`` (``torch.save``; None: not written) and returns
    the loss (f32 bits as hex), the gradients' digest and the seconds."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.train import (OptConfig, make_batch,
                                   make_chunked_train_fns)
    from repro_torch.tree import tree_map

    torch.set_num_threads(int(PINNED_CPU_ENV["OMP_NUM_THREADS"]))
    cfg = _train_e_cfg(arch, layers)
    bundle = build_model(cfg)
    grad_init, grad_step, _ = make_chunked_train_fns(bundle, OptConfig())
    batch = make_batch(cfg, ShapeConfig("e", "train", seq, 1), 0)
    dt = getattr(torch, dtype)
    t = time.perf_counter()
    p = tree_map(lambda x: x.to(dt) if x.is_floating_point() else x,
                 bundle.init(SEED, device="cpu"))
    init_s = time.perf_counter() - t
    t = time.perf_counter()
    g, loss = grad_step(p, grad_init(p), batch)
    step_s = time.perf_counter() - t
    del p
    g = tree_map(lambda x: x.float(), g)
    if out_path is not None:
        torch.save(g, out_path)
    loss32 = torch.tensor(float(loss), dtype=torch.float32)
    return {"loss": float(loss32), "loss_bits": float(loss32).hex(),
            "loss_unrounded": float(loss), "grads_sha256": _grads_digest(g),
            "dtype": dtype, "threads": torch.get_num_threads(),
            "cpu_capability": torch.backends.cpu.get_cpu_capability(),
            "init_s": init_s, "grad_step_s": step_s}


def start_reference(arch, layers, seq, out_path, dtype="float32",
                    env=None):
    """``train_e_reference`` started in a child process under ``env``
    (default ``PINNED_CPU_ENV``, on top of this process's environment);
    ``finish_reference`` waits for it."""
    import os

    code = ("import json, sys; sys.path[:0] = [sys.argv[1]]; "
            "import chip_smoke as c; print(json.dumps("
            "c.train_e_reference(*json.loads(sys.argv[2]))))")
    args = json.dumps([arch, layers, seq, out_path, dtype])
    return subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT), args], cwd=str(ROOT),
        env=dict(os.environ, **(PINNED_CPU_ENV if env is None else env)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_reference(proc, timeout=900):
    """The result of a ``start_reference`` child (killed past
    ``timeout`` seconds)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode:
        raise RuntimeError(f"train (e): the CPU reference failed "
                           f"({proc.returncode}): {err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def cpu_host():
    """This host's CPU: vendor, family, model, model name, stepping, its
    AVX2 / AVX-512 flags and logical CPUs (the first processor's
    entries in ``/proc/cpuinfo``)."""
    import os

    keys = {"vendor_id": "vendor", "cpu family": "family",
            "model": "model", "model name": "model_name",
            "stepping": "stepping"}
    info = {"cpus": os.cpu_count()}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, val = line.partition(":")
            key = key.strip()
            if key in keys and keys[key] not in info:
                info[keys[key]] = val.strip()
            if key == "flags":
                flags = val.split()
                info["avx2"] = "avx2" in flags
                info["avx512f"] = "avx512f" in flags
                break
    return info


def _train_card_vs_cpu(tc, base, device, names, root):
    """One ``grad_step`` of the port's own function on ``device`` in f32
    (no TF32), against the CPU's in a child process under pinned kernels
    (``PINNED_CPU_ENV``), from the same f32 weights drawn on the CPU from
    the seed: the link from the card's path to the CPU path the tests hold
    against the JAX package.  The child runs beside the card's step.  The
    reference's loss bits and gradient digest are the same on every host
    and are returned."""
    import os

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
    path = os.path.join(root, "e_reference.pt")
    t = time.perf_counter()
    child = start_reference(base.name, tc["e_layers"], tc["e_seq"], path)
    try:
        bundle = build_model(cfg)
        grad_init, grad_step, _ = make_chunked_train_fns(bundle,
                                                         OptConfig())
        batch = make_batch(cfg, ShapeConfig("e", "train", tc["e_seq"], 1),
                           0)
        p_dev = tree_map(lambda x: x.to(device),
                         bundle.init(SEED, device="cpu"))
        t_dev = time.perf_counter()
        g_dev, l_dev = grad_step(p_dev, grad_init(p_dev), batch)
        l_dev = float(l_dev)
        dev_s = time.perf_counter() - t_dev
        del p_dev
    finally:
        ref = finish_reference(child)
    ref_s = time.perf_counter() - t
    g_ref = torch.load(path, mmap=True, weights_only=True)
    loss_rel = abs(l_dev - ref["loss"]) / abs(ref["loss"])
    worst = 0.0
    for a, b in zip(tree_leaves(g_dev), tree_leaves(g_ref)):
        err = (a.cpu() - b).abs().max().item()
        worst = max(worst, err / max(b.abs().max().item(), 1e-30))
    del g_dev, g_ref
    os.remove(path)
    res = {"arch": cfg.name, "seq_len": tc["e_seq"], "batch": 1,
           "loss_card": l_dev, "loss_cpu": ref["loss"],
           "loss_cpu_bits": ref["loss_bits"],
           "grads_cpu_sha256": ref["grads_sha256"],
           "cpu_reference": {k: ref[k] for k in (
               "dtype", "threads", "cpu_capability", "init_s",
               "grad_step_s")}, "card_and_reference_s": ref_s,
           "pinned_env": PINNED_CPU_ENV, "cpu_host": cpu_host(),
           "loss_rel_err": loss_rel, "grad_rel_err_max": worst,
           "grad_step_card_s": dev_s}
    if loss_rel > TRAIN_LOSS_REL_TOL or worst > TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"train (e): card against CPU {res}")
    return res


# ---------------------------------------------------------------------------
# 20. the remaining dense archs: qwen3-8b, stablelm-3b, starcoder2-15b
# ---------------------------------------------------------------------------

# each arch at full width and depth (bf16, weights from seed 0): (a) served
# by FunkyRuntime -> ServeTask at its PATHS entry (batch 8, prompt 512, 32
# tokens), (b) kernel path against plain path, (c) the engine phase's
# configuration on the first ``n_requests`` of its requests through
# RequestRouter -> EngineServeTask, single-step and 8 fused with one
# EXECUTE ahead, then on a monitor to iteration ``logit_at`` for the logit
# checks.  Cut: 8 of the 24 requests, no evict/resume run.
# each arch at full width cut to a quarter of its depth (``_depth_cut``):
# the mesh phase's ~45 s are paid by this cut and moe's (at full depth
# the phase took 84.2 s of a 908 s script, at half depth 48.0-57.0 s)
DENSE_ARCHS = dict(keys=("qwen3", "stablelm", "starcoder2"), archs=None,
                   layers={"qwen3": 9, "stablelm": 8, "starcoder2": 10},
                   serve_prompt=None, engine=dict(ENGINE, n_requests=8),
                   logit_at=6, max_phase_s=200)


def _dense_logit_checks(arch, device, ec, logit_at, capture=None):
    """The engine at ``ec`` on a monitor, stepped to iteration
    ``logit_at`` with lanes in flight: one paged decode step's and each
    bucket's B 1 prefill's kernel-path logits against the plain path's
    (``_paged_logit_check``, ``_prefill_logit_check``, each given
    ``capture``; on the card only)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import FunkyCL, Monitor, SliceAllocator
    from repro_torch.scaling.metrics import MetricsRegistry
    from repro_torch.serve.engine import ContinuousBatchingEngine

    cfg = get_arch(arch)
    mon = Monitor("dense-logits", SliceAllocator(
        "node0", 1, mem_cap_bytes=64 << 30, device=device),
        telemetry=MetricsRegistry())
    try:
        eng = ContinuousBatchingEngine(arch, FunkyCL(mon), seed=SEED,
                                       engine_id="dense-logits",
                                       **_engine_kw(ec))
        eng.setup()
        for r in engine_requests(cfg.vocab_size, ec["n_requests"]):
            eng.submit(r)
        for _ in range(logit_at):
            eng.step()
        if not eng.active_count:
            raise AssertionError(f"{arch}: no lane in flight at iteration "
                                 f"{logit_at}")
        if device != "cuda":
            return None, []
        return (_paged_logit_check(eng, mon, cfg, capture),
                _prefill_logit_check(eng, mon, cfg, capture))
    finally:
        mon.vfpga_exit()
        del mon
        if device == "cuda":
            _free_cuda()


def _arch_run(state, key, arch, device, ec, logit_at, serve_prompt=None,
              capture=None):
    """One arch of the dense_archs and moe phases, freed before it
    returns: (a) served through the runtime with exact launch counts
    (``PATHS[key]``), (b) kernel path against plain path
    (``_parity``), (c) the engine at ``ec`` single-step and 8 fused with
    one EXECUTE ahead (same tokens; K2 once a layer per admission, K1
    paged once a layer per decode step, dense K1 never), (d) a paged
    decode step's and each bucket's prefill's logits
    (``_dense_logit_checks``, given ``capture``).  Returns the arch's
    record (its peak GB over all four on the card) and the engine runs'
    launches.  ``serve_prompt`` replaces the path's prompt in (a)."""
    import torch

    from repro_torch.configs import get_arch

    t_arch, peaks = time.perf_counter(), []

    def peak():
        if device == "cuda":
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)

    if device == "cuda":
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(arch)
    a = _serve(state, key, device, arch, serve_prompt)
    peak()
    n0 = _counts()
    b = _parity(state, key, device, arch)
    if device == "cuda" and not any(PATHS[key][2:]) and _counts() != n0:
        raise AssertionError(f"{arch}: kernel vs plain path launched "
                             f"{_counts()} (from {n0}); its path launches "
                             "no kernel")
    peak()
    a_tok, ca = _engine_served(arch, device, 1, 0, f"{key}-a", ec)
    state.setdefault("arch_engine_tokens", {})[arch] = a_tok
    peak()
    b_tok, cb = _engine_served(arch, device, 8, 1, f"{key}-b", ec)
    peak()
    if b_tok != a_tok:
        raise AssertionError(f"{arch}: fused tokens differ from single-step:"
                             f" {_first_divergence(b_tok, a_tok)}")
    check, prefill_checks = _dense_logit_checks(arch, device, ec, logit_at,
                                                capture)
    peak()
    launches = collections.Counter()
    for run in (ca, cb):
        launches.update(run["launches"])
    rec = {"arch": arch, "layers": cfg.num_layers, "serve": a, "parity": b,
           "engine": {run: {k: st[k] for k in (
               "wall_s", "ttft_p50_s", "ttft_p99_s", "decode_tokens_per_s",
               "tbt_req_mean_p50_s", "decode_steps", "prefills",
               "launches")}
               for run, st in (("a_single_step", ca),
                               ("b_fused8_async1", cb))},
           "logit_check": check, "prefill_logit_check": prefill_checks,
           "arch_s": time.perf_counter() - t_arch}
    if check is not None:
        rec["decode_step_warm_ms"] = check["decode_step_warm_s"] * 1e3
        rec["decode_trace"] = check["decode_trace"]
    if device == "cuda":
        rec["peak_gb"] = max(peaks)
    return rec, launches


def _logit_gate(rec, ec):
    """An arch run's paged decode step and every bucket's prefill within
    LOGIT_REL_TOL (on the card; with the routing diffs, where logged)."""
    check, pre = rec["logit_check"], rec["prefill_logit_check"]
    if (check["logit_rel_err"] > LOGIT_REL_TOL
            or len(pre) != len(ec["prompt_buckets"])
            or any(p["logit_rel_err"] > LOGIT_REL_TOL for p in pre)):
        raise AssertionError(
            f"{rec['arch']}: kernel vs plain logits: decode "
            f"{check['logit_rel_err']} (routing "
            f"{rec.get('decode_routing')}), prefill {pre} (routing "
            f"{rec.get('prefill_routing')})")


def phase_dense_archs(state, device="cuda", cut=None):
    """qwen3-8b (qk-norm), stablelm-3b (LayerNorm, rotary on a quarter of
    hd 80, MHA) and starcoder2-15b (LayerNorm, GELU, group 12) at full
    width cut to a quarter of their depth (``layers``: 9 of 36, 8 of 32,
    10 of 40), one after another, each freed before the next (``_arch_run``):
    (a) served through the runtime with exact launch counts (``PATHS``),
    (b) kernel path against plain path within LOGIT_REL_TOL, (c) the engine
    path of ``DENSE_ARCHS`` (single-step and fused transcripts identical;
    K2 once a layer per admission, K1 paged once a layer per decode step,
    dense K1 never; a paged decode step's and each bucket's prefill's
    logits within LOGIT_REL_TOL).  The phase holds under ``max_phase_s``.
    ``cut`` overrides ``DENSE_ARCHS`` (``archs`` and ``serve_prompt``
    replace the paths' archs and prompt: a rehearsal on the CPU at smoke
    size)."""
    from repro_torch.configs import get_arch

    dc = dict(DENSE_ARCHS, **(cut or {}))
    ec, t_phase = dc["engine"], time.perf_counter()
    archs = dc["archs"] or tuple(PATHS[k][0] for k in dc["keys"])
    out, launches = {}, collections.Counter()
    for key, arch in zip(dc["keys"], archs):
        with _depth_cut(arch, dc["layers"][key]) as cut:
            cfg = get_arch(cut)
            rec, runs = _arch_run(state, key, cut, device, ec,
                                  dc["logit_at"], dc["serve_prompt"])
        launches.update(runs)
        rec.update(layers_of=get_arch(arch).num_layers,
                   head_dim=cfg.head_dim_,
                   heads=[cfg.num_heads, cfg.num_kv_heads],
                   norm=cfg.norm_kind, qk_norm=cfg.qk_norm,
                   mlp=cfg.mlp_kind, rope_pct=cfg.rope_pct)
        log(phase="dense_archs", card=state.get("card"), **rec)
        out[key] = rec
        if device == "cuda":
            _logit_gate(rec, ec)
    stats = {"phase_s": time.perf_counter() - t_phase,
             "launches": {k: launches.get(k, 0) for k in _wrappers()}}
    log(phase="dense_archs", card=state.get("card"), summary=stats)
    state.setdefault("launches", {})["dense_archs"] = stats["launches"]
    state["dense_archs"] = {**out, **stats}
    if device == "cuda" and stats["phase_s"] > dc["max_phase_s"]:
        raise AssertionError(f"dense_archs: the phase took "
                             f"{stats['phase_s']:.1f} s, over "
                             f"{dc['max_phase_s']} s")


# ---------------------------------------------------------------------------
# 21. the MoE family
# ---------------------------------------------------------------------------

# deepseek-moe-16b at full width and depth (``layers`` None: no cut)
# full width at half depth (14 of 28 layers), a cut that pays with
# dense_archs' for the mesh phase (42.7 s at full depth, call 114)
MOE = dict(key="deepseek_moe", arch=None, layers=14, serve_prompt=None,
           engine=dict(ENGINE, n_requests=8), logit_at=6, max_phase_s=150,
           max_peak_gb=45)


def _routing_pin(store):
    """A ``capture`` that holds the plain path to the kernel path's
    routing.  Under a tag ending in "kernel", every MoE block's top-k
    expert ids are recorded in ``store[tag]``, one (rows, k) CPU tensor a
    block; under the same tag ending in "naive", run after it, each block
    takes the recorded ids in the same order, with its router's
    probabilities of them as gates, and the ids its own router picks are
    recorded in ``store[tag]`` for ``_routing_diff``.  The top-k is
    discontinuous: a bf16 rounding difference upstream flips a near-tie,
    and a flip moves a token's logits, and through the capacity its
    neighbours', by far more than the attention kernels' rounding; with
    the routing held, the logit gates see the kernels."""
    from repro_torch.models import moe

    @contextlib.contextmanager
    def capture(tag):
        inner, calls = moe._top_k, store.setdefault(tag, [])
        replay = (iter(store[tag[:-len("naive")] + "kernel"])
                  if tag.endswith("naive") else None)

        def pinned(probs, k):
            top_p, top_e = inner(probs, k)
            calls.append(top_e.cpu())
            if replay is None:
                return top_p, top_e
            top_e = next(replay).to(probs.device)
            return probs.gather(-1, top_e), top_e

        moe._top_k = pinned
        try:
            yield
        finally:
            moe._top_k = inner
    return capture


def _routing_diff(cfg, store, a, b, rows=None):
    """Rows whose top-k expert set differs between the paths ``a`` and
    ``b`` over all MoE blocks (only ``rows``, e.g. the active lanes, when
    given), and the first: its layer, its row and the two sets."""
    n, first = 0, None
    for i, (ea, eb) in enumerate(zip(store.get(a, []), store.get(b, []))):
        sa, sb = ea.sort(-1)[0], eb.sort(-1)[0]
        if rows is not None:
            sa, sb = sa[rows], sb[rows]
        bad = (sa != sb).any(-1).nonzero().flatten().tolist()
        n += len(bad)
        if bad and first is None:
            r = bad[0]
            first = {"layer": cfg.moe.n_dense_layers + i,
                     "row": rows[r] if rows is not None else r,
                     "experts_kernel": sa[r].tolist(),
                     "experts_plain": sb[r].tolist()}
    return {"moe_blocks": len(store.get(a, [])), "rows_differing": n,
            "first": first}


def _expert_path(cfg, live, reps=10):
    """Device time of one MoE block's ``moe_fwd`` at the paged decode's
    shape (``DECODE_ROWS`` rows, ``live`` lanes; random weights of one
    block and random unit-variance rows), from a trace, by kernel name:
    the GEMMs (the three expert bmm's, the shared experts' matmuls, the
    router's) and the other ops (routing, dispatch, combine, elementwise);
    times the model's MoE blocks, the expert path of one decode step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.moe import init_moe, moe_fwd
    from repro_torch.models.transformer import DECODE_ROWS

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p = init_moe(cfg, torch.device("cuda"), gen)
    x = torch.randn((DECODE_ROWS, 1, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        def run():
            moe_fwd(cfg, p, x, live=live, aux=False)

        timed(run, 3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = timed(run, reps)
    by_name, launches = collections.Counter(), 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_name[e.key] += e.self_device_time_total / 1e3 / reps
        elif e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                       "cuLaunchKernelEx", "cudaLaunchKernelExC"):
            launches += e.count / reps
    gemm = sum(ms for k, ms in by_name.items()
               if any(g in k.lower() for g in GEMM_SYMBOLS))
    block = sum(by_name.values())
    n_moe = cfg.num_layers - cfg.moe.n_dense_layers
    del p, x
    return {"rows": DECODE_ROWS, "live": live, "block_device_ms": block,
            "block_gemm_ms": gemm, "block_other_ms": block - gemm,
            "block_wall_ms": wall * 1e3 / reps,
            "block_launches": launches, "moe_blocks": n_moe,
            "step_device_ms": block * n_moe,
            "kernels": [{"kernel": k[:90], "ms": ms}
                        for k, ms in by_name.most_common(10)]}


def phase_moe(state, device="cuda", cut=None):
    """deepseek-moe-16b at full width cut to half its depth (14 of 28
    layers, 64 routed experts top-6 and 2 shared, MHA 16/16 heads of 128):
    (a) served through the runtime with exact launch counts (``PATHS``),
    (b) kernel path against plain path within LOGIT_REL_TOL, (c) the
    engine path of ``MOE`` (single-step and fused transcripts identical;
    K2 L per admission, K1 paged L per decode step, dense K1 never),
    (d) a paged decode step's and each bucket's prefill's logits within
    LOGIT_REL_TOL.  In (b) and (d) the plain path takes the kernel path's
    routing (``_routing_pin``), and the log counts the rows whose top-k
    expert set its own router would have picked otherwise, with the first
    one's layer, row and two sets; (b) also logs the logits against the
    plain path on its own routing (not gated).  Then the warm decode
    step's trace and the expert path's device time (``_expert_path``).
    The phase holds under ``max_phase_s`` and ``max_peak_gb``.  ``cut``
    overrides ``MOE`` (``arch`` and ``serve_prompt`` replace the path's: a
    rehearsal on the CPU at smoke size)."""
    mc = dict(MOE, **(cut or {}))
    t_phase = time.perf_counter()
    with _depth_cut(mc["arch"] or PATHS[mc["key"]][0], mc["layers"]) as arch:
        _routed_phase(state, "moe", mc, arch, device, t_phase)


def _routed_phase(state, phase, mc, arch, device, t_phase):
    """The moe and mla phases' body on ``arch``: ``_arch_run`` with the
    plain path on the kernel path's routing, the routing diffs, the expert
    path's device time and share of the warm decode step, the log, the
    launches, and on the card the logit, peak and time gates."""
    import torch

    from repro_torch.configs import get_arch

    ec, key = mc["engine"], mc["key"]
    cfg = get_arch(arch)
    if device == "cuda" and (torch.backends.cuda.matmul.allow_tf32 or
                             torch.get_float32_matmul_precision()
                             != "highest"):
        raise AssertionError(f"{phase}: TF32 is enabled")
    routing = {}
    rec, launches = _arch_run(state, key, arch, device, ec, mc["logit_at"],
                              mc["serve_prompt"], _routing_pin(routing))
    rec.update(experts=[cfg.moe.num_experts, cfg.moe.top_k,
                        cfg.moe.num_shared_experts],
               params=cfg.param_count())
    if cfg.mla.enabled:
        m = cfg.mla
        rec.update(mla=[m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
                        m.qk_rope_head_dim, m.v_head_dim],
                   layers_of=get_arch(PATHS[key][0]).num_layers)
    if cfg.mla.enabled:
        n0 = _counts()
        rec["features"] = _mla_features(
            arch, device, ec, state["arch_engine_tokens"][arch])
        launches.update({k: n - n0[k] for k, n in _counts().items()})
        if device == "cuda":
            rec["peak_gb"] = max(rec["peak_gb"],
                                 rec["features"].pop("peak_gb"))
    check = rec["logit_check"]
    if check is not None:
        rec["decode_routing"] = _routing_diff(cfg, routing, "kernel",
                                              "naive", check["active_rows"])
        rec["prefill_routing"] = {
            P: _routing_diff(cfg, routing, f"p{P}_kernel", f"p{P}_naive")
            for P in ec["prompt_buckets"]}
        rec["expert_path"] = _expert_path(cfg, ec["slots"])
        rec["expert_path_share"] = (rec["expert_path"]["step_device_ms"]
                                    / check["decode_trace"]["device_ms"])
        rec["peak_gb"] = max(rec["peak_gb"],
                             torch.cuda.max_memory_allocated() / 1e9)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(phase=phase, card=state.get("card"), **rec)
    state.setdefault("launches", {})[phase] = {
        k: launches.get(k, 0) for k in _wrappers()}
    state[phase] = {key: rec, "phase_s": rec["phase_s"]}
    if device != "cuda":
        return
    _logit_gate(rec, ec)
    if rec["peak_gb"] > mc["max_peak_gb"]:
        raise AssertionError(f"{phase}: peak {rec['peak_gb']:.2f} GB, over "
                             f"{mc['max_peak_gb']} GB")
    if rec["phase_s"] > mc["max_phase_s"]:
        raise AssertionError(f"{phase}: the phase took "
                             f"{rec['phase_s']:.1f} s, over "
                             f"{mc['max_phase_s']} s")


# ---------------------------------------------------------------------------
# 22. MLA
# ---------------------------------------------------------------------------

# deepseek-v3-671b at full width cut to ``layers`` of its 61: the three
# dense MLA + MLP layers (d_ff 18432) and one MLA + MoE layer (256 routed
# experts of 2048, top-8, 1 shared), 15.11 B parameters, 30.22 GB in bf16
# (5 layers would take 53.2 GB, over the peak gate).  The moe phase's
# steps, the engine on 8 requests.
MLA = dict(key="deepseek_v3", arch=None, layers=4, serve_prompt=None,
           engine=dict(ENGINE, n_requests=8), logit_at=6, max_phase_s=120,
           max_peak_gb=45)


@contextlib.contextmanager
def _few_experts(arch):
    """``arch`` with ``top_k`` routed experts (its width, depth and
    vocabulary kept), registered in the port's arch registry while the
    block runs: a draft model small beside its target."""
    import dataclasses

    from repro_torch.configs import get_arch, registry

    cfg = get_arch(arch)
    name = f"{arch}-{cfg.moe.top_k}experts"
    registry.ARCHS[name] = dataclasses.replace(cfg, name=name, moe=(
        dataclasses.replace(cfg.moe, num_experts=cfg.moe.top_k)))
    try:
        yield name
    finally:
        registry.ARCHS.pop(name, None)


def _mla_features(arch, device, ec, want):
    """The engine's features over latent pages at ``ec``, each run on its
    own monitor and freed before the next: (e) the prefix cache, the
    workload's shortest prompt served cold and then again as a full hit,
    the hit with the cold run's tokens (a prefix engine admits a prompt by
    one-lane paged decode steps, ``prefill_chunk``, whose bf16 cache is not
    the blockwise prefill's: the log gives the first token where the cold
    run leaves run (a)'s); (f)
    speculative decode, k 2, of the first two requests, the draft the
    model itself with its routed experts cut to ``top_k`` (a self-draft
    would hold two 30.22 GB copies, over the peak gate; a shallower cut
    has no MoE layer, which the plan does not build); (g) a prefill
    replica admits the first two requests and hands each lane off
    (``export_lane``: ``xfer_extract`` of its ``ckv``/``k_pe`` pages and a
    d2h read), is freed, and a decode replica installs the lanes
    (``import_lane``: h2d, ``xfer_install``, ``lane_set``) and decodes
    them to the end; (f) and (g) with run (a)'s tokens ``want``.  Returns
    each run's stats and seconds, and the peak GB on the card."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import FunkyCL, Monitor, SliceAllocator
    from repro_torch.scaling.metrics import MetricsRegistry
    from repro_torch.serve.engine import ContinuousBatchingEngine, SpecConfig

    cfg = get_arch(arch)
    reqs = engine_requests(cfg.vocab_size, ec["n_requests"])
    out, peaks = {}, []

    def engine(tag, **kw):
        mon = Monitor(f"mla-{tag}", SliceAllocator(
            "node0", 1, mem_cap_bytes=64 << 30, device=device),
            telemetry=MetricsRegistry())
        eng = ContinuousBatchingEngine(arch, FunkyCL(mon), seed=SEED,
                                       engine_id=f"mla-{tag}",
                                       **dict(_engine_kw(ec), **kw))
        eng.setup()
        return mon, eng

    def done(tag, mon, eng, tokens, t0, ref=None, **stats):
        what = "the cold run" if ref else "run (a)"
        ref = ref or want
        bad = {r: t for r, t in tokens.items()
               if t != ref[r.split("-")[0]]}
        if bad:
            raise AssertionError(f"mla ({tag}): tokens differ from {what} "
                                 f"for {sorted(bad)}")
        mon.vfpga_exit()
        if device == "cuda":
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            _free_cuda()
        out[tag] = {"requests": sorted(tokens), "s":
                    time.perf_counter() - t0, **stats}

    # (e) a prefix hit: cold, then the same prompt again
    t0 = time.perf_counter()
    mon, eng = engine("e", prefix_cache=True)
    r = min(reqs, key=lambda q: len(q.prompt))
    for rid in (r.rid, f"{r.rid}-hit"):
        eng.submit(type(r)(rid=rid, prompt=r.prompt,
                           max_new_tokens=r.max_new_tokens))
        eng.run_until_drained()
    st = eng.prefix_stats()
    if st["hits"] < 1:
        raise AssertionError(f"mla (e): no prefix hit: {st}")
    tokens = {k: list(c.tokens) for k, c in eng.completed.items()}
    cold = tokens[r.rid]
    done("e_prefix_hit", mon, eng, tokens, t0, ref={r.rid: cold},
         prefix_stats={k: st[k] for k in ("hits", "cached_tokens",
                                          "prompt_tokens", "hit_rate")},
         first_divergence_from_run_a=next(
             (i for i, (x, y) in enumerate(zip(cold, want[r.rid]))
              if x != y), None))
    del eng
    # (f) speculative decode, the draft the model with top_k experts
    with _few_experts(arch) as draft:
        t0 = time.perf_counter()
        mon, eng = engine("f", spec=SpecConfig(k=2, draft_arch=draft))
        for q in reqs[:2]:
            eng.submit(q)
        eng.run_until_drained()
        st = eng.spec_stats()
        done("f_spec_k2", mon, eng, {k: list(c.tokens) for k, c in
                                     eng.completed.items()}, t0,
             draft=draft, spec_stats=st)
        del eng
    # (g) a prefill replica's lanes handed to a decode replica
    t0 = time.perf_counter()
    mon, eng = engine("g_prefill", role="prefill")
    for q in reqs[:2]:
        eng.submit(q)
    handoffs = []
    while len(handoffs) < 2 and not eng.idle:
        eng.step()
        handoffs += [eng.export_lane(st) for st in eng.exportable_lanes()]
    if len(handoffs) < 2:
        raise AssertionError(f"mla (g): {len(handoffs)} lanes handed off")
    export_s = time.perf_counter() - t0
    at_handoff = [len(h.tokens) for h in handoffs]
    mon.vfpga_exit()
    del eng
    if device == "cuda":
        _free_cuda()
    mon, eng = engine("g_decode", role="decode")
    t1 = time.perf_counter()
    if not all(eng.import_lane(h) for h in handoffs):
        raise AssertionError("mla (g): the decode replica refused a lane")
    install_s = time.perf_counter() - t1
    eng.run_until_drained()
    done("g_handoff", mon, eng, {k: list(c.tokens) for k, c in
                                 eng.completed.items()}, t0,
         handoffs=len(handoffs), pages=sum(h.n_pages for h in handoffs),
         tokens_at_handoff=at_handoff,
         export_s=export_s, install_s=install_s)
    del eng, handoffs
    if peaks:
        out["peak_gb"] = max(peaks)
    return out


def phase_mla(state, device="cuda", cut=None):
    """deepseek-v3-671b at full width (d_model 7168, 128 heads; MLA with
    q_lora 1536, kv_lora 512, q/k head dim 128 + 64, v 128) cut to 4 of
    its 61 layers (``_depth_cut``): (a) served through the runtime
    (``ServeTask``: blockwise prefill, absorbed decode) with exact launch
    counts, none (``PATHS``), (b) absorbed decode against decompressed
    decode on the served prefill's decode steps, within LOGIT_REL_TOL,
    (c) the engine path of ``MLA`` over a pool of latent pages
    (single-step and fused transcripts identical; no launch), (d) a paged
    decode step's logits (absorbed) against the plain gather +
    decompressed decode, and each bucket's blockwise prefill against the
    naive one, within LOGIT_REL_TOL.  In (b) and (d) the decompressed side
    takes the absorbed side's MoE routing (``_routing_pin``; the log
    counts the rows its own router would route otherwise).  Then the warm
    decode step's trace and the expert layer's device time and share
    (``_expert_path``).  Any kernel launch fails the phase.  It holds
    under ``max_phase_s`` and ``max_peak_gb``.  ``cut`` overrides ``MLA``
    (``arch`` and ``serve_prompt`` replace the path's: a rehearsal on the
    CPU at smoke size)."""
    mc = dict(MLA, **(cut or {}))
    t_phase = time.perf_counter()
    with _depth_cut(mc["arch"] or PATHS[mc["key"]][0], mc["layers"]) as arch:
        _routed_phase(state, "mla", mc, arch, device, t_phase)


# ---------------------------------------------------------------------------
# 23. the encoder-decoder and the VLM
# ---------------------------------------------------------------------------

# both at full width and depth, batch 8, 32 new tokens through ``generate``;
# the logit parity at the same batch (both paths' caches fit beside the
# weights)
FAMILIES = dict(keys=("seamless", "llava"), archs=None, seq=None, batch=8,
                new_tokens=32, parity_steps=4, max_phase_s=150,
                max_peak_gb=45)


def _family_batch(cfg, S, B, device):
    """The prompt of ``make_batch``'s batch at ``S`` and ``B``: encdec
    ``src_emb`` (S frames) and ``tgt_tokens`` (S * tgt_ratio); vlm
    ``img_emb`` (num_image_tokens) and ``tokens`` (S - num_image_tokens).
    Returns it on ``device`` and the first decode position."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.train import make_batch

    b = make_batch(cfg, ShapeConfig("p", "train", S, B), 0)
    if cfg.family == "encdec":
        keys, pos = ("src_emb", "tgt_tokens"), b["tgt_tokens"].shape[1]
    else:
        keys = ("tokens", "img_emb")
        pos = b["tokens"].shape[1] + cfg.num_image_tokens
    return {k: torch.as_tensor(b[k]).to(device) for k in keys}, pos


def _family_shapes(cfg, batch, B, n_tok, margin):
    """The launches a served run must make, by case and by the wrappers'
    shape keys: K2 once a layer per prefill (encdec: encoder, decoder
    self and cross), K1 once a layer per token (encdec: self and cross)."""
    if cfg.family == "encdec":
        L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim_
        S, T = batch["src_emb"].shape[1], batch["tgt_tokens"].shape[1]
        kv = cfg.num_kv_heads
        k2 = {"enc": ((B, S, S, H, kv, hd, False), cfg.encoder_layers),
              "dec_prefill": ((B, T, T, H, kv, hd, True), L),
              "cross": ((B, T, S, H, kv, hd, False), L)}
        k1 = {"seamless_self": ((B, T + margin, H, kv, hd), L * n_tok),
              "cross": ((B, S, H, kv, hd), L * n_tok)}
    else:
        L, H, kv, hd = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim_)
        S = batch["tokens"].shape[1] + cfg.num_image_tokens
        k2 = {"llava": ((B, S, S, H, kv, hd, True), L)}
        k1 = {"llava": ((B, S + margin, H, kv, hd), L * n_tok)}
    return k2, k1


def _family_parity(kern, plain, params, batch, pos, steps):
    """The kernel path and the plain path (blockwise prefill, plain
    decode) on one set of weights: prefill, then ``steps`` decode steps of
    the kernel path's tokens.  Returns max|logit - plain| / max|plain| per
    step, the greedy-token agreement, the kernel path's logits, caches and
    position after the last step, and its warm prefill seconds."""
    import torch

    rels, agree = [], []
    with torch.no_grad():
        plain_out = plain.prefill_fn(params, batch)
        t0 = time.perf_counter()
        out = kern.prefill_fn(params, batch)
        if out[0].is_cuda:
            torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        for i in range(steps + 1):
            kl, pl = out[0].float(), plain_out[0].float()
            rels.append(((kl - pl).abs().max() / pl.abs().max()).item())
            agree.append((kl.argmax(-1) == pl.argmax(-1)).float().mean()
                         .item())
            if i == steps:
                break
            tok = out[0].argmax(-1).to(torch.int32)
            out = kern.decode_fn(params, tok, pos + i, out[1], inplace=True)
            plain_out = plain.decode_fn(params, tok, pos + i, plain_out[1],
                                        inplace=True)
    del plain_out
    return rels, agree, out, pos + steps, prefill_s


def _family_run(state, key, arch, fc, device):
    """One arch of the families phase, freed before it returns: (a) or (b)
    served through ``generate`` with exact launch counts by shape, (c) the
    kernel path against the plain path, (d) one warm decode step traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serve import generate

    t_arch = time.perf_counter()
    cfg = get_arch(arch)
    kern = build_model(cfg)
    plain = build_model(cfg, prefill_impl="blockwise", decode_impl="naive")
    B, n_tok = fc["batch"], fc["new_tokens"]
    params = kern.init(SEED, device=device)
    batch, pos = _family_batch(cfg, fc["seq"] or PATHS[key][1], B, device)
    k2, k1 = _family_shapes(cfg, batch, B, n_tok, kern.cache_margin)
    # (a)/(b) served: the counts zeroed just before, read just after
    _zero_counts()
    t0 = time.perf_counter()
    toks = generate(kern, params, batch, n_tok)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    by_shape = {"K2": dict(_wrappers()["K2"].launches_by_shape),
                "K1": dict(_wrappers()["K1"].launches_by_shape)}
    if tuple(toks.shape) != (B, n_tok) or not (
            (0 <= toks) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: bad tokens {tuple(toks.shape)}")
    per_prefill, per_token = PATHS[key][2:]
    expected = {k: per_prefill.get(k, 0) + n_tok * per_token.get(k, 0)
                for k in _wrappers()}
    want_shapes = {"K2": {s: n for s, n in k2.values()},
                   "K1": {s: n for s, n in k1.values()}}
    if device == "cuda" and (
            {k: launches[k] for k in expected} != expected
            or by_shape != want_shapes):
        raise AssertionError(f"{arch}: launches {launches} by shape "
                             f"{by_shape}, expected {expected} by shape "
                             f"{want_shapes} (one prefill, {n_tok} tokens)")
    # (c) the kernel path against the plain path on the same weights
    rels, agree, run, run_pos, prefill_s = _family_parity(
        kern, plain, params, batch, pos, fc["parity_steps"])
    rec = {"arch": arch, "family": cfg.family, "batch": B,
           "prompt": {k: list(t.shape) for k, t in batch.items()},
           "first_decode_pos": pos, "new_tokens": n_tok,
           "layers": [cfg.encoder_layers, cfg.num_layers],
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "head_dim": cfg.head_dim_, "params": cfg.param_count(),
           "served": {"wall_s": wall, "decode_tokens_per_s_incl_prefill":
                      B * n_tok / wall, "launches": launches,
                      "launches_by_case": {
                          "K2": {c: by_shape["K2"].get(s, 0)
                                 for c, (s, _) in k2.items()},
                          "K1": {c: by_shape["K1"].get(s, 0)
                                 for c, (s, _) in k1.items()}},
                      "last_tokens": toks[:, -1].tolist()},
           "parity": {"logit_rel_err": rels, "token_agreement": agree,
                      "bound": LOGIT_REL_TOL, "batch": B},
           "prefill_warm_s": prefill_s}
    del toks
    # (d) one warm decode step of the kernel path, timed and traced
    if device == "cuda":
        def decode():
            nonlocal run_pos
            tok = run[0].argmax(-1).to(torch.int32)
            run[:] = kern.decode_fn(params, tok, run_pos, run[1],
                                    inplace=True)
            run_pos += 1

        run = list(run)
        with torch.no_grad():
            timed(decode, 2)
            rec["decode_step_warm_ms"] = timed(decode, 4) / 4 * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = timed(decode, 2)
        rec["decode_trace"] = _trace_summary(prof, wall, 2)
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del run, params, batch
    if device == "cuda":
        _free_cuda()
    rec["arch_s"] = time.perf_counter() - t_arch
    return rec


def phase_families(state, device="cuda", cut=None):
    """The last two families at full width and depth, one after the other,
    each freed before the next (``_family_run``), on random weights from
    ``SEED``: (a) seamless-m4t-large-v2 (24 encoder + 24 decoder layers,
    d_model 1024, 16/16 heads of 64, vocab 256206; 1.63 B parameters)
    served through ``generate`` at batch 8 from 1024 source frames
    (``src_emb``, the stubbed speech frontend) and a target prompt of 256,
    32 new tokens: K2 72 launches per prefill (24 encoder, non-causal; 24
    decoder self, causal; 24 cross, 256 rows against 1024) and K1 48 per
    token (24 self ring, 24 cross cache), exact by shape; (b)
    llava-next-mistral-7b (32 layers, 32/8 heads of 128; 7.24 B
    parameters) served the same way from 2880 image embeddings (anyres
    5 x 576) and 192 text tokens: K2 32 per prefill, K1 32 per token,
    decoding from position 3072; (c) for each, the kernel path against the
    plain path (blockwise prefill, plain decode) on the same weights over
    the prefill and 4 decode steps, within LOGIT_REL_TOL at the served
    batch; (d) one warm decode step of each, traced (busy share,
    launches, the kernels that take the time).  The phase holds under
    ``max_phase_s`` and ``max_peak_gb``.  ``cut`` overrides ``FAMILIES``
    (``archs``, ``seq``, ``batch`` and ``new_tokens`` replace the paths':
    a rehearsal on the CPU at smoke size, where nothing launches and the
    counts, the logit gate and the trace are not checked)."""
    import torch

    fc = dict(FAMILIES, **(cut or {}))
    t_phase = time.perf_counter()
    if device == "cuda":
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
    archs = fc["archs"] or tuple(PATHS[k][0] for k in fc["keys"])
    out = {}
    for key, arch in zip(fc["keys"], archs):
        rec = _family_run(state, key, arch, fc, device)
        log(phase="families", card=state.get("card"), **rec)
        out[key] = rec
        state.setdefault("launches", {})[key] = rec["served"]["launches"]
        if device == "cuda" and max(rec["parity"]["logit_rel_err"]) \
                > LOGIT_REL_TOL:
            raise AssertionError(f"{arch}: kernel vs plain logits differ by "
                                 f"{rec['parity']['logit_rel_err']}")
    stats = {"phase_s": time.perf_counter() - t_phase}
    if device == "cuda":
        stats["peak_gb"] = max(r["peak_gb"] for r in out.values())
    log(phase="families", card=state.get("card"), summary=stats)
    state["families"] = {**out, **stats}
    if device != "cuda":
        return
    if stats["peak_gb"] > fc["max_peak_gb"]:
        raise AssertionError(f"families: peak {stats['peak_gb']:.2f} GB, "
                             f"over {fc['max_peak_gb']} GB")
    if stats["phase_s"] > fc["max_phase_s"]:
        raise AssertionError(f"families: the phase took "
                             f"{stats['phase_s']:.1f} s, over "
                             f"{fc['max_phase_s']} s")


# ---------------------------------------------------------------------------
# 24. the launch layer
# ---------------------------------------------------------------------------

LAUNCH = dict(serve=dict(key="qwen3", layers=18, batch=8, prompt=512,
                         tokens=64, tokens_per_step=8),
              train=dict(arch="yi-9b", layers=8, seq=1024, batch=8, chunks=4,
                         steps=4),
              remats=("none", "full", "dots"), remat_microbatches=2,
              remat_steps=2, max_phase_s=120.0, max_peak_gb=45.0)
# (c) runs the train cut in 2 microbatches, not TRAIN's 4: at 4 the peak
# of "full" and of "dots" is the accumulation's (the f32 accumulator and
# a microbatch's gradients beside the state), the same for both
# (``dryrun``'s meta estimate: 31.98 GB each, "none" 35.2), where at 2 the
# saved activations set it (31.98 / 33.67 / 43.71 GB)
REMAT_GRAD_NORM_REL_TOL = 1e-5


def _launch_serve(sc, device, arch):
    """(a): ``launch.serve.main`` at ``sc``, then a ``ServeTask`` on the
    same image run directly on a ``FunkyRuntime``.  Returns the CLI's
    record, its launches and the direct run's last tokens."""
    from repro_torch.core import (FunkyRuntime, SliceAllocator, TaskStatus)
    from repro_torch.launch import serve as launch_serve

    argv = ["--arch", arch, "--batch", str(sc["batch"]), "--prompt-len",
            str(sc["prompt"]), "--tokens", str(sc["tokens"]),
            "--tokens-per-step", str(sc["tokens_per_step"]), "--device",
            device]
    _zero_counts()
    out = launch_serve.main(argv)
    launches = _counts()
    if device == "cuda":
        _free_cuda()
    image = launch_serve.image_of(launch_serve.parse_args(argv))
    rt = FunkyRuntime("node0", SliceAllocator("node0", 1,
                                              mem_cap_bytes=64 << 30,
                                              device=device))
    rt.create("direct", image)
    rt.start("direct")
    if rt.wait("direct", timeout=600) is not TaskStatus.DONE:
        raise RuntimeError(f"launch: the direct ServeTask ended "
                           f"{rt.tasks['direct'].status}: "
                           f"{rt.tasks['direct'].error!r}")
    direct = rt.tasks["direct"].guest_state.user["last_token"]
    rt.delete("direct")
    del rt
    if device == "cuda":
        _free_cuda()
    return out, launches, direct


def _saved_bytes(cell, params, batch, k):
    """Bytes that autograd holds after the forward of the first of ``k``
    microbatches of ``batch`` (what the backward will read), on the card:
    allocated after the loss less allocated before."""
    import torch

    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

    mb = tree_map(lambda x: x[:x.shape[0] // k], batch)
    leaves, treedef = tree_flatten(params)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with torch.enable_grad():
        ps = [t.detach().requires_grad_(True) for t in leaves]
        loss, _ = cell.bundle.loss_fn(tree_unflatten(treedef, ps), mb)
        torch.cuda.synchronize()
        saved = torch.cuda.memory_allocated() - before
    del loss, ps
    return saved


def _launch_remat(tc, lc, device, cfg):
    """(c): ``build_cell`` train steps at the train cut, one remat after
    another, each run's state freed before the next: each step's loss and
    gradient norm, the run's peak and each step's seconds; then, on the
    card, the bytes autograd holds after one microbatch's forward."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import build_cell

    shape = ShapeConfig("launch_train", "train", tc["seq"], tc["batch"])
    k = lc["remat_microbatches"]
    runs = {}
    for remat in lc["remats"]:
        if device == "cuda":
            _free_cuda()
            torch.cuda.reset_peak_memory_stats()
        cell = build_cell(cfg, shape, remat=remat, num_microbatches=k)
        args = cell.materialize(device, SEED)
        losses, norms, secs = [], [], []
        for _ in range(lc["remat_steps"]):
            t = time.perf_counter()
            params, opt, m = cell.fn(*args)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t)
            args = (params, opt, args[2])
        rec = {"loss": losses, "grad_norm": norms, "step_s": secs}
        if device == "cuda":
            torch.cuda.synchronize()
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            rec["saved_gb"] = _saved_bytes(cell, params, args[2], k) / 1e9
        del cell, args, params, opt, m
        runs[remat] = rec
    return shape, runs


def _launch_bounds(cfg_serve, cfg_train, sc, shape_train, runs, served):
    """(d): ``roofline.analyze_cell``'s bounds for (a)'s prefill, (a)'s
    decode step (caches of prompt + 128) and (c)'s "full" train step
    beside the measured times, and ``dryrun``'s meta-device peak estimate
    of each (c) run beside its measured peak."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun, roofline

    cells = {
        "a_prefill": (cfg_serve, ShapeConfig("launch_prefill", "prefill",
                                             sc["prompt"], sc["batch"]),
                      served["prefill_s"]),
        "a_decode": (cfg_serve, ShapeConfig("launch_decode", "decode",
                                            sc["prompt"] + 128, sc["batch"]),
                     served["decode_step_s_median"]),
        "c_train": (cfg_train, shape_train, runs["full"]["step_s"][-1]),
    }
    out = {}
    for name, (cfg, shape, measured) in cells.items():
        rec = roofline.analyze_cell(cfg, shape)
        bound = rec["step_seconds_lower_bound"]
        out[name] = {"bound_s": bound, "bottleneck": rec["bottleneck"],
                     "compute_s": rec["compute_s"],
                     "memory_s": rec["memory_s"],
                     "required_flops": rec["required_flops"],
                     "op_compute_s": rec["op_compute_s"],
                     "op_flops": rec["op_flops_per_device"],
                     "measured_s": measured,
                     "measured_over_bound": measured / bound}
    est = {}
    for remat in runs:
        r = dryrun.run_cell(cfg_train, shape_train, remat=remat,
                            num_microbatches=LAUNCH["remat_microbatches"])
        if r["status"] != "ok":
            raise RuntimeError(f"launch: dryrun of {remat}: {r}")
        est[remat] = {"meta_peak_gb": r["peak_bytes"] / 1e9,
                      "meta_arg_gb": r["arg_bytes"] / 1e9,
                      "measured_peak_gb": runs[remat].get("peak_gb")}
    out["remat_peaks"] = est
    return out


def phase_launch(state, device="cuda", cut=None):
    """The launch layer (``repro_torch.launch``), through the entry points
    a user calls: (a) ``launch.serve.main`` serving full-width qwen3-8b cut
    to 18 of its 36 layers (batch 8, prompt 512, 64 tokens at 8 a step)
    through ``make_cluster`` -> ``FunkyRuntime`` -> ``ServeTask``: K2 once
    a layer per prefill and K1 once a layer per token, exactly, and the
    last tokens of a ``ServeTask`` on the same image run directly; (b)
    ``launch.train.main`` native and through Funky (fig04's pair) at
    ``TRAIN``'s cut (yi-9b at 8 of 48 layers, seq 1024, batch 8 in 4
    chunks, 4 steps): equal final losses, bit for bit; (c) ``build_cell``
    train steps at that cut with ``remat`` "none", "full" and "dots" (2
    microbatches), each freed before the next, run before (b): first-step
    losses equal to the bit, gradient norms within
    ``REMAT_GRAD_NORM_REL_TOL``, the step's peaks and the bytes autograd
    holds after a microbatch's forward each strictly ordered full < dots
    < none; (d) ``roofline``'s bound for
    (a)'s prefill, (a)'s decode step and (c)'s step beside the measured
    times, and ``dryrun``'s meta-device peaks beside (c)'s (no gate).  The
    phase holds under ``max_phase_s`` and ``max_peak_gb``.  ``cut``
    overrides ``LAUNCH`` (``serve`` and ``train`` merge into theirs; an
    ``arch`` in ``serve`` replaces the path's: a rehearsal on the CPU at
    smoke size, where launches, peaks and the budget are not checked)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train

    cut = dict(cut or {})
    lc = dict(LAUNCH, **{k: v for k, v in cut.items()
                         if k not in ("serve", "train")})
    sc = dict(LAUNCH["serve"], **cut.get("serve", {}))
    tc = dict(LAUNCH["train"], **cut.get("train", {}))
    t_phase = time.perf_counter()
    if device == "cuda":
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
    peaks = []

    def peak():
        if device == "cuda":
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)

    out = {}
    # (a) serve: launch.serve.main, then the same image directly
    path_arch, _, per_prefill, per_token = PATHS[sc["key"]]
    with _depth_cut(sc.get("arch") or path_arch, sc["layers"]) as arch:
        cfg_serve = get_arch(arch)
        full = get_arch(path_arch).num_layers
        served, launches, direct = _launch_serve(sc, device, arch)
        peak()
    n_tok = served["new_tokens"]
    expected = {k: (per_prefill.get(k, 0) + n_tok * per_token.get(k, 0))
                * cfg_serve.num_layers // full for k in _counts()}
    out["a"] = {**served, "layers": cfg_serve.num_layers,
                "layers_of": full, "launches": launches,
                "expected_launches": expected,
                "direct_last_token": direct,
                "equal_to_direct": served["last_token"] == direct}
    state.setdefault("launches", {})["launch"] = launches
    log(phase="launch", run="a", card=state.get("card"), **out["a"])
    if device == "cuda" and launches != expected:
        raise AssertionError(f"launch: (a) launches {launches}, expected "
                             f"{expected}")
    if not out["a"]["equal_to_direct"]:
        raise AssertionError(f"launch: (a)'s last tokens {served['last_token']}"
                             f" differ from a direct ServeTask's {direct}")

    with _depth_cut(tc["arch"], tc["layers"]) as arch:
        cfg_train = get_arch(arch)
        # (c) build_cell with each remat; it runs before (b), so that the
        # pair runs warm: on a card that has not trained yet in the
        # process, the first steps take seconds more (PERF.md §6)
        shape_train, runs = _launch_remat(tc, lc, device, cfg_train)
        if device == "cuda":
            peaks.extend(r["peak_gb"] for r in runs.values())
            _free_cuda()
        out["c"] = runs
        log(phase="launch", run="c", card=state.get("card"), **runs)
        first = [r["loss"][0] for r in runs.values()]
        norms = [r["grad_norm"][0] for r in runs.values()]
        if len(set(first)) != 1:
            raise AssertionError(f"launch: (c) first-step losses differ by "
                                 f"remat: {first}")
        if max(norms) - min(norms) > REMAT_GRAD_NORM_REL_TOL * max(norms):
            raise AssertionError(f"launch: (c) gradient norms {norms}")
        for key in ("peak_gb", "saved_gb") if device == "cuda" else ():
            if not (runs["full"][key] < runs["dots"][key]
                    < runs["none"][key]):
                raise AssertionError(
                    f"launch: (c) {key} not full < dots < none: "
                    f"{[r[key] for r in runs.values()]}")

        # (b) fig04's pair through launch.train.main
        argv = ["--arch", arch, "--seq", str(tc["seq"]), "--batch",
                str(tc["batch"]), "--chunks", str(tc["chunks"]), "--steps",
                str(tc["steps"]), "--seed", str(SEED), "--device", device]
        native = launch_train.main(argv + ["--native"])
        peak()
        if device == "cuda":
            _free_cuda()
        funky = launch_train.main(argv)
        peak()
        if device == "cuda":
            _free_cuda()
        out["b"] = {"arch": arch, "native": native, "funky": funky,
                    "equal": native["final_loss"] == funky["final_loss"],
                    "overhead": funky["seconds"] / native["seconds"] - 1,
                    "train_phase_overhead": state.get("train", {}).get(
                        "b", {}).get("overhead"),
                    "paper_overhead_alveo_u50": PAPER_VIRT_OVERHEAD}
        log(phase="launch", run="b", card=state.get("card"), **out["b"])
        if not out["b"]["equal"]:
            raise AssertionError(f"launch: (b) native final loss "
                                 f"{native['final_loss']!r} != Funky's "
                                 f"{funky['final_loss']!r}")

        # (d) the roofline and the dry run beside the card
        out["d"] = _launch_bounds(cfg_serve, cfg_train, sc, shape_train,
                                  runs, served)
        log(phase="launch", run="d", card=state.get("card"), **out["d"])

    stats = {"phase_s": time.perf_counter() - t_phase}
    if device == "cuda":
        stats["peak_gb"] = max(peaks)
    log(phase="launch", card=state.get("card"), summary=stats)
    state["launch"] = {**out, **stats}
    if device != "cuda":
        return
    if stats["peak_gb"] > lc["max_peak_gb"]:
        raise AssertionError(f"launch: peak {stats['peak_gb']:.2f} GB, over "
                             f"{lc['max_peak_gb']} GB")
    if stats["phase_s"] > lc["max_phase_s"]:
        raise AssertionError(f"launch: the phase took {stats['phase_s']:.1f}"
                             f" s, over {lc['max_phase_s']} s")


MESH = dict(train=dict(arch="yi-9b", layers=8, seq=1024, batch=8, chunks=2),
            serve=dict(key="mesh", arch=None, layers=12, batch=8,
                       prompt=512, tokens=32),
            moe=dict(arch="deepseek-moe-16b", batch=8, seq=512),
            policies=("tp", "fsdp_tp", "fsdp"), max_phase_s=60.0,
            max_peak_gb=45.0)


@contextlib.contextmanager
def _one_rank_mesh(device):
    """A process group of one rank (NCCL on the card, gloo on the CPU; a
    ``HashStore``, no network) and a (1, 1) ``("data", "model")`` mesh on
    it; the group is destroyed on exit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device=device)
    finally:
        dist.destroy_process_group()


def _full(t):
    """A DTensor's global value (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _max_diff(a, b):
    """(bitwise equal, largest |a - b|) over two trees of tensors, leaf by
    leaf on ``a``'s device (a leaf of ``b`` is copied there)."""
    from repro_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    same, diff = len(la) == len(lb), 0.0
    for x, y in zip(la, lb):
        x = _full(x)
        y = y.to(x.device)
        if not _equal(x, y):
            same = False
            diff = max(diff, float((x.float() - y.float()).abs().max()))
    return same, diff


def _equal(x, y):
    """Equal shapes, dtypes and bits."""
    import torch

    return (x.shape == y.shape and x.dtype == y.dtype
            and bool(torch.equal(x, y)))


def _mesh_train(tc, policies, device, mesh):
    """(a): ``build_cell`` train steps at ``tc``'s cut, without a mesh and
    on ``mesh`` under each policy, from the same seed: each step's loss
    and updated parameters against the mesh-less step's, and whether the
    parameters kept the rules' placements."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import tree_leaves, tree_map

    out = {}
    shape = ShapeConfig("mesh_train", "train", tc["seq"], tc["batch"])
    with _depth_cut(tc["arch"], tc["layers"]) as arch:
        cfg = get_arch(arch)
        cell = build_cell(cfg, shape, num_microbatches=tc["chunks"])
        t = time.perf_counter()
        params, opt, m = cell.fn(*cell.materialize(device, SEED))
        del opt
        ref_loss = float(m["loss"])
        out["mesh_less"] = {"loss": ref_loss,
                            "step_s": time.perf_counter() - t,
                            **_stage_peak(device)}
        # the updated parameters wait on the host (the card holds one
        # training state at a time)
        params = tree_map(lambda x: x.cpu(), params)
        del cell, m
        for policy in policies:
            if device == "cuda":
                _free_cuda()
            t = time.perf_counter()
            cell = build_cell(cfg, shape, mesh, policy=policy,
                              num_microbatches=tc["chunks"])
            args = cell.materialize(device, SEED)
            want = [a.placements for a in tree_leaves(args[0])]
            p2, opt, m2 = cell.fn(*args)
            del args, opt
            loss = float(_full(m2["loss"]))
            step_s = time.perf_counter() - t
            peak = _stage_peak(device)
            placed = want == [a.placements for a in tree_leaves(p2)]
            same, diff = _max_diff(p2, params)
            out[policy] = {
                "loss": loss, "loss_mesh_less": ref_loss,
                "loss_equal": loss == ref_loss, "params_equal": same,
                "params_max_abs_diff": diff, "placements_kept": placed,
                "step_s": step_s, **peak}
            del cell, p2, m2
    return out


def _stage_peak(device) -> dict:
    """The card's peak since the last call, in GB (reset after)."""
    import torch

    if device != "cuda":
        return {}
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    return {"peak_gb": peak}


def _greedy(prefill, decode, params, tokens, n, lay_token=None):
    """Greedy decoding: the prefill's next token, then ``n`` decode steps
    (each writes its token's k/v and gives the next).  Returns the
    (B, n + 1) tokens."""
    import torch

    logits, caches = prefill(params, {"tokens": tokens})
    pos = tokens.shape[1]
    out = [_full(logits).argmax(-1)]
    for i in range(n):
        tok = out[-1] if lay_token is None else lay_token(out[-1])
        logits, caches = decode(params, tok,
                                torch.tensor(pos + i, dtype=torch.int32,
                                             device=out[-1].device), caches)
        out.append(_full(logits).argmax(-1))
    return torch.stack(out, dim=1)


def _mesh_snapshot(sc, device, root):
    """(b)'s snapshot, begun before (a): the parameters of ``sc``'s cut of
    yi-9b from ``SEED``, copied to the host, saved as a format-v2
    snapshot under ``root`` (with its digests) and loaded back on a
    thread of its own, whose I/O overlaps (a), (b)'s mesh-less run and
    (c).  The load skips re-hashing the files: (b) holds what it
    restores to the saved tree itself, bit for bit.  Returns (the cut's
    config, the thread, the record the thread fills: ``host`` (the saved
    tree), ``save`` (the saver's stats), ``snapshot`` (the loaded one),
    ``save_load_s``)."""
    from repro_torch.ckpt import load_snapshot, save_snapshot
    from repro_torch.configs import get_arch
    from repro_torch.core.state import GuestState, TaskSnapshot
    from repro_torch.models.model_zoo import build_model
    from repro_torch.tree import tree_map

    with _depth_cut(sc["arch"] or PATHS[sc["key"]][0], sc["layers"]) as arch:
        cfg = get_arch(arch)
    rec = {"host": tree_map(lambda x: x.cpu(),
                            build_model(cfg).init(SEED, device=device))}
    snap_dir = str(Path(root) / "mesh-snapshot")

    def save_then_load():
        t = time.perf_counter()
        rec["save"] = save_snapshot(snap_dir, TaskSnapshot(
            task_id="mesh", guest_state=GuestState(),
            buffers={"params": rec["host"]}, versions={"params": 1}))
        rec["snapshot"], _ = load_snapshot(snap_dir, verify=False)
        rec["save_load_s"] = time.perf_counter() - t

    return cfg, _Background(save_then_load), rec


class _Background:
    """``fn()`` on a thread of its own; ``wait()`` joins it and re-raises
    what it raised."""

    def __init__(self, fn):
        import threading

        self.error = None

        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - re-raised in wait
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def wait(self):
        self.thread.join()
        if self.error is not None:
            raise self.error


def _mesh_cells(sc, cfg, mesh=None, policy=None):
    """(b)'s prefill and decode cells (K2 and K1), on ``mesh`` if given."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import build_cell

    kw = dict(prefill_impl="kernel", decode_impl="kernel")
    if mesh is not None:
        kw.update(policy=policy)
    return {k: build_cell(cfg, ShapeConfig(f"mesh_{k}", k, sc["prompt"],
                                           sc["batch"]), mesh, **kw)
            for k in ("prefill", "decode")}


def _mesh_prompt(sc, cfg, device):
    import torch

    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    return torch.randint(0, cfg.vocab_size, (sc["batch"], sc["prompt"]),
                         generator=gen, dtype=torch.int32).to(device)


def _mesh_serve_plain(sc, device, snapshot):
    """(b)'s reference: greedy decoding through the mesh-less cells on
    the parameters the snapshot holds, while its I/O runs.  Returns (the
    tokens, their launches)."""
    import torch

    from repro_torch.tree import tree_map

    cfg, _, saved = snapshot
    plain = tree_map(lambda x: x.to(device), saved["host"])
    cells = _mesh_cells(sc, cfg)
    with torch.no_grad():
        _zero_counts()
        want = _greedy(cells["prefill"].fn, cells["decode"].fn, plain,
                       _mesh_prompt(sc, cfg, device), sc["tokens"])
        launches = _counts()
    del plain, cells
    return want, launches


def _mesh_serve(sc, policy, device, mesh, snapshot, reference):
    """(b): the format-v2 snapshot of ``_mesh_snapshot``, once loaded,
    restored onto ``mesh`` through ``reshard_snapshot_buffers`` (every
    ``full_tensor()`` equal to the saved tree), then greedy decoding
    through the prefill and decode cells on the mesh (K2 and K1 on each
    rank's local shards) against ``reference``, the mesh-less cells' run
    on the same parameters (``_mesh_serve_plain``)."""
    import torch

    from repro_torch.ckpt import reshard_snapshot_buffers
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import _laid_out

    path_arch = PATHS[sc["key"]][0]
    cfg, job, saved = snapshot
    want, rec = reference[0], {"launches_mesh_less": reference[1]}
    cells = _mesh_cells(sc, cfg, mesh, policy)
    t = time.perf_counter()
    job.wait()
    snap = saved.pop("snapshot")
    rec["snapshot"] = {"bytes": saved["save"]["written_bytes"],
                       "save_s": saved["save"]["seconds"],
                       "save_load_s": saved["save_load_s"],
                       "wait_s": time.perf_counter() - t}
    t = time.perf_counter()
    on_mesh = reshard_snapshot_buffers(cfg, snap.buffers, mesh,
                                       policy)["params"]
    rec["restore_s"] = time.perf_counter() - t
    del snap
    rec["restored_equal"] = _max_diff(on_mesh, saved.pop("host"))[0]
    tok_sh = cells["decode"].in_placements[1]
    batch = _laid_out({"tokens": _mesh_prompt(sc, cfg, device)},
                      cells["prefill"].in_placements[1])
    with torch.no_grad():
        _zero_counts()
        t = time.perf_counter()
        got = _greedy(cells["prefill"].fn, cells["decode"].fn, on_mesh,
                      batch["tokens"], sc["tokens"],
                      lay_token=lambda x: _laid_out(x, tok_sh))
        rec["launches"] = _counts()
        rec["serve_s"] = time.perf_counter() - t
    rec.update(arch=cfg.name, layers=cfg.num_layers,
               layers_of=get_arch(path_arch).num_layers, policy=policy,
               batch=sc["batch"], prompt=sc["prompt"],
               new_tokens=sc["tokens"],
               tokens_equal=_equal(got.cpu(), want.cpu()),
               last_tokens=got[:, -1].tolist(), **_stage_peak(device))
    del on_mesh, cells
    return rec


def _mesh_moe(mc, device, mesh):
    """(c): one full-width MoE block's ``moe_fwd`` (deepseek-moe-16b's 64
    routed experts top-6 and 2 shared; random weights from ``SEED``) on
    ``mesh`` under the "local" dispatch (an all-reduce over "model") and
    "a2a" (two all-to-alls), each against the mesh-less dispatch on the
    same routing (``_routing_pin``): output and aux loss to the bit."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import _laid_out
    from repro_torch.models.moe import init_moe, moe_fwd
    from repro_torch.sharding.rules import NamedSharding, P, ShardingRules

    base = get_arch(mc["arch"])
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = init_moe(base, dev, gen)
    x = torch.randn((mc["batch"], mc["seq"], base.d_model), generator=gen,
                    device=dev).to(p["w_up"].dtype)
    store, out = {}, {}
    with torch.no_grad():
        capture = _routing_pin(store)
        with capture("ref_kernel"):
            ref, ref_aux = moe_fwd(base, p, x)
        for dispatch in ("local", "a2a"):
            cfg = dataclasses.replace(base, moe_dispatch=dispatch)
            rules = ShardingRules(cfg, mesh, "fsdp_tp")
            p_m = _laid_out(p, rules.param_shardings(p))
            x_m = _laid_out(x, NamedSharding(mesh, P(rules.batch_axes)))
            store[f"{dispatch}_kernel"] = store["ref_kernel"]
            t = time.perf_counter()
            with capture(f"{dispatch}_naive"):
                got, aux = moe_fwd(cfg, p_m, x_m, mesh=mesh,
                                   dp_axes=rules.batch_axes,
                                   dispatch=dispatch)
            got, aux = _full(got), _full(aux)
            out[dispatch] = {
                "out_equal": _equal(got, ref),
                "aux_equal": _equal(aux, ref_aux),
                "out_max_abs_diff": float((got.float() - ref.float())
                                          .abs().max()),
                "aux": float(aux), "aux_mesh_less": float(ref_aux),
                "s": time.perf_counter() - t}
    out.update(arch=base.name, rows=mc["batch"] * mc["seq"],
               experts=base.moe.num_experts, top_k=base.moe.top_k,
               **_stage_peak(device))
    return out


def phase_mesh(state, device="cuda", cut=None):
    """The multi-device layer on a one-rank mesh of the card: a process
    group of one rank (NCCL, a ``HashStore``: no network) and a (1, 1)
    ``("data", "model")`` ``DeviceMesh``, destroyed at the phase's end.
    (a) ``build_cell`` train steps at the train phase's cut (yi-9b at 8 of
    48 layers, seq 1024, batch 8 in 2 microbatches) on the mesh under
    "tp", "fsdp_tp" and "fsdp": each step's loss and updated parameters
    equal to the mesh-less step's, to the bit, and the parameters in the
    rules' placements after it; (b) a format-v2 snapshot of yi-9b at 12
    of 48 layers (the cri cut) restored onto the mesh by
    ``reshard_snapshot_buffers`` (every ``full_tensor()`` equal to the
    snapshot), then the prefill and decode cells on the mesh (batch 8,
    prompt 512, 32 greedy tokens; K2 and K1 inside ``shard_map`` on the
    local shards): tokens equal to the mesh-less cells', K2 12 per
    prefill and K1 12 per decode step exactly (``PATHS["mesh"]``); (c)
    one full-width deepseek-moe-16b block's ``moe_fwd`` on the mesh under
    "local" and "a2a" (NCCL's all-reduce and all-to-all at one rank)
    equal to the mesh-less dispatch to the bit on pinned routing.  The
    snapshot is saved and loaded on a thread of its own while (a), (b)'s
    mesh-less run and (c) run.  The phase holds under ``max_phase_s`` and
    ``max_peak_gb``.  ``cut``
    overrides ``MESH`` (``train``, ``serve`` and ``moe`` merge into
    theirs; an ``arch`` in ``serve`` replaces the path's: a rehearsal on
    the CPU at smoke size, where launches, peaks and the budget are not
    checked)."""
    import shutil
    import tempfile

    import torch

    cut = dict(cut or {})
    mc = dict(MESH, **{k: v for k, v in cut.items()
                       if k not in ("train", "serve", "moe")})
    tc, sc, moc = (dict(MESH[k], **cut.get(k, {}))
                   for k in ("train", "serve", "moe"))
    t_phase = time.perf_counter()
    if device == "cuda":
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
    out = {}
    root = tempfile.mkdtemp(prefix="funky-mesh-")
    try:
        with _one_rank_mesh(device) as mesh:
            snapshot = _mesh_snapshot(sc, device, root)
            if device == "cuda":
                _free_cuda()
            out["a"] = _mesh_train(tc, mc["policies"], device, mesh)
            log(phase="mesh", run="a", card=state.get("card"), **out["a"])
            if device == "cuda":
                _free_cuda()
            # (b)'s mesh-less reference and (c) while the snapshot's I/O
            # runs
            reference = _mesh_serve_plain(sc, device, snapshot)
            if device == "cuda":
                _free_cuda()
            out["c"] = _mesh_moe(moc, device, mesh)
            log(phase="mesh", run="c", card=state.get("card"), **out["c"])
            if device == "cuda":
                _free_cuda()
            out["b"] = _mesh_serve(sc, "tp", device, mesh, snapshot,
                                   reference)
            del snapshot, reference
            log(phase="mesh", run="b", card=state.get("card"), **out["b"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    stats = {"phase_s": time.perf_counter() - t_phase}
    if device == "cuda":
        # each stage logs its own peak and resets the count
        stats["peak_gb"] = max([r["peak_gb"] for r in out["a"].values()]
                               + [out["b"]["peak_gb"], out["c"]["peak_gb"]])
        _free_cuda()
    log(phase="mesh", card=state.get("card"), summary=stats)
    state["mesh"] = {**out, **stats}
    state.setdefault("launches", {})["mesh"] = out["b"]["launches"]

    bad = [f"(a) {p}: {out['a'][p]}" for p in mc["policies"]
           if not (out["a"][p]["loss_equal"] and out["a"][p]["params_equal"]
                   and out["a"][p]["placements_kept"])]
    b = out["b"]
    if not (b["restored_equal"] and b["tokens_equal"]):
        bad.append(f"(b) restored_equal {b['restored_equal']}, "
                   f"tokens_equal {b['tokens_equal']}")
    bad += [f"(c) {d}: {out['c'][d]}" for d in ("local", "a2a")
            if not (out["c"][d]["out_equal"] and out["c"][d]["aux_equal"])]
    if device == "cuda":
        _, _, per_prefill, per_token = PATHS[sc["key"]]
        full = b["layers_of"]
        expected = {k: (per_prefill.get(k, 0)
                        + sc["tokens"] * per_token.get(k, 0))
                    * b["layers"] // full for k in _counts()}
        if b["launches"] != expected:
            bad.append(f"(b) launches {b['launches']}, expected {expected}")
        if stats["peak_gb"] > mc["max_peak_gb"]:
            bad.append(f"peak {stats['peak_gb']:.2f} GB, over "
                       f"{mc['max_peak_gb']} GB")
        if stats["phase_s"] > mc["max_phase_s"]:
            bad.append(f"the phase took {stats['phase_s']:.1f} s, over "
                       f"{mc['max_phase_s']} s")
    if bad:
        raise AssertionError("mesh: " + "; ".join(bad))


# ---------------------------------------------------------------------------
# 26. the ported examples and tools, driven through their own entry points
# ---------------------------------------------------------------------------

# The examples of ``examples_torch/`` and the tools ``tools/*_torch.py``
# at the full width of the reference's archs, cut in depth only; state at
# 14 bytes a parameter (bf16 weights, f32 grad_acc, two f32 AdamW
# moments).  (a) quickstart's image on yi-9b at 2 of 48 layers (0.870 B
# parameters, ~12.2 GB) in a 16 GiB slice, at ``OptConfig``'s default peak
# learning rate, 3e-4 (the reference's 3e-3 is set for its smoke width
# of 64: at d_model 4096 it took the loss from 11.60 to 13.66 over the
# 100 steps on an H100 80GB HBM3 at 700 W); (b) preemptive_cluster's batch
# jobs on yi-9b at 1 of 48 (0.697 B, ~9.8 GB each) and its prod job on
# qwen3-8b at 1 of 36 (1.438 B, ~20 GB: its 151936-token vocabulary) in
# 24 GiB slices; (c) checkpoint_restore on mamba2-1.3b at 4 of 48 (0.206 B,
# ~2.9 GB; yi-9b's embedding and head alone would move 7.3 GB through the
# snapshot's disk at ~0.3 GB/s a way); (d) elastic_serving on yi-9b at 2 of
# 48 (1.74 GB of bf16 weights a replica), its base rate scaled so the
# burst keeps the reference's ratio to one replica's capacity
# (``REQUEST_RATE`` x R1 / ``REFERENCE_REPLICA_RATE``, R1 one 2-slot
# replica's closed-loop rate over ``rate_s``; ``request_rate`` replaces
# the scaled rate in a rehearsal on a loaded CPU), and ``sample`` of its
# requests, drawn by ``seed``, served again on one engine alone; (e) the
# two smoke tools at their own sizes; (f) ``trace_dump_torch --check`` on
# the features phase's Chrome trace.
EXAMPLES = dict(
    quickstart=dict(arch="yi-9b", layers=2, mem_cap=16 << 30, steps=None,
                    peak_lr=3e-4),
    preemptive=dict(batch_arch="yi-9b", batch_layers=1, prod_arch="qwen3-8b",
                    prod_layers=1, mem_cap=24 << 30),
    checkpoint=dict(arch="mamba2-1.3b", layers=4, mem_cap=8 << 30),
    elastic=dict(arch="yi-9b", layers=2, mem_cap=8 << 30, rate_s=3.0,
                 request_rate=None, duration_s=None, sample=16, seed=43),
    smoke_all=dict(names=None),
    max_phase_s=150.0, max_peak_gb=45.0)


def _script(rel):
    """A script of the checkout (``examples_torch/*.py``, ``tools/*.py``)
    loaded as a module of its own."""
    import importlib.util

    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        f"_chip_smoke_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_expected(cfg):
    """Launches of ``smoke_all_torch.run_arch``'s prefill and decode step
    (its loss and gradient run the plain paths): K2 once an attention
    layer (the encoder-decoder: encoder, decoder self and cross), K1 once
    an attention layer per decode step (self and cross), K3 once a Mamba2
    layer, K4 once an RG-LRU layer; MLA none."""
    from repro_torch.models.transformer import plan_segments

    want = dict.fromkeys(("K1", "K1p", "K2", "K3", "K4"), 0)
    if cfg.family == "encdec":
        want.update(K2=cfg.encoder_layers + 2 * cfg.num_layers,
                    K1=2 * cfg.num_layers)
        return want
    mix = collections.Counter()
    for s in plan_segments(cfg):
        for b in s.blocks:
            mix[b.mixer] += s.count
    want.update(K1=mix["attn"], K2=mix["attn"], K3=mix["ssm"],
                K4=mix["rec"])
    return want


def _example_run(runs, name, device, fn, expect=None):
    """``fn()`` with the launch counts set to 0 just before and read just
    after, its seconds and (on the card) its peak; ``expect(out)`` gives
    the exact launches the run must show on the card (default: none, as
    training launches no kernel)."""
    import torch

    if device == "cuda":
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _counts().items() if k != "K1p_b1"}
    run = {"s": wall, "launches": launches}
    if device == "cuda":
        run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        _free_cuda()
    want = (expect(out) if expect is not None
            else dict.fromkeys(launches, 0))
    if device == "cuda" and launches != want:
        raise AssertionError(f"examples ({name}): launches {launches}, "
                             f"expected {want}")
    runs[name] = run
    return out


def _served_trace_doc(device):
    """The Chrome trace of two requests served on yi-9b-smoke through a
    router, an engine and a monitor sharing one tracer."""
    import numpy as np

    from repro_torch.core import FunkyCL, Monitor, SliceAllocator
    from repro_torch.obs import Tracer
    from repro_torch.scaling.metrics import MetricsRegistry
    from repro_torch.scaling.serving import RequestRouter
    from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                          ServeRequest)

    tracer = Tracer(capacity=256)
    mon = Monitor("trace-doc", SliceAllocator("node0", 1, device=device),
                  telemetry=MetricsRegistry(), tracer=tracer)
    eng = ContinuousBatchingEngine("yi-9b-smoke", FunkyCL(mon), slots=2,
                                   prompt_len=8, page_size=4,
                                   max_new_tokens=3, engine_id="trace-doc")
    eng.setup()
    router = RequestRouter("trace-doc", registry=eng.registry,
                           kv_aware=False, tracer=tracer)
    try:
        for i in range(2):
            router.submit(ServeRequest(rid=f"r{i}", prompt=np.arange(8) + i,
                                       max_new_tokens=3))
        while router.outstanding() or not eng.idle:
            eng.pump(router)
    finally:
        mon.vfpga_exit()
    return tracer.chrome_trace()


def phase_examples(state, device="cuda", cut=None):
    """The ported examples and tools through their own ``main``s, at the
    full width of the reference's archs cut in depth (``EXAMPLES``): (a)
    quickstart to DONE at its last step, the final loss finite and under
    the first step's (a one-step run of the same image; the image at the
    phase's ``peak_lr``); (b)
    preemptive_cluster: an eviction, every job done, the evicted batch
    job at its last step; (c) checkpoint_restore: the recovered job DONE
    at its last step with the final parameters of an uninterrupted run,
    bit for bit; (d) elastic_serving at the scaled rate: every request
    once, drained back to one replica, K2 = L x admissions and K1 paged =
    L x decode steps over every replica, and ``sample`` requests' tokens
    equal to one engine's alone; (e) cluster_smoke_torch to ``CLUSTER
    SMOKE OK`` (K2 and K1 of its serve image exactly) and smoke_all_torch
    with every arch OK and exact launches by arch; (f)
    ``trace_dump_torch.check`` on the features phase's Chrome trace (of a
    short traced run where that phase did not run): exit 0, an
    ``execute.device`` span of non-zero duration.  No other launch
    anywhere (training runs no kernel).  The phase holds under
    ``max_phase_s`` and ``max_peak_gb``.  ``cut`` merges into
    ``EXAMPLES`` by example (a rehearsal on the CPU at smoke size, where
    ``layers`` None keeps the arch; launches, peaks and the budget are
    checked on the card only)."""
    import dataclasses
    import math
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_arch, reduced, registry

    cut = dict(cut or {})
    ec = {k: (dict(v, **cut.get(k, {})) if isinstance(v, dict) else
              cut.get(k, v)) for k, v in EXAMPLES.items()}
    t_phase = time.perf_counter()
    runs, out = {}, {}
    root = tempfile.mkdtemp(prefix="funky-examples-")
    names = []

    def cut_arch(arch, layers):
        base = get_arch(arch)
        if layers is None or base.num_layers <= layers:
            return arch
        return _train_cut(base, layers, names).name

    try:
        # (a) quickstart
        qs = _script("examples_torch/quickstart.py")
        qc = ec["quickstart"]
        arch = cut_arch(qc["arch"], qc["layers"])
        image = dataclasses.replace(qs.IMAGE, opt=dataclasses.replace(
            qs.IMAGE.opt, peak_lr=qc["peak_lr"]))
        kw = dict(image=image, arch=arch, mem_cap_bytes=qc["mem_cap"],
                  device=device, ckpt_root=root)
        first = _example_run(runs, "quickstart_first_step", device,
                             lambda: qs.main(total_steps=1, **kw))
        a = _example_run(runs, "quickstart", device,
                         lambda: qs.main(total_steps=qc["steps"], **kw))
        a["first_step_loss"] = first["final_loss"]
        out["a_quickstart"] = a
        log(phase="examples", run="a_quickstart", card=state.get("card"),
            **a, **runs["quickstart"])
        if not (a["status"] == "done" and a["step"] == a["total_steps"]
                and math.isfinite(a["final_loss"])
                and a["final_loss"] < first["final_loss"]):
            raise AssertionError(f"examples (a): {a}")

        # (b) preemptive_cluster
        pc = ec["preemptive"]
        pm = _script("examples_torch/preemptive_cluster.py")
        b = _example_run(runs, "preemptive_cluster", device, lambda: pm.main(
            batch_arch=cut_arch(pc["batch_arch"], pc["batch_layers"]),
            prod_arch=cut_arch(pc["prod_arch"], pc["prod_layers"]),
            mem_cap_bytes=pc["mem_cap"], device=device, ckpt_root=root))
        out["b_preemptive_cluster"] = b
        log(phase="examples", run="b_preemptive_cluster",
            card=state.get("card"), **b, **runs["preemptive_cluster"])
        evicted = b["jobs"][b["evicted"][0]] if b["evicted"] else None
        if not (b["evicted"] and all(j["status"] == "done"
                                     for j in b["jobs"].values())
                and evicted["step"] == pm.IMAGES["batch-job"].total_steps):
            raise AssertionError(f"examples (b): {b}")

        # (c) checkpoint_restore against one uninterrupted run
        cc = ec["checkpoint"]
        cr = _script("examples_torch/checkpoint_restore.py")
        ckw = dict(arch=cut_arch(cc["arch"], cc["layers"]),
                   mem_cap_bytes=cc["mem_cap"], device=device,
                   ckpt_root=root)
        want = _example_run(runs, "checkpoint_uninterrupted", device,
                            lambda: cr.uninterrupted(**ckw))
        c = _example_run(runs, "checkpoint_restore", device,
                         lambda: cr.main(**ckw))
        c["params_equal"] = _tree_equal(c.pop("final_params"), want)
        del want
        out["c_checkpoint_restore"] = c
        log(phase="examples", run="c_checkpoint_restore",
            card=state.get("card"), **c, **runs["checkpoint_restore"])
        if not (c["status"] == "done"
                and c["step"] == cr.IMAGE.total_steps
                and c["params_equal"]):
            raise AssertionError(f"examples (c): {c}")

        # (d) elastic_serving at the reference's ratio to one replica
        el = ec["elastic"]
        es = _script("examples_torch/elastic_serving.py")
        arch = cut_arch(el["arch"], el["layers"])
        ekw = dict(arch=arch, mem_cap_bytes=el["mem_cap"], device=device)
        r1 = es.replica_rate(seconds=el["rate_s"], **ekw)
        if device == "cuda":
            _free_cuda()
        rate = el["request_rate"] or (es.REQUEST_RATE * r1["requests_per_s"]
                                      / es.REFERENCE_REPLICA_RATE)
        L = _attn_layers(get_arch(arch))
        d = _example_run(
            runs, "elastic_serving", device,
            lambda: es.main(request_rate=rate, ckpt_root=root,
                            duration_s=el["duration_s"] or es.DURATION_S,
                            **ekw),
            expect=lambda o: dict(
                dict.fromkeys(("K1", "K1p", "K2", "K3", "K4"), 0),
                K1p=L * o["decode_steps"], K2=L * o["admissions"]))
        rng = np.random.default_rng(el["seed"])
        sampled = sorted(rng.choice(sorted(d["tokens"]),
                                    min(el["sample"], len(d["tokens"])),
                                    replace=False).tolist())
        alone = es.engine_alone({r: d["prompts"][r] for r in sampled},
                                {r: d["n_tokens"][r] for r in sampled},
                                **ekw)
        d["sampled"] = sampled
        d["sampled_equal"] = all(alone[r] == d["tokens"][r]
                                 for r in sampled)
        d["r1"] = r1
        for k in ("tokens", "prompts", "n_tokens"):
            d.pop(k)
        out["d_elastic_serving"] = d
        log(phase="examples", run="d_elastic_serving",
            card=state.get("card"), **d, **runs["elastic_serving"])
        if not (d["served"] == d["requests"]
                and d["replicas_after_drain"] == 1
                and d["sampled_equal"]):
            raise AssertionError(f"examples (d): served {d['served']} of "
                                 f"{d['requests']}, drained to "
                                 f"{d['replicas_after_drain']}, sampled "
                                 f"tokens equal {d['sampled_equal']}")
    finally:
        for n in names:
            registry.ARCHS.pop(n, None)
        shutil.rmtree(root, ignore_errors=True)

    # (e) the two smoke tools at their own sizes
    cs = _script("tools/cluster_smoke_torch.py")
    serve = cs.IMAGES["serve-small"]
    L = _attn_layers(get_arch(serve.arch))
    root = tempfile.mkdtemp(prefix="funky-examples-")
    try:
        e = _example_run(
            runs, "cluster_smoke", device,
            lambda: cs.main(device=device, ckpt_root=root),
            expect=lambda o: dict(
                dict.fromkeys(("K1", "K1p", "K2", "K3", "K4"), 0), K2=L,
                K1=L * serve.total_steps * serve.tokens_per_step))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["e_cluster_smoke"] = e
    sa = _script("tools/smoke_all_torch.py")
    names_e = ec["smoke_all"]["names"] or list(registry.ARCHS)
    want_e = {n: _smoke_expected(reduced(registry.ARCHS[n]))
              for n in names_e}
    s = _example_run(runs, "smoke_all", device,
                     lambda: sa.main(names_e, device=device),
                     expect=lambda o: {k: sum(w[k] for w in want_e.values())
                                       for k in ("K1", "K1p", "K2", "K3",
                                                 "K4")})
    bad = [n for n in names_e if not isinstance(s[n], dict)]
    if device == "cuda":
        bad += [n for n in names_e if isinstance(s[n], dict)
                and s[n]["launches"] != want_e[n]]
    out["e_smoke_all"] = s
    log(phase="examples", run="e_tools", card=state.get("card"),
        cluster_smoke=e, smoke_all=s, expected_by_arch=want_e,
        runs={k: runs[k] for k in ("cluster_smoke", "smoke_all")})
    if not e.get("ok") or s["fails"] or bad:
        raise AssertionError(f"examples (e): cluster_smoke {e.get('ok')}, "
                             f"smoke_all failures {s['fails']}, archs off "
                             f"their launches or failed {bad}")

    # (f) the features phase's Chrome trace through trace_dump_torch (a
    # short traced run of its own where that phase did not run)
    td = _script("tools/trace_dump_torch.py")
    source = "features (d)"
    doc = state.get("features_trace_doc")
    if doc is None:
        doc, source = _served_trace_doc(device), "yi-9b-smoke, 2 requests"
    rc = td.check(doc)
    devs = sum(1 for ev in doc["traceEvents"] if ev.get("ph") == "X"
               and ev["name"] == "execute.device" and ev.get("dur", 0) > 0)
    out["f_trace_dump"] = {"rc": rc, "execute_device_spans": devs,
                           "trace_of": source}
    log(phase="examples", run="f_trace_dump", card=state.get("card"),
        **out["f_trace_dump"])
    if rc != 0 or not devs:
        raise AssertionError(f"examples (f): trace_dump_torch --check "
                             f"returned {rc}, {devs} execute.device spans "
                             "with device time")

    launches = collections.Counter()
    for r in runs.values():
        launches.update(r["launches"])
    stats = {"phase_s": time.perf_counter() - t_phase,
             "launches": {k: launches.get(k, 0) for k in _wrappers()},
             "runs": runs}
    if device == "cuda":
        stats["peak_gb"] = max(r["peak_gb"] for r in runs.values())
    log(phase="examples", card=state.get("card"), summary=stats)
    state.setdefault("launches", {})["examples"] = stats["launches"]
    state["examples"] = {**out, **stats}
    if device == "cuda" and stats["phase_s"] > ec["max_phase_s"]:
        raise AssertionError(f"examples: the phase took "
                             f"{stats['phase_s']:.1f} s, over "
                             f"{ec['max_phase_s']} s")
    if stats.get("peak_gb", 0.0) > ec["max_peak_gb"]:
        raise AssertionError(f"examples: peak {stats['peak_gb']:.2f} GB, "
                             f"over {ec['max_peak_gb']} GB")


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
    rows[2]["launches_features"] = state["launches"]["features"]["K2"]
    rows[2]["launches_disagg"] = state["launches"]["disagg"]["K2"]
    rows[4]["launches_orch"] = state["launches"]["orch"]["K3"]
    # training runs the plain forwards under autograd: no kernel
    for row, key in zip(rows, ("K1", "K1", "K2", "K2", "K3", "K4")):
        row["launches_train"] = state["launches"]["train"][key]
    # the mesh phase's prefill and decode cells (yi-9b's shapes at 12 of
    # 48 layers on a one-rank mesh; K1 and K2 on the local shards)
    rows[0]["launches_mesh"] = state["launches"]["mesh"]["K1"]
    rows[2]["launches_mesh"] = state["launches"]["mesh"]["K2"]
    # the examples phase: elastic_serving's replicas (K2 admissions, K1
    # paged), cluster_smoke's serve image and smoke_all's ten reduced
    # archs (K1, K2, K3, K4) on the ported scripts' own entry points
    for row, key in zip(rows, ("K1", "K1", "K2", "K2", "K3", "K4")):
        row["launches_examples"] = state["launches"]["examples"][key]
    r = state["k1p"]["path"]
    rows.append({
        "name": "decode_attention_paged", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:83",
        "launches": state["launches"]["engine"]["K1p"],
        "launches_cri": state["launches"]["cri"]["K1p"],
        "launches_orch": state["launches"]["orch"]["K1p"],
        "launches_features": state["launches"]["features"]["K1p"],
        "launches_disagg": state["launches"]["disagg"]["K1p"],
        "max_abs_err": r["max_abs_err"], "ms": r["device_ms"],
        "event_ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None, "gather_dense_ms": r["gather_dense_ms"],
        "launches_train": state["launches"]["train"]["K1p"],
        "launches_examples": state["launches"]["examples"]["K1p"]})
    # the paged entry at the disagg phase's decode replica (its launches
    # counted at its shape, phase_disagg) and the features phase's call
    # patterns: the paged entry at one lane (prefill_chunk) and at verify's
    # window, the dense entry with per-lane positions (draft and reserved
    # lanes); launches are the phase's, each counted (phase_features)
    feat = state["features"]
    for key, case, name, launches in (
            ("k1p", "engine_d", "decode_attention_paged (engine_d)",
             state["engine"]["d"]["launches"]["K1p"]),
            ("k1p", "disagg_decode",
             "decode_attention_paged (disagg_decode)",
             state["disagg"]["decode_replica_k1p"]),
            ("k1p", "chunk_b1", "decode_attention_paged (chunk_b1)",
             feat["k1p_b1_launches"]),
            ("k1p", "verify_w0", "decode_attention_paged (verify_w0)",
             feat["k1p_verify_launches"]),
            ("k1", "draft", "decode_attention (per-lane, draft)",
             feat["k1_draft_launches"]),
            ("k1", "reserved", "decode_attention (per-lane, reserved)",
             feat["k1_reserved_launches"])):
        r = state[key][case]
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:83",
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["device_ms"], "event_ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_device_ms"),
            **({"gather_dense_ms": r["gather_dense_ms"]}
               if "gather_dense_ms" in r else {})})
    # the dense_archs and moe phases' shapes (bf16): K2 and K1 dense with
    # their served path's launches, K1 paged with its engine runs' (K2's
    # engine launches beside); stablelm-3b at hd 80, starcoder2-15b at
    # group 12, qwen3-8b at 32/8, deepseek-moe-16b at 16/16 (hd 128)
    for phase, key, case in (("dense_archs", "stablelm", "hd80_path"),
                             ("dense_archs", "starcoder2", "g12_path"),
                             ("dense_archs", "qwen3", "qwen3_path"),
                             ("moe", "deepseek_moe", "mha128_path")):
        eng = collections.Counter()
        for run in state[phase][key]["engine"].values():
            eng.update(run["launches"])
        for kkey, name, kfile, line, launches, extra in (
                ("k2", "flash_attention", "flash_attention", 95,
                 state["launches"][key]["K2"], {"launches_engine": eng["K2"]}),
                ("k1", "decode_attention", "decode_attention", 83,
                 state["launches"][key]["K1"], {}),
                ("k1p", "decode_attention_paged", "decode_attention", 83,
                 eng["K1p"], {})):
            r = state[kkey][case]
            rows.append({
                "name": f"{name} ({PATHS[key][0]}: {case})", "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{kfile}.cu",
                "replaces": f"src/repro/kernels/{kfile}/kernel.py:{line}",
                "launches": launches, **extra,
                "max_abs_err": r["max_abs_err"], "ms": r["device_ms"],
                "event_ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r.get("library_device_ms"),
                **({"library_gathered_ms": r["library_gathered_device_ms"]}
                   if "library_gathered_device_ms" in r else {})})
    # the launch phase's served run (launch.serve.main) is qwen3-8b's path
    # at 18 of its 36 layers: K2 and K1 at the qwen3 rows' shapes
    for row in rows:
        if row["name"] in ("flash_attention (qwen3-8b: qwen3_path)",
                           "decode_attention (qwen3-8b: qwen3_path)"):
            row["launches_launch"] = state["launches"]["launch"][
                "K2" if row["name"].startswith("flash") else "K1"]
    # the families phase's shapes (bf16), each with its launches on the
    # served run, counted by shape: seamless-m4t-large-v2's K2 over the
    # encoder, the decoder's prefill and the cross attention, and K1 over
    # the self ring and the cross cache; llava-next-mistral-7b's K2 and K1
    for key, kkey, case in (("seamless", "k2", "enc"),
                            ("seamless", "k2", "dec_prefill"),
                            ("seamless", "k2", "cross"),
                            ("seamless", "k1", "seamless_self"),
                            ("seamless", "k1", "cross"),
                            ("llava", "k2", "llava"),
                            ("llava", "k1", "llava")):
        kfile, line = (("flash_attention", 95) if kkey == "k2"
                       else ("decode_attention", 83))
        r = state[kkey][case]
        served = state["families"][key]["served"]
        rows.append({
            "name": f"{kfile} ({PATHS[key][0]}: {case})", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kfile}.cu",
            "replaces": f"src/repro/kernels/{kfile}/kernel.py:{line}",
            "launches": served["launches_by_case"][kkey.upper()][case],
            "max_abs_err": r["max_abs_err"], "ms": r["device_ms"],
            "event_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_device_ms")})
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
