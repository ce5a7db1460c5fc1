"""Continuous-batching serving engine (vLLM/Orca-style iteration-level
scheduling on top of the Funky monitor) over **paged** device memory: the
reference's ``serve/engine.py``, its paged, non-speculative, ``mixed``
path.

The engine owns ``slots`` decode lanes.  Each lane is an independent
sequence with its own position; one *iteration* advances every occupied
lane through one EXECUTE.  Between iterations the engine retires finished
sequences and backfills freed lanes with prefills of waiting requests, so
a long request never stalls the batch behind it.

KV memory is a ``BlockPool`` of fixed-size pages shared by every lane
(``serve/kvcache.py``).  A per-lane *block table* row maps logical page ->
physical page; the decode program (``lm_decode_paged``, K1's paged entry)
reads each lane's pages in place through its row and writes the new token
into its page.  Lanes hold pages at token granularity: prompt pages at
admission, one more page whenever decode crosses a page boundary, all
freed when the request retires.  Admission is memory-based (admit while
``free_pages - prompt_pages >= reserve_pages``).  If the pool runs dry
mid-decode the youngest lane is OOM-preempted: its pages are freed and its
request requeued for recomputation (greedy decode: the client sees the
same tokens).  Reallocated pages are scrubbed (positions invalidated), so
a new owner never attends to a previous lane's tokens.  Prompts route to
the smallest of a few compiled *prompt buckets* that fits.  The pool
auto-defragments at iteration boundaries when fragmentation crosses
``auto_compact_frag``.

``fuse_steps > 1`` runs that many greedy steps per EXECUTE (``decode_multi``)
and ``async_depth > 0`` submits iteration N+1's EXECUTE before iteration
N's tokens are read back; token counts are known at submit time, so
positions and pages advance there and only token values arrive at commit.

Every device interaction is a Funky request through ``Monitor.submit``, so
serving stays preemptible at token boundaries: ``Monitor.evict`` between
iterations saves the dirty pages plus the block table, and ``resume``
continues every in-flight sequence bit-exactly.  Per-request latencies
(TTFT, time between tokens, end to end) and KV occupancy gauges land in
the shared registry.

Not ported yet (each raises ``NotImplementedError``): speculative decode,
the prefix cache, roles other than ``mixed`` (and the lane handoff),
reserved (``paged=False``) mode, the staged legacy admission, and tracing.
"""

from __future__ import annotations

import heapq
import math
import os
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.guest import FunkyCL
from repro_torch.core.programs import Program
from repro_torch.scaling.autoscaler import (M_COMPLETIONS, M_KV_FREE_PAGES,
                                            M_KV_PAGES, M_PREEMPTIONS,
                                            M_QUEUE_DEPTH, M_SLO_VIOLATIONS,
                                            M_UTILIZATION)
from repro_torch.scaling.metrics import MetricsRegistry
from repro_torch.serve.kvcache import (BlockPool, apply_block_table_delta,
                                       compact_pool,
                                       init_caches_from_specs,
                                       pool_specs_from_lane_cache,
                                       scatter_prefill, scrub_pages)

# Canonical per-request serving metrics (one schema across planes).
M_TTFT = "request_ttft_seconds"
M_TBT = "request_tbt_seconds"
M_E2E = "request_latency_seconds"
M_TOKENS = "engine_tokens_total"
M_ITERS = "engine_iterations_total"
# Host-overhead attribution (per engine): device_us is the monitor-measured
# device phase, host_us everything else in the iteration loop.
M_HOST_US = "host_us_per_token"
M_DEVICE_US = "device_us_per_token"
M_QUEUE_WAIT_US = "queue_wait_us"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


@dataclass
class ServeRequest:
    """One generation request admitted into a decode slot."""
    rid: str
    prompt: np.ndarray                  # (P,) int32 token ids
    max_new_tokens: int = 8
    arrival_t: Optional[float] = None   # registry-clock timestamp
    slo_s: Optional[float] = None       # end-to-end SLO (None = untracked)
    # committed tokens: aliased to the slot's token list at admission, so
    # the router sees exactly what the engine generated
    committed: Optional[List[int]] = None


@dataclass
class CompletedRequest:
    rid: str
    tokens: List[int]
    arrival_t: float
    admit_t: float
    first_token_t: float
    finish_t: float
    tbts: List[float] = field(default_factory=list)

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.arrival_t

    @property
    def e2e_s(self) -> float:
        return self.finish_t - self.arrival_t


@dataclass
class _SlotState:
    req: ServeRequest
    slot: int
    tokens: List[int]
    admit_t: float
    first_token_t: float
    last_token_t: float
    tbts: List[float] = field(default_factory=list)
    # effective generation cap: min(request ask, engine cap)
    limit: int = 1
    bucket: int = 0                     # prompt bucket this lane prefilled
    pos: int = 0                        # absolute position of the next write
    blocks: List[int] = field(default_factory=list)
    # tokens whose generation has been *submitted* (committed or riding an
    # in-flight EXECUTE); equal to len(tokens) on the non-pipelined path
    submitted: int = 0
    # in-flight EXECUTEs referencing this lane's pages: retire (which frees
    # pages) waits until it drains back to zero
    inflight: int = 0
    # the lane hit EOS mid-span: later in-flight spans for it are no-ops
    eos_done: bool = False


class ContinuousBatchingEngine:
    def __init__(self, arch: str, cl: FunkyCL, *, slots: int = 4,
                 prompt_len: int = 16, max_new_tokens: int = 16,
                 service: str = "svc", engine_id: str = "engine0",
                 seed: int = 0, registry: Optional[MetricsRegistry] = None,
                 publish_gauges: bool = True, paged: bool = True,
                 page_size: int = 8, pool_pages: Optional[int] = None,
                 reserve_pages: int = 1,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 spec: Any = None, prefix_cache: bool = False,
                 auto_compact_frag: Optional[float] = 0.5,
                 auto_compact_min_pages: int = 4,
                 fuse_steps: int = 1, async_depth: int = 0,
                 role: str = "mixed", eos_id: Optional[int] = None,
                 tracer: Any = None):
        from repro_torch.configs import get_arch
        from repro_torch.models import build_model

        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"unknown role {role!r}")
        if role != "mixed":
            raise _not_ported(f"role {role!r} (disaggregated serving)")
        if spec is not None:
            raise _not_ported("speculative decode (spec=)")
        if prefix_cache:
            raise _not_ported("the prefix cache (prefix_cache=True)")
        if not paged:
            raise _not_ported("reserved mode (paged=False)")
        if tracer is not None:
            raise _not_ported("engine tracing (tracer=)")
        if fuse_steps < 1:
            raise ValueError("fuse_steps must be >= 1")
        if async_depth < 0:
            raise ValueError("async_depth must be >= 0")
        if prompt_buckets and prompt_len > max(prompt_buckets):
            raise ValueError(
                f"prompt_len {prompt_len} exceeds the largest prompt "
                f"bucket {max(prompt_buckets)}: prompts would be silently "
                "truncated — add prompt_len as the largest bucket")
        self.cl = cl
        self.slots = slots
        self.eos_id = eos_id
        self.max_new_tokens = max_new_tokens   # per-request cap
        self.service = service
        self.engine_id = engine_id
        self.seed = seed
        self.cfg = get_arch(arch)
        self.fuse_steps = fuse_steps
        self.async_depth = async_depth
        # pipelined mode: EXECUTEs (decode spans and admissions) commit at a
        # later boundary instead of being waited at the submit site
        self._pipelined = fuse_steps > 1 or async_depth > 0
        self.auto_compact_frag = auto_compact_frag
        self.auto_compact_min_pages = auto_compact_min_pages
        self.buckets = tuple(sorted(set(prompt_buckets or (prompt_len,))))
        self.prompt_len = max(self.buckets)
        self.page_size = page_size
        # +headroom: a fused decode's masked steps write up to fuse_steps-1
        # positions past a retiring lane's limit; they must not wrap
        max_ctx = self.prompt_len + max_new_tokens + fuse_steps - 1
        self.max_blocks = math.ceil(max_ctx / page_size)
        # default pool covers the worst case (no oversubscription)
        self.pool_pages = (pool_pages if pool_pages is not None
                           else slots * self.max_blocks)
        if self.pool_pages < self.max_blocks:
            raise ValueError(
                f"pool of {self.pool_pages} pages cannot hold one "
                f"worst-case request ({self.max_blocks} pages)")
        max_prompt_pages = math.ceil(self.prompt_len / page_size)
        if self.pool_pages - max_prompt_pages < reserve_pages:
            raise ValueError(
                f"reserve watermark {reserve_pages} can never clear for "
                f"a {max_prompt_pages}-page prompt in a "
                f"{self.pool_pages}-page pool (admission would starve)")
        self.pool = BlockPool(self.pool_pages, page_size,
                              reserve_pages=reserve_pages)
        # first-touch pages are born scrubbed (init_paged writes INVALID
        # positions pool-wide): only reused pages need the scrub EXECUTE
        self._virgin_pages: set = set()
        # paged prefill writes exactly the prompt (margin 0); decode
        # headroom comes from pages appended at token granularity
        self.bundle = build_model(self.cfg, cache_margin=0)
        self._bt_host = np.full((slots, self.max_blocks), -1, np.int32)
        # device-resident block table: _bt_host is a host mirror; steady
        # state updates ship as (slot, logical_page, phys) delta rows.
        # _bt_full forces a full h2d rewrite (compact/evacuate/failure).
        self._bt_dirty = True
        self._bt_full = True
        self._bt_delta: List[Tuple[int, int, int]] = []
        self._bt_delta_width = max(16, 4 * slots)
        self.bt_delta_execs = 0     # delta-driven device updates
        self.bt_full_writes = 0     # full-table h2d rewrites
        self._first_token: Dict[str, float] = {}
        self.registry = (registry if registry is not None
                         else cl._monitor.telemetry)
        self._clock = self.registry.clock
        self._publish_gauges = publish_gauges
        self._step_completions: List = []
        # pipelined decode: records submitted but not yet committed
        self._inflight: deque = deque()
        # set after a failed pipelined EXECUTE: device toks/pos are rewritten
        # from the host-authoritative lane state before the next submit
        self._resync_lanes = False
        # host/device attribution (from the monitor's per-request phases)
        self._attr_host_s = 0.0
        self._attr_device_s = 0.0
        self._attr_queue_wait_s = 0.0
        self._attr_tokens = 0
        self._attr_execs = 0
        # EXECUTEs and device seconds per program
        self.program_execs: Dict[str, int] = {}
        self.program_device_s: Dict[str, float] = {}
        reg = self.registry
        self._h_ttft = reg.histogram(M_TTFT, service=service)
        self._h_tbt = reg.histogram(M_TBT, service=service)
        self._h_e2e = reg.histogram(M_E2E, service=service)
        self._c_tokens = reg.counter(M_TOKENS, service=service)
        self._c_iters = reg.counter(M_ITERS, service=service)
        self._c_completions = reg.counter(M_COMPLETIONS, service=service)
        self._c_violations = reg.counter(M_SLO_VIOLATIONS, service=service)
        self._c_preemptions = reg.counter(M_PREEMPTIONS, service=service)
        if publish_gauges:
            lbl = dict(service=service, engine=engine_id)
            self._g_queue = reg.gauge(M_QUEUE_DEPTH, **lbl)
            self._g_util = reg.gauge(M_UTILIZATION, **lbl)
            self._g_kv = reg.gauge(M_KV_PAGES, **lbl)
            self._g_kv_free = reg.gauge(M_KV_FREE_PAGES, **lbl)
            self._g_host_us = reg.gauge(M_HOST_US, **lbl)
            self._g_device_us = reg.gauge(M_DEVICE_US, **lbl)
            self._g_queue_wait_us = reg.gauge(M_QUEUE_WAIT_US, **lbl)

        self.pending: deque = deque()
        self._free: List[int] = list(range(slots))
        heapq.heapify(self._free)
        self._active: Dict[int, _SlotState] = {}
        self.completed: Dict[str, CompletedRequest] = {}
        self._unreported: deque = deque()   # completions not yet drained
        self.iterations = 0
        self.peak_active = 0                # max concurrent lanes
        self.preemptions = 0
        self.auto_compactions = 0
        self._mid_step = False              # pages in flight: no compaction
        # the reference's staged admission (write + prefill + admit + read),
        # a benchmark baseline flipped before setup()
        self._legacy_admit = False
        self._setup_done = False
        self._program_ids: List[str] = []

    # ------------------------------------------------------------------
    # Program/buffer setup (Funky guest-style, via FunkyCL only)
    # ------------------------------------------------------------------
    def setup(self, restore: bool = False) -> None:
        if self._legacy_admit:
            raise _not_ported("the staged (legacy) admission")
        self._setup_paged(restore)
        self._setup_done = True

    def program_ids(self) -> tuple:
        return tuple(self._program_ids)

    def _register(self, name, fn, abstracts, inplace=()):
        self.cl.clCreateProgramWithBinary(
            Program(name, fn, inplace_argnums=inplace), abstracts,
            donate_argnums=inplace)
        self._program_ids.append(name)

    def _setup_paged(self, restore: bool) -> None:
        bundle, B, ps = self.bundle, self.slots, self.page_size
        NP, max_blocks, kf = self.pool_pages, self.max_blocks, self.fuse_steps
        cap = max_blocks * ps
        eos = self.eos_id
        dev = self.cl.device
        meta = torch.device("meta")
        i32 = torch.int32

        def empty(*shape):
            return torch.empty(shape, dtype=i32, device=meta)

        params_abs = bundle.init(0, device=meta)
        pool_abs = pool_specs_from_lane_cache(
            bundle.cache_specs(1, self.prompt_len), NP, ps, self.prompt_len)
        toks_abs, pos_abs = empty(B, 1), empty(B)
        bt_abs = empty(B, max_blocks)
        delta_abs = np.zeros((self._bt_delta_width, 3), np.int32)

        def init_params(seed):
            return bundle.init(int(seed), device=dev)

        def init_paged():
            return (torch.zeros((B, 1), dtype=i32, device=dev),
                    torch.zeros((B,), dtype=i32, device=dev),
                    init_caches_from_specs(pool_abs, dev))

        def decode_step(params, toks, pos, bt, pool):
            logits, pool = bundle.decode_paged_fn(params, toks[:, 0], pos,
                                                  pool, bt)
            toks[:, 0] = logits.argmax(-1).to(i32)
            pos += (bt[:, 0] >= 0).to(i32)
            return toks, pos, pool

        # fused multi-step decode: kf greedy steps per EXECUTE.  Per-lane
        # ``lims`` (a const arg) masks token/position updates once a lane
        # hits its limit; cache writes past the mask land at positions
        # every later query masks out (kv_pos > pos) until the lane
        # overwrites them in order, and a step whose slot would wrap the
        # lane's logical cap writes to the sink, as the reference drops it
        def decode_multi(params, toks, pos, bt, pool, lims, delta):
            apply_block_table_delta(bt, delta)
            on = bt[:, 0] >= 0
            lim = torch.as_tensor(np.asarray(lims), device=dev).clamp(0, kf)
            cur = toks[:, 0].clone()
            p0 = pos.clone()
            done = (cur == eos) if eos is not None else torch.zeros_like(on)
            adv = torch.zeros_like(p0)
            outs = torch.zeros((B, kf), dtype=i32, device=dev)
            for i in range(kf):
                logits, pool = bundle.decode_paged_fn(
                    params, cur, p0 + i, pool, bt,
                    write_ok=(p0 % cap) + i < cap)
                step_on = on & (lim > i) & ~done
                cur = torch.where(step_on, logits.argmax(-1).to(i32), cur)
                if eos is not None:
                    done = done | (step_on & (cur == eos))
                adv += step_on.to(i32)
                outs[:, i] = cur
            toks[:, 0] = cur
            pos.copy_(torch.where(on, p0 + adv, p0))
            return outs, toks, pos, bt, pool

        def bt_update(bt, delta):
            return apply_block_table_delta(bt, delta)

        def scrub(pool, page_ids):
            return scrub_pages(pool, page_ids)

        def compact(pool, src_ids, dst_ids):
            return compact_pool(pool, src_ids, dst_ids)

        self._register("init_params", init_params, (0,))
        self._register("init_paged", init_paged, ())
        # one fused k-step span can append several pages per lane
        self._scrub_width = B * ((self.fuse_steps - 1) // ps + 2)
        ids_abs = np.zeros((self._scrub_width,), np.int32)
        np_abs = np.zeros((NP,), np.int32)
        for P in self.buckets:
            n_pp = self.pool.pages_for_tokens(P)

            # one-EXECUTE admission: prefill + first-token argmax + lane
            # install + page scatter, the prompt a const arg
            def prefill_admit(params, toks, pos, pool, prompt, slot,
                              page_ids, P=P):
                prompt = torch.as_tensor(np.asarray(prompt), device=dev)
                logits, cache = bundle.prefill_fn(params, {"tokens": prompt})
                pf_tok = logits.argmax(-1).to(i32)
                slot = int(slot)
                toks[slot, 0] = pf_tok[0]
                pos[slot] = P
                scatter_prefill(pool, page_ids, cache, page_size=ps,
                                prompt_len=P)
                return pf_tok, toks, pos, pool

            self._register(
                f"prefill_admit_{P}", prefill_admit,
                (params_abs, toks_abs, pos_abs, pool_abs,
                 np.zeros((1, P), np.int32), np.int32(0),
                 np.zeros((n_pp,), np.int32)), inplace=(1, 2, 3))
        self._register("scrub", scrub, (pool_abs, ids_abs), inplace=(0,))
        self._register("compact_pool", compact, (pool_abs, np_abs, np_abs),
                       inplace=(0,))
        self._register("decode_step", decode_step,
                       (params_abs, toks_abs, pos_abs, bt_abs, pool_abs),
                       inplace=(1, 2, 4))
        self._register("bt_update", bt_update, (bt_abs, delta_abs),
                       inplace=(0,))
        if kf > 1:
            self._register("decode_multi", decode_multi,
                           (params_abs, toks_abs, pos_abs, bt_abs, pool_abs,
                            np.zeros((B,), np.int32), delta_abs),
                           inplace=(1, 2, 3, 4))
        if not restore:
            cl = self.cl
            cl.clCreateBuffer("params", params_abs)
            cl.clCreateBuffer("toks", toks_abs)
            cl.clCreateBuffer("pos", pos_abs)
            cl.clCreateBuffer("block_table", bt_abs)
            cl.clCreateBuffer("kv_pool", pool_abs, paged=True)
            cl.clCreateBuffer("pf_tok", empty(1))
            if kf > 1:
                cl.clCreateBuffer("fused_toks", empty(B, kf))
            cl.clEnqueueKernel("init_params", (), ("params",),
                               const_args=(self.seed,))
            cl.clEnqueueKernel("init_paged", (), ("toks", "pos", "kv_pool"))
            # the freshly initialized pool is all-INVALID: every page is
            # clean until its first allocation
            self._virgin_pages = set(range(self.pool_pages))
            cl.write_buffer("block_table", self._bt_host.copy())
            cl.clFinish()
            self._bt_dirty = False
            self._bt_full = False
            self._bt_delta.clear()

    # ------------------------------------------------------------------
    # Tracked device-op helpers: the step folds the monitor's per-request
    # phase dicts into the engine's host/device attribution
    # ------------------------------------------------------------------
    def _exec(self, *args, **kw):
        c = self.cl.clEnqueueKernel(*args, **kw)
        self._step_completions.append(c)
        return c

    def _write(self, buff_id, host_value):
        c = self.cl.write_buffer(buff_id, host_value)
        self._step_completions.append(c)
        return c

    def _read(self, buff_id):
        c = self.cl.clEnqueueMigrateMemObjects(buff_id, to_device=False)
        self._step_completions.append(c)
        try:
            return c.wait()
        except BaseException:
            # surfaced here: the step-boundary sweep must not raise it again
            c.error_seen = True
            raise

    def _read_async(self, buff_id):
        """d2h read whose wait is deferred to the commit site."""
        c = self.cl.clEnqueueMigrateMemObjects(buff_id, to_device=False)
        self._step_completions.append(c)
        return c

    # ------------------------------------------------------------------
    # Request intake
    # ------------------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        if req.arrival_t is None:
            req.arrival_t = self._clock()
        self.pending.append(req)

    @property
    def idle(self) -> bool:
        return not self._active and not self.pending

    @property
    def active_count(self) -> int:
        return len(self._active)

    def _pick_bucket(self, prompt_len: int) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        return self.buckets[-1]         # over-long prompts truncate

    def _pad_prompt(self, prompt: np.ndarray, bucket: int) -> np.ndarray:
        """Right-padded with token 0, which the prefill attends to."""
        p = np.asarray(prompt, np.int32).reshape(-1)[:bucket]
        if p.shape[0] < bucket:
            p = np.pad(p, (0, bucket - p.shape[0]))
        return p.reshape(1, bucket)

    # ------------------------------------------------------------------
    # One iteration: admit into free lanes, decode all occupied lanes
    # ------------------------------------------------------------------
    def _admit(self) -> int:
        admitted = 0
        while self._free and self.pending:
            req = self.pending[0]
            bucket = self._pick_bucket(
                np.asarray(req.prompt).reshape(-1).shape[0])
            n_pp = self.pool.pages_for_tokens(bucket)
            if not self.pool.can_admit(n_pp):
                break                   # memory-based admission gate
            page_ids = self.pool.alloc(n_pp)
            # the prefill scatters these pages whole: no scrub needed, but
            # they are no longer first-touch clean
            self._virgin_pages.difference_update(page_ids)
            self.pending.popleft()
            slot = heapq.heappop(self._free)
            # one-EXECUTE admission: the prompt rides as a const arg
            admit_c = self._exec(
                f"prefill_admit_{bucket}",
                ("params", "toks", "pos", "kv_pool"),
                ("pf_tok", "toks", "pos", "kv_pool"),
                const_args=(self._pad_prompt(req.prompt, bucket),
                            np.int32(slot), np.asarray(page_ids, np.int32)),
                donate=True, dirty_pages={"kv_pool": tuple(page_ids)})
            self._bt_set_row(slot, page_ids)
            read_c = first_tok = None
            if self._pipelined:
                # the first token's d2h read is deferred to the commit site
                read_c = self._read_async("pf_tok")
            else:
                first_tok = int(np.asarray(self._read("pf_tok"))[0])
            now = self._clock()
            st = _SlotState(req=req, slot=slot,
                            tokens=[] if read_c is not None else [first_tok],
                            submitted=1, admit_t=now, first_token_t=now,
                            last_token_t=now,
                            limit=max(1, min(req.max_new_tokens,
                                             self.max_new_tokens)),
                            bucket=bucket, pos=bucket, blocks=list(page_ids))
            req.committed = st.tokens
            self.registry.record_event("engine_admit", rid=req.rid,
                                       slot=slot, engine=self.engine_id)
            if read_c is not None:
                # deferred admission: the lane decodes in this step's EXECUTE
                # (its device state is set by the admit EXECUTE ahead of it
                # in the FIFO); only the first token's value waits
                self._active[slot] = st
                self._inflight.append(("admit", st, read_c, (admit_c,)))
                continue
            if self.eos_id is not None and first_tok == self.eos_id:
                st.limit = 1            # the prompt's continuation IS the stop
            st.first_token_t = self._observe_first_token(req, now)
            self._c_tokens.inc()
            admitted += 1
            if len(st.tokens) >= st.limit:
                self._retire(st, now)       # degenerate 1-token request
            else:
                self._active[slot] = st
        return admitted

    def _observe_first_token(self, req, now: float) -> float:
        """TTFT at first-token delivery; an OOM-preempted request keeps its
        original TTFT when it recomputes."""
        prior = self._first_token.get(req.rid)
        if prior is not None:
            return prior
        self._first_token[req.rid] = now
        self._h_ttft.observe(now - req.arrival_t)
        return now

    def _retire(self, st: _SlotState, now: float) -> None:
        rec = CompletedRequest(
            rid=st.req.rid, tokens=st.tokens, arrival_t=st.req.arrival_t,
            admit_t=st.admit_t, first_token_t=st.first_token_t,
            finish_t=now, tbts=st.tbts)
        self.completed[st.req.rid] = rec
        self._unreported.append(rec)
        self._active.pop(st.slot, None)
        heapq.heappush(self._free, st.slot)
        # the lane's pages return to the pool at retirement; the cleared
        # row deactivates the lane for the next decode
        self.pool.free(st.blocks)
        self._bt_clear_row(st.slot)
        self._first_token.pop(st.req.rid, None)
        self._h_e2e.observe(rec.e2e_s)
        self._c_completions.inc()
        if st.req.slo_s is not None and rec.e2e_s > st.req.slo_s:
            self._c_violations.inc()
        self.registry.record_event("engine_retire", rid=st.req.rid,
                                   slot=st.slot, tokens=len(st.tokens),
                                   engine=self.engine_id)

    # -- page lifecycle --------------------------------------------------
    def _pick_victim(self) -> _SlotState:
        """Youngest admission loses (its recomputation is cheapest); the
        oldest lane always progresses, so the engine never livelocks as
        long as the pool holds one worst-case request."""
        return max(self._active.values(), key=lambda s: (s.admit_t, s.slot))

    def _preempt(self, st: _SlotState) -> None:
        self.pool.free(st.blocks)
        self._bt_clear_row(st.slot)
        self._active.pop(st.slot)
        heapq.heappush(self._free, st.slot)
        self.pending.appendleft(st.req)     # deterministic recompute
        self.preemptions += 1
        self._c_preemptions.inc()
        self.registry.record_event("engine_oom_preempt", rid=st.req.rid,
                                   slot=st.slot, engine=self.engine_id)

    def _scrub_needed(self, ids) -> List[int]:
        """The freshly allocated pages a previous owner wrote (first-touch
        pages already read INVALID); removes ``ids`` from the virgin set."""
        need = [p for p in ids if p not in self._virgin_pages]
        self._virgin_pages.difference_update(ids)
        return need

    def _append_pages(self) -> None:
        """Token-granularity growth: map the page(s) each lane's next write
        window lands in — one page for plain decode, the k-step span for
        fused decode — preempting the youngest lane(s) when the pool runs
        dry."""
        scrub_ids: List[int] = []
        for slot in sorted(self._active):
            st = self._active.get(slot)
            if st is None:
                continue                # preempted by an earlier append
            if self._pipelined:
                span_tok = min(self.fuse_steps, st.limit - st.submitted)
                if span_tok <= 0:
                    continue    # fully submitted: awaiting pipeline commit
            else:
                span_tok = 1
            lp_last = (st.pos + span_tok - 1) // self.page_size
            dead = False
            for lp in range(len(st.blocks), lp_last + 1):
                # urgent: appends may dip into the admission reserve
                got = self.pool.alloc(1, urgent=True)
                while got is None:
                    victim = self._pick_victim()
                    self._preempt(victim)
                    if victim is st:
                        dead = True     # st preempted itself: all freed
                        break
                    got = self.pool.alloc(1, urgent=True)
                if dead:
                    break
                st.blocks.append(got[0])
                self._bt_set_cell(slot, lp, got[0])
                scrub_ids.append(got[0])
        scrub_ids = self._scrub_needed(scrub_ids)
        if scrub_ids:
            assert len(scrub_ids) <= self._scrub_width
            ids = np.full((self._scrub_width,), self.pool_pages, np.int32)
            ids[:len(scrub_ids)] = scrub_ids
            self._exec("scrub", ("kv_pool",), ("kv_pool",),
                       const_args=(ids,), donate=True,
                       dirty_pages={"kv_pool": tuple(scrub_ids)})

    def compact(self) -> dict:
        """Defragment the pool: pack used pages into the lowest physical
        ids.  Call between iterations only."""
        if self._mid_step:
            raise RuntimeError(
                "compact() while pages are in flight: an iteration's "
                "EXECUTEs reference physical page ids — compaction is only "
                "legal between engine iterations")
        if self._inflight:
            # pipelined EXECUTEs were submitted against the old page ids
            self._drain_pipeline()
        mapping = self.pool.compact()
        if mapping:
            self._virgin_pages.difference_update(mapping.values())
            src = np.full((self.pool_pages,), self.pool_pages, np.int32)
            dst = np.full((self.pool_pages,), self.pool_pages, np.int32)
            src[:len(mapping)] = list(mapping.keys())
            dst[:len(mapping)] = list(mapping.values())
            self._exec("compact_pool", ("kv_pool",), ("kv_pool",),
                       const_args=(src, dst), donate=True,
                       dirty_pages={"kv_pool": tuple(mapping.values())})
            for st in self._active.values():
                st.blocks = [mapping.get(p, p) for p in st.blocks]
                self._bt_host[st.slot, :len(st.blocks)] = st.blocks
            self._bt_mark_full()
        return {"moved": len(mapping), "span": self.pool.used_span()}

    def _should_auto_compact(self) -> bool:
        if self.auto_compact_frag is None:
            return False
        used, span = self.pool.used_count(), self.pool.used_span()
        if used == 0 or span - used < self.auto_compact_min_pages:
            return False
        return 1.0 - used / span >= self.auto_compact_frag

    def _maybe_auto_compact(self) -> None:
        """Threshold-triggered defragmentation at the top of an iteration,
        the only point where no EXECUTE holds page ids."""
        if not self._should_auto_compact():
            return
        used, span = self.pool.used_count(), self.pool.used_span()
        self.compact()
        self.auto_compactions += 1
        self.registry.record_event("engine_auto_compact",
                                   engine=self.engine_id, used=used,
                                   span_before=span)

    # -- device-resident block table -------------------------------------
    def _bt_set_row(self, slot: int, page_ids) -> None:
        self._bt_host[slot, :] = -1
        self._bt_host[slot, :len(page_ids)] = page_ids
        self._bt_delta.append((slot, -1, -1))
        self._bt_delta.extend(
            (slot, lp, int(p)) for lp, p in enumerate(page_ids))
        self._bt_dirty = True

    def _bt_clear_row(self, slot: int) -> None:
        self._bt_host[slot, :] = -1
        self._bt_delta.append((slot, -1, -1))
        self._bt_dirty = True

    def _bt_set_cell(self, slot: int, lp: int, phys: int) -> None:
        self._bt_host[slot, lp] = phys
        self._bt_delta.append((slot, lp, int(phys)))
        self._bt_dirty = True

    def _bt_mark_full(self) -> None:
        """Bulk rewrites (compact/evacuate/failure) skip the delta path."""
        self._bt_full = True
        self._bt_delta.clear()
        self._bt_dirty = True

    def _bt_take_delta(self) -> np.ndarray:
        """Claim pending block-table rows for the fused decode EXECUTE to
        apply itself.  Forced rewrites and overflowing deltas still take
        the full h2d write here; the delta is then all padding."""
        if self._bt_dirty and (self._bt_full or
                               len(self._bt_delta) > self._bt_delta_width):
            self._flush_block_table()
        delta = np.full((self._bt_delta_width, 3), -1, np.int32)
        if self._bt_delta:
            delta[:len(self._bt_delta)] = self._bt_delta
            self._bt_delta.clear()
            self.bt_delta_execs += 1
        self._bt_dirty = False
        self._bt_full = False
        return delta

    def _flush_block_table(self) -> None:
        """Ship pending block-table changes: a small bt_update EXECUTE in
        the steady state, a full h2d rewrite when forced (or when the
        delta outgrew its fixed width)."""
        if not self._bt_dirty:
            return
        if self._bt_full or len(self._bt_delta) > self._bt_delta_width:
            self._write("block_table", self._bt_host.copy())
            self.bt_full_writes += 1
        else:
            delta = np.full((self._bt_delta_width, 3), -1, np.int32)
            if self._bt_delta:
                delta[:len(self._bt_delta)] = self._bt_delta
            self._exec("bt_update", ("block_table",), ("block_table",),
                       const_args=(delta,), donate=True)
            self.bt_delta_execs += 1
        self._bt_full = False
        self._bt_delta.clear()
        self._bt_dirty = False

    def _commit_tokens(self, st: _SlotState, tokens, now: float, *,
                       advance: bool = True) -> int:
        """Append committed tokens to a lane; the first carries the
        inter-token gap, the rest arrived in the same burst (TBT 0).
        ``advance=False`` (pipelined decode): positions already advanced at
        submit time."""
        for i, t in enumerate(tokens):
            st.tokens.append(int(t))
            tbt = (now - st.last_token_t) if i == 0 else 0.0
            st.tbts.append(tbt)
            self._h_tbt.observe(tbt)
        st.last_token_t = now
        if advance:
            st.pos += len(tokens)
            st.submitted = len(st.tokens)
        return len(tokens)

    def _dirty_window(self, width: int) -> tuple:
        """Pages of every active lane's next ``width``-token write window
        (masked fused steps past a lane's limit still write its mapped
        tail page)."""
        ps, dirty = self.page_size, set()
        for st in self._active.values():
            for lp in range(st.pos // ps,
                            min((st.pos + width - 1) // ps,
                                self.max_blocks - 1) + 1):
                pid = int(self._bt_host[st.slot, lp])
                if pid >= 0:
                    dirty.add(pid)
        return tuple(sorted(dirty))

    # -- host-out-of-the-loop decode: fused multi-step + async pipeline --
    def _fused_iteration(self) -> int:
        """Submit one EXECUTE covering up to ``fuse_steps`` tokens per lane,
        then commit the oldest in-flight record(s).  With ``async_depth >
        0`` the submit goes ahead of the previous iteration's read-back."""
        kf = self.fuse_steps
        # lanes finished by an earlier commit but kept while in-flight
        # EXECUTEs still referenced their pages retire once those drained
        for slot in sorted(self._active):
            st = self._active[slot]
            if (st.tokens and len(st.tokens) >= st.limit
                    and st.inflight == 0):
                self._retire(st, self._clock())
        entries: List[Tuple[_SlotState, int]] = []
        lims = np.zeros((self.slots,), np.int32)
        for slot in sorted(self._active):
            st = self._active[slot]
            n = min(kf, st.limit - st.submitted)
            if n > 0:
                entries.append((st, n))
                lims[slot] = n
        decoded = 0
        if entries:
            if self._resync_lanes:
                # a dropped pipeline left the device's toks/pos ahead of the
                # rolled-back host state: rewrite them from the host (KV
                # pages need no repair: greedy decode rewrites the same
                # values at the same positions).  Deferred admissions from
                # this step commit first, so every lane has a last token.
                while self._inflight and self._inflight[0][0] == "admit":
                    decoded += self._commit_fused()
                toks_h = np.zeros((self.slots, 1), np.int32)
                pos_h = np.zeros((self.slots,), np.int32)
                for slot, st in self._active.items():
                    toks_h[slot, 0] = st.tokens[-1]
                    pos_h[slot] = st.pos
                self._write("toks", toks_h)
                self._write("pos", pos_h)
                self._resync_lanes = False
            dirty = {"kv_pool": self._dirty_window(kf)}
            if kf > 1:
                delta = self._bt_take_delta()
                exec_c = self._exec(
                    "decode_multi",
                    ("params", "toks", "pos", "block_table", "kv_pool"),
                    ("fused_toks", "toks", "pos", "block_table", "kv_pool"),
                    donate=True, const_args=(lims, delta),
                    dirty_pages=dirty)
                read_c = self._read_async("fused_toks")
            else:
                self._flush_block_table()
                exec_c = self._exec(
                    "decode_step",
                    ("params", "toks", "pos", "block_table", "kv_pool"),
                    ("toks", "pos", "kv_pool"), donate=True,
                    dirty_pages=dirty)
                read_c = self._read_async("toks")
            for st, n in entries:
                st.submitted += n
                st.pos += n
                st.inflight += 1
            self._inflight.append(("batch", exec_c, read_c, entries))
        # only decode batches count against the pipeline depth: a deferred
        # admission commits when it reaches the head
        if entries:
            while sum(1 for r in self._inflight
                      if r[0] == "batch") > self.async_depth:
                decoded += self._commit_fused()
        else:
            decoded += self._drain_pipeline()
        return decoded

    def _commit_fused(self) -> int:
        """Read back and commit the oldest in-flight record, a decode batch
        or a deferred admission.  A failed EXECUTE drops the whole pipeline
        and rolls the submit-time advance back (``_fail_pipeline``); the
        monitor raises before any output buffer is written, so the next
        iteration resubmits the span bit-exactly."""
        rec = self._inflight.popleft()
        kind, read_c = rec[0], rec[2]
        err = None
        try:
            val = np.asarray(read_c.wait())
        except BaseException as e:  # noqa: BLE001 - surfaced below
            read_c.error_seen = True
            err = e
        if err is None:
            # FIFO: the read completing proves every EXECUTE ahead of it ran;
            # surface their failures instead of committing stale bytes
            for c in ((rec[1],) if kind == "batch" else rec[3]):
                if c.error is not None:
                    c.error_seen = True
                    err = c.error
                    break
        if err is not None:
            self._fail_pipeline([rec] + list(self._inflight))
            raise err
        now = self._clock()
        if kind == "admit":
            st = rec[1]
            if self._active.get(st.slot) is not st:
                return 0    # preempted since submit: recompute replays it
            tok = int(val[0])
            st.first_token_t = self._observe_first_token(st.req, now)
            st.tokens.append(tok)
            st.last_token_t = now
            self._c_tokens.inc()
            if self.eos_id is not None and tok == self.eos_id:
                self._mark_eos(st)
            if len(st.tokens) >= st.limit and st.inflight == 0:
                self._retire(st, now)   # degenerate 1-token request
            return 1
        decoded = 0
        for st, n in rec[3]:
            if self._active.get(st.slot) is not st:
                continue    # preempted since submit: recompute replays it
            st.inflight -= 1
            if st.eos_done:
                # frozen on the device for this whole span: nothing to commit
                if len(st.tokens) >= st.limit and st.inflight == 0:
                    self._retire(st, now)
                continue
            toks = np.asarray(val[st.slot, :n])
            if self.eos_id is not None:
                hit = np.nonzero(toks == self.eos_id)[0]
                if hit.size:
                    toks = toks[:int(hit[0]) + 1]
            decoded += self._commit_tokens(st, toks, now, advance=False)
            if (self.eos_id is not None and st.tokens
                    and st.tokens[-1] == self.eos_id):
                self._mark_eos(st)
            if len(st.tokens) >= st.limit and st.inflight == 0:
                self._retire(st, now)
        self._c_tokens.inc(decoded)
        return decoded

    def _mark_eos(self, st: _SlotState) -> None:
        """The lane's newest committed token is the stop token: clamp the
        limit so it retires, and restore ``pos == bucket + len(tokens) - 1``
        (any submit-time advance on later in-flight spans is undone; the
        device lane froze at EOS)."""
        st.eos_done = True
        st.limit = len(st.tokens)
        st.submitted = len(st.tokens)
        st.pos = st.bucket + len(st.tokens) - 1

    def _fail_pipeline(self, records) -> None:
        """Drop every in-flight record after a failed EXECUTE: later
        pipelined EXECUTEs ran against the pre-failure state.  Batch records
        roll their submit-time advances back; deferred admissions un-admit
        (the request is requeued whole and replays deterministically).  The
        caller raises the error exactly once."""
        self._inflight.clear()
        # reversed, so appendleft restores the admissions' arrival order
        for rec in reversed(records):
            if rec[0] == "admit":
                st = rec[1]
                if self._active.get(st.slot) is not st:
                    continue
                self.pool.free(st.blocks)
                self._bt_clear_row(st.slot)
                self._active.pop(st.slot)
                heapq.heappush(self._free, st.slot)
                self.pending.appendleft(st.req)
                self.registry.record_event("engine_unadmit",
                                           rid=st.req.rid, slot=st.slot,
                                           engine=self.engine_id)
            else:
                for st, n in rec[3]:
                    if self._active.get(st.slot) is st:
                        st.inflight -= 1
                        if not st.eos_done:
                            st.submitted -= n
                            st.pos -= n
        self._resync_lanes = True
        # a failed fused EXECUTE never applied the delta rows it carried:
        # the next iteration rewrites the table whole
        self._bt_mark_full()

    def _drain_pipeline(self) -> int:
        """Commit every in-flight record (compaction / explicit flush)."""
        decoded = 0
        while self._inflight:
            decoded += self._commit_fused()
        return decoded

    # -- one iteration ---------------------------------------------------
    def step(self) -> dict:
        """One engine iteration; returns counts for the caller's pacing.
        On an unexpected exception the registry's flight record is written
        to ``funky_flight_<engine>.json`` in the temp dir, then the error
        propagates."""
        if not self._setup_done:
            raise RuntimeError("engine.setup() has not run")
        try:
            return self._step_inner()
        except BaseException as e:  # noqa: BLE001 - dump, then re-raise
            try:
                self.registry.flight_record_to_file(
                    os.path.join(tempfile.gettempdir(),
                                 f"funky_flight_{self.engine_id}.json"),
                    engine=self.engine_id, error=repr(e),
                    iteration=self.iterations)
            except Exception:  # noqa: BLE001 - never mask the original
                pass
            raise

    def _step_inner(self) -> dict:
        t_step0 = time.perf_counter()
        decoded = 0
        if self._inflight and self._should_auto_compact():
            # compaction remaps physical pages: commit the pipelined batches
            # first (their EXECUTEs hold the old ids)
            decoded += self._drain_pipeline()
        self._maybe_auto_compact()
        self._mid_step = True
        try:
            admitted = self._admit()
            self.peak_active = max(self.peak_active, len(self._active))
            if self._active:
                self._append_pages()
            if self._pipelined:
                if self._active or self._inflight:
                    decoded += self._fused_iteration()
            elif self._active:
                self._flush_block_table()
                self._exec(
                    "decode_step",
                    ("params", "toks", "pos", "block_table", "kv_pool"),
                    ("toks", "pos", "kv_pool"), donate=True,
                    dirty_pages={"kv_pool": self._dirty_window(1)})
                # token delivery doubles as the iteration's sync point
                toks = np.asarray(self._read("toks"))
                now = self._clock()
                for st in list(self._active.values()):
                    decoded += self._commit_tokens(st, toks[st.slot], now)
                    if (self.eos_id is not None and st.tokens
                            and st.tokens[-1] == self.eos_id):
                        self._mark_eos(st)
                    if len(st.tokens) >= st.limit:
                        self._retire(st, now)
                self._c_tokens.inc(decoded)
        finally:
            self._mid_step = False
        self.iterations += 1
        self._c_iters.inc()
        self._attribute(time.perf_counter() - t_step0, decoded + admitted)
        if self._publish_gauges:
            self._g_queue.set(len(self.pending))
            self._g_util.set(len(self._active) / self.slots)
            self._g_kv.set(self.pool.occupancy())
            self._g_kv_free.set(self.pool.free_count())
        return {"admitted": admitted, "decoded": decoded,
                "active": len(self._active), "pending": len(self.pending)}

    def _attribute(self, wall: float, tokens: int) -> None:
        """Fold this step's finished completions into the host/device
        split; an unfinished one (a pipelined EXECUTE) carries over, so a
        late failure surfaces exactly once."""
        device_s = queue_wait_s = 0.0
        execs = 0
        carry: List = []
        pending = self._step_completions
        for i, c in enumerate(pending):
            if not c.done:
                carry.append(c)
                continue
            if c.error is not None:
                if c.error_seen:
                    continue
                c.error_seen = True
                self._step_completions = carry + pending[i + 1:]
                raise c.error
            ph = c.phases or {}
            device_s += ph.get("device_s", 0.0)
            queue_wait_s += ph.get("queue_wait_s", 0.0)
            if ph.get("kind") == "EXECUTE":
                execs += 1
                prog = ph.get("program")
                self.program_execs[prog] = self.program_execs.get(prog, 0) + 1
                self.program_device_s[prog] = (
                    self.program_device_s.get(prog, 0.0)
                    + ph.get("device_s", 0.0))
        self._step_completions = carry
        if tokens:
            self._attr_host_s += max(0.0, wall - device_s)
            self._attr_device_s += device_s
            self._attr_queue_wait_s += queue_wait_s
            self._attr_tokens += tokens
            self._attr_execs += execs
            if self._publish_gauges:
                self._g_host_us.set(
                    self._attr_host_s / self._attr_tokens * 1e6)
                self._g_device_us.set(
                    self._attr_device_s / self._attr_tokens * 1e6)
                self._g_queue_wait_us.set(
                    self._attr_queue_wait_s / max(self._attr_execs, 1) * 1e6)

    def host_device_split(self) -> dict:
        """Cumulative host-vs-device attribution of the serving loop, from
        the monitor's per-request phase dicts."""
        toks = max(self._attr_tokens, 1)
        return {"tokens": self._attr_tokens,
                "execs": self._attr_execs,
                "host_us_per_token": self._attr_host_s / toks * 1e6,
                "device_us_per_token": self._attr_device_s / toks * 1e6,
                "queue_wait_us_mean": (self._attr_queue_wait_s
                                       / max(self._attr_execs, 1) * 1e6),
                "host_s_total": self._attr_host_s,
                "device_s_total": self._attr_device_s}

    def drain_completions(self) -> List[CompletedRequest]:
        out = list(self._unreported)
        self._unreported.clear()
        return out

    def evacuate(self) -> List[ServeRequest]:
        """Hand back every unfinished request (kill / drain path) and reset
        the lanes.  Finished-but-unreported completions stay available via
        ``drain_completions``."""
        reqs = ([st.req for st in self._active.values()]
                + list(self.pending))
        self._active.clear()
        self.pending.clear()
        # in-flight pipelined tokens die with the lanes: the requests are
        # requeued whole and recompute deterministically elsewhere
        self._inflight.clear()
        self._resync_lanes = False
        self._free = list(range(self.slots))
        heapq.heapify(self._free)
        self.pool = BlockPool(self.pool_pages, self.page_size,
                              reserve_pages=self.pool.reserve_pages)
        # the device pool keeps the dead lanes' bytes: nothing is
        # first-touch clean for whoever reuses this engine
        self._virgin_pages = set()
        self._bt_host[:] = -1
        self._bt_mark_full()
        self._first_token.clear()
        if self._publish_gauges:
            # a dead engine must not pin the pressure signal at its last
            # value, nor outrank live replicas in KV-aware routing
            self._g_kv.set(0.0)
            self._g_kv_free.set(0.0)
        return reqs

    def attach_transfer(self, queue) -> None:
        raise _not_ported("the KV lane handoff (attach_transfer)")

    def export_lane(self, st) -> Any:
        raise _not_ported("the KV lane handoff (export_lane)")

    def import_lane(self, handoff) -> bool:
        raise _not_ported("the KV lane handoff (import_lane)")

    def run_until_drained(self, max_iterations: int = 100000) -> None:
        while not self.idle:
            self.step()
            if self.iterations >= max_iterations:
                raise RuntimeError("engine did not drain "
                                   f"in {max_iterations} iterations")

    # ------------------------------------------------------------------
    # Router integration: pull admissible work, push results
    # ------------------------------------------------------------------
    def pump(self, router, admit: bool = True) -> bool:
        """One iteration against a ``RequestRouter``; True if work moved.
        ``admit=False`` (a draining replica) pulls nothing new.  The pop is
        engine-tagged so a KV-aware router can prefer the replica with the
        most free pages."""
        if admit:
            for req in router.pop(len(self._free), engine_id=self.engine_id):
                self.submit(req)
        moved = bool(self._active or self.pending)
        if moved:
            self.step()
        for rec in self.drain_completions():
            router.complete(rec)
        return moved
