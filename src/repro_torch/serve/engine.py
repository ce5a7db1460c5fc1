"""Continuous-batching serving engine (vLLM/Orca-style iteration-level
scheduling on top of the Funky monitor) over **paged** device memory: the
reference's ``serve/engine.py``.

The engine owns ``slots`` decode lanes.  Each lane is an independent
sequence with its own position; one *iteration* advances every occupied
lane through one EXECUTE.  Between iterations the engine retires finished
sequences and backfills freed lanes with prefills of waiting requests, so
a long request never stalls the batch behind it.

KV memory comes in two modes:

* **paged** (default) — a ``BlockPool`` of fixed-size pages shared by every
  lane (``serve/kvcache.py``).  A per-lane *block table* row maps logical
  page -> physical page; the decode program (``lm_decode_paged``, K1's
  paged entry) reads each lane's pages in place through its row and writes
  the new token into its page.  Lanes hold pages at token granularity:
  prompt pages at admission, one more page whenever decode crosses a page
  boundary, all freed when the request retires.  Admission is memory-based
  (admit while ``free_pages - prompt_pages >= reserve_pages``).  If the
  pool runs dry mid-decode the youngest lane is OOM-preempted: its pages
  are freed and its request requeued for recomputation (greedy decode: the
  client sees the same tokens).  Reallocated pages are scrubbed (positions
  invalidated), so a new owner never attends to a previous lane's tokens.
  Prompts route to the smallest of a few compiled *prompt buckets* that
  fits.  The pool auto-defragments at iteration boundaries when
  fragmentation crosses ``auto_compact_frag``.
* **reserved** (``paged=False``) — every lane owns a dense
  ``prompt_len + max_new_tokens`` ring up front, at its own position
  (K1's dense entry with per-lane positions); the baseline paged mode is
  measured against.

Paged mode adds:

* ``fuse_steps > 1`` runs that many greedy steps per EXECUTE
  (``decode_multi``) and ``async_depth > 0`` submits iteration N+1's
  EXECUTE before iteration N's tokens are read back; token counts are
  known at submit time, so positions and pages advance there and only
  token values arrive at commit.
* the **prefix cache** (``prefix_cache=True``, ``serve/prefix_cache.py``):
  admission maps the pages of the longest cached prefix and prefills only
  the rest, one page per ``prefill_chunk`` EXECUTE that feeds the page's
  tokens one at a time through the paged decode (K1 paged at one lane).
  Cold and hit admissions run that same program, so a hit's tokens equal
  a cold run's.  Retirement donates the lane's committed pages to the
  tree; a shared page in a lane's write window is copied first
  (copy-on-write).
* **speculative decode** (``spec=SpecConfig(...)``): a draft model runs
  ``k`` lookahead steps per lane in one EXECUTE over per-lane dense draft
  caches (K1 dense), then the target verifies all ``k+1`` positions in one
  EXECUTE: ``k+1`` of the same paged decode steps as ``decode_step``, in
  sequence, so the logits at every position are the plain decode's.  The
  host commits the accepted prefix plus the target's token at the first
  mismatch, rolls the lane's position back and frees the orphaned tail
  pages; rejected writes left in kept pages sit at positions every later
  query masks until the lane overwrites them in order.
* **prefill/decode disaggregation** (``role="prefill"`` or ``"decode"``,
  with a ``serve/disagg.py:TransferQueue`` attached): a prefill replica
  admits prompts and, once a lane's first token is committed, exports the
  lane (``xfer_extract`` gathers its pages into the ``xfer_pages`` staging
  buffer, read back to the host); a decode replica takes no prompts from
  the router and imports lanes into fresh pages of its own pool
  (``xfer_install``, then ``lane_set`` for the lane's token and
  position).  The paged decode reads a lane through its block table, so
  a handoff changes no token.

Every device interaction is a Funky request through ``Monitor.submit``, so
serving stays preemptible at token boundaries: ``Monitor.evict`` between
iterations saves the dirty pages plus the block table, and ``resume``
continues every in-flight sequence bit-exactly.  Per-request latencies
(TTFT, time between tokens, end to end) and KV occupancy gauges land in
the shared registry; with a tracer (``tracer=``, else the monitor's) each
request is one span tree and each iteration an ``engine.step`` trace.
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
                                            M_PREFIX_HIT_RATE,
                                            M_QUEUE_DEPTH, M_SLO_VIOLATIONS,
                                            M_SPEC_ACCEPT_RATE,
                                            M_UTILIZATION)
from repro_torch.scaling.metrics import MetricsRegistry
from repro_torch.serve.kvcache import (BlockPool, apply_block_table_delta,
                                       cache_bytes, compact_pool,
                                       extract_pool_pages,
                                       init_caches_from_specs,
                                       install_lane_cache,
                                       install_pool_pages, lane_cache_specs,
                                       pool_specs_from_lane_cache,
                                       scatter_prefill, scrub_pages)
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.tree import tree_map

# Canonical per-request serving metrics (one schema across planes).
M_TTFT = "request_ttft_seconds"
M_TBT = "request_tbt_seconds"
M_E2E = "request_latency_seconds"
M_TOKENS = "engine_tokens_total"
M_ITERS = "engine_iterations_total"
M_SPEC_K = "spec_k"                 # live speculative lookahead per engine
# Host-overhead attribution (per engine): device_us is the monitor-measured
# device phase, host_us everything else in the iteration loop.
M_HOST_US = "host_us_per_token"
M_DEVICE_US = "device_us_per_token"
M_QUEUE_WAIT_US = "queue_wait_us"


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decode configuration (the reference's).

    ``draft_arch=None`` self-drafts with the target architecture; with
    ``draft_seed=None`` (the engine seed) the draft params equal the target
    params, so every draft token is accepted where draft and target decode
    alike — the forced-accept ceiling.  ``draft_mode="antigreedy"`` makes
    the draft argmin instead of argmax: rejection at every position, the
    forced-reject floor.  Committed tokens equal plain greedy decode's for
    *any* draft.

    ``dynamic_k=True`` adapts the live lookahead between ``k_min`` and
    ``k``: every ``adapt_window`` offered drafts the window's accept rate is
    read — below ``shrink_below`` the lookahead shrinks one step, at or
    above ``grow_above`` for two windows in a row it regrows one step.
    Programs exist for every ``k`` value from setup on, and adaptation
    changes throughput only, never tokens."""
    k: int = 2                          # max lookahead tokens per iteration
    draft_arch: Optional[str] = None    # None -> target arch
    draft_seed: Optional[int] = None    # None -> engine seed
    draft_mode: str = "greedy"          # "greedy" | "antigreedy"
    dynamic_k: bool = False             # adapt live k from acceptance
    k_min: int = 1                      # floor for dynamic shrink
    adapt_window: int = 32              # offered drafts per adaptation step
    shrink_below: float = 0.4           # window accept rate -> shrink
    grow_above: float = 0.8             # sustained window rate -> regrow


@dataclass
class ServeRequest:
    """One generation request admitted into a decode slot."""
    rid: str
    prompt: np.ndarray                  # (P,) int32 token ids
    max_new_tokens: int = 8
    arrival_t: Optional[float] = None   # registry-clock timestamp
    slo_s: Optional[float] = None       # end-to-end SLO (None = untracked)
    # per-request trace (repro_torch.obs.Trace), started by the router (or
    # the engine on direct submit) when a tracer is attached; id == rid
    trace: Any = None
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
    span: Any = None                    # engine.decode span (tracing)
    # prefix-cache insert deferred until the pipelined first-token read
    # commits: (bucket, flat_prompt, page_ids)
    deferred_insert: Any = None


class ContinuousBatchingEngine:
    def __init__(self, arch: str, cl: FunkyCL, *, slots: int = 4,
                 prompt_len: int = 16, max_new_tokens: int = 16,
                 service: str = "svc", engine_id: str = "engine0",
                 seed: int = 0, registry: Optional[MetricsRegistry] = None,
                 publish_gauges: bool = True, paged: bool = True,
                 page_size: int = 8, pool_pages: Optional[int] = None,
                 reserve_pages: int = 1,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 spec: Optional[SpecConfig] = None,
                 prefix_cache: bool = False,
                 prefix_cache_max_nodes: int = 4096,
                 auto_compact_frag: Optional[float] = 0.5,
                 auto_compact_min_pages: int = 4,
                 fuse_steps: int = 1, async_depth: int = 0,
                 role: str = "mixed", eos_id: Optional[int] = None,
                 tracer: Any = None):
        from repro_torch.configs import get_arch
        from repro_torch.models import build_model

        # disaggregated serving: a `prefill` replica admits prompts and
        # hands freshly prefilled lanes to a `decode` replica through a
        # TransferQueue; `mixed` is the aggregated engine.  Roles need paged
        # KV (the handoff moves whole pool pages)
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"unknown role {role!r}")
        if role != "mixed" and not paged:
            raise ValueError("role-disaggregated serving needs paged=True "
                             "(KV handoff moves pool pages)")
        if role != "mixed" and spec is not None:
            raise ValueError("speculative decode is host-authoritative and "
                             "does not survive a lane handoff; use "
                             "role='mixed'")
        if eos_id is not None and spec is not None:
            raise ValueError("eos_id does not compose with spec: verify "
                             "acceptance is host-decided, so EOS commits "
                             "host-side there anyway")
        if spec is not None:
            if not paged:
                raise ValueError("speculative decode needs paged=True (the "
                                 "lookahead rolls back through block tables)")
            if spec.k < 1:
                raise ValueError("spec.k must be >= 1")
            if spec.draft_mode not in ("greedy", "antigreedy"):
                raise ValueError(f"unknown draft_mode {spec.draft_mode!r}")
            if spec.dynamic_k and not 1 <= spec.k_min <= spec.k:
                raise ValueError(
                    f"dynamic k needs 1 <= k_min <= k, got "
                    f"k_min={spec.k_min} k={spec.k}")
        if fuse_steps < 1:
            raise ValueError("fuse_steps must be >= 1")
        if async_depth < 0:
            raise ValueError("async_depth must be >= 0")
        if (fuse_steps > 1 or async_depth > 0) and not paged:
            raise ValueError("fused/pipelined decode needs paged=True (the "
                             "multi-step program maps its write span "
                             "through block tables)")
        if spec is not None and (fuse_steps > 1 or async_depth > 0):
            raise ValueError(
                "fuse_steps/async_depth do not compose with spec: the "
                "verify program already fuses k+1 positions per EXECUTE "
                "and acceptance is host-decided, so the host cannot be "
                "taken out of that loop")
        if prompt_buckets and prompt_len > max(prompt_buckets):
            raise ValueError(
                f"prompt_len {prompt_len} exceeds the largest prompt "
                f"bucket {max(prompt_buckets)}: prompts would be silently "
                "truncated — add prompt_len as the largest bucket")
        self.cl = cl
        self.slots = slots
        self.role = role
        self.transfer = None            # TransferQueue, via attach_transfer
        self.eos_id = eos_id
        self.max_new_tokens = max_new_tokens   # per-request cap
        self.service = service
        self.engine_id = engine_id
        self.seed = seed
        self.cfg = get_arch(arch)
        self.paged = paged
        self.spec = spec
        self.fuse_steps = fuse_steps
        self.async_depth = async_depth
        # pipelined mode: EXECUTEs (decode spans and admissions) commit at a
        # later boundary instead of being waited at the submit site
        self._pipelined = fuse_steps > 1 or async_depth > 0
        # spec_k is the provisioning maximum (capacity, scrub width); the
        # live lookahead spec_k_now moves within spec_ks under dynamic_k
        self.spec_k = spec.k if spec is not None else 0
        self.spec_k_now = self.spec_k
        if spec is not None and spec.dynamic_k:
            self.spec_ks = tuple(range(spec.k_min, spec.k + 1))
        else:
            self.spec_ks = (self.spec_k,) if spec is not None else ()
        self._adapt_offered = 0
        self._adapt_accepted = 0
        self._grow_streak = 0
        self.auto_compact_frag = auto_compact_frag
        self.auto_compact_min_pages = auto_compact_min_pages
        self._first_token: Dict[str, float] = {}
        # the reference's staged admission (write + prefill + admit + read),
        # a benchmark baseline flipped before setup()
        self._legacy_admit = False
        self.prefix = None
        self._prefix_max_nodes = prefix_cache_max_nodes
        if paged:
            self.buckets = tuple(sorted(set(prompt_buckets or (prompt_len,))))
            self.prompt_len = max(self.buckets)
            self.page_size = page_size
            # +headroom: verify writes up to k positions past the commit
            # horizon, and a fused decode's masked steps up to fuse_steps-1
            # past a retiring lane's limit; they must not wrap the table
            max_ctx = (self.prompt_len + max_new_tokens
                       + max(self.spec_k, fuse_steps - 1))
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
            if prefix_cache:
                # nodes key whole pages and prefill_chunk writes exactly one
                # page per EXECUTE: every bucket must be page-aligned
                bad = [b for b in self.buckets if b % page_size]
                if bad:
                    raise ValueError(
                        f"prefix_cache needs page-aligned prompt buckets; "
                        f"{bad} not divisible by page_size {page_size}")
                self.prefix = PrefixCache(self.pool, page_size,
                                          max_nodes=prefix_cache_max_nodes)
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
            if spec is not None:
                self.draft_cfg = get_arch(spec.draft_arch or arch)
                # dense per-lane draft ring: it must reach the last
                # lookahead write, prompt_len + max_new_tokens + k - 1
                self.draft_bundle = build_model(
                    self.draft_cfg, cache_margin=max_new_tokens + spec.k)
                self.draft_seed = (spec.draft_seed
                                   if spec.draft_seed is not None else seed)
                # host-authoritative lane state: the verify EXECUTE cannot
                # know acceptance, so toks/pos are committed here and
                # rewritten h2d (tiny) before each speculative iteration
                self._toks_host = np.zeros((slots, 1), np.int32)
                self._pos_host = np.zeros((slots,), np.int32)
        else:
            if prompt_buckets:
                raise ValueError("prompt buckets need paged=True (dense "
                                 "lanes are sized to one prompt_len)")
            if prefix_cache:
                raise ValueError("prefix_cache needs paged=True (sharing "
                                 "maps pool pages through block tables)")
            self.buckets = (prompt_len,)
            self.prompt_len = prompt_len
            # lane capacity = prompt_len + max_new_tokens: prefill reserves
            # the decode headroom so admission is a whole-lane copy
            self.bundle = build_model(self.cfg,
                                      cache_margin=max_new_tokens)
            self.pool = None
        self.registry = (registry if registry is not None
                         else cl._monitor.telemetry)
        self._clock = self.registry.clock
        self._publish_gauges = publish_gauges
        # tracing: an explicit tracer wins; else share the monitor's, if any
        self.tracer = (tracer if tracer is not None
                       else getattr(cl._monitor, "tracer", None))
        self._it_root = None            # current iteration's root span
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
            if spec is not None:
                self._g_spec = reg.gauge(M_SPEC_ACCEPT_RATE, **lbl)
                self._g_spec_k = reg.gauge(M_SPEC_K, **lbl)
                self._g_spec_k.set(self.spec_k_now)
            if self.prefix is not None:
                self._g_prefix = reg.gauge(M_PREFIX_HIT_RATE, **lbl)

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
        # prefix-cache accounting (all zero when the cache is off)
        self.prefix_hits = 0                # full-prompt hits (no prefill)
        self.prefix_partial_hits = 0        # suffix-only prefills
        self.prefix_misses = 0
        self.prefix_prompt_tokens = 0       # padded prompt tokens admitted
        self.prefix_cached_tokens = 0       # of those, served from cache
        self.cow_copies = 0                 # shared pages privatized
        # speculative-decode accounting (all zero when spec is off)
        self.spec_iterations = 0            # verify EXECUTEs issued
        self.spec_lane_iterations = 0       # active-lane verify passes
        self.spec_committed = 0             # tokens committed via verify
        self.spec_offered_drafts = 0        # draft tokens that could commit
        self.spec_accepted_drafts = 0
        self._mid_step = False              # pages in flight: no compaction
        self._setup_done = False
        self._program_ids: List[str] = []

    # ------------------------------------------------------------------
    # Program/buffer setup (Funky guest-style, via FunkyCL only)
    # ------------------------------------------------------------------
    def setup(self, restore: bool = False) -> None:
        if self.paged:
            self._setup_paged(restore)
        else:
            self._setup_reserved(restore)
        self._setup_done = True

    def program_ids(self) -> tuple:
        return tuple(self._program_ids)

    def _register(self, name, fn, abstracts, inplace=()):
        self.cl.clCreateProgramWithBinary(
            Program(name, fn, inplace_argnums=inplace), abstracts,
            donate_argnums=inplace)
        self._program_ids.append(name)

    def _staged(self) -> bool:
        """Admission through separate prefill and admit EXECUTEs (speculative
        engines: the draft prefill reads the same prompt buffer, and the
        host needs the first token at once for its lane mirror)."""
        return self.spec is not None or self._legacy_admit

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
        self.pool_bytes = cache_bytes(pool_abs)
        self.page_bytes = self.pool_bytes // (NP + 1)   # the sink included
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
        # one lookahead (or one fused k-step span) can append several pages
        # per lane; with the prefix cache, one scrub covers a whole prompt's
        # fresh suffix pages before its chunked prefill
        self._scrub_width = B * (max(self.spec_k, kf - 1) // ps + 2)
        if self.prefix is not None:
            self._scrub_width = max(self._scrub_width, self.prompt_len // ps)
        ids_abs = np.zeros((self._scrub_width,), np.int32)
        np_abs = np.zeros((NP,), np.int32)
        pf_tok_abs = empty(1)
        self._pf_abs = {}
        for P in self.buckets:
            self._pf_abs[P] = (empty(1, P), bundle.cache_specs(1, P))
        if self.prefix is None:
            for P in self.buckets:
                n_pp = self.pool.pages_for_tokens(P)
                pp_abs = np.zeros((n_pp,), np.int32)

                # one-EXECUTE admission: prefill + first-token argmax + lane
                # install + page scatter, the prompt a const arg
                def prefill_admit(params, toks, pos, pool, prompt, slot,
                                  page_ids, P=P):
                    prompt = torch.as_tensor(np.asarray(prompt), device=dev)
                    logits, cache = bundle.prefill_fn(params,
                                                      {"tokens": prompt})
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
                     np.zeros((1, P), np.int32), np.int32(0), pp_abs),
                    inplace=(1, 2, 3))
                if not self._staged():
                    continue
                # the staged admission: prefill from the prompt buffer, then
                # the lane install + page scatter from the prefill's buffers
                prompt_abs, cache_abs = self._pf_abs[P]
                self._register(f"prefill_{P}", self._prefill_fn(bundle),
                               (params_abs, prompt_abs))

                def admit(toks, pos, pool, pf_tok, pf_cache, slot, page_ids,
                          P=P):
                    slot = int(slot)
                    toks[slot, 0] = pf_tok[0]
                    pos[slot] = P
                    scatter_prefill(pool, page_ids, pf_cache, page_size=ps,
                                    prompt_len=P)
                    return toks, pos, pool

                self._register(
                    f"admit_{P}", admit,
                    (toks_abs, pos_abs, pool_abs, pf_tok_abs, cache_abs,
                     np.int32(0), pp_abs), inplace=(0, 1, 2))
        else:
            # prefix-cache mode replaces the per-bucket prefill with ONE
            # page-granular program shared by every bucket: each EXECUTE
            # feeds page ``lp``'s tokens one at a time through the paged
            # decode (one lane, its row of the block table), writing that
            # page in place.  Cold admissions run every chunk, a hit skips
            # the covered ones; both run the same program over the same
            # inputs, so a hit's tokens equal a cold run's (sequential
            # decode is not bitwise the fused prefill, so the two paths
            # never mix)
            def prefill_chunk(params, pool, chunk_toks, lp, bt_row):
                toks = torch.as_tensor(np.asarray(chunk_toks, np.int32),
                                       device=dev)
                row = torch.as_tensor(np.asarray(bt_row, np.int32),
                                      device=dev).reshape(1, -1)
                pos = torch.full((1,), int(lp) * ps, dtype=i32, device=dev)
                logits = None
                for i in range(ps):
                    logits, pool = bundle.decode_paged_fn(
                        params, toks[i:i + 1], pos, pool, row, rows=1)
                    pos += 1
                return logits.argmax(-1).to(i32), pool

            self._register("prefill_chunk", prefill_chunk,
                           (params_abs, pool_abs, np.zeros((ps,), np.int32),
                            np.int32(0), np.zeros((max_blocks,), np.int32)),
                           inplace=(1,))

            def admit_tok(toks, pos, pf_tok, slot, p_end):
                toks[int(slot), 0] = pf_tok[0]
                pos[int(slot)] = int(p_end)
                return toks, pos

            self._register("admit_tok", admit_tok,
                           (toks_abs, pos_abs, pf_tok_abs, np.int32(0),
                            np.int32(0)), inplace=(0, 1))
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
        if self.role != "mixed":
            # cross-replica KV handoff: a prefill replica gathers a lane's
            # pages into the fixed-width staging buffer (a d2h read
            # follows); a decode replica scatters staged pages into freshly
            # allocated pages of its own pool and installs the lane's token
            # and position.  Padding ids (``NP``) are clamped on extraction
            # and sent to the sink on installation
            ids_w = np.zeros((max_blocks,), np.int32)
            self._xfer_abs = tree_map(
                lambda l: torch.empty((max_blocks,) + tuple(l.shape[1:]),
                                      dtype=l.dtype, device=meta), pool_abs)

            def xfer_extract(pool, page_ids):
                return extract_pool_pages(pool, page_ids)

            def xfer_install(pool, staged, page_ids):
                return install_pool_pages(pool, staged, page_ids)

            def lane_set(toks, pos, tok, p, slot):
                toks[int(slot), 0] = int(tok)
                pos[int(slot)] = int(p)
                return toks, pos

            self._register("xfer_extract", xfer_extract, (pool_abs, ids_w))
            self._register("xfer_install", xfer_install,
                           (pool_abs, self._xfer_abs, ids_w), inplace=(0,))
            self._register("lane_set", lane_set,
                           (toks_abs, pos_abs, np.int32(0), np.int32(0),
                            np.int32(0)), inplace=(0, 1))
        if self.spec is not None:
            self._setup_spec(params_abs, toks_abs, pos_abs, bt_abs, pool_abs)
        if not restore:
            cl = self.cl
            cl.clCreateBuffer("params", params_abs)
            cl.clCreateBuffer("toks", toks_abs)
            cl.clCreateBuffer("pos", pos_abs)
            cl.clCreateBuffer("block_table", bt_abs)
            cl.clCreateBuffer("kv_pool", pool_abs, paged=True)
            cl.clCreateBuffer("pf_tok", pf_tok_abs)
            if self.role != "mixed":
                cl.clCreateBuffer("xfer_pages", self._xfer_abs)
            if kf > 1:
                cl.clCreateBuffer("fused_toks", empty(B, kf))
            if self._staged():
                for P, (prompt_abs, cache_abs) in self._pf_abs.items():
                    cl.clCreateBuffer(f"pf_prompt_{P}", prompt_abs)
                    if self.prefix is None:
                        cl.clCreateBuffer(f"pf_cache_{P}", cache_abs)
            cl.clEnqueueKernel("init_params", (), ("params",),
                               const_args=(self.seed,))
            cl.clEnqueueKernel("init_paged", (), ("toks", "pos", "kv_pool"))
            # the freshly initialized pool is all-INVALID: every page is
            # clean until its first allocation
            self._virgin_pages = set(range(self.pool_pages))
            cl.write_buffer("block_table", self._bt_host.copy())
            if self.spec is not None:
                cl.clCreateBuffer("draft_params", self._draft_params_abs)
                cl.clCreateBuffer("draft_caches", self._draft_caches_abs)
                for v in self.spec_ks:
                    cl.clCreateBuffer(f"draft_toks_k{v}", empty(B, v))
                    cl.clCreateBuffer(f"verify_toks_k{v}", empty(B, v + 1))
                for P, dcache_abs in self._draft_pf_abs.items():
                    cl.clCreateBuffer(f"pf_draft_cache_{P}", dcache_abs)
                cl.clEnqueueKernel("init_draft_params", (),
                                   ("draft_params",),
                                   const_args=(self.draft_seed,))
                cl.clEnqueueKernel("init_draft", (), ("draft_caches",))
            cl.clFinish()
            self._bt_dirty = False
            self._bt_full = False
            self._bt_delta.clear()

    @staticmethod
    def _prefill_fn(bundle):
        def prefill_one(params, tokens):
            logits, cache = bundle.prefill_fn(params, {"tokens": tokens})
            return logits.argmax(-1).to(torch.int32), cache

        return prefill_one

    # -- speculative decode: draft + verify programs ---------------------
    def _setup_spec(self, params_abs, toks_abs, pos_abs, bt_abs,
                    pool_abs) -> None:
        spec, bundle, dbundle = self.spec, self.bundle, self.draft_bundle
        B, ps = self.slots, self.page_size
        cap = self.max_blocks * ps
        dev = self.cl.device
        meta = torch.device("meta")
        i32 = torch.int32
        greedy = spec.draft_mode == "greedy"
        margin = dbundle.cache_margin

        def init_draft_params(seed):
            return dbundle.init(int(seed), device=dev)

        dparams_abs = dbundle.init(0, device=meta)
        # one lane's draft ring per bucket (prompt + margin slots); the
        # lanes are sized to the largest bucket and a smaller bucket's
        # prefill is padded into them (install_lane_cache)
        self._draft_pf_abs = {P: dbundle.cache_specs(1, P + margin)
                              for P in self.buckets}
        dcaches_abs = lane_cache_specs(self._draft_pf_abs[self.prompt_len],
                                       B)
        self._draft_params_abs = dparams_abs
        self._draft_caches_abs = dcaches_abs

        def init_draft():
            return init_caches_from_specs(dcaches_abs, dev)

        def draft_prefill(dparams, tokens):
            return dbundle.prefill_fn(dparams, {"tokens": tokens})[1]

        def admit_draft(dcaches, pf_cache, slot):
            return install_lane_cache(dcaches, pf_cache, int(slot))

        def make_draft_lookahead(v):
            # v+1 steps for v offered drafts: the extra step feeds the last
            # draft token back so its KV lands in the draft ring (under
            # full acceptance the commit advances v+1 positions; without it
            # the draft state would grow one hole per iteration, costing
            # acceptance, never correctness)
            def draft_lookahead(dparams, toks, pos, dcaches):
                cur, outs = toks[:, 0], []
                for i in range(v + 1):
                    logits, dcaches = dbundle.decode_fn(
                        dparams, cur, pos + i, dcaches, inplace=True)
                    cur = (logits.argmax(-1) if greedy
                           else logits.argmin(-1)).to(i32)
                    if i < v:
                        outs.append(cur)
                return torch.stack(outs, 1), dcaches
            return draft_lookahead

        def make_verify_step(v):
            # v+1 of decode_step's own paged steps in sequence over every
            # lane (never a multi-query attention over the window), so each
            # position's logits are plain decode's.  Writes go in place to
            # the lane's mapped pages; unmapped pages, inactive lanes and a
            # slot past the lane's logical cap go to the sink
            def verify_step(params, toks, d_toks, pos, bt, pool):
                cur, outs = toks[:, 0], []
                for i in range(v + 1):
                    logits, pool = bundle.decode_paged_fn(
                        params, cur, pos + i, pool, bt,
                        write_ok=(pos % cap) + i < cap)
                    outs.append(logits.argmax(-1).to(i32))
                    if i < v:
                        cur = d_toks[:, i]
                return torch.stack(outs, 1), pool
            return verify_step

        self._register("init_draft_params", init_draft_params, (0,))
        self._register("init_draft", init_draft, ())
        for P, dcache_abs in self._draft_pf_abs.items():
            self._register(f"draft_prefill_{P}", draft_prefill,
                           (dparams_abs, self._pf_abs[P][0]))
            self._register(f"admit_draft_{P}", admit_draft,
                           (dcaches_abs, dcache_abs, np.int32(0)),
                           inplace=(0,))
        for v in self.spec_ks:
            d_abs = torch.empty((B, v), dtype=i32, device=meta)
            self._register(f"draft_lookahead_k{v}", make_draft_lookahead(v),
                           (dparams_abs, toks_abs, pos_abs, dcaches_abs),
                           inplace=(3,))
            self._register(f"verify_step_k{v}", make_verify_step(v),
                           (params_abs, toks_abs, d_abs, pos_abs, bt_abs,
                            pool_abs), inplace=(5,))

    # -- reserved (per-lane dense ring) layout ---------------------------
    def _setup_reserved(self, restore: bool) -> None:
        bundle, B, P = self.bundle, self.slots, self.prompt_len
        dev = self.cl.device
        meta = torch.device("meta")
        i32 = torch.int32

        def init_params(seed):
            return bundle.init(int(seed), device=dev)

        # every lane at its own position over its own ring: K1's dense
        # entry with per-lane positions (the reference vmaps the lanes)
        def decode_step(params, toks, pos, caches):
            logits, caches = bundle.decode_fn(params, toks[:, 0], pos,
                                              caches, inplace=True)
            toks[:, 0] = logits.argmax(-1).to(i32)
            pos += 1
            return toks, pos, caches

        def admit_slot(toks, pos, caches, pf_tok, pf_cache, slot):
            toks[int(slot), 0] = pf_tok[0]
            pos[int(slot)] = P
            install_lane_cache(caches, pf_cache, int(slot))
            return toks, pos, caches

        params_abs = bundle.init(0, device=meta)
        prompt_abs = torch.empty((1, P), dtype=i32, device=meta)
        pf_tok_abs = torch.empty((1,), dtype=i32, device=meta)
        pf_cache_abs = bundle.cache_specs(1, P + bundle.cache_margin)
        caches_abs = lane_cache_specs(pf_cache_abs, B)
        toks_abs = torch.empty((B, 1), dtype=i32, device=meta)
        pos_abs = torch.empty((B,), dtype=i32, device=meta)
        self.pool_bytes = cache_bytes(caches_abs)

        def init_slots():
            return (torch.zeros((B, 1), dtype=i32, device=dev),
                    torch.zeros((B,), dtype=i32, device=dev),
                    init_caches_from_specs(caches_abs, dev))

        self._register("init_params", init_params, (0,))
        self._register("init_slots", init_slots, ())
        self._register(f"prefill_{P}", self._prefill_fn(bundle),
                       (params_abs, prompt_abs))
        self._register("admit_slot", admit_slot,
                       (toks_abs, pos_abs, caches_abs, pf_tok_abs,
                        pf_cache_abs, np.int32(0)), inplace=(0, 1, 2))
        self._register("decode_step", decode_step,
                       (params_abs, toks_abs, pos_abs, caches_abs),
                       inplace=(1, 2, 3))
        if not restore:
            cl = self.cl
            cl.clCreateBuffer("params", params_abs)
            cl.clCreateBuffer("toks", toks_abs)
            cl.clCreateBuffer("pos", pos_abs)
            cl.clCreateBuffer("caches", caches_abs)
            cl.clCreateBuffer(f"pf_prompt_{P}", prompt_abs)
            cl.clCreateBuffer("pf_tok", pf_tok_abs)
            cl.clCreateBuffer(f"pf_cache_{P}", pf_cache_abs)
            cl.clEnqueueKernel("init_params", (), ("params",),
                               const_args=(self.seed,))
            cl.clEnqueueKernel("init_slots", (), ("toks", "pos", "caches"))
            cl.clFinish()

    # ------------------------------------------------------------------
    # Tracked device-op helpers: the step folds the monitor's per-request
    # phase dicts into the engine's host/device attribution
    # ------------------------------------------------------------------
    def _exec(self, *args, span=None, **kw):
        c = self.cl.clEnqueueKernel(*args, span=span, **kw)
        self._step_completions.append(c)
        return c

    def _write(self, buff_id, host_value, span=None):
        c = self.cl.write_buffer(buff_id, host_value, span=span)
        self._step_completions.append(c)
        return c

    def _read(self, buff_id, span=None):
        c = self.cl.clEnqueueMigrateMemObjects(buff_id, to_device=False,
                                               span=span)
        self._step_completions.append(c)
        try:
            return c.wait()
        except BaseException:
            # surfaced here: the step-boundary sweep must not raise it again
            c.error_seen = True
            raise

    def _read_async(self, buff_id, span=None):
        """d2h read whose wait is deferred to the commit site."""
        c = self.cl.clEnqueueMigrateMemObjects(buff_id, to_device=False,
                                               span=span)
        self._step_completions.append(c)
        return c

    # ------------------------------------------------------------------
    # Request intake
    # ------------------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        if req.arrival_t is None:
            req.arrival_t = self._clock()
        if self.tracer is not None and req.trace is None:
            req.trace = self.tracer.start_trace("request", trace_id=req.rid,
                                                service=self.service)
        if req.trace is not None:
            req._eng_queue_span = req.trace.span("engine.queue",
                                                 engine=self.engine_id)
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
    def _prefix_match(self, bucket: int, flat: np.ndarray):
        """The tree's match for a padded prompt.  A match of every page
        whose continuation is unknown (pages donated at retire without a
        following token) gives its last page back, so the recomputed last
        chunk's argmax yields the first token."""
        match = self.prefix.match(bucket, flat)
        if (len(match.pages) == self.pool.pages_for_tokens(bucket)
                and match.next_token is None):
            match.pages.pop()
            match.tokens -= self.page_size
        return match

    def _admit(self) -> int:
        admitted = 0
        while self._free and self.pending:
            req = self.pending[0]
            bucket = self._pick_bucket(
                np.asarray(req.prompt).reshape(-1).shape[0])
            page_ids = padded = match = None
            if self.prefix is not None:
                padded = self._pad_prompt(req.prompt, bucket)
                n_pp = self.pool.pages_for_tokens(bucket)
                match = self._prefix_match(bucket, padded.reshape(-1))
                need = n_pp - len(match.pages)
                if not self.pool.can_admit(need):
                    # admission pressure: reclaim cold cache (LRU subtrees)
                    # before refusing; the match just bumped its own pages'
                    # recency, so they are evicted last
                    short = (need + self.pool.reserve_pages
                             - self.pool.free_count())
                    if short > 0:
                        self.prefix.evict_pages(short)
                    if not self.pool.can_admit(need):
                        break
                    # eviction ran: re-match against the surviving tree
                    match = self._prefix_match(bucket, padded.reshape(-1))
                    need = n_pp - len(match.pages)
                    if not self.pool.can_admit(need):
                        break
                new_ids = self.pool.alloc(need) if need else []
                if new_ids is None:
                    break
                self.pool.share(match.pages)    # this lane's references
                page_ids = list(match.pages) + [int(p) for p in new_ids]
            elif self.paged:
                n_pp = self.pool.pages_for_tokens(bucket)
                if not self.pool.can_admit(n_pp):
                    break               # memory-based admission gate
                page_ids = self.pool.alloc(n_pp)
                # the prefill scatters these pages whole: no scrub needed,
                # but they are no longer first-touch clean
                self._virgin_pages.difference_update(page_ids)
            self.pending.popleft()
            slot = heapq.heappop(self._free)
            qsp = getattr(req, "_eng_queue_span", None)
            if qsp is not None:
                qsp.end()
                req._eng_queue_span = None
            adm = (req.trace.span("engine.admit", engine=self.engine_id,
                                  slot=slot, bucket=bucket)
                   if req.trace is not None else None)
            admit_cs: List = []
            read_c = first_tok = deferred_insert = None
            if self.prefix is not None:
                first_tok, read_c, deferred_insert = self._admit_prefix(
                    req, bucket, padded, match, page_ids, slot, adm)
            elif self.paged and not self._staged():
                # one-EXECUTE admission: the prompt rides as a const arg
                admit_cs.append(self._exec(
                    f"prefill_admit_{bucket}",
                    ("params", "toks", "pos", "kv_pool"),
                    ("pf_tok", "toks", "pos", "kv_pool"),
                    const_args=(self._pad_prompt(req.prompt, bucket),
                                np.int32(slot),
                                np.asarray(page_ids, np.int32)),
                    donate=True, dirty_pages={"kv_pool": tuple(page_ids)},
                    span=adm))
                self._bt_set_row(slot, page_ids)
                if self._pipelined:
                    # the first token's d2h read is deferred to the commit
                    # site
                    read_c = self._read_async("pf_tok", span=adm)
                else:
                    first_tok = int(np.asarray(self._read("pf_tok",
                                                          span=adm))[0])
            else:
                first_tok = self._admit_staged(req, bucket, page_ids, slot,
                                               adm)
            if adm is not None:
                adm.end()
            if self.spec is not None and first_tok is not None:
                self._toks_host[slot, 0] = first_tok
                self._pos_host[slot] = bucket
            now = self._clock()
            st = _SlotState(req=req, slot=slot,
                            tokens=[] if read_c is not None else [first_tok],
                            submitted=1, admit_t=now, first_token_t=now,
                            last_token_t=now,
                            limit=max(1, min(req.max_new_tokens,
                                             self.max_new_tokens)),
                            bucket=bucket, pos=bucket,
                            blocks=list(page_ids) if page_ids else [],
                            span=(req.trace.span("engine.decode",
                                                 engine=self.engine_id,
                                                 slot=slot)
                                  if req.trace is not None else None),
                            deferred_insert=deferred_insert)
            req.committed = st.tokens
            self.registry.record_event("engine_admit", rid=req.rid,
                                       slot=slot, engine=self.engine_id)
            if read_c is not None:
                # deferred admission: the lane decodes in this step's EXECUTE
                # (its device state is set by the admit EXECUTE ahead of it
                # in the FIFO); only the first token's value waits
                self._active[slot] = st
                self._inflight.append(("admit", st, read_c, tuple(admit_cs)))
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

    def _admit_staged(self, req, bucket, page_ids, slot, adm) -> int:
        """Write the prompt, prefill it (K2), install the lane (paged: plus
        the page scatter; speculative: plus the draft's prefill and lane
        install), then read the first token: the host mirror needs it at
        once."""
        self._write(f"pf_prompt_{bucket}", self._pad_prompt(req.prompt,
                                                            bucket),
                    span=adm)
        self._exec(f"prefill_{bucket}", ("params", f"pf_prompt_{bucket}"),
                   ("pf_tok", f"pf_cache_{bucket}"), span=adm)
        if self.paged:
            self._exec(f"admit_{bucket}",
                       ("toks", "pos", "kv_pool", "pf_tok",
                        f"pf_cache_{bucket}"),
                       ("toks", "pos", "kv_pool"),
                       const_args=(np.int32(slot),
                                   np.asarray(page_ids, np.int32)),
                       donate=True, dirty_pages={"kv_pool": tuple(page_ids)},
                       span=adm)
            self._bt_set_row(slot, page_ids)
            if self.spec is not None:
                self._admit_draft(bucket, slot, adm)
        else:
            self._exec("admit_slot",
                       ("toks", "pos", "caches", "pf_tok",
                        f"pf_cache_{bucket}"),
                       ("toks", "pos", "caches"),
                       const_args=(np.int32(slot),), donate=True, span=adm)
        return int(np.asarray(self._read("pf_tok", span=adm))[0])

    def _admit_draft(self, bucket, slot, adm) -> None:
        """The draft lane's dense prefill (K2) from the prompt buffer, then
        its lane install."""
        self._exec(f"draft_prefill_{bucket}",
                   ("draft_params", f"pf_prompt_{bucket}"),
                   (f"pf_draft_cache_{bucket}",), span=adm)
        self._exec(f"admit_draft_{bucket}",
                   ("draft_caches", f"pf_draft_cache_{bucket}"),
                   ("draft_caches",), const_args=(np.int32(slot),),
                   donate=True, span=adm)

    def _observe_first_token(self, req, now: float) -> float:
        """TTFT at first-token delivery; an OOM-preempted request keeps its
        original TTFT when it recomputes."""
        prior = self._first_token.get(req.rid)
        if prior is not None:
            return prior
        self._first_token[req.rid] = now
        self._h_ttft.observe(now - req.arrival_t)
        return now

    def _admit_prefix(self, req, bucket, padded, match, page_ids, slot, adm):
        """Admission over the prefix cache: map the matched pages and
        chunk-prefill only the uncovered suffix.  A full-prompt match skips
        device compute: the tree's stored greedy continuation is the first
        token, written to ``pf_tok`` for the lane install.  Then the
        prompt's pages are donated to the tree, so same-prefix requests
        (this request's own OOM recompute included) hit.

        Returns ``(first_tok, read_c, deferred_insert)``: on a pipelined
        engine a hit's suffix prefill rides the pipeline like a plain
        admission (``first_tok`` None, ``read_c`` committed later) and the
        tree insert, which needs the first token, is parked on the lane.
        Buckets are page-aligned, so no decode write lands in a prompt page
        before that insert."""
        ps = self.page_size
        n_pp = len(page_ids)
        flat = padded.reshape(-1)
        n_hit = len(match.pages)
        full_hit = n_hit == n_pp and match.next_token is not None
        self._bt_set_row(slot, page_ids)
        self.prefix_prompt_tokens += bucket
        self.prefix_cached_tokens += bucket if full_hit else n_hit * ps
        if full_hit:
            self.prefix_hits += 1
            first_tok = int(match.next_token)
            self._write("pf_tok", np.asarray([first_tok], np.int32),
                        span=adm)
            if adm is not None:
                adm.annotate(prefix_hit="full", cached_pages=n_hit)
        else:
            self.prefix_partial_hits += 1 if n_hit else 0
            self.prefix_misses += 0 if n_hit else 1
            # freed-memory zeroing: the chunks must see INVALID positions in
            # the fresh suffix pages, never a previous owner's tokens
            scrub_new = self._scrub_needed(page_ids[n_hit:])
            if scrub_new:
                ids = np.full((self._scrub_width,), self.pool_pages,
                              np.int32)
                ids[:len(scrub_new)] = scrub_new
                self._exec("scrub", ("kv_pool",), ("kv_pool",),
                           const_args=(ids,), donate=True,
                           dirty_pages={"kv_pool": tuple(scrub_new)},
                           span=adm)
            row = self._bt_host[slot].copy()
            for c in range(n_hit, n_pp):
                self._exec(
                    "prefill_chunk", ("params", "kv_pool"),
                    ("pf_tok", "kv_pool"),
                    const_args=(flat[c * ps:(c + 1) * ps].astype(np.int32),
                                np.int32(c), row),
                    donate=True, dirty_pages={"kv_pool": (int(page_ids[c]),)},
                    span=adm)
            first_tok = None
            if adm is not None:
                adm.annotate(prefix_hit="partial" if n_hit else "miss",
                             cached_pages=n_hit, chunks=n_pp - n_hit)
        self._exec("admit_tok", ("toks", "pos", "pf_tok"), ("toks", "pos"),
                   const_args=(np.int32(slot), np.int32(bucket)),
                   donate=True, span=adm)
        if self.spec is not None:
            # the draft lane has no pages: its dense prefill always runs in
            # full (throughput only: draft state never changes tokens)
            self._write(f"pf_prompt_{bucket}", padded, span=adm)
            self._admit_draft(bucket, slot, adm)
        if first_tok is None and self._pipelined and n_hit:
            # prefix-hit lanes ride the pipeline; a miss keeps the
            # synchronous read, since its insert seeds the tree and a
            # same-step sibling with the same prompt must full-match it
            read_c = self._read_async("pf_tok", span=adm)
            return None, read_c, (bucket, flat.copy(), list(page_ids))
        if first_tok is None:
            first_tok = int(np.asarray(self._read("pf_tok", span=adm))[0])
        self.prefix.insert(bucket, flat, page_ids, first_tok)
        return first_tok, None, None

    def _donate_committed(self, st: _SlotState) -> None:
        """Donate every fully committed page (prompt + generated) of a lane
        to the tree before its references drop, so a later request whose
        prompt extends this sequence maps the pages.  The page holding
        position ``pos`` is left out: it may hold rejected speculative
        writes past the commit horizon."""
        ps = self.page_size
        flat = self._pad_prompt(st.req.prompt, st.bucket).reshape(-1)
        full = np.concatenate([flat, np.asarray(st.tokens, np.int32)])
        n_complete = min(st.pos // ps, len(st.blocks))
        if n_complete:
            nxt = (int(full[n_complete * ps])
                   if n_complete * ps < len(full) else None)
            self.prefix.insert(st.bucket, full[:n_complete * ps],
                               st.blocks[:n_complete], nxt)

    def _retire(self, st: _SlotState, now: float) -> None:
        rec = CompletedRequest(
            rid=st.req.rid, tokens=st.tokens, arrival_t=st.req.arrival_t,
            admit_t=st.admit_t, first_token_t=st.first_token_t,
            finish_t=now, tbts=st.tbts)
        self.completed[st.req.rid] = rec
        self._unreported.append(rec)
        self._active.pop(st.slot, None)
        heapq.heappush(self._free, st.slot)
        if self.paged:
            if self.prefix is not None and st.blocks:
                self._donate_committed(st)
            # the lane's references return to the pool at retirement (pages
            # the tree pinned survive); the cleared row deactivates the lane
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
        if st.span is not None:
            st.span.annotate(tokens=len(st.tokens)).end()
        if st.req.trace is not None:
            st.req.trace.finish(tokens=len(st.tokens),
                                engine=self.engine_id)

    # -- page lifecycle --------------------------------------------------
    def _pick_victim(self) -> _SlotState:
        """Youngest admission loses (its recomputation is cheapest); the
        oldest lane always progresses, so the engine never livelocks as
        long as the pool holds one worst-case request."""
        return max(self._active.values(), key=lambda s: (s.admit_t, s.slot))

    def _requeue_span(self, req) -> None:
        """A requeued request's wait until its re-admission (tracing)."""
        if req.trace is not None:
            req._eng_queue_span = req.trace.span(
                "engine.queue", engine=self.engine_id, requeued=True)

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
        if st.span is not None:
            st.span.annotate(preempted=True,
                             tokens_discarded=len(st.tokens)).end()
        self._requeue_span(st.req)

    def _scrub_needed(self, ids) -> List[int]:
        """The freshly allocated pages a previous owner wrote (first-touch
        pages already read INVALID); removes ``ids`` from the virgin set."""
        need = [p for p in ids if p not in self._virgin_pages]
        self._virgin_pages.difference_update(ids)
        return need

    def _alloc_urgent(self) -> Optional[List[int]]:
        """One-page urgent allocation; when the pool is dry, cold prefix
        cache is reclaimed before the caller escalates to preemption."""
        got = self.pool.alloc(1, urgent=True)
        if got is None and self.prefix is not None \
                and self.prefix.evict_pages(1):
            got = self.pool.alloc(1, urgent=True)
        return got

    def _alloc_or_preempt(self, st: _SlotState) -> Optional[int]:
        """One page for ``st``, preempting the youngest lane(s) while the
        pool is dry; None if ``st`` itself was preempted."""
        got = self._alloc_urgent()
        while got is None:
            victim = self._pick_victim()
            self._preempt(victim)
            if victim is st:
                return None
            got = self._alloc_urgent()
        return got[0]

    def _cow_pages(self, st: _SlotState, lp_first: int,
                   lp_last: int) -> bool:
        """Privatize shared pages in the lane's write window [lp_first,
        lp_last]: a fresh page, the shared page's bytes copied on the device
        (reported dirty, so evict and checkpoint stay consistent), the
        block-table entry swapped and this lane's shared reference dropped.
        Every write of this engine is in place, so no write may reach a
        shared page first.  False if the lane preempted itself."""
        for lp in range(lp_first, min(lp_last + 1, len(st.blocks))):
            old = st.blocks[lp]
            if self.pool.refcount(old) <= 1:
                continue
            new = self._alloc_or_preempt(st)
            if new is None:
                return False
            self._virgin_pages.discard(new)     # copied into whole
            src = np.full((self.pool_pages,), self.pool_pages, np.int32)
            dst = np.full((self.pool_pages,), self.pool_pages, np.int32)
            src[0], dst[0] = old, new
            self._exec("compact_pool", ("kv_pool",), ("kv_pool",),
                       const_args=(src, dst), donate=True,
                       dirty_pages={"kv_pool": (new,)}, span=self._it_root)
            self.pool.free([old])       # drop this lane's shared reference
            st.blocks[lp] = new
            self._bt_set_cell(st.slot, lp, new)
            self.cow_copies += 1
            self.registry.record_event("engine_cow", rid=st.req.rid,
                                       slot=st.slot, page_from=old,
                                       page_to=new, engine=self.engine_id)
        return True

    def _append_pages(self) -> None:
        """Token-granularity growth: map the page(s) each lane's next write
        window lands in — one page for plain decode, the k-step span for
        fused decode, up to the ``k+1``-token lookahead for speculative
        decode (capped at the tokens the lane can still commit) — copying
        shared pages in the window first and preempting the youngest
        lane(s) when the pool runs dry."""
        scrub_ids: List[int] = []
        for slot in sorted(self._active):
            st = self._active.get(slot)
            if st is None:
                continue                # preempted by an earlier append
            if self.spec is not None:
                span_tok = min(self.spec_k_now + 1,
                               st.limit - len(st.tokens))
            elif self._pipelined:
                span_tok = min(self.fuse_steps, st.limit - st.submitted)
                if span_tok <= 0:
                    continue    # fully submitted: awaiting pipeline commit
            else:
                span_tok = 1
            lp_first = st.pos // self.page_size
            lp_last = (st.pos + span_tok - 1) // self.page_size
            if self.prefix is not None and not self._cow_pages(
                    st, lp_first, lp_last):
                continue                # st preempted itself during COW
            for lp in range(len(st.blocks), lp_last + 1):
                # urgent: appends may dip into the admission reserve
                page = self._alloc_or_preempt(st)
                if page is None:
                    break               # st preempted itself: all freed
                st.blocks.append(page)
                self._bt_set_cell(slot, lp, page)
                scrub_ids.append(page)
        scrub_ids = self._scrub_needed(scrub_ids)
        if scrub_ids:
            assert len(scrub_ids) <= self._scrub_width
            ids = np.full((self._scrub_width,), self.pool_pages, np.int32)
            ids[:len(scrub_ids)] = scrub_ids
            self._exec("scrub", ("kv_pool",), ("kv_pool",),
                       const_args=(ids,), donate=True,
                       dirty_pages={"kv_pool": tuple(scrub_ids)},
                       span=self._it_root)

    def compact(self) -> dict:
        """Defragment the pool: pack used pages into the lowest physical
        ids.  Call between iterations only."""
        if not self.paged:
            return {"moved": 0}
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
                       dirty_pages={"kv_pool": tuple(mapping.values())},
                       span=self._it_root)
            for st in self._active.values():
                st.blocks = [mapping.get(p, p) for p in st.blocks]
                self._bt_host[st.slot, :len(st.blocks)] = st.blocks
            if self.prefix is not None:
                # every owner of a moved page follows the same mapping:
                # lanes above, the tree here
                self.prefix.remap(mapping)
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
            self._write("block_table", self._bt_host.copy(),
                        span=self._it_root)
            self.bt_full_writes += 1
        else:
            delta = np.full((self._bt_delta_width, 3), -1, np.int32)
            if self._bt_delta:
                delta[:len(self._bt_delta)] = self._bt_delta
            self._exec("bt_update", ("block_table",), ("block_table",),
                       const_args=(delta,), donate=True,
                       span=self._it_root)
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
                self._write("toks", toks_h, span=self._it_root)
                self._write("pos", pos_h, span=self._it_root)
                self._resync_lanes = False
            dirty = {"kv_pool": self._dirty_window(kf)}
            if kf > 1:
                delta = self._bt_take_delta()
                exec_c = self._exec(
                    "decode_multi",
                    ("params", "toks", "pos", "block_table", "kv_pool"),
                    ("fused_toks", "toks", "pos", "block_table", "kv_pool"),
                    donate=True, const_args=(lims, delta),
                    dirty_pages=dirty, span=self._it_root)
                read_c = self._read_async("fused_toks", span=self._it_root)
            else:
                self._flush_block_table()
                exec_c = self._exec(
                    "decode_step",
                    ("params", "toks", "pos", "block_table", "kv_pool"),
                    ("toks", "pos", "kv_pool"), donate=True,
                    dirty_pages=dirty, span=self._it_root)
                read_c = self._read_async("toks", span=self._it_root)
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
            if st.deferred_insert is not None:
                # the prefix insert parked at admission needs the first
                # token, which only just arrived
                b, flat, ids = st.deferred_insert
                self.prefix.insert(b, flat, ids, tok)
                st.deferred_insert = None
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
        if self.paged:
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
                if st.span is not None:
                    st.span.annotate(unadmitted=True).end()
                self._requeue_span(st.req)
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

    # -- one speculative iteration: draft k, verify k+1, commit/rollback -
    def _spec_iteration(self) -> int:
        k = self.spec_k_now
        self._flush_block_table()
        # host-authoritative lane state (acceptance is decided here)
        self._write("toks", self._toks_host.copy(), span=self._it_root)
        self._write("pos", self._pos_host.copy(), span=self._it_root)
        self._exec(f"draft_lookahead_k{k}",
                   ("draft_params", "toks", "pos", "draft_caches"),
                   (f"draft_toks_k{k}", "draft_caches"), donate=True,
                   span=self._it_root)
        # every page the verify can write is dirty, partially accepted ones
        # included: evict must save them whole
        self._exec(f"verify_step_k{k}",
                   ("params", "toks", f"draft_toks_k{k}", "pos",
                    "block_table", "kv_pool"),
                   (f"verify_toks_k{k}", "kv_pool"), donate=True,
                   dirty_pages={"kv_pool": self._dirty_window(k + 1)},
                   span=self._it_root)
        # token delivery doubles as the iteration's sync point
        target = np.asarray(self._read(f"verify_toks_k{k}",
                                       span=self._it_root))
        drafts = np.asarray(self._read(f"draft_toks_k{k}",
                                       span=self._it_root))
        now = self._clock()
        ps = self.page_size
        decoded = 0
        self.spec_iterations += 1
        for st in list(self._active.values()):
            remaining = st.limit - len(st.tokens)
            g, d = target[st.slot], drafts[st.slot]
            m = 0
            while m < k and int(d[m]) == int(g[m]):
                m += 1
            ncommit = min(m + 1, remaining)
            offered = min(k, remaining - 1)
            self.spec_offered_drafts += offered
            self.spec_accepted_drafts += min(m, offered)
            self._adapt_offered += offered
            self._adapt_accepted += min(m, offered)
            self.spec_lane_iterations += 1
            self.spec_committed += ncommit
            self._commit_tokens(st, g[:ncommit], now)
            self._toks_host[st.slot, 0] = st.tokens[-1]
            self._pos_host[st.slot] = st.pos
            decoded += ncommit
            # rollback: free the orphaned lookahead tail, the pages wholly
            # past the last committed entry (the kept tail page may hold
            # rejected writes; masking hides them until the lane
            # overwrites them in order)
            keep = (st.pos + ps - 1) // ps
            if len(st.blocks) > keep:
                freed = self.pool.free_tail(st.blocks, keep)
                for lp in range(keep, len(st.blocks)):
                    self._bt_set_cell(st.slot, lp, -1)
                del st.blocks[keep:]
                self.registry.record_event(
                    "engine_spec_rollback", rid=st.req.rid, slot=st.slot,
                    freed=len(freed), engine=self.engine_id)
            if len(st.tokens) >= st.limit:
                self._retire(st, now)
        self._c_tokens.inc(decoded)
        if self._publish_gauges and self.spec_offered_drafts:
            self._g_spec.set(self.spec_accepted_drafts
                             / self.spec_offered_drafts)
        self._adapt_spec_k()
        return decoded

    def _adapt_spec_k(self) -> None:
        """Dynamic lookahead: every ``adapt_window`` offered drafts, read the
        window's accept rate and resize the live ``k`` — one step down below
        ``shrink_below``, one step up after two windows in a row at or
        above ``grow_above``.  Only throughput changes."""
        spec = self.spec
        if spec is None or not spec.dynamic_k:
            return
        if self._adapt_offered < spec.adapt_window:
            return
        rate = self._adapt_accepted / self._adapt_offered
        self._adapt_offered = self._adapt_accepted = 0
        prev = self.spec_k_now
        if rate < spec.shrink_below:
            self._grow_streak = 0
            self.spec_k_now = max(spec.k_min, self.spec_k_now - 1)
        elif rate >= spec.grow_above:
            self._grow_streak += 1
            if self._grow_streak >= 2:
                self._grow_streak = 0
                self.spec_k_now = min(self.spec_k, self.spec_k_now + 1)
        else:
            self._grow_streak = 0
        if self.spec_k_now != prev:
            if self._publish_gauges:
                self._g_spec_k.set(self.spec_k_now)
            self.registry.record_event(
                "engine_spec_k_adapt", engine=self.engine_id,
                k_from=prev, k_to=self.spec_k_now, window_rate=rate)

    def kv_stats(self) -> dict:
        """Cache-memory occupancy in the shared byte accounting (the
        reference's keys).  A paged pool here holds one page more than the
        reference's, the sink page that takes the writes the reference
        drops: ``pool_bytes`` counts it, so it is the reference's
        ``pool_bytes`` plus one ``page_bytes``; the page counts, bytes in
        use, occupancy and span are over the ``pool_pages`` real pages, as
        the reference's."""
        if not self.paged:
            return {"paged": False, "pool_bytes": self.pool_bytes,
                    "bytes_in_use": self.pool_bytes, "occupancy": 1.0}
        used = self.pool.used_count()
        return {"paged": True, "pool_bytes": self.pool_bytes,
                "page_bytes": self.page_bytes,
                "pages_used": used, "pages_free": self.pool.free_count(),
                "bytes_in_use": used * self.page_bytes,
                "occupancy": self.pool.occupancy(),
                "used_span": self.pool.used_span()}

    def spec_stats(self) -> dict:
        """Speculation accounting (zeros when spec is off)."""
        lane_iters = max(self.spec_lane_iterations, 1)
        offered = max(self.spec_offered_drafts, 1)
        return {
            "k": self.spec_k,
            "k_now": self.spec_k_now,
            "iterations": self.spec_iterations,
            "lane_iterations": self.spec_lane_iterations,
            "committed_tokens": self.spec_committed,
            "tokens_per_lane_iteration": self.spec_committed / lane_iters,
            "accept_rate": self.spec_accepted_drafts / offered,
        }

    def prefix_stats(self) -> dict:
        """Prefix-cache effectiveness (zeros when the cache is off)."""
        out = {"hits": self.prefix_hits,
               "partial_hits": self.prefix_partial_hits,
               "misses": self.prefix_misses,
               "prompt_tokens": self.prefix_prompt_tokens,
               "cached_tokens": self.prefix_cached_tokens,
               "hit_rate": (self.prefix_cached_tokens
                            / max(self.prefix_prompt_tokens, 1)),
               "cow_copies": self.cow_copies}
        if self.prefix is not None:
            out.update(self.prefix.stats())
        return out

    def prefix_match_len(self, prompt) -> int:
        """Router probe: how many of this prompt's (padded) tokens the
        engine's tree would serve from cache.  Read-only and lock-guarded,
        so any router thread may call it against any replica."""
        if self.prefix is None:
            return 0
        bucket = self._pick_bucket(np.asarray(prompt).reshape(-1).shape[0])
        padded = self._pad_prompt(prompt, bucket).reshape(-1)
        return self.prefix.match_len(bucket, padded)

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
        it_tr = None
        if self.tracer is not None and (self._active or self.pending):
            it_tr = self.tracer.start_trace(
                "engine.step",
                trace_id=f"{self.engine_id}:it{self.iterations}",
                engine=self.engine_id)
            self._it_root = it_tr.root
        preempts0, compacts0 = self.preemptions, self.auto_compactions
        decoded = 0
        if self.paged:
            if self._inflight and self._should_auto_compact():
                # compaction remaps physical pages: commit the pipelined
                # batches first (their EXECUTEs hold the old ids)
                decoded += self._drain_pipeline()
            self._maybe_auto_compact()
        self._mid_step = True
        try:
            admitted = self._admit()
            self.peak_active = max(self.peak_active, len(self._active))
            if self._active and self.paged:
                self._append_pages()
            if self._active and self.spec is not None:
                decoded += self._spec_iteration()
            elif self._pipelined:
                if self._active or self._inflight:
                    decoded += self._fused_iteration()
            elif self._active:
                if self.paged:
                    self._flush_block_table()
                    self._exec(
                        "decode_step",
                        ("params", "toks", "pos", "block_table", "kv_pool"),
                        ("toks", "pos", "kv_pool"), donate=True,
                        dirty_pages={"kv_pool": self._dirty_window(1)},
                        span=self._it_root)
                else:
                    self._exec("decode_step",
                               ("params", "toks", "pos", "caches"),
                               ("toks", "pos", "caches"), donate=True,
                               span=self._it_root)
                # token delivery doubles as the iteration's sync point
                toks = np.asarray(self._read("toks", span=self._it_root))
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
        device_s = self._attribute(time.perf_counter() - t_step0,
                                   decoded + admitted)
        if it_tr is not None:
            it_tr.finish(admitted=admitted, decoded=decoded,
                         active=len(self._active),
                         preemptions=self.preemptions - preempts0,
                         auto_compactions=self.auto_compactions - compacts0,
                         device_s=device_s)
            self._it_root = None
        if self._publish_gauges:
            self._g_queue.set(len(self.pending))
            self._g_util.set(len(self._active) / self.slots)
            if self.paged:
                self._g_kv.set(self.pool.occupancy())
                if self.prefix is not None:
                    # tree-only pages are one eviction away from free:
                    # advertising them keeps KV-aware routing from treating
                    # a warm cache as memory pressure
                    self._g_kv_free.set(self.pool.free_count()
                                        + self.prefix.reclaimable_pages())
                    if self.prefix_prompt_tokens:
                        self._g_prefix.set(self.prefix_cached_tokens
                                           / self.prefix_prompt_tokens)
                else:
                    self._g_kv_free.set(self.pool.free_count())
        return {"admitted": admitted, "decoded": decoded,
                "active": len(self._active), "pending": len(self.pending)}

    def _attribute(self, wall: float, tokens: int) -> float:
        """Fold this step's finished completions into the host/device
        split; an unfinished one (a pipelined EXECUTE) carries over, so a
        late failure surfaces exactly once.  Returns the step's device
        seconds."""
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
        return device_s

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
        for st in self._active.values():
            if st.span is not None:
                st.span.annotate(evacuated=True).end()
        for req in reqs:
            qsp = getattr(req, "_eng_queue_span", None)
            if qsp is not None:
                qsp.annotate(evacuated=True).end()
                req._eng_queue_span = None
            if req.trace is not None:
                # a handle for the router to link the post-requeue trace
                # back to this one (the recovery timeline)
                req._prev_trace = req.trace
                req.trace.finish(evacuated=True, engine=self.engine_id)
                req.trace = None        # traced anew on resubmission
        self._active.clear()
        self.pending.clear()
        # in-flight pipelined tokens die with the lanes: the requests are
        # requeued whole and recompute deterministically elsewhere
        self._inflight.clear()
        self._resync_lanes = False
        self._free = list(range(self.slots))
        heapq.heapify(self._free)
        self._first_token.clear()
        if self.paged:
            self.pool = BlockPool(self.pool_pages, self.page_size,
                                  reserve_pages=self.pool.reserve_pages)
            # the device pool keeps the dead lanes' bytes: nothing is
            # first-touch clean for whoever reuses this engine
            self._virgin_pages = set()
            if self.prefix is not None:
                # the old pool and every tree reference into it die with
                # the evacuation; the index restarts cold
                self.prefix = PrefixCache(self.pool, self.page_size,
                                          max_nodes=self._prefix_max_nodes)
            self._bt_host[:] = -1
            self._bt_mark_full()
            if self.spec is not None:
                self._toks_host[:] = 0
                self._pos_host[:] = 0
            if self._publish_gauges:
                # a dead engine must not pin the pressure signal at its
                # last value, nor outrank live replicas in KV-aware routing;
                # the spec and prefix gauges become NaN tombstones that the
                # service-level folds skip
                self._g_kv.set(0.0)
                self._g_kv_free.set(0.0)
                if self.spec is not None:
                    self._g_spec.set(float("nan"))
                    self._g_spec_k.set(float("nan"))
                if self.prefix is not None:
                    self._g_prefix.set(float("nan"))
        return reqs

    # ------------------------------------------------------------------
    # Disaggregated serving: the KV lane handoff between role replicas
    # ------------------------------------------------------------------
    def attach_transfer(self, queue) -> None:
        """Join a ``TransferQueue``: the prefill side offers freshly
        prefilled lanes, the decode side drains them.  Needs a declared
        role: mixed engines never hand lanes off."""
        if self.role == "mixed":
            raise ValueError("attach_transfer needs role='prefill' or "
                             "'decode'")
        self.transfer = queue
        queue.register(self)

    def exportable_lanes(self) -> List[_SlotState]:
        """Active lanes a prefill replica could hand off now: the first
        token is committed, no EXECUTE in flight references the lane, every
        submitted token is committed, the request has tokens left to
        generate and no prefix insert is parked on it.  A lane that missed
        the window keeps decoding here and is offered again at the next
        step boundary."""
        out = []
        for slot in sorted(self._active):
            st = self._active[slot]
            if (st.tokens and st.inflight == 0
                    and st.submitted == len(st.tokens)
                    and len(st.tokens) < st.limit
                    and st.deferred_insert is None):
                out.append(st)
        return out

    def export_lane(self, st: _SlotState):
        """Serialize an in-flight lane for a decode replica: gather its
        pages into the staging buffer (one EXECUTE), read them back to the
        host, then release the lane (committed pages donated to the prefix
        tree first, as at retirement; the slot frees).  The request is not
        completed here: the importer continues it mid-decode."""
        from repro_torch.serve.disagg import KVHandoff

        rid = st.req.rid
        ids = np.full((self.max_blocks,), self.pool_pages, np.int32)
        ids[:len(st.blocks)] = st.blocks
        xsp = (st.req.trace.span("engine.handoff_out",
                                 engine=self.engine_id, slot=st.slot,
                                 pages=len(st.blocks))
               if st.req.trace is not None else None)
        self._exec("xfer_extract", ("kv_pool",), ("xfer_pages",),
                   const_args=(ids,), span=xsp)
        # the monitor's d2h copy: CPU tensors, shared with nothing that
        # writes them (the buffer's next read makes a new copy)
        pages = self._read("xfer_pages", span=xsp)
        if xsp is not None:
            xsp.end()
        handoff = KVHandoff(
            req=st.req, rid=rid, tokens=st.tokens, tbts=st.tbts,
            pos=st.pos, bucket=st.bucket, limit=st.limit,
            n_pages=len(st.blocks), pages=pages, admit_t=st.admit_t,
            first_token_t=self._first_token.get(rid, st.first_token_t),
            last_token_t=st.last_token_t,
            src_engine=self.engine_id, export_t=self._clock())
        if self.prefix is not None and st.blocks:
            # the handed-off request's own OOM recompute (or a sibling
            # prompt) still hits here
            self._donate_committed(st)
        self.pool.free(st.blocks)
        self._bt_clear_row(st.slot)
        self._active.pop(st.slot, None)
        heapq.heappush(self._free, st.slot)
        self._first_token.pop(rid, None)
        if st.span is not None:
            st.span.annotate(handed_off=True, tokens=len(st.tokens)).end()
        self.registry.record_event("engine_handoff_out", rid=rid,
                                   slot=st.slot, engine=self.engine_id,
                                   pages=handoff.n_pages)
        return handoff

    def import_lane(self, handoff) -> bool:
        """Install a handed-off lane: allocate pages, upload and scatter the
        staged pages (whole pages overwritten, so no scrub), set the lane's
        token and position, and resume decode mid-request.  Returns False,
        with no side effect, when there is no slot or page room."""
        if not self._free:
            return False
        n = handoff.n_pages
        if n > self.max_blocks or not self.pool.can_admit(n):
            return False
        page_ids = self.pool.alloc(n)
        if page_ids is None:
            return False
        page_ids = [int(p) for p in page_ids]
        self._virgin_pages.difference_update(page_ids)
        slot = heapq.heappop(self._free)
        # the row ships with the next decode EXECUTE (block-table delta),
        # after the install and lane_set below in the monitor's FIFO
        self._bt_set_row(slot, page_ids)
        try:
            imp = (handoff.req.trace.span("engine.handoff_in",
                                          engine=self.engine_id, slot=slot,
                                          pages=n)
                   if handoff.req.trace is not None else None)
            W = self.max_blocks

            def fit(leaf):
                # replicas may be provisioned with different max_blocks:
                # pad or trim the staging width (padding never installs:
                # its ids go to the sink)
                if leaf.shape[0] >= W:
                    return leaf[:W]
                pad = torch.zeros((W - leaf.shape[0],) + tuple(leaf.shape[1:]),
                                  dtype=leaf.dtype)
                return torch.cat([leaf, pad], 0)

            staged = tree_map(fit, handoff.pages)
            ids = np.full((W,), self.pool_pages, np.int32)
            ids[:n] = page_ids
            self._write("xfer_pages", staged, span=imp)
            self._exec("xfer_install", ("kv_pool", "xfer_pages"),
                       ("kv_pool",), const_args=(ids,), donate=True,
                       dirty_pages={"kv_pool": tuple(page_ids)}, span=imp)
            self._exec("lane_set", ("toks", "pos"), ("toks", "pos"),
                       const_args=(np.int32(handoff.tokens[-1]),
                                   np.int32(handoff.pos), np.int32(slot)),
                       donate=True, span=imp)
            if imp is not None:
                imp.end()
        except BaseException:
            self.pool.free(page_ids)
            self._bt_clear_row(slot)
            heapq.heappush(self._free, slot)
            raise
        st = _SlotState(req=handoff.req, slot=slot, tokens=handoff.tokens,
                        tbts=handoff.tbts, admit_t=handoff.admit_t,
                        first_token_t=handoff.first_token_t,
                        last_token_t=handoff.last_token_t,
                        limit=handoff.limit, bucket=handoff.bucket,
                        pos=handoff.pos, blocks=page_ids,
                        submitted=len(handoff.tokens),
                        span=(handoff.req.trace.span(
                            "engine.decode", engine=self.engine_id,
                            slot=slot, imported=True)
                            if handoff.req.trace is not None else None))
        handoff.req.committed = st.tokens   # re-alias: crash replay
        # seed the TTFT ledger so neither this engine's commits nor an
        # OOM-preempt recompute here observe TTFT a second time
        self._first_token[handoff.req.rid] = handoff.first_token_t
        self._active[slot] = st
        self.registry.record_event("engine_handoff_in",
                                   rid=handoff.req.rid, slot=slot,
                                   engine=self.engine_id, pages=n)
        return True

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
        if self.prefix is not None and admit:
            # advertise this replica's prefix-cache warmth so the router
            # can steer repeat prefixes here (idempotent)
            router.register_prefix_probe(self.engine_id,
                                         self.prefix_match_len)
        reg_role = getattr(router, "register_engine_role", None)
        if reg_role is not None and admit:
            # declare this replica's role, so the router sends fresh
            # prompts to prefill replicas only (idempotent)
            reg_role(self.engine_id, self.role, self.buckets)
        if self.transfer is not None and self.role == "decode":
            # install admitted handoffs into free slots before stepping
            self.transfer.pump_dest(self)
        if admit:
            for req in router.pop(len(self._free), engine_id=self.engine_id):
                self.submit(req)
        moved = bool(self._active or self.pending)
        if moved:
            self.step()
        if self.transfer is not None and self.role == "prefill":
            # offer freshly prefilled lanes at the step boundary; lanes the
            # queue refuses keep decoding here (aggregated fallback)
            self.transfer.pump_source(self)
        for rec in self.drain_completions():
            router.complete(rec)
        return moved
