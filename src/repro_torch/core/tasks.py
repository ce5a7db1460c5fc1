"""Guest tasks: the "unikernel applications" of this framework.

Tasks are written against the FunkyCL API only — they allocate on
``cl.device`` and reach it through the monitor.  They are *step-wise
resumable*: ``setup()`` builds programs and buffers (or re-attaches after
restore), ``step()`` performs one preemptible unit of work.  The runtime's
driver thread calls ``step()`` in a loop; all orchestration
(evict/resume/migrate/checkpoint) lands between steps plus a monitor-level
SYNC — the paper's request-boundary preemption model.

``TrainTask`` uses the *chunked* train functions (paper §3.4 data
splitting): one logical optimizer step = K microbatch EXECUTE requests + one
apply EXECUTE, so preemption waits at most one microbatch (Fig 9).
``ServeTask`` decodes one fixed batch over reserved caches;
``EngineServeTask`` is a continuous-batching engine replica fed by the
service's ``RequestRouter``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.core.guest import FunkyCL
from repro_torch.core.programs import Program
from repro_torch.core.state import GuestState
from repro_torch.train import (OptConfig, init_opt_state, make_batch,
                               make_chunked_train_fns, make_train_state)


@dataclass
class TaskImage:
    """The "OCI image" of a task: guest binary + config."""

    name: str
    kind: str                       # train | serve | engine-serve
    arch: str = "yi-9b-smoke"
    seq_len: int = 32               # train: tokens per sequence
    global_batch: int = 4           # engine-serve: decode lanes
    total_steps: int = 8
    chunks: int = 2                 # train: microbatches per step
    tokens_per_step: int = 4        # serve: decode tokens per step() call
    prompt_len: int = 16
    seed: int = 0
    # engine-serve: per-request cap and paged KV memory (None/() keep the
    # engine's defaults)
    max_new_tokens: int = 8
    page_size: int = 8
    kv_pool_pages: Optional[int] = None
    prompt_buckets: tuple = ()      # e.g. (128, 512); empty = (prompt_len,)
    fuse_steps: int = 1             # greedy steps per decode EXECUTE
    async_depth: int = 0            # decode EXECUTEs submitted ahead
    opt: OptConfig = field(default_factory=lambda: OptConfig(
        warmup_steps=2, decay_steps=100))

    def instantiate(self) -> "GuestTask":
        if self.kind == "train":
            return TrainTask(self)
        if self.kind == "serve":
            return ServeTask(self)
        if self.kind == "engine-serve":
            return EngineServeTask(self)
        raise ValueError(self.kind)


class GuestTask:
    image: TaskImage

    def setup(self, cl: FunkyCL, gs: GuestState, restore: bool) -> None:
        raise NotImplementedError

    def step(self, cl: FunkyCL, gs: GuestState) -> bool:
        """One preemptible unit of work; returns True when finished."""
        raise NotImplementedError

    def teardown(self, cl: FunkyCL, gs: GuestState) -> None:
        pass

    def on_update(self, vfpga_num: int) -> None:
        """Vertical-scaling hook (the runtime's ``update`` command)."""

    def on_kill(self) -> None:
        """Graceful-kill hook, run once the task's driver thread stopped:
        release any work the task holds that outlives it (e.g. requeue
        in-flight requests).  A crash never runs it."""

    def drain(self) -> None:
        """Graceful-decommission hook: stop taking new work and finish what
        is already held.  Tasks without a notion of draining ignore it."""

    @property
    def drained(self) -> bool:
        """True once a draining task holds no unfinished work."""
        return True

    def program_ids(self) -> tuple:
        """Program ("bitstream") ids this guest compiles; empty means
        unknown (e.g. before setup)."""
        return ()


class TrainTask(GuestTask):
    """Chunked training: each ``step()`` submits one microbatch EXECUTE
    (``grad_step``), and the last chunk of a logical step also ``apply``.

    Programs: ``init_state`` (weights from ``image.seed`` and zero moments
    on the device), ``grad_init`` (a zero accumulator), ``grad_step`` (adds
    one microbatch's gradients into ``grad_acc`` in place) and ``apply``
    (AdamW on the averaged gradient, ``params`` and ``opt_state`` updated
    in place); their EXECUTEs donate the buffers they update.  Buffers:
    ``params``, ``opt_state``, ``grad_acc``, ``batch``, ``loss``,
    ``grad_norm``."""

    PROGRAMS = ("init_state", "grad_init", "grad_step", "apply")

    def __init__(self, image: TaskImage):
        self.image = image
        self.cfg = get_arch(image.arch)
        self.shape = ShapeConfig("task", "train", image.seq_len,
                                 image.global_batch)

    def program_ids(self) -> tuple:
        return self.PROGRAMS

    def _build_programs(self, device: torch.device):
        from repro_torch.models import build_model

        bundle = build_model(self.cfg)
        oc = self.image.opt
        grad_init, grad_step, apply_step = make_chunked_train_fns(bundle, oc)

        def init_state(seed):
            return make_train_state(bundle, oc, seed, device=device)

        def apply_fn(params, opt_state, grad_acc):
            p, o, stats = apply_step(params, opt_state, grad_acc,
                                     self.image.chunks)
            return p, o, stats["grad_norm"]

        self._bundle = bundle
        self._grad_init = grad_init
        self._progs = {
            "init_state": Program("init_state", init_state),
            "grad_init": Program("grad_init", grad_init),
            "grad_step": Program("grad_step", grad_step,
                                 inplace_argnums=(1,)),
            "apply": Program("apply", apply_fn, inplace_argnums=(0, 1)),
        }

    def _abstracts(self):
        """Shapes of params, opt_state, grad_acc and one microbatch, as
        meta tensors (nothing allocated)."""
        meta = torch.device("meta")
        params_abs = self._bundle.init(0, device=meta)
        opt_abs = init_opt_state(self.image.opt, params_abs)
        grad_abs = self._grad_init(params_abs)
        mb = (self.image.global_batch // self.image.chunks,
              self.image.seq_len)
        mb_abs = {k: torch.empty(mb, dtype=torch.int32, device=meta)
                  for k in ("tokens", "targets")}
        return params_abs, opt_abs, grad_abs, mb_abs

    def setup(self, cl: FunkyCL, gs: GuestState, restore: bool) -> None:
        self._build_programs(cl.device)
        params_abs, opt_abs, grad_abs, mb_abs = self._abstracts()
        cl.clCreateProgramWithBinary(self._progs["init_state"], (0,))
        cl.clCreateProgramWithBinary(self._progs["grad_init"], (params_abs,))
        cl.clCreateProgramWithBinary(
            self._progs["grad_step"], (params_abs, grad_abs, mb_abs),
            donate_argnums=(1,))
        cl.clCreateProgramWithBinary(
            self._progs["apply"], (params_abs, opt_abs, grad_abs),
            donate_argnums=(0, 1))
        if not restore:
            meta = torch.device("meta")
            scalar = torch.empty((), dtype=torch.float32, device=meta)
            cl.clCreateBuffer("params", params_abs)
            cl.clCreateBuffer("opt_state", opt_abs)
            cl.clCreateBuffer("grad_acc", grad_abs)
            cl.clCreateBuffer("batch", mb_abs)
            cl.clCreateBuffer("loss", scalar)
            cl.clCreateBuffer("grad_norm", scalar)
            cl.clEnqueueKernel("init_state", (), ("params", "opt_state"),
                               const_args=(self.image.seed,))
            cl.clFinish()

    def step(self, cl: FunkyCL, gs: GuestState) -> bool:
        """One *chunk* of a logical optimizer step (paper §3.4 splitting).

        Each driver-loop iteration submits exactly one microbatch EXECUTE,
        so preemption waits at most one chunk — and a task evicted mid-
        accumulation resumes bit-exactly: ``chunk_idx`` lives in the guest
        (VM) state and ``grad_acc`` is a DIRTY tracked buffer."""
        k = self.image.chunks
        ci = gs.user.get("chunk_idx", 0)
        if ci == 0:
            cl.clEnqueueKernel("grad_init", ("params",), ("grad_acc",))
        full = make_batch(self.cfg, self.shape, gs.step,
                          batch_override=self.image.global_batch)
        mb_size = self.image.global_batch // k
        cl.write_buffer("batch", {key: x[ci * mb_size:(ci + 1) * mb_size]
                                  for key, x in full.items()})
        cl.clEnqueueKernel("grad_step", ("params", "grad_acc", "batch"),
                           ("grad_acc", "loss"), donate=True)
        if ci + 1 < k:
            cl.clFinish()
            gs.user["chunk_idx"] = ci + 1
            return False
        cl.clEnqueueKernel("apply", ("params", "opt_state", "grad_acc"),
                           ("params", "opt_state", "grad_norm"), donate=True)
        cl.clFinish()
        gs.user["chunk_idx"] = 0
        gs.step += 1
        gs.data_position = gs.step
        return gs.step >= self.image.total_steps

    def teardown(self, cl: FunkyCL, gs: GuestState) -> None:
        gs.user["final_loss"] = float(cl.read_buffer("loss"))
        # read results out before releasing: the monitor zeroes device
        # memory on vfpga_exit (paper §3.4 isolation).  Host-side only;
        # never in a manifest (checkpoints only happen while RUNNING).
        gs.user["final_params"] = cl.read_buffer("params")
        for pid in self.PROGRAMS:
            cl.clReleaseProgram(pid)


class ServeTask(GuestTask):
    """Batched greedy decoding service; one step() = tokens_per_step tokens.

    Programs: ``init_params`` (weights drawn on the device from
    ``image.seed``), ``prefill`` (``lm_prefill``: K2 for attention layers,
    K3 for Mamba2 layers, K4 for RG-LRU layers) and ``decode``
    (``lm_decode``: K1 for attention layers).  ``decode`` writes the caches
    (KV ring, SSM and RG-LRU states, conv windows) in place, so its
    EXECUTEs donate the buffers they update."""

    PROGRAMS = ("init_params", "prefill", "decode")

    def __init__(self, image: TaskImage):
        self.image = image
        self.cfg = get_arch(image.arch)

    def program_ids(self) -> tuple:
        return self.PROGRAMS

    def _build_programs(self, device: torch.device):
        from repro_torch.models import build_model

        bundle = build_model(self.cfg)

        def init_params(seed):
            return bundle.init(seed, device=device)

        def prefill(params, tokens):
            logits, caches = bundle.prefill_fn(params, {"tokens": tokens})
            tok = logits.argmax(dim=-1).to(torch.int32)
            pos = torch.tensor(tokens.shape[1], dtype=torch.int32,
                               device=tokens.device)
            return tok, pos, caches

        def decode(params, token, pos, caches):
            logits, caches = bundle.decode_fn(params, token, pos, caches,
                                              inplace=True)
            return logits.argmax(dim=-1).to(torch.int32), pos + 1, caches

        self._bundle = bundle
        self._progs = {
            "init_params": Program("init_params", init_params),
            "prefill": Program("prefill", prefill),
            "decode": Program("decode", decode, inplace_argnums=(3,)),
        }

    def setup(self, cl: FunkyCL, gs: GuestState, restore: bool) -> None:
        self._build_programs(cl.device)
        im = self.image
        meta = torch.device("meta")
        # abstract shapes without allocating: parameters on the meta
        # device, caches from their specs (capacity prompt + margin)
        params_abs = self._bundle.init(0, device=meta)
        toks_abs = torch.empty((im.global_batch, im.prompt_len),
                               dtype=torch.int32, device=meta)
        tok_abs = torch.empty((im.global_batch,), dtype=torch.int32,
                              device=meta)
        pos_abs = torch.empty((), dtype=torch.int32, device=meta)
        caches_abs = self._bundle.cache_specs(
            im.global_batch, im.prompt_len + self._bundle.cache_margin)
        cl.clCreateProgramWithBinary(self._progs["init_params"], (0,))
        cl.clCreateProgramWithBinary(self._progs["prefill"],
                                     (params_abs, toks_abs))
        # decode's in_buffs (params, token, pos, caches) that are also its
        # outputs are donated: argnums 1, 2, 3
        cl.clCreateProgramWithBinary(
            self._progs["decode"], (params_abs, tok_abs, pos_abs, caches_abs),
            donate_argnums=(1, 2, 3))
        if not restore:
            cl.clCreateBuffer("params", params_abs)
            cl.clCreateBuffer("prompt", toks_abs)
            cl.clCreateBuffer("token", tok_abs)
            cl.clCreateBuffer("pos", pos_abs)
            cl.clCreateBuffer("caches", caches_abs)
            cl.clEnqueueKernel("init_params", (), ("params",),
                               const_args=(im.seed,))
            prompt = make_batch(self.cfg,
                                ShapeConfig("p", "train", im.prompt_len,
                                            im.global_batch), 0)["tokens"]
            cl.write_buffer("prompt", prompt)
            cl.clEnqueueKernel("prefill", ("params", "prompt"),
                               ("token", "pos", "caches"))
            cl.clFinish()

    def step(self, cl: FunkyCL, gs: GuestState) -> bool:
        for _ in range(self.image.tokens_per_step):
            cl.clEnqueueKernel("decode", ("params", "token", "pos", "caches"),
                               ("token", "pos", "caches"), donate=True)
        cl.clFinish()
        gs.step += 1
        return gs.step >= self.image.total_steps

    def teardown(self, cl: FunkyCL, gs: GuestState) -> None:
        gs.user["last_token"] = cl.read_buffer("token").tolist()
        for pid in self.PROGRAMS:
            cl.clReleaseProgram(pid)


class EngineServeTask(GuestTask):
    """Per-request serving replica: a continuous-batching engine pulling
    admissible requests from the service's ``RequestRouter`` and pushing
    engine-reported completions back.

    One ``step()`` = one engine iteration, so orchestration commands land
    between iterations and the in-flight batch is preemptible at token
    boundaries.  The task finishes when the router is closed and every
    lane has drained.  ``drain()`` stops admissions and finishes the held
    sequences, so scale-in needs no requeue.

    Restore and replicate build a new replica from a snapshot: its engine
    starts with empty lanes on the snapshot's pool.  A migrated replica
    keeps its engine, since the guest's memory (lanes, page allocator,
    block-table mirror) moves with its device context; a new engine would
    strand the requests leased to the old one.
    """

    def __init__(self, image: TaskImage):
        self.image = image
        self._engine = None
        self._draining = False

    @property
    def engine(self):
        return self._engine

    def setup(self, cl: FunkyCL, gs: GuestState, restore: bool) -> None:
        from repro_torch.scaling.serving import get_router
        from repro_torch.serve.engine import ContinuousBatchingEngine

        if restore and self._engine is not None:
            return                          # migrated whole: keep the lanes
        im = self.image
        self._router = get_router(im.name, registry=cl._monitor.telemetry)
        self._engine = ContinuousBatchingEngine(
            im.arch, cl, slots=im.global_batch, prompt_len=im.prompt_len,
            max_new_tokens=im.max_new_tokens, service=im.name,
            engine_id=cl._monitor.task_id, seed=im.seed,
            page_size=im.page_size, pool_pages=im.kv_pool_pages,
            prompt_buckets=im.prompt_buckets or None,
            fuse_steps=im.fuse_steps, async_depth=im.async_depth)
        self._engine.setup(restore=restore)

    def step(self, cl: FunkyCL, gs: GuestState) -> bool:
        moved = self._engine.pump(self._router, admit=not self._draining)
        gs.step += 1
        if self._draining and self._engine.idle:
            return True                  # drained: exit at request boundary
        if not moved:
            if self._router.closed and self._router.pending_count() == 0:
                return True
            time.sleep(0.002)            # idle poll; don't spin the monitor
        return gs.step >= self.image.total_steps

    def drain(self) -> None:
        self._draining = True

    @property
    def drained(self) -> bool:
        return self._engine is None or self._engine.idle

    def program_ids(self) -> tuple:
        return self._engine.program_ids() if self._engine is not None else ()

    def teardown(self, cl: FunkyCL, gs: GuestState) -> None:
        gs.user["completed"] = len(self._engine.completed)
        # the engine's own FunkyCL holds the program references (a
        # migrated replica's driver runs on a newer one)
        for pid in self._engine.program_ids():
            self._engine.cl.clReleaseProgram(pid)

    def on_kill(self) -> None:
        # scale-in removed this replica: report what already finished, then
        # hand unfinished sequences back to the router for another replica
        # (greedy decode: the client sees the same tokens again)
        if self._engine is None:
            return
        for rec in self._engine.drain_completions():
            self._router.complete(rec)
        reqs = self._engine.evacuate()
        if reqs:
            self._router.requeue(reqs)
