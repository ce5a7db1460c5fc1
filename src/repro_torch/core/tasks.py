"""Guest tasks: the "unikernel applications" of this framework.

Tasks are written against the FunkyCL API only — they allocate on
``cl.device`` and reach it through the monitor.  They are *step-wise
resumable*: ``setup()`` builds programs and buffers (or re-attaches after
restore), ``step()`` performs one preemptible unit of work.  The runtime's
driver thread calls ``step()`` in a loop; all orchestration (evict/resume)
lands between steps plus a monitor-level SYNC — the paper's
request-boundary preemption model.

The serving guest ``ServeTask`` is ported; training and the
continuous-batching engine come with their slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.core.guest import FunkyCL
from repro_torch.core.programs import Program
from repro_torch.core.state import GuestState
from repro_torch.train import make_batch


@dataclass
class TaskImage:
    """The "OCI image" of a task: guest binary + config."""

    name: str
    kind: str                       # serve (train | engine-serve: later)
    arch: str = "yi-9b-smoke"
    global_batch: int = 4
    total_steps: int = 8
    tokens_per_step: int = 4        # serve: decode tokens per step() call
    prompt_len: int = 16
    seed: int = 0

    def instantiate(self) -> "GuestTask":
        if self.kind == "serve":
            return ServeTask(self)
        raise NotImplementedError(f"task kind {self.kind!r} is not ported yet")


class GuestTask:
    image: TaskImage

    def setup(self, cl: FunkyCL, gs: GuestState, restore: bool) -> None:
        raise NotImplementedError

    def step(self, cl: FunkyCL, gs: GuestState) -> bool:
        """One preemptible unit of work; returns True when finished."""
        raise NotImplementedError

    def teardown(self, cl: FunkyCL, gs: GuestState) -> None:
        pass


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
