"""Program ("bitstream") registry and "compile" cache.

An FPGA bitstream maps to a program: a Python function over tensors that
runs eagerly on the slice's device.  There is no ``jax.jit``: the
"compile" is the first keyed lookup, which records the argument signature
(shapes/dtypes) and the donated arguments; later lookups with the same key
are warm hits.  Stats feed the same counters as the reference.

Donation: a program that writes some of its arguments in place declares
them in ``inplace_argnums``; an EXECUTE must donate those (the monitor
donates inputs that are also outputs), or the lookup raises.

The cache is node-wide and keyed by program id and signature, so two
tasks of different models on one node can register different programs
under one id (every task's weights come from an ``init_params``).  A
lookup therefore names the caller's own ``Program``: a warm entry counts
as a hit, but the entry returned always runs the caller's function.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict

from repro_torch.tree import tree_leaves


@dataclass
class Program:
    program_id: str
    fn: Callable
    # fn(*in_buffs_values, *const_args) -> outputs, matched positionally
    # with out_buffs; these argument positions are written in place
    inplace_argnums: tuple = ()


@dataclass
class CompiledEntry:
    compiled: Callable
    compile_seconds: float
    arg_fingerprint: str
    donate_argnums: tuple = ()


def _fingerprint(tree: Any) -> str:
    parts = [f"{tuple(getattr(l, 'shape', ()))}:"
             f"{getattr(l, 'dtype', type(l).__name__)}"
             for l in tree_leaves(tree)]
    return "|".join(parts)


class ProgramCache:
    def __init__(self):
        self._programs: Dict[str, Program] = {}
        self._compiled: Dict[tuple, CompiledEntry] = {}
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0, "compile_seconds": 0.0}

    def register(self, program: Program):
        with self._lock:
            self._programs[program.program_id] = program

    def __contains__(self, program_id: str) -> bool:
        return program_id in self._programs

    def get_program(self, program_id: str) -> Program:
        """The latest ``Program`` registered under ``program_id`` on this
        node (``get_or_compile`` runs the caller's own, see above)."""
        return self._programs[program_id]

    def get_or_compile(self, prog: Program, abstract_args: tuple,
                       donate_argnums: tuple = ()) -> CompiledEntry:
        """Entry for the caller's own ``prog`` at the given abstract args
        (cached on its program id, the signature fingerprint and the
        donated argnums)."""
        program_id = prog.program_id
        missing = set(prog.inplace_argnums) - set(donate_argnums)
        if missing:
            raise ValueError(
                f"program {program_id!r} writes arguments "
                f"{sorted(missing)} in place; they must be donated")
        fp = _fingerprint(abstract_args)
        key = (program_id, fp, tuple(donate_argnums))
        with self._lock:
            hit = self._compiled.get(key)
            if hit is not None:
                self.stats["hits"] += 1
                if hit.compiled is not prog.fn:
                    hit = dataclasses.replace(hit, compiled=prog.fn)
                return hit
        # eager PyTorch: nothing to compile; the kernels a program launches
        # are built at their first launch
        entry = CompiledEntry(compiled=prog.fn, compile_seconds=0.0,
                              arg_fingerprint=fp,
                              donate_argnums=tuple(donate_argnums))
        with self._lock:
            self._compiled[key] = entry
            self.stats["misses"] += 1
        return entry

    def program_ids(self):
        return tuple(self._programs)
