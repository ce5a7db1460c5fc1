"""Program ("bitstream") registry and "compile" cache.

An FPGA bitstream maps to a program: a Python function over tensors that
runs eagerly on the slice's device.  There is no ``jax.jit``: the
"compile" is the first keyed lookup, which records the argument signature
(shapes/dtypes) and the donated arguments; later lookups with the same key
are warm hits.  Stats feed the same counters as the reference.

Donation: a program that writes some of its arguments in place declares
them in ``inplace_argnums``; an EXECUTE must donate those (the monitor
donates inputs that are also outputs), or the lookup raises.
"""

from __future__ import annotations

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
        return self._programs[program_id]

    def get_or_compile(self, program_id: str, abstract_args: tuple,
                       donate_argnums: tuple = ()) -> CompiledEntry:
        """Entry for ``fn`` at the given abstract args (cached on the
        signature fingerprint and the donated argnums)."""
        prog = self._programs[program_id]
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
