"""Reusable engine-vs-baseline bit-exactness harness (a copy of the
reference's ``serve/equivalence.py``).

The serving engine's core correctness contract is that *scheduling never
changes tokens*: continuous batching, paged memory, OOM preemption,
compaction, evict/resume and speculative decode are all pure throughput
mechanisms — the committed token stream of every request must be
bit-identical to what a plain greedy decode of that request alone would
produce.  This module packages that contract as a parameterized check so
every engine feature can assert it instead of re-growing ad-hoc
comparison loops:

* ``run_transcript`` — drive one freshly built engine over a workload to
  completion and return ``{rid: [token, ...]}``; an optional ``step_hook``
  fires between iterations to inject perturbations (evict/resume,
  compaction, anything legal at a token boundary).
* ``assert_transcripts_equal`` — diff two transcripts with a first-
  divergence error message.
* ``check_equivalence`` — run candidate and baseline factories over the
  same workload (each gets fresh request objects) and assert equality.
* ``evict_resume_every`` — the canonical perturbation: monitor-level
  evict + resume every ``n`` iterations while lanes are in flight.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

Transcript = Dict[str, List[int]]


def run_transcript(engine_factory: Callable, requests_factory: Callable,
                   *, step_hook: Optional[Callable] = None,
                   max_iterations: int = 100000) -> Tuple[Transcript, object]:
    """Run a workload to completion on a fresh engine.

    ``engine_factory() -> (monitor, engine)`` must return an engine with
    ``setup()`` already run; ``requests_factory()`` returns fresh
    ``ServeRequest`` objects (engines mutate ``arrival_t``).
    ``step_hook(engine, monitor, iteration)`` runs after every iteration.
    Returns ``(transcript, engine)`` — the engine is already torn down
    (``vfpga_exit``) but keeps its counters/stats readable.
    """
    mon, eng = engine_factory()
    try:
        for req in requests_factory():
            eng.submit(req)
        i = 0
        while not eng.idle:
            eng.step()
            i += 1
            if step_hook is not None:
                step_hook(eng, mon, i)
            if i >= max_iterations:
                raise RuntimeError(
                    f"engine did not drain in {max_iterations} iterations")
        return ({rid: list(rec.tokens)
                 for rid, rec in eng.completed.items()}, eng)
    finally:
        mon.vfpga_exit()


def assert_transcripts_equal(got: Transcript, ref: Transcript,
                             context: str = "") -> None:
    """Bit-exact comparison with a first-divergence diagnostic."""
    tag = f" [{context}]" if context else ""
    if set(got) != set(ref):
        raise AssertionError(
            f"request sets differ{tag}: only-got={sorted(set(got) - set(ref))}"
            f" only-ref={sorted(set(ref) - set(got))}")
    for rid in sorted(ref):
        a, b = got[rid], ref[rid]
        if a == b:
            continue
        n = min(len(a), len(b))
        div = next((i for i in range(n) if a[i] != b[i]), n)
        raise AssertionError(
            f"transcript diverges{tag}: rid={rid} at token {div}: "
            f"got={a[max(0, div - 2):div + 3]} (len {len(a)}) "
            f"ref={b[max(0, div - 2):div + 3]} (len {len(b)})")


def check_equivalence(engine_factory: Callable, baseline_factory: Callable,
                      requests_factory: Callable, *,
                      step_hook: Optional[Callable] = None,
                      baseline_hook: Optional[Callable] = None,
                      context: str = "") -> Tuple[object, object]:
    """Assert the candidate engine's transcript equals the baseline's.

    Returns the two (torn-down) engines so callers can additionally assert
    on mechanism counters (preemptions, spec stats, compactions, ...).
    """
    got, eng = run_transcript(engine_factory, requests_factory,
                              step_hook=step_hook)
    ref, base = run_transcript(baseline_factory, requests_factory,
                               step_hook=baseline_hook)
    assert_transcripts_equal(got, ref, context=context)
    return eng, base


def evict_resume_every(n: int, *, only_while_active: bool = True) -> Callable:
    """Step hook: monitor-level evict + immediate resume every ``n``
    iterations — the harness's standard preemption perturbation."""
    def hook(eng, mon, i):
        if i % n:
            return
        if only_while_active and eng.active_count == 0:
            return
        mon.evict()
        mon.resume()
    return hook
