"""Bounded retry with exponential backoff + deadline.

The recovery half of the chaos layer: monitor EXECUTEs wrap their fallible
calls in ``retry_call`` so a transient fault (injected or environmental)
costs a backoff, not a dead task.  Anything
that is not a ``TransientFault`` — validation errors, ``NodeFailed``,
``InjectedCrash`` — propagates immediately: retrying a deterministic
failure only hides it, and a crash must exercise the crash path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from repro_torch.chaos.faults import TransientFault


@dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` total tries; backoff doubles from
    ``base_backoff_s`` capped at ``max_backoff_s``; ``deadline_s`` (when
    set) bounds the whole retried call including sleeps."""

    max_attempts: int = 3
    base_backoff_s: float = 0.01
    max_backoff_s: float = 0.5
    deadline_s: Optional[float] = None

    def backoff_s(self, attempt: int) -> float:
        """Sleep before attempt ``attempt + 1`` (attempt is 1-based)."""
        return min(self.max_backoff_s,
                   self.base_backoff_s * (2 ** (attempt - 1)))


DEFAULT_EXECUTE_RETRY = RetryPolicy(max_attempts=3, base_backoff_s=0.01,
                                    max_backoff_s=0.25, deadline_s=5.0)


def retry_call(fn: Callable, policy: RetryPolicy, *,
               retryable: Tuple[Type[BaseException], ...] = (TransientFault,),
               on_retry: Optional[Callable] = None,
               sleep: Callable[[float], None] = time.sleep):
    """Call ``fn()`` with up to ``policy.max_attempts`` tries.

    ``on_retry(attempt, backoff_s, exc)`` fires before each backoff sleep
    (telemetry / span annotation).  The final failure re-raises the last
    retryable exception; non-retryable exceptions propagate on first
    occurrence.
    """
    t0 = time.perf_counter()
    attempt = 1
    while True:
        try:
            return fn()
        except retryable as e:
            backoff = policy.backoff_s(attempt)
            out_of_time = (policy.deadline_s is not None and
                           time.perf_counter() - t0 + backoff
                           > policy.deadline_s)
            if attempt >= policy.max_attempts or out_of_time:
                raise
            if on_retry is not None:
                on_retry(attempt, backoff, e)
            sleep(backoff)
            attempt += 1
