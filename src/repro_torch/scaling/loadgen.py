"""Traffic generators for elastic-serving scenarios (paper §5.6 style
trace replay, applied to request streams instead of batch jobs).

Open-loop: a non-homogeneous Poisson process over a rate profile —
constant, diurnal (sinusoidal day/night), or burst/spike — sampled by
thinning, so offered load is independent of the system's state (the honest
way to measure SLO attainment; closed-loop generators hide overload by
backing off).

Closed-loop: N clients that each wait ``think_time_s`` after a completion
before issuing the next request — the feedback mode, driven by the serving
loop calling ``on_complete``.

Service demand per request is exponential around ``mean_service_s`` — the
M/M/n-ish baseline that makes policy comparisons interpretable.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

RateFn = Callable[[float], float]


@dataclass
class Request:
    rid: str
    arrival_t: float                # seconds from trace start
    service_s: float                # work one replica needs to serve it
    client: Optional[int] = None    # closed-loop issuer
    n_tokens: Optional[int] = None  # generation length (engine-served runs)


# ---------------------------------------------------------------------------
# Rate profiles (requests/second as a function of time)
# ---------------------------------------------------------------------------
def constant_rate(rate: float) -> RateFn:
    return lambda t: rate


def diurnal_rate(base: float, peak: float, period_s: float = 86400.0,
                 ) -> RateFn:
    """Sinusoid between ``base`` (trough) and ``peak`` (crest)."""
    mid = (base + peak) / 2.0
    amp = (peak - base) / 2.0
    return lambda t: mid + amp * math.sin(2 * math.pi * t / period_s)


def burst_rate(base: float, burst_mult: float, burst_start: float,
               burst_len: float) -> RateFn:
    """Flat ``base`` with a ``burst_mult``x spike in [start, start+len)."""
    def rate(t: float) -> float:
        if burst_start <= t < burst_start + burst_len:
            return base * burst_mult
        return base
    return rate


# ---------------------------------------------------------------------------
# Open loop
# ---------------------------------------------------------------------------
def open_loop(rate_fn: RateFn, horizon_s: float, *, seed: int = 0,
              mean_service_s: float = 0.2,
              tokens_range: Optional[tuple] = None,
              rate_cap: Optional[float] = None) -> List[Request]:
    """Sample a non-homogeneous Poisson arrival stream by thinning.

    ``tokens_range=(lo, hi)`` additionally draws a ragged generation
    length per request (uniform ints) for engine-served runs.
    """
    rng = np.random.Generator(np.random.Philox(seed))
    if rate_cap is None:
        # conservative envelope for the thinning proposal
        probe = [rate_fn(horizon_s * i / 1000.0) for i in range(1001)]
        rate_cap = max(probe) * 1.05 + 1e-9
    out: List[Request] = []
    t = 0.0
    i = 0
    while True:
        t += rng.exponential(1.0 / rate_cap)
        if t >= horizon_s:
            break
        if rng.uniform() * rate_cap <= rate_fn(t):
            out.append(Request(
                rid=f"req-{i:06d}", arrival_t=t,
                service_s=float(rng.exponential(mean_service_s)),
                n_tokens=(None if tokens_range is None
                          else int(rng.integers(*tokens_range)))))
            i += 1
    return out


# ---------------------------------------------------------------------------
# Closed loop
# ---------------------------------------------------------------------------
@dataclass
class ClosedLoopGen:
    """N clients; each issues, waits for completion + think time, repeats.

    The serving loop owns the clock: call ``initial()`` once, then
    ``on_complete(req, now)`` for each finished request to get the client's
    next one (or None past the horizon).  ``tokens_range=(lo, hi)``
    additionally draws a ragged generation length per request (uniform
    ints), matching the open-loop generator's engine-served mode — so
    closed-loop think-time scenarios can drive ``engine_service_model``
    service times too.
    """

    n_clients: int = 4
    think_time_s: float = 1.0
    mean_service_s: float = 0.2
    horizon_s: float = 60.0
    seed: int = 0
    tokens_range: Optional[tuple] = None
    _rng: np.random.Generator = field(init=False, repr=False)
    _issued: int = field(init=False, default=0)

    def __post_init__(self):
        self._rng = np.random.Generator(np.random.Philox(self.seed))

    @property
    def issued(self) -> int:
        """Requests handed out so far (conservation checks)."""
        return self._issued

    def _make(self, t: float, client: int) -> Request:
        r = Request(rid=f"creq-{self._issued:06d}", arrival_t=t,
                    service_s=float(
                        self._rng.exponential(self.mean_service_s)),
                    client=client,
                    n_tokens=(None if self.tokens_range is None
                              else int(self._rng.integers(
                                  *self.tokens_range))))
        self._issued += 1
        return r

    def initial(self) -> List[Request]:
        # stagger the first wave across one think time to avoid a lockstep
        return [self._make(float(self._rng.uniform(0, self.think_time_s)), c)
                for c in range(self.n_clients)]

    def on_complete(self, req: Request, now: float) -> Optional[Request]:
        if req.client is None:
            return None
        t = now + float(self._rng.exponential(self.think_time_s))
        if t >= self.horizon_s:
            return None
        return self._make(t, req.client)
