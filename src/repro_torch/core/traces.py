"""Synthetic Borg-like production traces (a copy of the reference
package's ``core/traces.py``).

The paper replays the Google ClusterData 2019 traces; that dataset is not
available in this offline container, so we generate statistically similar
synthetic traces (a documented deviation of the reference):

* arrivals: Poisson process over the horizon;
* durations: heavy-tailed lognormal, clipped to [30 s, 3 h] (Borg-like);
* priorities: three tiers — best-effort (60 %), batch (30 %), prod (10 %);
* memory: lognormal, capped at the device memory (8 GiB on Alveo U50);
* failures: each job optionally fails once at a uniform fraction of its
  runtime — El-Sayed et al. (cited by the paper) report failed jobs run
  ~40 % of their duration before the first failure; U(1%,99%) reproduces the
  paper's setup with ~50 % mean.

The paper applies a measured 1.6x FPGA speedup to job durations; the
simulator takes the same ``acceleration_rate`` sweep as Fig 11.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class TraceJob:
    jid: str
    submit_time: float              # seconds from trace start
    duration: float                 # un-accelerated work, seconds
    priority: int                   # 0 best-effort, 1 batch, 2 prod
    memory_bytes: int               # device-memory working set
    fail_frac: Optional[float]      # fraction of work at which the job fails
    # placement enrichment (optional): replicas of one service share a
    # group (spread across failure domains); ``programs`` are the job's
    # bitstream ids — a node that already compiled them is warm and skips
    # reconfiguration on deploy
    group: Optional[str] = None
    programs: tuple = ()


def generate_trace(n_jobs: int = 2000, horizon_s: float = 24 * 3600.0,
                   seed: int = 0, with_failures: bool = False,
                   mean_duration_s: float = 600.0,
                   device_mem_cap: int = 8 << 30) -> List[TraceJob]:
    rng = np.random.Generator(np.random.Philox(seed))
    arrivals = np.sort(rng.uniform(0.0, horizon_s, n_jobs))
    # lognormal with median ~ mean_duration_s/2, heavy tail
    mu = np.log(mean_duration_s / 2)
    durations = np.clip(rng.lognormal(mu, 1.2, n_jobs), 30.0, 3 * 3600.0)
    priorities = rng.choice([0, 1, 2], size=n_jobs, p=[0.6, 0.3, 0.1])
    mem = np.minimum(rng.lognormal(np.log(512e6), 1.0, n_jobs),
                     float(device_mem_cap)).astype(np.int64)
    fail = rng.uniform(0.01, 0.99, n_jobs) if with_failures else None
    jobs = []
    for i in range(n_jobs):
        jobs.append(TraceJob(
            jid=f"job-{i:06d}",
            submit_time=float(arrivals[i]),
            duration=float(durations[i]),
            priority=int(priorities[i]),
            memory_bytes=int(mem[i]),
            fail_frac=float(fail[i]) if with_failures else None,
        ))
    return jobs
