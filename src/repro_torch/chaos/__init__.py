"""Deterministic fault injection + retry scaffolding used by the monitor."""

from repro_torch.chaos.faults import (FaultPlan, FaultSpec, InjectedCrash,
                                      InjectedFault, TransientFault)
from repro_torch.chaos.retry import (DEFAULT_EXECUTE_RETRY, RetryPolicy,
                                     retry_call)

__all__ = ["FaultPlan", "FaultSpec", "InjectedCrash", "InjectedFault",
           "TransientFault", "RetryPolicy", "retry_call",
           "DEFAULT_EXECUTE_RETRY"]
