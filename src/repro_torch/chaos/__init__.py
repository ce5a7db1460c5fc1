"""Deterministic fault injection + retry scaffolding used by the monitor
and the orchestrator."""

from repro_torch.chaos.faults import (FaultPlan, FaultSpec, InjectedCrash,
                                      InjectedFault, TransientFault)
from repro_torch.chaos.retry import (DEFAULT_ACTION_RETRY,
                                     DEFAULT_EXECUTE_RETRY, RetryPolicy,
                                     retry_call)

__all__ = ["FaultPlan", "FaultSpec", "InjectedCrash", "InjectedFault",
           "TransientFault", "RetryPolicy", "retry_call",
           "DEFAULT_ACTION_RETRY", "DEFAULT_EXECUTE_RETRY"]
