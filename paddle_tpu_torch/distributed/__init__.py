"""paddle_tpu_torch.distributed — the serving path's fault injection
(``fault_inject``) and retry policies (``resilience``)."""

from .fault_inject import (FAULT_SITES, FaultInjector,  # noqa: F401
                           InjectedFault, fault_point, get_injector)
from .resilience import (RetryExhausted, RetryPolicy,  # noqa: F401
                         call_with_retry, get_retry_policy)
