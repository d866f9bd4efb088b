"""paddle_tpu_torch.distributed — the serving path's fault injection
(``fault_inject``), retry policies and durable checkpoints
(``resilience``)."""

from .fault_inject import (FAULT_SITES, FaultInjector,  # noqa: F401
                           InjectedFault, fault_point, get_injector)
from .resilience import (CheckpointCorruptError,  # noqa: F401
                         ResilientCheckpointManager, RetryExhausted,
                         RetryPolicy, call_with_retry, get_retry_policy)
