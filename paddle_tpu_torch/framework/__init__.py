"""Framework utilities (port of ``paddle_tpu/framework/``): save / load
with the encrypted envelope, the trainer runtime behind
``static.Executor.train_from_dataset``, the execution-mode switch
(``mode.py``), ``unique_name`` and the host ``RaggedTensor``
(``ragged.py``). ``DistMultiTrainer`` / ``DownpourWorker`` wait for the
parameter server."""

from . import unique_name  # noqa: F401
from .io import load, save  # noqa: F401
from .mode import (batch, check_shape, disable_static,  # noqa: F401
                   enable_static, in_dygraph_mode, in_dynamic_mode,
                   set_printoptions)
from .trainer import (DeviceWorker, HogwildWorker,  # noqa: F401
                      MultiTrainer, TrainerFactory)
