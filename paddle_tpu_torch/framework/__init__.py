"""Framework utilities (port of ``paddle_tpu/framework/``): save / load
with the encrypted envelope, the trainer runtime behind
``static.Executor.train_from_dataset``, the execution-mode switch
(``mode.py``) and ``unique_name``. ``DistMultiTrainer`` /
``DownpourWorker`` wait for the parameter server and ``ragged.py`` for
ROADMAP.md's 3(e)."""

from . import unique_name  # noqa: F401
from .io import load, save  # noqa: F401
from .mode import (batch, check_shape, disable_static,  # noqa: F401
                   enable_static, in_dygraph_mode, in_dynamic_mode,
                   set_printoptions)
from .trainer import (DeviceWorker, HogwildWorker,  # noqa: F401
                      MultiTrainer, TrainerFactory)
