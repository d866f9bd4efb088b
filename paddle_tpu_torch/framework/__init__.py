"""Framework utilities (port of ``paddle_tpu/framework/``): save / load
with the encrypted envelope, and the trainer runtime behind
``static.Executor.train_from_dataset``. ``DistMultiTrainer`` /
``DownpourWorker`` wait for the parameter server; ``mode.py``,
``ragged.py`` and ``unique_name.py`` are in ROADMAP.md's 3(e)."""

from .io import load, save  # noqa: F401
from .trainer import (DeviceWorker, HogwildWorker,  # noqa: F401
                      MultiTrainer, TrainerFactory)
