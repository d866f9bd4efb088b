"""The inference predictor over saved programs (port of
``paddle_tpu/inference/predictor.py``).

A :class:`Predictor` loads a program written by
``static.save_inference_model`` (``static/program.py``) and runs it on
the device it was exported for: the graph holds that device's kernel
choices (on the card, the registered forward kernels). ``Config.
disable_gpu()`` asks for the CPU and ``Config.enable_use_gpu()`` for
CUDA; asking for a device other than the program's raises, naming
both. (The JAX ``Predictor`` never reads its config's device.) A loaded
program runs its graph op by op, with no graph replay.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..static.program import LoadedProgram, _as_input


class PrecisionType:
    Float32 = "float32"
    Bfloat16 = "bfloat16"
    Half = "float16"
    Int8 = "int8"


class Config:
    """``AnalysisConfig`` (``inference/api/paddle_analysis_config.h``):
    the model path and the device / precision knobs."""

    def __init__(self, model_path_prefix: Optional[str] = None):
        self.model_path_prefix = model_path_prefix
        self._device = "auto"
        self._precision = PrecisionType.Float32
        self._enable_profile = False
        self._memory_optim = True

    def set_model(self, path_prefix: str) -> None:
        self.model_path_prefix = path_prefix

    def enable_use_gpu(self, memory_pool_init_size_mb: int = 0,
                       device_id: int = 0) -> None:
        """The port's counterpart of the JAX config's ``enable_tpu``:
        ask for the card."""
        self._device = "cuda"

    def disable_gpu(self) -> None:
        self._device = "cpu"

    def set_cpu_math_library_num_threads(self, n: int) -> None:
        pass

    def enable_memory_optim(self, flag: bool = True) -> None:
        self._memory_optim = flag

    def enable_profile(self) -> None:
        self._enable_profile = True

    def set_precision(self, precision: str) -> None:
        self._precision = precision

    def enable_low_precision(self, precision: str = PrecisionType.Int8
                             ) -> None:
        """bf16 / f16: floating parameters stored in that type and cast
        back at each call. int8: the model must have been converted
        before export, so no parameter cast is applied at load."""
        self._precision = precision

    def enable_tensorrt_engine(self, workspace_size=0, max_batch_size=1,
                               min_subgraph_size=3,
                               precision_mode=PrecisionType.Float32,
                               use_static=False, use_calib_mode=False):
        """Selects the precision only (no TensorRT here)."""
        self._precision = precision_mode


class Tensor:
    """Zero-copy handle (``paddle_tensor.h`` ``ZeroCopyTensor``)."""

    def __init__(self, name: str, owner: "Predictor", is_input: bool):
        self.name = name
        self._owner = owner
        self._is_input = is_input

    def reshape(self, shape) -> None:
        pass  # shapes are taken from the bound array

    def copy_from_cpu(self, arr: np.ndarray) -> None:
        """Copy a host array to the program's device (its dtype cast to
        the input's)."""
        self._owner._inputs[self.name] = self._owner._to_input(self.name,
                                                               arr)

    def copy_to_cpu(self) -> np.ndarray:
        return self._owner._outputs[self.name].detach().cpu().numpy()

    def share_external_data(self, arr) -> None:
        """Bind a tensor already on the program's device, without a
        copy."""
        self._owner._inputs[self.name] = arr


class Predictor:
    """``AnalysisPredictor``: loads the exported program once;
    :meth:`run` runs its graph on the program's device."""

    def __init__(self, config: Config):
        self.config = config
        device = None if config._device == "auto" else config._device
        self._program = LoadedProgram(config.model_path_prefix,
                                      precision=config._precision,
                                      device=device)
        self._input_names = [
            s.name or f"x{i}"
            for i, s in enumerate(self._program.input_specs)]
        self._specs = dict(zip(self._input_names, self._program.input_specs))
        self._inputs: Dict[str, Any] = {}
        self._outputs: Dict[str, Any] = {}
        self._output_names: List[str] = []

    @property
    def device(self) -> torch.device:
        return self._program.device

    def _to_input(self, name: str, arr) -> torch.Tensor:
        return _as_input(arr, self._specs[name], self.device)

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> Tensor:
        return Tensor(name, self, True)

    def get_output_names(self) -> List[str]:
        return list(self._output_names) or ["out0"]

    def get_output_handle(self, name: str) -> Tensor:
        return Tensor(name, self, False)

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """One request. With ``inputs`` (host arrays or tensors) bound
        in order, it returns the outputs as numpy arrays (a host fetch);
        without, it runs on the bound handles and leaves the outputs on
        the device for ``get_output_handle``."""
        if inputs is not None:
            for n, a in zip(self._input_names, inputs):
                self._inputs[n] = self._to_input(n, a)
        args = [self._inputs[n] for n in self._input_names]
        leaves = pytree.tree_leaves(self._program.run(*args))
        self._output_names = [f"out{i}" for i in range(len(leaves))]
        self._outputs = dict(zip(self._output_names, leaves))
        if inputs is not None:
            return [l.detach().cpu().numpy() for l in leaves]
        return None

    def try_shrink_memory(self) -> None:
        pass


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


class DataType:
    """``paddle_api.h`` ``PaddleDType``: dtype tags on the inference
    tensor ABI."""
    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6


class PlaceType:
    """``paddle_tensor.h`` ``PlaceType``."""
    UNK = -1
    CPU = 0
    GPU = 1
    XPU = 2
    NPU = 3
    TPU = 4


def get_num_bytes_of_data_type(dtype) -> int:
    sizes = {DataType.FLOAT32: 4, DataType.INT64: 8, DataType.INT32: 4,
             DataType.UINT8: 1, DataType.INT8: 1, DataType.FLOAT16: 2,
             DataType.BFLOAT16: 2}
    if dtype in sizes:
        return sizes[dtype]
    return int(np.dtype(dtype).itemsize)


def get_version() -> str:
    return f"paddle_tpu_torch inference (torch {torch.__version__})"


class PredictorPool:
    """``paddle.inference.PredictorPool``: N predictors over one config,
    for thread-confined use (each holds its own copy of the
    parameters)."""

    def __init__(self, config: Config, size: int = 1):
        self._predictors = [create_predictor(config)
                            for _ in range(max(1, int(size)))]

    def retrieve(self, idx: int) -> Predictor:
        return self._predictors[idx % len(self._predictors)]

    def __len__(self) -> int:
        return len(self._predictors)
