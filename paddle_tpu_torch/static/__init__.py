"""paddle_tpu_torch.static: the program path (port of
``paddle_tpu/static/``).

A Program is a traced, exported PyTorch computation (``torch.export``)
over its parameters and buffers; ``save_inference_model`` writes it in
the port's own format and ``load_inference_model`` /
``inference.Predictor`` run it on the device it was exported for.
``static.nn`` holds the layer builders with named parameters in
``global_scope()`` (``fc``, ``conv2d``, ``multi_box_head``, ...) and
re-exports the control-flow, sequence and ``crf_decoding`` ops.
"""

from .program import (CompiledProgram, Executor, InputSpec,  # noqa: F401
                      LoadedProgram, Program, build_program, data,
                      default_main_program, load_inference_model,
                      program_guard, save_inference_model)
from .api import (BuildStrategy, ExecutionStrategy,  # noqa: F401,E402
                  ParallelExecutor, Print, Scope, Variable,
                  WeightNormParamAttr, accuracy, append_backward, auc,
                  cpu_places, create_global_var, create_parameter,
                  cuda_places,
                  default_startup_program, deserialize_persistables,
                  deserialize_program, device_guard, global_scope,
                  gradients, load, load_from_file, load_program_state,
                  name_scope, normalize_program, py_func, save,
                  save_to_file, scope_guard, serialize_persistables,
                  serialize_program, set_program_state)
from . import nn  # noqa: F401,E402
