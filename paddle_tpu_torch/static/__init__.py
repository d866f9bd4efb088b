"""paddle_tpu_torch.static: the program path (port of
``paddle_tpu/static/``).

A Program is a traced, exported PyTorch computation (``torch.export``)
over its parameters and buffers; ``save_inference_model`` writes it in
the port's own format and ``load_inference_model`` /
``inference.Predictor`` run it on the device it was exported for.
``static/nn.py`` waits for the op library (ROADMAP.md 3(e)), as do
``cpu_places`` / ``cuda_places`` and ``accuracy``; none is importable.
"""

from .program import (CompiledProgram, Executor, InputSpec,  # noqa: F401
                      LoadedProgram, Program, build_program, data,
                      default_main_program, load_inference_model,
                      program_guard, save_inference_model)
from .api import (BuildStrategy, ExecutionStrategy,  # noqa: F401,E402
                  ParallelExecutor, Print, Scope, Variable,
                  WeightNormParamAttr, append_backward, auc,
                  create_global_var, create_parameter,
                  default_startup_program, deserialize_persistables,
                  deserialize_program, device_guard, global_scope,
                  gradients, load, load_from_file, load_program_state,
                  name_scope, normalize_program, py_func, save,
                  save_to_file, scope_guard, serialize_persistables,
                  serialize_program, set_program_state)
