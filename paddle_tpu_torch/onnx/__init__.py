"""ONNX export (port of ``paddle_tpu/onnx/__init__.py``; reference:
``python/paddle/onnx/__init__.py`` ``__all__``: ``export``, a thin
wrapper over the paddle2onnx converter).

The traced artefact is the port's ``torch.export`` program
(``static/program.py``), on the layer's device; its core ATen ops
convert to a standard ONNX ModelProto (``_convert.py``), written with
the port's own hand-encoded protobuf writer (``_proto.py``; no ``onnx``
package is needed). The registered kernel ops (the attention forward
#4 / #5 / #9 and the fused bottleneck #11) have no ONNX counterpart and
are written as their plain math in standard ONNX ops. ``_interp.py``
reads a file back and runs it in numpy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["export"]


def export(layer, path: str, input_spec: Optional[Sequence] = None,
           opset_version: int = 13, **configs) -> str:
    """reference: ``paddle.onnx.export(layer, path, input_spec)``: writes
    ``path + '.onnx'`` and returns that filename. The program is traced
    on the layer's device (the expected place for a layer with no
    state)."""
    import torch
    from torch.utils import _pytree as pytree

    from ..core.enforce import InvalidArgumentError
    from ..device import resolve_device
    from ..static.program import InputSpec, Program
    from ..tensor import Tensor, unwrap
    from ._convert import convert_program

    if input_spec is None:
        raise InvalidArgumentError(
            "paddle.onnx.export requires input_spec (static shapes are "
            "part of the traced program)")

    specs: List[InputSpec] = []
    info = []
    for i, spec in enumerate(input_spec):
        if any(d is None or (isinstance(d, int) and d < 0)
               for d in spec.shape):
            raise InvalidArgumentError(
                "paddle.onnx.export needs fully static input shapes "
                f"(got {tuple(spec.shape)}); dynamic dims would be baked "
                "in as the tracing placeholder")
        name = getattr(spec, "name", None) or f"x{i}"
        s = InputSpec(spec.shape, getattr(spec, "dtype", "float32"), name)
        specs.append(s)
        info.append((name, torch.empty(0, dtype=s.dtype).numpy().dtype,
                     tuple(int(d) for d in s.shape)))

    was_training = bool(getattr(layer, "training", False))
    layer.eval()
    params = {k: v.detach() for k, v in layer.named_parameters()}
    buffers = dict(layer.named_buffers())

    def fn(params, buffers, *inputs):
        out = torch.func.functional_call(layer, (params, buffers),
                                         tuple(inputs))
        leaves = [unwrap(v) for v in pytree.tree_leaves(
            out, is_leaf=lambda v: isinstance(v, Tensor))]
        return leaves[0] if len(leaves) == 1 else tuple(leaves)

    try:
        program = Program(fn, specs, params=params, buffers=buffers,
                          name=type(layer).__name__,
                          device=next((v.device for v in
                                       (*params.values(), *buffers.values())),
                                      None) or resolve_device(None))
        ep = program.exported().run_decompositions()
    finally:
        if was_training:
            layer.train()
    values = {k: v.detach().cpu().numpy() for k, v in
              {**params, **buffers}.items()}
    bound = list(params) + list(buffers) + [n for n, _, _ in info]
    data = convert_program(ep, bound, values, info,
                           graph_name=type(layer).__name__,
                           opset_version=opset_version)
    out_path = path if path.endswith(".onnx") else path + ".onnx"
    with open(out_path, "wb") as f:
        f.write(data)
    return out_path
