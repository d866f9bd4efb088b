"""``Sequential`` (port of ``paddle_tpu/nn/container.py:13-29``).

It is torch's ``nn.Sequential`` with ``Layer``'s names and call: torch
already names the children ``"0"``, ``"1"``, ... as the JAX one does, so
state-dict keys such as ``layer1.0.downsample.1._mean`` match without
renaming. As in the JAX container, ``(name, layer)`` pairs name their
children. ``LayerList``, ``LayerDict`` and ``ParameterList`` wait for
ROADMAP.md's 3(e).
"""

from collections import OrderedDict

from torch import nn

from .layer import Layer


class Sequential(nn.Sequential, Layer):
    def __init__(self, *layers):
        if layers and all(isinstance(it, (list, tuple)) and len(it) == 2
                          and isinstance(it[0], str) for it in layers):
            layers = (OrderedDict(layers),)
        nn.Sequential.__init__(self, *layers)
