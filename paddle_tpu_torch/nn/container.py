"""The layer containers (port of ``paddle_tpu/nn/container.py``):
``Sequential``, ``LayerList``, ``ParameterList`` and ``LayerDict``.

Each is torch's container (``nn.Sequential``, ``nn.ModuleList``,
``nn.ParameterList``, ``nn.ModuleDict``) with ``Layer``'s names and
call, and the JAX keywords of ``append`` / ``insert`` / ``extend``
(``layer=``, ``layers=``, ``parameter=``). torch already names list
children ``"0"``, ``"1"``, ... as the JAX containers do, so state-dict
keys such as
``layer1.0.downsample.1._mean`` or ``blocks.3.weight`` match and
``nn.layer.load_jax_state`` finds every parameter under its JAX name.
As in the JAX ``Sequential``, ``(name, layer)`` pairs name their
children.
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


class LayerList(nn.ModuleList, Layer):
    """A list of layers named ``"0"``, ``"1"``, ...; ``append`` returns
    the list, a slice is a ``LayerList``."""

    def __init__(self, sublayers=()):
        nn.ModuleList.__init__(self, list(sublayers))

    def append(self, layer) -> "LayerList":
        return nn.ModuleList.append(self, layer)

    def insert(self, index: int, layer) -> None:
        nn.ModuleList.insert(self, index, layer)

    def extend(self, layers) -> "LayerList":
        return nn.ModuleList.extend(self, layers)


class ParameterList(nn.ParameterList, Layer):
    """A list of parameters named ``"0"``, ``"1"``, ...; ``append``
    returns the list."""

    def __init__(self, parameters=()):
        nn.ParameterList.__init__(self, list(parameters))

    def append(self, parameter) -> "ParameterList":
        return nn.ParameterList.append(self, parameter)


class LayerDict(nn.ModuleDict, Layer):
    """Layers by name in insertion order; ``update`` takes a dict or
    ``(name, layer)`` pairs, iteration gives the names."""

    def __init__(self, sublayers=None):
        nn.ModuleDict.__init__(self)
        if sublayers:
            self.update(sublayers)

    def update(self, sublayers) -> None:
        items = sublayers.items() if isinstance(sublayers, dict) else \
            sublayers
        for name, layer in items:
            self.add_sublayer(name, layer)
