"""Recurrent layers (port of ``paddle_tpu/nn/rnn.py:22-280``):
``SimpleRNN`` / ``LSTM`` / ``GRU`` over ``ops.rnn.rnn``, the three
cells, the ``RNN`` wrapper that walks a cell over time with
``sequence_length`` masking, ``RNNCellBase`` and ``BiRNN``.

Every weight and bias draws from ``Uniform(-1/sqrt(H), 1/sqrt(H))`` as
in the JAX package, and the parameter names are its ``state_dict``
keys (``weight_ih_l0``, ``weight_hh_l1_reverse``, ``cell.bias_ih``,
``rnn_fw.cell.weight_ih``), so its weights load with
``nn.layer.load_jax_state``. As there, the multi-layer layers apply no
dropout between layers.

Constructors take ``device`` (``None`` means CUDA and raises without a
GPU), ``dtype`` and ``generator`` (``None``: the device's default
generator). The weight attributes (``weight_ih_attr`` and the others)
are accepted and ignored, as in the JAX layers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import rnn as R
from .initializer import Uniform, create_parameter
from .layer import Layer

_GATES = {"SimpleRNN": 1, "LSTM": 4, "GRU": 3}


def map_structure(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and the matching leaves of
    ``rest``), rebuilding its tuples, lists, named tuples and dicts with
    their own types; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, map_structure(fn, v, *(r[k] for r in rest)))
                          for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        items = [map_structure(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def flatten_structure(tree):
    """The tensors of ``tree`` in ``map_structure``'s order."""
    leaves = []
    map_structure(leaves.append, tree)
    return leaves


def _draw(device, dtype, generator, hidden_size):
    """The drawer of every weight and bias: ``Uniform(±1/sqrt(H))``. The
    JAX layers create them without their ``*_attr`` arguments, which
    they accept and ignore; so do these."""
    init = Uniform(-1.0 / math.sqrt(hidden_size), 1.0 / math.sqrt(
        hidden_size))
    kw = dict(default_initializer=init, device=resolve_device(device),
              dtype=dtype, generator=generator)
    return lambda shape: create_parameter(shape, **kw)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, **attrs):
        super().__init__()
        draw = _draw(device, dtype, generator, hidden_size)
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.num_directions = 2 if direction in ("bidirect",
                                                 "bidirectional") else 1
        g = _GATES[mode]
        self._weight_names = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_size = input_size if layer == 0 else \
                    hidden_size * self.num_directions
                suffix = f"l{layer}" + ("_reverse" if d == 1 else "")
                names = [f"weight_ih_{suffix}", f"weight_hh_{suffix}",
                         f"bias_ih_{suffix}", f"bias_hh_{suffix}"]
                shapes = [(g * hidden_size, in_size),
                          (g * hidden_size, hidden_size),
                          (g * hidden_size,), (g * hidden_size,)]
                for n, s in zip(names, shapes):
                    self.register_parameter(n, draw(s))
                self._weight_names.extend(names)

    def _weights(self):
        return [getattr(self, n) for n in self._weight_names]

    def forward(self, inputs, initial_states=None):
        b = inputs.shape[1 if self.time_major else 0]
        if initial_states is None:
            zero = torch.zeros((self.num_layers * self.num_directions, b,
                                self.hidden_size), dtype=inputs.dtype,
                               device=inputs.device)
            initial_states = (zero, zero) if self.mode == "LSTM" else zero
        return R.rnn(inputs, initial_states, self._weights(),
                     mode=self.mode, num_layers=self.num_layers,
                     direction=self.direction, activation=self.activation,
                     time_major=self.time_major)

    def extra_repr(self) -> str:
        return (f"{self.input_size}, {self.hidden_size}, "
                f"num_layers={self.num_layers}")


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__("SimpleRNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation,
                         **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class _CellBase(Layer):
    def __init__(self, mode, input_size, hidden_size, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, **attrs):
        super().__init__()
        draw = _draw(device, dtype, generator, hidden_size)
        g = _GATES[mode]
        self.input_size, self.hidden_size = input_size, hidden_size
        self.weight_ih = draw((g * hidden_size, input_size))
        self.weight_hh = draw((g * hidden_size, hidden_size))
        self.bias_ih = draw((g * hidden_size,))
        self.bias_hh = draw((g * hidden_size,))

    def _zeros(self, inputs):
        return torch.zeros((inputs.shape[0], self.hidden_size),
                           dtype=inputs.dtype, device=inputs.device)


class SimpleRNNCell(_CellBase):
    def __init__(self, input_size, hidden_size, activation="tanh", **kwargs):
        super().__init__("SimpleRNN", input_size, hidden_size, **kwargs)
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self._zeros(inputs)
        h = R.simple_rnn_cell(inputs, states, self.weight_ih,
                              self.weight_hh, self.bias_ih, self.bias_hh,
                              activation=self.activation)
        return h, h


class LSTMCell(_CellBase):
    def __init__(self, input_size, hidden_size, **kwargs):
        super().__init__("LSTM", input_size, hidden_size, **kwargs)

    def forward(self, inputs, states=None):
        if states is None:
            z = self._zeros(inputs)
            states = (z, z)
        h, c = states
        h_new, c_new = R.lstm_cell(inputs, h, c, self.weight_ih,
                                   self.weight_hh, self.bias_ih,
                                   self.bias_hh)
        return h_new, (h_new, c_new)


class GRUCell(_CellBase):
    def __init__(self, input_size, hidden_size, **kwargs):
        super().__init__("GRU", input_size, hidden_size, **kwargs)

    def forward(self, inputs, states=None):
        if states is None:
            states = self._zeros(inputs)
        h = R.gru_cell(inputs, states, self.weight_ih, self.weight_hh,
                       self.bias_ih, self.bias_hh)
        return h, h


class RNN(Layer):
    """Walk a cell over time. With ``sequence_length``, a row's states
    stop changing and its outputs are zero past its length (the
    reverse walk keeps the initial state until it enters the row's
    valid prefix), so the final states are those of step ``len - 1``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        time_axis = 0 if self.time_major else 1
        steps = inputs.shape[time_axis]
        order = range(steps - 1, -1, -1) if self.is_reverse else \
            range(steps)
        lens = None
        if sequence_length is not None:
            lens = torch.as_tensor(sequence_length, device=inputs.device)
        states = initial_states
        outs = []
        for t in order:
            xt = inputs.select(time_axis, t)
            out, new_states = self.cell(xt, states)
            if lens is not None:
                valid = lens > t

                def keep(new, old=None, valid=valid):
                    m = valid.reshape((-1,) + (1,) * (new.dim() - 1))
                    return torch.where(m, new, torch.zeros_like(new)
                                       if old is None else old)

                new_states = (map_structure(keep, new_states)
                              if states is None else
                              map_structure(keep, new_states, states))
                out = keep(out)
            states = new_states
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, dim=time_axis), states


class RNNCellBase(Layer):
    """Base of user-defined cells: ``forward(inputs, states) ->
    (output, new_states)``; zero-filled initial states from
    ``state_shape``."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        shape = shape if shape is not None else self.state_shape
        batch = batch_ref.shape[batch_dim_idx]
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)

        def one(s):
            full = (batch,) + tuple(int(d) for d in s)
            return torch.full(full, init_value,
                              dtype=dtype or batch_ref.dtype,
                              device=batch_ref.device)

        if isinstance(shape, (list, tuple)) and shape and \
                isinstance(shape[0], (list, tuple)):
            return type(shape)(one(s) for s in shape)
        return one(shape)

    @property
    def state_shape(self):
        raise NotImplementedError(
            "RNNCellBase subclasses must define state_shape or override "
            "get_initial_states")


class BiRNN(Layer):
    """``cell_fw`` forward and ``cell_bw`` reversed, outputs joined on
    the feature axis; states ``(fw, bw)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.time_major = time_major
        # each cell registers once, through its RNN
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    @property
    def cell_fw(self):
        return self.rnn_fw.cell

    @property
    def cell_bw(self):
        return self.rnn_bw.cell

    def forward(self, inputs, initial_states=None, sequence_length=None):
        fw_init, bw_init = (initial_states if initial_states is not None
                            else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, fw_init, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, bw_init, sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)
