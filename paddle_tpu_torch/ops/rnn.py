"""Recurrent ops (port of ``paddle_tpu/ops/rnn.py:19-122``).

The JAX package scans each direction with ``lax.scan``; here a Python
loop over time steps runs the same cell math, gate order i, f, g, o for
the LSTM and r, z, n for the GRU, as the reference's layers have them.

Weights per (layer, direction): ``[w_ih, w_hh, b_ih, b_hh]`` with
``w_ih`` ``[G*H, in]`` and ``w_hh`` ``[G*H, H]`` (G = 1 simple, 3 GRU,
4 LSTM). No dropout between layers: the JAX ``_RNNBase`` passes none.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _cell_simple(x, h, w_ih, w_hh, b_ih, b_hh, activation):
    act = torch.tanh if activation == "tanh" else torch.relu
    return act(x @ w_ih.T + b_ih + h @ w_hh.T + b_hh)


def _cell_lstm(x, hc, w_ih, w_hh, b_ih, b_hh):
    h, c = hc
    gates = x @ w_ih.T + b_ih + h @ w_hh.T + b_hh
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


def _cell_gru(x, h, w_ih, w_hh, b_ih, b_hh):
    ir, iz, in_ = torch.chunk(x @ w_ih.T + b_ih, 3, dim=-1)
    hr, hz, hn = torch.chunk(h @ w_hh.T + b_hh, 3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1.0 - z) * n + z * h


def _scan_direction(x_tbi, h0, weights, mode, activation, reverse=False):
    """One direction over ``x_tbi [T, B, I]``: ``(final carry, outputs
    [T, B, H])``, the outputs in time order whichever way it walks."""
    w_ih, w_hh, b_ih, b_hh = weights
    carry = h0
    outs = [None] * x_tbi.shape[0]
    steps = range(x_tbi.shape[0] - 1, -1, -1) if reverse else \
        range(x_tbi.shape[0])
    for t in steps:
        if mode == "LSTM":
            carry = _cell_lstm(x_tbi[t], carry, w_ih, w_hh, b_ih, b_hh)
            outs[t] = carry[0]
        elif mode == "GRU":
            carry = _cell_gru(x_tbi[t], carry, w_ih, w_hh, b_ih, b_hh)
            outs[t] = carry
        else:
            carry = _cell_simple(x_tbi[t], carry, w_ih, w_hh, b_ih, b_hh,
                                 activation)
            outs[t] = carry
    return carry, torch.stack(outs)


def rnn(x, initial_states, weights: Sequence, mode: str = "LSTM",
        num_layers: int = 1, direction: str = "forward",
        activation: str = "tanh", time_major: bool = False):
    """Multi-layer, one- or two-directional recurrence.

    ``x`` ``[B, T, I]`` (``[T, B, I]`` when ``time_major``); ``weights``
    the flat list of four tensors per (layer, direction). Returns
    ``(outputs, final_states)``: outputs in ``x``'s layout with ``H *
    num_dirs`` features, final states ``[num_layers * num_dirs, B, H]``
    (a tuple ``(h, c)`` for the LSTM)."""
    num_dirs = 2 if direction in ("bidirect", "bidirectional") else 1
    if not time_major:
        x = x.transpose(0, 1)  # [T, B, I]
    finals_h, finals_c = [], []
    layer_in = x
    for layer in range(num_layers):
        outs_dirs = []
        for d in range(num_dirs):
            idx = layer * num_dirs + d
            w = weights[idx * 4:(idx + 1) * 4]
            if mode == "LSTM":
                h_init = (initial_states[0][idx], initial_states[1][idx])
            else:
                h_init = initial_states[idx]
            final, outs = _scan_direction(layer_in, h_init, w, mode,
                                          activation, reverse=(d == 1))
            if mode == "LSTM":
                finals_h.append(final[0])
                finals_c.append(final[1])
            else:
                finals_h.append(final)
            outs_dirs.append(outs)
        layer_in = outs_dirs[0] if num_dirs == 1 else torch.cat(outs_dirs,
                                                                dim=-1)
    outputs = layer_in if time_major else layer_in.transpose(0, 1)
    h_stack = torch.stack(finals_h)
    if mode == "LSTM":
        return outputs, (h_stack, torch.stack(finals_c))
    return outputs, h_stack


def simple_rnn_cell(x, h, w_ih, w_hh, b_ih, b_hh, activation="tanh"):
    return _cell_simple(x, h, w_ih, w_hh, b_ih, b_hh, activation)


def lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    return _cell_lstm(x, (h, c), w_ih, w_hh, b_ih, b_hh)


def gru_cell(x, h, w_ih, w_hh, b_ih, b_hh):
    return _cell_gru(x, h, w_ih, w_hh, b_ih, b_hh)
