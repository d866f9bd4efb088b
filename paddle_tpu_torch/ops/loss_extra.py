"""The CTC and hierarchical-sigmoid losses (port of ``ctc_loss`` and
``hsigmoid_loss`` of ``paddle_tpu/ops/loss_extra.py``; the rest of that
module is not ported yet, see ROADMAP.md).

``ctc_loss`` walks the alpha recursion over time in log space, one step
a frame, as the JAX function scans it; autograd gives its gradient, as
JAX's autodiff does. ``hsigmoid_loss`` reads the complete binary tree's
paths from a table built once on the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .nn_functional import _sigmoid_ce

_NEG_INF = -1e30


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """``loss_extra.py:167-252``: ``log_probs [T, N, C]`` (normalised
    here by a log-softmax, so raw logits do as well), ``labels [N, S]``
    padded with anything, ``input_lengths`` / ``label_lengths [N]``.
    ``"mean"`` averages the losses divided by the label lengths (at least
    1); ``norm_by_times`` divides by the input lengths first."""
    log_probs = torch.log_softmax(log_probs, dim=-1)
    T, N, _ = log_probs.shape
    S = labels.shape[1]
    dev = log_probs.device
    labels = labels.long()
    input_lengths = torch.as_tensor(input_lengths, device=dev).long()
    label_lengths = torch.as_tensor(label_lengths, device=dev).long()
    neg_inf = torch.tensor(_NEG_INF, dtype=log_probs.dtype, device=dev)

    # the extended sequence: blank l1 blank l2 ... lS blank (2S + 1)
    ext = torch.full((N, 2 * S + 1), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    ext_valid = torch.arange(2 * S + 1, device=dev)[None, :] < (
        2 * label_lengths[:, None] + 1)
    # a skip from s - 2 to s: only onto a label other than the one before
    can_skip = torch.zeros((N, 2 * S + 1), dtype=torch.bool, device=dev)
    if S > 1:
        can_skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    elif S == 1:
        can_skip[:, 2] = ext[:, 2] != blank

    def emit(t_logp):
        return torch.gather(t_logp, 1, ext)

    e0 = emit(log_probs[0])
    alpha = torch.full((N, 2 * S + 1), _NEG_INF, dtype=log_probs.dtype,
                       device=dev)
    alpha = torch.cat([e0[:, :1], torch.where(label_lengths > 0, e0[:, 1],
                                              neg_inf)[:, None],
                       alpha[:, 2:]], dim=1)
    pad1 = torch.full((N, 1), _NEG_INF, dtype=log_probs.dtype, device=dev)
    alphas = [alpha]
    for t in range(1, T):
        from_prev = torch.cat([pad1, alpha[:, :-1]], dim=1)
        from_skip = torch.cat([pad1, pad1, alpha[:, :-2]], dim=1)
        from_skip = torch.where(can_skip, from_skip, neg_inf)
        merged = torch.logaddexp(torch.logaddexp(alpha, from_prev),
                                 from_skip)
        alpha = torch.where(ext_valid, merged + emit(log_probs[t]), neg_inf)
        alphas.append(alpha)
    alphas = torch.stack(alphas)                      # [T, N, 2S + 1]

    # alpha at t = input_length - 1, s in {2L, 2L - 1}
    t_idx = torch.clamp(input_lengths - 1, 0, T - 1)
    final = alphas[t_idx, torch.arange(N, device=dev)]
    s_last = 2 * label_lengths
    a_blank = torch.gather(final, 1, s_last[:, None])[:, 0]
    a_label = torch.where(
        label_lengths > 0,
        torch.gather(final, 1, torch.clamp_min(s_last - 1, 0)[:, None])[:, 0],
        neg_inf)
    loss = -torch.logaddexp(a_blank, a_label)
    if norm_by_times:
        loss = loss / torch.clamp_min(input_lengths.to(loss.dtype), 1.0)
    if reduction == "mean":
        return torch.mean(loss / torch.clamp_min(
            label_lengths.to(loss.dtype), 1.0))
    if reduction == "sum":
        return loss.sum()
    return loss


warpctc = ctc_loss


@functools.lru_cache(maxsize=None)
def _hsigmoid_simple_code(num_classes: int):
    """The complete binary tree's paths (``loss_extra.py:359-375``):
    class c is heap node ``c + num_classes``; its path bits are the node
    id's bits below the top one. Returns (table, code, length) numpy
    arrays."""
    max_len = int(math.floor(math.log2(max(num_classes, 2)))) + 1
    table = np.zeros((num_classes, max_len), np.int32)
    code = np.zeros((num_classes, max_len), np.float32)
    length = np.zeros((num_classes,), np.int32)
    for cls in range(num_classes):
        node = cls + num_classes
        bits = node.bit_length() - 1
        length[cls] = bits
        for j in range(bits):
            table[cls, j] = (node >> (bits - j)) - 1
            code[cls, j] = float((node >> (bits - 1 - j)) & 1)
    return table, code, length


def hsigmoid_loss(input, label, weight, bias=None,  # noqa: A002
                  num_classes=None, path_table=None, path_code=None,
                  is_sparse=False):
    """``loss_extra.py:378-406``: the summed sigmoid cross entropies of
    each sample along its class's path, ``[N, 1]``. The default tree is
    the complete binary one over ``num_classes``; ``path_table`` /
    ``path_code [N, L]`` give a custom tree, -1 padding the paths."""
    label = label.reshape(-1).long()
    dev = input.device
    if path_table is None:
        table_np, code_np, len_np = _hsigmoid_simple_code(int(num_classes))
        table = torch.from_numpy(table_np).to(dev)[label].long()
        code = torch.from_numpy(code_np).to(dev)[label]
        length = torch.from_numpy(len_np).to(dev)[label]
        valid = torch.arange(table.shape[1], device=dev)[None, :] < \
            length[:, None]
    else:
        table = path_table.long()
        code = path_code.to(input.dtype)
        valid = table >= 0
        table = torch.clamp_min(table, 0)
    z = torch.einsum("nd,nld->nl", input, weight[table])
    if bias is not None:
        z = z + bias[table]
    ce = _sigmoid_ce(z, code.to(z.dtype))
    return torch.where(valid, ce, torch.zeros_like(ce)).sum(1, keepdim=True)
