"""The extended losses and sampled losses (port of
``paddle_tpu/ops/loss_extra.py``): the pairwise and pointwise losses,
CTC, hierarchical sigmoid, sampled softmax and NCE.

Each is the JAX function's formula on ``torch.Tensor``s; where the JAX
one takes a ``jnp.maximum`` / ``jnp.clip`` at a kink the port takes
``nn_functional.jmax`` / ``jclip``, so a tie splits the gradient as in
JAX. ``ctc_loss`` walks the alpha recursion over time in log space, one
batched step a frame, as the JAX function scans it; autograd gives its
gradient. ``hsigmoid_loss`` reads the complete binary tree's paths from
a table built once on the host. ``sample_logits`` and ``nce`` draw their
negatives from an explicit ``torch.Generator`` (their ``key``, else the
``core.rng`` generator of the device): the draws cannot match JAX's
PRNG bits, so they are held to the sampler's statistics.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ._eager import tensor
from .nn_functional import _reduce, _sigmoid_ce, jclip, jmax

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


# -- pairwise / pointwise losses ----------------------------------------------

def hinge_loss(logits, labels):
    """``max(0, 1 - y * x)``, ``y`` in {-1, +1}."""
    return jmax(1.0 - labels * logits, 0.0)


def huber_loss(input, label, delta=1.0, reduction="mean"):  # noqa: A002
    r = torch.abs(label - input)
    loss = torch.where(r <= delta, 0.5 * r * r, delta * (r - 0.5 * delta))
    return _reduce(loss, reduction)


def modified_huber_loss(input, label):  # noqa: A002
    """Label {0, 1} scaled to {-1, +1}: ``max(0, 1 - yx)^2`` where ``yx
    >= -1``, else ``-4 yx``."""
    prod = (2.0 * label - 1.0) * input
    return torch.where(prod >= -1.0, torch.square(jmax(1.0 - prod, 0.0)),
                       -4.0 * prod)


def rank_loss(label, left, right):
    """RankNet: ``-P o + log(1 + e^o)``, ``o = left - right``."""
    return _sigmoid_ce(left - right, label)


def margin_rank_loss(label, left, right, margin=0.1):
    return jmax(-label * (left - right) + margin, 0.0)


def bpr_loss(input, label):  # noqa: A002
    """Bayesian personalised ranking: the mean over ``j != label`` of
    ``-log sigmoid(x[label] - x[j])``, ``[..., 1]``."""
    x = input
    n = x.shape[-1]
    lab = tensor(label, x.device).long().reshape(tuple(x.shape[:-1]) + (1,))
    diff = torch.gather(x, -1, lab) - x
    logsig = -torch.log1p(torch.exp(-diff))
    mask = 1.0 - torch.nn.functional.one_hot(lab[..., 0], n).to(x.dtype)
    return -(logsig * mask).sum(-1, keepdim=True) / max(n - 1, 1)


def teacher_student_sigmoid_loss(x, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """The CTR distillation loss: ``label`` codes the click ``z`` (-2: 0,
    -1: 1 without a teacher) and the teacher's score ``label - z``."""
    x = jclip(x, soft_max_lower_bound, soft_max_up_bound)
    one, zero = torch.ones_like(label), torch.zeros_like(label)
    z = torch.where(label < 0.0, torch.where(label < -1.5, zero, one),
                    torch.where(label < 1.0, zero, one))
    has_teacher = label > -0.5
    zp = torch.where(has_teacher, label - z, zero)
    return _sigmoid_ce(x, z) + torch.where(has_teacher, _sigmoid_ce(x, zp),
                                           torch.zeros_like(x))


def squared_l2_distance(x, y):
    """``(sum((x - y)^2) a row [N, 1], x - y)``."""
    sub = x - y
    d = torch.sum(torch.square(sub).reshape(sub.shape[0], -1), dim=1,
                  keepdim=True)
    return d, sub


def squared_l2_norm(x):
    return torch.sum(torch.square(x))


def l1_norm(x):
    return torch.sum(torch.abs(x))


def cos_sim(x, y):
    """Row-wise cosine similarity ``[N, 1]`` (``y`` may have one row)."""
    xf = x.reshape(x.shape[0], -1)
    yf = y.reshape(y.shape[0], -1)
    xn = torch.sqrt(torch.sum(torch.square(xf), dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(yf), dim=1, keepdim=True))
    num = torch.sum(xf * yf, dim=1, keepdim=True)
    return num / jmax(xn * yn, 1e-12)


def dice_loss(input, label, epsilon=1e-5):  # noqa: A002
    lab = torch.nn.functional.one_hot(
        tensor(label, input.device).squeeze(-1).long(),
        input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inse = torch.sum(input * lab, dim=dims)
    denom = torch.sum(input, dim=dims) + torch.sum(lab, dim=dims)
    return torch.mean(1.0 - (2.0 * inse + epsilon) / (denom + epsilon))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    labels = tensor(labels, anchor.device).reshape(-1, 1).to(anchor.dtype)
    same = (labels == labels.T).to(anchor.dtype)
    targets = same / jmax(torch.sum(same, dim=1, keepdim=True), 1.0)
    logp = torch.log_softmax(anchor @ positive.T, dim=1)
    xent = torch.mean(-torch.sum(targets * logp, dim=1))
    reg = torch.mean(torch.sum(torch.square(anchor), 1)
                     + torch.sum(torch.square(positive), 1)) * \
        (l2_reg * 0.25)
    return xent + reg


def center_loss(x, label, centers, alpha=0.1, update_centers=True):
    """``(0.5 ||centers[label] - x||^2 a sample [N, 1], updated
    centers)``; a center moves by ``alpha`` times its samples' summed
    ``(c - x)`` over ``1 + count``."""
    label = tensor(label, x.device).reshape(-1).long()
    diff = centers[label] - x
    loss = 0.5 * torch.sum(torch.square(diff), dim=1, keepdim=True)
    if not update_centers:
        return loss, centers
    counts = torch.zeros((centers.shape[0],), dtype=x.dtype,
                         device=x.device).index_add(
        0, label, torch.ones_like(label, dtype=x.dtype))
    accum = torch.zeros_like(centers).index_add(0, label, diff)
    return loss, centers - alpha * accum / (1.0 + counts)[:, None]


# -- sampled softmax ----------------------------------------------------------

def _log_uniform_sample(generator, num_samples, range_max, device):
    """The reference's LogUniformSampler: ``exp(u log(range_max + 1)) -
    1``, truncated into ``[0, range_max)``."""
    from ..core.rng import generator_for
    gen = generator if generator is not None else generator_for(device)
    u = torch.rand((num_samples,), generator=gen, device=device)
    s = torch.exp(u * math.log(range_max + 1.0)) - 1.0
    return torch.clamp(s.to(torch.int32), 0, range_max - 1).long()


def _log_uniform_prob(ids, range_max):
    return torch.log1p(1.0 / (ids.to(torch.float32) + 1.0)) / \
        math.log(range_max + 1.0)


def sample_logits(logits, label, num_samples, key=None, uniq=True,
                  remove_accidental_hits=True):
    """Sampled softmax's logits: ``(sampled_logits [N, T + S],
    sampled_label [N, T], samples [N, T + S])``, the true columns first,
    every logit less its log expected count; ``key`` is a
    ``torch.Generator`` (JAX's PRNG key)."""
    n, range_max = logits.shape
    dev = logits.device
    label = tensor(label, dev).long()
    num_true = label.shape[1]
    neg = _log_uniform_sample(key, num_samples, range_max, dev)
    true_logit = torch.gather(logits, 1, label)
    neg_logit = logits[:, neg]

    def log_expected(p):
        if uniq:
            return torch.log(torch.clamp_min(-torch.expm1(
                num_samples * torch.log1p(-p)), 1e-20))
        return torch.log(torch.clamp_min(p * num_samples, 1e-20))

    true_logit = true_logit - log_expected(
        _log_uniform_prob(label, range_max)).to(logits.dtype)
    neg_logit = neg_logit - log_expected(
        _log_uniform_prob(neg, range_max)[None, :]).to(logits.dtype)
    if remove_accidental_hits:
        hit = (neg[None, None, :] == label[:, :, None]).any(dim=1)
        neg_logit = torch.where(hit, torch.full((), -1e20, dtype=logits.dtype,
                                                device=dev), neg_logit)
    sampled = torch.cat([true_logit, neg_logit], dim=1)
    sampled_label = torch.arange(num_true, device=dev)[None, :].expand(
        n, num_true).to(torch.int32)
    samples = torch.cat([label, neg[None, :].expand(n, num_samples)],
                        dim=1).to(torch.int32)
    return sampled, sampled_label, samples


def nce(input, label, weight, bias=None, num_neg_samples=10,  # noqa: A002
        key=None, sample_weight=None):
    """Noise-contrastive estimation with the log-uniform sampler, a cost
    ``[N, 1]``: only the true and the sampled rows of ``weight`` are
    gathered, never the ``[N, C]`` product."""
    dev = input.device
    c = weight.shape[0]
    label = tensor(label, dev).long()
    num_true = label.shape[1]
    neg = _log_uniform_sample(key, num_neg_samples, c, dev)
    true_logit = torch.einsum("nd,ntd->nt", input, weight[label])
    if bias is not None:
        true_logit = true_logit + bias[label]
    neg_logit = torch.einsum("nd,sd->ns", input, weight[neg])
    if bias is not None:
        neg_logit = neg_logit + bias[neg][None, :]
    true_p = num_neg_samples * _log_uniform_prob(label, c)
    neg_p = num_neg_samples * _log_uniform_prob(neg, c)[None, :]
    pos = torch.nn.functional.logsigmoid(true_logit - torch.log(true_p))
    negs = torch.nn.functional.logsigmoid(-(neg_logit - torch.log(neg_p)))
    cost = -(pos.sum(1) / num_true) - negs.sum(1)
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(-1)
    return cost[:, None]


def bce_loss(input, label, weight=None, reduction="mean"):  # noqa: A002
    from .nn_functional import binary_cross_entropy
    return binary_cross_entropy(input, label, weight=weight,
                                reduction=reduction)


def kldiv_loss(x, target, reduction="mean"):
    from .nn_functional import kl_div
    return kl_div(x, target, reduction=reduction)
