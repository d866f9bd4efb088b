"""The NLP-matching, CTR and tree-index ops (port of
``paddle_tpu/ops/nlp_ctr_extra.py``).

The dense ops run on the device of their inputs; ``var_conv_2d`` goes
through the port's ``conv2d``. ``hash_ids`` and ``pyramid_hash`` compute
JAX's uint32 arithmetic modulo 2^32 in int64 (torch has no uint32
multiply), so the hashes are bit-equal. ``sampling_id`` and
``random_crop`` draw from an explicit ``torch.Generator`` (``key``, a
nonzero ``seed``, else the device's generator) and are held to their
distributions, not to JAX's bits. ``filter_by_instag``, ``tdm_sampler``
and ``similarity_focus`` run on the host in numpy, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ._eager import host, tensor

_HASH_PRIME = 0x9E3779B1
_M32 = 0xFFFFFFFF


def _u32(x):
    return tensor(x).long() & _M32


def _mul32(a, c: int):
    """``a * c mod 2^32`` for ``a`` in ``[0, 2^32)`` held in int64: the
    constant's 16-bit halves keep every product below 2^63."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def sequence_topk_avg_pooling(x, row_lengths, col_lengths, topks,
                              channel_num: int):
    """For each ``k`` of ``topks``, the mean of the ``k`` largest valid
    entries of each row of ``x [B, C, H, W]`` (columns past
    ``col_lengths`` masked, rows past ``row_lengths`` zero): ``[B, H, C *
    len(topks)]``. The top-k is a stable descending sort."""
    b, c, h, w = x.shape
    dev = x.device
    rl = tensor(row_lengths, dev).long()
    cl = tensor(col_lengths, dev).long()
    col_valid = torch.arange(w, device=dev)[None, None, None, :] < \
        cl[:, None, None, None]
    masked = torch.where(col_valid, x, torch.full((), float("-inf"),
                                                  dtype=x.dtype, device=dev))
    max_k = max(int(k) for k in topks)
    vals = torch.sort(masked, dim=-1, descending=True,
                      stable=True).values[..., :min(max_k, w)]
    counts = torch.minimum(cl[:, None, None, None], torch.arange(
        1, vals.shape[-1] + 1, device=dev)[None, None, None, :])
    csum = torch.cumsum(torch.where(torch.isfinite(vals), vals,
                                    torch.zeros((), dtype=x.dtype,
                                                device=dev)), dim=-1)
    outs = []
    for k in topks:
        kk = min(int(k), vals.shape[-1])
        denom = torch.clamp_min(counts[..., kk - 1], 1).to(x.dtype)
        outs.append(csum[..., kk - 1] / denom)
    out = torch.stack(outs, dim=-1)
    row_valid = torch.arange(h, device=dev)[None, None, :, None] < \
        rl[:, None, None, None]
    out = torch.where(row_valid, out, torch.zeros((), dtype=out.dtype,
                                                  device=dev))
    return out.permute(0, 2, 1, 3).reshape(b, h, -1)


def match_matrix_tensor(x, y, w, x_lengths=None, y_lengths=None,
                        dim_t=None):
    """``out [b, t, i, j] = x_i^T W_t y_j``, zero past the valid
    lengths."""
    out = torch.einsum("bid,dte,bje->btij", x, w, y)
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    if x_lengths is not None:
        mx = torch.arange(x.shape[1], device=x.device)[None, None, :, None] \
            < tensor(x_lengths, x.device).long()[:, None, None, None]
        out = torch.where(mx, out, zero)
    if y_lengths is not None:
        my = torch.arange(y.shape[1], device=x.device)[None, None, None, :] \
            < tensor(y_lengths, x.device).long()[:, None, None, None]
        out = torch.where(my, out, zero)
    return out


def _region(h, w, rows, cols, dev):
    rm = torch.arange(h, device=dev)[None, None, :, None] < \
        rows[:, None, None, None]
    cm = torch.arange(w, device=dev)[None, None, None, :] < \
        cols[:, None, None, None]
    return rm & cm


def var_conv_2d(x, row_lengths, col_lengths, weight, input_channel: int,
                output_channel: int, filter_size: int, stride: int = 1):
    """A same-padded conv over each sample's valid ``(row, col)`` region
    of ``x [B, C, H, W]``, zero outside it before and after."""
    from .nn_functional import conv2d
    b, c, h, w = x.shape
    dev = x.device
    rows = tensor(row_lengths, dev).long()
    cols = tensor(col_lengths, dev).long()
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    x = torch.where(_region(h, w, rows, cols, dev), x, zero)
    out = conv2d(x, weight, stride=stride, padding=filter_size // 2)
    oh, ow = out.shape[2], out.shape[3]
    orl = torch.clamp_max((rows + stride - 1) // stride, oh)
    ocl = torch.clamp_max((cols + stride - 1) // stride, ow)
    return torch.where(_region(oh, ow, orl, ocl, dev), out, zero)


def tree_conv(nodes_vector, edge_set, filter, max_depth: int = 2):  # noqa: A002
    """Tree convolution in JAX's simplified form: the node, its
    children's sum and (depth 3) its grandchildren's sum, mixed by
    ``filter [f, 3, out]``; ``edge_set [b, e, 2]`` parent -> child
    pairs, 0-padded."""
    nv = nodes_vector
    b, n, f = nv.shape
    es = tensor(edge_set, nv.device).long()
    src, dst = es[..., 0], es[..., 1]
    valid = (src != dst).to(nv.dtype)
    adj = torch.zeros((b, n * n), dtype=nv.dtype, device=nv.device)
    adj = adj.index_put((torch.arange(b, device=nv.device)[:, None]
                         .expand_as(src), src * n + dst), valid,
                        accumulate=True).reshape(b, n, n)
    feats = [nv]
    reach = adj
    for _ in range(max_depth - 1):
        feats.append(torch.einsum("bij,bjf->bif", reach, nv))
        reach = torch.einsum("bij,bjk->bik", reach, adj)
    roles = [feats[0],
             feats[1] if len(feats) > 1 else torch.zeros_like(nv),
             feats[2] if len(feats) > 2 else torch.zeros_like(nv)]
    return torch.einsum("bnrf,fro->bno", torch.stack(roles, dim=2), filter)


def hash_ids(x, num_hash: int = 1, mod_by: int = 100000007):
    """Multiplicative hashes of int ids, ``[..., num_hash]`` in ``[0,
    mod_by)`` (JAX's uint32 formula)."""
    x = _u32(x)
    outs = []
    for i in range(num_hash):
        h = ((_mul32(x, _HASH_PRIME) + (i * 0x85EBCA77)) & _M32) ^ (x >> 16)
        h = _mul32(h, 0xC2B2AE3D)
        outs.append(h % mod_by)
    return torch.stack(outs, dim=-1)


def pyramid_hash(x, lengths, weight, num_emb: int, space_len: int,
                 pyramid_layer: int = 2, rand_len: int = 16):
    """Hashed n-gram embeddings: each valid n-gram (n = 2 ..
    ``pyramid_layer`` + 1) of ``x [b, maxlen]`` hashed into
    ``space_len`` rows of ``weight [space_len, rand_len]``, summed into
    ``[b, num_emb]``."""
    x = _u32(x)
    b, m = x.shape
    lens = tensor(lengths, x.device).long()
    total = torch.zeros((b, num_emb), dtype=weight.dtype,
                        device=weight.device)
    reps = num_emb // rand_len
    for win in range(2, pyramid_layer + 2):
        if m < win:
            break
        key = torch.zeros((b, m - win + 1), dtype=torch.long,
                          device=x.device)
        for j in range(win):
            key = (_mul32(key, 131) + x[:, j:m - win + 1 + j]) & _M32
        valid = (torch.arange(m - win + 1, device=x.device)[None, :]
                 + win) <= lens[:, None]
        rows = []
        for r in range(reps):
            idx = ((_mul32(key, _HASH_PRIME) + r) & _M32) % space_len
            e = weight[idx]
            rows.append(torch.where(valid[..., None], e,
                                    torch.zeros((), dtype=e.dtype,
                                                device=e.device)).sum(1))
        total = total + torch.cat(rows, dim=-1)
    return total


def rank_attention(x, rank_offset, rank_param, max_rank: int,
                   max_size: int = 0):
    """Each instance averages ``x @ W[rank_i * max_rank + other_k]`` over
    its valid rank pairs (``rank_offset [n, 1 + 2 max_rank]``: column 0
    the instance's rank, odd columns the others'): ``[n, p]``."""
    n, d = x.shape
    p = rank_param.shape[1]
    ro = tensor(rank_offset, x.device).long()
    wb = rank_param.reshape(max_rank * max_rank, d, p)
    rank_i = ro[:, 0]
    acc = torch.zeros((n, p), dtype=x.dtype, device=x.device)
    cnt = torch.zeros((n, 1), dtype=x.dtype, device=x.device)
    for k in range(max_rank):
        other = ro[:, 1 + 2 * k]
        ok = ((rank_i >= 0) & (other >= 0))[:, None]
        block = torch.clamp(rank_i * max_rank + other, 0,
                            max_rank * max_rank - 1)
        term = torch.einsum("nd,ndp->np", x, wb[block])
        acc = acc + torch.where(ok, term, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
        cnt = cnt + ok.to(x.dtype)
    return acc / torch.clamp_min(cnt, 1.0)


def filter_by_instag(ins, ins_tags, filter_tags, is_lod: bool = True,
                     out_val_if_empty: float = 0.0):
    """Host-side: the rows whose tags meet ``filter_tags``: ``(rows, kept
    indices, loss weight)`` numpy arrays."""
    ins = host(ins)
    want = set(int(t) for t in host(filter_tags).reshape(-1))
    keep = [i for i, tags in enumerate(ins_tags)
            if want & set(int(t) for t in host(tags).reshape(-1))]
    if not keep:
        out = np.full((1,) + ins.shape[1:], out_val_if_empty, ins.dtype)
        return out, np.array([0]), np.zeros((1, 1), np.float32)
    idx = np.asarray(keep)
    return ins[idx], idx, np.ones((len(idx), 1), np.float32)


def tdm_child(x, tree_info, child_nums: int):
    """Each node's children from ``tree_info [nodes, 3 + child_nums]``
    (item, layer, parent, children; 0 = none): ``(children, leaf mask)``
    int32."""
    x = tensor(x).long()
    info = tensor(tree_info, x.device).long()
    children = info[x][..., 3:3 + child_nums]
    is_leaf = (info[children][..., 3:3 + child_nums].sum(-1) == 0) & \
        (children != 0)
    return children.to(torch.int32), is_leaf.to(torch.int32)


def tdm_sampler(x, travel_list, layer_node_lists, neg_samples_per_layer,
                seed: int = 0, output_positive: bool = True):
    """Host-side TDM sampling along each item's path: ``(samples,
    labels)`` int64 numpy arrays, drawn by ``np.random.default_rng(seed)``
    as in JAX."""
    rng = np.random.default_rng(seed)
    outs, labels = [], []
    for item in host(x).reshape(-1):
        row, lab = [], []
        path = travel_list[int(item)]
        for layer, neg_k in enumerate(neg_samples_per_layer):
            pos = path[layer]
            if output_positive:
                row.append(pos)
                lab.append(1)
            cands = [nd for nd in layer_node_lists[layer] if nd != pos]
            take = min(neg_k, len(cands))
            row.extend(rng.choice(cands, take, replace=False).tolist())
            lab.extend([0] * take)
        outs.append(row)
        labels.append(lab)
    return np.asarray(outs, np.int64), np.asarray(labels, np.int64)


def _generator(key, seed, device):
    if key is not None:
        return key
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    from ..core.rng import generator_for
    return generator_for(device)


def sampling_id(x, seed: int = 0, key=None):
    """One index a row of probabilities ``x [n, c]`` (a categorical draw
    from ``log(max(x, 1e-20))``)."""
    gen = _generator(key, seed, x.device)
    probs = torch.softmax(torch.log(torch.clamp_min(x, 1e-20)), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def similarity_focus(x, axis: int, indexes):
    """Host-side similarity focus: a 0/1 mask of ``x``'s shape marking,
    for each selected slice, one greedy (row, col) maximum a rank."""
    xv = host(x)
    out = np.zeros_like(xv, np.float32)
    for i in range(xv.shape[0]):
        for idx in indexes:
            if axis == 1:
                plane = xv[i, idx]
            elif axis == 2:
                plane = xv[i, :, idx]
            else:
                plane = xv[i, :, :, idx]
            h, w = plane.shape
            used_r = np.zeros(h, bool)
            used_c = np.zeros(w, bool)
            marked = 0
            for flat in np.argsort(-plane.ravel()):
                r, cc = divmod(int(flat), w)
                if used_r[r] or used_c[cc]:
                    continue
                used_r[r] = used_c[cc] = True
                if axis == 1:
                    out[i, :, r, cc] = 1.0
                elif axis == 2:
                    out[i, r, :, cc] = 1.0
                else:
                    out[i, r, cc, :] = 1.0
                marked += 1
                if marked >= min(h, w):
                    break
    return out


def pad_constant_like(x, y, pad_value: float = 0.0):
    """``y`` padded at the end of each dim up to ``x``'s shape."""
    pads = []
    for a, b in reversed(list(zip(x.shape, y.shape))):
        pads += [0, int(a) - int(b)]
    return torch.nn.functional.pad(y, pads, value=pad_value)


def random_crop(x, shape, seed: int = 0, key=None):
    """A random crop of ``x``'s trailing ``len(shape)`` dims to
    ``shape``; each start uniform over the valid range."""
    gen = _generator(key, seed, x.device)
    lead = x.dim() - len(shape)
    out = x
    for i, s in enumerate(shape):
        limit = x.shape[lead + i] - int(s)
        start = int(torch.randint(0, limit + 1, (), generator=gen,
                                  device=x.device))
        out = out.narrow(lead + i, start, int(s))
    return out
