"""The evaluation ops (port of ``paddle_tpu/ops/metric_extra.py``).

``edit_distance``, ``ctc_align``, ``mean_iou`` and ``precision_recall``
are dense tensor ops on the device of their inputs. ``chunk_eval``,
``detection_map`` and ``positive_negative_pair`` run on the host in
numpy, as in the JAX package and the reference's CPU kernels (their
work is data-dependent): they take tensors on any device and return
numpy scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from ._eager import host, tensor


def edit_distance(hyps, refs, hyp_lengths=None, ref_lengths=None,
                  normalized: bool = True):
    """Levenshtein distance of each row pair: ``(distances [batch, 1]``
    float32 (over the reference length when ``normalized``),
    ``sequence_num [1])``. One batched step a hypothesis position: the
    row recurrence ``dp[i, j] = min(dp[i-1, j] + 1, dp[i-1, j-1] + sub,
    dp[i, j-1] + 1)`` is ``j + cummin_k(c_k - k)`` over the first two
    terms ``c``, exact in float32 at these sizes."""
    hyps = tensor(hyps)
    refs = tensor(refs, hyps.device)
    dev = hyps.device
    b, m = hyps.shape
    n = refs.shape[1]
    hl = tensor(hyp_lengths, dev).long() if hyp_lengths is not None else \
        torch.full((b,), m, dtype=torch.long, device=dev)
    rl = tensor(ref_lengths, dev).long() if ref_lengths is not None else \
        torch.full((b,), n, dtype=torch.long, device=dev)
    cols = torch.arange(n + 1, dtype=torch.float32, device=dev)
    row = cols[None].expand(b, n + 1)
    rows = [row]
    for i in range(1, m + 1):
        sub = (hyps[:, i - 1][:, None] != refs).to(torch.float32)
        c = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + sub)
        c = torch.cat([torch.full((b, 1), float(i), device=dev), c], dim=1)
        row = cols + torch.cummin(c - cols, dim=1).values
        rows.append(row)
    all_rows = torch.stack(rows)                  # [m + 1, b, n + 1]
    dist = all_rows[hl, torch.arange(b, device=dev), rl]
    if normalized:
        dist = dist / torch.clamp_min(rl.to(torch.float32), 1.0)
    return dist[:, None], torch.tensor([b], dtype=torch.int32, device=dev)


def ctc_align(x, lengths, blank: int = 0, merge_repeated: bool = True):
    """Collapse CTC paths (merge repeats, drop blanks), compacted left and
    zero-padded: ``(aligned [batch, maxlen], new lengths)``."""
    from .sequence import _compact
    x = tensor(x)
    b, m = x.shape
    valid = torch.arange(m, device=x.device)[None, :] < \
        tensor(lengths, x.device).long()[:, None]
    if merge_repeated:
        first = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                      device=x.device),
                           x[:, 1:] != x[:, :-1]], dim=1)
    else:
        first = torch.ones((b, m), dtype=torch.bool, device=x.device)
    return _compact(x, valid & first & (x != blank))


def _count(idx, n, weights=None):
    w = torch.ones_like(idx, dtype=torch.int32) if weights is None \
        else weights
    return torch.zeros((n,), dtype=w.dtype, device=idx.device).index_add(
        0, idx, w)


def mean_iou(predictions, labels, num_classes: int):
    """``(mean IoU over the classes present, wrong [C], correct [C])``."""
    p = tensor(predictions).reshape(-1).long()
    lab = tensor(labels, p.device).reshape(-1).long()
    correct = _count(lab, num_classes, (p == lab).to(torch.int32))
    pred_cnt = _count(p, num_classes)
    label_cnt = _count(lab, num_classes)
    union = pred_cnt + label_cnt - correct
    present = union > 0
    iou = torch.where(present, correct / torch.clamp_min(union, 1),
                      torch.zeros((), device=p.device))
    miou = iou.sum() / torch.clamp_min(present.sum(), 1)
    return miou.to(torch.float32), label_cnt - correct, correct


def precision_recall(predictions, labels, num_classes: int,
                     weights=None, states=None):
    """``(batch metrics [6], accumulated metrics [6], states [C, 4])``:
    macro P / R / F1 then micro P / R / F1; state rows (TP, FP, TN, FN)
    a class."""
    p = tensor(predictions)
    if p.dim() == 2:
        p = torch.argmax(p, dim=1)
    dev = p.device
    lab = tensor(labels, dev).reshape(-1)
    w = tensor(weights, dev).reshape(-1).to(torch.float32) if weights is \
        not None else torch.ones(p.shape, dtype=torch.float32, device=dev)
    ids = torch.arange(num_classes, device=dev)
    pred_onehot = (p[:, None] == ids[None, :]).to(torch.float32) * w[:, None]
    label_onehot = (lab[:, None] == ids[None, :]).to(torch.float32) * \
        w[:, None]
    tp = (pred_onehot * label_onehot).sum(0)
    fp = (pred_onehot * (1 - label_onehot)).sum(0)
    fn = ((1 - pred_onehot) * label_onehot).sum(0)
    tn = w.sum() - tp - fp - fn
    batch_states = torch.stack([tp, fp, tn, fn], dim=1)
    total = batch_states if states is None else \
        batch_states + tensor(states, dev)
    zero = torch.zeros((), device=dev)

    def metrics(st):
        tp_, fp_, fn_ = st[:, 0], st[:, 1], st[:, 3]
        prec = torch.where(tp_ + fp_ > 0,
                           tp_ / torch.clamp_min(tp_ + fp_, 1e-9), zero)
        rec = torch.where(tp_ + fn_ > 0,
                          tp_ / torch.clamp_min(tp_ + fn_, 1e-9), zero)
        f1 = torch.where(prec + rec > 0, 2 * prec * rec /
                         torch.clamp_min(prec + rec, 1e-9), zero)
        macro = torch.stack([prec.mean(), rec.mean(), f1.mean()])
        stp, sfp, sfn = tp_.sum(), fp_.sum(), fn_.sum()
        mp = stp / torch.clamp_min(stp + sfp, 1e-9)
        mr = stp / torch.clamp_min(stp + sfn, 1e-9)
        mf = torch.where(mp + mr > 0, 2 * mp * mr /
                         torch.clamp_min(mp + mr, 1e-9), zero)
        return torch.cat([macro, torch.stack([mp, mr, mf])])

    return metrics(batch_states), metrics(total), total


def chunk_eval(inference, label, lengths, chunk_scheme: str = "IOB",
               num_chunk_types: int = 1, excluded_chunk_types=()):
    """Host-side chunk precision / recall / F1 over IOB / IOE / IOBES
    tags (``tag = type * parts + part``, ``O`` past the last type):
    ``(precision, recall, f1, num_infer, num_label, num_correct)``."""
    inf = host(inference)
    lab = host(label)
    lens = host(lengths).reshape(-1)
    parts = {"IOB": 2, "IOE": 2, "IOBES": 4}[chunk_scheme]
    ends = {"IOE": (1,), "IOBES": (1, 3)}.get(chunk_scheme, ())

    def extract(tags, ln):
        chunks = []
        start, ctype = None, None
        for i in range(ln):
            t = int(tags[i])
            if t >= num_chunk_types * parts:
                if start is not None:
                    chunks.append((start, i - 1, ctype))
                    start = None
                continue
            ty, part = divmod(t, parts)
            begin = part == 0 if chunk_scheme != "IOE" else False
            if chunk_scheme == "IOBES" and part in (0, 3):
                begin = True
            if start is None or begin or ty != ctype:
                if start is not None:
                    chunks.append((start, i - 1, ctype))
                start, ctype = i, ty
            if part in ends and start is not None:
                chunks.append((start, i, ctype))
                start = None
        if start is not None:
            chunks.append((start, ln - 1, ctype))
        return {c for c in chunks if c[2] not in excluded_chunk_types}

    n_inf = n_lab = n_cor = 0
    for row in range(inf.shape[0]):
        ci = extract(inf[row], int(lens[row]))
        cl = extract(lab[row], int(lens[row]))
        n_inf += len(ci)
        n_lab += len(cl)
        n_cor += len(ci & cl)
    prec = n_cor / n_inf if n_inf else 0.0
    rec = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return (np.float32(prec), np.float32(rec), np.float32(f1),
            np.int64(n_inf), np.int64(n_lab), np.int64(n_cor))


def detection_map(detections, gt_boxes, gt_labels, class_num: int,
                  overlap_threshold: float = 0.5,
                  ap_type: str = "integral"):
    """Host-side detection mAP of one image (or an accumulated set):
    ``detections [M, 6]`` rows (label, score, x1, y1, x2, y2),
    ``gt_boxes [G, 4]``, ``gt_labels [G]``."""
    det = host(detections).astype(np.float32)
    gtb = host(gt_boxes).astype(np.float32)
    gtl = host(gt_labels).reshape(-1)

    def iou(a, b):
        iw = np.maximum(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]),
                        0)
        ih = np.maximum(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]),
                        0)
        inter = iw * ih
        ua = ((a[2] - a[0]) * (a[3] - a[1]) +
              (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - inter)
        return inter / np.maximum(ua, 1e-9)

    aps = []
    for c in range(class_num):
        gt_c = gtb[gtl == c]
        det_c = det[det[:, 0] == c]
        if len(gt_c) == 0:
            continue
        det_c = det_c[np.argsort(-det_c[:, 1])]
        matched = np.zeros(len(gt_c), bool)
        tp = np.zeros(len(det_c))
        fp = np.zeros(len(det_c))
        for i, d in enumerate(det_c):
            ious = iou(d[2:6], gt_c)
            j = int(np.argmax(ious))
            if ious[j] >= overlap_threshold and not matched[j]:
                tp[i] = 1
                matched[j] = True
            else:
                fp[i] = 1
        ctp = np.cumsum(tp)
        cfp = np.cumsum(fp)
        rec = ctp / len(gt_c)
        prec = ctp / np.maximum(ctp + cfp, 1e-9)
        if ap_type == "11point":
            ap = np.mean([prec[rec >= t].max() if (rec >= t).any() else 0.0
                          for t in np.linspace(0, 1, 11)])
        else:
            ap = 0.0
            prev_r = 0.0
            for r, p in zip(rec, prec):
                ap += (r - prev_r) * p
                prev_r = r
        aps.append(ap)
    return np.float32(np.mean(aps) if aps else 0.0)


def positive_negative_pair(score, label, query_ids):
    """Host-side ranking quality a query: ``(positive, negative, neutral)``
    pair counts as float32 scalars."""
    s = host(score).reshape(-1)
    lab = host(label).reshape(-1)
    q = host(query_ids).reshape(-1)
    pos = neg = neu = 0.0
    for qid in np.unique(q):
        idx = np.nonzero(q == qid)[0]
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                i, j = idx[a], idx[b]
                if lab[i] == lab[j]:
                    continue
                hi, lo = (i, j) if lab[i] > lab[j] else (j, i)
                if s[hi] > s[lo]:
                    pos += 1
                elif s[hi] < s[lo]:
                    neg += 1
                else:
                    neu += 1
    return (np.float32(pos), np.float32(neg), np.float32(neu))
