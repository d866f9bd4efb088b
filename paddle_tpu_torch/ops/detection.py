"""The detection op family (port of ``paddle_tpu/ops/detection.py``).

Boxes are ``[x1, y1, x2, y2]`` unless noted. As in the JAX package every
device op is fixed-size with validity masks: NMS returns ``max_out``
slots and a count, matchers return an index a column. The arithmetic
follows the JAX functions op for op (IoU, box coding, prior grids), so
float32 results agree to rounding and comparisons against thresholds
agree wherever a value is not within rounding of its threshold.

Orders are JAX's: candidates are sorted by a stable descending sort
(``jnp.argsort(-s)``), ``lax.top_k`` is a stable descending sort cut to
``k`` (ties: lower index first), and ``jnp.argmax`` takes the first
maximum. ``torch.topk`` promises no tie order on CUDA, so it is not used.

The greedy loops run as batched tensor steps: ``nms`` walks its ``n``
candidates once for a whole ``[rows, n]`` batch, and ``multiclass_nms``
puts every (image, class) row into that one batch (it takes one image
as in JAX, or a batch ``boxes [B, N, 4]``, ``scores [B, C, N]``);
``bipartite_match`` takes one matrix or a batch ``[B, N, M]`` and does
``min(N, M)`` whole-batch steps.

The ops the JAX package runs on the host in numpy stay host-side here:
``rpn_target_assign``, ``distribute_fpn_proposals``,
``collect_fpn_proposals``, ``mine_hard_examples``,
``locality_aware_nms``, ``retinanet_target_assign``,
``retinanet_detection_output``, ``generate_proposal_labels`` and
``generate_mask_labels`` take tensors on any device (or arrays) and
return numpy arrays, as JAX returns them.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ._eager import device_of, host, tensor

_F32 = torch.float32


def _cpu(a):
    """A host array as a CPU tensor, for the host-side ops' calls into
    the device ops."""
    return torch.from_numpy(np.ascontiguousarray(a))


def _bound(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _clip(t, lo, hi):
    """``jnp.clip``: a maximum then a minimum."""
    return torch.minimum(torch.maximum(t, _bound(lo, t)), _bound(hi, t))


def _top_k(x, k):
    """``lax.top_k`` along the last dim: a stable descending sort cut to
    ``k`` (ties keep the lower index first)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _neg_inf(t):
    return torch.full((), float("-inf"), dtype=t.dtype, device=t.device)


def box_area(boxes):
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    return torch.maximum(boxes[..., 2] - boxes[..., 0], zero) * \
        torch.maximum(boxes[..., 3] - boxes[..., 1], zero)


def iou_similarity(x, y, box_normalized=True):
    """Pairwise IoU ``[..., N, M]`` of ``x [..., N, 4]`` and ``y [..., M,
    4]`` (leading dims broadcast); ``box_normalized=False`` adds 1 to
    widths and heights (pixel indices)."""
    off = 0.0 if box_normalized else 1.0
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    lt = torch.maximum(x[..., :, None, :2], y[..., None, :, :2])
    rb = torch.minimum(x[..., :, None, 2:], y[..., None, :, 2:])
    wh = torch.maximum(rb - lt + off, zero)
    inter = wh[..., 0] * wh[..., 1]

    def area(b):
        return (torch.maximum(b[..., 2] - b[..., 0] + off, zero) *
                torch.maximum(b[..., 3] - b[..., 1] + off, zero))

    union = area(x)[..., :, None] + area(y)[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-10)


def box_clip(boxes, im_shape):
    """Clip to ``[0, w - 1] x [0, h - 1]``; ``im_shape = (h, w)``."""
    h, w = im_shape[0], im_shape[1]
    return torch.stack([_clip(boxes[..., 0], 0, w - 1),
                        _clip(boxes[..., 1], 0, h - 1),
                        _clip(boxes[..., 2], 0, w - 1),
                        _clip(boxes[..., 3], 0, h - 1)], dim=-1)


def box_coder(prior_box, prior_box_var, target_box, code_type="encode",
              box_normalized=True, axis=0):
    """Encode targets against priors (``[T, P, 4]``) or decode deltas:
    ``[P, 4]``, one a prior, or ``[R, C, 4]``, where ``axis`` 0 takes
    prior ``j`` for column ``j`` and ``axis`` 1 prior ``i`` for row ``i``
    (``box_coder_op.cc:69``)."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    norm = 0.0 if box_normalized else 1.0
    pw = prior_box[:, 2] - prior_box[:, 0] + norm
    ph = prior_box[:, 3] - prior_box[:, 1] + norm
    pcx = prior_box[:, 0] + pw * 0.5
    pcy = prior_box[:, 1] + ph * 0.5
    if prior_box_var is None:
        var = torch.ones((1, 4), dtype=prior_box.dtype,
                         device=prior_box.device)
    else:
        var = tensor(prior_box_var, prior_box.device).reshape(-1, 4)
    if code_type == "encode":
        tw = target_box[:, 2] - target_box[:, 0] + norm
        th = target_box[:, 3] - target_box[:, 1] + norm
        tcx = target_box[:, 0] + tw * 0.5
        tcy = target_box[:, 1] + th * 0.5
        out = torch.stack([
            (tcx[:, None] - pcx[None, :]) / pw[None, :],
            (tcy[:, None] - pcy[None, :]) / ph[None, :],
            torch.log(torch.clamp_min(tw[:, None] / pw[None, :], 1e-10)),
            torch.log(torch.clamp_min(th[:, None] / ph[None, :], 1e-10)),
        ], dim=-1)
        return out / var[None]
    if target_box.dim() == 3:
        if axis == 1:
            bpw, bph = pw[:, None], ph[:, None]
            pcx_b, pcy_b = pcx[:, None], pcy[:, None]
            var_b = var[:, None] if var.shape[0] > 1 else var[None]
        else:
            bpw, bph = pw[None, :], ph[None, :]
            pcx_b, pcy_b = pcx[None, :], pcy[None, :]
            var_b = var[None]
        d = target_box * var_b
        w = torch.exp(d[..., 2]) * bpw
        h = torch.exp(d[..., 3]) * bph
        cx = d[..., 0] * bpw + pcx_b
        cy = d[..., 1] * bph + pcy_b
        return torch.stack([cx - w * 0.5, cy - h * 0.5,
                            cx + w * 0.5 - norm, cy + h * 0.5 - norm],
                           dim=-1)
    d = target_box * var
    w = torch.exp(d[:, 2]) * pw
    h = torch.exp(d[:, 3]) * ph
    cx = d[:, 0] * pw + pcx
    cy = d[:, 1] * ph + pcy
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5 - norm, cy + h * 0.5 - norm], dim=-1)


def _centers(feature_h, feature_w, sw, sh, offset, dev):
    cx = (torch.arange(feature_w, dtype=_F32, device=dev) + offset) * sw
    cy = (torch.arange(feature_h, dtype=_F32, device=dev) + offset) * sh
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")
    return torch.stack([cxg, cyg], -1)[:, :, None, :]


def prior_box(feature_h, feature_w, image_h, image_w, min_sizes,
              max_sizes=(), aspect_ratios=(1.0,), flip=True, clip=False,
              step_w=0.0, step_h=0.0, offset=0.5,
              variances=(0.1, 0.1, 0.2, 0.2),
              min_max_aspect_ratios_order=False):
    """SSD priors on the expected place: ``(boxes [fh, fw, P, 4]``
    normalised xyxy``, variances)``; the widths and heights are computed
    in float64 numpy and taken as float32, as in JAX."""
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    sw = step_w or image_w / feature_w
    sh = step_h or image_h / feature_h
    whs = []
    for k, ms in enumerate(min_sizes):
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if k < len(max_sizes):
                s = np.sqrt(ms * max_sizes[k])
                whs.append((s, s))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        else:
            for ar in ars:
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
            if k < len(max_sizes):
                s = np.sqrt(ms * max_sizes[k])
                whs.append((s, s))
    dev = device_of()
    wh = torch.from_numpy(np.asarray(whs, np.float32)).to(dev)
    c = _centers(feature_h, feature_w, sw, sh, offset, dev)
    half = wh[None, None] * 0.5
    boxes = torch.cat([c - half, c + half], dim=-1)
    boxes = boxes / torch.tensor([image_w, image_h, image_w, image_h],
                                 dtype=_F32, device=dev)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variances, dtype=_F32, device=dev).expand_as(boxes)
    return boxes, var


def anchor_generator(feature_h, feature_w, anchor_sizes, aspect_ratios,
                     stride, offset=0.5, variances=(0.1, 0.1, 0.2, 0.2)):
    """RPN anchors on the expected place: ``(anchors [fh, fw, na, 4]`` in
    pixels``, variances)``."""
    wh = []
    for ar, sz in itertools.product(aspect_ratios, anchor_sizes):
        w = np.sqrt(float(sz) * float(sz) / ar)
        wh.append((w, w * ar))
    dev = device_of()
    wh = torch.from_numpy(np.asarray(wh, np.float32)).to(dev)
    c = _centers(feature_h, feature_w, stride[0], stride[1], offset, dev)
    half = wh[None, None] * 0.5
    anchors = torch.cat([c - half, c + half], dim=-1)
    var = torch.tensor(variances, dtype=_F32,
                       device=dev).expand_as(anchors)
    return anchors, var


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """``detection.py:192-253``: ``x [N, na * (5 + classes), H, W]`` (with
    ``iou_aware``, ``na`` IoU channels first and the confidence
    ``conf^(1 - f) * sigmoid(iou)^f``), ``img_size [N, 2]`` as (h, w).
    Returns boxes ``[N, na * H * W, 4]`` (x1, y1, x2, y2 in pixels) and
    scores ``[N, na * H * W, classes]``, both 0 where the confidence is
    below ``conf_thresh``."""
    n, _, h, w = x.shape
    na = len(anchors) // 2
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    an = torch.tensor(anchors, **f32).reshape(na, 2)
    iou = None
    if iou_aware:
        iou = torch.sigmoid(x[:, :na].float())
        x = x[:, na:]
    x = x.reshape(n, na, 5 + class_num, h, w)
    grid_x = torch.arange(w, **f32)[None, None, None, :]
    grid_y = torch.arange(h, **f32)[None, None, :, None]
    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
    bx = (torch.sigmoid(x[:, :, 0]) * alpha + beta + grid_x) / w
    by = (torch.sigmoid(x[:, :, 1]) * alpha + beta + grid_y) / h
    bw = torch.exp(x[:, :, 2]) * an[None, :, 0, None, None] / (
        downsample_ratio * w)
    bh = torch.exp(x[:, :, 3]) * an[None, :, 1, None, None] / (
        downsample_ratio * h)
    conf = torch.sigmoid(x[:, :, 4])
    if iou_aware:
        conf = conf ** (1.0 - iou_aware_factor) * iou ** iou_aware_factor
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    keep = conf >= conf_thresh
    img_h = img_size[:, 0].float()[:, None, None, None]
    img_w = img_size[:, 1].float()[:, None, None, None]
    x1 = (bx - bw * 0.5) * img_w
    y1 = (by - bh * 0.5) * img_h
    x2 = (bx + bw * 0.5) * img_w
    y2 = (by + bh * 0.5) * img_h
    if clip_bbox:
        zero = torch.zeros((), **f32)
        x1 = torch.clamp(x1, zero, img_w - 1)
        y1 = torch.clamp(y1, zero, img_h - 1)
        x2 = torch.clamp(x2, zero, img_w - 1)
        y2 = torch.clamp(y2, zero, img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    boxes = torch.where(keep[..., None], boxes, torch.zeros_like(boxes))
    probs = torch.where(keep[:, :, None], probs, torch.zeros_like(probs))
    boxes = boxes.reshape(n, na * h * w, 4)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(n, na * h * w, class_num)
    return boxes, scores


# -- NMS -------------------------------------------------------------------------

def _greedy_alive(iou, alive, iou_threshold, eta):
    """The greedy pass over ``[R, n]`` score-sorted rows: candidate ``j``
    survives unless an earlier surviving candidate overlaps it by more
    than the row's current threshold, which each survivor decays by
    ``eta`` while it is above 0.5 (``NMSFast``). ``n`` batched steps."""
    rows, n = alive.shape
    dev = alive.device
    alive = alive.clone()
    thr = torch.full((rows,), float(iou_threshold), dtype=_F32, device=dev)
    iou_t = iou.transpose(1, 2).contiguous()      # row j: iou[:, :, j]
    earlier = torch.arange(n, device=dev)
    for j in range(n):
        killed = ((iou_t[:, j] > thr[:, None]) & (earlier < j)[None]
                  & alive).any(dim=1)
        alive_j = alive[:, j] & ~killed
        alive[:, j] = alive_j
        if eta != 1.0:
            thr = torch.where(alive_j & (thr > 0.5), thr * eta, thr)
    return alive


def _nms_rows(boxes, scores, iou_threshold, score_threshold, max_out, eta,
              normalized):
    """NMS on each row of ``boxes [R, n, 4]`` / ``scores [R, n]``:
    ``(indices [R, max_out]`` int64, -1 past the count``, valid [R,
    max_out])``."""
    rows, n = scores.shape
    dev = scores.device
    _, order = torch.sort(-scores, dim=1, stable=True)
    b = torch.gather(boxes, 1, order[..., None].expand(rows, n, 4))
    s = torch.gather(scores, 1, order)
    iou = iou_similarity(b, b, box_normalized=normalized)
    alive = _greedy_alive(iou, s > score_threshold, iou_threshold, eta)
    rank = torch.cumsum(alive.long(), dim=1) - 1
    slot = torch.where(alive, rank, max_out).clamp(0, max_out)
    idx_out = torch.full((rows, max_out + 1), -1, dtype=torch.long,
                         device=dev)
    idx_out = idx_out.scatter(1, slot, order)[:, :max_out]
    count = alive.sum(dim=1)
    valid = torch.arange(max_out, device=dev)[None, :] < count[:, None]
    idx_out = torch.where(valid, idx_out, -1)
    return idx_out, valid


def nms(boxes, scores, iou_threshold=0.5, score_threshold=float("-inf"),
        max_out=None, eta=1.0, normalized=True):
    """Single-class greedy NMS, fixed size: ``(indices [max_out]`` int32,
    ``valid [max_out])``, indices in decreasing score order."""
    n = boxes.shape[0]
    max_out = n if max_out is None else int(max_out)
    idx, valid = _nms_rows(boxes[None], scores[None], iou_threshold,
                           score_threshold, max_out, eta, normalized)
    return idx[0].to(torch.int32), valid[0]


def multiclass_nms(boxes, scores, score_threshold=0.05, nms_top_k=64,
                   keep_top_k=100, iou_threshold=0.5, background_label=-1,
                   nms_eta=1.0, normalized=True):
    """Per-class NMS, then a global ``keep_top_k``: one image (``boxes [N,
    4]``, ``scores [C, N]``) gives ``(out [keep_top_k, 6]`` rows (class,
    score, x1, y1, x2, y2), class -1 past the count``, count)``; a batch
    (``boxes [B, N, 4]``, ``scores [B, C, N]``) gives ``out [B,
    keep_top_k, 6]`` and ``count [B]``, every (image, class) row in one
    greedy pass."""
    single = scores.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    bsz, num_classes, n = scores.shape
    dev = scores.device
    k_cls = min(int(nms_top_k), n)
    top_s, top_i = _top_k(scores, k_cls)                  # [B, C, k]
    img_boxes = boxes[:, None].expand(bsz, num_classes, n, 4)
    cand = torch.gather(img_boxes, 2,
                        top_i[..., None].expand(bsz, num_classes, k_cls, 4))
    rows = bsz * num_classes
    idx, valid = _nms_rows(cand.reshape(rows, k_cls, 4),
                           top_s.reshape(rows, k_cls), iou_threshold,
                           score_threshold, k_cls, nms_eta, normalized)
    idx = idx.reshape(bsz, num_classes, k_cls)
    valid = valid.reshape(bsz, num_classes, k_cls)
    safe = idx.clamp_min(0)
    sel = torch.where(idx >= 0, torch.gather(top_i, 2, safe),
                      torch.zeros_like(idx))
    sc = torch.where(valid, torch.gather(top_s, 2, safe),
                     torch.full((), -1.0, dtype=scores.dtype, device=dev))
    bx = torch.gather(img_boxes, 2, sel[..., None].expand(
        bsz, num_classes, k_cls, 4))
    cls_f = torch.arange(num_classes, dtype=_F32, device=dev)[
        None, :, None].expand(bsz, num_classes, k_cls)
    cls_f, sc, bx, valid = (cls_f.reshape(bsz, -1), sc.reshape(bsz, -1),
                            bx.reshape(bsz, -1, 4), valid.reshape(bsz, -1))
    if background_label >= 0:
        valid = valid & (cls_f != background_label)
    sc = torch.where(valid, sc, _neg_inf(sc))
    k = min(int(keep_top_k), sc.shape[1])
    best, bi = _top_k(sc, k)
    ok = best > float("-inf")
    out = torch.cat([
        torch.where(ok, torch.gather(cls_f, 1, bi),
                    torch.full((), -1.0, dtype=_F32, device=dev))[..., None],
        torch.where(ok, best, torch.zeros_like(best))[..., None],
        torch.where(ok[..., None], torch.gather(
            bx, 1, bi[..., None].expand(bsz, k, 4)),
            torch.zeros((), dtype=bx.dtype, device=dev))], dim=-1)
    count = ok.sum(dim=1).to(torch.int32)
    if single:
        return out[0], count[0]
    return out, count


# -- RoI ops ------------------------------------------------------------------

def _pair(size):
    return tuple(size) if isinstance(size, (tuple, list)) else (size, size)


def roi_align(x, rois, output_size, spatial_scale=1.0, sampling_ratio=-1,
              aligned=False):
    """RoIAlign of one image ``x [C, H, W]`` over ``rois [R, 4]`` ->
    ``[R, C, oh, ow]``: ``ratio x ratio`` bilinear samples a bin,
    averaged (``sampling_ratio <= 0`` means 2, JAX's static choice);
    samples past ``[-1, H] x [-1, W]`` give 0, those in ``[-1, 0)``
    clamp to the border."""
    oh, ow = _pair(output_size)
    c, hh, ww = x.shape
    off = 0.5 if aligned else 0.0
    ratio = 2 if sampling_ratio <= 0 else int(sampling_ratio)
    dev = x.device
    r = rois.shape[0]
    x1 = (rois[:, 0] * spatial_scale - off)[:, None, None]
    y1 = (rois[:, 1] * spatial_scale - off)[:, None, None]
    x2 = (rois[:, 2] * spatial_scale - off)[:, None, None]
    y2 = (rois[:, 3] * spatial_scale - off)[:, None, None]
    floor = 1e-6 if aligned else 1.0
    rw = torch.clamp_min(x2 - x1, floor)
    rh = torch.clamp_min(y2 - y1, floor)
    bin_w, bin_h = rw / ow, rh / oh
    sub = (torch.arange(ratio, dtype=x.dtype, device=dev)[None, None, :]
           + 0.5)
    sy = (torch.arange(oh, dtype=x.dtype, device=dev)[None, :, None]
          * bin_h + y1 + sub * bin_h / ratio).reshape(r, -1)
    sx = (torch.arange(ow, dtype=x.dtype, device=dev)[None, :, None]
          * bin_w + x1 + sub * bin_w / ratio).reshape(r, -1)
    yy = sy[:, :, None].expand(r, sy.shape[1], sx.shape[1])
    xx = sx[:, None, :].expand(r, sy.shape[1], sx.shape[1])
    outside = (yy < -1.0) | (yy > hh) | (xx < -1.0) | (xx > ww)
    yy = _clip(yy, 0.0, hh - 1)
    xx = _clip(xx, 0.0, ww - 1)
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    y1i = _clip(y0 + 1, 0, hh - 1)
    x1i = _clip(x0 + 1, 0, ww - 1)
    ly = yy - y0
    lx = xx - x0
    y0, x0, y1i, x1i = (v.long() for v in (y0, x0, y1i, x1i))
    val = (x[:, y0, x0] * (1 - ly) * (1 - lx) + x[:, y0, x1i] * (1 - ly)
           * lx + x[:, y1i, x0] * ly * (1 - lx) + x[:, y1i, x1i] * ly * lx)
    val = torch.where(outside, torch.zeros((), dtype=val.dtype,
                                           device=dev), val)
    val = val.reshape(c, r, oh, ratio, ow, ratio).mean(dim=(3, 5))
    return val.permute(1, 0, 2, 3)


def roi_pool(x, rois, output_size, spatial_scale=1.0):
    """RoI max-pool of one image ``x [C, H, W]`` over ``rois [R, 4]`` ->
    ``[R, C, oh, ow]``; an empty bin gives 0."""
    oh, ow = _pair(output_size)
    c, hh, ww = x.shape
    dev = x.device
    ygrid = torch.arange(hh, dtype=_F32, device=dev)
    xgrid = torch.arange(ww, dtype=_F32, device=dev)
    x1 = torch.round(rois[:, 0] * spatial_scale)[:, None]
    y1 = torch.round(rois[:, 1] * spatial_scale)[:, None]
    x2 = torch.round(rois[:, 2] * spatial_scale)[:, None]
    y2 = torch.round(rois[:, 3] * spatial_scale)[:, None]
    rw = torch.clamp_min(x2 - x1 + 1, 1.0)
    rh = torch.clamp_min(y2 - y1 + 1, 1.0)
    bh, bw = rh / oh, rw / ow
    ay = torch.arange(oh, dtype=_F32, device=dev)[None]
    ax = torch.arange(ow, dtype=_F32, device=dev)[None]
    ys = torch.floor(ay * bh + y1)
    ye = torch.ceil((ay + 1) * bh + y1)
    xs = torch.floor(ax * bw + x1)
    xe = torch.ceil((ax + 1) * bw + x1)
    in_y = (ygrid[None, None, :] >= ys[..., None]) & (
        ygrid[None, None, :] < ye[..., None])               # [R, oh, H]
    in_x = (xgrid[None, None, :] >= xs[..., None]) & (
        xgrid[None, None, :] < xe[..., None])               # [R, ow, W]
    m = in_y[:, :, None, :, None] & in_x[:, None, :, None, :]
    masked = torch.where(m[:, None], x[None, :, None, None],
                         _neg_inf(x))
    out = masked.amax(dim=(4, 5))
    return torch.where(torch.isfinite(out), out,
                       torch.zeros((), dtype=out.dtype, device=dev))


# -- matching -------------------------------------------------------------------

def bipartite_match(dist, match_type="bipartite", dist_threshold=0.5):
    """Greedy bipartite matching on a similarity ``dist [N, M]`` (or a
    batch ``[B, N, M]``; rows of -inf pad a batch's shorter matrices):
    ``(match_indices [M]`` int32, the row matched to each column or -1``,
    match_dist [M])``. Each of the ``min(N, M)`` steps takes the flat
    first maximum; ``per_prediction`` then gives each unmatched column
    its best row when that similarity reaches ``dist_threshold``."""
    if match_type not in ("bipartite", "per_prediction"):
        raise ValueError(
            f"match_type must be 'bipartite' or 'per_prediction', got "
            f"{match_type!r} (bipartite_match_op.cc)")
    single = dist.dim() == 2
    if single:
        dist = dist[None]
    bsz, n, m = dist.shape
    dev = dist.device
    d = dist.to(_F32)
    idx = torch.full((bsz, m), -1, dtype=torch.long, device=dev)
    val = torch.zeros((bsz, m), dtype=dist.dtype, device=dev)
    rows = torch.arange(n, device=dev)[None, :, None]
    cols = torch.arange(m, device=dev)[None, None, :]
    bidx = torch.arange(bsz, device=dev)
    neg = _neg_inf(d)
    for _ in range(min(n, m)):
        flat = torch.argmax(d.reshape(bsz, -1), dim=1)
        i, j = flat // m, flat % m
        best = d[bidx, i, j]
        found = best > float("-inf")
        hit = found[:, None] & (torch.arange(m, device=dev)[None] ==
                                j[:, None])
        idx = torch.where(hit, i[:, None], idx)
        val = torch.where(hit, best[:, None].to(val.dtype), val)
        kill = found[:, None, None] & ((rows == i[:, None, None])
                                       | (cols == j[:, None, None]))
        d = torch.where(kill, neg, d)
    if match_type == "per_prediction":
        best_val, best_row = torch.max(dist, dim=1)
        take = (idx < 0) & (best_val >= dist_threshold)
        idx = torch.where(take, best_row, idx)
        val = torch.where(take, best_val.to(val.dtype), val)
    idx = idx.to(torch.int32)
    if single:
        return idx[0], val[0]
    return idx, val


def density_prior_box(feature_h, feature_w, image_h, image_w, fixed_sizes,
                      fixed_ratios=(1.0,), densities=(1,),
                      variances=(0.1, 0.1, 0.2, 0.2), step_w=0.0,
                      step_h=0.0, offset=0.5, clip=False,
                      flatten_to_2d=False):
    """Density priors on the expected place: for each (fixed size,
    density) a density x density grid of shifted boxes a ratio over one
    step cell, clamped into [0, 1] (``density_prior_box_op.h:68-101``):
    ``(boxes [fh, fw, P, 4], variances)``, or ``[N, 4]`` flattened."""
    sw = step_w or image_w / feature_w
    sh = step_h or image_h / feature_h
    step_average = int((sw + sh) * 0.5)
    dev = device_of()
    cx = (torch.arange(feature_w, dtype=_F32, device=dev) + offset) * sw
    cy = (torch.arange(feature_h, dtype=_F32, device=dev) + offset) * sh
    boxes = []
    for size, dens in zip(fixed_sizes, densities):
        shift = step_average // dens
        for ratio in fixed_ratios:
            bw = size * float(ratio) ** 0.5
            bh = size / float(ratio) ** 0.5
            origin = -step_average / 2.0 + shift / 2.0
            for di in range(dens):
                for dj in range(dens):
                    ccx = (cx[None, :] + origin + dj * shift).expand(
                        feature_h, feature_w)
                    ccy = (cy[:, None] + origin + di * shift).expand(
                        feature_h, feature_w)
                    boxes.append(torch.stack(
                        [torch.clamp_min((ccx - bw / 2.0) / image_w, 0.0),
                         torch.clamp_min((ccy - bh / 2.0) / image_h, 0.0),
                         torch.clamp_max((ccx + bw / 2.0) / image_w, 1.0),
                         torch.clamp_max((ccy + bh / 2.0) / image_h, 1.0)],
                        dim=-1))
    out = torch.stack(boxes, dim=2)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    var = torch.tensor(variances, dtype=out.dtype, device=dev).expand_as(
        out)
    if flatten_to_2d:
        return out.reshape(-1, 4), var.reshape(-1, 4)
    return out, var


def target_assign(x, match_indices, mismatch_value=0.0):
    """``out[i, j] = x[match_indices[i, j]]`` where the index is >= 0,
    else ``mismatch_value``; returns ``(out, out_weight)``."""
    x = tensor(x)
    mi = tensor(match_indices, x.device).long()
    safe = torch.clamp(mi, 0, x.shape[0] - 1)
    gathered = x[safe]
    matched = mi >= 0
    shape = tuple(matched.shape) + (1,) * (gathered.dim() - matched.dim())
    out = torch.where(matched.reshape(shape), gathered,
                      torch.full((), mismatch_value, dtype=x.dtype,
                                 device=x.device))
    return out, matched.to(x.dtype).reshape(shape)


# -- host-side anchor assignment --------------------------------------------------

def _iouhost(a, b):
    return iou_similarity(_cpu(a), _cpu(b)).numpy()


def _assign_anchors(anchors, gts, positive_overlap, negative_overlap,
                    valid=None):
    """IoU-threshold labels (-1 ignore, 0 background, 1 foreground), every
    gt's best valid anchor positive (``detection.py:523-546``)."""
    n = len(anchors)
    if len(gts) == 0:
        return np.zeros(n, np.int32), np.zeros(n, np.int64)
    ious = _iouhost(anchors, gts)
    if valid is not None:
        ious = np.where(valid[:, None], ious, -1.0)
    best_gt = ious.argmax(1)
    best_iou = ious.max(1)
    labels = -np.ones(n, np.int32)
    labels[best_iou < negative_overlap] = 0
    labels[best_iou >= positive_overlap] = 1
    labels[ious.argmax(0)] = 1
    if valid is not None:
        labels[~valid] = -1
    return labels, best_gt


def _encode_diag(priors, gts):
    """``box_coder`` encode of each prior against its own gt (the
    pairwise result's diagonal)."""
    enc = box_coder(_cpu(priors), None, _cpu(gts), code_type="encode")
    enc = enc.numpy()
    return enc[np.arange(len(priors)), np.arange(len(priors))]


def _encode_fg_targets(anchors, gts, best_gt, fg):
    if not (len(gts) and len(fg)):
        return np.zeros((0, 4), np.float32)
    return _encode_diag(anchors[fg], gts[best_gt[fg]])


def rpn_target_assign(anchors, gt_boxes, is_crowd=None, im_height=None,
                      im_width=None, rpn_batch_size_per_im=256,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True, seed=0,
                      rpn_straddle_thresh=0.0):
    """Host-side RPN anchor sampling (``detection.py:564-612``):
    ``(loc_index, score_index, tgt_bbox, tgt_label,
    bbox_inside_weight)`` numpy arrays; straddling anchors are filtered
    before assignment when ``rpn_straddle_thresh >= 0``."""
    anchors = host(anchors).astype(np.float32)
    gts = host(gt_boxes).astype(np.float32).reshape(-1, 4)
    inside = None
    if rpn_straddle_thresh >= 0 and im_height is not None and \
            im_width is not None:
        t = float(rpn_straddle_thresh)
        inside = ((anchors[:, 0] >= -t) & (anchors[:, 1] >= -t) &
                  (anchors[:, 2] < im_width + t) &
                  (anchors[:, 3] < im_height + t))
    labels, best_gt = _assign_anchors(anchors, gts, rpn_positive_overlap,
                                      rpn_negative_overlap, valid=inside)
    rng = np.random.default_rng(seed)
    fg_cap = int(rpn_batch_size_per_im * rpn_fg_fraction)
    fg = np.nonzero(labels == 1)[0]
    if len(fg) > fg_cap:
        drop = rng.choice(fg, len(fg) - fg_cap, replace=False) \
            if use_random else fg[fg_cap:]
        labels[drop] = -1
        fg = np.nonzero(labels == 1)[0]
    bg_cap = rpn_batch_size_per_im - len(fg)
    bg = np.nonzero(labels == 0)[0]
    if len(bg) > bg_cap:
        drop = rng.choice(bg, len(bg) - bg_cap, replace=False) \
            if use_random else bg[bg_cap:]
        labels[drop] = -1
        bg = np.nonzero(labels == 0)[0]
    score_index = np.concatenate([fg, bg])
    tgt = _encode_fg_targets(anchors, gts, best_gt, fg)
    return (fg, score_index, tgt, labels[score_index].astype(np.int32),
            np.ones_like(tgt, np.float32))


def generate_proposals(scores, bbox_deltas, im_shape, anchors,
                       variances=None, pre_nms_top_n=6000,
                       post_nms_top_n=1000, nms_thresh=0.5, min_size=0.1,
                       eta=1.0, pixel_offset=True):
    """RPN proposals, fixed size: ``(rois [post_nms_top_n, 4],
    roi_scores, valid)``."""
    off = 1.0 if pixel_offset else 0.0
    scores = scores.reshape(-1)
    deltas = tensor(bbox_deltas, scores.device).reshape(-1, 4)
    anchors = tensor(anchors, scores.device).reshape(-1, 4)
    k = min(int(pre_nms_top_n), scores.shape[0])
    top, idx = _top_k(scores, k)
    boxes = box_coder(anchors[idx], variances, deltas[idx],
                      code_type="decode", box_normalized=not pixel_offset)
    h, w = im_shape[0], im_shape[1]
    boxes = torch.stack([_clip(boxes[:, 0], 0, w - off),
                         _clip(boxes[:, 1], 0, h - off),
                         _clip(boxes[:, 2], 0, w - off),
                         _clip(boxes[:, 3], 0, h - off)], dim=1)
    ws = boxes[:, 2] - boxes[:, 0] + off
    hs = boxes[:, 3] - boxes[:, 1] + off
    keep_size = (ws >= min_size) & (hs >= min_size)
    cand = torch.where(keep_size, top, _neg_inf(top))
    sel, valid = nms(boxes, cand, iou_threshold=nms_thresh,
                     max_out=int(post_nms_top_n), eta=eta,
                     normalized=not pixel_offset)
    sel = sel.long()
    return boxes[sel], cand[sel], valid


def matrix_nms(boxes, scores, score_threshold=0.05, post_threshold=0.0,
               nms_top_k=400, keep_top_k=100, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True):
    """Matrix (soft-decay) NMS: ``(out [keep_top_k, 6]`` rows (label,
    score, x1, y1, x2, y2)``, valid)``; one vectorised pass a class."""
    c, n = scores.shape
    dev = scores.device
    outs = []
    for cls in range(c):
        if cls == background_label:
            continue
        k = min(int(nms_top_k), n)
        top, idx = _top_k(scores[cls], k)
        b = boxes[idx]
        ious = torch.triu(iou_similarity(b, b), diagonal=1)
        compensate = ious.amax(dim=0)
        if use_gaussian:
            dmat = torch.exp(-(ious ** 2 - compensate[:, None] ** 2) /
                             gaussian_sigma)
        else:
            dmat = (1 - ious) / torch.clamp_min(1 - compensate[:, None],
                                                1e-9)
        tri = torch.triu(torch.ones_like(dmat, dtype=torch.bool),
                         diagonal=1)
        decay = torch.where(tri, dmat, torch.ones((), dtype=dmat.dtype,
                                                  device=dev)).amin(dim=0)
        dec = top * decay
        dec = torch.where(dec > max(score_threshold, post_threshold), dec,
                          _neg_inf(dec))
        outs.append(torch.cat([torch.full((k, 1), float(cls), device=dev),
                               dec[:, None], b], dim=1))
    if not outs:
        return (torch.zeros((0, 6), dtype=boxes.dtype, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev))
    allc = torch.cat(outs, dim=0)
    kk = min(int(keep_top_k), allc.shape[0])
    best, bidx = _top_k(allc[:, 1], kk)
    return allc[bidx], torch.isfinite(best)


def distribute_fpn_proposals(rois, min_level=2, max_level=5,
                             refer_level=4, refer_scale=224,
                             pixel_offset=True):
    """Host-side: each RoI to its FPN level ``floor(refer_level +
    log2(sqrt(area) / refer_scale))``: ``(rois a level, restore
    index)``."""
    r = host(rois).astype(np.float32)
    off = 1.0 if pixel_offset else 0.0
    scale = np.sqrt(np.maximum(
        (r[:, 2] - r[:, 0] + off) * (r[:, 3] - r[:, 1] + off), 1e-9))
    lvl = np.floor(refer_level + np.log2(scale / refer_scale + 1e-9))
    lvl = np.clip(lvl, min_level, max_level).astype(int)
    outs, order = [], []
    for level in range(min_level, max_level + 1):
        idx = np.nonzero(lvl == level)[0]
        outs.append(r[idx])
        order.append(idx)
    order = np.concatenate(order) if order else np.zeros(0, int)
    restore = np.empty_like(order)
    restore[order] = np.arange(len(order))
    return outs, restore


def collect_fpn_proposals(multi_rois, multi_scores, post_nms_top_n):
    """Host-side: the top ``post_nms_top_n`` RoIs by score across
    levels."""
    rois = np.concatenate([host(r).astype(np.float32).reshape(-1, 4)
                           for r in multi_rois], axis=0)
    scores = np.concatenate([host(s).astype(np.float32).reshape(-1)
                             for s in multi_scores], axis=0)
    order = np.argsort(-scores)[:int(post_nms_top_n)]
    return rois[order], scores[order]


def box_decoder_and_assign(prior_box, prior_box_var, target_box,
                           box_score, box_clip_value=4.135):
    """Decode each class's deltas (``dw`` / ``dh`` clamped at
    ``box_clip_value``) and pick each row's best-scoring class box:
    ``(decoded [N, C * 4], assigned [N, 4])``."""
    n, c4 = target_box.shape
    decoded = []
    for cls in range(c4 // 4):
        delta = target_box[:, cls * 4:(cls + 1) * 4]
        delta = torch.cat([delta[:, :2], torch.clamp_max(
            delta[:, 2:], box_clip_value)], dim=1)
        decoded.append(box_coder(prior_box, prior_box_var, delta,
                                 code_type="decode", box_normalized=False))
    dec = torch.stack(decoded, dim=1)
    best = torch.argmax(box_score, dim=1)
    assigned = dec[torch.arange(n, device=dec.device), best]
    return dec.reshape(n, c4), assigned


def mine_hard_examples(cls_loss, match_indices, neg_pos_ratio=3.0,
                       mining_type="max_negative", loc_loss=None,
                       neg_dist_threshold=0.5, sample_size=None):
    """Host-side OHEM for SSD: all positives and the highest-loss
    negatives, ``neg_pos_ratio`` times the positives a row (``hard_example``
    ranks by ``cls_loss + loc_loss``): ``(match_indices`` unchanged,
    ``[the selected negatives' sorted indices a row])``. numpy's argsort
    orders the losses, as in JAX."""
    loss = host(cls_loss).astype(np.float32)
    if mining_type == "hard_example" and loc_loss is not None:
        loss = loss + host(loc_loss).astype(np.float32)
    mi = host(match_indices).copy()
    neg_sel = []
    for i in range(mi.shape[0]):
        pos = mi[i] >= 0
        n_neg = int(pos.sum() * neg_pos_ratio) if sample_size is None \
            else int(sample_size)
        neg_idx = np.nonzero(~pos)[0]
        order = neg_idx[np.argsort(-loss[i][neg_idx])]
        neg_sel.append(sorted(set(order[:n_neg].tolist())))
    return mi, neg_sel


def polygon_box_transform(x):
    """EAST geometry: channel ``2k`` is an offset from the pixel's x,
    ``2k + 1`` from its y; returns ``4 * grid - x``."""
    n, c, h, w = x.shape
    dev = x.device
    xs = torch.arange(w, device=dev)[None, None, None, :]
    ys = torch.arange(h, device=dev)[None, None, :, None]
    chan = torch.arange(c, device=dev)[None, :, None, None]
    grid = torch.where(chan % 2 == 0, xs, ys).to(x.dtype)
    return 4.0 * grid - x


def locality_aware_nms(boxes, scores, iou_threshold=0.5,
                       score_threshold=0.0, nms_top_k=-1, keep_top_k=-1,
                       nms_eta=1.0, normalized=True,
                       background_label=-1):
    """Host-side locality-aware NMS (EAST): consecutive overlapping boxes
    merge, weighted by score, then greedy NMS: ``(boxes, scores)``
    numpy."""
    off = 0.0 if normalized else 1.0
    if background_label == 0:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32))
    b = host(boxes).astype(np.float32).reshape(-1, 4).copy()
    s = host(scores).astype(np.float32).reshape(-1).copy()
    keep_b, keep_s = [], []
    for i in range(len(b)):
        if s[i] < score_threshold:
            continue
        if keep_b:
            last = keep_b[-1]
            ix1 = max(last[0], b[i][0])
            iy1 = max(last[1], b[i][1])
            ix2 = min(last[2], b[i][2])
            iy2 = min(last[3], b[i][3])
            inter = max(ix2 - ix1 + off, 0) * max(iy2 - iy1 + off, 0)
            ua = ((last[2] - last[0] + off) * (last[3] - last[1] + off) +
                  (b[i][2] - b[i][0] + off) *
                  (b[i][3] - b[i][1] + off) - inter)
            if ua > 0 and inter / ua >= iou_threshold:
                wsum = keep_s[-1] + s[i]
                keep_b[-1] = (last * keep_s[-1] + b[i] * s[i]) / wsum
                keep_s[-1] = wsum
                continue
        keep_b.append(b[i])
        keep_s.append(s[i])
    if not keep_b:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
    kb = np.stack(keep_b)
    ks = np.asarray(keep_s)
    if nms_top_k > 0 and len(kb) > nms_top_k:
        top = np.argsort(-ks)[:nms_top_k]
        kb, ks = kb[top], ks[top]
    sel, valid = nms(_cpu(kb), _cpu(ks), iou_threshold=iou_threshold,
                     max_out=len(kb), eta=nms_eta, normalized=normalized)
    sel = sel.numpy()[valid.numpy()]
    if keep_top_k > 0:
        sel = sel[:keep_top_k]
    return kb[sel], ks[sel]


def retinanet_target_assign(anchors, gt_boxes, gt_labels, is_crowd=None,
                            im_height=None, im_width=None,
                            positive_overlap=0.5, negative_overlap=0.4):
    """Host-side RetinaNet assignment, no sampling: ``(loc_index,
    score_index, tgt_bbox, tgt_label, bbox_inside_weight, fg_num)``,
    ``fg_num`` = foregrounds + 1 as in the reference."""
    anchors = host(anchors).astype(np.float32)
    gts = host(gt_boxes).astype(np.float32).reshape(-1, 4)
    gtl = host(gt_labels).astype(np.int32).reshape(-1)
    labels, best_gt = _assign_anchors(anchors, gts, positive_overlap,
                                      negative_overlap)
    fg = np.nonzero(labels == 1)[0]
    bg = np.nonzero(labels == 0)[0]
    score_index = np.concatenate([fg, bg])
    tgt = _encode_fg_targets(anchors, gts, best_gt, fg)
    tgt_label = np.zeros(len(score_index), np.int32)
    if len(gts):
        tgt_label[:len(fg)] = gtl[best_gt[fg]]
    return (fg, score_index, tgt, tgt_label, np.ones_like(tgt, np.float32),
            np.asarray([len(fg) + 1], np.int32))


def retinanet_detection_output(bboxes, scores, anchors, im_scale=1.0,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.5):
    """Host-side RetinaNet head over per-level lists: ``[N, 6]`` rows
    (label, score, x0, y0, x1, y1)."""
    cands_box, cands_score = [], []
    for deltas, probs, anc in zip(bboxes, scores, anchors):
        deltas = host(deltas).astype(np.float32)
        probs = host(probs).astype(np.float32)
        anc = host(anc).astype(np.float32)
        best = probs.max(1)
        keep = np.nonzero(best > score_threshold)[0]
        if len(keep) > nms_top_k:
            keep = keep[np.argsort(-best[keep])[:nms_top_k]]
        if not len(keep):
            continue
        dec = box_coder(_cpu(anc[keep]), None, _cpu(deltas[keep]),
                        code_type="decode").numpy()
        cands_box.append(dec / im_scale)
        cands_score.append(probs[keep])
    if not cands_box:
        return np.zeros((0, 6), np.float32)
    boxes_all = np.concatenate(cands_box)
    scores_all = np.concatenate(cands_score)
    out = []
    for c in range(scores_all.shape[1]):
        sc = scores_all[:, c]
        keep = np.nonzero(sc > score_threshold)[0]
        if not len(keep):
            continue
        idx, valid = nms(_cpu(boxes_all[keep]), _cpu(sc[keep]),
                         iou_threshold=nms_threshold)
        for i in keep[idx.numpy()[valid.numpy()]]:
            out.append([c + 1, sc[i], *boxes_all[i]])
    if not out:
        return np.zeros((0, 6), np.float32)
    out = np.asarray(out, np.float32)
    if len(out) > keep_top_k:
        out = out[np.argsort(-out[:, 1])[:keep_top_k]]
    return out


def generate_proposal_labels(rpn_rois, gt_classes, gt_boxes,
                             batch_size_per_im=256, fg_fraction=0.25,
                             fg_thresh=0.5, bg_thresh_hi=0.5,
                             bg_thresh_lo=0.0, num_classes=81,
                             use_random=True, seed=0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2)):
    """Host-side Fast R-CNN RoI sampling: ``(rois, labels, bbox_targets,
    bbox_inside_weights, bbox_outside_weights)``."""
    rois = host(rpn_rois).astype(np.float32).reshape(-1, 4)
    gts = host(gt_boxes).astype(np.float32).reshape(-1, 4)
    gtc = host(gt_classes).astype(np.int32).reshape(-1)
    cand = np.concatenate([rois, gts]) if len(gts) else rois
    rng = np.random.default_rng(seed)
    if len(gts):
        ious = _iouhost(cand, gts)
        best_gt = ious.argmax(1)
        best_iou = ious.max(1)
    else:
        best_gt = np.zeros(len(cand), np.int64)
        best_iou = np.zeros(len(cand), np.float32)
    fg = np.nonzero(best_iou >= fg_thresh)[0]
    bg = np.nonzero((best_iou >= bg_thresh_lo)
                    & (best_iou < bg_thresh_hi))[0]
    fg_cap = int(batch_size_per_im * fg_fraction)
    if len(fg) > fg_cap:
        fg = rng.choice(fg, fg_cap, replace=False) if use_random \
            else fg[:fg_cap]
    bg_cap = batch_size_per_im - len(fg)
    if len(bg) > bg_cap:
        bg = rng.choice(bg, bg_cap, replace=False) if use_random \
            else bg[:bg_cap]
    keep = np.concatenate([fg, bg]).astype(np.int64)
    labels = np.zeros(len(keep), np.int32)
    if len(gts):
        labels[:len(fg)] = gtc[best_gt[fg]]
    tgt = np.zeros((len(keep), 4 * num_classes), np.float32)
    inside = np.zeros_like(tgt)
    if len(gts) and len(fg):
        enc = _encode_diag(cand[fg], gts[best_gt[fg]])
        enc = enc / np.asarray(bbox_reg_weights, np.float32)
        for i, c in enumerate(labels[:len(fg)]):
            tgt[i, 4 * c:4 * c + 4] = enc[i]
            inside[i, 4 * c:4 * c + 4] = 1.0
    return cand[keep], labels, tgt, inside, (inside > 0).astype(np.float32)


def generate_mask_labels(im_h, im_w, gt_classes, gt_segms, rois,
                         roi_labels, num_classes=81, resolution=14):
    """Host-side Mask R-CNN targets: each foreground RoI's best-IoU
    instance polygon rasterised (PIL) into a ``resolution`` square in its
    class's slot, -1 elsewhere: ``(mask_rois, roi_has_mask, mask_int32
    [N, num_classes * resolution ** 2])``."""
    from PIL import Image, ImageDraw
    rois = host(rois).astype(np.float32).reshape(-1, 4)
    roi_labels = host(roi_labels).astype(np.int32).reshape(-1)
    gtc = host(gt_classes).astype(np.int32).reshape(-1)
    fg = np.nonzero(roi_labels > 0)[0]
    masks, keep_rois = [], []
    gt_boxes = []
    for poly in gt_segms:
        p = np.asarray(poly, np.float32).reshape(-1, 2)
        gt_boxes.append([p[:, 0].min(), p[:, 1].min(),
                         p[:, 0].max(), p[:, 1].max()])
    gt_boxes = np.asarray(gt_boxes, np.float32) if gt_segms else \
        np.zeros((0, 4), np.float32)
    for i in fg:
        if not len(gt_boxes):
            continue
        g = int(_iouhost(rois[i:i + 1], gt_boxes)[0].argmax())
        x0, y0, x1, y1 = rois[i]
        w = max(x1 - x0, 1e-3)
        h = max(y1 - y0, 1e-3)
        poly = np.asarray(gt_segms[g], np.float32).reshape(-1, 2)
        px = (poly[:, 0] - x0) * resolution / w
        py = (poly[:, 1] - y0) * resolution / h
        img = Image.new("L", (resolution, resolution), 0)
        ImageDraw.Draw(img).polygon(
            list(zip(px.tolist(), py.tolist())), outline=1, fill=1)
        m = np.asarray(img, np.int32)
        expanded = np.full(num_classes * resolution * resolution, -1,
                           np.int32)
        lo = int(gtc[g]) * resolution * resolution
        expanded[lo:lo + resolution * resolution] = m.reshape(-1)
        masks.append(expanded)
        keep_rois.append(rois[i])
    if not masks:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32),
                np.zeros((0, num_classes * resolution * resolution),
                         np.int32))
    return (np.asarray(keep_rois, np.float32),
            np.ones(len(masks), np.int32), np.stack(masks))
