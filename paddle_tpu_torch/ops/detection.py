"""YOLOv3's box decoder (port of ``yolo_box`` of
``paddle_tpu/ops/detection.py``; the rest of that module, ``nms`` and
``multiclass_nms`` among it, is not ported yet, see ROADMAP.md)."""

from __future__ import annotations

import torch


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
