"""``paddle.vision.ops`` (port of ``paddle_tpu/vision/ops.py``):
``yolo_loss``, ``yolo_box``, ``deform_conv2d``, ``DeformConv2D``,
``read_file`` and ``decode_jpeg`` in the reference's argument order,
over ``ops/vision_extra.py`` and ``ops/detection.py``."""

from __future__ import annotations

from ..nn.conv import DeformConv2D
from ..ops import detection as D
from ..ops import vision_extra as VE

__all__ = ["yolo_loss", "yolo_box", "deform_conv2d", "DeformConv2D",
           "read_file", "decode_jpeg"]


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """``yolov3_loss``; ``scale_x_y`` is accepted and unused, as in the
    JAX package."""
    return VE.yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask,
                          class_num, ignore_thresh, downsample_ratio,
                          gt_score, use_label_smooth)


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    return D.yolo_box(x, img_size, anchors, class_num, conf_thresh,
                      downsample_ratio, clip_bbox, scale_x_y, iou_aware,
                      iou_aware_factor)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """v1 without ``mask``, v2 with it."""
    return VE.deformable_conv(x, offset, weight, mask, bias, stride,
                              padding, dilation, deformable_groups, groups)


def read_file(filename: str, name=None):
    return VE.read_file(filename)


def decode_jpeg(x, mode: str = "unchanged", name=None):
    return VE.decode_jpeg(x, mode)
