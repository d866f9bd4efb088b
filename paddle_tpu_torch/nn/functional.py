"""``paddle.nn.functional``: the eager-wrapped functional API (port of
``paddle_tpu/nn/functional.py``, with its export list).

Every name is the dispatch wrapper of the registered op
(``dispatch.wrapped_ops``): ``Tensor`` and ``torch.Tensor`` arguments
in, ``Tensor``s out, autograd through torch's graph. The ``*_`` forms
write the result into their ``Tensor`` argument. The port's own layers
call the raw functions of ``ops/nn_functional.py`` instead.
"""

from .. import dispatch as _dispatch

_NN_OPS = [
    # activations
    "relu", "relu6", "leaky_relu", "prelu", "rrelu", "elu", "selu", "celu",
    "gelu", "silu", "swish", "mish", "sigmoid", "log_sigmoid", "hardsigmoid",
    "hardswish", "hardtanh", "hardshrink", "softshrink", "tanhshrink",
    "softplus", "softsign", "tanh", "softmax", "log_softmax",
    "gumbel_softmax", "maxout", "glu",
    # linear/embedding/common
    "linear", "embedding", "one_hot", "bilinear", "dropout", "dropout2d",
    "dropout3d", "alpha_dropout", "label_smooth", "cosine_similarity",
    "normalize", "sequence_mask", "pad", "interpolate", "upsample",
    "pixel_shuffle", "pixel_unshuffle", "unfold", "fold", "grid_sample",
    "affine_grid", "temporal_shift", "channel_shuffle", "pad3d",
    "zeropad2d", "thresholded_relu",
    # conv
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "deformable_conv",
    # vision/CTR extras (ops/vision_extra.py)
    "affine_channel", "space_to_depth", "shuffle_channel", "cvm",
    "shuffle_batch", "partial_concat", "partial_sum", "batch_fc",
    "row_conv", "conv_shift", "im2sequence", "add_position_encoding",
    "fsp", "bilinear_tensor_product", "correlation", "max_unpool2d",
    "spp", "psroi_pool", "prroi_pool", "yolov3_loss",
    # pooling
    "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "lp_pool2d", "adaptive_avg_pool1d",
    "adaptive_avg_pool2d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
    "adaptive_max_pool2d", "adaptive_max_pool3d",
    # norm
    "layer_norm", "rms_norm", "batch_norm", "instance_norm", "group_norm",
    "local_response_norm",
    # attention
    "scaled_dot_product_attention",
    # losses
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss", "mse_loss",
    "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "triplet_margin_loss",
    "square_error_cost", "log_loss", "sigmoid_focal_loss",
    "soft_margin_loss", "multi_label_soft_margin_loss",
    "poisson_nll_loss", "gaussian_nll_loss",
    # extended loss family (ops/loss_extra.py)
    "hinge_loss", "huber_loss", "modified_huber_loss", "rank_loss",
    "margin_rank_loss", "bpr_loss", "teacher_student_sigmoid_loss",
    "squared_l2_distance", "squared_l2_norm", "l1_norm", "cos_sim",
    "dice_loss", "npair_loss", "center_loss", "ctc_loss", "nce",
    "hsigmoid_loss", "sample_logits", "bce_loss", "kldiv_loss",
    # decode / misc
    "gather_tree", "diag_embed",
]

for _name in _NN_OPS:
    globals()[_name] = _dispatch.wrapped_ops[_name]

del _name


def _inplace(name):
    def f(x, *args, **kwargs):
        out = _dispatch.wrapped_ops[name](x, *args, **kwargs)
        return x._inplace_assign(out) if hasattr(x, "_inplace_assign") \
            else out
    f.__name__ = name + "_"
    f.__doc__ = f"In-place variant of {name} (reference: F.{name}_)."
    return f


relu_ = _inplace("relu")
elu_ = _inplace("elu")
tanh_ = _inplace("tanh")
softmax_ = _inplace("softmax")
del _inplace
