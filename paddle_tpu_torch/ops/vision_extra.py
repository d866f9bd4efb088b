"""The vision extras (port of ``paddle_tpu/ops/vision_extra.py``): the
channel and layout transforms, the CTR and sequence ops, the RoI pools,
``deformable_conv``, ``conv3d_transpose``, ``max_unpool2d``, the YOLOv3
loss and the file / JPEG readers.

Like the JAX functions these are gathers, scatters and contractions in
plain PyTorch; none reaches a kernel of the port. Bilinear samples take
JAX's border rules, which are not ``F.grid_sample``'s: in
``deformable_conv`` a neighbour outside the image contributes 0, in
``prroi_pool`` the neighbours are clamped to the image and the weights
to ``[0, 1]``. ``read_file`` and ``decode_jpeg`` are host operations and
return CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .nn_functional import (_conv_transpose, _norm_tuple,
                            _out_padding_from_size, _sigmoid_ce,
                            adaptive_avg_pool2d, adaptive_max_pool2d,
                            channel_shuffle, jclip, jmax, one_hot, unfold)


# -- channel / layout transforms -----------------------------------------------

def affine_channel(x, scale, bias, data_format="NCHW"):
    """``scale * x + bias`` a channel."""
    if x.dim() == 2:
        return x * scale.reshape(1, -1) + bias.reshape(1, -1)
    if data_format == "NCHW":
        shape = (1, -1) + (1,) * (x.dim() - 2)
    else:
        shape = (1,) * (x.dim() - 1) + (-1,)
    return x * scale.reshape(shape) + bias.reshape(shape)


def space_to_depth(x, blocksize):
    """YOLOv2's reorg: ``[N, C, H, W] -> [N, C * bs * bs, H / bs, W /
    bs]``, the block offsets outermost."""
    n, c, h, w = x.shape
    bs = blocksize
    x = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * bs * bs, h // bs, w // bs)


def shuffle_channel(x, group):
    return channel_shuffle(x, group)


def cvm(x, cvm_input, use_cvm=True):
    """The first two columns are (show, click): ``use_cvm`` logs them,
    else they are dropped. ``cvm_input`` is unused, as in JAX."""
    if use_cvm:
        show = torch.log(x[:, 0] + 1.0)
        click = torch.log(x[:, 1] + 1.0) - show
        return torch.cat([show[:, None], click[:, None], x[:, 2:]], dim=1)
    return x[:, 2:]


def shuffle_batch(x, generator=None):
    """The rows in a random order, and the order. JAX draws it from a
    key; the port from ``generator`` (else the device's default one)."""
    idx = torch.randperm(x.shape[0], generator=generator, device=x.device)
    return x[idx], idx


def _partial_slice(x, start_index, length):
    start = start_index + x.shape[1] if start_index < 0 else start_index
    end = x.shape[1] if length < 0 else start + length
    return x[:, start:end]


def partial_concat(xs, start_index=0, length=-1):
    return torch.cat([_partial_slice(x, start_index, length) for x in xs],
                     dim=1)


def partial_sum(xs, start_index=0, length=-1):
    out = None
    for x in xs:
        piece = _partial_slice(x, start_index, length)
        out = piece if out is None else out + piece
    return out


def batch_fc(x, w, bias=None):
    """``x [S, N, Din] @ w [S, Din, Dout] (+ bias [S, Dout])``."""
    out = torch.einsum("snd,sde->sne", x, w)
    return out if bias is None else out + bias[:, None, :]


# -- sequence convolutions -------------------------------------------------------

def row_conv(x, weight):
    """DeepSpeech2's lookahead: ``out[t] = sum_j weight[j] * x[t + j]``,
    zeros past the end; ``x [N, T, D]``, ``weight [context, D]``."""
    ctx = weight.shape[0]
    t = x.shape[1]
    padded = torch.nn.functional.pad(x, (0, 0, 0, ctx - 1))
    idx = torch.arange(t, device=x.device)[:, None] + torch.arange(
        ctx, device=x.device)[None, :]
    return torch.einsum("ntcd,cd->ntd", padded[:, idx], weight)


def conv_shift(x, y):
    """Circular convolution: ``out[i, j] = sum_k x[i, (j - N/2 + k) mod
    M] * y[i, k]``; ``x [B, M]``, ``y [B, N]``, N odd."""
    m, nk = x.shape[1], y.shape[1]
    j = torch.arange(m, device=x.device)[:, None]
    k = torch.arange(nk, device=x.device)[None, :]
    return torch.einsum("bmn,bn->bm", x[:, (j - nk // 2 + k) % m], y)


def im2sequence(x, kernels, strides=(1, 1), paddings=(0, 0, 0, 0)):
    """``[N, C, H, W] -> [N * oh * ow, C * kh * kw]``, windows row-major;
    ``paddings`` is (up, left, down, right)."""
    pu, pl, pd, pr = paddings
    x = torch.nn.functional.pad(x, (pl, pr, pu, pd))
    c = x.shape[1]
    kh, kw = kernels
    cols = unfold(x, kernels, strides)
    return cols.transpose(1, 2).reshape(-1, c * kh * kw)


def add_position_encoding(x, alpha=1.0, beta=1.0):
    """``alpha * x + beta * PE`` on ``x [B, T, D]``: sines in the first
    half, cosines in the second, the frequency indexed within each half
    (an odd D pads one zero column)."""
    _, t, d = x.shape
    half = d // 2
    kw = dict(dtype=x.dtype, device=x.device)
    pos = torch.arange(t, **kw)[:, None]
    i = torch.arange(half, **kw)[None, :]
    div = torch.pow(10000.0, i / max(half - 1.0, 1.0))
    pe = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    if d % 2:
        pe = torch.nn.functional.pad(pe, (0, 1))
    return alpha * x + beta * pe[None]


def fsp(x, y):
    """``[N, C1, H, W] x [N, C2, H, W] -> [N, C1, C2]``, the spatial
    mean of the outer products."""
    return torch.einsum("nchw,ndhw->ncd", x, y) / (x.shape[2] * x.shape[3])


def bilinear_tensor_product(x, y, weight, bias=None):
    """``out[:, k] = x @ weight[k] @ y^T`` (its diagonal), weight ``[K,
    Dx, Dy]``."""
    out = torch.einsum("nd,kde,ne->nk", x, weight, y)
    return out if bias is None else out + bias.reshape(1, -1)


def correlation(x1, x2, pad_size, kernel_size, max_displacement, stride1=1,
                stride2=1, corr_type_multiply=1):
    """FlowNet's correlation of NCHW maps: for each displacement of a
    ``(2 * (d // stride2) + 1)^2`` window, the channel mean of ``x1``
    times the shifted (circularly, in the padded map) ``x2``. Only
    ``kernel_size=1`` is implemented, as in JAX."""
    if kernel_size != 1:
        raise NotImplementedError("correlation: kernel_size != 1")
    _, _, h, w = x1.shape
    d = max_displacement
    pads = (pad_size,) * 4
    x1p = torch.nn.functional.pad(x1, pads)
    x2p = torch.nn.functional.pad(x2, pads)
    outs = []
    for di in range(-(d // stride2), d // stride2 + 1):
        for dj in range(-(d // stride2), d // stride2 + 1):
            shifted = torch.roll(x2p, (-di * stride2, -dj * stride2),
                                 dims=(2, 3))
            prod = (x1p * shifted).mean(dim=1)
            outs.append(prod[:, pad_size:pad_size + h,
                             pad_size:pad_size + w])
    out = torch.stack(outs, dim=1)
    if stride1 > 1:
        out = out[:, :, ::stride1, ::stride1]
    return out


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCDHW"):
    """``vision_extra.py:408-443``: ``weight [Cin, Cout, kd, kh, kw]``,
    symmetric pads (an int or one a dim); ``groups > 1`` raises
    ``NotImplementedError`` as there."""
    if output_size is not None:
        sp = x.shape[1:4] if data_format == "NDHWC" else x.shape[2:5]
        output_padding = _out_padding_from_size(
            tuple(sp), output_size, stride, padding, dilation,
            tuple(weight.shape[2:5]), 3)
    if groups != 1:
        raise NotImplementedError("conv3d_transpose groups>1")
    if isinstance(padding, str):
        raise ValueError(f"conv3d_transpose: padding={padding!r}; give an "
                         f"int or one int a dim")
    p = _norm_tuple(padding, 3)
    return _conv_transpose(x, weight, bias, stride, [(q, q) for q in p],
                           output_padding, dilation, 1,
                           data_format == "NDHWC", 3)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None):
    """``vision_extra.py:206-229``: the pooled values of ``x [N, C, h, w]``
    written back at ``indices`` (flat positions in each ``[H * W]``
    plane, as ``max_pool2d(return_mask=True)`` gives them), zeros
    elsewhere. As JAX's scatter reads an index, a negative one counts
    from the plane's end and one outside the plane is dropped."""
    if stride is None:
        stride = kernel_size
    ks = _norm_tuple(kernel_size, 2)
    st = _norm_tuple(stride, 2)
    pd = _norm_tuple(padding, 2)
    n, c, h, w = x.shape
    if output_size is None:
        oh = (h - 1) * st[0] - 2 * pd[0] + ks[0]
        ow = (w - 1) * st[1] - 2 * pd[1] + ks[1]
    else:
        oh, ow = output_size
    idx = indices.reshape(n, c, -1).to(torch.int64)
    size = oh * ow
    idx = torch.where(idx < 0, idx + size, idx)
    # out-of-plane writes land in one spare slot past the plane
    idx = torch.where((idx < 0) | (idx >= size), size, idx)
    flat = torch.zeros((n, c, size + 1), dtype=x.dtype, device=x.device)
    flat = flat.scatter(2, idx, x.reshape(n, c, -1))
    return flat[..., :size].reshape(n, c, oh, ow)


unpool = max_unpool2d


def spp(x, pyramid_height, pooling_type="max"):
    """Spatial pyramid pooling: adaptive pools at 1, 2, 4, ... bins a
    side, flattened and concatenated, ``[N, C * sum(4^l)]``."""
    n = x.shape[0]
    outs = []
    for lvl in range(pyramid_height):
        bins = 2 ** lvl
        pooled = (adaptive_max_pool2d(x, bins) if pooling_type == "max"
                  else adaptive_avg_pool2d(x, bins))
        outs.append(pooled.reshape(n, -1))
    return torch.cat(outs, dim=1)


def _roi_batch_index(rois, rois_num, n_images):
    """The image of each RoI: image 0 without ``rois_num``, else
    ``rois_num[i]`` RoIs of image i in turn."""
    dev = rois.device
    if rois_num is None:
        return torch.zeros((rois.shape[0],), dtype=torch.long, device=dev)
    counts = torch.as_tensor(rois_num, device=dev).long()
    idx = torch.repeat_interleave(torch.arange(n_images, device=dev),
                                  counts)
    # jnp.repeat(total_repeat_length=R) cuts, or fills with the last
    # image (the last value of its input, whatever its count)
    r = rois.shape[0]
    if idx.numel() >= r:
        return idx[:r]
    return torch.cat([idx, idx.new_full((r - idx.numel(),), n_images - 1)])


def psroi_pool(x, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, rois_num=None):
    """Position-sensitive RoI average pooling: ``x [N, oc * ph * pw, H,
    W]`` (channel ``(c * ph + i) * pw + j`` for class c, bin (i, j)),
    ``rois [R, 4]`` as (x1, y1, x2, y2) in image coordinates; a bin
    averages the pixels from ``floor`` of its start to ``ceil`` of its
    end. ``[R, oc, ph, pw]``."""
    ph, pw = pooled_height, pooled_width
    n, _, h, w = x.shape
    b = _roi_batch_index(rois, rois_num, n)
    box = rois * spatial_scale
    x1, y1, x2, y2 = (box[:, k] for k in range(4))
    rh = jmax(y2 - y1, 0.1) / ph
    rw = jmax(x2 - x1, 0.1) / pw
    img = x.reshape(n, output_channels, ph, pw, h, w)
    ys = torch.arange(h, dtype=x.dtype, device=x.device)[None, :, None]
    xs = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, :]
    out = x.new_zeros((rois.shape[0], output_channels, ph, pw))
    for i in range(ph):
        hs = (y1 + i * rh)[:, None, None]
        he = (y1 + (i + 1) * rh)[:, None, None]
        for j in range(pw):
            ws = (x1 + j * rw)[:, None, None]
            we = (x1 + (j + 1) * rw)[:, None, None]
            mask = ((ys >= torch.floor(hs)) & (ys < torch.ceil(he))
                    & (xs >= torch.floor(ws)) & (xs < torch.ceil(we)))
            area = torch.clamp_min(mask.sum((1, 2)), 1)
            chans = img[b, :, i, j]                           # [R, oc, H, W]
            val = torch.where(mask[:, None], chans, torch.zeros_like(chans))
            out[:, :, i, j] = val.sum((2, 3)) / area[:, None]
    return out


def prroi_pool(x, rois, spatial_scale, pooled_height, pooled_width,
               rois_num=None, sampling=4):
    """Precise RoI pooling as the JAX function estimates it: each bin
    averages ``sampling x sampling`` bilinear samples at the centres of
    its sub-cells, neighbours clamped to the image and weights to ``[0,
    1]``. ``[R, C, ph, pw]``."""
    ph, pw = pooled_height, pooled_width
    n, c, h, w = x.shape
    r = rois.shape[0]
    b = _roi_batch_index(rois, rois_num, n)
    box = rois * spatial_scale
    x1, y1, x2, y2 = (box[:, k] for k in range(4))
    rh = (y2 - y1) / ph
    rw = (x2 - x1) / pw
    s = sampling
    kw = dict(dtype=x.dtype, device=x.device)
    off = (torch.arange(s, **kw) + 0.5) / s
    ii = torch.arange(ph, **kw)
    jj = torch.arange(pw, **kw)
    # [R, ph, s] and [R, pw, s] sample positions
    yy = y1[:, None, None] + ii[None, :, None] * rh[:, None, None] \
        + off[None, None] * rh[:, None, None]
    xx = x1[:, None, None] + jj[None, :, None] * rw[:, None, None] \
        + off[None, None] * rw[:, None, None]
    yy = yy.reshape(r, ph, 1, s, 1).expand(r, ph, pw, s, s).reshape(r, -1)
    xx = xx.reshape(r, 1, pw, 1, s).expand(r, ph, pw, s, s).reshape(r, -1)
    y0 = torch.clamp(torch.floor(yy).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(xx).long(), 0, w - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1)
    x1i = torch.clamp(x0 + 1, 0, w - 1)
    ly = jclip(yy - y0, 0.0, 1.0)[:, None]
    lx = jclip(xx - x0, 0.0, 1.0)[:, None]
    flat = x.reshape(n, c, h * w)[b]                         # [R, C, H*W]

    def at(yi, xi):
        ind = (yi * w + xi)[:, None].expand(r, c, yi.shape[1])
        return torch.gather(flat, 2, ind)

    v = (at(y0, x0) * (1 - ly) * (1 - lx) + at(y1i, x0) * ly * (1 - lx)
         + at(y0, x1i) * (1 - ly) * lx + at(y1i, x1i) * ly * lx)
    return v.reshape(r, c, ph, pw, s * s).mean(-1)


def deformable_conv(x, offset, weight, mask=None, bias=None, stride=1,
                    padding=0, dilation=1, deformable_groups=1, groups=1):
    """Deformable convolution, v1, or v2 with ``mask``
    (``vision_extra.py:340-405``): ``x [N, C, H, W]``, ``offset [N, 2 * dg
    * kh * kw, oh, ow]`` as (y, x) a tap, ``mask [N, dg * kh * kw, oh,
    ow]``, ``weight [Cout, C / groups, kh, kw]``. Each tap reads a
    bilinear sample at its offset position, a neighbour outside the image
    giving 0; one contraction with the weight follows."""
    s = _norm_tuple(stride, 2)
    p = _norm_tuple(padding, 2)
    d = _norm_tuple(dilation, 2)
    n, c, h, w = x.shape
    cout, _, kh, kw = weight.shape
    oh = (h + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    ow = (w + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    dg = deformable_groups
    kk = kh * kw
    dev = x.device
    off = offset.reshape(n, dg, kk, 2, oh, ow)
    base_y = (torch.arange(oh, device=dev) * s[0] - p[0])[:, None]
    base_x = (torch.arange(ow, device=dev) * s[1] - p[1])[None, :]
    ky = (torch.arange(kh, device=dev) * d[0]).repeat_interleave(kw)
    kx = (torch.arange(kw, device=dev) * d[1]).repeat(kh)
    # sample positions [N, dg, kk, oh, ow]
    yy = base_y[None, None, None] + ky[None, None, :, None, None] \
        + off[:, :, :, 0]
    xx = base_x[None, None, None] + kx[None, None, :, None, None] \
        + off[:, :, :, 1]
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    ly = yy - y0
    lx = xx - x0
    flat = x.reshape(n, dg, c // dg, h * w)

    def gather(py, px):
        pyc = torch.clamp(py.to(torch.int32), 0, h - 1).long()
        pxc = torch.clamp(px.to(torch.int32), 0, w - 1).long()
        valid = ((py >= 0) & (py <= h - 1) & (px >= 0)
                 & (px <= w - 1)).to(x.dtype)
        ind = (pyc * w + pxc).reshape(n, dg, 1, -1)
        vals = torch.gather(flat, 3, ind.expand(n, dg, c // dg,
                                                ind.shape[-1]))
        vals = vals.reshape(n, dg, c // dg, kk, oh, ow)
        return vals * valid[:, :, None]

    sampled = (gather(y0, x0) * ((1 - ly) * (1 - lx))[:, :, None]
               + gather(y0, x0 + 1) * ((1 - ly) * lx)[:, :, None]
               + gather(y0 + 1, x0) * (ly * (1 - lx))[:, :, None]
               + gather(y0 + 1, x0 + 1) * (ly * lx)[:, :, None])
    if mask is not None:
        sampled = sampled * mask.reshape(n, dg, 1, kk, oh, ow)
    sg = sampled.reshape(n, groups, c // groups, kk, oh, ow)
    wg = weight.reshape(groups, cout // groups, c // groups, kk)
    out = torch.einsum("ngckhw,gock->ngohw", sg, wg).reshape(n, cout, oh, ow)
    return out if bias is None else out + bias.reshape(1, -1, 1, 1)


# -- YOLOv3 loss ---------------------------------------------------------------

def _sce(x, label):
    """Elementwise sigmoid cross entropy (``yolov3_loss_op.h`` SCE)."""
    return _sigmoid_ce(x, label)


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True):
    """``vision_extra.py:452-574``: ``x [N, A * (5 + C), H, W]`` raw head
    output (A = ``len(anchor_mask)``), ``gt_box [N, B, 4]`` normalised
    (cx, cy, w, h), ``gt_label [N, B]``; ``anchors`` every (w, h) pair,
    ``anchor_mask`` this head's. Each ground truth's responsible anchor
    is the best shape-IoU over all anchors; location (SCE on x, y, L1 on
    w, h, scaled by ``2 - w * h``), class (SCE on the smoothed one-hot)
    and objectness terms (predictions whose decoded box overlaps a
    ground truth above ``ignore_thresh`` are not pushed to 0). Per-image
    loss ``[N]``."""
    n, _, h, w = x.shape
    a = len(anchor_mask)
    cn = class_num
    dev = x.device
    an_all_np = np.asarray(anchors, np.float32).reshape(-1, 2)
    an_use_np = an_all_np[np.asarray(anchor_mask)]
    an_all = torch.from_numpy(an_all_np).to(dev)
    an_use = torch.from_numpy(an_use_np).to(dev)
    input_size = downsample_ratio * h
    nb = gt_box.shape[1]

    x = x.reshape(n, a, 5 + cn, h, w)
    px, py = x[:, :, 0], x[:, :, 1]
    pw, ph_ = x[:, :, 2], x[:, :, 3]
    pobj = x[:, :, 4]
    pcls = x[:, :, 5:]

    gx, gy = gt_box[..., 0], gt_box[..., 1]
    gw, gh = gt_box[..., 2], gt_box[..., 3]
    valid = (gw > 0) & (gh > 0)
    if gt_score is None:
        gt_score = torch.ones_like(gx)

    # the responsible anchor of each ground truth
    inter = (torch.minimum(gw[..., None], an_all[None, None, :, 0]
                           / input_size)
             * torch.minimum(gh[..., None], an_all[None, None, :, 1]
                             / input_size))
    union = (gw * gh)[..., None] + (an_all[None, None, :, 0]
                                    * an_all[None, None, :, 1]
                                    / input_size ** 2) - inter
    an_iou = inter / jmax(union, 1e-10)
    best_an = torch.argmax(an_iou, dim=-1)
    lookup = np.full((an_all_np.shape[0],), -1, np.int64)
    for li, g in enumerate(np.asarray(anchor_mask)):
        lookup[g] = li
    local_an = torch.from_numpy(lookup).to(dev)[best_an]
    resp = valid & (local_an >= 0)

    gi = torch.clamp((gx * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((gy * h).to(torch.int32), 0, h - 1).long()
    la = torch.clamp_min(local_an, 0)

    # location at the responsible cells
    tx = gx * w - gi
    ty = gy * h - gj
    tw = torch.log(jmax(gw * input_size / an_use[la][..., 0], 1e-9))
    th = torch.log(jmax(gh * input_size / an_use[la][..., 1], 1e-9))
    scale = (2.0 - gw * gh) * gt_score
    bidx = torch.arange(n, device=dev)[:, None].expand(n, nb)
    loc = (_sce(px[bidx, la, gj, gi], tx) + _sce(py[bidx, la, gj, gi], ty)
           + torch.abs(pw[bidx, la, gj, gi] - tw)
           + torch.abs(ph_[bidx, la, gj, gi] - th)) * scale
    loss_loc = torch.where(resp, loc, torch.zeros_like(loc)).sum(1)

    # class at the responsible cells: positives 1 - s, negatives s, s =
    # min(1 / C, 1 / 40)
    smooth = min(1.0 / cn, 1.0 / 40.0) if use_label_smooth else 0.0
    onehot = one_hot(gt_label, cn).to(x.dtype)
    tcls = onehot * (1.0 - smooth) + (1.0 - onehot) * smooth
    pcls_g = pcls.permute(0, 1, 3, 4, 2)[bidx, la, gj, gi]
    cls = (_sce(pcls_g, tcls) * gt_score[..., None]).sum(-1)
    loss_cls = torch.where(resp, cls, torch.zeros_like(cls)).sum(1)

    # objectness: the target by a scatter-max, predictions overlapping a
    # ground truth above ignore_thresh ignored
    kw = dict(dtype=x.dtype, device=dev)
    grid_x = torch.arange(w, **kw)[None, None, None, :]
    grid_y = torch.arange(h, **kw)[None, None, :, None]
    bx = (torch.sigmoid(px) + grid_x) / w
    by = (torch.sigmoid(py) + grid_y) / h
    bw = torch.exp(jclip(pw, -20, 20)) * an_use[:, 0][
        None, :, None, None] / input_size
    bh = torch.exp(jclip(ph_, -20, 20)) * an_use[:, 1][
        None, :, None, None] / input_size

    def corners(cx, cy, bw_, bh_):
        return cx - bw_ / 2, cy - bh_ / 2, cx + bw_ / 2, cy + bh_ / 2

    p1x, p1y, p2x, p2y = (t[:, None] for t in corners(bx, by, bw, bh))
    g1x, g1y, g2x, g2y = (t[..., None, None, None]
                          for t in corners(gx, gy, gw, gh))
    iw = jmax(torch.minimum(p2x, g2x) - torch.maximum(p1x, g1x), 0)
    ih = jmax(torch.minimum(p2y, g2y) - torch.maximum(p1y, g1y), 0)
    inter = iw * ih
    union = (p2x - p1x) * (p2y - p1y) + (g2x - g1x) * (g2y - g1y) - inter
    ious = inter / jmax(union, 1e-10)              # [N,B,A,H,W]
    ious = torch.where(valid[..., None, None, None], ious,
                       torch.zeros_like(ious))
    best_iou = ious.amax(1)

    score_resp = torch.where(resp, gt_score, torch.zeros_like(gt_score))
    flat_idx = ((bidx * a + la) * h + gj) * w + gi
    tobj = torch.zeros(n * a * h * w, **kw).scatter_reduce(
        0, flat_idx.reshape(-1), score_resp.reshape(-1).to(x.dtype),
        reduce="amax", include_self=True).reshape(n, a, h, w)
    ignore = (best_iou > ignore_thresh) & (tobj <= 0)
    zero = torch.zeros_like(pobj)
    obj_pos = torch.where(tobj > 1e-5, _sce(pobj, 1.0) * tobj, zero)
    obj_neg = torch.where((tobj <= 1e-5) & ~ignore, _sce(pobj, 0.0), zero)
    loss_obj = (obj_pos + obj_neg).reshape(n, -1).sum(1)
    return loss_loc + loss_cls + loss_obj


# -- file readers ----------------------------------------------------------------

def read_file(path):
    """The file's bytes, a uint8 CPU tensor."""
    with open(path, "rb") as f:
        data = f.read()
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def decode_jpeg(x, mode="unchanged"):
    """A uint8 byte vector (tensor or array) decoded by PIL (imported
    here, at the call) into a ``[C, H, W]`` uint8 CPU tensor; ``mode``
    ``"gray"`` or ``"rgb"`` converts first."""
    import io

    from PIL import Image
    raw = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x
                     ).astype(np.uint8).tobytes()
    img = Image.open(io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode in ("rgb", "RGB"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(arr.copy())
