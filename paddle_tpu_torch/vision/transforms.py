"""Image transforms (port of ``paddle_tpu/vision/transforms.py``): numpy
host-side transforms of HWC (or CHW) images, with the JAX package's
semantics kept:

- ``Resize`` is always the half-pixel linear resize, antialiased when it
  downsamples (``jax.image.resize``; ``ops/nn_functional.py``
  ``resize_host`` here, in numpy), whatever ``interpolation`` says, and
  returns float32 from a uint8 image. So after a ``Resize`` (and a ``RandomResizedCrop``),
  ``ToTensor`` does not divide by 255.
- Random draws come from numpy's global stream in JAX's order: seeding
  ``np.random`` gives both packages the same crops, flips and jitter.
"""

from __future__ import annotations

import numbers

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class ToTensor:
    """HWC uint8 -> CHW float32/255 (no-op on already-CHW float)."""

    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format
        self.keys = keys

    def __call__(self, img):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[None]
        elif img.ndim == 3 and img.shape[-1] in (1, 3, 4) and \
                img.shape[0] not in (1, 3, 4):
            img = np.transpose(img, (2, 0, 1))
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        out = img.astype(np.float32)
        if getattr(self, "data_format", "CHW") == "HWC":
            out = np.transpose(out, (1, 2, 0))
        return out


class Normalize:
    def __init__(self, mean, std, data_format="CHW", to_rgb=False,
                 keys=None):
        self.keys = keys
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, dtype=np.float32)
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


class Resize:
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.keys = keys
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def __call__(self, img):
        from ..ops.nn_functional import resize_host
        img = np.asarray(img)
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        h_ax, w_ax = (1, 2) if chw else (0, 1)
        shape = list(img.shape)
        shape[h_ax], shape[w_ax] = self.size
        return resize_host(img, shape, "linear")


class CenterCrop:
    def __init__(self, size, keys=None):
        self.keys = keys
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def __call__(self, img):
        img = np.asarray(img)
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        h_ax, w_ax = (1, 2) if chw else (0, 1)
        th, tw = self.size
        i = max((img.shape[h_ax] - th) // 2, 0)
        j = max((img.shape[w_ax] - tw) // 2, 0)
        sl = [slice(None)] * img.ndim
        sl[h_ax] = slice(i, i + th)
        sl[w_ax] = slice(j, j + tw)
        return img[tuple(sl)]


class RandomCrop:
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode
        self.keys = keys

    def __call__(self, img):
        img = np.asarray(img)
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        h_ax, w_ax = (1, 2) if chw else (0, 1)
        mode = {"constant": "constant", "edge": "edge",
                "reflect": "reflect", "symmetric": "symmetric"}[
            self.padding_mode]
        kw = {"constant_values": self.fill} if mode == "constant" else {}
        if self.padding:
            pad = [(0, 0)] * img.ndim
            pad[h_ax] = (self.padding, self.padding)
            pad[w_ax] = (self.padding, self.padding)
            img = np.pad(img, pad, mode=mode, **kw)
        th, tw = self.size
        if self.pad_if_needed and (img.shape[h_ax] < th or
                                   img.shape[w_ax] < tw):
            pad = [(0, 0)] * img.ndim
            pad[h_ax] = (0, max(0, th - img.shape[h_ax]))
            pad[w_ax] = (0, max(0, tw - img.shape[w_ax]))
            img = np.pad(img, pad, mode=mode, **kw)
        i = np.random.randint(0, img.shape[h_ax] - th + 1)
        j = np.random.randint(0, img.shape[w_ax] - tw + 1)
        sl = [slice(None)] * img.ndim
        sl[h_ax] = slice(i, i + th)
        sl[w_ax] = slice(j, j + tw)
        return img[tuple(sl)]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob
        self.keys = keys

    def __call__(self, img):
        img = np.asarray(img)
        if np.random.random() < self.prob:
            chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
            return np.flip(img, axis=2 if chw else 1).copy()
        return img


class RandomVerticalFlip:
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob
        self.keys = keys

    def __call__(self, img):
        img = np.asarray(img)
        if np.random.random() < self.prob:
            chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
            return np.flip(img, axis=1 if chw else 0).copy()
        return img


class Transpose:
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order
        self.keys = keys

    def __call__(self, img):
        return np.transpose(np.asarray(img), self.order)


# ---------------------------------------------------------------------------
# functional API (reference: python/paddle/vision/transforms/functional.py;
# numpy HWC images, uint8 or float; CHW tolerated where axes are detectable)
# ---------------------------------------------------------------------------

def _axes(img):
    chw = img.ndim == 3 and img.shape[0] in (1, 3, 4) and \
        img.shape[-1] not in (1, 3, 4)
    return ((1, 2), 0) if chw else ((0, 1), (2 if img.ndim == 3 else None))


def to_tensor(pic, data_format="CHW"):
    """reference: F.to_tensor — HWC uint8 -> float32/255 in CHW."""
    out = ToTensor()(pic)
    if data_format == "HWC":
        out = np.transpose(out, (1, 2, 0))
    return out


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    """reference: F.normalize."""
    return Normalize(mean, std, data_format)(img)


def hflip(img):
    """reference: F.hflip."""
    img = np.asarray(img)
    (h_ax, w_ax), _ = _axes(img)
    return np.flip(img, axis=w_ax).copy()


def vflip(img):
    """reference: F.vflip."""
    img = np.asarray(img)
    (h_ax, w_ax), _ = _axes(img)
    return np.flip(img, axis=h_ax).copy()


def resize(img, size, interpolation="bilinear"):
    """reference: F.resize; int size scales the short edge."""
    img = np.asarray(img)
    (h_ax, w_ax), _ = _axes(img)
    if isinstance(size, numbers.Number):
        h, w = img.shape[h_ax], img.shape[w_ax]
        short, long = (h, w) if h < w else (w, h)
        ns = int(size)
        nl = int(round(long * ns / short))
        size = (ns, nl) if h < w else (nl, ns)
    return Resize(tuple(size), interpolation)(img)


def crop(img, top, left, height, width):
    """reference: F.crop."""
    img = np.asarray(img)
    (h_ax, w_ax), _ = _axes(img)
    sl = [slice(None)] * img.ndim
    sl[h_ax] = slice(top, top + height)
    sl[w_ax] = slice(left, left + width)
    return img[tuple(sl)]


def center_crop(img, output_size):
    """reference: F.center_crop."""
    return CenterCrop(output_size)(img)


def pad(img, padding, fill=0, padding_mode="constant"):
    """reference: F.pad; padding int or (l, t) or (l, t, r, b)."""
    img = np.asarray(img)
    (h_ax, w_ax), _ = _axes(img)
    if isinstance(padding, numbers.Number):
        pl = pt_ = pr = pb = int(padding)
    elif len(padding) == 2:
        pl, pt_ = padding
        pr, pb = padding
    else:
        pl, pt_, pr, pb = padding
    spec = [(0, 0)] * img.ndim
    spec[h_ax] = (pt_, pb)
    spec[w_ax] = (pl, pr)
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    return np.pad(img, spec, mode=mode, **kw)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """reference: F.rotate — counter-clockwise degrees, inverse-map
    sampling (nearest or bilinear)."""
    img = np.asarray(img)
    (h_ax, w_ax), c_ax = _axes(img)
    hwc = img if c_ax != 0 else np.transpose(img, (1, 2, 0))
    if hwc.ndim == 2:
        hwc = hwc[:, :, None]
        squeeze = True
    else:
        squeeze = False
    h, w = hwc.shape[0], hwc.shape[1]
    # positive angle = counter-clockwise (PIL convention); the image
    # y-axis points down, so negate the angle for the math-convention
    # rotation below
    theta = -np.deg2rad(angle)
    cos, sin = np.cos(theta), np.sin(theta)
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None else \
        (center[1], center[0])
    if expand:
        # round before ceil: cos(90deg) is ~6e-17, not 0, and the epsilon
        # must not bump the size by one
        nh = int(np.ceil(np.round(abs(h * cos) + abs(w * sin), 6)))
        nw = int(np.ceil(np.round(abs(w * cos) + abs(h * sin), 6)))
        ocy, ocx = (nh - 1) / 2.0, (nw - 1) / 2.0
    else:
        # rotate about the pivot: src = R^-1(out - c) + c, so the
        # outgoing offset must use the same pivot as the incoming one
        nh, nw = h, w
        ocy, ocx = cy, cx
    yy, xx = np.meshgrid(np.arange(nh), np.arange(nw), indexing="ij")
    # inverse rotation: output pixel -> source coordinate
    ys = (yy - ocy) * cos - (xx - ocx) * sin + cy
    xs = (yy - ocy) * sin + (xx - ocx) * cos + cx
    if interpolation == "nearest":
        yi = np.round(ys).astype(np.int64)
        xi = np.round(xs).astype(np.int64)
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        out = np.full((nh, nw, hwc.shape[2]), fill, dtype=hwc.dtype)
        out[valid] = hwc[yi[valid], xi[valid]]
    else:  # bilinear
        y0 = np.floor(ys).astype(np.int64)
        x0 = np.floor(xs).astype(np.int64)
        wy = (ys - y0)[..., None]
        wx = (xs - x0)[..., None]
        acc = np.zeros((nh, nw, hwc.shape[2]), np.float32)
        wsum = np.zeros((nh, nw, 1), np.float32)
        for dy, dx, wgt in ((0, 0, (1 - wy) * (1 - wx)),
                            (0, 1, (1 - wy) * wx),
                            (1, 0, wy * (1 - wx)),
                            (1, 1, wy * wx)):
            yi, xi = y0 + dy, x0 + dx
            valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
            yc, xc = np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)
            acc += np.where(valid, wgt * hwc[yc, xc].astype(np.float32), 0)
            wsum += np.where(valid, wgt, 0)
        out = np.where(wsum > 0, acc / np.maximum(wsum, 1e-8), fill)
        out = out.astype(hwc.dtype)
    if squeeze:
        out = out[:, :, 0]
    if c_ax == 0 and out.ndim == 3:
        out = np.transpose(out, (2, 0, 1))
    return out


def to_grayscale(img, num_output_channels=1):
    """reference: F.to_grayscale (ITU-R 601-2 luma)."""
    img = np.asarray(img)
    (h_ax, w_ax), c_ax = _axes(img)
    if img.ndim == 2:
        g = img.astype(np.float32)
    else:
        hwc = img if c_ax != 0 else np.transpose(img, (1, 2, 0))
        if hwc.shape[2] == 1:
            g = hwc[:, :, 0].astype(np.float32)
        else:
            g = (0.299 * hwc[..., 0] + 0.587 * hwc[..., 1] +
                 0.114 * hwc[..., 2]).astype(np.float32)
    g = g.astype(img.dtype) if img.dtype == np.uint8 else g
    out = np.repeat(g[:, :, None], num_output_channels, axis=2)
    if c_ax == 0 and img.ndim == 3:
        out = np.transpose(out, (2, 0, 1))
    return out


def _blend(a, b, factor, dtype):
    out = factor * a.astype(np.float32) + (1 - factor) * b
    if np.issubdtype(np.dtype(dtype), np.integer):
        out = np.clip(out, 0, 255)
    return out.astype(dtype)


def adjust_brightness(img, brightness_factor):
    """reference: F.adjust_brightness — blend with black."""
    img = np.asarray(img)
    return _blend(img, 0.0, brightness_factor, img.dtype)


def adjust_contrast(img, contrast_factor):
    """reference: F.adjust_contrast — blend with the grayscale mean."""
    img = np.asarray(img)
    mean = to_grayscale(img).astype(np.float32).mean()
    return _blend(img, mean, contrast_factor, img.dtype)


def adjust_saturation(img, saturation_factor):
    """reference: F.adjust_saturation — blend with grayscale."""
    img = np.asarray(img)
    (h_ax, w_ax), c_ax = _axes(img)
    gray = to_grayscale(img, 3 if img.ndim == 3 else 1)
    return _blend(img, gray.astype(np.float32), saturation_factor,
                  img.dtype)


def adjust_hue(img, hue_factor):
    """reference: F.adjust_hue — shift hue in HSV space;
    hue_factor in [-0.5, 0.5]."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    img = np.asarray(img)
    (h_ax, w_ax), c_ax = _axes(img)
    hwc = img if c_ax != 0 else np.transpose(img, (1, 2, 0))
    scale = 255.0 if img.dtype == np.uint8 else 1.0
    rgb = hwc.astype(np.float32) / scale
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    hch = np.where(mx == r, ((g - b) / diff) % 6,
                   np.where(mx == g, (b - r) / diff + 2,
                            (r - g) / diff + 4)) / 6.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    v = mx
    hch = (hch + hue_factor) % 1.0
    i = np.floor(hch * 6.0)
    f = hch * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    out = np.stack([r2, g2, b2], axis=-1) * scale
    if img.dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255)
    out = out.astype(img.dtype)
    if c_ax == 0:
        out = np.transpose(out, (2, 0, 1))
    return out


# ---------------------------------------------------------------------------
# transform classes over the functional API
# ---------------------------------------------------------------------------

class BaseTransform:
    """reference: paddle.vision.transforms.BaseTransform — subclasses
    implement _apply_image (and optionally _apply_{coords,boxes,mask});
    __call__ routes plain images through _apply_image."""

    def __init__(self, keys=None):
        self.keys = keys

    def _apply_image(self, img):
        raise NotImplementedError

    def __call__(self, inputs):
        if self.keys is None or isinstance(inputs, np.ndarray):
            return self._apply_image(np.asarray(inputs))
        outs = []
        for key, data in zip(self.keys, inputs):
            fn = getattr(self, f"_apply_{key}", None)
            outs.append(fn(data) if fn else data)
        return tuple(outs)


class BrightnessTransform(BaseTransform):
    """reference: BrightnessTransform(value) — random factor in
    [max(0, 1-value), 1+value]."""

    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("brightness value must be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("contrast value must be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("saturation value must be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(-self.value, self.value)
        return adjust_hue(img, f)


class ColorJitter(BaseTransform):
    """reference: ColorJitter(brightness, contrast, saturation, hue) —
    applies the four jitters in random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.transforms = [BrightnessTransform(brightness),
                           ContrastTransform(contrast),
                           SaturationTransform(saturation),
                           HueTransform(hue)]

    def _apply_image(self, img):
        order = np.random.permutation(len(self.transforms))
        for i in order:
            img = self.transforms[i]._apply_image(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class RandomResizedCrop(BaseTransform):
    """reference: RandomResizedCrop(size, scale, ratio) — random area +
    aspect crop, resized to size."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        img = np.asarray(img)
        (h_ax, w_ax), _ = _axes(img)
        h, w = img.shape[h_ax], img.shape[w_ax]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            log_r = np.log(np.asarray(self.ratio))
            ar = np.exp(np.random.uniform(log_r[0], log_r[1]))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                top = np.random.randint(0, h - ch + 1)
                left = np.random.randint(0, w - cw + 1)
                patch = crop(img, top, left, ch, cw)
                return Resize(self.size, self.interpolation)(patch)
        return Resize(self.size, self.interpolation)(
            CenterCrop(min(h, w))(img))


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, self.interpolation, self.expand,
                      self.center, self.fill)
