"""The FFT family (port of ``paddle_tpu/ops/fft.py``): ``torch.fft``
with JAX's ``norm`` names (``"backward"``, ``"ortho"``, ``"forward"``),
complex64 outputs under the x32 policy (a real input is taken as
float32 first) and the ``dtype`` argument of ``fftfreq`` /
``rfftfreq``, whose result lies on the expected place. cuFFT computes
them on the card, pocketfft on the CPU.
"""

from __future__ import annotations

import torch

from ._eager import axes as _axes, device_of, floating, tensor


def _in(x):
    return floating(tensor(x))


def _s(s):
    return None if s is None else tuple(int(v) for v in s)


def fft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.fft(_in(x), n=n, dim=int(axis), norm=norm)


def ifft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ifft(_in(x), n=n, dim=int(axis), norm=norm)


def rfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.rfft(_in(x), n=n, dim=int(axis), norm=norm)


def irfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.irfft(_in(x), n=n, dim=int(axis), norm=norm)


def hfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.hfft(_in(x), n=n, dim=int(axis), norm=norm)


def ihfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ihfft(_in(x), n=n, dim=int(axis), norm=norm)


def fft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.fft2(_in(x), s=_s(s), dim=_axes(axes), norm=norm)


def ifft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.ifft2(_in(x), s=_s(s), dim=_axes(axes), norm=norm)


def rfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.rfft2(_in(x), s=_s(s), dim=_axes(axes), norm=norm)


def irfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.irfft2(_in(x), s=_s(s), dim=_axes(axes), norm=norm)


def fftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.fftn(_in(x), s=_s(s), dim=_axes(axes), norm=norm)


def ifftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.ifftn(_in(x), s=_s(s), dim=_axes(axes), norm=norm)


def fftshift(x, axes=None):
    return torch.fft.fftshift(tensor(x), dim=_axes(axes))


def ifftshift(x, axes=None):
    return torch.fft.ifftshift(tensor(x), dim=_axes(axes))


def _freq_dtype(dtype):
    from ..core.dtype import convert_dtype
    return torch.float32 if dtype is None else convert_dtype(dtype)


def fftfreq(n, d=1.0, dtype=None):
    return torch.fft.fftfreq(int(n), d=d, dtype=torch.float32,
                             device=device_of()).to(_freq_dtype(dtype))


def rfftfreq(n, d=1.0, dtype=None):
    return torch.fft.rfftfreq(int(n), d=d, dtype=torch.float32,
                              device=device_of()).to(_freq_dtype(dtype))
