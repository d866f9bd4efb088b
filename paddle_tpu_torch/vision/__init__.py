"""paddle_tpu_torch.vision (port of ``paddle_tpu/vision/``): the models,
``ops``, ``transforms`` and ``datasets``, and the image backend
setting."""

from . import datasets, models, ops, transforms  # noqa: F401

_image_backend = "pil"


def set_image_backend(backend: str) -> None:
    """``'pil'`` or ``'cv2'``."""
    if backend not in ("pil", "cv2"):
        raise ValueError(f"unsupported image backend {backend!r}, "
                         "expected 'pil' or 'cv2'")
    global _image_backend
    _image_backend = backend


def get_image_backend() -> str:
    return _image_backend


def image_load(path: str, backend=None):
    """The image at ``path`` through the backend (PIL's ``Image.open``,
    or ``cv2.imread`` where OpenCV is installed), imported at the
    call."""
    backend = backend or _image_backend
    if backend == "cv2":
        try:
            import cv2
            return cv2.imread(path)
        except ImportError:
            raise ImportError("cv2 backend requested but OpenCV is not "
                              "installed; use the 'pil' backend") from None
    from PIL import Image
    return Image.open(path)
