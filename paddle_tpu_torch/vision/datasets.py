"""Built-in datasets (port of ``paddle_tpu/vision/datasets.py``): MNIST,
FashionMNIST, Cifar10 / Cifar100, FakeImageNet, DatasetFolder /
ImageFolder, Flowers and VOC2012, over the port's ``io.Dataset``.

Nothing is fetched: each dataset reads the local files it is given
(MNIST's idx files, raw or gzipped; the Flowers and VOC archives) and
otherwise serves the JAX package's deterministic synthetic samples with
the real shapes and dtypes (Cifar10 / Cifar100 always do, as in JAX).
PIL and scipy are imported inside the calls that need them, so the
module imports on a host without them; ``DatasetFolder`` with a
``loader`` (``np.load`` over ``.npy`` images) needs neither.
"""

from __future__ import annotations

import gzip
import os
import struct
import threading
from typing import Callable, Optional

import numpy as np

from ..io.dataset import Dataset


class _TarReader:
    """Thread- and process-worker-safe random access into a tar archive:
    reads are serialized under a lock (TarFile seeks on ONE file object),
    and pickling drops the handle and reopens lazily in the worker (a
    TarFile itself is unpicklable)."""

    def __init__(self, path: str):
        self.path = path
        self._open()

    def _open(self):
        import tarfile
        self._lock = threading.Lock()
        self._tar = tarfile.open(self.path)
        self.members = {m.name: m for m in self._tar.getmembers()}

    def read(self, name: str) -> bytes:
        with self._lock:
            return self._tar.extractfile(self.members[name]).read()

    def __getstate__(self):
        return {"path": self.path}

    def __setstate__(self, state):
        self.path = state["path"]
        self._open()


class MNIST(Dataset):
    def __init__(self, image_path: Optional[str] = None,
                 label_path: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None, download: bool = True,
                 backend: str = "cv2", synthetic_size: Optional[int] = None):
        self.mode = mode
        self.transform = transform
        if image_path and os.path.exists(image_path):
            self.images, self.labels = self._load_idx(image_path, label_path)
        else:
            n = synthetic_size or (600 if mode == "train" else 100)
            rng = np.random.default_rng(0 if mode == "train" else 1)
            self.labels = rng.integers(0, 10, n).astype(np.int64)
            base = rng.normal(0.1307, 0.3081, (n, 28, 28)).astype(np.float32)
            # encode the label coarsely in the image so training can learn
            for i, lbl in enumerate(self.labels):
                base[i, :3, int(lbl) * 2:int(lbl) * 2 + 2] += 2.0
            self.images = base

    @staticmethod
    def _load_idx(image_path, label_path):
        opener = gzip.open if image_path.endswith(".gz") else open
        with opener(image_path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                n, rows, cols).astype(np.float32) / 255.0
        with opener(label_path, "rb") as f:
            _, n = struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)
        return images, labels

    def __getitem__(self, idx):
        img = self.images[idx][np.newaxis]  # [1, 28, 28]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None, download: bool = True,
                 backend: str = "cv2", synthetic_size: Optional[int] = None):
        self.mode = mode
        self.transform = transform
        self.num_classes = 10
        n = synthetic_size or (500 if mode == "train" else 100)
        rng = np.random.default_rng(2 if mode == "train" else 3)
        self.labels = rng.integers(0, self.num_classes, n).astype(np.int64)
        self.images = rng.normal(0.5, 0.25, (n, 3, 32, 32)).astype(
            np.float32)
        for i, lbl in enumerate(self.labels):
            self.images[i, 0, :2, int(lbl) * 3:int(lbl) * 3 + 3] += 1.5

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_classes = 100


class FakeImageNet(Dataset):
    """Synthetic ImageNet-shaped dataset for ResNet-50 benchmarks."""

    def __init__(self, size: int = 1024, image_shape=(3, 224, 224),
                 num_classes: int = 1000, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self._seed = seed

    def __getitem__(self, idx):
        rng = np.random.default_rng(self._seed + idx)
        img = rng.standard_normal(self.image_shape).astype(np.float32)
        label = np.int64(idx % self.num_classes)
        return img, label

    def __len__(self):
        return self.size


_IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm",
                   ".tif", ".tiff", ".webp")


class DatasetFolder(Dataset):
    """Directory-per-class image dataset (reference:
    python/paddle/vision/datasets/folder.py DatasetFolder):
    root/class_x/xxx.png layout; samples are (image, class_index)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or self._default_loader
        extensions = extensions or _IMG_EXTENSIONS
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise RuntimeError(f"no class folders under {root!r}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fname in sorted(files):
                    path = os.path.join(dirpath, fname)
                    ok = (is_valid_file(path) if is_valid_file else
                          fname.lower().endswith(tuple(extensions)))
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(f"no image files under {root!r}")

    @staticmethod
    def _default_loader(path):
        from . import image_load
        return np.asarray(image_load(path))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat image dataset without labels (reference: vision/datasets/
    folder.py ImageFolder): every image under root; samples are
    [image]."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or DatasetFolder._default_loader
        extensions = extensions or _IMG_EXTENSIONS
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                path = os.path.join(dirpath, fname)
                ok = (is_valid_file(path) if is_valid_file else
                      fname.lower().endswith(tuple(extensions)))
                if ok:
                    self.samples.append(path)
        if not self.samples:
            raise RuntimeError(f"no image files under {root!r}")

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


class Flowers(Dataset):
    """Flowers-102 (reference: vision/datasets/flowers.py). Given the
    official archives — ``data_file`` 102flowers.tgz (jpg/image_%05d.jpg
    members), ``label_file`` imagelabels.mat ('labels', 1-indexed),
    ``setid_file`` setid.mat ('trnid'/'valid'/'tstid' image indices) —
    parses the real formats (scipy.io + PIL decode). Otherwise serves a
    deterministic synthetic set with the real shapes.

    Mirrors the reference's split swap (flowers.py MODE_FLAG_MAP):
    'train' reads the (larger) tstid list, 'test' reads trnid."""

    _SPLIT_SIZES = {"train": 60, "valid": 20, "test": 60}
    _MODE_FLAG = {"train": "tstid", "test": "trnid", "valid": "valid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self._tar = None
        if data_file and os.path.exists(data_file):
            if not (label_file and os.path.exists(label_file) and
                    setid_file and os.path.exists(setid_file)):
                raise ValueError(
                    "Flowers needs label_file (imagelabels.mat) and "
                    "setid_file (setid.mat) together with data_file")
            import scipy.io as scio
            self._labels_mat = scio.loadmat(label_file)["labels"][0]
            self._indexes = scio.loadmat(setid_file)[
                self._MODE_FLAG.get(mode.lower(), "valid")][0]
            self._tar = _TarReader(data_file)
            return
        n = self._SPLIT_SIZES.get(mode, 60)
        # per-mode seeds: splits must be disjoint image sets
        rng = np.random.RandomState(
            102 + {"train": 0, "valid": 1, "test": 2}.get(mode, 3))
        self._images = (rng.rand(n, 64, 64, 3) * 255).astype("uint8")
        # labels shaped [1] like the real-archive path (reference
        # flowers.py:127 returns np.array([label]))
        self._labels = (rng.randint(0, 102, size=(n, 1))).astype("int64")

    def __getitem__(self, idx):
        if self._tar is not None:
            import io as _io

            from PIL import Image
            index = int(self._indexes[idx])
            name = "jpg/image_%05d.jpg" % index
            img = np.asarray(Image.open(_io.BytesIO(self._tar.read(name))))
            label = np.array([self._labels_mat[index - 1]], "int64")
            if self.transform is not None:
                img = self.transform(img)
            return img, label
        img = self._images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self._labels[idx]

    def __len__(self):
        if self._tar is not None:
            return len(self._indexes)
        return len(self._images)


class VOC2012(Dataset):
    """Pascal VOC 2012 segmentation (reference: vision/datasets/voc2012.py):
    samples are (image, segmentation mask). Given the official
    VOCtrainval tar via ``data_file``, parses the real layout
    (ImageSets/Segmentation/{mode}.txt -> JPEGImages/*.jpg +
    SegmentationClass/*.png, PIL-decoded). A directory of (img, mask)
    .npy pairs also works; otherwise serves deterministic synthetic
    pairs with real shapes/dtypes."""

    _SET = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
    _IMG = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
    _MASK = "VOCdevkit/VOC2012/SegmentationClass/{}.png"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self._tar = None
        if data_file and os.path.isfile(data_file):
            self._tar = _TarReader(data_file)
            # reference MODE_FLAG_MAP (vision/datasets/voc2012.py:37):
            # train -> trainval, test -> train, valid -> val
            flag = {"train": "trainval", "valid": "val",
                    "test": "train"}.get(mode, "trainval")
            listing = self._tar.read(self._SET.format(flag))
            self._names = [ln.strip().decode()
                           for ln in listing.splitlines() if ln.strip()]
            self._pairs = None
        elif data_file and os.path.isdir(data_file):
            files = sorted(f for f in os.listdir(data_file)
                           if f.endswith("_img.npy"))
            self._pairs = [
                (np.load(os.path.join(data_file, f)),
                 np.load(os.path.join(data_file,
                                      f.replace("_img", "_mask"))))
                for f in files]
        else:
            n = {"train": 24, "valid": 8, "test": 8}.get(mode, 8)
            rng = np.random.RandomState(2012)
            self._pairs = [((rng.rand(96, 96, 3) * 255).astype("uint8"),
                            rng.randint(0, 21, size=(96, 96)).astype(
                                "int64")) for _ in range(n)]

    def __getitem__(self, idx):
        if self._tar is not None:
            import io as _io

            from PIL import Image
            name = self._names[idx]
            img = np.asarray(Image.open(_io.BytesIO(
                self._tar.read(self._IMG.format(name)))))
            mask = np.asarray(Image.open(_io.BytesIO(
                self._tar.read(self._MASK.format(name)))), dtype="int64")
        else:
            img, mask = self._pairs[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        if self._tar is not None:
            return len(self._names)
        return len(self._pairs)
