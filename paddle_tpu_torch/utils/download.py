"""Weight / dataset path cache (port of ``paddle_tpu/utils/download.py``;
reference: ``python/paddle/utils/download.py``
``get_weights_path_from_url:75``, ``get_path_from_url:121``).

Same cache layout (``~/.cache/paddle_tpu/weights/<name>``), md5 check
and archive decompression. Ported in part: the port reads local files
only. A ``file://`` URL is copied into the cache, a file already in the
cache is used as it is, and an ``http(s)://`` URL that is not cached
raises, where the JAX package fetches it with ``urllib``.
"""

from __future__ import annotations

import hashlib
import os
import os.path as osp
import shutil
import tarfile
import zipfile

WEIGHTS_HOME = osp.expanduser("~/.cache/paddle_tpu/weights")

__all__ = ["get_weights_path_from_url", "get_path_from_url", "is_url"]


def is_url(path: str) -> bool:
    return path.startswith(("http://", "https://", "file://"))


def _md5check(fullname: str, md5sum: str | None) -> bool:
    if md5sum is None:
        return True
    md5 = hashlib.md5()
    with open(fullname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            md5.update(chunk)
    return md5.hexdigest() == md5sum


def _download(url: str, path: str) -> str:
    os.makedirs(path, exist_ok=True)
    fname = osp.split(url)[-1]
    fullname = osp.join(path, fname)
    if url.startswith("file://"):
        shutil.copy(url[len("file://"):], fullname)
        return fullname
    raise RuntimeError(
        f"{url} is not in the cache ({fullname}) and paddle_tpu_torch "
        f"reads local files only: place the file there or pass a "
        f"file:// URL")


def _decompress(fname: str) -> str:
    """Extract beside the archive. Returns the single top-level directory
    when the archive has one (the usual weights layout), else the
    directory holding the extracted members."""
    dirpath = osp.dirname(fname)
    if tarfile.is_tarfile(fname):
        with tarfile.open(fname) as tf:
            names = tf.getnames()
            tf.extractall(dirpath, filter="data")
    elif zipfile.is_zipfile(fname):
        with zipfile.ZipFile(fname) as zf:
            names = zf.namelist()
            zf.extractall(dirpath)
    else:
        return fname
    roots = {n.split("/")[0] for n in names if n}
    if len(roots) == 1:
        top = osp.join(dirpath, next(iter(roots)))
        if osp.isdir(top):
            return top
    return dirpath


def get_path_from_url(url: str, root_dir: str | None = None,
                      md5sum: str | None = None,
                      check_exist: bool = True,
                      decompress: bool = True) -> str:
    """Copy (or reuse the cached) ``url`` under ``root_dir``; optionally
    unpack it."""
    root_dir = root_dir or WEIGHTS_HOME
    fname = osp.split(url)[-1]
    fullname = osp.join(root_dir, fname)
    marker = fullname + ".extracted"
    if check_exist and osp.exists(fullname) and _md5check(fullname, md5sum):
        cached = True
    else:
        fullname = _download(url, root_dir)
        if not _md5check(fullname, md5sum):
            raise RuntimeError(f"md5 mismatch for {url}")
        cached = False
    if decompress and (tarfile.is_tarfile(fullname)
                       or zipfile.is_zipfile(fullname)):
        # skip re-extraction on cache hits (marker records the result path)
        if cached and osp.exists(marker):
            with open(marker) as f:
                return f.read().strip()
        out = _decompress(fullname)
        with open(marker, "w") as f:
            f.write(out)
        return out
    return fullname


def get_weights_path_from_url(url: str, md5sum: str | None = None) -> str:
    """The weights in the shared cache: their local path."""
    return get_path_from_url(url, WEIGHTS_HOME, md5sum, decompress=False)
