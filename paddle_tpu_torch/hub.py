"""Model hub (port of ``paddle_tpu/hub.py``; reference:
``python/paddle/hub.py``: list / help / load over a ``hubconf.py``
protocol).

The reference resolves github: / gitee: sources by downloading a repo
archive; as in the JAX package, remote sources raise and local
directories (``source="local"``) are supported with the same hubconf.py
contract: entrypoints are the public callables in the repo's
hubconf.py, and ``dependencies`` is honoured. The hubconf loads as the
module ``paddle_tpu_torch_hubconf``.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import List

__all__ = ["list", "help", "load"]

_HUBCONF = "hubconf.py"
_MODULE = "paddle_tpu_torch_hubconf"


def _load_hubconf(repo_dir: str):
    path = os.path.join(repo_dir, _HUBCONF)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {_HUBCONF} in {repo_dir!r}")
    spec = importlib.util.spec_from_file_location(_MODULE, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_MODULE] = mod
    spec.loader.exec_module(mod)
    deps = getattr(mod, "dependencies", [])
    missing = []
    for d in deps:
        try:
            importlib.import_module(d)
        except ImportError:
            missing.append(d)
    if missing:
        raise RuntimeError(f"hub repo requires missing packages: {missing}")
    return mod


def _resolve(repo_dir: str, source: str) -> str:
    if source == "local":
        return repo_dir
    raise RuntimeError(
        f"hub source {source!r} needs a download, and paddle_tpu_torch "
        "reads local files only; clone the repo and use source='local'")


def list(repo_dir: str, source: str = "github",  # noqa: A001
         force_reload: bool = False) -> List[str]:
    """reference: paddle.hub.list — entrypoint names in hubconf.py."""
    mod = _load_hubconf(_resolve(repo_dir, source))
    return [k for k, v in vars(mod).items()
            if callable(v) and not k.startswith("_")]


def help(repo_dir: str, model: str, source: str = "github",  # noqa: A001
         force_reload: bool = False) -> str:
    """reference: paddle.hub.help — the entrypoint's docstring."""
    mod = _load_hubconf(_resolve(repo_dir, source))
    fn = getattr(mod, model, None)
    if fn is None or not callable(fn):
        raise ValueError(f"no entrypoint {model!r} in hubconf")
    return fn.__doc__ or ""


def load(repo_dir: str, model: str, source: str = "github",
         force_reload: bool = False, **kwargs):
    """reference: paddle.hub.load — call the entrypoint."""
    mod = _load_hubconf(_resolve(repo_dir, source))
    fn = getattr(mod, model, None)
    if fn is None or not callable(fn):
        raise ValueError(f"no entrypoint {model!r} in hubconf")
    return fn(**kwargs)
