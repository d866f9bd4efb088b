"""The kernel cache (``core/compile_cache.py``) on the CPU.

The directory resolution is the JAX package's (``PADDLE_TPU_COMPILE_
CACHE``, an explicit path winning over it, None when off); in the port
the directory is where ``ops/kernels/_build.py`` builds and finds the
kernel library. A cache that holds the library of the current digest
serves it without ``nvcc``; an empty one gets it built there (a stub
stands in for ``nvcc``, as in ``tests/test_torch_build_lock.py``), and
without ``nvcc`` that build raises. Once a library is loaded, the cache
refuses to move: one process loads one copy.
"""

import _torch_threads  # noqa: F401

import os

import pytest

import paddle_tpu.core.compile_cache as jcc
import paddle_tpu_torch.core.compile_cache as tcc
from paddle_tpu_torch.ops.kernels import _build
from test_torch_build_lock import _stub


@pytest.fixture(autouse=True)
def _no_cache(monkeypatch):
    monkeypatch.delenv(tcc.ENV_VAR, raising=False)
    monkeypatch.setattr(tcc, "_enabled_dir", None)
    monkeypatch.setattr(_build, "_lib_dir", None)
    yield


@pytest.mark.parametrize("side", ["jax", "port"])
def test_directory_resolution_matches_jax(side, tmp_path, monkeypatch):
    cc = jcc if side == "jax" else tcc
    try:
        assert cc.ENV_VAR == "PADDLE_TPU_COMPILE_CACHE"
        assert cc.enable_compile_cache() is None
        assert cc.compile_cache_dir() is None
        monkeypatch.setenv(cc.ENV_VAR, str(tmp_path / "env"))
        assert cc.enable_compile_cache() == str(tmp_path / "env")
        assert os.path.isdir(tmp_path / "env")
        rel = os.path.relpath(tmp_path / "explicit")
        assert cc.enable_compile_cache(rel) == str(tmp_path / "explicit")
        assert cc.compile_cache_dir() == str(tmp_path / "explicit")
        cc.disable_compile_cache()
        assert cc.compile_cache_dir() is None
        monkeypatch.setenv(cc.ENV_VAR, "  ")
        assert cc.enable_compile_cache() is None
    finally:
        cc.disable_compile_cache()


def test_the_cache_names_where_the_library_is_built(tmp_path):
    assert _build.build_dir() == _build.BUILD_DIR
    tcc.enable_compile_cache(str(tmp_path))
    assert _build.build_dir() == str(tmp_path)
    assert _build.ptxas_report_path().startswith(str(tmp_path))
    tcc.disable_compile_cache()
    assert _build.build_dir() == _build.BUILD_DIR


def _fake_library(directory):
    """A library of the current digest, as a build leaves it."""
    os.makedirs(directory, exist_ok=True)
    lib = os.path.join(directory, _build.LIB_NAME)
    with open(lib, "w") as f:
        f.write("built")
    with open(lib + ".hash", "w") as f:
        f.write(_build.source_hash())
    return lib


def _no_nvcc():
    raise AssertionError("nvcc was called")


def test_a_filled_cache_serves_the_library_without_nvcc(tmp_path,
                                                        monkeypatch):
    lib = _fake_library(tmp_path / "filled")
    monkeypatch.setattr(_build, "_nvcc", _no_nvcc)
    monkeypatch.setenv(tcc.ENV_VAR, str(tmp_path / "filled"))
    assert _build.build() == lib
    assert tcc.compile_cache_dir() == str(tmp_path / "filled")
    assert sorted(os.listdir(tmp_path / "filled")) == sorted(
        [_build.LIB_NAME, _build.LIB_NAME + ".hash"])


def test_an_empty_cache_builds_there(tmp_path, monkeypatch):
    stub = _stub(tmp_path)
    monkeypatch.setenv("STUB_LOG", str(tmp_path / "calls.log"))
    monkeypatch.setattr(_build, "_nvcc", lambda: stub)
    tcc.enable_compile_cache(str(tmp_path / "empty"))
    path = _build.build()
    assert path == str(tmp_path / "empty" / _build.LIB_NAME)
    with open(path + ".hash") as f:
        assert f.read() == _build.source_hash()
    with open(tmp_path / "calls.log") as f:
        assert len(f.read().splitlines()) == 1 + sum(
            s.endswith(".cu") for s in _build._sources())


def test_without_nvcc_an_empty_cache_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    tcc.enable_compile_cache(str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not os.path.exists(tmp_path / "empty" / _build.LIB_NAME)


def test_a_loaded_library_pins_the_cache(tmp_path, monkeypatch):
    """Once the library is loaded from a directory, a call that would
    move the cache raises; naming that directory changes nothing."""
    monkeypatch.setattr(_build, "_lib_dir", str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="already loaded"):
        tcc.enable_compile_cache(str(tmp_path / "b"))
    assert tcc.compile_cache_dir() is None
    assert tcc.enable_compile_cache(str(tmp_path / "a")) == \
        str(tmp_path / "a")
    with pytest.raises(RuntimeError, match="one process loads one copy"):
        tcc.disable_compile_cache()
    assert tcc.compile_cache_dir() == str(tmp_path / "a")
    # loaded from build/kernels/: the cache stays off
    monkeypatch.setattr(tcc, "_enabled_dir", None)
    monkeypatch.setattr(_build, "_lib_dir", _build.BUILD_DIR)
    monkeypatch.setenv(tcc.ENV_VAR, str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="already loaded"):
        tcc.enable_compile_cache()
    tcc.disable_compile_cache()
    assert tcc.compile_cache_dir() is None
    assert _build.loaded_from() == _build.BUILD_DIR


def test_the_engine_turns_the_cache_on(tmp_path, monkeypatch):
    from paddle_tpu_torch.inference import create_decode_engine
    from paddle_tpu_torch.models import gpt as tgpt
    monkeypatch.setenv(tcc.ENV_VAR, str(tmp_path / "engine"))
    model = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    eng = create_decode_engine(model, device="cpu", num_slots=1,
                               page_size=8, num_pages=4)
    eng.close()
    assert tcc.compile_cache_dir() == str(tmp_path / "engine")
