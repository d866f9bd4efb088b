"""The port's ``distribution``, ``utils``, ``sysconfig`` and ``incubate``
against the JAX package's, on the CPU.

Densities, probabilities, entropies and divergences within 1e-6
relative of JAX's (the same float32 formulas); the argument checks raise
what JAX raises; draws are held to statistics, as the random ops are
(the mean within 5 standard errors, the variance within 10%, over 20000
draws; a seed repeats its draw). ``download`` copies ``file://`` URLs and
unpacks local tar and zip archives to the paths JAX gives, with the same
contents.
"""

import _torch_threads  # noqa: F401

import hashlib
import os
import tarfile
import warnings
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distribution as jdist
import paddle_tpu_torch as paddle
import paddle_tpu_torch.distribution as tdist
from paddle_tpu_torch.core import place

N_DRAWS = 20000


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    place.set_device("cpu")
    yield
    place.reset_device()


def _v(x):
    return np.asarray(x.value if hasattr(x, "value") else x)


def _close(got, want):
    got, want = _v(got), _v(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


LOC = np.array([0.1, -1.0, 2.5], np.float32)
SCALE = np.array([1.0, 0.5, 2.0], np.float32)
VALUE = np.array([0.3, -0.2, 9.0], np.float32)
LOGITS = np.log(np.array([[0.2, 0.3, 0.5], [0.6, 0.3, 0.1]], np.float32))


def _pair(name):
    """The same distribution built in both packages."""
    if name == "normal":
        half, wide = np.array([0.5], np.float32), np.array([1.5], np.float32)
        return (jdist.Normal(LOC, SCALE), tdist.Normal(LOC, SCALE),
                jdist.Normal(half, wide), tdist.Normal(half, wide))
    if name == "normal_floats":
        return (jdist.Normal(0.25, 2.0), tdist.Normal(0.25, 2.0),
                jdist.Normal(1.0, 1.0), tdist.Normal(1.0, 1.0))
    if name == "uniform":
        return (jdist.Uniform(np.zeros(3, np.float32), SCALE * 4),
                tdist.Uniform(np.zeros(3, np.float32), SCALE * 4), None,
                None)
    return (jdist.Categorical(LOGITS), tdist.Categorical(LOGITS),
            jdist.Categorical(LOGITS[::-1].copy()),
            tdist.Categorical(LOGITS[::-1].copy()))


@pytest.mark.parametrize("name", ["normal", "normal_floats", "uniform",
                                  "categorical"])
def test_densities_entropy_kl_match_jax(name):
    j, t, j2, t2 = _pair(name)
    _close(t.entropy(), j.entropy())
    if name == "categorical":
        idx = np.array([[0], [2]], np.int32)
        _close(t.probs(idx), j.probs(idx))
        _close(t.log_prob(idx), j.log_prob(idx))
        _close(t.probs(), j.probs())
        one = tdist.Categorical(LOGITS[0])
        _close(one.probs(idx), jdist.Categorical(LOGITS[0]).probs(idx))
    else:
        _close(t.log_prob(VALUE), j.log_prob(VALUE))
        _close(t.probs(VALUE), j.probs(VALUE))
    if j2 is not None:
        _close(t.kl_divergence(t2), j.kl_divergence(j2))


def test_argument_checks_and_promotion_match_jax():
    # a tensor beside a number is refused, in both
    for mod, tensor in ((jdist, pt.to_tensor(LOC)),
                        (tdist, paddle.to_tensor(LOC))):
        with pytest.raises(ValueError, match="all arguments"):
            mod.Normal(tensor, 1.0)
        with pytest.raises(TypeError, match="Type of input args"):
            mod.Uniform("a", 1.0)
    # float64 arrays are float32 under the x32 policy; ints warn
    assert tdist.Normal(LOC.astype(np.float64), 1.0).loc.dtype == \
        torch.float32
    assert _v(jdist.Normal(LOC.astype(np.float64), 1.0).loc).dtype == \
        np.float32
    for mod in (jdist, tdist):
        with pytest.warns(UserWarning, match="convert to float32"):
            mod.Normal(np.array([1, 2]), np.array([1, 1]))
        n = mod.Normal(LOC, SCALE)
        with pytest.raises(TypeError, match="floating"):
            n.log_prob(np.array([1, 2, 3], np.int32))
    # tensors stay tensors
    t = tdist.Normal(paddle.to_tensor(LOC), paddle.to_tensor(SCALE))
    j = jdist.Normal(pt.to_tensor(LOC), pt.to_tensor(SCALE))
    _close(t.log_prob(VALUE), j.log_prob(VALUE))


@pytest.mark.parametrize("name", ["normal", "uniform", "categorical"])
def test_samples_are_held_to_statistics(name):
    j, t, _, _ = _pair(name)
    shape = (N_DRAWS,)
    draws = t.sample(shape, seed=7).value
    jshape = _v(j.sample((4,), seed=7)).shape
    assert tuple(draws.shape) == shape + tuple(jshape[1:])
    assert torch.equal(draws, t.sample(shape, seed=7).value)
    assert not torch.equal(draws, t.sample(shape, seed=8).value)
    if name == "categorical":
        assert draws.dtype == torch.int32
        p = torch.softmax(torch.from_numpy(LOGITS), -1)
        freq = torch.stack([(draws == c).float().mean(0) for c in range(3)],
                           -1)
        se = torch.sqrt(p * (1 - p) / N_DRAWS)
        assert torch.all((freq - p).abs() <= 5 * se), (freq, p)
        return
    if name == "normal":
        mean, var = torch.from_numpy(LOC), torch.from_numpy(SCALE) ** 2
    else:
        hi = torch.from_numpy(SCALE * 4)
        mean, var = hi / 2, hi ** 2 / 12
    d = draws.double()
    se = torch.sqrt(var.double() / N_DRAWS)
    assert torch.all((d.mean(0) - mean.double()).abs() <= 5 * se)
    assert torch.all((d.var(0) / var.double() - 1).abs() <= 0.1)


def test_unseeded_samples_follow_paddle_seed():
    n = tdist.Normal(LOC, SCALE)
    paddle.seed(11)
    a = n.sample((5,)).value
    paddle.seed(11)
    assert torch.equal(a, n.sample((5,)).value)


# -- utils ----------------------------------------------------------------------

def _archives(tmp_path):
    src = tmp_path / "src"
    (src / "model").mkdir(parents=True)
    (src / "model" / "w.bin").write_bytes(b"\x01\x02weights")
    (src / "model" / "cfg.txt").write_text("hidden=8")
    tgz = src / "model.tar.gz"
    with tarfile.open(tgz, "w:gz") as tf:
        tf.add(src / "model", arcname="model")
    zp = src / "flat.zip"
    with zipfile.ZipFile(zp, "w") as zf:
        zf.writestr("a.txt", "A")
        zf.writestr("b/b.txt", "B")
    plain = src / "vocab.txt"
    plain.write_text("x\ny\n")
    return {"tgz": tgz, "zip": zp, "plain": plain}


def _tree(root):
    """Files under ``root`` by relative path; an extraction marker holds
    an absolute path, kept relative to ``root``."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                data = fh.read()
            if f.endswith(".extracted"):
                data = os.path.relpath(data.decode(), root)
            out[os.path.relpath(p, root)] = data
    return out


@pytest.mark.parametrize("kind", ["tgz", "zip", "plain"])
def test_download_reads_local_files_as_jax(kind, tmp_path):
    from paddle_tpu.utils import download as jdl
    from paddle_tpu_torch.utils import download as tdl
    src = _archives(tmp_path)[kind]
    url = "file://" + str(src)
    md5 = hashlib.md5(src.read_bytes()).hexdigest()
    got = {}
    for tag, mod in (("jax", jdl), ("port", tdl)):
        root = tmp_path / tag
        first = mod.get_path_from_url(url, str(root), md5sum=md5)
        again = mod.get_path_from_url(url, str(root), md5sum=md5)
        assert first == again
        got[tag] = (os.path.relpath(first, root),
                    _tree(first) if os.path.isdir(first)
                    else open(first, "rb").read())
    assert got["port"] == got["jax"]
    assert tdl.is_url(url) and not tdl.is_url(str(src))
    with pytest.raises(RuntimeError, match="md5"):
        tdl.get_path_from_url(url, str(tmp_path / "bad"), md5sum="0" * 32)


def test_download_refuses_an_uncached_remote_url(tmp_path):
    from paddle_tpu_torch.utils import download as tdl
    with pytest.raises(RuntimeError, match="local files only"):
        tdl.get_path_from_url("https://example.invalid/w.pdparams",
                              str(tmp_path))
    # a file already in the cache is used as it is
    (tmp_path / "w.pdparams").write_bytes(b"cached")
    assert tdl.get_weights_path_from_url.__doc__
    assert tdl.get_path_from_url("https://example.invalid/w.pdparams",
                                 str(tmp_path)) == str(tmp_path /
                                                       "w.pdparams")


@pytest.mark.parametrize("side", ["jax", "port"])
def test_utils_helpers(side):
    if side == "jax":
        import paddle_tpu.utils as utils
        name = "paddle_tpu"
    else:
        import paddle_tpu_torch.utils as utils
        name = "paddle_tpu_torch"

    @utils.deprecated(update_to="new_fn", since="0.1", reason="old")
    def old(x):
        return x + 1

    with pytest.warns(DeprecationWarning, match="use new_fn instead"):
        assert old(1) == 2
    assert old.__deprecated__

    @utils.deprecated(level=2)
    def gone():
        return 0

    with pytest.raises(RuntimeError, match="deprecated"):
        gone()
    utils.require_version("0.0.1")
    with pytest.raises(RuntimeError, match=f"{name}>=99.0"):
        utils.require_version("99.0")
    with pytest.raises(RuntimeError, match=f"{name}<=0.0.1"):
        utils.require_version("0.0.0", "0.0.1")
    assert utils.try_import("json").dumps([1]) == "[1]"
    with pytest.raises(ImportError, match="no_such_mod_xyz"):
        utils.try_import("no_such_mod_xyz")
    with pytest.raises(ImportError, match="custom message"):
        utils.try_import("no_such_mod_xyz", "custom message")
    assert utils.unique_name.generate("fc") != utils.unique_name.generate(
        "fc")


def test_cpp_extension_waits_for_the_roadmap():
    import paddle_tpu_torch.utils as utils
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        utils.cpp_extension.load(name="op", sources=[])


def test_run_check_on_the_cpu(capsys):
    import paddle_tpu_torch.utils as utils
    utils.run_check()
    out = capsys.readouterr().out.splitlines()
    assert out == ["Running verify on 1 cpu device(s).",
                   "paddle_tpu_torch is installed successfully!"]


def test_run_check_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default is usable")
    import paddle_tpu_torch.utils as utils
    place.reset_device()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            utils.run_check()
    finally:
        place.set_device("cpu")


def test_sysconfig_and_incubate_match_jax():
    import paddle_tpu.incubate as jinc
    import paddle_tpu.sysconfig as jsys
    import paddle_tpu_torch.incubate as tinc
    import paddle_tpu_torch.sysconfig as tsys
    from paddle_tpu_torch.ops import decode_extra
    from paddle_tpu_torch.optimizer import wrappers
    assert tsys.get_include() == jsys.get_include()
    assert tsys.get_lib() == jsys.get_lib()
    assert os.path.isfile(os.path.join(tsys.get_include(),
                                       "pt_custom_op.h"))
    assert tinc.__all__ == jinc.__all__
    assert tinc.LookAhead is wrappers.Lookahead
    assert tinc.ModelAverage is wrappers.ModelAverage
    assert tinc.segment_sum is decode_extra.segment_sum
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([0, 0, 1, 1], np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _v(jinc.segment_mean(pt.to_tensor(x), pt.to_tensor(ids), 2))
    got = tinc.segment_mean(torch.from_numpy(x), torch.from_numpy(ids), 2)
    np.testing.assert_allclose(_v(got), want)


def test_top_level_names_resolve_to_the_ported_modules():
    import importlib
    for name in ("profiler", "utils", "sysconfig", "distribution",
                 "incubate", "text", "hub", "onnx"):
        assert getattr(paddle, name) is importlib.import_module(
            f"paddle_tpu_torch.{name}")
