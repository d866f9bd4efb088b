"""The PyTorch port stands alone: it imports neither ``jax`` nor
``paddle_tpu``, and its default entry points run on CUDA or raise —
they never carry on on the CPU by themselves.
"""

import _torch_threads  # noqa: F401

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    out = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                           "compare_argmax.py")]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_module_of_the_port_imports_jax_or_paddle_tpu(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


def test_package_imports_with_jax_and_paddle_tpu_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'paddle_tpu'):\n"
        "    sys.modules[name] = None  # any import of them now fails\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.models.gpt, paddle_tpu_torch.nn.decode\n"
        "import paddle_tpu_torch.inference, paddle_tpu_torch.serving\n"
        "import paddle_tpu_torch.serving.server\n"
        "import paddle_tpu_torch.ops.kernels\n"
        "import paddle_tpu_torch.jit, paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.regularizer, paddle_tpu_torch.core.flags\n"
        "import paddle_tpu_torch.ops.kernels.optimizer_update\n"
        "import paddle_tpu_torch.core.rng\n"
        "import paddle_tpu_torch.amp, paddle_tpu_torch.amp.grad_scaler\n"
        "import paddle_tpu_torch.optimizer.wrappers\n"
        "import paddle_tpu_torch.optimizer.dgc\n"
        "import paddle_tpu_torch.vision.models\n"
        "import paddle_tpu_torch.inference.fusion\n"
        "import paddle_tpu_torch.ops.kernels.fused_conv_block\n"
        "import paddle_tpu_torch.serving.prefix_cache\n"
        "import paddle_tpu_torch.distributed.resilience\n"
        "from paddle_tpu_torch.distributed.resilience import "
        "ResilientCheckpointManager\n"
        "import paddle_tpu_torch.inference.costs\n"
        "import paddle_tpu_torch.inference.speculative\n"
        "import paddle_tpu_torch.inference.graphs\n"
        "from paddle_tpu_torch.models.gpt import multi_step_decode\n"
        "from paddle_tpu_torch.nn.decode import masked_run_advance\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "isolated" in r.stdout


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")


def test_default_entry_points_raise_without_a_gpu():
    _no_card()
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.inference import create_decode_engine
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.serving.server import ServingServer, main
    with pytest.raises(RuntimeError, match="no usable GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no usable GPU"):
        GPTForCausalLM(gpt_tiny())
    cpu_model = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no usable GPU"):
        create_decode_engine(cpu_model)
    with pytest.raises(RuntimeError, match="no usable GPU"):
        ServingServer(cpu_model)
    with pytest.raises(RuntimeError, match="no usable GPU"):
        main(["--model", "gpt_tiny"])
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    with pytest.raises(RuntimeError, match="no usable GPU"):
        TrainStep(cpu_model, AdamW(), lambda m, x: m(x, labels=x))


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50",
                                  "resnet101", "resnet152",
                                  "wide_resnet50_2"])
def test_resnet_constructors_raise_without_a_gpu(name):
    _no_card()
    from paddle_tpu_torch.vision import models
    with pytest.raises(RuntimeError, match="no usable GPU"):
        getattr(models, name)()
    with pytest.raises(RuntimeError, match="no usable GPU"):
        getattr(models, name)(data_format="NHWC", device="cuda")


def test_fused_bottleneck_has_no_backward():
    """The fused bottleneck has no backward (nor has its TPU kernel):
    with grad mode on, an operand that requires grad raises; under
    ``torch.no_grad()`` it runs."""
    from paddle_tpu_torch.ops.kernels.fused_conv_block import (
        fused_bottleneck_eval)
    g = torch.Generator().manual_seed(0)
    c, m = 32, 8
    x = torch.randn(1, 5, 6, c, generator=g)
    params = [torch.randn(c, m, generator=g), torch.zeros(1, m),
              torch.randn(9 * m, m, generator=g), torch.zeros(1, m),
              torch.randn(m, c, generator=g), torch.zeros(1, c)]
    with pytest.raises(RuntimeError, match="fused_bottleneck has no "
                                           "backward"):
        fused_bottleneck_eval(x.clone().requires_grad_(True), *params)
    w1 = params[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        fused_bottleneck_eval(x, w1, *params[1:])
    with torch.no_grad():
        out = fused_bottleneck_eval(x.clone().requires_grad_(True), w1,
                                    *params[1:])
    assert out.shape == x.shape and not out.requires_grad
    assert fused_bottleneck_eval(x, *params).shape == x.shape


def test_train_step_refuses_a_model_on_another_device():
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.optimizer import AdamW
    cpu_model = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        TrainStep(cpu_model, AdamW(), lambda m, x: m(x, labels=x),
                  device="meta")


def test_kernels_without_a_backward_refuse_inputs_that_require_grad():
    """``paged_decode``, ``decode_out_proj`` and ``fused_argmax`` have no
    backward (nor do their TPU kernels): with grad mode on, an operand
    that requires grad raises instead of leaving it without a gradient
    on the card. Under ``torch.no_grad()`` they run."""
    from paddle_tpu_torch.ops.kernels.fused_sample import fused_argmax
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        decode_out_proj, paged_decode)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2, 64, generator=g)
    pages = torch.randn(5, 8, 2, 64, generator=g)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    lens = torch.tensor([9, 3], dtype=torch.int32)
    w = torch.randn(128, 128, generator=g)
    hidden = torch.randn(2, 128, generator=g)
    calls = {
        "paged_decode": lambda r: paged_decode(
            q.clone().requires_grad_(r), pages, pages, table, lens),
        "decode_out_proj": lambda r: decode_out_proj(
            hidden, w.clone().requires_grad_(r)),
        "fused_argmax": lambda r: fused_argmax(
            hidden.clone().requires_grad_(r), w),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call(True)
        with torch.no_grad():
            call(True)
        call(False)


def test_engine_refuses_a_model_on_another_device():
    from paddle_tpu_torch.inference import create_decode_engine
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    cpu_model = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        create_decode_engine(cpu_model, device="meta")


def test_chip_smoke_fails_without_a_gpu_and_alone(tmp_path):
    _no_card()
    script = os.path.join(REPO, "chip_smoke.py")
    r = subprocess.run([sys.executable, script], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(script, lone)
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
