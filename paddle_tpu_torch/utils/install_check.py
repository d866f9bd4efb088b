"""Installation self-check (port of ``paddle_tpu/utils/install_check.py``;
reference: ``python/paddle/utils/install_check.py`` ``run_check:162``).

Runs a tiny linear-regression fit twice, eagerly (``loss.backward()``,
an SGD step) and through ``jit.TrainStep``, on the expected place (the
card unless ``paddle.set_device`` names another; without a GPU the card
raises), then prints the verdict the way ``paddle.utils.run_check()``
does. With more than one card the reference adds a data-parallel run;
the port's ``DataParallel`` waits for ROADMAP.md's Queue 1, item 7, and
the check says so.
"""

from __future__ import annotations

import numpy as np

__all__ = ["run_check"]


def _simple_network():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn

    model = nn.Linear(4, 1)
    x = pt.to_tensor(np.random.default_rng(0)
                     .standard_normal((16, 4)).astype(np.float32))
    y = pt.to_tensor(np.ones((16, 1), np.float32))
    return model, x, y


def _run_single() -> None:
    import paddle_tpu_torch.optimizer as optim

    model, x, y = _simple_network()
    opt = optim.SGD(learning_rate=0.1, parameters=model.parameters())
    for _ in range(3):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    assert np.isfinite(loss.item()), "single-device training diverged"


def _run_jit() -> None:
    import paddle_tpu_torch.optimizer as optim
    from paddle_tpu_torch.jit import TrainStep

    model, x, y = _simple_network()
    opt = optim.SGD(learning_rate=0.1)
    step = TrainStep(model, opt, lambda m, b: ((m(b[0]) - b[1]) ** 2).mean())
    l0 = float(step((x.value, y.value)))
    l1 = float(step((x.value, y.value)))
    assert np.isfinite(l0) and l1 < l0, "jitted training did not descend"


def run_check() -> None:
    """Verify the install: eager and ``TrainStep`` training on the
    expected place."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(None)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"Running verify on {n} {dev.type} device(s).")
    _run_single()
    _run_jit()
    if n > 1:
        print("the multi-device check waits for DataParallel (ROADMAP.md, "
              "Queue 1, item 7); single-device install is healthy.")
    print("paddle_tpu_torch is installed successfully!")
