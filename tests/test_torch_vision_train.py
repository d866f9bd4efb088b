"""ResNet training on the port against the JAX package's ``TrainStep``,
on the CPU, at the JAX benchmark's CPU size (``bench_all.py:83-145``:
``resnet18(num_classes=10)``, B=2, 64x64, labels in [0, 10),
``mean(cross_entropy(logits.float(), y))``, ``Momentum(0.1, 0.9)``), in
fp32 and under the bf16 recipe (``_to_bf16_except_norms``).

Each of two steps starts both packages from the same state (the JAX
trajectory's parameters, BN running statistics and velocity): a step of
lr 0.1 on a batch of two moves the weights so far that any rounding
difference in step 1 grows through step 2's batch statistics (free
running, the fp32 BN biases part by 3.6e-3 after two steps), so each
step is held on its own. The free-running losses of ``multi_step`` are
held too.

Tolerances, stated:

- fp32: losses within 1e-5 relative (measured 4.3e-7); a parameter's
  update (new minus old) within 2e-4 relative in L2 of the JAX update
  (measured 2.4e-5), the velocity within 2e-4 relative in L2
  (1.8e-5), each BN running statistic within 5e-5 of its largest
  magnitude (6.5e-6); the free-running ``multi_step`` losses within
  1e-4 relative (3.2e-5: step 2 inherits step 1's differences).
- bf16 recipe: at B=2 the bf16 step is mostly rounding. From the same
  state the JAX bf16 step's gradients lie 35% (in L2 over the model)
  from its own fp32 step's and the port's 39%, two independent
  roundings of the same step. So the bf16 step is held to the fp32 step
  that JAX takes from the same (bf16-valued) state: the port's distance
  from it, for the velocity, the updates and the running statistics,
  within twice the JAX bf16 step's own distance (measured ratios 1.03
  to 1.25), and the loss within 4u relative of JAX's (u = 2^-8;
  measured 0.66u and 3.0u). The dtypes are held exactly:
  every parameter, buffer and velocity of the port has the JAX model's
  dtype: ``downsample.1.weight`` / ``.bias`` stay bf16 (their name
  carries none of the keep-tokens) while every other BN's scale and
  bias are f32, and every BN's running statistics are bf16 (the JAX
  recipe's buffer loop tests ``np.issubdtype(bfloat16, np.floating)``,
  which is false, and leaves them as ``model.to`` made them); the
  update, computed in f32, is rounded into them, as ``set_value``
  rounds it.
"""

import _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.dispatch as dispatch
from bench_all import _to_bf16_except_norms
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.vision import models as jmodels

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.ops import nn_functional as tnf
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.optimizer.optimizer import load_jax_optimizer_state
from paddle_tpu_torch.vision import models as tmodels
from test_torch_attention_fwd import _chip_smoke

U = 2.0 ** -8
LR, MOMENTUM = 0.1, 0.9
LOSS_RTOL = 1e-5
UPDATE_REL = 2e-4
VELOCITY_REL = 2e-4
STAT_REL = 5e-5
FREE_LOSS_RTOL = 1e-4
BF16_NOISE_RATIO = 2.0
BF16_LOSS_RTOL = 4 * U

JF = dispatch.wrapped_ops


@pytest.fixture(scope="module", autouse=True)
def _single_device_jax():
    """The JAX models of this file on one device, whatever ran before in
    the worker (``tests/test_torch_hot_swap.py``'s guard)."""
    from paddle_tpu.distributed.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)
    prev = get_hybrid_communicate_group()
    set_hybrid_communicate_group(None)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)


def _jfn(m, b):
    return JF["mean"](JF["cross_entropy"](JF["cast"](m(b[0]), "float32"),
                                          b[1]))


def _tfn(m, b):
    return tnf.cross_entropy(m(b[0]).float(), b[1]).mean()


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    y = rng.integers(0, 10, (2,)).astype(np.int64)
    return x, y


class _JaxSide:
    """A JAX ``TrainStep`` that runs one step from a given state."""

    def __init__(self, bf16):
        pt.seed(0)
        self.model = jmodels.resnet18(num_classes=10)
        if bf16:
            _to_bf16_except_norms(self.model)
        self.step = JTrainStep(self.model, jopt.Momentum(
            learning_rate=LR, momentum=MOMENTUM), _jfn)
        self.bf16 = bf16

    def dtypes(self):
        return {**{n: str(v.dtype) for n, v in self.step.params.items()},
                **{n: str(v.dtype) for n, v in self.step.buffers.items()}}

    def state(self):
        s = self.step
        return ({n: _f32(v) for n, v in s.params.items()},
                {n: _f32(v) for n, v in s.buffers.items()},
                {n: _f32(v["velocity"]) for n, v in
                 s.opt_state["slots"].items()})

    def run(self, state, x, y):
        params, buffers, vel = state
        s = self.step

        def put(src, like):
            return {n: jnp.asarray(src[n]).astype(like[n].dtype)
                    for n in like}

        s.params = put(params, s.params)
        s.buffers = put(buffers, s.buffers)
        slots = s.opt_state["slots"]
        s.opt_state = {**s.opt_state, "slots": {
            n: {"velocity": jnp.asarray(vel[n]).astype(
                slots[n]["velocity"].dtype)} for n in slots}}
        xj = jnp.asarray(x).astype(jnp.bfloat16 if self.bf16
                                   else jnp.float32)
        loss = float(s((xj, jnp.asarray(y))))
        return loss, self.state()


class _PortSide:
    def __init__(self, bf16):
        self.model = tmodels.resnet18(num_classes=10, device="cpu")
        if bf16:
            _chip_smoke().to_bf16_except_norms(torch, self.model)
        self.step = TrainStep(self.model, Momentum(
            learning_rate=LR, momentum=MOMENTUM), _tfn, device="cpu")
        self.bf16 = bf16

    def run(self, state, x, y):
        params, buffers, vel = state
        load_jax_state(self.model, {**params, **buffers})
        load_jax_optimizer_state(self.step.optimizer, {
            "slots": {n: {"velocity": v} for n, v in vel.items()},
            "step": 0})
        xt = torch.from_numpy(x).to(torch.bfloat16 if self.bf16
                                    else torch.float32)
        loss = float(self.step((xt, torch.from_numpy(y))))
        opt = self.step.optimizer
        return loss, (
            {n: p.detach().float().numpy()
             for n, p in self.model.named_parameters()},
            {n: b.float().numpy() for n, b in self.model.named_buffers()},
            {n: s["velocity"].float().numpy()
             for n, s in opt._state.items()})


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _stat_err(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _zero_velocity(params):
    return {n: np.zeros_like(v) for n, v in params.items()}


def test_bf16_recipe_dtypes_match_jax():
    """Every parameter and buffer takes the JAX recipe's dtype; the
    downsample branch's norm (``downsample.1``) keeps a bf16 scale and
    bias, as the keep-tokens leave it, and the running statistics stay
    bf16."""
    j = _JaxSide(bf16=True)
    t = _PortSide(bf16=True)
    want = j.dtypes()
    got = {n: str(v.dtype).replace("torch.", "")
           for n, v in t.model.state_dict().items()}
    assert got == want
    for i in (2, 3, 4):
        pre = f"layer{i}.0.downsample.1."
        assert got[pre + "weight"] == got[pre + "bias"] == "bfloat16"
        assert got[pre + "_mean"] == got[pre + "_variance"] == "bfloat16"
    assert got["layer1.0.bn1.weight"] == "float32"
    assert got["layer1.0.bn1._mean"] == "bfloat16"
    assert got["fc.weight"] == got["conv1.weight"] == "bfloat16"


def test_fp32_steps_match_jax_train_step():
    x, y = _batch()
    j, t = _JaxSide(bf16=False), _PortSide(bf16=False)
    params, buffers, _ = j.state()
    state = (params, buffers, _zero_velocity(params))
    for step in range(2):
        want_loss, want = j.run(state, x, y)
        got_loss, got = t.run(state, x, y)
        assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
        for n, p in got[0].items():
            upd = want[0][n] - state[0][n]
            assert _rel(p - state[0][n], upd) <= UPDATE_REL, (step, n)
            assert _rel(got[2][n], want[2][n]) <= VELOCITY_REL, (step, n)
        for n, b in got[1].items():
            assert _stat_err(b, want[1][n]) <= STAT_REL, (step, n)
        state = want
    # free running: the port's multi_step over both steps against JAX's
    x2, y2 = np.stack([x, x]), np.stack([y, y])
    j2, t2 = _JaxSide(bf16=False), _PortSide(bf16=False)
    load_jax_state(t2.model, {**j2.state()[0], **j2.state()[1]})
    want = np.asarray(j2.step.multi_step((jnp.asarray(x2),
                                           jnp.asarray(y2))))
    got = t2.step.multi_step((torch.from_numpy(x2),
                              torch.from_numpy(y2))).numpy()
    np.testing.assert_allclose(got, want, rtol=FREE_LOSS_RTOL)


def test_bf16_recipe_steps_match_jax_train_step():
    x, y = _batch()
    jb, j32, t = _JaxSide(bf16=True), _JaxSide(bf16=False), \
        _PortSide(bf16=True)
    params, buffers, _ = jb.state()
    state = (params, buffers, _zero_velocity(params))
    for step in range(2):
        ref_loss, ref = j32.run(state, x, y)
        want_loss, want = jb.run(state, x, y)
        got_loss, got = t.run(state, x, y)
        assert abs(got_loss - want_loss) <= BF16_LOSS_RTOL * abs(want_loss)

        def noise(side, part, delta=False):
            names = list(ref[part])
            base = state[part] if delta else {n: 0.0 for n in names}
            num = sum(np.sum(((side[part][n] - base[n])
                              - (ref[part][n] - base[n])) ** 2)
                      for n in names)
            den = sum(np.sum((ref[part][n] - base[n]) ** 2) for n in names)
            return float(np.sqrt(num / den))

        for part, what, delta in ((2, "velocity", False),
                                  (0, "updates", True),
                                  (1, "running statistics", True)):
            port, jax_ = noise(got, part, delta), noise(want, part, delta)
            assert port <= BF16_NOISE_RATIO * jax_, (step, what, port,
                                                     jax_)
        params = dict(t.model.named_parameters())
        for n, v in t.step.optimizer._state.items():
            assert v["velocity"].dtype == params[n].dtype, n
        for n, b in t.model.named_buffers():
            assert b.dtype == torch.bfloat16, n
        state = want
