"""The port's learning-rate schedulers against the JAX package's.

Both are host-side Python over the same arithmetic, so every scheduler
gives the same floats, exactly, over 50 steps; a ``state_dict`` taken
midway and loaded into a fresh scheduler continues the same sequence;
and an optimizer carries its scheduler's state under ``LR_Scheduler``.
"""

import pytest
import torch

from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 50


class _JHalf(jlr.LRScheduler):
    def get_lr(self):
        return self.base_lr * 0.5 ** self.last_epoch


class _THalf(tlr.LRScheduler):
    def get_lr(self):
        return self.base_lr * 0.5 ** self.last_epoch


def _cases():
    """(id, factory(mod) -> scheduler, metrics or None)."""
    losses = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.85, 0.86, 0.86, 0.87]
    metrics = [losses[i % len(losses)] + 0.001 * (i // 10)
               for i in range(STEPS)]
    return [
        ("LRScheduler", lambda m: (_JHalf if m is jlr else _THalf)(0.5),
         None),
        ("NoamDecay", lambda m: m.NoamDecay(512, 10, learning_rate=1.0),
         None),
        ("PiecewiseDecay",
         lambda m: m.PiecewiseDecay([5, 20], [0.1, 0.05, 0.01]), None),
        ("NaturalExpDecay", lambda m: m.NaturalExpDecay(0.5, 0.1), None),
        ("InverseTimeDecay", lambda m: m.InverseTimeDecay(0.5, 0.1), None),
        ("PolynomialDecay",
         lambda m: m.PolynomialDecay(0.5, 20, end_lr=0.01, power=2.0),
         None),
        ("PolynomialDecay-cycle",
         lambda m: m.PolynomialDecay(0.5, 20, end_lr=0.01, cycle=True),
         None),
        ("ExponentialDecay", lambda m: m.ExponentialDecay(0.5, 0.9), None),
        ("MultiStepDecay",
         lambda m: m.MultiStepDecay(0.5, [10, 30], gamma=0.5), None),
        ("StepDecay", lambda m: m.StepDecay(0.5, 7, gamma=0.5), None),
        ("LambdaDecay", lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
         None),
        ("MultiplicativeDecay",
         lambda m: m.MultiplicativeDecay(0.5, lambda e: 0.97), None),
        ("CosineAnnealingDecay",
         lambda m: m.CosineAnnealingDecay(0.5, 25, eta_min=0.01), None),
        ("LinearWarmup", lambda m: m.LinearWarmup(0.5, 10, 0.0, 0.5), None),
        ("LinearWarmup-scheduler",
         lambda m: m.LinearWarmup(m.CosineAnnealingDecay(0.5, 30), 10,
                                  0.0, 0.5), None),
        ("ReduceOnPlateau",
         lambda m: m.ReduceOnPlateau(0.5, patience=2, factor=0.5,
                                     cooldown=1), metrics),
        ("ReduceOnPlateau-max-abs",
         lambda m: m.ReduceOnPlateau(0.5, mode="max", patience=1,
                                     threshold_mode="abs"), metrics),
        ("OneCycleLR", lambda m: m.OneCycleLR(0.5, 40), None),
        ("OneCycleLR-linear",
         lambda m: m.OneCycleLR(0.5, 40, anneal_strategy="linear"), None),
        ("CyclicLR",
         lambda m: m.CyclicLR(0.01, 0.5, step_size_up=5,
                              mode="triangular2"), None),
        ("CyclicLR-exp_range",
         lambda m: m.CyclicLR(0.01, 0.5, step_size_up=4, step_size_down=6,
                              mode="exp_range", exp_gamma=0.98), None),
    ]


CASES = _cases()


def _run(sched, metrics, start, stop):
    out = []
    for i in range(start, stop):
        out.append(sched())
        if metrics is None:
            sched.step()
        else:
            sched.step(metrics[i])
    return out


@pytest.mark.parametrize("make,metrics", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_scheduler_matches_jax_exactly(make, metrics):
    want = _run(make(jlr), metrics, 0, STEPS)
    got = _run(make(tlr), metrics, 0, STEPS)
    assert got == want
    assert len(set(want)) > 1 or metrics is not None


@pytest.mark.parametrize("make,metrics", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_scheduler_state_dict_round_trip(make, metrics):
    """A state_dict taken after 20 steps continues the same sequence in
    a fresh scheduler, and holds the JAX scheduler's keys and values."""
    ref, first = make(tlr), make(tlr)
    want = _run(ref, metrics, 0, STEPS)
    _run(first, metrics, 0, 20)
    state = first.state_dict()
    jfirst = make(jlr)
    _run(jfirst, metrics, 0, 20)
    assert state == jfirst.state_dict()
    again = make(tlr)
    again.set_state_dict(dict(state))
    assert _run(again, metrics, 20, STEPS) == want[20:]


def test_lambda_decay_state_dict_drops_the_function():
    sched = tlr.LambdaDecay(0.5, lambda e: 0.9 ** e)
    assert "lr_lambda" not in sched.state_dict()
    assert sched.state_dict()["base_lr"] == 0.5


def test_optimizer_reads_the_scheduler_and_carries_its_state():
    """``get_lr`` follows the scheduler; ``set_lr`` refuses under one;
    the optimizer's ``state_dict`` carries it under ``LR_Scheduler``
    (JAX ``optimizer.py:274-286``) and loads it back."""
    p = torch.nn.Parameter(torch.ones(3))
    sched = tlr.StepDecay(0.5, 2, gamma=0.5)
    opt = SGD(learning_rate=sched, parameters=[("p", p)])
    assert opt._lr_scheduler is sched
    seen = []
    for _ in range(5):
        seen.append(opt.get_lr())
        p.grad = torch.ones(3)
        opt.step()
        sched.step()
    assert seen == [0.5, 0.5, 0.25, 0.25, 0.125]
    with pytest.raises(ValueError, match="LRScheduler"):
        opt.set_lr(0.1)
    state = opt.state_dict()
    assert state["LR_Scheduler"]["last_epoch"] == 5
    fresh = tlr.StepDecay(0.5, 2, gamma=0.5)
    other = SGD(learning_rate=fresh, parameters=[("p", p)])
    other.set_state_dict(state)
    assert fresh.last_epoch == 5 and other.get_lr() == opt.get_lr()
    plain = AdamW(learning_rate=0.1, parameters=[("p", p)])
    plain.set_lr(0.2)
    assert plain.get_lr() == 0.2 and plain._lr_scheduler is None
    assert "LR_Scheduler" not in plain.state_dict()
    with pytest.raises(TypeError, match="learning_rate"):
        SGD(learning_rate="0.1", parameters=[("p", p)])
