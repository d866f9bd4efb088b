"""The high-level API (``paddle_tpu_torch/hapi``), ``metric`` and
``static.accuracy`` against the JAX package on the CPU, on the same data
and the JAX networks' weights (``load_jax_state``).

Tolerances, stated: training losses, evaluation losses and predictions
within 1e-5 relative (the JAX ``TrainStep`` is one jitted program, the
port's an eager step; fp32 sums in other orders through a few Adam
steps); accuracies, metric states, callback decisions, printed lines and
scalar logs' steps exact; the functional accuracy within one float32
ulp. ``flops`` is held exactly against the products
reckoned from the layers' shapes; JAX's figure (XLA's cost analysis,
which counts every op) is printed beside it, not compared (ROADMAP.md
Queue 3, "Decided").
"""

import _torch_threads  # noqa: F401

import math
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.optimizer as joptim
from paddle_tpu import hapi as jhapi
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn

from paddle_tpu_torch import hapi as thapi
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.nn.activation import ReLU
from paddle_tpu_torch.nn.common import Linear
from paddle_tpu_torch.nn.container import Sequential
from paddle_tpu_torch.nn.conv import Conv2D
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.nn.loss import CrossEntropyLoss, MSELoss
from paddle_tpu_torch.vision.models import LeNet, resnet50
from test_torch_transformer import jax_state

RTOL = 1e-5
# the functional accuracy's mean: one float32 ulp (XLA's mean multiplies
# the hits by the reciprocal of the count; the port divides)
MEAN_RTOL = 2.0 ** -23


@pytest.fixture(scope="module", autouse=True)
def _single_device_jax():
    from paddle_tpu.distributed.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)
    prev = get_hybrid_communicate_group()
    set_hybrid_communicate_group(None)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)


def _pair():
    pt.seed(0)
    j = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 3))
    t = Sequential(Linear(8, 32, device="cpu"), ReLU(),
                   Linear(32, 3, device="cpu"))
    load_jax_state(t, jax_state(j))
    return j, t


def _data(n=64, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    w = rng.standard_normal((8, 3)).astype(np.float32)
    y = (x @ w).argmax(-1).astype(np.int64)
    return [(x[i:i + batch], y[i:i + batch]) for i in range(0, n, batch)]


class _Record:
    """The same recording callback for both packages' ``Model``."""

    def __init__(self, base):
        class Rec(base):
            def __init__(self):
                super().__init__()
                self.losses, self.evals, self.epochs = [], [], []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(float(logs["loss"]))

            def on_eval_end(self, logs=None):
                self.evals.append(dict(logs or {}))

            def on_epoch_end(self, epoch, logs=None):
                self.epochs.append(epoch)

        self.cb = Rec()


def _models(opt_j, opt_t, loss_j, loss_t, metrics=False):
    j, t = _pair()
    jm, tm = jhapi.Model(j), thapi.Model(t)
    jm.prepare(opt_j, loss_j, jmetric.Accuracy() if metrics else None)
    tm.prepare(opt_t, loss_t, tmetric.Accuracy() if metrics else None)
    return jm, tm


def test_fit_evaluate_predict_match_jax():
    jm, tm = _models(joptim.Adam(learning_rate=0.01),
                     toptim.Adam(learning_rate=0.01),
                     jnn.CrossEntropyLoss(), CrossEntropyLoss(), True)
    data = _data()
    jr = _Record(jhapi.Callback).cb
    tr = _Record(thapi.Callback).cb
    jm.fit(data, eval_data=data, epochs=3, verbose=0, callbacks=[jr])
    tm.fit(data, eval_data=data, epochs=3, verbose=0, callbacks=[tr])
    assert len(tr.losses) == len(jr.losses) == 12
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=RTOL)
    assert tr.epochs == jr.epochs == [0, 1, 2]
    for got, want in zip(tr.evals, jr.evals):
        assert got["acc"] == want["acc"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    jlogs = jm.evaluate(data, verbose=0)
    tlogs = tm.evaluate(data, verbose=0)
    assert tlogs["acc"] == jlogs["acc"] > 0.7
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=RTOL)
    jp = jm.predict(data, stack_outputs=True)
    tp = tm.predict(data, stack_outputs=True)
    assert tp[0].shape == jp[0].shape == (64, 3)
    np.testing.assert_allclose(tp[0], jp[0], rtol=RTOL, atol=RTOL)
    assert len(tm.predict(data)) == 4
    # train_batch / eval_batch / predict_batch one batch at a time
    x, y = data[0]
    np.testing.assert_allclose(tm.eval_batch([x], [y])[0],
                               jm.eval_batch([x], [y])[0], rtol=RTOL)
    np.testing.assert_allclose(tm.predict_batch([x])[0],
                               jm.predict_batch([x])[0], rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(tm.train_batch([x], [y]),
                               jm.train_batch([x], [y]), rtol=RTOL)


def test_fit_on_a_dataset():
    """The JAX package's own hapi test on the port: a ``TensorDataset``
    batched (and shuffled) by ``io.DataLoader`` on the network's
    device."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 8)).astype(np.float32)
    w = rng.standard_normal((8, 3)).astype(np.float32)
    y = (x @ w).argmax(-1).astype(np.int64)
    _, t = _pair()
    model = thapi.Model(t)
    model.prepare(toptim.Adam(learning_rate=0.01), CrossEntropyLoss(),
                  tmetric.Accuracy())
    model.fit(TensorDataset([x, y]), epochs=8, batch_size=32, verbose=0)
    logs = model.evaluate(TensorDataset([x, y]), batch_size=32, verbose=0)
    assert logs["acc"] > 0.7, logs
    preds = model.predict(TensorDataset([x, y]), batch_size=32,
                          stack_outputs=True)
    assert preds[0].shape == (128, 3)
    assert model.summary()["total_params"] == 8 * 32 + 32 + 32 * 3 + 3


def test_summary_matches_jax(capsys):
    jm, tm = _models(None, None, None, None)
    want = jm.summary()
    jout = capsys.readouterr().out
    got = tm.summary()
    tout = capsys.readouterr().out
    assert got == want
    assert tout == jout


def test_progbar_lines_match_jax(capsys):
    jm, tm = _models(joptim.SGD(learning_rate=0.1),
                     toptim.SGD(learning_rate=0.1),
                     jnn.CrossEntropyLoss(), CrossEntropyLoss())
    data = _data(32, 8)

    def lines(model):
        model.fit(data, epochs=2, verbose=2, log_freq=2)
        out = capsys.readouterr().out.splitlines()
        # the epoch line carries its wall time and the losses' digits
        return [ln.split(" - ")[0].split(" done in")[0] for ln in out]

    assert lines(tm) == lines(jm)


def test_model_checkpoint_and_save_load(tmp_path):
    jm, tm = _models(joptim.Adam(learning_rate=0.01),
                     toptim.Adam(learning_rate=0.01),
                     jnn.CrossEntropyLoss(), CrossEntropyLoss())
    data = _data()
    d = str(tmp_path / "ckpt")
    tm.fit(data, epochs=2, verbose=0, save_dir=d)
    for name in ("0", "1", "final"):
        assert os.path.exists(os.path.join(d, name + ".pdparams")), name
        assert os.path.exists(os.path.join(d, name + ".pdopt")), name
    p = str(tmp_path / "model")
    tm.save(p)
    _, t2 = _pair()
    m2 = thapi.Model(t2)
    m2.prepare(toptim.Adam(learning_rate=0.01), CrossEntropyLoss())
    m2.load(p)
    x = data[0][0]
    saved = tm.predict_batch([x])[0]
    np.testing.assert_array_equal(m2.predict_batch([x])[0], saved)
    # the optimizer's moments came back: the next step is the same
    np.testing.assert_array_equal(m2.train_batch([x], [data[0][1]]),
                                  tm.train_batch([x], [data[0][1]]))
    # load without the optimizer's file
    _, t3 = _pair()
    m3 = thapi.Model(t3)
    m3.prepare(toptim.Adam(learning_rate=0.01), CrossEntropyLoss())
    m3.load(p, reset_optimizer=True)
    np.testing.assert_array_equal(m3.predict_batch([x])[0], saved)


def test_lr_scheduler_callback_matches_jax():
    jsched = joptim.lr.StepDecay(0.1, step_size=3, gamma=0.5)
    tsched = toptim.lr.StepDecay(0.1, step_size=3, gamma=0.5)
    jm, tm = _models(joptim.SGD(learning_rate=jsched),
                     toptim.SGD(learning_rate=tsched),
                     jnn.CrossEntropyLoss(), CrossEntropyLoss())
    data = _data()
    jm.fit(data, epochs=2, verbose=0, callbacks=[jhapi.LRScheduler()])
    tm.fit(data, epochs=2, verbose=0, callbacks=[thapi.LRScheduler()])
    assert tsched.last_epoch == jsched.last_epoch == 8
    assert float(tsched()) == float(jsched())
    jsched2 = joptim.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    tsched2 = toptim.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    jm, tm = _models(joptim.SGD(learning_rate=jsched2),
                     toptim.SGD(learning_rate=tsched2),
                     jnn.CrossEntropyLoss(), CrossEntropyLoss())
    jm.fit(data, epochs=3, verbose=0,
           callbacks=[jhapi.LRScheduler(by_step=False, by_epoch=True)])
    tm.fit(data, epochs=3, verbose=0,
           callbacks=[thapi.LRScheduler(by_step=False, by_epoch=True)])
    assert tsched2.last_epoch == jsched2.last_epoch == 3


def _regression():
    x = np.random.default_rng(3).standard_normal((32, 8)).astype(
        np.float32)
    y = np.zeros((32, 3), np.float32)
    return [(x[i:i + 16], y[i:i + 16]) for i in (0, 16)]


def test_early_stopping_matches_jax(tmp_path):
    jm, tm = _models(joptim.SGD(learning_rate=0.0),
                     toptim.SGD(learning_rate=0.0), jnn.MSELoss(),
                     MSELoss())
    data = _regression()
    jr, tr = _Record(jhapi.Callback).cb, _Record(thapi.Callback).cb
    jes = jhapi.EarlyStopping(monitor="loss", patience=1, verbose=0)
    tes = thapi.EarlyStopping(monitor="loss", patience=1, verbose=0)
    jm.fit(data, eval_data=data, epochs=10, verbose=0, callbacks=[jes, jr],
           save_dir=str(tmp_path / "j"))
    tm.fit(data, eval_data=data, epochs=10, verbose=0, callbacks=[tes, tr],
           save_dir=str(tmp_path / "t"))
    assert tm.stop_training and jm.stop_training
    assert tr.epochs == jr.epochs and len(tr.epochs) < 10
    assert tes.wait == jes.wait
    np.testing.assert_allclose(tes.best, jes.best, rtol=RTOL)
    assert os.path.exists(str(tmp_path / "t" / "final.pdparams"))


def test_reduce_lr_on_plateau_matches_jax():
    jm, tm = _models(joptim.SGD(learning_rate=0.1),
                     toptim.SGD(learning_rate=0.1), jnn.MSELoss(),
                     MSELoss())
    data = _regression()
    jcb = jhapi.ReduceLROnPlateau(monitor="acc", patience=1, factor=0.5,
                                  verbose=0, min_delta=10.0)
    tcb = thapi.ReduceLROnPlateau(monitor="acc", patience=1, factor=0.5,
                                  verbose=0, min_delta=10.0)
    assert tcb.mode == jcb.mode == "max"
    jlrs, tlrs = [], []
    for _ in range(4):
        for cb, lrs, m in ((jcb, jlrs, jm), (tcb, tlrs, tm)):
            cb.set_model(m)
            cb.on_eval_end({"acc": 0.5})
            lrs.append(m._optimizer.get_lr())
    assert tlrs == pytest.approx(jlrs) and tlrs[-1] < 0.1
    assert tcb.wait == jcb.wait and tcb.best == jcb.best


def test_visualdl_scalars_read_across_packages(tmp_path):
    jm, tm = _models(joptim.SGD(learning_rate=0.1),
                     toptim.SGD(learning_rate=0.1),
                     jnn.CrossEntropyLoss(), CrossEntropyLoss())
    data = _data(32, 4)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jm.fit(data, epochs=2, verbose=0, callbacks=[jhapi.VisualDL(jdir)])
    tm.fit(data, epochs=2, verbose=0, callbacks=[thapi.VisualDL(tdir)])
    for mode in ("train", "train-epoch"):
        want = jhapi.VisualDL.read_scalars(jdir, mode)
        got = thapi.VisualDL.read_scalars(tdir, mode)
        # each package reads the other's files
        assert jhapi.VisualDL.read_scalars(tdir, mode) == got
        assert thapi.VisualDL.read_scalars(jdir, mode) == want
        assert sorted(got) == sorted(want)
        for tag in want:
            assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]]
            np.testing.assert_allclose([v for _, v in got[tag]],
                                       [v for _, v in want[tag]],
                                       rtol=RTOL)
    assert len(thapi.VisualDL.read_scalars(tdir)["train/loss"]) == 16


def _preds_with_ties():
    rng = np.random.default_rng(9)
    p = np.round(rng.random((40, 5)), 1).astype(np.float32)
    p[:8] = 0.5  # rows tied across all classes
    label = rng.integers(0, 5, 40).astype(np.int64)
    return p, label


def test_metric_classes_match_jax():
    p, label = _preds_with_ties()
    for topk in ((1,), (1, 2), 3):
        ja, ta = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
        for sl in (slice(0, 20), slice(20, 40)):
            jc = ja.compute(pt.to_tensor(p[sl]), pt.to_tensor(label[sl]))
            tc = ta.compute(torch.from_numpy(p[sl]),
                            torch.from_numpy(label[sl]))
            np.testing.assert_array_equal(tc, np.asarray(jc))
            np.testing.assert_array_equal(ta.update(tc), ja.update(jc))
        assert ta.accumulate() == ja.accumulate()
        assert ta.name() == ja.name()
    rng = np.random.default_rng(10)
    score = rng.random(200).astype(np.float32)
    y = (rng.random(200) < score).astype(np.int64)
    for cls in ("Precision", "Recall", "Auc"):
        jm, tm = getattr(jmetric, cls)(), getattr(tmetric, cls)()
        jm.update(score[:100], y[:100])
        jm.update(score[100:], y[100:])
        tm.update(torch.from_numpy(score[:100]), torch.from_numpy(y[:100]))
        tm.update(score[100:], y[100:])
        assert tm.accumulate() == jm.accumulate(), cls
        assert tm.name() == jm.name()
        tm.reset()
        assert tm.accumulate() == 0.0
    two = np.stack([1 - score, score], 1)
    ja, ta = jmetric.Auc(num_thresholds=255), tmetric.Auc(num_thresholds=255)
    ja.update(two, y)
    ta.update(torch.from_numpy(two), torch.from_numpy(y))
    assert ta.accumulate() == ja.accumulate()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_functional_accuracy_ties_match_jax(k):
    p, label = _preds_with_ties()
    for lbl in (label, label[:, None]):
        want = jmetric.accuracy(pt.to_tensor(p), pt.to_tensor(lbl), k=k)
        got = tmetric.accuracy(torch.from_numpy(p), torch.from_numpy(lbl),
                               k=k)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want.numpy()),
                                   rtol=MEAN_RTOL)
    # a tie across all classes: the lower index wins, as in lax.top_k
    tie = torch.full((1, 4), 0.25)
    assert float(tmetric.accuracy(tie, torch.tensor([0]))) == 1.0
    assert float(tmetric.accuracy(tie, torch.tensor([3]))) == 0.0


def test_static_accuracy_fills_correct_and_total():
    p, label = _preds_with_ties()
    correct = torch.zeros((), dtype=torch.int64)
    total = torch.zeros((), dtype=torch.int64)
    acc = tstatic.accuracy(torch.from_numpy(p), torch.from_numpy(label),
                           k=2, correct=correct, total=total)
    from paddle_tpu import static as jstatic
    want = jstatic.accuracy(pt.to_tensor(p), pt.to_tensor(label), k=2)
    np.testing.assert_allclose(float(acc), float(want.numpy()),
                               rtol=MEAN_RTOL)
    assert int(total) == 40
    assert int(correct) == round(float(acc) * 40)


def _macs(model, x):
    """2 x the multiply-adds of the model's convolutions and linears,
    reckoned from the shapes each one sees."""
    total = []

    def hook(mod, inputs, out):
        if isinstance(mod, Conv2D):
            cin_g = mod.weight.shape[1]
            k = math.prod(mod.weight.shape[2:])
            total.append(out.numel() * cin_g * k)
        else:
            total.append(out.numel() * mod.weight.shape[0])

    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, (Conv2D, Linear))]
    model.eval()
    with torch.no_grad():
        model(x)
    for h in hs:
        h.remove()
    return 2 * sum(total)


def test_flops_lenet_and_resnet50():
    from paddle_tpu.vision.models import LeNet as JLeNet
    net = LeNet(device="cpu")
    got = thapi.flops(net, (2, 1, 28, 28))
    assert net.training  # flops leaves the mode as it found it
    assert got == _macs(net, torch.zeros(2, 1, 28, 28))
    pt.seed(0)
    jfig = jhapi.flops(JLeNet(), (2, 1, 28, 28))
    print(f"LeNet [2, 1, 28, 28]: port {got} (2 x MACs), JAX {jfig} "
          f"(XLA cost analysis)")
    r50 = resnet50(device="cpu")
    got = thapi.flops(r50, (1, 3, 224, 224))
    assert got == _macs(r50, torch.zeros(1, 3, 224, 224))
    print(f"ResNet-50 [1, 3, 224, 224]: port {got} (2 x MACs)")
    # ResNet-50's published 4.1 GMACs a 224 x 224 image
    assert 8.0e9 < got < 8.4e9


def test_model_takes_numpy_batches():
    """Numpy batches are moved to the network's device (the CPU here),
    as the JAX package's Model takes them."""
    _, tm = _models(joptim.SGD(learning_rate=0.1),
                    toptim.SGD(learning_rate=0.1), jnn.CrossEntropyLoss(),
                    CrossEntropyLoss())
    x, y = _data()[0]
    out = tm.predict_batch(x)
    assert isinstance(out[0], np.ndarray) and out[0].shape == (16, 3)
    assert tm.device == torch.device("cpu")
    assert isinstance(tm.train_batch(x, y)[0], float)
