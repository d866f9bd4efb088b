"""The high-level ``Model``: prepare, fit, evaluate, predict, save, load
and summary (port of ``paddle_tpu/hapi/model.py``; the reference's
``python/paddle/hapi/model.py:883``).

Training runs through ``jit.TrainStep`` (one eager step a batch: the
forward, autograd and the optimizer's in-place update), evaluation and
prediction through the network in eval mode under ``torch.no_grad()``.
Everything runs on the device of the network's parameters: CUDA unless
the caller built the network on the CPU. Numpy batches are moved there;
a ``Dataset`` is batched by ``io.DataLoader`` onto that device.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..device import module_device
from ..framework.io import load as fload, save as fsave
from ..io.dataloader import DataLoader
from ..io.dataset import Dataset
from ..metric import Metric
from .callbacks import CallbackList, ModelCheckpoint, ProgBarLogger


class Model:
    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        self._train_step = None

    @property
    def device(self) -> torch.device:
        return module_device(self.network)

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, (list, tuple)):
            self._metrics = list(metrics)
        else:
            self._metrics = [metrics]

    # -- core loops -----------------------------------------------------------

    def _build_train_step(self):
        from ..jit import TrainStep

        loss_fn = self._loss

        def step_fn(model, batch):
            *xs, y = batch
            return loss_fn(model(*xs), y)

        return TrainStep(self.network, self._optimizer, step_fn,
                         device=self.device)

    def _tensor(self, x) -> torch.Tensor:
        if torch.is_tensor(x):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def train_batch(self, inputs, labels=None):
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        if labels is not None and not isinstance(labels, (list, tuple)):
            labels = [labels]
        batch = tuple(self._tensor(t) for t in
                      tuple(inputs) + tuple(labels or ()))
        if self._train_step is None:
            self._train_step = self._build_train_step()
        loss = self._train_step(batch)
        return [float(loss)]

    def _eval_forward(self, inputs):
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self.network.eval()
        try:
            with torch.no_grad():
                return self.network(*[self._tensor(i) for i in inputs])
        finally:
            self.network.train()

    def eval_batch(self, inputs, labels=None):
        out = self._eval_forward(inputs)
        losses = []
        if self._loss is not None and labels is not None:
            label = labels[0] if isinstance(labels, (list, tuple)) else \
                labels
            with torch.no_grad():
                losses = [float(self._loss(out, self._tensor(label)))]
        return losses, out

    def predict_batch(self, inputs):
        out = self._eval_forward(inputs)
        return [o.detach().cpu().numpy() if torch.is_tensor(o)
                else np.asarray(o) for o in pytree.tree_leaves(out)]

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None):
        train_loader = self._as_loader(train_data, batch_size, shuffle,
                                       drop_last, num_workers)
        eval_loader = self._as_loader(eval_data, batch_size, False, False,
                                      num_workers) \
            if eval_data is not None else None

        cbks = list(callbacks or [])
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
        if save_dir:
            cbks.append(ModelCheckpoint(save_freq, save_dir))
        cbk = CallbackList(cbks)
        cbk.set_model(self)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbk.set_params({"epochs": epochs, "steps": steps,
                        "verbose": verbose, "metrics": ["loss"] + [
                            m.name() for m in self._metrics]})

        cbk.on_train_begin()
        self.stop_training = False
        logs = {}
        for epoch in range(epochs):
            cbk.on_epoch_begin(epoch)
            logs = {}
            for step, batch in enumerate(train_loader):
                cbk.on_train_batch_begin(step)
                xs, y = _split_batch(batch)
                losses = self.train_batch(xs, y)
                logs = {"loss": losses[0]}
                cbk.on_train_batch_end(step, logs)
                if self.stop_training:
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate_loop(eval_loader, cbk)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbk.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        cbk.on_train_end(logs)

    def evaluate_loop(self, loader, cbk=None):
        if cbk is None:
            cbk = CallbackList([])
        cbk.on_eval_begin()
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            cbk.on_eval_batch_begin(step)
            xs, y = _split_batch(batch)
            batch_losses, out = self.eval_batch(xs, y)
            losses.extend(batch_losses)
            for m in self._metrics:
                label = y[0] if isinstance(y, (list, tuple)) else y
                m.update(m.compute(out, label))
            cbk.on_eval_batch_end(step)
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            acc = m.accumulate()
            accs = acc if isinstance(acc, (list, tuple)) else [acc]
            logs.update(dict(zip(names, accs)))
        cbk.on_eval_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        loader = self._as_loader(eval_data, batch_size, False, False,
                                 num_workers)
        return self.evaluate_loop(loader)

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None):
        loader = self._as_loader(test_data, batch_size, False, False,
                                 num_workers)
        outputs = []
        for batch in loader:
            # datasets that yield (x, label) pairs: feed x only, as
            # fit / evaluate split them
            xs, _ = _split_batch(batch)
            outputs.append(self.predict_batch(xs))
        if stack_outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    def _as_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        if isinstance(data, Dataset):
            return DataLoader(data, places=self.device,
                              batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers)
        return data

    # -- persistence ----------------------------------------------------------

    def save(self, path: str, training: bool = True) -> None:
        """``path.pdparams`` (the network's state dict, the JAX package's
        keys) and, with ``training``, ``path.pdopt`` (the optimizer's)."""
        fsave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path: str, skip_mismatch=False, reset_optimizer=False
             ) -> None:
        state = fload(path + ".pdparams")
        with torch.no_grad():
            for name, t in self.network.state_dict().items():
                if name in state:
                    t.copy_(torch.as_tensor(state[name]))
                elif not skip_mismatch:
                    raise KeyError(f"{path}.pdparams has no {name!r}")
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None and
                os.path.exists(opt_path)):
            if self._optimizer._named is None:
                self._optimizer.bind(self.network.named_parameters())
            self._optimizer.set_state_dict(fload(opt_path))
        self._train_step = None  # rebuilt against the loaded weights

    def parameters(self):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        params = list(self.network.parameters())
        total = sum(p.numel() for p in params)
        trainable = sum(p.numel() for p in params if p.requires_grad)
        lines = [f"{'Layer':<40}{'Params':>12}"]
        for name, layer in self.network.named_modules():
            if not name:
                continue
            n = sum(p.numel() for p in layer.parameters(recurse=False))
            if n:
                lines.append(f"{name:<40}{n:>12,}")
        lines.append(f"Total params: {total:,}")
        lines.append(f"Trainable params: {trainable:,}")
        print("\n".join(lines))
        return {"total_params": total, "trainable_params": trainable}


def _split_batch(batch, labeled=True):
    if isinstance(batch, (list, tuple)):
        if labeled and len(batch) >= 2:
            return list(batch[:-1]), batch[-1]
        return list(batch), None
    return [batch], None
