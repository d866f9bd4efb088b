"""Training callbacks (port of ``paddle_tpu/hapi/callbacks.py``; the
reference's ``python/paddle/hapi/callbacks.py``: Callback base,
ProgBarLogger, ModelCheckpoint:532, LRScheduler, EarlyStopping:687,
ReduceLROnPlateau, VisualDL). Host-side Python, as in the JAX package:
``VisualDL`` writes its scalars in the JAX package's format, so
``read_scalars`` reads either package's logs."""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatcher(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return dispatcher
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq: int = 1, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = ", ".join(f"{k}: {_fmt(v)}" for k, v in
                              (logs or {}).items())
            print(f"step {step}/{self.steps or '?'} - {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            items = ", ".join(f"{k}: {_fmt(v)}" for k, v in
                              (logs or {}).items())
            print(f"Epoch {epoch + 1} done in {dt:.1f}s - {items}")


def _fmt(v):
    try:
        return f"{float(v):.4f}"
    except (TypeError, ValueError):
        return str(v)


class ModelCheckpoint(Callback):
    """reference: hapi/callbacks.py:532 — save every epoch."""

    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir or "checkpoints"

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model is not None:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    """reference: hapi/callbacks.py:687."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.stopped_epoch = 0
        self.wait = 0
        self.best = None
        self.stop_training = False

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).ravel()[0])
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
                if self.model is not None:
                    self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping: best {self.monitor}="
                          f"{self.best}")


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.min_delta = min_delta
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None or self.model is None:
            return
        cur = float(np.asarray(cur).ravel()[0])
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        better = self.best is None or (
            cur < self.best - self.min_delta if self.mode == "min"
            else cur > self.best + self.min_delta)
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                opt = self.model._optimizer
                try:
                    lr = opt.get_lr()
                    opt.set_lr(max(lr * self.factor, self.min_lr))
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr -> {opt.get_lr()}")
                except Exception:
                    pass
                self.cooldown_counter = self.cooldown
                self.wait = 0


class VisualDL(Callback):
    """Scalar logging to a logdir (reference: hapi/callbacks.py:839
    VisualDL callback over the visualdl LogWriter). The visualdl package
    is CUDA-ecosystem tooling; here scalars stream to
    ``<log_dir>/scalars-<mode>.jsonl`` (one {"tag", "step", "value"}
    record per line — trivially loadable into pandas/TensorBoard), and
    ``read_scalars`` loads them back."""

    def __init__(self, log_dir: str = "./log"):
        super().__init__()
        self.log_dir = log_dir
        self.epochs = None
        self._writers = {}
        self._train_step = 0

    def _writer(self, mode: str):
        import os
        w = self._writers.get(mode)
        if w is None:
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(self.log_dir, f"scalars-{mode}.jsonl")
            # one file per callback instance (a fresh fit() run starts a
            # fresh log; appending would interleave restarting steps)
            w = open(path, "w")
            self._writers[mode] = w
        return w

    def _log(self, mode: str, step: int, logs) -> None:
        import json as _json
        w = self._writer(mode)
        for tag, value in (logs or {}).items():
            try:
                vals = np.asarray(value).ravel()
                if not len(vals):
                    continue
                v = float(vals[0])
            except (TypeError, ValueError):
                continue
            w.write(_json.dumps({"tag": f"{mode}/{tag}", "step": step,
                                 "value": v}) + "\n")
        w.flush()

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")

    def on_train_batch_end(self, step, logs=None):
        self._train_step += 1
        self._log("train", self._train_step, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._log("train-epoch", epoch, logs)

    def on_eval_end(self, logs=None):
        self._log("eval", self._train_step, logs)

    def on_train_end(self, logs=None):
        for w in self._writers.values():
            w.close()
        self._writers.clear()

    @staticmethod
    def read_scalars(log_dir: str, mode: str = "train"):
        """Load logged scalars back: {tag: [(step, value), ...]}."""
        import json as _json
        import os
        out = {}
        path = os.path.join(log_dir, f"scalars-{mode}.jsonl")
        if not os.path.exists(path):
            return out
        with open(path) as f:
            for line in f:
                rec = _json.loads(line)
                out.setdefault(rec["tag"], []).append(
                    (rec["step"], rec["value"]))
        return out
