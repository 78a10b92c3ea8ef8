"""``Model.fit``'s callbacks, the counterparts of
``paddle_tpu/hapi/callbacks.py``: ``Callback``, ``ProgBarLogger``,
``ModelCheckpoint``, ``LRScheduler``, ``EarlyStopping``,
``ObservabilityCallback`` (on the port's ``observability``) and
``VisualDL`` (scalars as a TSV file).

``LRScheduler`` is what steps an optimizer's schedule in ``fit``: once a
batch (``by_step``) or once an epoch (``by_epoch``), as upstream
Paddle's; ``Model.train_batch`` does not step it (JAX's does, so its
``fit`` steps a schedule twice a batch: ROADMAP.md, reference
caveats)."""

from __future__ import annotations

import os
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

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


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
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
            print(f"step {step}/{self.steps or '?'} - {_items(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch + 1} done ({time.time() - self._t0:.1f}s) "
                  f"- {_items(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {_items(logs)}")


def _items(logs):
    return " - ".join(f"{k}: {_fmt(v)}" for k, v in (logs or {}).items())


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4f}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt(x) for x in v) + "]"
    return str(v)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir or "checkpoint"

    def on_epoch_end(self, epoch, logs=None):
        if epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched  # noqa: N814

        opt = getattr(self.model, "_optimizer", None)
        if opt is not None and isinstance(opt._learning_rate, Sched):
            return opt._learning_rate
        return None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and self.by_epoch:
            s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "min" if "loss" in monitor else "max"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        cur = float(cur)
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class ObservabilityCallback(Callback):
    """Publishes the fit/eval loop into ``paddle_tpu_torch.observability``:
    epoch begin/end timeline events, per-batch loss/lr gauges, and a
    train-step counter, so a scrape of
    ``observability.render_prometheus()`` sees training progress next to
    the serving and dataloader metrics.  Purely additive: Model.fit
    records its step-time and samples/s histograms in any case."""

    def __init__(self, prefix="hapi"):
        super().__init__()
        from ..observability import events, metrics

        self._events = events
        self.prefix = prefix
        self._loss = metrics.gauge(f"{prefix}.loss",
                                   "last training-batch loss")
        self._lr = metrics.gauge(f"{prefix}.lr", "current learning rate")
        self._steps = metrics.counter(f"{prefix}.train_batches",
                                      "train batches seen by Model.fit")
        self._eval_loss = metrics.gauge(f"{prefix}.eval_loss",
                                        "last evaluation loss")

    def on_train_begin(self, logs=None):
        self._events.instant(f"{self.prefix}.train_begin", cat="hapi",
                             epochs=self.params.get("epochs"))

    def on_train_end(self, logs=None):
        self._events.instant(f"{self.prefix}.train_end", cat="hapi")

    def on_epoch_begin(self, epoch, logs=None):
        self._events.begin(f"{self.prefix}.epoch", cat="hapi",
                           epoch=epoch)

    def on_epoch_end(self, epoch, logs=None):
        self._events.end(f"{self.prefix}.epoch", cat="hapi", epoch=epoch)

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        self._steps.inc()
        loss = logs.get("loss")
        if isinstance(loss, (list, tuple)) and loss:
            loss = loss[0]
        if isinstance(loss, (int, float)):
            self._loss.set(loss)
        lr = logs.get("lr")
        if isinstance(lr, (int, float)):
            self._lr.set(lr)

    def on_eval_begin(self, logs=None):
        self._events.begin(f"{self.prefix}.eval", cat="hapi")

    def on_eval_end(self, logs=None):
        logs = logs or {}
        loss = logs.get("loss")
        if isinstance(loss, (int, float)):
            self._eval_loss.set(loss)
        self._events.end(f"{self.prefix}.eval", cat="hapi")


class VisualDL(Callback):
    """Scalars logged as TSV lines (time, step, name, value) in
    ``log_dir/scalars.tsv``, for any dashboard to ingest (the VisualDL
    package itself is not used)."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = None

    def on_train_begin(self, logs=None):
        self._f = open(os.path.join(self.log_dir, "scalars.tsv"), "a")

    def on_train_batch_end(self, step, logs=None):
        for k, v in (logs or {}).items():
            if isinstance(v, (int, float)):
                self._f.write(f"{time.time()}\t{step}\t{k}\t{v}\n")

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()
