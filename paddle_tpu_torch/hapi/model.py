"""``Model``, the high-level training API, the counterpart of
``paddle_tpu/hapi/model.py``: ``prepare``, ``train_batch``,
``eval_batch``, ``predict_batch``, ``fit``, ``evaluate``, ``predict``,
``save``, ``load``, ``parameters`` and ``summary``.

``prepare(jit=True)`` (the default) trains through the port's
``jit.TrainStep`` (with ``has_aux`` when there are metrics, so the step
also returns the network's outputs for them), built for one label and
rebuilt when a batch brings another number of labels; ``jit=False``
runs the per-batch autograd loop (forward, loss, ``backward``,
``step``, ``clear_grad``).  Both compute the same step, bit for bit.
JAX falls back from its traced step to the eager loop when a forward
cannot be traced (``model.py:109-128``); nothing traces here, so there
is no fallback.

``fit`` steps an optimizer's learning-rate schedule once a batch,
through the ``LRScheduler`` callback, as upstream Paddle; JAX's
``train_batch`` steps it as well, twice a batch in all (ROADMAP.md,
reference caveats).  ``amp_configs`` is accepted and ignored, as in JAX.

Batches may come from a ``Dataset`` (wrapped in an ``io.DataLoader``
whose ``places`` is the network's device), a ``DataLoader``, or any
iterable of tensors or NumPy arrays; every input and label is moved to
the network's device.  ``predict_batch`` returns NumPy arrays (a
bfloat16 output as float32, which holds its values exactly).

``fit`` records the ``hapi.step_seconds`` and ``hapi.ips`` histograms
(wall seconds and samples a second of each train batch) and
``evaluate`` ``hapi.eval_batch_seconds``, on the port's
``observability.metrics``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..metric import Metric
from ..observability import metrics as _obs_metrics
from .callbacks import LRScheduler as LRCallback
from .callbacks import ModelCheckpoint, ProgBarLogger

_FIT_STEP_SECONDS = _obs_metrics.histogram(
    "hapi.step_seconds", "Model.fit wall seconds per train batch")
_FIT_IPS = _obs_metrics.histogram(
    "hapi.ips", "Model.fit samples per second, by train batch")
_EVAL_BATCH_SECONDS = _obs_metrics.histogram(
    "hapi.eval_batch_seconds", "Model.evaluate wall seconds per batch")


def _batch_rows(inputs):
    """The leading-dim sample count of the first shaped input (None when
    the batch has none)."""
    for x in inputs:
        shape = getattr(x, "shape", None)
        if shape:
            return int(shape[0])
    return None


def _network_device(network):
    for t in network.parameters():
        return t.device
    for t in network.buffers():
        return t.device
    return resolve_device()


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._device = _network_device(network)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        self._train_step = None
        self._train_step_labels = None
        self._use_jit = False

    # -------------- setup --------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit=True):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, Metric):
            self._metrics = [metrics]
        else:
            self._metrics = list(metrics)
        self._use_jit = jit
        self._train_step = None
        if jit and optimizer is not None and loss is not None:
            self._build_train_step(n_labels=1)
        return self

    def _build_train_step(self, n_labels):
        """The train step for a known split of the batch into inputs and
        ``n_labels`` labels; a batch with another number of labels
        rebuilds it instead of mis-splitting."""
        from ..jit.train_step import TrainStep

        loss_layer = self._loss
        with_aux = bool(self._metrics)

        def loss_fn(net, *batch):
            xs = batch[:len(batch) - n_labels]
            ys = batch[len(batch) - n_labels:]
            out = net(*xs)
            loss = loss_layer(out, *ys)
            return (loss, out) if with_aux else loss

        self._train_step = TrainStep(self.network, loss_fn, self._optimizer,
                                     has_aux=with_aux, device=self._device)
        self._train_step_labels = n_labels

    # -------------- steps --------------
    def _on_device(self, xs):
        return [_as_tensor(x, self._device) for x in _to_list(xs)]

    def train_batch(self, inputs, labels=None, update=True):
        """One optimizer step (with ``update=False``, the forward and
        backward alone, gradients kept for a later step); returns
        ``[loss]`` as a float.  Does not step the learning-rate
        schedule."""
        self.network.train()
        inputs = self._on_device(inputs)
        labels = self._on_device(labels)
        if (self._use_jit and update and labels
                and self._train_step is not None):
            if self._train_step_labels != len(labels):
                self._build_train_step(n_labels=len(labels))
            if self._train_step.has_aux:
                loss, outs = self._train_step(*inputs, *labels)
                self._update_metrics(outs, labels)
            else:
                loss = self._train_step(*inputs, *labels)
            return [float(loss)]
        outs = self.network(*inputs)
        loss = self._loss(outs, *labels) if self._loss else outs
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        self._update_metrics(outs, labels)
        return [float(loss.detach())]

    def _update_metrics(self, outs, labels):
        if not self._metrics:
            return
        with torch.no_grad():
            for m in self._metrics:
                corr = m.compute(outs, *labels)
                # the base Metric.compute passes its arguments through as
                # a tuple (Precision, Recall), which update unpacks
                if isinstance(corr, (tuple, list)):
                    m.update(*corr)
                else:
                    m.update(corr)

    def _metric_logs(self, logs):
        for m in self._metrics:
            name = m.name()
            res = m.accumulate()
            if isinstance(name, list):
                for n, r in zip(name, res if isinstance(res, list)
                                else [res]):
                    logs[n] = r
            else:
                logs[name] = res
        return logs

    def eval_batch(self, inputs, labels=None):
        """``(loss or None, [each metric's update of this batch])`` in
        ``eval()`` mode without gradients."""
        self.network.eval()
        inputs = self._on_device(inputs)
        labels = self._on_device(labels)
        with torch.no_grad():
            outs = self.network(*inputs)
            loss_val = None
            if self._loss is not None and labels:
                loss_val = float(self._loss(outs, *labels))
            metrics_out = []
            for m in self._metrics:
                corr = m.compute(outs, *labels)
                if isinstance(corr, (tuple, list)):
                    metrics_out.append(m.update(*corr))
                else:
                    metrics_out.append(m.update(corr))
        return loss_val, metrics_out

    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            outs = self.network(*self._on_device(inputs))
        return [_numpy(o) for o in _to_list(outs)]

    # -------------- loops --------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        loader = self._as_loader(train_data, batch_size, shuffle, drop_last,
                                 num_workers)
        eval_loader = (self._as_loader(eval_data, batch_size, False, False,
                                       num_workers)
                       if eval_data is not None else None)
        cbs = [ProgBarLogger(log_freq, verbose=verbose), LRCallback()]
        if save_dir:
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        cbs += list(callbacks or [])
        for cb in cbs:
            cb.set_model(self)
            cb.set_params({"epochs": epochs, "steps": _safe_len(loader),
                           "verbose": verbose})
        self.stop_training = False
        for cb in cbs:
            cb.on_train_begin()
        step_count = 0
        logs = {}
        for epoch in range(epochs):
            sampler = getattr(loader, "batch_sampler", None)
            if hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            for cb in cbs:
                cb.on_epoch_begin(epoch)
            logs = {}
            for m in self._metrics:
                m.reset()
            for step, batch in enumerate(loader):
                for cb in cbs:
                    cb.on_train_batch_begin(step)
                ins, lbls = _split_batch(batch)
                bt0 = time.perf_counter()
                losses = self.train_batch(ins, lbls)
                bdt = time.perf_counter() - bt0
                _FIT_STEP_SECONDS.observe(bdt)
                rows = _batch_rows(ins)
                if rows and bdt > 0:
                    _FIT_IPS.observe(rows / bdt)
                logs = {"loss": losses, "lr": self._optimizer.get_lr()}
                self._metric_logs(logs)
                for cb in cbs:
                    cb.on_train_batch_end(step, logs)
                step_count += 1
                if num_iters is not None and step_count >= num_iters:
                    break
            for cb in cbs:
                cb.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self._run_eval(eval_loader, cbs)
            if self.stop_training or (num_iters is not None
                                      and step_count >= num_iters):
                break
        for cb in cbs:
            cb.on_train_end(logs)

    def _run_eval(self, loader, cbs):
        for cb in cbs:
            cb.on_eval_begin()
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            ins, lbls = _split_batch(batch)
            bt0 = time.perf_counter()
            loss, _ = self.eval_batch(ins, lbls)
            _EVAL_BATCH_SECONDS.observe(time.perf_counter() - bt0)
            if loss is not None:
                losses.append(loss)
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        self._metric_logs(logs)
        for cb in cbs:
            cb.on_eval_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._as_loader(eval_data, batch_size, False, False,
                                 num_workers)
        cbs = list(callbacks or [])
        for cb in cbs:
            cb.set_model(self)
        return self._run_eval(loader, cbs)

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._as_loader(test_data, batch_size, False, False,
                                 num_workers)
        outputs = []
        for batch in loader:
            ins, _ = _split_batch(batch)
            outputs.append(self.predict_batch(ins))
        if stack_outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    def _as_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        from ..io import DataLoader, Dataset

        if isinstance(data, Dataset):
            return DataLoader(data, places=self._device,
                              batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers)
        return data          # a DataLoader, or an iterable of batches

    # -------------- persistence --------------
    def save(self, path, training=True):
        """``path.pdparams`` (the network's ``state_dict``) and, with
        ``training``, ``path.pdopt`` (the optimizer's)."""
        from ..framework.io import save

        save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load ``path.pdparams`` as JAX's ``set_state_dict`` (keys the
        network lacks or misses are passed over, a misshaped tensor
        raises) and ``path.pdopt`` where it exists."""
        from ..framework.io import load

        self.network.load_state_dict(
            load(path + ".pdparams", device=self._device), strict=False)
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(
                load(path + ".pdopt", device=self._device))

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters())

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary

        return summary(self.network, input_size, dtypes=dtype)


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _numpy(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _split_batch(batch):
    if isinstance(batch, (list, tuple)) and len(batch) >= 2:
        return list(batch[:-1]), [batch[-1]]
    return _to_list(batch), []


def _safe_len(loader):
    try:
        return len(loader)
    except TypeError:
        return None
