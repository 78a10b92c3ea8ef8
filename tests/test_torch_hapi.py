"""The port's ``hapi`` (``Model`` and its callbacks, ``summary``,
``flops``) against the JAX package's on the CPU, on a small MLP both
packages build (Linear 8-16, ReLU, Linear 16-4; JAX's ``[in, out]``
weights carried across transposed) over a numpy-seeded dataset.

Tolerance: ``fit`` against JAX's, rtol 1e-5 and atol 1e-6 on every
per-batch loss, final parameter, evaluation figure and prediction
(the same f32 steps; matmul sums may round in another order).  Inside
the port, ``jit=True`` equals ``jit=False`` bit for bit.  The callbacks
see JAX's event sequence; ``summary`` and ``flops`` give JAX's totals
for ResNet-50 (JAX's counted under ``jax.eval_shape``: shapes only)."""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
import paddle_tpu.nn as jnn
from paddle_tpu import hapi as jhapi
from paddle_tpu.vision.models import resnet50 as jresnet50
import paddle_tpu_torch as pt
from paddle_tpu_torch import hapi as thapi
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.optimizer import SGD, Momentum
from paddle_tpu_torch.optimizer.lr import StepDecay
from paddle_tpu_torch.vision.models import resnet50 as tresnet50

from _torch_port_util import one_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
X = np.random.RandomState(0).randn(32, 8).astype(np.float32)
Y = np.random.RandomState(1).randint(0, 4, 32)


def _dataset(mod, n=32):
    class Rows(mod.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return X[i % 32], int(Y[i % 32])

    return Rows()


def _nets():
    """The JAX MLP and the port's with the same weights."""
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tnet = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.ReLU(),
                          tnn.Linear(16, 4, device="cpu"))
    with torch.no_grad():
        for k, v in jnet.state_dict().items():
            a = np.asarray(v.numpy())
            tnet.state_dict()[k].copy_(torch.tensor(a))
    return jnet, tnet


def _port_params(tnet):
    return {k: v.detach().numpy() for k, v in tnet.state_dict().items()}


class _Recorder:
    """Mixin of a callback that records each hook's name and argument
    and the train batches' losses."""

    def _setup(self):
        self.events, self.losses = [], []

    def _note(self, name, arg=None):
        self.events.append((name, arg))


def _recorder(cb_base):
    class Rec(cb_base, _Recorder):
        def __init__(self):
            super().__init__()
            self._setup()

        def on_train_begin(self, logs=None):
            self._note("train_begin")

        def on_train_end(self, logs=None):
            self._note("train_end")

        def on_epoch_begin(self, epoch, logs=None):
            self._note("epoch_begin", epoch)

        def on_epoch_end(self, epoch, logs=None):
            self._note("epoch_end", epoch)

        def on_train_batch_begin(self, step, logs=None):
            self._note("batch_begin", step)

        def on_train_batch_end(self, step, logs=None):
            self._note("batch_end", step)
            self.losses.append(logs["loss"][0])

        def on_eval_begin(self, logs=None):
            self._note("eval_begin")

        def on_eval_end(self, logs=None):
            self._note("eval_end", sorted(logs))

    return Rec()


def _fit_both(epochs=2, lr=0.1, callbacks=(), **fit_kw):
    jnet, tnet = _nets()
    jm, tm = jhapi.Model(jnet), pt.Model(tnet)
    jm.prepare(paddle.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                         parameters=jnet.parameters()),
               jnn.CrossEntropyLoss(), paddle.metric.Accuracy(topk=(1, 2)))
    tm.prepare(Momentum(learning_rate=lr, momentum=0.9,
                        parameters=tnet.parameters(), device="cpu"),
               tnn.CrossEntropyLoss(), tmetric.Accuracy(topk=(1, 2)))
    recs = []
    for m, io_mod, base in ((jm, jio, jhapi.callbacks.Callback),
                            (tm, tio, thapi.callbacks.Callback)):
        rec = _recorder(base)
        recs.append(rec)
        np.random.seed(0)
        m.fit(_dataset(io_mod), eval_data=_dataset(io_mod, 12), batch_size=8,
              epochs=epochs, verbose=0, callbacks=[rec] + [
                  c(io_mod) for c in callbacks], **fit_kw)
    return (jm, tm), (jnet, tnet), recs


def test_fit_evaluate_predict_match_jax():
    (jm, tm), (jnet, tnet), (jrec, trec) = _fit_both(shuffle=True)
    assert trec.events == jrec.events
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=RTOL,
                               atol=ATOL)
    want = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    for k, v in _port_params(tnet).items():
        np.testing.assert_allclose(v, want[k], rtol=RTOL, atol=ATOL)
    je = jm.evaluate(_dataset(jio, 20), batch_size=8, verbose=0)
    te = tm.evaluate(_dataset(tio, 20), batch_size=8, verbose=0)
    assert sorted(te) == sorted(je) == ["acc_top1", "acc_top2", "loss"]
    for k in je:
        np.testing.assert_allclose(te[k], je[k], rtol=RTOL, atol=ATOL)
    jp = jm.predict(_dataset(jio, 20), batch_size=8, stack_outputs=True)
    tp = tm.predict(_dataset(tio, 20), batch_size=8, stack_outputs=True)
    assert tp[0].shape == jp[0].shape == (20, 4)
    np.testing.assert_allclose(tp[0], jp[0], rtol=RTOL, atol=ATOL)


def test_jit_step_equals_the_eager_loop_bit_for_bit():
    runs = []
    for jit in (True, False):
        _, tnet = _nets()
        m = pt.Model(tnet)
        m.prepare(Momentum(learning_rate=0.1, momentum=0.9,
                           parameters=tnet.parameters(), device="cpu"),
                  tnn.CrossEntropyLoss(), tmetric.Accuracy(), jit=jit)
        rec = _recorder(thapi.callbacks.Callback)
        m.fit(_dataset(tio), batch_size=8, epochs=2, shuffle=False,
              verbose=0, callbacks=[rec])
        runs.append((rec.losses, tnet.state_dict(), m._metrics[0].total))
    assert runs[0][0] == runs[1][0]
    assert runs[0][2] == runs[1][2]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_lr_schedule_steps_once_a_batch():
    """JAX's fit steps a schedule in train_batch and again in the
    LRScheduler callback: 4 batches leave ``last_epoch`` at 8 (ROADMAP.md,
    reference caveats); the port's steps it once a batch, as upstream
    Paddle."""
    jnet, tnet = _nets()
    jsched = paddle.optimizer.lr.StepDecay(0.1, step_size=1000)
    tsched = StepDecay(0.1, step_size=1000)
    jm = jhapi.Model(jnet).prepare(
        paddle.optimizer.SGD(learning_rate=jsched,
                             parameters=jnet.parameters()),
        jnn.CrossEntropyLoss())
    tm = pt.Model(tnet).prepare(
        SGD(learning_rate=tsched, parameters=tnet.parameters(),
            device="cpu"), tnn.CrossEntropyLoss())
    jm.fit(_dataset(jio), batch_size=8, epochs=1, verbose=0)
    tm.fit(_dataset(tio), batch_size=8, epochs=1, verbose=0)
    assert jsched.last_epoch == 8
    assert tsched.last_epoch == 4


@pytest.mark.parametrize("mode", ["early_stopping", "num_iters"])
def test_early_stopping_and_num_iters_match_jax(mode):
    if mode == "early_stopping":
        # "max" on a falling loss: the second evaluation is no better, so
        # patience 1 stops training after epoch 2 of 5
        cb = [lambda m: (jhapi.callbacks if m is jio else thapi.callbacks
                         ).EarlyStopping(monitor="loss", mode="max",
                                         patience=1)]
        _, _, (jrec, trec) = _fit_both(epochs=5, callbacks=cb)
        n_epochs = 2
    else:
        _, _, (jrec, trec) = _fit_both(epochs=3, num_iters=5)
        n_epochs = 2
    assert trec.events == jrec.events
    assert sum(e == "epoch_begin" for e, _ in trec.events) == n_epochs
    if mode == "num_iters":
        assert len(trec.losses) == 5
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=RTOL,
                               atol=ATOL)


def test_model_checkpoint_save_and_load(tmp_path):
    _, tnet = _nets()
    m = pt.Model(tnet)
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=tnet.named_parameters(), device="cpu")
    m.prepare(opt, tnn.CrossEntropyLoss())
    m.fit(_dataset(tio), batch_size=8, epochs=2, verbose=0,
          save_dir=str(tmp_path))
    for tag in ("0", "1", "final"):
        for ext in (".pdparams", ".pdopt"):
            assert os.path.exists(tmp_path / f"{tag}{ext}"), tag + ext
    _, fresh = _nets()
    m2 = pt.Model(fresh)
    opt2 = Momentum(learning_rate=0.1, momentum=0.9,
                    parameters=fresh.named_parameters(), device="cpu")
    m2.prepare(opt2, tnn.CrossEntropyLoss())
    m2.load(str(tmp_path / "final"))
    for k, v in tnet.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert s1["global_step"] == s2["global_step"] == 8
    for k, v in s1.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(s2[k], v), k


class _TwoLabelLoss:
    def __init__(self, F):
        self.F = F

    def __call__(self, out, y1, y2):
        return self.F.cross_entropy(out, y1) + 0.5 * self.F.mse_loss(
            out.sum(-1), y2)


def test_two_labels_rebuild_the_step():
    jnet, tnet = _nets()
    import paddle_tpu.nn.functional as JF
    from paddle_tpu_torch.nn import functional as TF

    jm = jhapi.Model(jnet).prepare(
        paddle.optimizer.SGD(learning_rate=0.1, parameters=jnet.parameters()),
        _TwoLabelLoss(JF))
    tm = pt.Model(tnet).prepare(
        SGD(learning_rate=0.1, parameters=tnet.parameters(), device="cpu"),
        _TwoLabelLoss(TF))
    assert tm._train_step_labels == 1
    y2 = X[:8].sum(-1) / 4
    for _ in range(2):
        jl = jm.train_batch([X[:8]], [Y[:8], y2])
        tl = tm.train_batch([X[:8]], [Y[:8], y2])
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert tm._train_step_labels == 2
    want = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    for k, v in _port_params(tnet).items():
        np.testing.assert_allclose(v, want[k], rtol=RTOL, atol=ATOL)


def test_batches_from_a_threaded_loader_and_numpy_iterables():
    """A port DataLoader with worker threads and a plain iterable of
    NumPy batches train as the synchronous Dataset path does."""
    losses = []
    for data in ("dataset", "loader", "numpy"):
        _, tnet = _nets()
        m = pt.Model(tnet).prepare(
            SGD(learning_rate=0.1, parameters=tnet.parameters(),
                device="cpu"), tnn.CrossEntropyLoss())
        rec = _recorder(thapi.callbacks.Callback)
        src = {"dataset": _dataset(tio),
               "loader": tio.DataLoader(_dataset(tio), batch_size=8,
                                        num_workers=2, places="cpu"),
               "numpy": [(X[i:i + 8], Y[i:i + 8].astype(np.int32))
                         for i in range(0, 32, 8)]}[data]
        m.fit(src, batch_size=8, shuffle=False, verbose=0, callbacks=[rec])
        losses.append(rec.losses)
    assert losses[0] == losses[1] == losses[2]


def test_observability_and_visualdl_callbacks(tmp_path):
    steps = obs_metrics.counter("hapi.train_batches")
    seconds = obs_metrics.histogram("hapi.step_seconds")
    n0 = steps.value()
    c0 = (seconds.stats() or {"count": 0})["count"]
    _, tnet = _nets()
    m = pt.Model(tnet).prepare(
        SGD(learning_rate=0.1, parameters=tnet.parameters(), device="cpu"),
        tnn.CrossEntropyLoss())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        m.fit(_dataset(tio), batch_size=8, log_freq=2, callbacks=[
            thapi.callbacks.ObservabilityCallback(),
            thapi.callbacks.VisualDL(str(tmp_path / "vdl"))])
    assert steps.value() - n0 == 4
    assert seconds.stats()["count"] - c0 == 4
    lines = (tmp_path / "vdl" / "scalars.tsv").read_text().splitlines()
    assert [ln.split("\t")[2] for ln in lines] == ["lr"] * 4
    assert "Epoch 1/1" in out.getvalue() and "step 2/4" in out.getvalue()


def test_summary_and_flops_match_jax_for_resnet50():
    got = []

    def jax_counts():
        with contextlib.redirect_stdout(io.StringIO()):
            net = jresnet50()
            got.append((jhapi.summary(net), jhapi.flops(net, [1, 3, 64, 64])))
        return jnp.zeros(())

    jax.eval_shape(jax_counts)
    net = tresnet50(num_classes=1000, device="cpu")
    was = net.training
    with contextlib.redirect_stdout(io.StringIO()):
        mine = (pt.summary(net), pt.flops(net, [1, 3, 64, 64]))
    assert mine == got[0]
    assert mine[0]["total_params"] == 25557032
    assert net.training == was
    with contextlib.redirect_stdout(io.StringIO()):
        assert pt.Model(net).summary() == mine[0]
