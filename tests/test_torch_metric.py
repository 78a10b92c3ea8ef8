"""The port's ``metric`` (``Accuracy``, ``Precision``, ``Recall``) against
the JAX package's ``paddle.metric`` on numpy-seeded scores: top-1 and
top-5 hits of ``compute``, each batch's accuracy from ``update``, the
running ``accumulate`` over three batches, ``reset`` and ``name``; a
label with a trailing dim of 1.  Exact: the hits are counts."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import metric

from _torch_port_util import one_thread  # noqa: F401


@pytest.mark.parametrize("topk", [(1,), (1, 5), 3],
                         ids=["top1", "top1_top5", "top3_int"])
def test_accuracy_matches_jax(topk):
    jacc, tacc = paddle.metric.Accuracy(topk=topk), metric.Accuracy(topk=topk)
    assert tacc.name() == jacc.name()
    r = np.random.RandomState(0)
    for step in range(3):
        pred = r.randn(16, 10).astype(np.float32)
        label = r.randint(0, 10, (16, 1) if step == 1 else (16,))
        jc = jacc.compute(paddle.to_tensor(pred), paddle.to_tensor(label))
        tc = tacc.compute(torch.from_numpy(pred), torch.from_numpy(label))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc.numpy()))
        assert tacc.update(tc) == jacc.update(jc)
        assert tacc.accumulate() == jacc.accumulate()
    tacc.reset()
    jacc.reset()
    assert tacc.accumulate() == jacc.accumulate()


def test_accuracy_equals_a_direct_topk_count():
    r = np.random.RandomState(1)
    pred = torch.from_numpy(r.randn(64, 1000).astype(np.float32))
    label = torch.from_numpy(r.randint(0, 1000, (64,)))
    acc = metric.Accuracy(topk=(1, 5))
    acc.update(acc.compute(pred, label))
    top5 = pred.topk(5, dim=-1).indices
    want = [(top5[:, :k] == label[:, None]).any(-1).float().mean().item()
            for k in (1, 5)]
    assert acc.accumulate() == want


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall_match_jax(cls):
    jm, tm = getattr(paddle.metric, cls)(), getattr(metric, cls)()
    r = np.random.RandomState(2)
    for _ in range(3):
        preds = r.rand(32).astype(np.float32)
        labels = r.randint(0, 2, (32,))
        jm.update(preds, labels)
        tm.update(torch.from_numpy(preds), torch.from_numpy(labels))
    assert tm.accumulate() == jm.accumulate()
    assert tm.name() == jm.name()
