"""Dropout in the port (``nn.functional.dropout``, ``nn.Dropout`` and the
attention dropout of ``scaled_dot_product_attention``), held to its
properties: JAX draws its masks with threefry bits, the port from torch
generators seeded by the counter stream (``paddle_tpu_torch.random``),
so masks cannot be compared with JAX's.  Checked: the keep rate within
binomial bounds (6 standard deviations), the ``1/(1-p)`` scale of
``upscale_in_train`` and ``downscale_in_infer``'s ``1-p`` in eval,
``axis`` sharing the mask along the other dims, one key a training call
and none at p = 0 or in eval, the same seed giving the same mask, the
backward through the forward's mask, and attention dropout's mean over
draws against ``_sdpa_ref`` without dropout.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.nn.functional.attention import _sdpa_ref
from paddle_tpu_torch import random as prandom
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn import functional as F

from _torch_port_util import one_thread  # noqa: F401


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_rate_within_binomial_bounds(p):
    prandom.seed(1)
    x = torch.ones(256, 512)
    kept = (F.dropout(x, p) != 0).sum().item()
    n = x.numel()
    mean, std = n * (1 - p), np.sqrt(n * p * (1 - p))
    assert abs(kept - mean) <= 6 * std


def test_upscale_and_downscale_modes():
    prandom.seed(2)
    x = torch.randn(64, 33)
    y = F.dropout(x, 0.3)
    keep = y != 0
    torch.testing.assert_close(y[keep], (x / 0.7)[keep], rtol=0, atol=0)
    assert torch.equal(F.dropout(x, 0.3, training=False), x)
    assert torch.equal(Dropout(0.3).eval()(x), x)
    y = F.dropout(x, 0.3, mode="downscale_in_infer")
    keep = y != 0
    assert torch.equal(y[keep], x[keep])
    torch.testing.assert_close(
        F.dropout(x, 0.3, training=False, mode="downscale_in_infer"),
        x * 0.7, rtol=0, atol=0)
    bf = x.to(torch.bfloat16)
    assert F.dropout(bf, 0.3).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, 0.3, mode="nope")


@pytest.mark.parametrize("axis", [1, [0, 2], -1], ids=["1", "0_2", "-1"])
def test_axis_shares_the_mask(axis):
    prandom.seed(3)
    x = torch.ones(6, 7, 8)
    keep = F.dropout(x, 0.5, axis=axis) != 0
    axes = [axis] if isinstance(axis, int) else axis
    axes = [a % 3 for a in axes]
    for d in range(3):
        if d not in axes:         # constant along every shared dim
            first = keep.narrow(d, 0, 1)
            assert torch.equal(keep, first.expand_as(keep))
    assert 0 < keep.float().mean() < 1


def test_keys_and_same_seed_same_mask():
    x = torch.randn(32, 32)
    prandom.seed(4)
    a = F.dropout(x, 0.5)
    assert prandom.get_rng_state() == (4, 1)
    F.dropout(x, 0.0)
    F.dropout(x, 0.5, training=False)
    assert prandom.get_rng_state() == (4, 1)      # no key taken
    b = F.dropout(x, 0.5)
    prandom.seed(4)
    assert torch.equal(F.dropout(x, 0.5), a)
    assert not torch.equal(a, b)
    state = prandom.get_rng_state()
    c = F.dropout(x, 0.5)
    prandom.set_rng_state(state)
    assert torch.equal(F.dropout(x, 0.5), c)
    with prandom.fork_rng(4):
        assert torch.equal(F.dropout(x, 0.5), a)
    assert prandom.get_rng_state() == (4, 2)      # the fork left it alone


def test_backward_passes_through_the_forward_mask():
    prandom.seed(5)
    x = torch.randn(40, 50, requires_grad=True)
    y = F.dropout(x, 0.25)
    g = torch.randn(40, 50)
    y.backward(g)
    keep = y.detach() != 0
    torch.testing.assert_close(x.grad, torch.where(keep, g / 0.75, 0.0),
                               rtol=0, atol=0)


def test_attention_dropout_mean_matches_sdpa_ref():
    """Over 64 draws the dropped attention's mean stays within 6 standard
    deviations of ``_sdpa_ref`` without dropout, elementwise (the
    variance of one draw is ``p/(1-p) * sum_t P_t^2 v_t^2``); each draw
    takes one key, and the same key gives the same output."""
    r = np.random.RandomState(6)
    q, k, v = (r.randn(1, 12, 2, 8).astype(np.float32) for _ in range(3))
    p, n = 0.1, 64
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    prandom.seed(7)
    outs = torch.stack([F.scaled_dot_product_attention(tq, tk, tv,
                                                       dropout_p=p)
                        for _ in range(n)])
    assert prandom.get_rng_state() == (7, n)
    ref = np.array(_sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v)))
    probs = torch.softmax(torch.einsum("bshd,bthd->bhst", tq, tk)
                          / np.sqrt(8), -1)
    var = p / (1 - p) * torch.einsum("bhst,bthd->bshd", probs.square(),
                                     tv.square())
    err = (outs.mean(0) - torch.from_numpy(ref)).abs()
    assert (err <= 6 * (var / n).sqrt() + 1e-6).all()
    prandom.seed(7)
    again = F.scaled_dot_product_attention(tq, tk, tv, dropout_p=p)
    assert torch.equal(again, outs[0])
    assert not torch.equal(outs[0], outs[1])
