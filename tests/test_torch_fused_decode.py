"""The fused generation slice as a whole on the CPU: a tiny generator
(token embedding plus learned positions, or inline NeoX rotary instead
of positions -> ``fused_multi_transformer`` -> final LayerNorm -> the
tied head, ``chip_smoke.py``'s ``fused_decode`` at 2 layers, dim 64, 4
heads, FFN 128, a 48-token vocabulary) on the same seeded weights in the
JAX package and in the port (``convert.fused_multi_transformer_params_
from_jax``): a prefill of two 5-token prompts into ``max_seq`` 16
caches, then 8 greedy steps.

The greedy streams are equal; every step's last-position logits agree
within 2e-5 of their largest value (f32 on both sides, the same terms in
another order).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JIF
import paddle_tpu.nn.functional as JF

from paddle_tpu_torch.convert import (FUSED_MT_WEIGHTS,
                                      fused_multi_transformer_params_from_jax)
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.nn import functional as TF

from _torch_port_util import one_thread  # noqa: F401

L, DIM, HEADS, FFN, VOCAB, MAX_SEQ, STEPS = 2, 64, 4, 128, 48, 16, 8
HD = DIM // HEADS


def _weights(seed):
    """Layer weights N(0, 0.5) (norm scales 1 + N(0, 0.1)), embeddings
    N(0, 0.1), positions N(0, 0.5): a generator whose greedy streams
    wander (at smaller layer weights the tied head echoes one token)."""
    r = np.random.RandomState(seed)

    def mk(shape, std):
        return (r.randn(*shape) * std).astype(np.float32)

    shapes = dict(ln_scales=(DIM,), ln_biases=(DIM,),
                  qkv_weights=(3, HEADS, HD, DIM), qkv_biases=(3 * DIM,),
                  linear_weights=(DIM, DIM), linear_biases=(DIM,),
                  ffn_ln_scales=(DIM,), ffn_ln_biases=(DIM,),
                  ffn1_weights=(DIM, FFN), ffn1_biases=(FFN,),
                  ffn2_weights=(FFN, DIM), ffn2_biases=(DIM,))
    layers = {k: [mk(shapes[k], 0.1) + 1 if k.endswith("scales") else
                  mk(shapes[k], 0.5) for _ in range(L)]
              for k in FUSED_MT_WEIGHTS}
    return dict(layers=layers, embed=mk((VOCAB, DIM), 0.1),
                pos=mk((MAX_SEQ, DIM), 0.5), lnf_w=mk((DIM,), 0.1) + 1,
                lnf_b=mk((DIM,), 0.1))


def _rotary():
    inv = 1.0 / (10000.0 ** (np.arange(0, HD, 2, np.float32) / HD))
    ang = np.outer(np.arange(MAX_SEQ, dtype=np.float32), inv)
    ang = np.concatenate([ang, ang], -1)                 # NeoX halves
    tab = np.stack([np.cos(ang), np.sin(ang)])[:, None, None]
    return np.ascontiguousarray(np.broadcast_to(
        tab, (2, 2, 1, MAX_SEQ, HD)).astype(np.float32))


class _Jax:
    def __init__(self, w, rotary):
        self.w = w
        self.p = {k: [paddle.to_tensor(a) for a in v]
                  for k, v in w["layers"].items()}
        self.kw = {} if rotary is None else dict(
            rotary_embs=paddle.to_tensor(rotary), rotary_emb_dims=1,
            use_neox_rotary_style=True)
        self.caches = [paddle.to_tensor(np.zeros(
            (2, 2, HEADS, MAX_SEQ, HD), np.float32)) for _ in range(L)]

    def logits(self, ids, start):
        x = self.w["embed"][ids]
        if not self.kw:
            x = x + self.w["pos"][start:start + ids.shape[1]]
        kw = dict(self.kw)
        if start:
            kw["time_step"] = paddle.to_tensor(np.asarray(start, np.int32))
        h, self.caches = JIF.fused_multi_transformer(
            paddle.to_tensor(x), cache_kvs=self.caches, **self.p, **kw)
        h = JF.layer_norm(h, [DIM], paddle.to_tensor(self.w["lnf_w"]),
                          paddle.to_tensor(self.w["lnf_b"]))
        return np.asarray(h.numpy())[:, -1] @ self.w["embed"].T


class _Port:
    def __init__(self, w, rotary):
        self.p = fused_multi_transformer_params_from_jax(w["layers"],
                                                         device="cpu")
        self.embed, self.pos, self.lnf_w, self.lnf_b = (
            torch.from_numpy(w[k]) for k in ("embed", "pos", "lnf_w",
                                             "lnf_b"))
        self.kw = {} if rotary is None else dict(
            rotary_embs=torch.from_numpy(rotary), rotary_emb_dims=1,
            use_neox_rotary_style=True)
        self.caches = [torch.zeros(2, 2, HEADS, MAX_SEQ, HD)
                       for _ in range(L)]

    @torch.no_grad()
    def logits(self, ids, start):
        ids = torch.from_numpy(ids)
        x = self.embed[ids]
        if not self.kw:
            x = x + self.pos[start:start + ids.shape[1]]
        kw = dict(self.kw)
        if start:
            kw["time_step"] = torch.tensor(start)
        h, self.caches = TIF.fused_multi_transformer(
            x, cache_kvs=self.caches, **self.p, **kw)
        h = TF.layer_norm(h, [DIM], self.lnf_w, self.lnf_b)
        return (h[:, -1] @ self.embed.T).numpy()


@pytest.mark.parametrize("rotary", [False, True],
                         ids=["learned_positions", "neox_rotary"])
def test_greedy_generation_matches_jax(rotary):
    w = _weights(3)
    rot = _rotary() if rotary else None
    jm, tm = _Jax(w, rot), _Port(w, rot)
    prompt = np.random.RandomState(1).randint(0, VOCAB, (2, 5))
    streams = {"jax": [], "port": []}
    for name, m in (("jax", jm), ("port", tm)):
        ids, start = prompt, 0
        for _ in range(STEPS + 1):
            logits = m.logits(ids, start)
            streams[name].append(logits)
            start += ids.shape[1]
            ids = logits.argmax(-1)[:, None].astype(np.int64)
    for want, got in zip(streams["jax"], streams["port"]):
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
    toks = np.stack([s.argmax(-1) for s in streams["port"]], 1)
    assert all(len(set(row.tolist())) > 2 for row in toks)   # streams move
