"""The port's ``jit`` (``to_static``, ``save``/``load``, ``TrainStep.many``)
and its kernels as ``torch.library`` custom ops, on the CPU, against the
JAX package on the same NumPy inputs and weights: the cases of
``tests/test_jit_io_amp.py``'s ``TestToStatic``,
``TestToStaticParamMutation``, ``TestManyRngDelta`` and
``TestSaveEarlyExit``, a 2-layer BERT at hidden 64 (``to_static`` against
JAX's, ``jit.save`` -> ``jit.load`` against JAX's forward), and
``torch.library.opcheck`` of every registered op.  On the CPU ``to_static`` captures with
``torch.compile``'s ``aot_eager`` backend (the card's is Inductor) and
the ops run their plain twins.

Tolerances: the same f32 functions in another summation order, outputs to
1e-5 relative and 1e-6 absolute (a BERT's logits to 1e-5 of their largest
magnitude); RNG-free ``many`` bit for bit.
"""


import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForMaskedLM as JBertForMaskedLM
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import state_from_jax
from paddle_tpu_torch.models import BertConfig, BertForMaskedLM
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.ops import _library

from _torch_jax_table import numpy_init
from _torch_port_util import one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    """The CPU as the current device for each test, in a fresh slot that
    the teardown swaps back (the suite's processes run many files)."""
    monkeypatch.setattr(tdevice, "_CURRENT", [None])
    tp.set_device("cpu")


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _load_jax(tl, jl):
    """The port layer ``tl`` on the JAX layer ``jl``'s state."""
    tl.load_state_dict({k: torch.tensor(np.asarray(v.numpy()))
                        for k, v in jl.state_dict().items()})
    return tl


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(4, 8), P.nn.ReLU(), P.nn.Linear(8, 2))


# ------------------------------------------------------------- custom ops
def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g)

    ops = _library.ops()
    q, k, v = r(2, 5, 4, 8), r(2, 7, 2, 8), r(2, 7, 2, 8)
    _, lse = ops["flash_fwd"](q, k, v, 0.3, False)
    x, w, b = r(3, 4, 16), r(16), r(16)
    xg, wg, bg = r(2, 8, 3, 3), r(8), r(8)
    st = ops["layer_norm_fwd"](x, w, b, 1e-5)[1]
    sg = ops["group_norm_fwd"](xg, wg, bg, 4, 1e-5)[1]
    rs = ops["rms_norm_fwd"](x, w, 1e-6)[1]
    dq = (q, k, v, r(2, 5, 4, 8), lse, r(2, 4, 5), 0.3, True)

    def grad(*ts):
        return tuple(t.clone().requires_grad_(True) for t in ts)

    return {
        "flash_fwd": grad(q, k, v) + (0.3, True),
        "flash_bwd_dq": dq, "flash_bwd_dkv": dq,
        "layer_norm_fwd": grad(x, w, b) + (1e-5,),
        "layer_norm_bwd": (x, w, st[0], st[1], r(3, 4, 16)),
        "group_norm_fwd": grad(xg, wg, bg) + (4, 1e-5),
        "group_norm_bwd": (xg, wg, sg[0], sg[1], r(2, 8, 3, 3), 4),
        "rms_norm_fwd": grad(x, w) + (1e-6,),
        "rms_norm_bwd": (x, w, rs, r(3, 4, 16)),
    }


@pytest.mark.parametrize("name", _library.OP_NAMES)
def test_every_kernel_op_passes_opcheck(name):
    """Schema, fake implementation (shapes, dtypes and strides of the
    plain twins), autograd registration and AOTAutograd dispatch."""
    torch.library.opcheck(_library.ops()[name], _op_cases()[name])


def test_ops_raise_off_cpu_and_cuda_and_capture_as_one_node():
    """A meta tensor raises as any unsupported device; a captured
    program holds each op as one node, forward and backward."""
    from paddle_tpu_torch.ops.layer_norm import layer_norm

    x, w, b = (torch.tensor(_r(*s, seed=i)) for i, s in
               enumerate(((4, 8), (8,), (8,))))
    with pytest.raises(ValueError, match="unsupported device"):
        layer_norm(x.to("meta"), w.to("meta"), b.to("meta"))
    graphs = []

    def backend(gm, example):
        graphs.append(gm)
        return gm

    def f(x, w, b):
        return layer_norm(x, w, b).sum()

    xr = x.clone().requires_grad_(True)
    torch.compile(f, backend=torch._dynamo.backends.common.aot_autograd(
        fw_compiler=backend, bw_compiler=backend), fullgraph=True)(
        xr, w, b).backward()
    targets = [str(n.target) for g in graphs for n in g.graph.nodes]
    assert "paddle_tpu_torch.layer_norm_fwd.default" in targets
    assert "paddle_tpu_torch.layer_norm_bwd.default" in targets
    assert xr.grad is not None


# -------------------------------------------------------------- to_static
def test_eager_static_parity_and_cache_by_shape():
    def fn(P):
        return lambda x, y: P.tanh(x) @ y + x.sum()

    a, b = _r(4, 4, seed=1), _r(4, 4, seed=2)
    want = jp.jit.to_static(fn(jp))(jp.to_tensor(a), jp.to_tensor(b))
    sf = tp.jit.to_static(fn(tp))
    name = sf.__name__
    compiles = tmetrics.value("jit.compile_count", fn=name) or 0
    hits = tmetrics.value("jit.cache_hit", fn=name) or 0
    got = sf(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    sf(torch.tensor(a), torch.tensor(b))
    assert len(sf.program_cache) == 1
    assert tmetrics.value("jit.compile_count", fn=name) == compiles + 1
    assert tmetrics.value("jit.cache_hit", fn=name) == hits + 1
    sf(torch.ones(2, 4), torch.ones(4, 4))
    assert len(sf.program_cache) == 2


def test_layer_to_static_updates_buffers_as_jax():
    x = _r(8, 4, seed=3) * 3 + 1
    jbn = jp.jit.to_static(jp.nn.BatchNorm1D(4))
    tbn = tp.jit.to_static(tp.nn.BatchNorm1D(4))
    for _ in range(2):
        np.testing.assert_allclose(tbn(torch.tensor(x)).detach().numpy(),
                                   jbn(jp.to_tensor(x)).numpy(), rtol=1e-5,
                                   atol=1e-6)
    for k in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(tbn, k).numpy(),
                                   getattr(jbn, k).numpy(), rtol=1e-6)
    assert abs(float(tbn._mean.mean())) > 1e-4


def test_randomness_varies_across_calls_and_follows_the_stream():
    drop = tp.jit.to_static(tp.nn.Dropout(0.5))
    x = torch.ones(100)
    tp.seed(4)
    a, b = drop(x), drop(x)
    assert not torch.equal(a, b)
    assert 20 < int((a == 0).sum()) < 80
    tp.seed(4)
    assert torch.equal(drop(x), a)           # the stream's keys decide


def test_alternating_state_signatures_keep_their_own_captures():
    """A forward that branches on a parameter's dtype: calls that
    alternate between the dtypes each get their own capture's output
    structure back."""
    class DtypeDependent(tp.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = tp.nn.Linear(4, 4)

        def forward(self, x):
            y = self.lin(x)
            if str(self.lin.weight.dtype) == "torch.float32":
                return y
            return {"out": y, "casted": True}

    layer = tp.jit.to_static(DtypeDependent())
    x = torch.ones(2, 4)
    lin = layer.lin
    w32, b32 = lin.weight.data, lin.bias.data
    first = layer(x)
    assert isinstance(first, torch.Tensor)
    lin.weight.data, lin.bias.data = (t.to(torch.bfloat16) for t in (w32,
                                                                     b32))
    assert layer(x.to(torch.bfloat16))["casted"] is True
    lin.weight.data, lin.bias.data = w32, b32
    assert torch.equal(layer(x), first)


def test_check_raises_naming_the_analysis_item():
    with pytest.raises(NotImplementedError, match="analysis"):
        tp.jit.to_static(lambda x: x, check=True)


class _Ema:
    @staticmethod
    def build(P):
        class Ema(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.lin = P.nn.Linear(4, 4)
                self.ema = self.create_parameter(
                    [4, 4], default_initializer=P.nn.initializer.Constant(
                        0.0))

            def forward(self, x):
                if P is jp:
                    self.ema.set_value(self.ema * 0.5 + self.lin.weight * 0.5)
                else:
                    with torch.no_grad():
                        self.ema.copy_(self.ema * 0.5 + self.lin.weight * 0.5)
                return self.lin(x).sum()
        return Ema()


def test_param_mutation_survives_the_grad_path_as_jax():
    jp.seed(0)
    jm = _Ema.build(jp)
    tm = _load_jax(_Ema.build(tp), jm)
    js, ts = jp.jit.to_static(jm), tp.jit.to_static(tm)
    x = _r(2, 4, seed=5)
    for _ in range(2):
        jl, tl = js(jp.to_tensor(x)), ts(torch.tensor(x))
        np.testing.assert_allclose(tm.ema.detach().numpy(), jm.ema.numpy(),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    tl.backward()
    assert tm.lin.weight.grad is not None


def test_untouched_params_not_churned():
    lin = tp.nn.Linear(4, 2)
    tp.jit.to_static(lin)
    w, ptr = lin.weight, lin.weight.data_ptr()
    lin(torch.randn(3, 4))
    assert lin.weight is w and lin.weight.data_ptr() == ptr


def test_to_static_model_trains_with_eager_backward_as_jax():
    """Five SGD steps through a to_static forward and eager backward:
    the same weights as JAX's to_static training; gradients reach the
    inputs too."""
    X = np.random.RandomState(0).rand(32, 4).astype(np.float32)
    Y = X.sum(-1, keepdims=True)
    jp.seed(7)
    jm = jp.nn.Linear(4, 1)
    tm = _load_jax(tp.nn.Linear(4, 1), jm)
    jo = jp.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters())
    to = tp.optimizer.SGD(learning_rate=0.1, parameters=tm.parameters(),
                          device="cpu")
    jp.jit.to_static(jm)
    tp.jit.to_static(tm)
    for _ in range(5):
        jl = jp.nn.functional.mse_loss(jm(jp.to_tensor(X)), jp.to_tensor(Y))
        jl.backward()
        jo.step()
        jo.clear_grad()
        tl = tp.nn.functional.mse_loss(tm(torch.tensor(X)), torch.tensor(Y))
        tl.backward()
        to.step()
        to.clear_grad()
    np.testing.assert_allclose(tm.weight.detach().numpy(), jm.weight.numpy(),
                               rtol=1e-5, atol=1e-6)
    x = torch.tensor(X, requires_grad=True)
    tm(x).sum().backward()
    assert x.grad is not None and tuple(x.grad.shape) == (32, 4)


def test_optimizer_over_a_param_subset_trains():
    class TwoPart(tp.nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = tp.nn.Linear(4, 4)
            self.b = tp.nn.Linear(4, 1)

        def forward(self, x):
            return self.b(self.a(x))

    m = TwoPart()
    opt = tp.optimizer.Adam(learning_rate=0.01, parameters=m.b.parameters(),
                            device="cpu")
    step = tp.jit.TrainStep(m, lambda n, x, y: ((n(x) - y) ** 2).mean(),
                            opt, device="cpu")
    x, y = torch.randn(8, 4), torch.randn(8, 1)
    assert all(np.isfinite([float(step(x, y)), float(step(x, y))]))


# -------------------------------------------------------------- many
def _many_model(dropout):
    tp.seed(123)
    layers = [tp.nn.Linear(8, 32)]
    if dropout:
        layers.append(tp.nn.Dropout(0.5))
    layers += [tp.nn.ReLU(), tp.nn.Linear(32, 1)]
    m = tp.nn.Sequential(*layers)
    m.train()
    o = tp.optimizer.SGD(learning_rate=0.05, parameters=m.parameters(),
                         device="cpu")
    return m, tp.jit.TrainStep(
        m, lambda n, x, y: tp.nn.functional.mse_loss(n(x), y), o,
        device="cpu")


def test_many_equals_sequential_steps_bitwise_and_draws_per_step():
    """RNG-free: K steps of many() equal K sequential calls bit for bit
    (losses, parameters, step count).  With dropout every step draws its
    own mask (the losses differ, all finite)."""
    rng = np.random.RandomState(3)
    batches = [(torch.tensor(rng.rand(64, 8).astype(np.float32)),
                torch.tensor(rng.rand(64, 1).astype(np.float32)))
               for _ in range(4)]
    m1, s1 = _many_model(False)
    seq = torch.stack([s1(*b) for b in batches])
    m2, s2 = _many_model(False)
    many = s2.many(batches)
    assert torch.equal(many, seq)
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    assert s2.optimizer._step_count == 4
    _, s3 = _many_model(True)
    drop = s3.many([batches[0]] * 4)
    assert torch.isfinite(drop).all() and len(set(drop.tolist())) == 4
    with pytest.raises(ValueError, match="equal-shape"):
        s3.many([batches[0], (batches[0][0][:3], batches[0][1][:3])])


def test_scaler_state_keeps_its_storage_and_reads_as_jax():
    """The scale and the counters are written in place by every setter
    (a captured pack reads the addresses it recorded), and
    ``get_loss_scaling`` is a value that later steps leave as it is, as
    JAX's array: the same values as JAX's scaler after each call."""
    js = jp.amp.GradScaler(init_loss_scaling=2.0 ** 10)
    ts = tp.amp.GradScaler(init_loss_scaling=2.0 ** 10, device="cpu")
    ptrs = [t.data_ptr() for t in (ts._scale, ts._good_steps,
                                   ts._bad_steps)]
    jseen, tseen = js.get_loss_scaling(), ts.get_loss_scaling()
    for s in (js, ts):
        s.set_init_loss_scaling(2.0 ** 5)
    assert float(jseen) == tseen.item() == 2.0 ** 10
    for s in (js, ts):
        s.load_state_dict(dict(s.state_dict(), scale=2.0 ** 7, incr_count=3,
                               decr_count=1))
    assert [t.data_ptr() for t in (ts._scale, ts._good_steps,
                                   ts._bad_steps)] == ptrs
    assert ts.state_dict() == {k: (float(v) if k == "scale" else v)
                               for k, v in js.state_dict().items()}
    assert ts.get_loss_scaling().item() == float(js.get_loss_scaling())


# ------------------------------------------------------------ save / load
def test_jit_save_load_roundtrip_matches_jax(tmp_path):
    jp.seed(1)
    jm = _mlp(jp)
    jm.eval()
    tm = _load_jax(_mlp(tp), jm).eval()
    spec = [(jp, jp.jit.InputSpec([None, 4])), (tp, tp.jit.InputSpec(
        [None, 4]))]
    for (P, sp), m, d in zip(spec, (jm, tm), ("jax", "port")):
        P.jit.save(m, str(tmp_path / d), input_spec=[sp])
    jl = jp.jit.load(str(tmp_path / "jax"))
    tl = tp.jit.load(str(tmp_path / "port"), device="cpu")
    for bs in (1, 3):
        x = _r(bs, 4, seed=bs)
        np.testing.assert_allclose(tl(torch.tensor(x)).numpy(),
                                   jl(jp.to_tensor(x)).numpy(), rtol=1e-5,
                                   atol=1e-6)


class _Dec:
    @staticmethod
    def build(P):
        class Dec(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.lin = P.nn.Linear(4, 4)

            def forward(self, h):
                n = 0
                while n < 8:
                    h = self.lin(h)
                    if P.max(P.abs(h)) < 0.05:
                        return h * 0.0
                    n = n + 1
                return h
        return Dec()


def test_save_load_early_exit_decode_as_jax(tmp_path):
    """The dy2static-converted forward is what jit.save exports: one
    program serves both exits of a decode with a data-dependent early
    return (h shrinks 10x a step: from 1 it returns at the second step,
    from 1e8 it runs out), equal to the eager forward and to JAX's loaded
    program; the export's forward is removed from the instance
    afterwards."""
    jp.seed(0)
    jm = _Dec.build(jp)
    jm.eval()
    w = np.eye(4, dtype=np.float32) * 0.1
    jm.lin.weight.set_value(jp.to_tensor(w))
    tm = _load_jax(_Dec.build(tp), jm).eval()
    jp.jit.save(jm, str(tmp_path / "j"),
                input_spec=[jp.jit.InputSpec([1, 4])])
    tp.jit.save(tm, str(tmp_path / "t"),
                input_spec=[tp.jit.InputSpec([1, 4])])
    assert "forward" not in tm.__dict__
    jl = jp.jit.load(str(tmp_path / "j"))
    tl = tp.jit.load(str(tmp_path / "t"), device="cpu")
    for start in (1.0, 1e8):
        x = np.full((1, 4), start, np.float32)
        got = tl(torch.tensor(x))
        np.testing.assert_allclose(got.numpy(), jl(jp.to_tensor(x)).numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(got.numpy(),
                                   tm(torch.tensor(x)).detach().numpy())
    assert not got.abs().sum() == 0          # the second ran out


def test_save_restores_instance_forward(tmp_path):
    import types

    lin = tp.nn.Linear(4, 2).eval()

    def custom_fwd(self, x):
        return type(lin).forward(self, x) + 1.0

    inst = types.MethodType(custom_fwd, lin)
    object.__setattr__(lin, "forward", inst)
    x = torch.randn(3, 4)
    before = lin(x)
    tp.jit.save(lin, str(tmp_path / "m"),
                input_spec=[tp.jit.InputSpec([3, 4])])
    assert lin.__dict__.get("forward") is inst
    assert torch.equal(lin(x), before)
    out = tp.jit.load(str(tmp_path / "m"), device="cpu")(x)
    torch.testing.assert_close(out, before)


# ------------------------------------------------------------------ BERT
BERT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def bert_pair():
    with numpy_init(21):        # JAX's initializers drawing from NumPy
        jm = JBertForMaskedLM(JBertConfig(**BERT))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = BertForMaskedLM(BertConfig(**BERT), device="cpu")
    tm.load_state_dict(state_from_jax(state, tm, device="cpu"))
    return jm, tm.eval()


def _ids(b, s=16, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (b, s)).astype(
        np.int32)


def _close_logits(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_bert_to_static_and_save_match_jax(bert_pair, tmp_path):
    """A 2-layer BERT (hidden 64) on JAX's weights: the to_static
    forward against JAX's to_static, and the program jit.save wrote
    (batch axis dynamic) against JAX's to_static forward at batches 1
    and 3 (the predictors of both packages:
    tests/test_torch_inference.py)."""
    jm, tm = bert_pair
    ids = _ids(2)
    jfwd = jp.jit.to_static(jm.forward)     # one program per batch size
    want = jfwd(jp.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = tp.jit.to_static(tm.forward)(torch.tensor(ids))
    _close_logits(got.numpy(), want)
    tp.jit.save(tm, str(tmp_path / "tb"), input_spec=[
        tp.jit.InputSpec([None, 16], "int64", "input_ids")])
    tl = tp.jit.load(str(tmp_path / "tb"), device="cpu")
    for b in (1, 3):
        x = _ids(b, seed=b)
        _close_logits(tl(torch.tensor(x)).numpy(),
                      jfwd(jp.to_tensor(x)).numpy())
