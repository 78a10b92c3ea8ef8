"""The port's ``inference`` Predictor and ``onnx.export`` on the CPU,
against the JAX package's on the same weights and NumPy inputs: the
cases of ``tests/test_jit_io_amp.py``'s ``TestInferencePredictor`` and
``TestOnnxExportAdapter``, a 2-layer BERT (hidden 64) through
``jit.save`` -> ``create_predictor`` against JAX's predictor, and a
``.pdiparams`` that the JAX package wrote, served through the port's
``.pdmodel`` (``Config(params_path=)``).  The predictors run on the CPU
(``Config.disable_gpu()``; the card is the default).

Tolerances: the same f32 functions in another summation order, 1e-5
relative and 1e-6 absolute (BERT's logits to 1e-5 of their largest
magnitude).
"""

import shutil
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.inference as jinf
import paddle_tpu_torch as tp
import paddle_tpu_torch.inference as tinf
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForMaskedLM as JBertForMaskedLM
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import state_from_jax
from paddle_tpu_torch.models import BertConfig, BertForMaskedLM

from _torch_jax_table import numpy_init
from _torch_port_util import one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    """The CPU as the current device for each test, in a fresh slot that
    the teardown swaps back (the suite's processes run many files)."""
    monkeypatch.setattr(tdevice, "_CURRENT", [None])
    tp.set_device("cpu")


def _cfg(prefix, params=None):
    cfg = tinf.Config(prefix + ".pdmodel", params or prefix + ".pdiparams")
    cfg.disable_gpu()
    return cfg


def _pair(build, seed):
    """The JAX layer from ``paddle.seed(seed)`` and the port's on its
    weights, both in eval mode."""
    jp.seed(seed)
    jm = build(jp)
    jm.eval()
    tm = build(tp)
    tm.load_state_dict({k: torch.tensor(np.asarray(v.numpy()))
                        for k, v in jm.state_dict().items()})
    return jm, tm.eval()


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                           P.nn.Linear(16, 3))


def test_handle_workflow_matches_jax(tmp_path):
    """Input names from the spec, output handles wired before the first
    run and refreshed in place by the next, the legacy list mode."""
    jm, tm = _pair(_mlp, 0)
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    jp.jit.save(jm, str(tmp_path / "j"), input_spec=[
        jp.static.InputSpec([4, 8], "float32", "feats")])
    tp.jit.save(tm, str(tmp_path / "t"), input_spec=[
        tp.jit.InputSpec([4, 8], "float32", "feats")])
    jpred = jinf.create_predictor(jinf.Config(str(tmp_path / "j.pdmodel"),
                                              str(tmp_path / "j.pdiparams")))
    pred = tinf.create_predictor(_cfg(str(tmp_path / "t")))
    assert pred.get_input_names() == jpred.get_input_names() == ["feats"]
    assert pred.get_output_names() == jpred.get_output_names()
    out_h = pred.get_output_handle(pred.get_output_names()[0])
    for scale in (1.0, 2.0):
        for p in (pred, jpred):
            p.get_input_handle("feats").copy_from_cpu(x * scale)
            p.run()
        np.testing.assert_allclose(
            out_h.copy_to_cpu(),
            jpred.get_output_handle(jpred.get_output_names()[0])
            .copy_to_cpu(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pred.run([x])[0], jpred.run([x])[0],
                               rtol=1e-5, atol=1e-6)


def test_missing_input_params_path_and_duplicate_names(tmp_path):
    model = tp.nn.Linear(4, 2)
    prefix = str(tmp_path / "m")
    tp.jit.save(model, prefix, input_spec=[tp.jit.InputSpec([2, 4])])
    pred = tinf.create_predictor(_cfg(prefix))
    with pytest.raises(RuntimeError, match="inputs not set"):
        pred.run()
    with pytest.raises(KeyError):
        pred.get_input_handle("nope")
    (tmp_path / "weights").mkdir()
    alt = str(tmp_path / "weights" / "final.pdiparams")
    shutil.move(prefix + ".pdiparams", alt)
    out = tinf.create_predictor(_cfg(prefix, alt)).run(
        [np.zeros((2, 4), np.float32)])
    assert out[0].shape == (2, 2)
    with pytest.raises(ValueError, match="unique"):
        tp.jit.save(model, str(tmp_path / "m4"),
                    input_spec=[tp.jit.InputSpec([2, 4], "float32", "x"),
                                tp.jit.InputSpec([2, 4], "float32", "x")])


def test_onnx_export_serves_any_batch_as_jax(tmp_path):
    import paddle_tpu.onnx as jonnx
    import paddle_tpu_torch.onnx as tonnx

    def net(P):
        return P.nn.Sequential(P.nn.Linear(4, 8), P.nn.ReLU(),
                               P.nn.Linear(8, 2))

    jm, tm = _pair(net, 0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jpath = jonnx.export(jm, str(tmp_path / "j.onnx"), input_spec=[
            jp.static.InputSpec([None, 4], "float32")])
        tpath = tonnx.export(tm, str(tmp_path / "t.onnx"), input_spec=[
            tp.jit.InputSpec([None, 4], "float32")])
        assert any("torch.export" in str(x.message) for x in w)
    assert tpath == str(tmp_path / "t")
    jpred = jinf.create_predictor(jinf.Config(jpath))
    pred = tinf.create_predictor(_cfg(tpath))
    for bs in (1, 3, 7):
        x = np.random.RandomState(bs).randn(bs, 4).astype(np.float32)
        got = pred.run([x])[0]
        assert got.shape == (bs, 2)
        np.testing.assert_allclose(got, jpred.run([x])[0], rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="input_spec"):
        tonnx.export(tp.nn.Linear(2, 2), str(tmp_path / "m"))


def test_polymorphic_shared_batch_of_two_inputs_as_jax(tmp_path):
    """Two inputs whose batch axes must be equal (a + b): the
    independent dims cannot be related, and the export tries again with
    one dim per axis index."""
    def two(P):
        class TwoIn(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = P.nn.Linear(4, 2)

            def forward(self, a, b):
                return self.fc(a + b)
        return TwoIn()

    jm, tm = _pair(two, 2)
    for P, m, d in ((jp, jm, "j"), (tp, tm, "t")):
        P.jit.save(m, str(tmp_path / d), input_spec=[
            P.jit.InputSpec([None, 4], "float32"),
            P.jit.InputSpec([None, 4], "float32")])
    jl = jp.jit.load(str(tmp_path / "j"))
    tl = tp.jit.load(str(tmp_path / "t"), device="cpu")
    for bs in (2, 6):
        a = np.random.RandomState(bs).randn(bs, 4).astype(np.float32)
        np.testing.assert_allclose(
            tl(torch.tensor(a), torch.tensor(a)).numpy(),
            jl(jp.to_tensor(a), jp.to_tensor(a)).numpy(), rtol=1e-5,
            atol=1e-6)


BERT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def test_bert_predictor_and_jax_params_through_the_port_program(tmp_path):
    """A 2-layer BERT: the port's predictor (batch axis dynamic) against
    JAX's (batch 2: JAX cannot make this model's batch symbolic), then
    the port's program over the ``.pdiparams`` the JAX package wrote.
    A JAX ``.pdmodel`` is refused with a message naming the format."""
    with numpy_init(21):        # JAX's initializers drawing from NumPy
        jm = JBertForMaskedLM(JBertConfig(**BERT))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = BertForMaskedLM(BertConfig(**BERT), device="cpu", seed=5).eval()
    jp.jit.save(jm, str(tmp_path / "j"), input_spec=[
        jp.jit.InputSpec([2, 16], "int64", "input_ids")])
    tp.jit.save(tm, str(tmp_path / "t"), input_spec=[
        tp.jit.InputSpec([None, 16], "int64", "input_ids")])
    ids = np.random.RandomState(0).randint(0, 128, (2, 16)).astype(np.int32)
    want = jinf.create_predictor(jinf.Config(str(tmp_path / "j"))).run(
        [ids])[0]
    # the port's program (its own random weights saved beside it) over
    # the JAX package's .pdiparams
    pred = tinf.create_predictor(_cfg(str(tmp_path / "t"),
                                      str(tmp_path / "j.pdiparams")))
    h = pred.get_input_handle("input_ids")
    h.copy_from_cpu(ids)
    pred.run()
    got = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    tm.load_state_dict(state_from_jax(state, tm, device="cpu"))
    jfwd = jp.jit.to_static(jm.forward)     # one program per batch size
    for b in (1, 3):
        x = np.random.RandomState(b).randint(0, 128, (b, 16)).astype(
            np.int32)
        out = pred.run([x])[0]
        ref = jfwd(jp.to_tensor(x)).numpy()
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError, match="StableHLO"):
        tp.jit.load(str(tmp_path / "j"), device="cpu")
