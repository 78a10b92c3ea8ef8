"""The port's recurrent layers, ``gather_tree`` and beam search against the
JAX package's on the CPU, on the same weights.

Each layer case holds the output and final states, and the gradient of
every input, initial state and parameter under a seeded cotangent of
the output, to 1e-5 of the reference's largest magnitude: the cells,
``RNN``/``BiRNN`` over cells, and ``SimpleRNN``/``LSTM``/``GRU`` at 2
layers in both directions, both time layouts, with and without initial
states, each through both of the port's routes (``torch._VF``, which is
cuDNN's on the card, and the step loop).  JAX's references come from one
``jax.jit`` with the layers' parameters swapped for traced arrays
(``_torch_jax_table``); the port runs ``torch.func.functional_call`` on
the same arrays (paddle's ``[in, out]`` ``Linear`` weights in both).  The beam searches run
both packages eagerly and hold ids, parents and lengths exactly: a step
with planted ties (JAX's ``lax.top_k`` rule), ``dynamic_decode`` over an
LSTM cell (beam 3, ``max_step_num`` 8, ``return_length``), and a tiny
attention seq2seq built from each package's public layers the same way
(vocabulary 50, hidden 16), whose logits, loss and gradients are held
too.  Last, the state-dict keys and shapes equal JAX's through
``convert.state_from_jax``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import tensor as T
from paddle_tpu_torch.convert import state_from_jax
from paddle_tpu_torch.nn import functional as TF

from _torch_jax_table import close, compare, first, jax_table, numpy_init
from _torch_port_util import one_thread  # noqa: F401

B, S, I, H = 3, 5, 4, 6
CPU = {"device": "cpu"}


def _f(*shapes, seed=0, scale=1.0):
    r = np.random.RandomState(seed)
    return [(r.randn(*s) * scale).astype(np.float32) for s in shapes]


def _jax_params(model):
    return list(model.named_parameters())


def _module_case(jmodel, tmodel, call, inputs):
    """A table case: ``call(model, *inputs)`` of each package with the
    parameters taken from the case's arrays (after the inputs)."""
    names = [n for n, _ in _jax_params(jmodel)]
    jparams = dict(_jax_params(jmodel))
    n_in = len(inputs)

    def jfn(*ts):
        saved = {n: p._data for n, p in jparams.items()}
        try:
            for n, t in zip(names, ts[n_in:]):
                jparams[n]._data = t._data
            return call(jmodel, *ts[:n_in])
        finally:
            for n, p in jparams.items():
                p._data = saved[n]

    class Call(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = tmodel

        def forward(self, *a):
            return call(self.m, *a)

    wrapper = Call()

    def tfn(*ts):
        pd = {f"m.{n}": t for n, t in zip(names, ts[n_in:])}
        return torch.func.functional_call(wrapper, pd, tuple(ts[:n_in]))

    arrays = list(inputs) + [np.asarray(p.numpy()) for _, p in
                             _jax_params(jmodel)]
    return jfn, tfn, arrays, True


CASES, PORT = {}, {}


def _reg(key, jmodel, tmodel, call, inputs):
    CASES[key] = _module_case(jmodel, tmodel, call, inputs)
    PORT[key] = tmodel


# ----- cells -----
CELLS = {"simple_tanh": (jnn.SimpleRNNCell, tnn.SimpleRNNCell, {}),
         "simple_relu": (jnn.SimpleRNNCell, tnn.SimpleRNNCell,
                         {"activation": "relu"}),
         "lstm": (jnn.LSTMCell, tnn.LSTMCell, {}),
         "gru": (jnn.GRUCell, tnn.GRUCell, {})}
for _i, (_c, (_jc, _tc, _kw)) in enumerate(CELLS.items()):
    for _init in (False, True):
        _x, _h, _cst = _f((B, I), (B, H), (B, H), seed=_i)
        _states = ([_h, _cst] if _c == "lstm" else [_h]) if _init else []

        def _call(m, x, *st, lstm=_c == "lstm"):
            if not st:
                return m(x)
            return m(x, tuple(st) if lstm else st[0])
        with numpy_init(_i):
            _jm = _jc(I, H, **_kw)
        _reg(f"cell|{_c}_{int(_init)}", _jm, _tc(I, H, **_kw, **CPU), _call,
             [_x] + _states)

# ----- RNN and BiRNN over cells -----
with numpy_init(10):
    _reg("wrap|rnn_lstm_reverse_time_major",
         jnn.RNN(jnn.LSTMCell(I, H), True, True),
         tnn.RNN(tnn.LSTMCell(I, H, **CPU), True, True),
         lambda m, x: m(x), _f((S, B, I), seed=11))
    _reg("wrap|rnn_simple_init", jnn.RNN(jnn.SimpleRNNCell(I, H)),
         tnn.RNN(tnn.SimpleRNNCell(I, H, **CPU)),
         lambda m, x, h: m(x, h), _f((B, S, I), (B, H), seed=13))
    _reg("wrap|birnn_gru", jnn.BiRNN(jnn.GRUCell(I, H), jnn.GRUCell(I, H)),
         tnn.BiRNN(tnn.GRUCell(I, H, **CPU), tnn.GRUCell(I, H, **CPU)),
         lambda m, x: m(x), _f((B, S, I), seed=15))

# ----- SimpleRNN / LSTM / GRU: 2 layers; each direction, time layout and
# initial-state choice meets each other (pairwise) for every mode -----
LAYERS = {"simple": (jnn.SimpleRNN, tnn.SimpleRNN, {}),
          "simple_relu": (jnn.SimpleRNN, tnn.SimpleRNN,
                          {"activation": "relu"}),
          "lstm": (jnn.LSTM, tnn.LSTM, {}), "gru": (jnn.GRU, tnn.GRU, {})}
LAYOUTS = (("forward", False, False), ("forward", True, True),
           ("bidirect", False, True), ("bidirect", True, False))
for _i, (_n, (_jl, _tl, _kw)) in enumerate(LAYERS.items()):
    for _d, _tm, _init in LAYOUTS[2:] if _n == "simple_relu" else LAYOUTS:
        nd = 2 if _d == "bidirect" else 1
        _x = _f((S, B, I) if _tm else (B, S, I), seed=_i)[0]
        _st = _f((2 * nd, B, H), (2 * nd, B, H), seed=_i + 1, scale=0.5)
        _states = (_st if _n == "lstm" else _st[:1]) if _init else []

        def _call(m, x, *st, lstm=_n == "lstm"):
            if not st:
                return m(x)
            return m(x, tuple(st) if lstm else st[0])
        with numpy_init(20 + _i):
            _jm = _jl(I, H, num_layers=2, direction=_d, time_major=_tm,
                      **_kw)
        _reg(f"layer|{_n}_{_d}_{'tm' if _tm else 'bm'}_{int(_init)}", _jm,
             _tl(I, H, num_layers=2, direction=_d, time_major=_tm, **_kw,
                 **CPU), _call, [_x] + _states)


# ----- the tiny attention seq2seq, built alike from either package -----
class _Pkg:
    """One package's layers and functions, as a model file imports
    them."""

    def __init__(self, jax):
        self.jax = jax
        self.nn = jnn if jax else tnn
        self.F = JF if jax else TF
        self.t = paddle if jax else T
        self.kw = {} if jax else CPU


JAX_PKG, PORT_PKG = _Pkg(True), _Pkg(False)


def build_seq2seq(P, vocab=50, hidden=16, layers=2, dropout=0.0):
    """PaddleNLP's attention seq2seq (``examples/machine_translation/
    seq2seq``): an LSTM encoder; a decoder cell of stacked LSTM cells
    with input feeding and dot-product attention over the (projected)
    encoder outputs, run by ``nn.RNN``; beam search through
    ``BeamSearchDecoder``.  The cell's state is a flat tuple ``(h0, c0,
    h1, c1, ..., feed)``."""
    nn, F, t, kw = P.nn, P.F, P.t, P.kw

    class AttentionCell(nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.hidden_size = hidden
            self.cells = nn.LayerList([
                nn.LSTMCell(2 * hidden if i == 0 else hidden, hidden, **kw)
                for i in range(layers)])
            self.input_proj = nn.Linear(hidden, hidden, bias_attr=False,
                                        **kw)
            self.output_proj = nn.Linear(2 * hidden, hidden,
                                         bias_attr=False, **kw)
            self.mem = {}

        def forward(self, x, states):
            inp = t.concat([x, states[-1]], axis=1)
            new = []
            for i, cell in enumerate(self.cells):
                inp, (h, c) = cell(inp, (states[2 * i], states[2 * i + 1]))
                new += [h, c]
            scores = t.matmul(t.unsqueeze(inp, [1]), self.mem["keys"],
                              transpose_y=True) + self.mem["bias"]
            attn = F.softmax(scores, axis=-1)
            ctx = t.squeeze(t.matmul(attn, self.mem["keys"]), [1])
            out = self.output_proj(t.concat([ctx, inp], axis=1))
            return out, tuple(new) + (out,)

    class Seq2Seq(nn.Layer if P.jax else torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(vocab, hidden, **kw)
            self.trg_emb = nn.Embedding(vocab, hidden, **kw)
            self.dropout = nn.Dropout(dropout)
            self.encoder = nn.LSTM(hidden, hidden, num_layers=layers, **kw)
            self.decoder = nn.RNN(AttentionCell())
            self.output_layer = nn.Linear(hidden, vocab, bias_attr=False,
                                          **kw)

        def encode(self, src, src_len, beam=None):
            enc, (h, c) = self.encoder(self.dropout(self.src_emb(src)))
            mask = F.sequence_mask(src_len, maxlen=src.shape[1],
                                   dtype="float32")
            cell = self.decoder.cell
            keys = cell.input_proj(enc)
            bias = t.unsqueeze((mask - 1.0) * 1e9, [1])
            if beam:
                tile = nn.BeamSearchDecoder.tile_beam_merge_with_batch
                keys, bias = tile(keys, beam), tile(bias, beam)
            cell.mem.update(keys=keys, bias=bias)
            feed = cell.get_initial_states(batch_ref=enc)
            return tuple(s for i in range(layers)
                         for s in (h[i], c[i])) + (feed,)

        def forward(self, src, src_len, trg_in, trg_out, trg_len):
            states = self.encode(src, src_len)
            out, _ = self.decoder(self.dropout(self.trg_emb(trg_in)),
                                  states)
            logits = self.output_layer(out)
            ce = F.cross_entropy(t.reshape(logits, [-1, vocab]),
                                 t.reshape(trg_out, [-1]), reduction="none")
            mask = F.sequence_mask(trg_len, maxlen=trg_out.shape[1],
                                   dtype="float32")
            loss = t.sum(t.reshape(ce, mask.shape) * mask) / src.shape[0]
            return loss, logits

        def beam_search(self, src, src_len, beam, bos, eos, max_steps):
            states = self.encode(src, src_len, beam)
            dec = nn.BeamSearchDecoder(self.decoder.cell, bos, eos, beam,
                                       embedding_fn=self.trg_emb,
                                       output_fn=self.output_layer)
            if P.jax:
                dec = jit_steps(dec)
            return nn.dynamic_decode(dec, states, max_step_num=max_steps,
                                     return_length=True)

    return Seq2Seq()


def _seq2seq_batch(seed=0, b=3, ls=7, lt=6, vocab=50):
    r = np.random.RandomState(seed)
    src = r.randint(3, vocab, (b, ls)).astype(np.int32)
    src_len = np.array([ls, ls - 2, 4][:b], np.int32)
    trg = r.randint(3, vocab, (b, lt + 1)).astype(np.int32)
    trg_len = np.array([lt, 3, lt - 1][:b], np.int32)
    return [src, src_len, trg[:, :-1], trg[:, 1:], trg_len]


with numpy_init(40):
    JAX_S2S = build_seq2seq(JAX_PKG)
PORT_S2S = build_seq2seq(PORT_PKG)
_reg("seq2seq|train", JAX_S2S, PORT_S2S, lambda m, *a: m(*a),
     _seq2seq_batch())


@pytest.fixture(scope="module")
def jax_refs():
    return jax_table(CASES)


def _check(refs, key, route=None):
    tfn, arrays, _, cot, jout, jgrads = refs[key]
    for m in PORT[key].modules():
        if hasattr(m, "route"):
            m.route = route
    tt = [torch.tensor(a, requires_grad=a.dtype.kind == "f")
          for a in arrays]
    tout = tfn(*tt)
    compare(tout, jout, key)
    (first(tout) * torch.from_numpy(cot)).sum().backward()
    for i, (t, j) in enumerate(zip([t for t in tt if t.requires_grad],
                                   jgrads)):
        close(t.grad, j, f"{key} grad {i}")


def _keys(family):
    return sorted(k for k in CASES if k.startswith(family + "|"))


@pytest.mark.parametrize("key", _keys("cell") + _keys("wrap"))
def test_cells_and_wrappers_match_jax(jax_refs, key):
    _check(jax_refs, key)


@pytest.mark.parametrize("route", ["fused", "loop"])
@pytest.mark.parametrize("key", _keys("layer"))
def test_multilayer_rnn_matches_jax_on_both_routes(jax_refs, key, route):
    _check(jax_refs, key, route)


@pytest.mark.parametrize("route", ["fused", "loop"])
def test_seq2seq_logits_loss_and_gradients_match_jax(jax_refs, route):
    _check(jax_refs, "seq2seq|train", route)


def test_routes_are_explicit():
    m = tnn.LSTM(I, H, **CPU)
    m.route = "cudnn"
    with pytest.raises(ValueError):
        m(torch.zeros(B, S, I))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tnn.GRU(I, H)
    # the ParamAttr arguments are JAX's (they raised before they were
    # ported): False builds the parameter, an initializer fills it
    cell = tnn.LSTMCell(I, H, weight_ih_attr=False, bias_hh_attr=tnn.ParamAttr(
        initializer=tnn.initializer.Constant(0.5)), **CPU)
    assert tuple(cell.weight_ih.shape) == (4 * H, I)
    assert (cell.bias_hh == 0.5).all()


def test_gather_tree_matches_jax():
    r = np.random.RandomState(5)
    ids = r.randint(0, 20, (6, 3, 4)).astype(np.int32)
    par = r.randint(0, 4, (6, 3, 4)).astype(np.int32)
    compare(TF.gather_tree(torch.from_numpy(ids), torch.from_numpy(par)),
            JF.gather_tree(paddle.to_tensor(ids), paddle.to_tensor(par)),
            "gather_tree")
    compare(TF.gather_tree(torch.from_numpy(ids[:1]),
                           torch.from_numpy(par[:1])),
            JF.gather_tree(paddle.to_tensor(ids[:1]),
                           paddle.to_tensor(par[:1])), "gather_tree T=1")


def jit_steps(dec):
    """``dec`` with its ``step`` run as one ``jax.jit`` of JAX's own
    ``BeamSearchDecoder.step`` (the same function, compiled once for the
    run's shapes instead of op by op)."""
    raw = type(dec).step

    @functools.partial(jax.jit, static_argnums=(5, 6))
    def f(time, inp, cs, lp, fin, batch, nested):
        cst = tuple(JTensor(c) for c in cs) if nested else JTensor(cs)
        with paddle.no_grad():
            tok, par, tlp, ninp, (ncs, nlp, nfin), nf = raw(
                dec, time, JTensor(inp), (cst, lp, fin), batch)
        ncs = tuple(c._data for c in ncs) if nested else ncs._data
        return tok, par, tlp, ninp._data, ncs, nlp, nfin, nf

    def step(time, inputs, states, batch):
        cs, lp, fin = states
        nested = isinstance(cs, (tuple, list))
        arrs = tuple(c._data for c in cs) if nested else cs._data
        tok, par, tlp, ninp, ncs, nlp, nfin, nf = f(
            time, inputs._data, arrs, lp, fin, batch, nested)
        ncs = tuple(JTensor(c) for c in ncs) if nested else JTensor(ncs)
        return tok, par, tlp, JTensor(ninp), (ncs, nlp, nfin), nf

    dec.step = step
    return dec


def _decoded(out):
    ids, _, lengths = out
    return ids, lengths


def test_beam_steps_with_planted_ties_match_jax():
    """Logits from a table of bf16 values, so totals tie across beams
    and tokens: every step's tokens, parents, log-probs and finished
    flags, and the decode, equal JAX's exactly (``lax.top_k`` takes the
    lower flat index)."""
    r = np.random.RandomState(7)
    table = (np.round(r.randn(8, 8) * 2) / 4).astype(np.float32)
    table[:, 5] = table[:, 2]                   # tokens 2 and 5 tie
    table[3] = table[1]                          # rows 1 and 3 tie
    jt, tt = paddle.to_tensor(table), torch.from_numpy(table)

    def jcell(ids, st):
        return paddle.gather(jt, ids), st

    def tcell(ids, st):
        return tt[ids.long()], st

    h = np.zeros((2, 3), np.float32)
    jdec = jit_steps(jnn.BeamSearchDecoder(jcell, 1, 7, 4))
    tdec = tnn.BeamSearchDecoder(tcell, 1, 7, 4)
    jin, jst, jb = jdec.initialize(paddle.to_tensor(h))
    tin, tst, tb = tdec.initialize(torch.from_numpy(h))
    for step in range(5):
        jo = jdec.step(step, jin, jst, jb)
        to = tdec.step(step, tin, tst, tb)
        for k, what in ((0, "token"), (1, "parent"), (2, "log_probs"),
                        (5, "finished")):
            compare(to[k], jo[k], f"step {step} {what}", rel=0.0)
        jin, jst, tin, tst = jo[3], jo[4], to[3], to[4]
    jres = jnn.dynamic_decode(jdec, paddle.to_tensor(h), max_step_num=6,
                              return_length=True)
    tres = tnn.dynamic_decode(tdec, torch.from_numpy(h), max_step_num=6,
                              return_length=True)
    compare(_decoded(tres), _decoded(jres), "decode")


def test_dynamic_decode_matches_jax():
    """An LSTM cell with an embedding and an output projection, beam 3,
    8 steps, ``return_length``, time-major and batch-major, on the same
    weights."""
    with numpy_init(3):
        jcell = jnn.LSTMCell(8, 8)
    tcell = tnn.LSTMCell(8, 8, **CPU)
    tcell.load_state_dict(state_from_jax(
        {k: v.numpy() for k, v in jcell.state_dict().items()}, tcell,
        device="cpu"))
    emb, proj = _f((12, 8), (8, 12), seed=4, scale=2.0)
    je, jp = paddle.to_tensor(emb), paddle.to_tensor(proj)
    te, tp = torch.from_numpy(emb), torch.from_numpy(proj)
    h0, c0 = _f((2, 8), (2, 8), seed=5)
    for tm in (False, True):
        jdec = jit_steps(jnn.BeamSearchDecoder(
            jcell, 0, 11, 3, embedding_fn=lambda i: paddle.gather(je, i),
            output_fn=lambda o: paddle.matmul(o, jp)))
        tdec = tnn.BeamSearchDecoder(
            tcell, 0, 11, 3, embedding_fn=lambda i: te[i.long()],
            output_fn=lambda o: o @ tp)
        jres = jnn.dynamic_decode(jdec, (paddle.to_tensor(h0),
                                         paddle.to_tensor(c0)),
                                  max_step_num=8, output_time_major=tm,
                                  return_length=True)
        tres = tnn.dynamic_decode(tdec, (torch.from_numpy(h0),
                                         torch.from_numpy(c0)),
                                  max_step_num=8, output_time_major=tm,
                                  return_length=True)
        compare(_decoded(tres), _decoded(jres), f"decode tm={tm}")
        compare(tres[1], jres[1], f"final states tm={tm}")
        jids = jnn.dynamic_decode(jdec, (paddle.to_tensor(h0),
                                         paddle.to_tensor(c0)),
                                  max_step_num=8, output_time_major=tm)
        assert len(jids) == 2


@pytest.mark.parametrize("route", ["fused", "loop"])
def test_seq2seq_beam_ids_match_jax(route):
    """The tiny seq2seq's beam search (beam 4, 8 steps, end token 2)
    gives JAX's ids and lengths exactly on the same weights."""
    PORT_S2S.load_state_dict(state_from_jax(
        {k: v.numpy() for k, v in JAX_S2S.state_dict().items()}, PORT_S2S,
        device="cpu"))
    PORT_S2S.encoder.route = route
    src, src_len = _seq2seq_batch(1)[:2]
    with paddle.no_grad():
        jres = JAX_S2S.beam_search(paddle.to_tensor(src),
                                   paddle.to_tensor(src_len), 4, 1, 2, 8)
    tres = PORT_S2S.beam_search(torch.from_numpy(src),
                                torch.from_numpy(src_len), 4, 1, 2, 8)
    compare(_decoded(tres), _decoded(jres), "seq2seq beam")


def test_state_dict_keys_and_shapes_match_jax():
    """2-layer bidirectional LSTM, GRU and SimpleRNN and the seq2seq:
    JAX's keys and shapes, loaded through the converter."""
    for jl, tl in ((jnn.LSTM, tnn.LSTM), (jnn.GRU, tnn.GRU),
                   (jnn.SimpleRNN, tnn.SimpleRNN)):
        with numpy_init(6):
            j = jl(I, H, num_layers=2, direction="bidirect")
        t = tl(I, H, num_layers=2, direction="bidirect", **CPU)
        want = {k: tuple(v.shape) for k, v in j.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in t.state_dict().items()} == \
            want
        assert list(t.state_dict()) == list(want)
        t.load_state_dict(state_from_jax(
            {k: v.numpy() for k, v in j.state_dict().items()}, t,
            device="cpu"))
    jsd = JAX_S2S.state_dict()
    tsd = PORT_S2S.state_dict()
    assert set(tsd) == set(jsd)
    for k in jsd:
        assert tuple(tsd[k].shape) == tuple(jsd[k].shape), k
    with pytest.raises(KeyError):
        state_from_jax({"weight_ih_l0": np.zeros((4, 4))},
                       tnn.GRU(I, H, **CPU), device="cpu")


def test_initial_values_follow_jax_rule():
    """``Uniform(-1/sqrt(H), 1/sqrt(H))`` from the counter stream, one
    key a parameter: a reseeded stream gives the same weights."""
    from paddle_tpu_torch import random as trandom

    trandom.seed(9)
    a = tnn.LSTM(I, 64, **CPU)
    trandom.seed(9)
    b = tnn.LSTM(I, 64, **CPU)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
        assert p.abs().max() <= 1 / 8.0 and p.abs().max() > 0.1, n
    c = tnn.GRUCell(I, 16, **CPU).get_initial_states(torch.zeros(5, 2),
                                                     init_value=0.5)
    assert c.shape == (5, 16) and c.dtype == torch.float32 and \
        bool((c == 0.5).all())
    assert jnp.asarray(0).dtype == jnp.int32      # x64 off, as the tests run


def test_names_match_jax():
    """Every class of JAX's ``nn/layer/rnn.py``, ``BeamSearchDecoder``
    and ``dynamic_decode`` of ``nn/decode.py`` and ``gather_tree`` exist
    in the port's ``nn`` and ``nn.functional``."""
    import paddle_tpu.nn.decode as jdecode
    import paddle_tpu.nn.layer.rnn as jrnn

    classes = {n for n, v in vars(jrnn).items() if isinstance(v, type)
               and v.__module__ == jrnn.__name__ and not n.startswith("_")}
    assert classes == {"RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell",
                       "RNN", "BiRNN", "SimpleRNN", "LSTM", "GRU"}
    assert classes <= set(tnn.__all__)
    decode = {n for n, v in vars(jdecode).items() if callable(v)
              and getattr(v, "__module__", None) == jdecode.__name__}
    assert decode == {"BeamSearchDecoder", "dynamic_decode"}
    assert decode <= set(tnn.__all__)
    assert callable(TF.gather_tree)


def test_rnn_ignores_sequence_length_dropout_and_proj_size_as_jax():
    """JAX's RNN layers take ``sequence_length``, the inter-layer
    ``dropout`` and ``LSTMCell``'s ``proj_size`` and ignore them
    (upstream Paddle applies all three: ``ROADMAP.md`` Queue 3); the
    port does the same."""
    with numpy_init(8):
        jm = jnn.LSTM(I, H, num_layers=2, dropout=0.5)
        jcell = jnn.LSTMCell(I, H, proj_size=3)
    tm = tnn.LSTM(I, H, num_layers=2, dropout=0.5, **CPU)
    tm.load_state_dict(state_from_jax(
        {k: v.numpy() for k, v in jm.state_dict().items()}, tm,
        device="cpu"))
    tm.train()
    x = torch.from_numpy(_f((B, S, I), seed=9)[0])
    a, (ha, ca) = tm(x)
    b, (hb, cb) = tm(x, sequence_length=torch.tensor([2, 5, 3]))
    assert torch.equal(a, b) and torch.equal(ha, hb) and torch.equal(ca, cb)
    assert jm.dropout == tm.dropout == 0.5
    cell = tnn.LSTMCell(I, H, proj_size=3, **CPU)
    h, (h2, c) = cell(x[:, 0])
    assert h.shape == (B, H) and jcell.weight_hh.shape == [4 * H, H]
