"""The recurrent layers, the counterparts of ``paddle_tpu/nn/layer/rnn.py``
(all nine): ``RNNCellBase`` (with ``get_initial_states``),
``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``, ``RNN`` and ``BiRNN`` over a
cell, and the multi-layer ``SimpleRNN``, ``LSTM`` and ``GRU``.

Parameters keep JAX's names and layouts (``weight_ih_l0``,
``weight_hh_l0_reverse``, ... of shape ``[gates * H, in]``; LSTM gates
``i, f, g, o``, GRU gates ``r, z, c`` with the reset gate multiplying
``h W_hh^T + b_hh``), which are torch's too, and initial values
``Uniform(-1/sqrt(H), 1/sqrt(H))`` drawn from the port's counter stream,
one key a parameter in JAX's order.  Constructors build on the card
unless asked for the CPU (``device=``).  The gate arithmetic is JAX's
term for term (``rnn.py:73-131`` and ``:213-240``).

**Routes of the multi-layer layers.**  JAX runs ``SimpleRNN``, ``LSTM``
and ``GRU`` as one ``lax.scan``.  On the card they run cuDNN's fused RNN
(``torch._VF.lstm``/``gru``/``rnn_tanh``/``rnn_relu``, the weights
flattened into cuDNN's buffer once and again whenever a parameter's
storage moves), which computes the same gate function; on the CPU they
run the plain twin, a Python loop over the time steps of JAX's step
function.  ``route`` (``"fused"`` or ``"loop"``) forces one of the two on
either device (the CPU tests hold both to JAX); nothing falls back from
one to the other.  cuDNN uses TF32 in f32 unless
``torch.backends.cudnn.allow_tf32`` is off.

As JAX's, these ignore ``sequence_length`` (``RNN``, ``BiRNN`` and the
multi-layer layers run every step of every sequence), the inter-layer
``dropout`` (stored, never applied) and ``LSTMCell``'s ``proj_size``;
Paddle masks by length and applies the dropout (``ROADMAP.md`` Queue 3).
The ParamAttr arguments (``weight_ih_attr``, ``weight_hh_attr``,
``bias_ih_attr``, ``bias_hh_attr``) are JAX's: ``Layer.create_parameter``
takes each for its parameters (an attr's initializer replaces the
uniform one).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ..amp.auto_cast import cast_inputs
from ..device import resolve_device
from ..tensor import manipulation as _manip
from ..tensor.creation import jax_dtype
from .initializer import Uniform
from .layers import Layer

__all__ = ["BiRNN", "GRU", "GRUCell", "LSTM", "LSTMCell", "RNN",
           "RNNCellBase", "SimpleRNN", "SimpleRNNCell"]

_ROUTES = (None, "fused", "loop")


def _uniform_params(module, names, shapes, attrs, hidden_size, device):
    """Register ``names`` as parameters of ``shapes`` (the last two
    biases) with ``attrs``, by default drawn from ``Uniform(-1/sqrt(H),
    1/sqrt(H))``, one key each, in order."""
    std = 1.0 / math.sqrt(hidden_size)
    dev = resolve_device(device)
    for i, (name, shape, attr) in enumerate(zip(names, shapes, attrs)):
        setattr(module, name, module.create_parameter(
            shape, attr, is_bias=i >= 2,
            default_initializer=Uniform(-std, std), device=dev))


def _gates(x, h, wi, wh, bi, bh):
    """``x W_ih^T + b_ih + h W_hh^T + b_hh``, summed in JAX's order."""
    return torch.addmm(TF.linear(x, wi, bi), h, wh.t()) + bh


def _lstm_step(x, h, c, wi, wh, bi, bh):
    i, f, g, o = _gates(x, h, wi, wh, bi, bh).chunk(4, -1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_step(x, h, wi, wh, bi, bh):
    ir, iz, ic = TF.linear(x, wi, bi).chunk(3, -1)
    hr, hz, hc = TF.linear(h, wh, bh).chunk(3, -1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    c = torch.tanh(ic + r * hc)
    return (1 - z) * c + z * h


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """``[batch, hidden_size]`` of ``init_value`` in ``dtype``
        (f32 by default) on ``batch_ref``'s device; ``shape`` is
        ignored, as JAX's."""
        b = batch_ref.shape[batch_dim_idx]
        return torch.full((b, self.hidden_size), init_value,
                          dtype=jax_dtype(dtype or "float32"),
                          device=batch_ref.device)


class _Cell(RNNCellBase):
    GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr, device, dtype):
        super().__init__(dtype=dtype)
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = self.GATES * hidden_size
        _uniform_params(self, ("weight_ih", "weight_hh", "bias_ih",
                               "bias_hh"),
                        ((g, input_size), (g, hidden_size), (g,), (g,)),
                        (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr), hidden_size, device)

    def _weights(self):
        return self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                         dtype)
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x, h, *w = cast_inputs("simple_rnn_cell", inputs, states,
                               *self._weights())
        act = torch.tanh if self.activation == "tanh" else torch.relu
        h = act(_gates(x, h, *w))
        return h, h

    @property
    def state_shape(self):
        return ((self.hidden_size,),)


class LSTMCell(_Cell):
    GATES = 4

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=None, name=None, *, device=None, dtype=None):
        """``proj_size`` is ignored, as JAX's."""
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                         dtype)

    def forward(self, inputs, states=None):
        """``(h, (h, c))``."""
        if states is None:
            states = (self.get_initial_states(inputs),
                      self.get_initial_states(inputs))
        x, h, c, *w = cast_inputs("lstm_cell", inputs, *states,
                                  *self._weights())
        h, c = _lstm_step(x, h, c, *w)
        return h, (h, c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(_Cell):
    GATES = 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                         dtype)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x, h, *w = cast_inputs("gru_cell", inputs, states, *self._weights())
        h = _gru_step(x, h, *w)
        return h, h

    @property
    def state_shape(self):
        return ((self.hidden_size,),)


class RNN(Layer):
    """A cell run over the time steps, one call a step (teacher
    forcing); ``sequence_length`` is ignored, as JAX's."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        axis = 0 if self.time_major else 1
        steps = _manip.unbind(inputs, axis)
        if self.is_reverse:
            steps = steps[::-1]
        states = initial_states
        outs = []
        for x in steps:
            out, states = self.cell(x, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return _manip.stack(outs, axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = (initial_states if initial_states is not None
                        else (None, None))
        out_fw, s_fw = self.rnn_fw(inputs, st_fw)
        out_bw, s_bw = self.rnn_bw(inputs, st_bw)
        return _manip.concat([out_fw, out_bw], axis=-1), (s_fw, s_bw)


_VF_FNS = {"LSTM": "lstm", "GRU": "gru", "RNN_TANH": "rnn_tanh",
           "RNN_RELU": "rnn_relu"}
_CUDNN_MODES = {"RNN_RELU": 0, "RNN_TANH": 1, "LSTM": 2, "GRU": 3}


class _RNNBase(Layer):
    MODE = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, activation=None, name=None, *,
                 device=None, dtype=None):
        super().__init__(dtype=dtype)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        self.route = None
        self._flat_key = None
        g = {"LSTM": 4, "GRU": 3}.get(self.MODE, 1) * hidden_size
        self._param_names = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_size = (input_size if layer == 0
                           else hidden_size * self.num_directions)
                sfx = f"l{layer}" + ("_reverse" if d else "")
                names = (f"weight_ih_{sfx}", f"weight_hh_{sfx}",
                         f"bias_ih_{sfx}", f"bias_hh_{sfx}")
                _uniform_params(self, names, ((g, in_size), (g, hidden_size),
                                              (g,), (g,)),
                                (weight_ih_attr, weight_hh_attr,
                                 bias_ih_attr, bias_hh_attr), hidden_size,
                                device)
                self._param_names += names

    def _weights(self):
        return [getattr(self, n) for n in self._param_names]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """``(outputs, h)``, or ``(outputs, (h, c))`` for the LSTM; the
        states ``[num_layers * num_directions, batch, hidden]``."""
        if self.route not in _ROUTES:
            raise ValueError(f"route must be one of {_ROUTES}")
        is_lstm = self.MODE == "LSTM"
        hx = (() if initial_states is None else tuple(initial_states)
              if is_lstm else (initial_states,))
        x, *rest = cast_inputs(f"rnn_{self.MODE.lower()}", inputs, *hx,
                               *self._weights())
        hx, weights = rest[:len(hx)], rest[len(hx):]
        if not hx:
            b = x.shape[1 if self.time_major else 0]
            zeros = torch.zeros(self.num_layers * self.num_directions, b,
                                self.hidden_size, dtype=x.dtype,
                                device=x.device)
            hx = [zeros, zeros] if is_lstm else [zeros]
        route = self.route or ("fused" if x.is_cuda else "loop")
        run = self._fused if route == "fused" else self._loop
        out, *states = run(x, hx, weights)
        return out, (tuple(states) if is_lstm else states[0])

    def _flatten(self, weights):
        """Put the weights into one cuDNN buffer (as
        ``torch.nn.LSTM.flatten_parameters``) when their storage moved."""
        key = tuple(w.data_ptr() for w in weights)
        if key == self._flat_key:
            return
        if (torch._use_cudnn_rnn_flatten_weight()
                and len({w.dtype for w in weights}) == 1
                and torch.backends.cudnn.is_acceptable(weights[0].data)):
            with torch.no_grad():
                torch._cudnn_rnn_flatten_weight(
                    weights, 4, self.input_size, _CUDNN_MODES[self.MODE],
                    self.hidden_size, 0, self.num_layers,
                    not self.time_major, self.bidirectional)
            key = tuple(w.data_ptr() for w in weights)
        self._flat_key = key

    def _fused(self, x, hx, weights):
        """cuDNN's fused RNN on the card (torch's native kernels on the
        CPU)."""
        if x.is_cuda and all(w is p for w, p in zip(weights,
                                                     self._weights())):
            self._flatten(weights)
        fn = getattr(torch._VF, _VF_FNS[self.MODE])
        args = (self.num_layers, 0.0, torch.is_grad_enabled(),
                self.bidirectional, not self.time_major)
        if self.MODE == "LSTM":
            return fn(x, tuple(hx), weights, True, *args)
        return fn(x, hx[0], weights, True, *args)

    def _step(self):
        if self.MODE == "LSTM":
            return _lstm_step
        if self.MODE == "GRU":
            return _gru_step
        act = torch.tanh if self.MODE == "RNN_TANH" else torch.relu
        return lambda x, h, *w: act(_gates(x, h, *w))

    def _loop(self, x, hx, weights):
        """The plain twin: JAX's scan as a Python loop over the steps."""
        is_lstm = self.MODE == "LSTM"
        step, nd = self._step(), self.num_directions
        out = x if self.time_major else x.transpose(0, 1)   # [T, B, ...]
        last_h, last_c = [], []
        for layer in range(self.num_layers):
            dir_outs = []
            for d in range(nd):
                k = layer * nd + d
                w = weights[4 * k:4 * k + 4]
                h = hx[0][k]
                c = hx[1][k] if is_lstm else None
                ys = []
                for xt in (out.flip(0) if d else out):
                    if is_lstm:
                        h, c = step(xt, h, c, *w)
                    else:
                        h = step(xt, h, *w)
                    ys.append(h)
                ys = torch.stack(ys)
                dir_outs.append(ys.flip(0) if d else ys)
                last_h.append(h)
                last_c.append(c)
            out = torch.cat(dir_outs, -1) if nd == 2 else dir_outs[0]
        out = out if self.time_major else out.transpose(0, 1)
        if is_lstm:
            return out, torch.stack(last_h), torch.stack(last_c)
        return out, torch.stack(last_h)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        self.MODE = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kw)


class LSTM(_RNNBase):
    MODE = "LSTM"


class GRU(_RNNBase):
    MODE = "GRU"
