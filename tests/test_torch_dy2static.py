"""The port's dy2static (``paddle_tpu_torch.jit.dy2static``) against the
JAX package's on the cases of ``tests/test_dy2static.py``: each function
is written once over a package namespace ``P`` and runs through both
packages' ``to_static`` (or ``convert_to_static``, where the JAX test
holds the eager conversion) on the same NumPy inputs.  Traced predicates
stage in both (``torch.cond`` / ``while_loop`` in the port, ``lax`` in
JAX), so one captured program serves every predicate value, which the
cache sizes show.  The errors the JAX tests expect (an undefined
variable, a side-effect-only branch, a zero range step, a None
fall-through) are raised by the port too.  ``TestStaticProgramRecording``
has no counterpart: the port has no ``static`` yet (ROADMAP.md).

Tolerance: the same f32 arithmetic, outputs to 1e-6 relative (1e-5 where
a loop multiplies through matmuls).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.jit.dy2static import convert_to_static as j_convert
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.jit.dy2static import convert_to_static as t_convert

from _torch_port_util import one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    """The CPU as the current device for each test, in a fresh slot that
    the teardown swaps back (the suite's processes run many files)."""
    monkeypatch.setattr(tdevice, "_CURRENT", [None])
    tp.set_device("cpu")


def _np(out):
    if isinstance(out, (tuple, list)):
        return [_np(o) for o in out]
    if isinstance(out, torch.Tensor):
        return out.detach().numpy()
    if hasattr(out, "numpy"):
        return np.asarray(out.numpy())
    return out


def _args(P, arrays):
    return [P.to_tensor(a) if isinstance(a, np.ndarray) else a
            for a in arrays]


def _f32(*v):
    return np.asarray(v if len(v) > 1 else v[0], np.float32)


def _i32(v):
    return np.asarray(v, np.int32)


# ------------------------------------------------------------------ cases
def branches(P):
    def f(x, flag=True):
        if P.sum(x) > 0:
            t = x + 1.0
            y = t * 2.0
        else:
            y = x - 1.0
        if flag:
            y = y + 10.0
        return y
    return f


def one_if(P):
    def f(x):
        if P.sum(x) > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y
    return f


def steps_to_100(P):
    def f(x):
        s = P.zeros([])
        i = P.zeros([])
        while s < 100.0:
            s = s + x
            i = i + 1.0
        return i
    return f


def nested_if(P):
    def f(x):
        if P.sum(x) > 0:
            if P.max(x) > 5.0:
                y = x * 10.0
            else:
                y = x * 2.0
        else:
            y = x - 1.0
        return y
    return f


def mixed(P):
    def f(x, mode="double"):
        if mode == "double":
            y = x * 2.0
        else:
            y = x * 3.0
        if P.sum(y) > 100.0:
            y = y / 10.0
        return y
    return f


def and_or_not(P):
    def f(x, y):
        if P.sum(x) > 0 and P.sum(y) > 0:
            out = x + y
        elif P.sum(x) > 0 or not (P.sum(y) > -10.0):
            out = x - y
        else:
            out = x * 0.0
        return out
    return f


def chained(P):
    def f(x):
        i = P.zeros([])
        s = P.zeros([])
        while 0.0 <= i < 4.0:
            s = s + x
            i = i + 1.0
        return s
    return f


def traced_range(P):
    def f(x, n):
        s = P.zeros([])
        for i in range(n):
            s = s + x * (i + 1.0)
        return s
    return f


def decode_loop(P):
    def f(scale, steps):
        tok = P.zeros([])
        acc = P.zeros([])
        for i in range(steps):
            tok = tok * 0.5 + scale
            acc = acc + tok
        return acc
    return f


def return_in_if(P):
    def f(x):
        if P.sum(x) > 0:
            return x * 2.0
        return x - 1.0
    return f


def body_temp(P):
    def f(x):
        i = P.zeros([])
        s = P.zeros([])
        while i < 4.0:
            tmp = x * 2.0
            s = s + tmp
            i = i + 1.0
        return s
    return f


def side_effect_if(P):
    def f(x):
        out = x * 1.0
        if P.sum(x) > 0:
            out = out + 1.0
        return out
    return f


def return_in_while(P):
    def f(x, lim):
        y = x
        while P.sum(y) < lim:
            t = y * 2.0
            if P.sum(t) > 50.0:
                return t
            y = t
        return y
    return f


def break_in_while(P):
    def f(x):
        s = x
        i = 0
        while i < 100:
            s = s + x
            if P.sum(s) > 10.0:
                break
            i += 1
        return s, i
    return f


def break_in_range(P):
    def f(x):
        acc = x * 0.0
        for i in range(10):
            acc = acc + x
            if P.sum(acc) > 5.0:
                break
        return acc
    return f


def multi_site(P):
    def f(x):
        if P.sum(x) > 10.0:
            return x * 3.0
        elif P.sum(x) > 0.0:
            return x * 2.0
        else:
            return -x
    return f


def tuple_sites(P):
    def f(x):
        if P.sum(x) > 0:
            return x * 2.0, x + 1.0
        return x, x - 1.0
    return f


def greedy_decode(P):
    W = P.to_tensor(np.eye(4, dtype=np.float32) * 0.5)

    def f(h, steps):
        n = 0
        while n < steps:
            h = P.matmul(h, W)
            if P.max(h) < 0.1:
                return h * 0.0
            n = n + 1
        return h
    return f


def scan_rows(P):
    def f(seq, h):
        for row in seq:
            h = h * 0.5 + row
        return h
    return f


def post_return(P):
    def f(x):
        if P.sum(x) > 0:
            return x * 2.0
        y = x + 1.0
        return y
    return f


def helper_stages(P):
    def helper(x):
        if P.sum(x) > 0:
            return x * 2.0
        return x - 1.0

    def entry(x):
        y = helper(x)
        return y + 10.0
    return entry


def two_levels(P):
    def inner(x):
        while P.sum(x) < 10.0:
            x = x * 2.0
        return x

    def mid(x):
        return inner(x) + 1.0

    def entry(x):
        return mid(x) * 1.0
    return entry


def while_true(P):
    def f(x):
        while True:
            x = x * 2.0
            if P.sum(x) > 10.0:
                return x
    return f


def beam(P):
    V, B = 6, 3
    W = P.to_tensor(np.linspace(-0.5, 0.5, 4 * V).reshape(4, V)
                    .astype(np.float32))
    E = P.to_tensor(np.linspace(-0.2, 0.2, V * 4).reshape(V, 4)
                    .astype(np.float32))

    def f(h, scores, steps, thresh):
        n = 0
        while n < steps:
            logits = P.matmul(h, W)
            cand = scores.unsqueeze(-1) + logits
            flat = cand.reshape([B * V])
            scores, idx = P.topk(flat, k=B)
            beam = idx // V
            tok = idx % V
            h = P.tanh(h[beam] + E[tok])
            if P.max(scores) > thresh:
                return h, scores
            n = n + 1
        return h, scores
    return f


_H0 = np.ones((3, 4), np.float32)
_S0 = np.zeros(3, np.float32)

#: name -> (build function, [argument tuples], captured programs):
#: every argument tuple runs through both packages' to_static; the port's
#: cache must end with that many programs (a staged predicate serves all
#: its values from one)
STATIC = {
    "if_stages_one_program": (one_if, [(_f32(1, 2),), (_f32(-1, -2),)], 1),
    "data_dependent_while": (steps_to_100, [(_f32(7.0),), (_f32(50.0),)],
                             1),
    "nested_if": (nested_if, [(_f32([7.0]),), (_f32([1.0]),),
                              (_f32([-1.0]),)], 1),
    "mixed_python_and_tensor": (mixed, [(_f32([1.0]),), (_f32([100.0]),),
                                        (_f32([1.0]), "triple")], 2),
    "and_or_not": (and_or_not, [(_f32(1, 2), _f32(3, 4)),
                                (_f32(1, 2), _f32(-9, -9)),
                                (_f32(-1, -2), _f32(-20, -20)),
                                (_f32(-1, -2), _f32(1, 1))], 1),
    "chained_comparison_in_while": (chained, [(_f32(2.0),)], 1),
    "traced_range_bound": (traced_range, [(_f32(2.0), _i32(4)),
                                          (_f32(2.0), _i32(2)),
                                          (_f32(2.0), _i32(0))], 1),
    "decode_style_range": (decode_loop, [(_f32(1.0), _i32(5))], 1),
    "return_inside_if": (return_in_if, [(_f32([2.0]),), (_f32([-2.0]),)],
                         1),
    "body_local_temp": (body_temp, [(_f32(3.0),)], 1),
    "side_effect_only_if": (side_effect_if, [(_f32([1.0]),),
                                             (_f32([-1.0]),)], 1),
    "return_in_while_both_exits": (return_in_while,
                                   [(_f32([1.0]), _f32(10.0)),
                                    (_f32([1.0]), _f32(1e6))], 1),
    "break_in_while_mid_loop": (break_in_while, [(_f32([2.0]),)], 1),
    "break_in_range": (break_in_range, [(_f32([2.0]),)], 1),
    "multi_site_returns": (multi_site, [(_f32([20.0]),), (_f32([1.0]),),
                                        (_f32([-5.0]),)], 1),
    "tuple_return_sites": (tuple_sites, [(_f32([3.0]),), (_f32([-3.0]),)],
                           1),
    "greedy_decode": (greedy_decode, [(_f32([[1.0] * 4]), _i32(100)),
                                      (_f32([[1.0] * 4]), _i32(2))], 1),
    "tensor_rows_scan": (scan_rows, [(_f32([[1, 2], [3, 4], [5, 6]]),
                                      _f32(0, 0))], 1),
    "post_return_bindings": (post_return, [(_f32([2.0]),),
                                           (_f32([-2.0]),)], 1),
    "undecorated_helper_stages": (helper_stages, [(_f32([2.0]),),
                                                  (_f32([-2.0]),)], 1),
    "two_levels_deep": (two_levels, [(_f32([1.0]),)], 1),
    "while_true_return_only_exit": (while_true, [(_f32([1.0]),)], 1),
    "beam_search_early_exit": (beam, [(_H0, _S0, _i32(50), _f32(1.0)),
                                      (_H0, _S0, _i32(3), _f32(1e9))], 1),
}


@pytest.mark.parametrize("name", sorted(STATIC))
def test_to_static_matches_jax(name):
    build, calls, programs = STATIC[name]
    jf, tf = jp.jit.to_static(build(jp)), tp.jit.to_static(build(tp))
    for args in calls:
        _close(tf(*_args(tp, args)), jf(*_args(jp, args)), str(args))
    assert len(tf.program_cache) == programs


def _close(got, want, what):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for g, w in zip(got, want):
            _close(g, w, what)
        return
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-5,
                               atol=1e-6, err_msg=what)


#: eager conversions (``convert_to_static``): Python semantics exactly
CONVERT = {
    "branches_and_python_if": (branches, [(_f32(1, 2),), (_f32(-3, -3),),
                                          (_f32(1, 2), False)]),
    "python_while": (lambda P: lambda n: sum(range(n)), [(5,)]),
    "tensor_rows_eager": (scan_rows, [(_f32([[1, 2], [3, 4]]),
                                       _f32(0, 0))]),
    "return_inside_if_eager": (return_in_if, [(_f32([2.0]),),
                                              (_f32([-2.0]),)]),
    "while_true_eager": (while_true, [(_f32([1.0]),)]),
    "beam_search_eager": (beam, [(_H0, _S0, 50, 1.0), (_H0, _S0, 3, 1e9)]),
}


@pytest.mark.parametrize("name", sorted(CONVERT))
def test_eager_conversion_matches_jax(name):
    build, calls = CONVERT[name]
    jf, tf = j_convert(build(jp)), t_convert(build(tp))
    for args in calls:
        _close(tf(*_args(tp, args)), jf(*_args(jp, args)), str(args))


def test_eager_runs_exactly_one_branch_and_keeps_short_circuit():
    for P, convert in ((jp, j_convert), (tp, t_convert)):
        calls = []

        def probe(tag, v, calls=calls):
            calls.append(tag)
            return v

        def f(x, flag=False):
            if flag and probe("rhs", True):
                x = x + 1.0
            if P.sum(x) > 0:
                y = probe("true", x * 2.0)
            else:
                y = probe("false", x * 3.0)
            return y

        convert(f)(P.to_tensor(_f32([1.0])))
        assert calls == ["true"]


def test_for_range_targets_and_fallbacks():
    """Concrete ranges: the target after the loop, an empty range's prior
    binding, a body that rebinds the target, and an unbound target."""
    def g(P):
        def f(x):
            total = P.zeros([])
            for i in range(2, 8, 3):
                total = total + x * i
            return total, i
        return f

    def prior(P):
        def f(x):
            i = 5
            for i in range(0):
                x = x + 1.0
            return i * 1.0
        return f

    def rebinds(P):
        def f(x):
            for i in range(3):
                i = i * 10
            return i
        return f

    def unbound(P):
        def f(x):
            for i in range(0):
                x = x + 1.0
            return i * 1.0
        return f

    for P, convert in ((jp, j_convert), (tp, t_convert)):
        x = P.to_tensor(_f32(1.0))
        t, last = convert(g(P))(x)
        assert float(_np(t)) == 7.0 and last == 5
        assert convert(prior(P))(x) == 5.0
        assert convert(rebinds(P))(x) == 20
        with pytest.raises(NameError, match="'i'"):
            convert(unbound(P))(x)


ERRORS = {
    "one_path_temp": (NameError, "'t'", lambda P: _one_path(P),
                      (_f32([1.0]),)),
    "loop_carried_undefined": (NameError, "acc", lambda P: _undef_acc(P),
                               (_f32(1.0),)),
    "side_effect_only_branch": (TypeError, "assigns no",
                                lambda P: _side_effect(P), (_f32([-1.0]),)),
    "zero_step": (ValueError, "must not be zero", lambda P: _zero_step(P),
                  (_f32(1.0), _i32(5))),
    "implicit_none_fallthrough": (TypeError, "every path|final return",
                                  lambda P: _none_fall(P), (_f32([1.0]),)),
}


def _one_path(P):
    def f(x):
        if P.sum(x) > 0:
            t = x * 2.0
        else:
            y = x - 1.0
            t2 = y  # noqa: F841
        return t * 1.0
    return f


def _undef_acc(P):
    def f(x):
        i = P.zeros([])
        while i < 3.0:
            acc = acc + x                      # noqa: F821
            i = i + 1.0
        return acc
    return f


def _side_effect(P):
    log = []

    def f(x):
        if P.sum(x) > 0:
            log.append("taken")
        return x * 1.0
    return f


def _zero_step(P):
    def f(x, n):
        s = P.zeros([])
        for i in range(0, n, 0):
            s = s + x
        return s
    return f


def _none_fall(P):
    def f(x):
        if P.sum(x) > 0:
            return x * 2.0
    return f


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_staging_errors_match_jax(name):
    exc, match, build, args = ERRORS[name]
    for P in (jp, tp):
        with pytest.raises(exc, match=match):
            P.jit.to_static(build(P))(*_args(P, args))


def test_layer_forward_converts_on_jax_weights():
    """A Layer whose forward branches on a tensor: the port's layer on
    the JAX layer's weights, eager and under to_static, equals JAX's."""
    def gate(P):
        class Gate(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.lin = P.nn.Linear(4, 4)

            def forward(self, x):
                h = self.lin(x)
                if P.mean(h) > 0:
                    out = P.nn.functional.relu(h)
                else:
                    out = h * 0.1
                return out
        return Gate()

    jp.seed(0)
    jl, tl = gate(jp), gate(tp)
    tl.load_state_dict({k: torch.from_numpy(np.asarray(v.numpy()))
                        for k, v in jl.state_dict().items()})
    for seed in (0, 3):
        x = np.random.RandomState(seed).randn(2, 4).astype(np.float32)
        want = jl(jp.to_tensor(x)).numpy()
        np.testing.assert_allclose(_np(tl(torch.from_numpy(x))), want,
                                   rtol=1e-6, atol=1e-6)
    jp.jit.to_static(jl)
    tp.jit.to_static(tl)
    for seed in (0, 3, 5):
        x = np.random.RandomState(seed).randn(2, 4).astype(np.float32)
        np.testing.assert_allclose(_np(tl(torch.from_numpy(x))),
                                   jl(jp.to_tensor(x)).numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_scan_differentiates_as_jax():
    """A loop over a traced tensor's rows is differentiable: the
    gradient through the port's to_static equals JAX's jax.grad of its
    staged scan."""
    import jax

    seq = _f32([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    h0 = _f32(0.3, -0.2)
    jconv = j_convert(scan_rows(jp))

    def loss(seq_a, h_a):
        return (jconv(jp.Tensor(seq_a), jp.Tensor(h_a))._data ** 2).sum()

    want = np.asarray(jax.grad(loss, argnums=1)(seq, h0))
    sf = tp.jit.to_static(scan_rows(tp))
    h = torch.from_numpy(h0).requires_grad_(True)
    (sf(torch.from_numpy(seq), h) ** 2).sum().backward()
    np.testing.assert_allclose(h.grad.numpy(), want, rtol=1e-6)


def test_closures_globals_and_recursion():
    """Sibling closures keep their own cells, a rebound global is seen,
    and a nested self-recursive function calls its conversion."""
    def make(P, convert, scale):
        def f(x):
            if P.sum(x) > 0:
                y = x * scale
            else:
                y = x - scale
            return y
        return convert(f)

    def outer(P, convert):
        def g(x, n):
            y = x
            if n > 0:
                y = g(x * 2.0, n - 1)
            return y
        return convert(g)

    g = globals()
    for P, convert in ((jp, j_convert), (tp, t_convert)):
        x = P.to_tensor(_f32([2.0]))
        c1, c2 = make(P, convert, 1.0), make(P, convert, 10.0)
        assert _np(c1(x)).tolist() == [2.0] and _np(c2(x)).tolist() == [20.0]
        assert _np(outer(P, convert)(P.to_tensor(_f32([1.0])), 2)) \
            .tolist() == [4.0]
        g["_rebindable"] = lambda t: t + 1.0

        def h(x):
            if P.sum(x) > 0:
                y = _rebindable(x)  # noqa: F821
            else:
                y = x
            return y

        conv = convert(h)
        try:
            assert _np(conv(x)).tolist() == [3.0]
            g["_rebindable"] = lambda t: t + 100.0
            assert _np(conv(x)).tolist() == [102.0]
        finally:
            g.pop("_rebindable", None)


def test_unconvertible_traced_predicate_raises_by_name():
    """An if whose body the converter leaves as Python (a return inside
    try) works eagerly and raises a message naming the construct under
    capture, as JAX's guard does."""
    from paddle_tpu_torch.jit.dy2static import UnconvertibleControlFlowError

    def f(x):
        try:
            if tp.sum(x) > 0:
                return x * 2.0
        finally:
            pass
        return x

    x = torch.tensor([2.0])
    np.testing.assert_allclose(t_convert(f)(x).numpy(), [4.0])
    with pytest.raises(UnconvertibleControlFlowError,
                       match="deliberately does not stage"):
        tp.jit.to_static(f)(x)
