"""The port's static-graph mode (``paddle_tpu_torch.static``) on the CPU,
against the JAX package's (``paddle_tpu.static``) on the same feeds and
weights: one counterpart for each case of ``tests/test_static_graph.py``,
a 2-layer BERT MLM trained by three static ``AdamW`` steps (against
JAX's static steps, and bit for bit against the port's eager steps), the
batch a ``None`` dim bakes in at build, and static dropout's masks.

Each test builds the same program in both packages; a ``static.nn.fc``
program's weights go from JAX's to the port's in JAX's parameter order
(``static.parameters_of`` against JAX's ``_collect_params``), an ``nn``
model's through its ``state_dict``.  Tolerances: the same f32 functions
in another summation order, 1e-5 relative and 1e-6 absolute (training
losses 2e-5); the port's static steps against its eager steps bit for
bit.
"""

import copy

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.static as jstatic
import paddle_tpu_torch as tp
import paddle_tpu_torch.static as tstatic
from paddle_tpu.static.graph import _collect_params as jax_params
from paddle_tpu_torch import device as tdevice

from _torch_port_util import one_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    """The CPU as the port's current device, in a fresh slot that the
    teardown swaps back (the suite's processes run many files)."""
    monkeypatch.setattr(tdevice, "_CURRENT", [None])
    tp.set_device("cpu")


@pytest.fixture
def static_mode():
    jp.enable_static()
    tp.enable_static()
    try:
        yield
    finally:
        tp.disable_static()
        jp.disable_static()


def both_static(fn):
    """``fn(P, S)`` once with each package's root and ``static``."""
    return fn(jp, jstatic), fn(tp, tstatic)


def copy_fc_params(jfetch, tfetch):
    """The JAX program's trainable parameters into the port's, in JAX's
    order; -> the port's parameters."""
    jps = jax_params([f._data for f in jfetch])
    tps = tstatic.parameters_of(tfetch)
    assert [tuple(p.shape) for p in jps] == [tuple(p.shape) for p in tps]
    with torch.no_grad():
        for j, t in zip(jps, tps):
            t.copy_(torch.from_numpy(np.array(j._data)))
    return tps


def load_jax_layer(tl, jl):
    tl.load_state_dict({k: torch.from_numpy(np.array(v.numpy()))
                        for k, v in jl.state_dict().items()})
    return tl


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class TestStaticGraph:
    def test_build_run_matches_eager(self, static_mode):
        w = _r(8, 4)
        feed = _r(5, 8, seed=1)

        def build(P, S):
            with S.program_guard(S.Program()):
                x = S.data("x", [None, 8], "float32")
                y = P.nn.functional.softmax(P.matmul(x, P.to_tensor(w)))
                return S.Executor().run(feed={"x": feed}, fetch_list=[y])[0]

        jout, tout = both_static(build)
        tp.disable_static()
        eager = tp.nn.functional.softmax(tp.matmul(tp.to_tensor(feed),
                                                   tp.to_tensor(w)))
        np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tout, _np(eager), rtol=RTOL, atol=ATOL)

    def test_nn_layers_stage_into_graph(self, static_mode):
        jp.seed(0)
        jm = jp.nn.Sequential(jp.nn.Linear(8, 16), jp.nn.ReLU(),
                              jp.nn.Linear(16, 3))
        tm = load_jax_layer(tp.nn.Sequential(
            tp.nn.Linear(8, 16), tp.nn.ReLU(), tp.nn.Linear(16, 3)), jm)
        feed = _r(4, 8, seed=2)
        outs = []
        for P, S, m in ((jp, jstatic, jm), (tp, tstatic, tm)):
            with S.program_guard(S.Program()):
                x = S.data("x", [4, 8], "float32")
                y = m(x)
                assert list(y.shape) == [4, 3]
                outs.append(S.Executor().run(feed={"x": feed},
                                             fetch_list=[y])[0])
        tp.disable_static()
        np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(outs[1], _np(tm(tp.to_tensor(feed))),
                                   rtol=RTOL, atol=ATOL)

    def test_dynamic_batch_retraces(self, static_mode):
        def build(P, S):
            x = S.data("xb", [None, 4], "float32")
            y = (x * 2.0).sum()
            exe = S.Executor()
            return [exe.run(feed={"xb": np.ones((bs, 4), np.float32)},
                            fetch_list=[y])[0] for bs in (2, 6)]

        jout, tout = both_static(build)
        for j, t, bs in zip(jout, tout, (2, 6)):
            np.testing.assert_allclose(t, 8.0 * bs)
            np.testing.assert_allclose(t, j)

    def test_static_nn_fc(self, static_mode):
        feed = _r(3, 8, seed=3)
        ys = []
        for S in (jstatic, tstatic):
            x = S.data("xf", [3, 8], "float32")
            h = S.nn.fc(x, 16, activation="relu")
            ys.append(S.nn.fc(h, 2))
        copy_fc_params([ys[0]], [ys[1]])
        jout = jstatic.Executor().run(feed={"xf": feed}, fetch_list=[ys[0]])
        tout = tstatic.Executor().run(feed={"xf": feed}, fetch_list=[ys[1]])
        assert tout[0].shape == (3, 2) and np.isfinite(tout[0]).all()
        np.testing.assert_allclose(tout[0], jout[0], rtol=RTOL, atol=ATOL)

    def test_missing_feed_and_concrete_touch_raise(self, static_mode):
        for S in (jstatic, tstatic):
            x = S.data("xm", [2, 2], "float32")
            y = x + 1.0
            with pytest.raises(S.StaticGraphError, match="missing feed"):
                S.Executor().run(feed={}, fetch_list=[y])
            with pytest.raises(S.StaticGraphError):
                y.numpy()

    def test_eager_unaffected_outside_and_after(self, static_mode):
        t = tp.to_tensor(np.ones((2,), np.float32))
        np.testing.assert_allclose(_np(t + t), [2.0, 2.0])
        j = jp.to_tensor(np.ones((2,), np.float32))
        np.testing.assert_allclose((j + j).numpy(), [2.0, 2.0])
        assert not tp.in_dynamic_mode() and not jp.in_dynamic_mode()
        tp.disable_static()
        jp.disable_static()
        assert tp.in_dynamic_mode() and jp.in_dynamic_mode()

    def test_save_inference_model_serves_via_predictor(self, tmp_path,
                                                       static_mode):
        from paddle_tpu import inference as jinf
        from paddle_tpu_torch import inference as tinf

        jp.seed(0)
        jm = jp.nn.Linear(8, 3)
        tm = load_jax_layer(tp.nn.Linear(8, 3), jm)
        for P, S, m, tag in ((jp, jstatic, jm, "j"), (tp, tstatic, tm, "t")):
            x = S.data("feats", [4, 8], "float32")
            y = P.nn.functional.softmax(m(x))
            S.save_inference_model(str(tmp_path / tag), [x], [y])
        tp.disable_static()
        jp.disable_static()
        feed = _r(4, 8, seed=4)
        got = {}
        for inf, tag in ((jinf, "j"), (tinf, "t")):
            pred = inf.create_predictor(inf.Config(str(tmp_path / tag)))
            assert pred.get_input_names() == ["feats"]
            pred.get_input_handle("feats").copy_from_cpu(feed)
            pred.run()
            got[tag] = pred.get_output_handle("output_0").copy_to_cpu()
        np.testing.assert_allclose(got["t"], got["j"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            got["t"], _np(tp.nn.functional.softmax(tm(tp.to_tensor(feed)))),
            rtol=RTOL, atol=ATOL)

    def test_load_inference_model(self, tmp_path, static_mode):
        jm = jp.nn.Linear(4, 2)
        tm = load_jax_layer(tp.nn.Linear(4, 2), jm)
        for S, m, tag in ((jstatic, jm, "j"), (tstatic, tm, "t")):
            x = S.data("inp", [2, 4], "float32")
            S.save_inference_model(str(tmp_path / tag), [x], [m(x)])
        tp.disable_static()
        jp.disable_static()
        feed = _r(2, 4, seed=5)
        outs = []
        for P, S, tag in ((jp, jstatic, "j"), (tp, tstatic, "t")):
            layer, names, _ = S.load_inference_model(str(tmp_path / tag))
            assert names == ["inp"]
            out = layer(P.to_tensor(feed))
            assert list(out.shape) == [2, 2]
            outs.append(_np(out) if P is tp else out.numpy())
        np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)

    def test_deep_sequential_graph_evaluates(self, static_mode):
        # deeper than Python's recursion limit: the walks are iterative
        def build(P, S):
            x = S.data("xd", [2, 2], "float32")
            y = x
            for _ in range(1500):
                y = y + 1.0
            return S.Executor().run(
                feed={"xd": np.zeros((2, 2), np.float32)},
                fetch_list=[y])[0]

        jout, tout = both_static(build)
        np.testing.assert_allclose(tout, np.full((2, 2), 1500.0))
        np.testing.assert_array_equal(tout, jout)

    def test_namedtuple_output_op_stages(self, static_mode):
        feed = _r(4, 4, seed=5)

        def build(P, S):
            x = S.data("xs", [4, 4], "float32")
            u, s, vt = P.linalg.svd(x)
            return S.Executor().run(feed={"xs": feed}, fetch_list=[s])[0]

        jout, tout = both_static(build)
        np.testing.assert_allclose(tout, np.linalg.svd(feed)[1], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-5)

    def test_fc_layers_get_distinct_weights(self, static_mode):
        def build(P, S):
            P.seed(123)
            x = S.data("xw", [2, 8], "float32")
            h1 = S.nn.fc(x, 8)
            h2 = S.nn.fc(h1, 8)
            return S.Executor().run(
                feed={"xw": np.ones((2, 8), np.float32)},
                fetch_list=[h1, h2])

        for out in both_static(build):
            assert not np.allclose(out[0], out[1])

    def test_name_scope_and_amp_module(self, static_mode):
        for S in (jstatic, tstatic):
            with S.name_scope("block"):
                pass
            assert callable(S.amp.decorate)
            assert callable(S.amp.AutoMixedPrecisionLists)

    def test_tensor_namespace_in_dynamic_mode_tracks_static(self,
                                                            static_mode):
        import paddle_tpu.tensor as JT
        import paddle_tpu_torch.tensor as TT

        assert JT.in_dynamic_mode() is False and TT.in_dynamic_mode() is False
        tp.disable_static()
        jp.disable_static()
        assert JT.in_dynamic_mode() is True and TT.in_dynamic_mode() is True

    def test_fc_dynamic_batch_with_flatten(self, static_mode):
        ys = []
        for S in (jstatic, tstatic):
            x = S.data("xfd", [None, 2, 3], "float32")
            ys.append(S.nn.fc(x, 4))
        copy_fc_params([ys[0]], [ys[1]])
        for bs in (2, 5):
            feed = {"xfd": _r(bs, 2, 3, seed=bs)}
            jout = jstatic.Executor().run(feed=feed, fetch_list=[ys[0]])[0]
            tout = tstatic.Executor().run(feed=feed, fetch_list=[ys[1]])[0]
            assert tout.shape == (bs, 4)
            np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)

    def test_save_dynamic_batch_serves_any_size(self, tmp_path,
                                                static_mode):
        from paddle_tpu import inference as jinf
        from paddle_tpu_torch import inference as tinf

        jp.seed(1)
        jm = jp.nn.Linear(4, 2)
        tm = load_jax_layer(tp.nn.Linear(4, 2), jm)
        for S, m, tag in ((jstatic, jm, "j"), (tstatic, tm, "t")):
            x = S.data("dynb", [None, 4], "float32")
            S.save_inference_model(str(tmp_path / tag), [x], [m(x)])
        tp.disable_static()
        jp.disable_static()
        preds = {tag: inf.create_predictor(inf.Config(str(tmp_path / tag)))
                 for inf, tag in ((jinf, "j"), (tinf, "t"))}
        for bs in (1, 3, 7):
            feed = _r(bs, 4, seed=bs)
            tout = preds["t"].run([feed])[0]
            assert tout.shape == (bs, 2)
            np.testing.assert_allclose(tout, preds["j"].run([feed])[0],
                                       rtol=RTOL, atol=ATOL)

    def test_symbolic_tensor_protocols(self, static_mode):
        x = tstatic.data("xp", [2, 2], "float32")
        y = x * 3.0
        assert copy.deepcopy(x) is x        # a graph value is shared
        for read in (lambda: np.asarray(y.numpy()), lambda: float(y),
                     lambda: int(y), lambda: bool(y), lambda: len(y),
                     lambda: list(y), lambda: y.item(), lambda: y.tolist()):
            with pytest.raises(tstatic.StaticGraphError):
                read()
        jx = jstatic.data("xp", [2, 2], "float32")
        copy.deepcopy(jx)
        with pytest.raises(jstatic.StaticGraphError):
            float((jx * 3.0)._data)


def _problem():
    rng = np.random.RandomState(0)
    X = rng.randn(64, 8).astype(np.float32)
    Y = (X @ rng.randn(8, 1).astype(np.float32)
         + 0.1 * rng.randn(64, 1).astype(np.float32))
    return X, Y


def _fc_regression(P, S):
    x = S.data("x", [None, 8], "float32")
    y = S.data("y", [None, 1], "float32")
    pred = S.nn.fc(x, 1)
    return x, y, P.mean((pred - y) ** 2)


class TestStaticTraining:
    def _eager_losses(self, ctor, w0, b0, X, Y, steps):
        model = tp.nn.Linear(8, 1)
        with torch.no_grad():
            model.weight.copy_(w0)
            model.bias.copy_(b0)
        opt = ctor(tp, model.parameters())
        losses = []
        for _ in range(steps):
            loss = tp.nn.functional.mse_loss(model(tp.to_tensor(X)),
                                             tp.to_tensor(Y))
            losses.append(loss.item())
            loss.backward()
            opt.step()
            opt.clear_grad()
        return losses

    @pytest.mark.parametrize("which", ["sgd", "adam"])
    def test_minimize_matches_eager(self, which, static_mode):
        X, Y = _problem()

        def ctor(P, ps=None):
            cls = {"sgd": P.optimizer.SGD, "adam": P.optimizer.Adam}[which]
            return cls(learning_rate=0.05, parameters=ps)

        progs, losses = [], {}
        for P, S in ((jp, jstatic), (tp, tstatic)):
            main = S.Program()
            with S.program_guard(main):
                progs.append((main,) + _fc_regression(P, S))
        copy_fc_params([progs[0][3]], [progs[1][3]])
        for (P, S), (main, x, y, loss) in zip(((jp, jstatic),
                                               (tp, tstatic)), progs):
            with S.program_guard(main):
                opt = ctor(P)                  # parameters=None: static
                _, pg = opt.minimize(loss)
                if P is tp:
                    w0, b0 = (pg[0][0].detach().clone(),
                              pg[1][0].detach().clone())
                exe = S.Executor()
                exe.run(S.default_startup_program())
                losses[P] = [float(exe.run(main, feed={"x": X, "y": Y},
                                           fetch_list=[loss])[0])
                             for _ in range(15)]
        tp.disable_static()
        ref = self._eager_losses(ctor, w0, b0, X, Y, 15)
        assert losses[tp][-1] < 0.5 * losses[tp][0]
        np.testing.assert_allclose(losses[tp], losses[jp], rtol=2e-5,
                                   atol=1e-6)
        assert losses[tp] == ref           # static step == eager step

    def test_append_backward_grads_numerically_correct(self, static_mode):
        X, Y = _problem()
        progs = [_fc_regression(P, S) for P, S in ((jp, jstatic),
                                                   (tp, tstatic))]
        copy_fc_params([progs[0][2]], [progs[1][2]])
        got = []
        for S, (x, y, loss) in zip((jstatic, tstatic), progs):
            pairs = S.append_backward(loss)
            assert len(pairs) == 2
            (w, gw), (b, gb) = pairs
            got.append(S.Executor().run(feed={"x": X, "y": Y},
                                        fetch_list=[gw, gb]))
        w, b = (_np(p) for p in tstatic.parameters_of([progs[1][2]]))
        r = X @ w + b - Y
        np.testing.assert_allclose(got[1][0], 2 * X.T @ r / len(X),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got[1][1], 2 * r.mean(0), rtol=1e-4,
                                   atol=1e-5)
        for t, j in zip(got[1], got[0]):
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)

    def test_clone_for_test_strips_train_op(self, static_mode):
        X, Y = _problem()
        progs, evals = [], {}
        for P, S in ((jp, jstatic), (tp, tstatic)):
            main = S.Program()
            with S.program_guard(main):
                progs.append((main,) + _fc_regression(P, S))
        copy_fc_params([progs[0][3]], [progs[1][3]])
        for (P, S), (main, x, y, loss) in zip(((jp, jstatic),
                                               (tp, tstatic)), progs):
            with S.program_guard(main):
                P.optimizer.SGD(learning_rate=0.1).minimize(loss)
                test_prog = main.clone(for_test=True)
                exe = S.Executor()
                feed = {"x": X, "y": Y}
                before = float(exe.run(test_prog, feed=feed,
                                       fetch_list=[loss])[0])
                for _ in range(10):
                    exe.run(main, feed=feed, fetch_list=[loss])
                after = float(exe.run(test_prog, feed=feed,
                                      fetch_list=[loss])[0])
                again = float(exe.run(test_prog, feed=feed,
                                      fetch_list=[loss])[0])
            evals[P] = (before, after, again)
        before, after, again = evals[tp]
        assert after < before and after == again
        np.testing.assert_allclose(evals[tp], evals[jp], rtol=2e-5,
                                   atol=1e-6)

    def test_grad_clip_and_lr_schedule_apply(self, static_mode):
        X, Y = _problem()
        progs, losses = [], {}
        for P, S in ((jp, jstatic), (tp, tstatic)):
            main = S.Program()
            with S.program_guard(main):
                progs.append((main,) + _fc_regression(P, S))
        copy_fc_params([progs[0][3]], [progs[1][3]])
        for (P, S), (main, x, y, loss) in zip(((jp, jstatic),
                                               (tp, tstatic)), progs):
            with S.program_guard(main):
                sched = P.optimizer.lr.StepDecay(learning_rate=0.1,
                                                 step_size=2, gamma=0.5)
                P.optimizer.SGD(
                    learning_rate=sched,
                    grad_clip=P.nn.ClipGradByGlobalNorm(0.01)).minimize(loss)
                exe = S.Executor()
                out = []
                for _ in range(6):
                    out.append(float(exe.run(feed={"x": X, "y": Y},
                                             fetch_list=[loss])[0]))
                    sched.step()
            losses[P] = out
        assert losses[tp][-1] < losses[tp][0]
        np.testing.assert_allclose(losses[tp], losses[jp], rtol=2e-5,
                                   atol=1e-6)


class TestControlFlowStaging:
    def test_cond_eager_and_jit(self):
        xp = np.array([1.0, 2.0], np.float32)
        xn = np.array([-1.0, -2.0], np.float32)
        outs = {}
        for P, S in ((jp, jstatic), (tp, tstatic)):
            def branchy(x, P=P, S=S):
                return S.nn.cond(P.mean(x) > 0, lambda: x * 2.0,
                                 lambda: x - 1.0)

            jb = P.jit.to_static(branchy)
            outs[P] = [_np(f(P.to_tensor(v))) if P is tp
                       else f(P.to_tensor(v)).numpy()
                       for f in (branchy, jb) for v in (xp, xn)]
        for got, want, ref in zip(outs[tp], outs[jp],
                                  (xp * 2, xn - 1, xp * 2, xn - 1)):
            np.testing.assert_allclose(got, ref)
            np.testing.assert_allclose(got, want)

    def test_cond_gradients_flow_through_taken_branch(self):
        grads = []
        for P, S in ((jp, jstatic), (tp, tstatic)):
            x = P.to_tensor(np.array([3.0], np.float32), stop_gradient=False)
            out = S.nn.cond(x.sum() > 0, lambda: x * 5.0, lambda: x * 7.0)
            out.sum().backward()
            grads.append(_np(x.grad) if P is tp else x.grad.numpy())
        np.testing.assert_allclose(grads[1], [5.0])
        np.testing.assert_allclose(grads[1], grads[0])

    def test_cond_structures_and_mismatch(self):
        for P, S in ((jp, jstatic), (tp, tstatic)):
            x = P.to_tensor(np.ones((2,), np.float32))
            a, b = S.nn.cond(x.sum() > 0, lambda: (x, x * 2),
                             lambda: (x * 3, x * 4))
            np.testing.assert_allclose(_np(b) if P is tp else b.numpy(),
                                       [2, 2])
            with pytest.raises(Exception, match="different structures"):
                P.jit.to_static(
                    lambda t, S=S: S.nn.cond(t.sum() > 0, lambda: (t, t),
                                             lambda: t))(x)

    def test_while_loop_eager_and_jit(self):
        for P, S in ((jp, jstatic), (tp, tstatic)):
            def count_to(limit, P=P, S=S):
                i = P.to_tensor(np.asarray(0, np.int32))
                s = P.to_tensor(np.asarray(0, np.int32))
                i, s = S.nn.while_loop(lambda i, s: i < limit,
                                       lambda i, s: (i + 1, s + i), [i, s])
                return s

            five = P.to_tensor(np.asarray(5, np.int32))
            assert int(count_to(five)) == 10
            jc = P.jit.to_static(count_to)
            assert int(jc(five)) == 10
            assert int(jc(P.to_tensor(np.asarray(7, np.int32)))) == 21

    def test_case_and_switch_case(self):
        for P, S in ((jp, jstatic), (tp, tstatic)):
            x = P.to_tensor(np.asarray(2.0, np.float32))
            out = S.nn.case([(x < 1, lambda: x * 10),
                             (x < 3, lambda: x * 100)],
                            default=lambda: x * 1000)
            np.testing.assert_allclose(float(out), 200.0)
            out2 = S.nn.switch_case(
                P.to_tensor(np.asarray(1, np.int32)),
                {0: lambda: x * 1, 1: lambda: x * 2, 2: lambda: x * 3})
            np.testing.assert_allclose(float(out2), 4.0)

    def test_cond_stages_into_static_program(self, static_mode):
        xp = np.array([1, 2, 3, 4], np.float32)

        def build(P, S):
            with S.program_guard(S.Program()):
                x = S.data("cf_x", [4], "float32")
                out = S.nn.cond(P.mean(x) > 0, lambda: x * 2.0,
                                lambda: x - 1.0)
                exe = S.Executor()
                return [exe.run(feed={"cf_x": v}, fetch_list=[out])[0]
                        for v in (xp, -xp)]

        jout, tout = both_static(build)
        np.testing.assert_allclose(tout[0], xp * 2)
        np.testing.assert_allclose(tout[1], -xp - 1)
        np.testing.assert_allclose(tout, jout)

    def test_while_loop_stages_into_static_program(self, static_mode):
        def build(P, S):
            with S.program_guard(S.Program()):
                n = S.data("cf_n", [], "int32")
                i = P.to_tensor(np.asarray(0, np.int32))
                s = P.to_tensor(np.asarray(0, np.int32))
                _, s_out, _ = S.nn.while_loop(
                    lambda i, s, lim: i < lim,
                    lambda i, s, lim: (i + 1, s + i, lim), [i, s, n])
                exe = S.Executor()
                return [int(exe.run(feed={"cf_n": np.asarray(k, np.int32)},
                                    fetch_list=[s_out])[0]) for k in (6, 9)]

        jout, tout = both_static(build)
        assert tout == [15, 36] and tout == jout

    def test_branchy_model_trains_eagerly(self):
        jlin = jp.nn.Linear(4, 4)
        tlin = load_jax_layer(tp.nn.Linear(4, 4), jlin)
        X = np.random.RandomState(0).randn(8, 4).astype(np.float32)
        losses = {}
        for P, S, lin in ((jp, jstatic, jlin), (tp, tstatic, tlin)):
            opt = P.optimizer.SGD(learning_rate=0.1,
                                  parameters=lin.parameters())
            out = []
            for _ in range(10):
                h = lin(P.to_tensor(X))
                y = S.nn.cond(P.mean(h) > 0, lambda: P.tanh(h),
                              lambda: h * 0.5)
                loss = (y ** 2).mean()
                out.append(float(loss))
                loss.backward()
                opt.step()
                opt.clear_grad()
            losses[P] = out
        assert losses[tp][-1] < losses[tp][0]
        np.testing.assert_allclose(losses[tp], losses[jp], rtol=2e-5,
                                   atol=1e-6)


class TestExecutorStructuralCache:
    def _build_and_run(self, P, S, exe, scale, feed):
        with S.program_guard(S.Program()):
            x = S.data("sc_x", [None, 4], "float32")
            w = P.to_tensor(np.arange(8, dtype=np.float32).reshape(4, 2)
                            * scale)
            out = P.nn.functional.softmax(P.matmul(x, w))
            return exe.run(feed={"sc_x": feed}, fetch_list=[out])[0]

    def test_rebuilt_program_hits_cache(self, static_mode):
        feed = _r(3, 4)
        for P, S in ((jp, jstatic), (tp, tstatic)):
            exe = S.Executor()
            r1 = self._build_and_run(P, S, exe, 1.0, feed)
            n1 = len(exe._cache)
            r2 = self._build_and_run(P, S, exe, 1.0, feed)
            assert len(exe._cache) == n1
            np.testing.assert_allclose(r1, r2, rtol=1e-6)
            r3 = self._build_and_run(P, S, exe, 2.0, feed)
            assert len(exe._cache) == n1 + 1
            assert not np.allclose(r1, r3)
            if P is jp:
                ref = (r1, r3)
        np.testing.assert_allclose(r1, ref[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r3, ref[1], rtol=RTOL, atol=ATOL)

    def test_trained_params_ride_positionally_on_cache_hit(self,
                                                           static_mode):
        feed = np.ones((2, 4), np.float32)
        jouts, touts = [], []
        jexe, texe = jstatic.Executor(), tstatic.Executor()
        for seed in (1, 2):
            ys = []
            for P, S in ((jp, jstatic), (tp, tstatic)):
                with S.program_guard(S.Program()):
                    P.seed(seed)
                    x = S.data("pp_x", [None, 4], "float32")
                    ys.append(S.nn.fc(x, 3))
            copy_fc_params([ys[0]], [ys[1]])
            jouts.append(jexe.run(feed={"pp_x": feed}, fetch_list=[ys[0]])[0])
            touts.append(texe.run(feed={"pp_x": feed}, fetch_list=[ys[1]])[0])
        assert len(texe._cache) == 1 and len(jexe._cache) == 1
        assert not np.allclose(touts[0], touts[1])
        np.testing.assert_allclose(touts, jouts, rtol=RTOL, atol=ATOL)

    def test_lru_bound(self, static_mode):
        feed = np.ones((1, 4), np.float32)
        for P, S in ((jp, jstatic), (tp, tstatic)):
            exe = S.Executor()
            exe.CACHE_SIZE = 3
            for scale in (1.0, 2.0, 3.0, 4.0, 5.0):
                self._build_and_run(P, S, exe, scale, feed)
            assert len(exe._cache) <= 3


class TestArtifactOutputNames:
    def test_names_roundtrip_through_predictor(self, tmp_path, static_mode):
        from paddle_tpu import inference as jinf
        from paddle_tpu_torch import inference as tinf

        for P, S, tag in ((jp, jstatic, "j"), (tp, tstatic, "t")):
            with S.program_guard(S.Program()):
                x = S.data("feat", [None, 4], "float32")
                logits = P.matmul(x, P.to_tensor(np.eye(4, 3,
                                                        dtype=np.float32)))
                logits.name = "logits"
                probs = P.nn.functional.softmax(logits)
                probs.name = "probs"
                S.save_inference_model(str(tmp_path / tag), [x],
                                       [logits, probs])
        tp.disable_static()
        jp.disable_static()
        got = {}
        for inf, tag in ((jinf, "j"), (tinf, "t")):
            pred = inf.create_predictor(inf.Config(str(tmp_path / tag)))
            assert pred.get_output_names() == ["logits", "probs"]
            pred.get_input_handle("feat").copy_from_cpu(
                _r(2, 4, seed=9))
            pred.run()
            got[tag] = [pred.get_output_handle(n).copy_to_cpu()
                        for n in ("logits", "probs")]
            with pytest.raises(KeyError):
                pred.get_output_handle("output_0")
        lg, pb = got["t"]
        assert lg.shape == (2, 3) and pb.shape == (2, 3)
        np.testing.assert_allclose(pb.sum(-1), 1.0, rtol=1e-5)
        for t, j in zip(got["t"], got["j"]):
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)

    def test_unnamed_fetches_default_and_jit_save_unaffected(
            self, tmp_path, static_mode):
        from paddle_tpu import inference as jinf
        from paddle_tpu_torch import inference as tinf

        for S, tag in ((jstatic, "j"), (tstatic, "t")):
            with S.program_guard(S.Program()):
                x = S.data("u_x", [None, 4], "float32")
                S.save_inference_model(str(tmp_path / tag), [x], [x * 2.0])
        tp.disable_static()
        jp.disable_static()
        for inf, tag in ((jinf, "j"), (tinf, "t")):
            pred = inf.create_predictor(inf.Config(str(tmp_path / tag)))
            assert pred.get_output_names() == ["output_0"]
            np.testing.assert_allclose(
                pred.run([np.ones((3, 4), np.float32)])[0], 2.0)


class TestCondGradSafety:
    def test_eager_cond_executes_one_branch_no_nan(self):
        grads = []
        for P, S in ((jp, jstatic), (tp, tstatic)):
            x = P.to_tensor(np.array([0.0], np.float32), stop_gradient=False)
            out = S.nn.cond(x.sum() > 0, lambda: P.sqrt(x), lambda: x * 2.0)
            out.sum().backward()
            grads.append(_np(x.grad) if P is tp else x.grad.numpy())
        np.testing.assert_allclose(grads[1], [2.0])
        np.testing.assert_allclose(grads[1], grads[0])

    def test_cond_dtype_mismatch_raises_under_tracing(self):
        for P, S in ((jp, jstatic), (tp, tstatic)):
            def f(x, P=P, S=S):
                return S.nn.cond(x.sum() > 0,
                                 lambda: P.cast(x, "int32"),
                                 lambda: x * 1.0)

            with pytest.raises(Exception, match="matching dtypes"):
                P.jit.to_static(f)(P.to_tensor(np.ones(2, np.float32)))


# ------------------------------------------------------------- BERT MLM

BERT_B, BERT_S = 4, 16


def _bert_config(P):
    return P.models.bert.BertConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=32, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)


def _bert_batches(n):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(n):
        ids = rng.randint(0, 120, (BERT_B, BERT_S)).astype(np.int32)
        types = (np.arange(BERT_S)[None] >= 9).repeat(BERT_B, 0) \
            .astype(np.int32)
        labels = np.where(rng.rand(BERT_B, BERT_S) < 0.3, ids,
                          -100).astype(np.int32)
        out.append({"ids": ids, "types": types, "labels": labels})
    return out


def _bert_models():
    from paddle_tpu.models.bert import BertForMaskedLM as JBert
    from paddle_tpu_torch.convert import state_from_jax
    from paddle_tpu_torch.models.bert import BertForMaskedLM as TBert

    jp.seed(5)
    jm = JBert(_bert_config(jp))
    np_state = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}

    def port_model():
        m = TBert(_bert_config(tp), device="cpu")
        m.load_state_dict(state_from_jax(np_state, m))
        return m

    return jm, port_model


def _bert_static(P, S, m, batch):
    ids = S.data("ids", batch, "int32")
    types = S.data("types", batch, "int32")
    labels = S.data("labels", batch, "int32")
    loss, _ = m(ids, types, labels=labels)
    return loss


def _jax_eager_steps(batches):
    """JAX's AdamW steps from the same weights through its
    ``jit.TrainStep`` (one compiled step; eager op by op costs minutes)
    -> (losses, state)."""
    from paddle_tpu.models.bert import BertForMaskedLM as JBert

    jp.seed(5)
    m = JBert(_bert_config(jp))
    opt = jp.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                             epsilon=1e-6, parameters=m.parameters())

    def loss_fn(net, ids, types, labels):
        return net(ids, types, labels=labels)[0]

    step = jp.jit.TrainStep(m, loss_fn, opt)
    losses = [float(step(*(jp.to_tensor(b[k]) for k in
                           ("ids", "types", "labels"))).numpy())
              for b in batches]
    return losses, {k: np.array(v.numpy()) for k, v in
                    m.state_dict().items()}


class TestStaticBert:
    def test_three_adamw_steps_match_jax_and_eager(self, static_mode):
        """Three static AdamW steps: bit for bit the port's eager steps,
        and within 2e-5 of JAX's compiled eager steps (losses; each
        parameter within 2e-5 of its tensor's largest value plus 1 % of
        a step: the key bias's gradient is f32 noise, which Adam turns
        into a random fraction of a step, ``test_torch_bert.py``), which
        JAX's static steps should equal; JAX's static steps equal them
        on the first loss only (the next test)."""
        jm, port_model = _bert_models()
        tm, em = port_model(), port_model()
        batches = _bert_batches(3)
        losses = {}
        for P, S, m in ((jp, jstatic, jm), (tp, tstatic, tm)):
            with S.program_guard(S.Program(), S.Program()):
                loss = _bert_static(P, S, m, [BERT_B, BERT_S])
                opt = P.optimizer.AdamW(learning_rate=1e-3,
                                        weight_decay=0.01, epsilon=1e-6)
                opt.minimize(loss)
                exe = S.Executor()
                exe.run(S.default_startup_program())
                losses[P] = [float(exe.run(feed=b, fetch_list=[loss])[0])
                             for b in batches]
        tp.disable_static()
        jp.disable_static()
        eopt = tp.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                  epsilon=1e-6, parameters=em.parameters())
        eager = []
        for b in batches:
            loss, _ = em(*(torch.from_numpy(b[k]) for k in
                           ("ids", "types")),
                         labels=torch.from_numpy(b["labels"]))
            eager.append(loss.item())
            loss.backward()
            eopt.step()
            eopt.clear_grad()
        assert losses[tp] == eager
        for (n, a), b in zip(tm.named_parameters(), em.parameters()):
            assert torch.equal(a, b), n
        np.testing.assert_allclose(losses[tp][0], losses[jp][0], rtol=2e-5)
        jlosses, jstate = _jax_eager_steps(batches)
        np.testing.assert_allclose(losses[tp], jlosses, rtol=2e-5,
                                   atol=1e-6)
        for k, v in tm.state_dict().items():
            want = jstate[k]
            np.testing.assert_allclose(
                _np(v), want, rtol=0,
                atol=2e-5 * np.abs(want).max() + 0.01 * 1e-3, err_msg=k)

    def test_jax_static_trains_build_time_copies(self, static_mode):
        """Reference caveat (ROADMAP.md, Queue 3): JAX's recorder runs an
        op on parameters alone eagerly, so its static BERT differentiates
        the build's values of the concatenated q/k/v weights, the
        transposed MLM decoder weight and the gathered position
        embeddings, not the parameters: ``minimize`` lists 35 of the 42,
        and the losses after the first step leave JAX's eager ones.  The
        port records those ops, lists all 42 and trains them."""
        jm, port_model = _bert_models()
        tm = port_model()
        pairs = {}
        for P, S, m in ((jp, jstatic, jm), (tp, tstatic, tm)):
            with S.program_guard(S.Program(), S.Program()):
                loss = _bert_static(P, S, m, [BERT_B, BERT_S])
                _, pairs[P] = P.optimizer.AdamW(
                    learning_rate=1e-3).minimize(loss)
        real = {id(p) for p in jm.parameters()}
        assert len(list(jm.parameters())) == 42
        assert sum(id(p) in real for p, _ in pairs[jp]) == 29
        assert {id(p) for p, _ in pairs[tp]} == \
            {id(p) for p in tm.parameters()}


class TestStaticBertBatch:
    def test_batch_baked_at_build(self, static_mode):
        """A ``None`` batch stands in as 1 at build, and the attention's
        reshape reads it: both packages fail to run batch 4."""
        jm, port_model = _bert_models()
        tm = port_model()
        feed = _bert_batches(1)[0]
        for P, S, m in ((jp, jstatic, jm), (tp, tstatic, tm)):
            with S.program_guard(S.Program()):
                loss = _bert_static(P, S, m, [None, BERT_S])
                with pytest.raises((TypeError, RuntimeError),
                                   match="reshape|shape"):
                    S.Executor().run(feed=feed, fetch_list=[loss])


class TestStaticDropout:
    def test_port_draws_a_mask_per_run_jax_one_per_build(self, static_mode):
        """JAX's static dropout draws its key once at build
        (``paddle_tpu/nn/functional/common.py:30``), so every run reuses
        one mask; the port's records the draw, and its generator gives a
        new mask each run, as Paddle does."""
        feed = {"dx": np.ones((64, 64), np.float32)}
        masks = {}
        for P, S in ((jp, jstatic), (tp, tstatic)):
            with S.program_guard(S.Program()):
                P.seed(3)
                x = S.data("dx", [64, 64], "float32")
                y = P.nn.functional.dropout(x, p=0.5, training=True)
                exe = S.Executor()
                masks[P] = [exe.run(feed=feed, fetch_list=[y])[0] != 0
                            for _ in range(2)]
        j1, j2 = masks[jp]
        t1, t2 = masks[tp]
        np.testing.assert_array_equal(j1, j2)
        assert not np.array_equal(t1, t2)
        for m in (t1, t2):
            assert 0.4 < m.mean() < 0.6


class TestConvertedIf:
    def test_converted_if_on_a_symbolic_tensor_stages(self, static_mode):
        """A dy2static-converted ``if`` whose predicate is a static
        Program's symbolic tensor records both branches and a select
        (JAX's ``_is_traced`` holds for its symbols too)."""
        from paddle_tpu.jit.dy2static import convert_to_static as jconv
        from paddle_tpu_torch.jit.dy2static import convert_to_static as tconv

        def branchy(x):
            if x.mean() > 0:
                y = x * 2.0
            else:
                y = x - 1.0
            return y

        xp = np.array([1, 2, 3, 4], np.float32)
        outs = {}
        for P, S, conv in ((jp, jstatic, jconv), (tp, tstatic, tconv)):
            with S.program_guard(S.Program()):
                x = S.data("ci_x", [4], "float32")
                y = conv(branchy)(x)
                exe = S.Executor()
                outs[P] = [exe.run(feed={"ci_x": v}, fetch_list=[y])[0]
                           for v in (xp, -xp)]
        np.testing.assert_allclose(outs[tp][0], xp * 2)
        np.testing.assert_allclose(outs[tp][1], -xp - 1)
        np.testing.assert_allclose(outs[tp], outs[jp])
