"""The port's static meta-optimizer (``distributed/fleet/meta_optimizers/
static_meta_optimizer.py``) and ``static.amp.decorate`` on the CPU,
against the JAX package's on the same programs and weights: the
single-card classes of ``tests/test_static_meta_optimizers.py``
(``TestStaticAMP``, ``TestStaticAmpDecorate``, ``TestStaticRecompute``,
``TestGradientMerge``, ``TestLambSwap``, ``TestAmpRewriteIdempotence``).
The port builds ``StaticMetaOptimizer`` directly or goes through
``static.amp.decorate`` (its ``fleet.distributed_optimizer`` waits for
the mesh, ROADMAP.md Queue 1 item 8); JAX goes through
``fleet.distributed_optimizer``.

Tolerances: f32 programs 2e-5 relative and 1e-6 absolute (as JAX's own
cases); bfloat16 programs 2e-2 relative (bf16 keeps 8 bits, and the two
packages' CPU matmuls round their bf16 results apart); float16 programs
5e-3 relative; loss scales exactly.  Recompute against no recompute is
bit for bit.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.static as jstatic
import paddle_tpu_torch as tp
import paddle_tpu_torch.static as tstatic
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.static.graph import _collect_params as jax_params
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
    static_meta_optimizer as tmeta,
)

from _torch_port_util import one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
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


def _problem(n=64, d=8):
    rng = np.random.RandomState(0)
    X = rng.randn(n, d).astype(np.float32)
    Y = (X @ rng.randn(d, 1).astype(np.float32)
         + 0.1 * rng.randn(n, 1).astype(np.float32))
    return X, Y


def _mlp_program(P, S, hidden=16, seed=0):
    """x -> fc -> relu -> fc -> mse in the current program guard ->
    (x, y, hidden activation, loss)."""
    P.seed(seed)
    x = S.data("x", [None, 8], "float32")
    y = S.data("y", [None, 1], "float32")
    h = P.nn.functional.relu(S.nn.fc(x, hidden))
    pred = S.nn.fc(h, 1)
    loss = P.mean((pred - y) ** 2)
    return x, y, h, loss


def _fc_program(P, S, seed):
    P.seed(seed)
    x = S.data("x", [None, 8], "float32")
    y = S.data("y", [None, 1], "float32")
    return x, y, P.mean((S.nn.fc(x, 1) - y) ** 2)


def copy_params(jloss, tloss):
    """The JAX program's parameters into the port's, in JAX's order ->
    the port's parameters."""
    jps = jax_params([jloss._data])
    tps = tstatic.parameters_of([tloss])
    assert [tuple(p.shape) for p in jps] == [tuple(p.shape) for p in tps]
    with torch.no_grad():
        for j, t in zip(jps, tps):
            t.copy_(torch.from_numpy(np.array(j._data)))
    return tps


def build_pair(builder):
    """``builder(P, S)`` under a fresh program of each package, weights
    copied from JAX's -> {package: (program, outputs)}."""
    out = {}
    for P, S in ((jp, jstatic), (tp, tstatic)):
        prog = S.Program()
        with S.program_guard(prog):
            out[P] = (prog, builder(P, S))
    copy_params(out[jp][1][-1], out[tp][1][-1])
    return out


def port_meta(opt, strat):
    return tmeta.StaticMetaOptimizer(opt, strat)


def jax_meta(opt, strat):
    return jfleet.distributed_optimizer(opt, strategy=strat)


def _strategy(F, **attrs):
    s = F.DistributedStrategy()
    for k, v in attrs.items():
        setattr(s, k, v)
    return s


def _run(P, S, prog, feeds, fetch, steps, **kw):
    with S.program_guard(prog):
        exe = S.Executor()
        return [exe.run(feed=f, fetch_list=fetch, **kw)
                for f in (feeds if isinstance(feeds, list)
                          else [feeds] * steps)]


def _f(v):
    return float(v.float().item()) if isinstance(v, torch.Tensor) \
        else float(np.asarray(v, np.float32))


class TestStaticAMP:
    def test_bf16_rewrite_casts_white_ops_and_trains(self, static_mode):
        X, Y = _problem()
        progs = build_pair(_mlp_program)
        losses = {}
        for P, S, F, meta in ((jp, jstatic, jfleet, jax_meta),
                              (tp, tstatic, tfleet, port_meta)):
            prog, (x, y, h, loss) = progs[P]
            with S.program_guard(prog):
                opt = meta(P.optimizer.SGD(learning_rate=0.05),
                           _strategy(F, amp=True))
                opt.minimize(loss)
            runs = _run(P, S, prog, {"x": X, "y": Y}, [loss, h], 15,
                        return_numpy=False)
            losses[P] = [_f(lv) for lv, _ in runs]
            if P is tp:
                assert isinstance(opt, tmeta.StaticMetaOptimizer)
                lv, hv = runs[-1]
                assert hv.dtype == torch.bfloat16      # the white matmul
                assert lv.dtype == torch.float32       # the black mean
        assert losses[tp][-1] < 0.5 * losses[tp][0]
        np.testing.assert_allclose(losses[tp], losses[jp], rtol=2e-2)

    def test_fp16_dynamic_loss_scaling_skips_and_recovers(self, static_mode):
        X, Y = _problem()
        progs = build_pair(_mlp_program)
        got = {}
        for P, S, F, meta in ((jp, jstatic, jfleet, jax_meta),
                              (tp, tstatic, tfleet, port_meta)):
            strat = _strategy(F, amp=True)
            strat.amp_configs = {"use_bf16": False,
                                 "init_loss_scaling": 1e9,
                                 "decr_every_n_nan_or_inf": 1,
                                 "incr_every_n_steps": 1000}
            prog, (x, y, h, loss) = progs[P]
            with S.program_guard(prog):
                opt = meta(P.optimizer.SGD(learning_rate=0.05), strat)
                _, pairs = opt.minimize(loss)
                w = pairs[0][0]
                w0 = np.array(w.detach() if P is tp else w._data)
                exe = S.Executor()
                assert opt.loss_scaling == pytest.approx(1e9)
                exe.run(feed={"x": X, "y": Y}, fetch_list=[loss])
                scales = [opt.loss_scaling]
                np.testing.assert_array_equal(
                    np.array(w.detach() if P is tp else w._data), w0)
                losses = []
                for _ in range(30):
                    losses.append(_f(exe.run(feed={"x": X, "y": Y},
                                             fetch_list=[loss])[0]))
                    scales.append(opt.loss_scaling)
                moved = not np.array_equal(
                    np.array(w.detach() if P is tp else w._data), w0)
            got[P] = (scales, losses, moved)
        scales, losses, moved = got[tp]
        assert scales[0] == pytest.approx(5e8)
        assert scales[-1] < 1e5 and moved
        assert losses[-1] < 0.5 * losses[0]
        assert scales == got[jp][0]
        np.testing.assert_allclose(losses, got[jp][1], rtol=5e-3)

    def test_fp16_scale_grows_after_good_steps(self, static_mode):
        X, Y = _problem()
        progs = build_pair(_mlp_program)
        for P, S, F, meta in ((jp, jstatic, jfleet, jax_meta),
                              (tp, tstatic, tfleet, port_meta)):
            strat = _strategy(F, amp=True)
            strat.amp_configs = {"use_bf16": False,
                                 "init_loss_scaling": 1024.0,
                                 "incr_every_n_steps": 3, "incr_ratio": 2.0}
            prog, (x, y, h, loss) = progs[P]
            with S.program_guard(prog):
                opt = meta(P.optimizer.SGD(learning_rate=0.01), strat)
                opt.minimize(loss)
            _run(P, S, prog, {"x": X, "y": Y}, [loss], 3)
            assert opt.loss_scaling == pytest.approx(2048.0)


class TestStaticAmpDecorate:
    def test_reference_decorate_workflow(self, static_mode):
        X, Y = _problem()
        progs = build_pair(_mlp_program)
        losses = {}
        for P, S in ((jp, jstatic), (tp, tstatic)):
            prog, (x, y, h, loss) = progs[P]
            with S.program_guard(prog):
                opt = S.amp.decorate(
                    P.optimizer.Adam(learning_rate=0.02),
                    amp_lists=S.amp.AutoMixedPrecisionLists(
                        custom_black_list=["relu"]),
                    init_loss_scaling=1024.0)
                opt.minimize(loss)
                opt.amp_init(None)
            losses[P] = [_f(r[0]) for r in
                         _run(P, S, prog, {"x": X, "y": Y}, [loss], 20)]
            assert opt.get_loss_scaling() == pytest.approx(1024.0)
        assert isinstance(opt, tmeta.StaticMetaOptimizer)
        assert losses[tp][-1] < 0.5 * losses[tp][0]
        np.testing.assert_allclose(losses[tp], losses[jp], rtol=5e-3)

    def test_bf16_dtype_skips_loss_scaling(self, static_mode):
        X, Y = _problem()
        progs = build_pair(_mlp_program)
        losses = {}
        for P, S in ((jp, jstatic), (tp, tstatic)):
            prog, (x, y, h, loss) = progs[P]
            with S.program_guard(prog):
                opt = S.amp.decorate(P.optimizer.SGD(learning_rate=0.05),
                                     dtype="bfloat16")
                opt.minimize(loss)
                assert opt._static_amp_scaler is None
            losses[P] = [_f(r[0]) for r in
                         _run(P, S, prog, {"x": X, "y": Y}, [loss], 11)]
        assert losses[tp][-1] < losses[tp][0]
        np.testing.assert_allclose(losses[tp], losses[jp], rtol=2e-2)


class TestStaticRecompute:
    def test_checkpointed_losses_match_plain(self, static_mode):
        X, Y = _problem()

        def builder(P, S):
            P.seed(7)
            x = S.data("x", [None, 8], "float32")
            y = S.data("y", [None, 1], "float32")
            h1 = P.nn.functional.relu(S.nn.fc(x, 16))
            h2 = P.nn.functional.relu(S.nn.fc(h1, 16))
            pred = S.nn.fc(h2, 1)
            return h1, h2, P.mean((pred - y) ** 2)

        def run(with_recompute):
            progs = build_pair(builder)
            out = {}
            for P, S, F, meta in ((jp, jstatic, jfleet, jax_meta),
                                  (tp, tstatic, tfleet, port_meta)):
                prog, (h1, h2, loss) = progs[P]
                strat = F.DistributedStrategy()
                if with_recompute:
                    strat.recompute = True
                    strat.recompute_configs = {"checkpoints": [h1, h2]}
                with S.program_guard(prog):
                    meta(P.optimizer.Adam(learning_rate=0.02),
                         strat).minimize(loss)
                    if with_recompute:
                        assert len(prog._recompute_checkpoints) == 2
                out[P] = [_f(r[0]) for r in
                          _run(P, S, prog, {"x": X, "y": Y}, [loss], 8)]
            return out

        plain, ckpt = run(False), run(True)
        assert ckpt[tp][-1] < 0.5 * ckpt[tp][0]
        assert ckpt[tp] == plain[tp]
        np.testing.assert_allclose(ckpt[tp], ckpt[jp], rtol=2e-5, atol=1e-6)

    def test_unreachable_checkpoint_raises(self, static_mode):
        X, Y = _problem()
        for P, S, F, meta in ((jp, jstatic, jfleet, jax_meta),
                              (tp, tstatic, tfleet, port_meta)):
            with S.program_guard(S.Program()):
                x, y, h, loss = _mlp_program(P, S)
                other = S.data("stray", [4, 4], "float32") * 2.0
                strat = _strategy(F, recompute=True)
                strat.recompute_configs = {"checkpoints": [other]}
                meta(P.optimizer.SGD(learning_rate=0.1),
                     strat).minimize(loss)
                with pytest.raises(S.StaticGraphError, match="not reachable"):
                    S.Executor().run(feed={"x": X, "y": Y},
                                     fetch_list=[loss])


class TestGradientMerge:
    def test_k2_avg_equals_full_batch_step(self, static_mode):
        X, Y = _problem(n=64)
        A, B = (X[:32], Y[:32]), (X[32:], Y[32:])
        progs = build_pair(lambda P, S: _fc_program(P, S, 3))
        got = {}
        for P, S, F, meta in ((jp, jstatic, jfleet, jax_meta),
                              (tp, tstatic, tfleet, port_meta)):
            prog, (x, y, loss) = progs[P]
            strat = _strategy(F, gradient_merge=True)
            strat.gradient_merge_configs = {"k_steps": 2, "avg": True}
            with S.program_guard(prog):
                opt = meta(P.optimizer.SGD(learning_rate=0.1), strat)
                _, pairs = opt.minimize(loss)
                w, b = pairs[0][0], pairs[1][0]

                def val(t, P=P):
                    return np.array(t.detach() if P is tp else t._data)

                w0, b0 = val(w), val(b)
                exe = S.Executor()
                exe.run(feed={"x": A[0], "y": A[1]}, fetch_list=[loss])
                np.testing.assert_array_equal(val(w), w0)
                exe.run(feed={"x": B[0], "y": B[1]}, fetch_list=[loss])
            got[P] = (w0, b0, val(w), val(b))
        w0, b0, w2, b2 = got[tp]
        assert not np.array_equal(w2, w0)
        r = X @ w0 + b0 - Y
        np.testing.assert_allclose(w2, w0 - 0.1 * 2 * X.T @ r / len(X),
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(b2, b0 - 0.1 * 2 * r.mean(0), rtol=2e-5,
                                   atol=1e-6)
        for t, j in zip(got[tp], got[jp]):
            np.testing.assert_allclose(t, j, rtol=2e-5, atol=1e-6)

    def test_merge_with_fp16_divides_by_landed_steps(self, static_mode):
        X, Y = _problem(n=64)
        A, B = (X[:32], Y[:32]), (X[32:], Y[32:])
        progs = build_pair(lambda P, S: _fc_program(P, S, 5))
        got = {}
        for P, S, F, meta in ((jp, jstatic, jfleet, jax_meta),
                              (tp, tstatic, tfleet, port_meta)):
            strat = _strategy(F, amp=True, gradient_merge=True)
            strat.amp_configs = {"use_bf16": False,
                                 "init_loss_scaling": 1e9,
                                 "decr_every_n_nan_or_inf": 1,
                                 "decr_ratio": 1e-6}
            strat.gradient_merge_configs = {"k_steps": 2, "avg": True}
            prog, (x, y, loss) = progs[P]
            with S.program_guard(prog):
                opt = meta(P.optimizer.SGD(learning_rate=0.1), strat)
                _, pairs = opt.minimize(loss)
                w, b = pairs[0][0], pairs[1][0]

                def val(t, P=P):
                    return np.array(t.detach() if P is tp else t._data)

                w0, b0 = val(w), val(b)
                exe = S.Executor()
                exe.run(feed={"x": A[0], "y": A[1]}, fetch_list=[loss])
                exe.run(feed={"x": B[0], "y": B[1]}, fetch_list=[loss])
            got[P] = (w0, b0, val(w))
        w0, b0, w2 = got[tp]
        r = B[0] @ w0 + b0 - B[1]
        gw = 2 * B[0].T @ r / len(B[0])
        np.testing.assert_allclose(w2, w0 - 0.1 * gw, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(w2, got[jp][2], rtol=5e-3, atol=5e-4)

    def test_merge_composes_with_amp_bf16(self, static_mode):
        X, Y = _problem()
        progs = build_pair(_mlp_program)
        losses = {}
        for P, S, F, meta in ((jp, jstatic, jfleet, jax_meta),
                              (tp, tstatic, tfleet, port_meta)):
            strat = _strategy(F, amp=True, gradient_merge=True)
            strat.gradient_merge_configs = {"k_steps": 2, "avg": True}
            prog, (x, y, h, loss) = progs[P]
            with S.program_guard(prog):
                meta(P.optimizer.SGD(learning_rate=0.05),
                     strat).minimize(loss)
            losses[P] = [_f(r[0]) for r in
                         _run(P, S, prog, {"x": X, "y": Y}, [loss], 20)]
        assert losses[tp][-1] < 0.5 * losses[tp][0]
        np.testing.assert_allclose(losses[tp], losses[jp], rtol=2e-2)


class TestLambSwap:
    def test_strategy_lamb_swaps_and_matches_eager(self, static_mode):
        from paddle_tpu_torch.optimizer.optimizers import Lamb

        X, Y = _problem()
        progs = build_pair(lambda P, S: _fc_program(P, S, 11))
        losses = {}
        for P, S, F, meta in ((jp, jstatic, jfleet, jax_meta),
                              (tp, tstatic, tfleet, port_meta)):
            strat = _strategy(F, lamb=True)
            strat.lamb_configs = {"lamb_weight_decay": 0.02}
            prog, (x, y, loss) = progs[P]
            with S.program_guard(prog):
                opt = meta(P.optimizer.Adam(learning_rate=0.05), strat)
                _, pairs = opt.minimize(loss)
                if P is tp:
                    assert isinstance(opt.inner_opt, Lamb)
                    # the swap keeps Adam's betas and epsilon (1e-8)
                    eps = opt.inner_opt._epsilon
                    w0, b0 = (pairs[0][0].detach().clone(),
                              pairs[1][0].detach().clone())
            losses[P] = [_f(r[0]) for r in
                         _run(P, S, prog, {"x": X, "y": Y}, [loss], 10)]
        tp.disable_static()
        model = tp.nn.Linear(8, 1)
        with torch.no_grad():
            model.weight.copy_(w0)
            model.bias.copy_(b0)
        ref_opt = Lamb(learning_rate=0.05, lamb_weight_decay=0.02,
                       epsilon=eps, parameters=model.parameters())
        ref = []
        for _ in range(10):
            lv = tp.nn.functional.mse_loss(model(tp.to_tensor(X)),
                                           tp.to_tensor(Y))
            ref.append(lv.item())
            lv.backward()
            ref_opt.step()
            ref_opt.clear_grad()
        assert losses[tp] == ref
        np.testing.assert_allclose(losses[tp], losses[jp], rtol=2e-5,
                                   atol=1e-6)


class TestAmpRewriteIdempotence:
    def test_re_rewrite_with_new_dtype_replaces_cast(self, static_mode):
        from paddle_tpu.distributed.fleet.meta_optimizers import (
            static_meta_optimizer as jmeta,
        )

        X, Y = _problem()
        counts = {}
        for P, S, rewrite in ((jp, jstatic, jmeta.amp_rewrite),
                              (tp, tstatic, tmeta.amp_rewrite)):
            with S.program_guard(S.Program()):
                x, y, h, loss = _mlp_program(P, S)
                n1 = rewrite(loss, "bfloat16")
                n_again = rewrite(loss, "bfloat16")
                n2 = rewrite(loss, "float16")
                counts[P] = (n1, n_again, n2)
                if P is tp:
                    for node in tmeta._iter_nodes([loss._ref()]):
                        fn = node.fn
                        if getattr(fn, "_amp_static", None) is not None:
                            assert fn._amp_static in (torch.float16,
                                                      torch.float32)
                            assert getattr(fn._amp_orig, "_amp_static",
                                           None) is None
                    hv = S.Executor().run(feed={"x": X, "y": Y},
                                          fetch_list=[h],
                                          return_numpy=False)[0]
                    assert hv.dtype == torch.float16
        for P in (jp, tp):
            n1, n_again, n2 = counts[P]
            assert n1 > 0 and n_again == 0 and 0 < n2 <= n1


class TestDistributedStrategy:
    def test_defaults_updates_and_degrees_match_jax(self):
        """The host-only strategy: the same defaults, in-place config
        updates, the unknown-key check and the degree resolution as
        JAX's."""
        out = {}
        for F in (jfleet, tfleet):
            s = F.DistributedStrategy()
            s.amp = True
            s.amp_configs = {"use_bf16": False, "init_loss_scaling": 1024.0}
            s.recompute_configs = {"enable_offload": True}
            s.hybrid_configs = {"mp_degree": 2, "pp_degree": 2}
            with pytest.raises(ValueError, match="unknown hybrid_configs"):
                s.hybrid_configs = {"tp_degree": 2}
            with pytest.raises(ValueError, match="not divisible"):
                s.hybrid_degrees(6)
            out[F] = (s.to_dict(), s.hybrid_degrees(8))
        assert out[tfleet] == out[jfleet]
