"""The port's SD UNet (``paddle_tpu_torch.models.unet``) against the JAX
package's on the same weights (the JAX ``state_dict`` loaded as it is:
both keep paddle's ``[in, out]`` Linear weight), in f32 on the CPU, on the tiny config of ``tests/test_models.py``
(``TestUNet``): the forward in both ``channels_last`` layouts, the
conversion's key and shape check, and three ``jit.TrainStep`` steps with
``AdamW(multi_precision=True)`` and ``mse_loss`` as ``bench_unet``
against ``paddle.jit.TrainStep``.  On CPU tensors the GroupNorm,
LayerNorm and attention calls run the kernels' plain twins.

Tolerances: the same f32 arithmetic in another summation order (convs
by torch against XLA, norms and attention by the plain twins against
jnp): outputs to 1e-5 of their largest magnitude, losses to 1e-5
relative, and the parameters after three steps to 2e-5 of each tensor's
largest magnitude plus 1 % of the three steps' learning rate (Adam
divides each gradient by its own running norm, so an f32-ulp difference
in a gradient moves its update by about as much relative to the
gradient; the biases start at 0, so their largest magnitude is the sum
of their updates and the absolute 1 % of a step bounds them).
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.models import UNetConfig as JUNetConfig
from paddle_tpu.models import UNet2DConditionModel as JUNet
from paddle_tpu.models.unet import timestep_embedding as jax_timestep_emb
from paddle_tpu_torch.convert import (
    unet_expected_shapes, unet_state_dict_from_jax,
)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.unet import (
    UNet2DConditionModel, UNetConfig, timestep_embedding, unet_loss,
)
from paddle_tpu_torch.ops import kernel_launches
from paddle_tpu_torch.optimizer import AdamW

from _torch_jax_table import FAST_COMPILE, numpy_init
from _torch_port_util import one_thread  # noqa: F401

# tests/test_models.py TestUNet's tiny config
TINY = dict(block_out_channels=(16, 32), layers_per_block=1,
            cross_attention_dim=16, attention_head_dim=2, norm_num_groups=4,
            in_channels=4, out_channels=4)
LAYOUT = pytest.mark.parametrize("channels_last", [False, True],
                                 ids=["nchw", "nhwc"])


def _models(seed=0, **kw):
    cfg = dict(TINY, **kw)
    paddle.seed(seed)
    jm = JUNet(JUNetConfig(**cfg))
    jm.eval()
    tcfg = UNetConfig(**cfg)
    tm = UNet2DConditionModel(tcfg, device="cpu")
    tm.load_state_dict({k: torch.tensor(np.asarray(v.numpy()))
                        for k, v in jm.state_dict().items()})
    return tcfg, jm, tm.eval()


def _batch(b=2, hw=8, seed=0):
    r = np.random.RandomState(seed)
    lat = r.randn(b, 4, hw, hw).astype(np.float32)
    t = r.randint(0, 1000, (b,)).astype(np.int32)
    ctx = r.randn(b, 3, TINY["cross_attention_dim"]).astype(np.float32)
    return lat, t, ctx


def _loss_fn(net, x, t, ctx, target):
    return paddle.nn.functional.mse_loss(net(x, t, ctx), target)


def _jax_forward(jm, *arrays):
    """The JAX model's eval forward as one ``jax.jit`` over its state
    (compiled op by op, the NCHW forward alone took 90 s)."""
    names = list(jm.state_dict())

    def run(state, *arrs):
        with paddle.no_grad(), jm.use_state(dict(zip(names, state))):
            return jm(*[JTensor(a) for a in arrs])._data

    state = [v._data for v in jm.state_dict().values()]
    return np.asarray(jax.jit(run).lower(state, *arrays).compile(
        compiler_options=FAST_COMPILE)(state, *arrays))


@LAYOUT
def test_forward_matches_jax(channels_last):
    _, jm, tm = _models(seed=1, channels_last=channels_last)
    lat, t, ctx = _batch(seed=1)
    ref = _jax_forward(jm, lat, t, ctx)
    with torch.no_grad():
        out = tm(*(torch.from_numpy(a) for a in (lat, t, ctx))).numpy()
    assert out.shape == ref.shape == (2, 4, 8, 8)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_timestep_embedding_matches_jax():
    """cos before sin, in f32.  The angle t * freq reaches 999 rad, whose
    f32 ulp is 6.1e-5, and its last bit depends on how each side rounds
    exp(); sin and cos move by as much, so 2e-4 absolute."""
    t = np.array([0, 1, 17, 999], np.int32)
    ref = np.asarray(jax_timestep_emb(t, 320))
    out = timestep_embedding(torch.from_numpy(t), 320).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4)
    np.testing.assert_allclose(out[:3], ref[:3], rtol=0, atol=1e-5)


@pytest.mark.parametrize("cfg", [
    TINY, dict(TINY, block_out_channels=(8, 16, 16), layers_per_block=2),
    dict(TINY, channels_last=True)], ids=["tiny", "3level_2layer", "nhwc"])
def test_expected_shapes_are_the_models(cfg):
    """The conversion's shape table is the port model's state dict and
    the JAX model's key set (in either layout)."""
    with numpy_init(0):
        jkeys = set(JUNet(JUNetConfig(**cfg)).state_dict())
    tm = UNet2DConditionModel(UNetConfig(**cfg), device="cpu")
    want = unet_expected_shapes(UNetConfig(**cfg))
    assert want == {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert set(want) == jkeys


def test_sd_default_topology_size():
    """SD-1.x defaults: 22 ResnetBlocks, 16 TransformerBlocks, 0.81 B
    parameters (counted from the shape table, no model built)."""
    shapes = unet_expected_shapes(UNetConfig())
    assert sum(math.prod(s) for s in shapes.values()) == 809_909_444
    assert len({k.split(".norm1")[0] for k in shapes
                if ".norm1." in k and "attn" not in k}) == 22
    assert len({k.split(".attn1")[0] for k in shapes if ".attn1." in k}) \
        == 16


def test_conversion_transposes_linears_and_checks_keys():
    """Nothing transposes any more: every array, the Linear weights
    ``[in, out]`` included, comes back as JAX saved it."""
    cfg, jm, tm = _models(seed=2)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    conv = unet_state_dict_from_jax(state, cfg, device="cpu")
    key = "down_attns.0.attn2.to_k.weight"                 # [ctx, dim]
    assert state[key].shape == (16, 16) and \
        tuple(tm.state_dict()["time_mlp1.weight"].shape) == (16, 64)
    for key in state:
        np.testing.assert_array_equal(conv[key].numpy(), state[key])
    with pytest.raises(KeyError, match="missing"):
        unet_state_dict_from_jax({k: v for k, v in state.items()
                                  if k != "conv_out.bias"}, cfg,
                                 device="cpu")
    with pytest.raises(ValueError, match="time_mlp2.weight"):
        unet_state_dict_from_jax(dict(state, **{
            "time_mlp2.weight": state["time_mlp2.weight"][:, :-1]}), cfg,
            device="cpu")


@LAYOUT
def test_three_train_steps_match_jax_train_step(channels_last):
    cfg, jm, tm = _models(seed=3, channels_last=channels_last)
    jm.train()
    tm.train()
    # bench_unet's optimizer (benchmarks/bench_models.py:199-201)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                  parameters=jm.parameters(),
                                  multi_precision=True)
    topt = AdamW(learning_rate=1e-4, parameters=tm.named_parameters(),
                 multi_precision=True, device="cpu")
    jstep = paddle.jit.TrainStep(jm, _loss_fn, jopt)
    tstep = TrainStep(tm, unet_loss, topt, device="cpu")
    lat, t, ctx = _batch(seed=3)
    jb = [paddle.to_tensor(a) for a in (lat, t, ctx, lat)]
    tb = [torch.from_numpy(a) for a in (lat, t, ctx, lat)]
    losses = []
    for _ in range(3):
        jl, tl = float(jstep(*jb).numpy()), tstep(*tb).item()
        losses.append(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert losses[2] < losses[0]
    js = {k: v.numpy() for k, v in jm.state_dict().items()}
    for k, p in tm.state_dict().items():
        want = js[k]
        np.testing.assert_allclose(p.numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max()
                                   + 0.01 * 1e-4 * 3)


def test_jax_state_dict_loads_as_it_is():
    """A JAX UNet's ``state_dict`` goes through ``load_state_dict``
    unchanged (the forward tests hold its outputs to JAX's): every tensor
    equals JAX's array and the converter's, the non-square Linears
    ``[in, out]``."""
    with numpy_init(5):
        jm = JUNet(JUNetConfig(**TINY))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = UNet2DConditionModel(UNetConfig(**TINY), device="cpu")
    tm.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    conv = unet_state_dict_from_jax(state, UNetConfig(**TINY), device="cpu")
    for k, p in tm.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), state[k])
        assert torch.equal(p, conv[k])
    assert tuple(tm.time_mlp1.weight.shape) == (16, 64)
    assert tuple(tm.down_attns[0].attn2.to_k.weight.shape) == (16, 16)
    assert tuple(tm.down_attns[0].ff1.weight.shape) == (16, 64)


def test_seeded_linear_init_bound_is_the_fan_in():
    """A Linear's U(-1/sqrt(fan_in), 1/sqrt(fan_in)) takes the fan-in
    from the ``[in, out]`` weight's first dim: time_mlp1 (16 -> 64) draws
    past 1/sqrt(64) and within 1/sqrt(16); ff2 (64 -> 16) within
    1/sqrt(64)."""
    tm = UNet2DConditionModel(UNetConfig(**TINY), device="cpu", seed=6)
    w1 = tm.time_mlp1.weight.detach().abs().max().item()
    assert 1 / math.sqrt(64) < w1 <= 1 / math.sqrt(16)
    w2 = tm.down_attns[0].ff2.weight.detach().abs().max().item()
    assert w2 <= 1 / math.sqrt(64)
    conv = tm.conv_in.weight.detach().abs().max().item()
    assert conv <= 1 / math.sqrt(4 * 3 * 3)


def test_bf16_train_step_on_cpu_keeps_dtypes_and_counts_nothing():
    cfg = UNetConfig(**dict(TINY, channels_last=False))
    tm = UNet2DConditionModel(cfg, device="cpu", dtype=torch.bfloat16,
                              seed=4).train()
    opt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
                multi_precision=True, device="cpu")
    step = TrainStep(tm, unet_loss, opt, device="cpu")
    lat, t, ctx = _batch(seed=4)
    lat_t = torch.from_numpy(lat).to(torch.bfloat16)
    batch = (lat_t, torch.from_numpy(t),
             torch.from_numpy(ctx).to(torch.bfloat16), lat_t)
    before = kernel_launches()
    losses = [step(*batch).item() for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0]
    assert kernel_launches() == before      # CPU: plain twins, uncounted
    for p in tm.parameters():
        assert p.dtype == torch.bfloat16
        assert opt._accumulators[id(p)]["master_weight"].dtype == \
            torch.float32


def test_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        UNet2DConditionModel(UNetConfig(**TINY))
    assert dataclasses.asdict(UNetConfig())["channels_last"] is True
