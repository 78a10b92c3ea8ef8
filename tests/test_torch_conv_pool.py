"""The port's convolution and pooling functionals and layers
(``paddle_tpu_torch.nn.functional``, ``nn.conv``, ``nn.pooling``) against
the JAX package's (``lax.conv_general_dilated`` and ``lax.reduce_window``)
on numpy-seeded f32 inputs: forward and the gradient of every input under
a random cotangent.

Cases: each conv and transposed conv in 1, 2 and 3 dims with stride,
dilation, groups, bias, every padding form (an int, per dim, 2n (lo, hi)
values, the NC*-style nested pairs, ``"SAME"`` with strides that make it
uneven, ``"VALID"``) and the channels-last layouts; each pool with
``ceil_mode``, exclusive and inclusive averages over padding and over the
ceil overhang, asymmetric padding, padding wider than half the window,
lax's ``"SAME"``, adaptive sizes that do not divide, and inputs with ties
(ReLU'd and rounded to halves: the max-pool gradient must go where JAX's
does, the first maximum of each window, and an adaptive max's split
evenly among tied maxima, as both frameworks' max reductions do).

JAX reads NC*-style nested padding only where the pairs' count is
neither n nor 2n (``conv.py:25-39``): at n = 2 it raises on its own form,
so the 2-D nested case is held against JAX's flat (lo, hi) form.

Tolerance: the same f32 arithmetic in another order, within 1e-5 of each
tensor's largest magnitude.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as F

from _torch_port_util import one_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The layers here are built without ``device=``, as a Paddle script
    builds them: ``set_device("cpu")`` puts them on the CPU, and the
    default is restored when the file ends."""
    prev = tdevice._CURRENT[0]
    tdevice.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _inputs(shapes, seed, ties=False):
    r = np.random.RandomState(seed)
    arrays = [r.randn(*s).astype(np.float32) for s in shapes]
    if ties:
        arrays[0] = np.round(np.maximum(arrays[0], 0.0) * 2) / 2
    return arrays


def _check(name, shapes, kw, seed, ties=False, jax_kw=None):
    """``name`` of both functionals on the same inputs: the outputs and
    every input's gradient under one random cotangent."""
    arrays = _inputs(shapes, seed, ties)
    jt = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    jout = getattr(JF, name)(*jt, **(kw if jax_kw is None else jax_kw))
    want = jout.numpy()
    cot = np.random.RandomState(seed + 1).randn(*want.shape).astype(
        np.float32)
    (jout * paddle.to_tensor(cot)).sum().backward()
    tt = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = getattr(F, name)(*tt, **kw)
    assert tuple(tout.shape) == want.shape, (tout.shape, want.shape)
    _close(tout.detach().numpy(), want, f"{name} output")
    (tout * torch.from_numpy(cot)).sum().backward()
    for i, (j, t) in enumerate(zip(jt, tt)):
        _close(t.grad.numpy(), j.grad.numpy(), f"{name} grad {i}")


CONV_CASES = {
    "1d_stride_pad_bias": ("conv1d", [(2, 4, 11), (6, 4, 3), (6,)],
                           dict(stride=2, padding=1)),
    "1d_nlc_same_dilated": ("conv1d", [(2, 12, 4), (6, 4, 3)],
                            dict(stride=2, padding="SAME", dilation=2,
                                 data_format="NLC")),
    "1d_groups_asym": ("conv1d", [(2, 4, 9), (6, 2, 4), (6,)],
                       dict(padding=[1, 2], groups=2)),
    "1d_nested": ("conv1d", [(2, 3, 9), (4, 3, 3)],
                  dict(padding=[[0, 0], [0, 0], [2, 1]], stride=2)),
    "2d_per_dim_groups_dilation": ("conv2d", [(2, 4, 9, 10), (6, 2, 3, 3),
                                              (6,)],
                                   dict(stride=(2, 1), padding=[1, 2],
                                        dilation=(1, 2), groups=2)),
    "2d_asym_2n": ("conv2d", [(2, 3, 8, 9), (5, 3, 3, 2), (5,)],
                   dict(padding=[0, 1, 2, 1])),
    "2d_same_stride2_even_k": ("conv2d", [(2, 3, 9, 10), (4, 3, 4, 4)],
                               dict(stride=2, padding="SAME")),
    "2d_valid": ("conv2d", [(2, 3, 8, 8), (4, 3, 3, 3), (4,)],
                 dict(stride=3, padding="VALID")),
    "2d_nhwc": ("conv2d", [(2, 7, 6, 3), (4, 3, 3, 3), (4,)],
                dict(padding=1, data_format="NHWC")),
    "2d_nhwc_same_stride2": ("conv2d", [(2, 9, 8, 4), (6, 2, 3, 3)],
                             dict(stride=2, padding="SAME", groups=2,
                                  data_format="NHWC")),
    "3d_stride_per_dim": ("conv3d", [(1, 2, 5, 6, 4), (4, 2, 3, 2, 3), (4,)],
                          dict(stride=(1, 2, 1), padding=[1, 0, 1])),
    "3d_ndhwc_same_groups": ("conv3d", [(1, 5, 6, 4, 4), (4, 2, 2, 3, 3)],
                             dict(padding="SAME", stride=2, groups=2,
                                  data_format="NDHWC")),
    "3d_nested": ("conv3d", [(1, 2, 4, 5, 6), (3, 2, 2, 2, 3)],
                  dict(padding=[[0, 0], [0, 0], [1, 0], [0, 2], [1, 1]])),
    "1dT_stride_outpad": ("conv1d_transpose", [(2, 4, 7), (4, 3, 3), (3,)],
                          dict(stride=2, padding=1, output_padding=1)),
    "1dT_nlc_same": ("conv1d_transpose", [(2, 6, 4), (4, 5, 4)],
                     dict(stride=3, padding="SAME", data_format="NLC")),
    "2dT_asym_groups_dilation": ("conv2d_transpose",
                                 [(2, 4, 5, 6), (4, 3, 3, 3), (6,)],
                                 dict(stride=2, padding=[1, 0, 2, 1],
                                      output_padding=1, groups=2,
                                      dilation=2)),
    "2dT_nhwc_valid": ("conv2d_transpose", [(2, 4, 5, 3), (3, 2, 2, 3)],
                       dict(stride=(2, 3), padding="VALID",
                            data_format="NHWC")),
    "2dT_pad_over_window": ("conv2d_transpose", [(1, 2, 6, 6), (2, 3, 3, 3)],
                            dict(padding=3)),
    "3dT_groups": ("conv3d_transpose", [(1, 4, 3, 4, 3), (4, 1, 3, 2, 2),
                                        (2,)],
                   dict(stride=2, padding=1, groups=2)),
    "3dT_ndhwc_same": ("conv3d_transpose", [(1, 3, 3, 2, 2), (2, 3, 2, 3, 2)],
                       dict(stride=2, padding="SAME", data_format="NDHWC")),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_jax(case):
    name, shapes, kw = CONV_CASES[case]
    _check(name, shapes, kw, seed=sorted(CONV_CASES).index(case))


def test_conv2d_nchw_style_nested_padding_matches_jax_flat_form():
    _check("conv2d", [(2, 3, 7, 8), (4, 3, 3, 3)],
           dict(padding=[[0, 0], [0, 0], [1, 0], [2, 1]]), seed=40,
           jax_kw=dict(padding=[1, 0, 2, 1]))


def test_conv2d_nhwc_equals_nchw():
    x, w, b = _inputs([(2, 3, 9, 8), (4, 3, 3, 3), (4,)], seed=41)
    x, w, b = (torch.from_numpy(a) for a in (x, w, b))
    ref = F.conv2d(x, w, b, stride=2, padding="SAME")
    got = F.conv2d(x.permute(0, 2, 3, 1).contiguous(), w, b, stride=2,
                   padding="SAME", data_format="NHWC")
    _close(got.permute(0, 3, 1, 2).numpy(), ref.numpy(), "NHWC vs NCHW")


POOL_CASES = {
    "max1d_ceil": ("max_pool1d", [(2, 3, 10)],
                   dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    "avg1d_asym_ceil_excl": ("avg_pool1d", [(2, 3, 10)],
                             dict(kernel_size=3, stride=2, padding=[1, 0],
                                  ceil_mode=True)),
    "avg1d_ceil_incl": ("avg_pool1d", [(2, 3, 10)],
                        dict(kernel_size=3, stride=2, padding=1,
                             ceil_mode=True, exclusive=False)),
    "max2d_resnet_stem_ties": ("max_pool2d", [(2, 3, 12, 12)],
                               dict(kernel_size=3, stride=2, padding=1)),
    "max2d_asym_ceil_ties": ("max_pool2d", [(2, 3, 9, 8)],
                             dict(kernel_size=(3, 2), stride=2,
                                  padding=[1, 0, 0, 1], ceil_mode=True)),
    "max2d_nhwc_same": ("max_pool2d", [(2, 7, 9, 3)],
                        dict(kernel_size=2, stride=2, padding="SAME",
                             data_format="NHWC")),
    "max2d_pad_over_half": ("max_pool2d", [(2, 2, 7, 7)],
                            dict(kernel_size=3, stride=1, padding=2)),
    "avg2d_excl": ("avg_pool2d", [(2, 3, 9, 9)],
                   dict(kernel_size=3, stride=2, padding=1)),
    "avg2d_incl": ("avg_pool2d", [(2, 3, 9, 9)],
                   dict(kernel_size=3, stride=2, padding=1,
                        exclusive=False)),
    "avg2d_ceil_excl": ("avg_pool2d", [(2, 3, 10, 9)],
                        dict(kernel_size=3, stride=2, padding=1,
                             ceil_mode=True)),
    "avg2d_ceil_incl": ("avg_pool2d", [(2, 3, 10, 9)],
                        dict(kernel_size=3, stride=2, padding=1,
                             ceil_mode=True, exclusive=False)),
    "avg2d_ceil_no_pad": ("avg_pool2d", [(2, 3, 10, 9)],
                          dict(kernel_size=3, stride=2, ceil_mode=True)),
    "avg2d_asym_excl": ("avg_pool2d", [(2, 3, 8, 9)],
                        dict(kernel_size=(2, 3), stride=(2, 1),
                             padding=[0, 1, 1, 2])),
    "avg2d_pad_over_half": ("avg_pool2d", [(2, 2, 7, 7)],
                            dict(kernel_size=3, stride=1, padding=2)),
    "avg2d_same": ("avg_pool2d", [(2, 3, 9, 8)],
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "avg2d_nhwc": ("avg_pool2d", [(2, 6, 7, 3)],
                   dict(kernel_size=2, stride=1, padding=1,
                        data_format="NHWC")),
    "max3d_ceil": ("max_pool3d", [(1, 2, 5, 6, 7)],
                   dict(kernel_size=2, stride=2, ceil_mode=True)),
    "avg3d_excl": ("avg_pool3d", [(1, 2, 5, 6, 7)],
                   dict(kernel_size=(2, 3, 2), stride=2, padding=1)),
    "adaptive_avg1d": ("adaptive_avg_pool1d", [(2, 3, 7)],
                       dict(output_size=3)),
    "adaptive_avg2d": ("adaptive_avg_pool2d", [(2, 3, 9, 7)],
                       dict(output_size=(4, 3))),
    "adaptive_avg2d_nhwc": ("adaptive_avg_pool2d", [(2, 9, 7, 3)],
                            dict(output_size=(2, 5), data_format="NHWC")),
    "adaptive_avg2d_1x1": ("adaptive_avg_pool2d", [(2, 8, 7, 7)],
                           dict(output_size=(1, 1))),
    "adaptive_avg3d": ("adaptive_avg_pool3d", [(1, 2, 5, 6, 7)],
                       dict(output_size=(2, 3, 4))),
    "adaptive_max1d": ("adaptive_max_pool1d", [(2, 3, 9)],
                       dict(output_size=4)),
    "adaptive_max2d_ties": ("adaptive_max_pool2d", [(2, 3, 9, 7)],
                            dict(output_size=(4, 5))),
    "adaptive_max3d": ("adaptive_max_pool3d", [(1, 2, 5, 6, 7)],
                       dict(output_size=(3, 2, 4))),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_jax(case):
    name, shapes, kw = POOL_CASES[case]
    _check(name, shapes, kw, seed=100 + sorted(POOL_CASES).index(case),
           ties="ties" in case)


def test_max_pool_tie_input_has_ties():
    """The tie cases do hold ties inside windows."""
    (x,) = _inputs([(2, 3, 12, 12)], seed=0, ties=True)
    assert (x == 0).mean() > 0.3 and len(np.unique(x)) < 20


def test_return_mask_raises():
    """``return_mask`` with string padding raises, as JAX's
    (``pooling.py:172-173``); with any other padding the max pools return
    ``(out, mask)`` (held against JAX by tests/test_torch_nn_surface.py)
    and the adaptive ones ignore it, as JAX's."""
    x = torch.zeros(1, 1, 4, 4)
    for pad in ("SAME", "VALID"):
        with pytest.raises(NotImplementedError, match="string padding"):
            F.max_pool2d(x, 2, padding=pad, return_mask=True)
    out, mask = F.max_pool2d(x, 2, return_mask=True)
    assert out.shape == mask.shape == (1, 1, 2, 2)
    assert mask.dtype == torch.int32
    assert F.adaptive_max_pool2d(x, 2, return_mask=True).shape == (1, 1, 2,
                                                                    2)


LAYERS = {
    "Conv1D": (dict(in_channels=4, out_channels=6, kernel_size=3, stride=2),
               (2, 4, 9)),
    "Conv2D": (dict(in_channels=4, out_channels=6, kernel_size=3, padding=1,
                    groups=2), (2, 4, 6, 5)),
    "Conv3D": (dict(in_channels=2, out_channels=4, kernel_size=2,
                    bias_attr=False), (1, 2, 4, 3, 5)),
    "Conv1DTranspose": (dict(in_channels=4, out_channels=3, kernel_size=3,
                             stride=2), (2, 4, 5)),
    "Conv2DTranspose": (dict(in_channels=4, out_channels=6, kernel_size=3,
                             stride=2, padding=1, groups=2), (2, 4, 5, 4)),
    "Conv3DTranspose": (dict(in_channels=2, out_channels=2, kernel_size=2,
                             stride=2), (1, 2, 2, 3, 2)),
    "MaxPool2D": (dict(kernel_size=3, stride=2, padding=1), (2, 3, 9, 9)),
    "AvgPool2D": (dict(kernel_size=2, ceil_mode=True), (2, 3, 9, 9)),
    "AvgPool1D": (dict(kernel_size=3, padding=1, exclusive=False),
                  (2, 3, 7)),
    "MaxPool3D": (dict(kernel_size=2), (1, 2, 4, 4, 4)),
    "AdaptiveAvgPool2D": (dict(output_size=(1, 1)), (2, 3, 5, 5)),
    "AdaptiveMaxPool1D": (dict(output_size=3), (2, 3, 8)),
}


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_names_shapes_and_forward_match_jax(layer):
    """Each layer's parameters (names and shapes) and its forward on the
    JAX layer's weights."""
    kw, shape = LAYERS[layer]
    jl = getattr(jnn, layer)(**kw)
    tl = getattr(tnn, layer)(**kw)
    jsd = {k: v.numpy() for k, v in jl.state_dict().items()}
    tsd = tl.state_dict()
    assert {k: tuple(v.shape) for k, v in tsd.items()} == \
        {k: v.shape for k, v in jsd.items()}
    tl.load_state_dict({k: torch.tensor(v) for k, v in jsd.items()})
    (x,) = _inputs([shape], seed=7)
    want = jl(paddle.to_tensor(x)).numpy()
    _close(tl(torch.from_numpy(x)).detach().numpy(), want, layer)


def test_conv_init_is_jax_uniform_bound():
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the weight and the bias."""
    conv = tnn.Conv2D(8, 16, 3, groups=2)
    bound = 1.0 / np.sqrt(4 * 9)
    for p in (conv.weight, conv.bias):
        assert p.abs().max().item() <= bound
        assert p.abs().max().item() > 0.8 * bound
    assert tnn.Conv2D(8, 16, 3, bias_attr=False).bias is None


def test_padding_mode_other_than_zeros_raises():
    with pytest.raises(NotImplementedError):
        tnn.Conv2D(2, 2, 3, padding_mode="reflect")


def test_conv_transpose_output_size_sets_the_output_padding():
    """``output_size`` (which JAX ignores) gives the output padding that
    reaches it: the same result as JAX's call with that padding."""
    _check("conv2d_transpose", [(1, 2, 4, 5), (2, 3, 3, 3), (3,)],
           dict(stride=2, padding=1, output_size=[8, 10]), seed=42,
           jax_kw=dict(stride=2, padding=1, output_padding=[1, 1]))
