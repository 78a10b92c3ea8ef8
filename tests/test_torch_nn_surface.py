"""The port's nn surface against the JAX package's on numpy-seeded f32
inputs on the CPU: every activation function and layer, the common
functionals and layers, ``normalize``/``local_response_norm`` and their
layers, the max pools' masks and the unpools, ``grid_sample``,
``affine_grid`` and ``temporal_shift``, ``interpolate`` in every mode,
and the 72 functions of ``tensor.manipulation``; then the name sets of
both packages.

Each case holds the output, and where the function is differentiable
every float input's gradient under one random cotangent, to 1e-5 of the
tensor's largest magnitude (the same f32 arithmetic in another order);
integer and bool outputs (masks, indices) and their dtypes are held
exactly.  The JAX side of every case runs the JAX package's function
(its ``Tensor`` over the traced arrays) inside one ``jax.jit`` of the
whole table, with ``jax.vjp`` for the gradients, built once for the
module (``jax_refs``): compiled op by op, the same references cost ten
times as much.  The functions whose output size depends on the data
(``nonzero``, ``unique``, ``masked_select``, ``sequence_mask`` without
``maxlen``) run eagerly.  The draws of the counter stream (``rrelu`` in
training, ``gumbel_softmax``, the dropouts) differ from JAX's threefry
bits by design, so they are held to their properties and to JAX at
p = 0 and in eval.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.tensor import manipulation as JM
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import random as trandom
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.tensor import manipulation as TM

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


def _close(got, want, what, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = np.abs(want).max() if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(scale, 1e-30), err_msg=what)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _compare(got, want, what):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), (what, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, f"{what}[{i}]")
    elif isinstance(want, (int, float, bool)):
        assert got == want, (what, got, want)
    else:
        _close(_np(got), _np(want), what)


def _floats(*shapes, seed=0, scale=1.0):
    r = np.random.RandomState(seed)
    return [np.asarray(r.randn(*s) * scale).astype(np.float32)
            for s in shapes]


def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out



X = (2, 6, 4, 5)
ACT_CASES = {
    "relu": {}, "relu6": {}, "gelu": {}, "gelu_tanh": {"approximate": True},
    "silu": {}, "swish": {}, "sigmoid": {}, "hardsigmoid": {},
    "hardsigmoid_args": {"slope": 0.2, "offset": 0.3}, "hardswish": {},
    "hardtanh": {"min": -0.5, "max": 0.7}, "hardshrink": {"threshold": 0.3},
    "tanh": {}, "tanhshrink": {}, "leaky_relu": {"negative_slope": 0.2},
    "rrelu": {}, "elu": {"alpha": 0.7}, "selu": {}, "celu": {"alpha": 1.3},
    "mish": {}, "softplus": {"beta": 2.0, "threshold": 3.0},
    "softshrink": {"threshold": 0.4}, "softsign": {},
    "thresholded_relu": {"threshold": 0.5, "value": 0.1},
    "log_sigmoid": {}, "softmax": {"axis": 1}, "log_softmax": {"axis": 0},
    "glu": {"axis": 1}, "maxout": {"groups": 2, "axis": 1},
    "maxout_last": {"groups": 5, "axis": -1},
}


LAYER_CASES = {
    "ReLU": {}, "ReLU6": {}, "GELU": {"approximate": True}, "SiLU": {},
    "Swish": {}, "Sigmoid": {}, "Tanh": {},
    "LeakyReLU": {"negative_slope": 0.3}, "PReLU": {"num_parameters": 6},
    "RReLU": {"lower": 0.2, "upper": 0.4}, "ELU": {"alpha": 0.5},
    "SELU": {}, "CELU": {"alpha": 0.8}, "Mish": {},
    "Hardshrink": {"threshold": 0.2}, "Hardsigmoid": {}, "Hardswish": {},
    "Hardtanh": {"min": -0.3, "max": 0.9},
    "Softplus": {"beta": 0.5, "threshold": 2.0},
    "Softshrink": {"threshold": 0.6}, "Softsign": {}, "Tanhshrink": {},
    "ThresholdedReLU": {"threshold": 0.2, "value": -1.0},
    "LogSigmoid": {}, "Softmax": {"axis": 2}, "LogSoftmax": {"axis": -1},
    "Maxout": {"groups": 3, "axis": 1}, "GLU": {"axis": -1},
    "Softmax2D": {},
}


PAD_CASES = {
    "const_2d": ([1, 2, 0, 3], {"mode": "constant", "value": 1.5}),
    "reflect_2d": ([2, 1, 1, 2], {"mode": "reflect"}),
    "replicate_2d": ([3, 0, 2, 4], {"mode": "replicate"}),
    "circular_2d": ([1, 2, 3, 1], {"mode": "circular"}),
    "reflect_1d_nhwc": ([2, 1], {"mode": "reflect", "data_format": "NHWC"}),
    "full_form": ([0, 1, 1, 0, 2, 1, 1, 2], {"mode": "constant"}),
    "full_reflect": ([0, 0, 1, 2, 2, 1, 3, 1], {"mode": "reflect"}),
}


COMMON_CASES = {
    "zeropad2d": (lambda m: lambda a: m.zeropad2d(a, [1, 2, 0, 1]),
                  [(2, 3, 4, 5)]),
    "cosine_similarity": (lambda m: lambda a, b: m.cosine_similarity(
        a, b, axis=1), [(4, 7, 3), (4, 7, 3)]),
    "cosine_similarity_last": (lambda m: lambda a, b: m.cosine_similarity(
        a, b, axis=-1, eps=1e-3), [(4, 7), (4, 7)]),
    "pixel_shuffle": (lambda m: lambda a: m.pixel_shuffle(a, 2),
                      [(2, 8, 3, 4)]),
    "pixel_shuffle_nhwc": (lambda m: lambda a: m.pixel_shuffle(
        a, 3, "NHWC"), [(1, 2, 3, 18)]),
    "pixel_unshuffle": (lambda m: lambda a: m.pixel_unshuffle(a, 2),
                        [(2, 3, 4, 6)]),
    "pixel_unshuffle_nhwc": (lambda m: lambda a: m.pixel_unshuffle(
        a, 2, "NHWC"), [(1, 4, 6, 3)]),
    "channel_shuffle": (lambda m: lambda a: m.channel_shuffle(a, 3),
                        [(2, 6, 3, 2)]),
    "channel_shuffle_nhwc": (lambda m: lambda a: m.channel_shuffle(
        a, 2, "NHWC"), [(2, 3, 2, 8)]),
    "unfold": (lambda m: lambda a: m.unfold(a, [2, 3], strides=[1, 2],
                                            paddings=[1, 0, 2, 1],
                                            dilations=[2, 1]),
               [(2, 3, 6, 7)]),
    "unfold_int": (lambda m: lambda a: m.unfold(a, 3, 2, 1), [(1, 2, 7, 7)]),
    "fold": (lambda m: lambda a: m.fold(a, [5, 6], [2, 3], strides=[1, 2],
                                        paddings=[1, 1], dilations=[1, 1]),
             [(2, 12, 18)]),
    "label_smooth": (lambda m: lambda a: m.label_smooth(a, epsilon=0.2),
                     [(3, 5)]),
    "label_smooth_prior": (lambda m: lambda a: m.label_smooth(
        a, np.linspace(0.1, 0.3, 5).astype(np.float32), epsilon=0.3),
        [(3, 5)]),
    "bilinear": (lambda m: lambda a, b, w, c: m.bilinear(a, b, w, c),
                 [(4, 3), (4, 5), (2, 3, 5), (2,)]),
    "bilinear_nobias": (lambda m: lambda a, b, w: m.bilinear(a, b, w),
                        [(4, 3), (4, 5), (2, 3, 5)]),
    "pairwise_distance": (lambda m: lambda a, b: m.pairwise_distance(a, b),
                          [(5, 8), (5, 8)]),
    "pairwise_distance_p1_keep": (lambda m: lambda a, b: m.pairwise_distance(
        a, b, p=1.0, keepdim=True), [(5, 8), (5, 8)]),
    "pairwise_distance_p3": (lambda m: lambda a, b: m.pairwise_distance(
        a, b, p=3.0, epsilon=0.0), [(2, 5, 8), (2, 5, 8)]),
    "normalize": (lambda m: lambda a: m.normalize(a), [(3, 6, 4)]),
    "normalize_p1": (lambda m: lambda a: m.normalize(a, p=1, axis=-1),
                     [(3, 6, 4)]),
    "normalize_p3": (lambda m: lambda a: m.normalize(a, p=3, axis=0),
                     [(3, 6, 4)]),
    "local_response_norm": (lambda m: lambda a: m.local_response_norm(
        a, 5, alpha=1e-2), [(2, 7, 3, 4)]),
    "local_response_norm_even_nhwc": (lambda m: lambda a:
                                      m.local_response_norm(
                                          a, 4, 1e-1, 0.6, 2.0, "NHWC"),
                                      [(2, 3, 4, 6)]),
    "affine_grid": (lambda m: lambda t: m.affine_grid(t, [2, 3, 4, 5]),
                    [(2, 2, 3)]),
    "affine_grid_half": (lambda m: lambda t: m.affine_grid(
        t, [2, 3, 5, 4], align_corners=False), [(2, 2, 3)]),
    "temporal_shift": (lambda m: lambda a: m.temporal_shift(a, 3, 0.25),
                       [(6, 8, 2, 3)]),
    "temporal_shift_nhwc": (lambda m: lambda a: m.temporal_shift(
        a, 2, 0.2, "NHWC"), [(4, 2, 3, 10)]),
}


INTERP_SHAPES = {"nearest": (2, 3, 5, 7), "bilinear": (2, 3, 5, 7),
                 "bicubic": (2, 3, 5, 7), "area": (2, 3, 5, 7),
                 "linear": (2, 3, 9), "trilinear": (1, 2, 4, 5, 6)}
INTERP_CASES = [(m, d, a) for m in sorted(INTERP_SHAPES)
                for d in ("up", "down") for a in (False, True)]


COMMON_LAYERS = {
    "Identity": ({}, [(2, 3)]), "Flatten": ({}, [(2, 3, 4, 5)]),
    "Flatten_range": ({"start_axis": 0, "stop_axis": 2}, [(2, 3, 4, 5)]),
    "Unflatten": ({"axis": 1, "shape": [2, 3]}, [(4, 6, 2)]),
    "Upsample": ({"scale_factor": 2, "mode": "bilinear"}, [(1, 2, 3, 4)]),
    "UpsamplingNearest2D": ({"size": [5, 7]}, [(1, 2, 3, 4)]),
    "UpsamplingBilinear2D": ({"scale_factor": 2}, [(1, 2, 3, 4)]),
    "PixelShuffle": ({"upscale_factor": 2}, [(1, 8, 2, 3)]),
    "PixelUnshuffle": ({"downscale_factor": 2}, [(1, 2, 4, 6)]),
    "ChannelShuffle": ({"groups": 2}, [(1, 4, 2, 3)]),
    "Pad1D": ({"padding": [1, 2], "mode": "reflect"}, [(2, 3, 5)]),
    "Pad2D": ({"padding": [1, 0, 2, 1], "mode": "replicate"},
              [(2, 3, 4, 5)]),
    "Pad3D": ({"padding": [1, 1, 0, 1, 1, 0], "value": 2.0},
              [(1, 2, 3, 4, 5)]),
    "ZeroPad2D": ({"padding": [2, 1, 1, 0]}, [(2, 3, 4, 5)]),
    "CosineSimilarity": ({"axis": 2}, [(2, 3, 4), (2, 3, 4)]),
    "Unfold": ({"kernel_sizes": 2, "strides": 2}, [(1, 2, 4, 6)]),
    "Fold": ({"output_sizes": [4, 6], "kernel_sizes": 2, "strides": 2},
             [(1, 8, 6)]),
    "PairwiseDistance": ({"p": 1.5}, [(3, 4), (3, 4)]),
    "Dropout2D": ({"p": 0.5}, [(2, 3, 4, 5)]),
    "Dropout3D": ({"p": 0.5}, [(2, 3, 2, 4, 5)]),
    "AlphaDropout": ({"p": 0.5}, [(2, 3)]),
    "LocalResponseNorm": ({"size": 3, "k": 2.0}, [(2, 5, 3, 3)]),
}


GRID_CASES = [(m, p, a) for m in ("bilinear", "nearest")
              for p in ("zeros", "border", "reflection") for a in (True,
                                                                  False)]


MASK_CASES = {
    "2d_k2": (2, (2, 3, 6, 7), dict(kernel_size=2)),
    "2d_k3s2p1": (2, (2, 3, 7, 8), dict(kernel_size=3, stride=2,
                                        padding=1)),
    "2d_ceil": (2, (1, 2, 7, 7), dict(kernel_size=3, stride=2,
                                      ceil_mode=True)),
    "2d_ceil_pad": (2, (1, 2, 8, 6), dict(kernel_size=3, stride=2,
                                          padding=1, ceil_mode=True)),
    "2d_asym": (2, (1, 2, 6, 6), dict(kernel_size=[2, 3], stride=[2, 1],
                                      padding=[1, 0, 0, 1])),
    "2d_nhwc": (2, (2, 6, 5, 3), dict(kernel_size=2, stride=1,
                                      data_format="NHWC")),
    "1d": (1, (2, 3, 9), dict(kernel_size=3, stride=2, padding=1)),
    "1d_nlc": (1, (2, 9, 3), dict(kernel_size=2, data_format="NLC")),
    "3d": (3, (1, 2, 4, 5, 4), dict(kernel_size=2, stride=2, padding=1)),
}


def _i(*vals):
    return np.array(vals, np.int64)


A = (3, 4, 5)
MANIP_CASES = {
    "reshape": (lambda m, a: m.reshape(a, [4, -1]), [A]),
    "transpose": (lambda m, a: m.transpose(a, [2, 0, 1]), [A]),
    "t": (lambda m, a: m.t(a), [(3, 4)]),
    "t_3d": (lambda m, a: m.t(a), [A]),
    "moveaxis": (lambda m, a: m.moveaxis(a, 0, -1), [A]),
    "swapaxes": (lambda m, a: m.swapaxes(a, 0, 2), [A]),
    "flatten": (lambda m, a: m.flatten(a, 1), [A]),
    "squeeze": (lambda m, a: m.squeeze(a), [(1, 3, 1, 4)]),
    "squeeze_axis": (lambda m, a: m.squeeze(a, [0, 1]), [(1, 3, 1, 4)]),
    "unsqueeze": (lambda m, a: m.unsqueeze(a, [0, -1]), [(3, 4)]),
    "concat": (lambda m, a, b: m.concat([a, b], axis=1), [(2, 3), (2, 4)]),
    "cat": (lambda m, a, b: m.cat([a, b]), [(2, 3), (1, 3)]),
    "stack": (lambda m, a, b: m.stack([a, b], axis=1), [(2, 3), (2, 3)]),
    "split": (lambda m, a: m.split(a, 2, axis=1), [(3, 4)]),
    "split_sections": (lambda m, a: m.split(a, [2, -1, 1], axis=2), [A]),
    "chunk": (lambda m, a: m.chunk(a, 3), [(6, 2)]),
    "unbind": (lambda m, a: m.unbind(a, 1), [(2, 3, 2)]),
    "unstack": (lambda m, a: m.unstack(a), [(2, 3)]),
    "tile": (lambda m, a: m.tile(a, [2, 1, 3]), [(3, 4)]),
    "expand": (lambda m, a: m.expand(a, [2, -1, 4]), [(3, 1)]),
    "expand_as": (lambda m, a, b: m.expand_as(a, b), [(1, 4), (3, 4)]),
    "broadcast_to": (lambda m, a: m.broadcast_to(a, [2, 3, 4]), [(3, 1)]),
    "broadcast_tensors": (lambda m, a, b: m.broadcast_tensors([a, b]),
                          [(3, 1), (1, 4)]),
    "flip": (lambda m, a: m.flip(a, [0, 2]), [A]),
    "fliplr": (lambda m, a: m.fliplr(a), [(3, 4)]),
    "flipud": (lambda m, a: m.flipud(a), [(3, 4)]),
    "rot90": (lambda m, a: m.rot90(a, 3, [1, 2]), [A]),
    "roll": (lambda m, a: m.roll(a, [1, -2], [0, 2]), [A]),
    "roll_flat": (lambda m, a: m.roll(a, 3), [(3, 4)]),
    "slice": (lambda m, a: m.slice(a, [0, 2], [1, -3], [10, -1]), [A]),
    "strided_slice": (lambda m, a: m.strided_slice(
        a, [1, 2], [0, 4], [4, 0], [2, -2]), [A]),
    "repeat_interleave": (lambda m, a: m.repeat_interleave(a, 2, axis=1),
                          [(2, 3)]),
    "repeat_interleave_flat": (lambda m, a: m.repeat_interleave(a, 3),
                               [(2, 2)]),
    "as_real": (lambda m, a: m.as_real(m.as_complex(a)), [(3, 2)]),
    "view": (lambda m, a: m.view(a, [2, 6]), [(3, 4)]),
    "view_as": (lambda m, a, b: m.view_as(a, b), [(3, 4), (6, 2)]),
    "atleast_1d": (lambda m, a: m.atleast_1d(a), [()]),
    "atleast_2d": (lambda m, a: m.atleast_2d(a), [(4,)]),
    "atleast_3d": (lambda m, a, b: m.atleast_3d(a, b), [(4,), (3, 4)]),
    "tensordot": (lambda m, a, b: m.tensordot(a, b, 1), [(3, 4), (4, 5)]),
    "tensordot_pairs": (lambda m, a, b: m.tensordot(a, b, [[0, 1], [1, 0]]),
                        [A, (4, 3, 2)]),
    "diagonal": (lambda m, a: m.diagonal(a, 1, 0, 2), [A]),
    "unfold": (lambda m, a: m.unfold(a, 1, 3, 1), [(2, 6, 3)]),
    "as_strided": (lambda m, a: m.as_strided(a, [3, 3], [2, 1], 1),
                   [(12,)]),
    "tensor_split": (lambda m, a: m.tensor_split(a, 4, axis=1), [(2, 6)]),
    "tensor_split_indices": (lambda m, a: m.tensor_split(a, [1, 3]),
                             [(5, 2)]),
    "hsplit": (lambda m, a: m.hsplit(a, 2), [(3, 4)]),
    "vsplit": (lambda m, a: m.vsplit(a, [1]), [(3, 4)]),
    "dsplit": (lambda m, a: m.dsplit(a, 5), [A]),
    "hstack": (lambda m, a, b: m.hstack([a, b]), [(3, 2), (3, 1)]),
    "vstack": (lambda m, a, b: m.vstack([a, b]), [(3,), (3,)]),
    "column_stack": (lambda m, a, b: m.column_stack([a, b]), [(3,), (3, 2)]),
    "row_stack": (lambda m, a, b: m.row_stack([a, b]), [(2, 3), (1, 3)]),
    "unflatten": (lambda m, a: m.unflatten(a, 1, [2, 2]), [(3, 4)]),
    "cast": (lambda m, a: m.cast(a, "int32"), [(3, 4)]),
}
# index arguments, made from a seed, by case: (function, float shapes,
# int arrays)
INDEX_CASES = {
    "gather": (lambda m, a, i: m.gather(a, i, axis=1), [A], [_i(3, 0, 3)]),
    "index_select": (lambda m, a, i: m.index_select(a, i), [A], [_i(2, 1)]),
    "gather_nd": (lambda m, a, i: m.gather_nd(a, i), [A],
                  [np.array([[0, 1], [2, 3]], np.int64)]),
    "scatter": (lambda m, a, u, i: m.scatter(a, i, u), [(5, 3), (2, 3)],
                [_i(4, 1)]),
    "scatter_add": (lambda m, a, u, i: m.scatter(a, i, u, overwrite=False),
                    [(5, 3), (3, 3)], [_i(0, 0, 2)]),
    "scatter_nd_add": (lambda m, a, u, i: m.scatter_nd_add(a, i, u),
                       [(4, 3), (3, 3)], [np.array([[1], [3], [1]])]),
    "scatter_nd": (lambda m, u, i: m.scatter_nd(i, u, [4, 3]), [(2, 3)],
                   [np.array([[1], [3]])]),
    "index_sample": (lambda m, a, i: m.index_sample(a, i), [(3, 5)],
                     [np.array([[0, 4], [1, 1], [3, 2]], np.int64)]),
    "index_add": (lambda m, a, v, i: m.index_add(a, i, 1, v), [A, (3, 2, 5)],
                  [_i(3, 0)]),
    "index_fill": (lambda m, a, i: m.index_fill(a, i, 2, 0.5), [A],
                   [_i(1, 4)]),
    "take_along_axis": (lambda m, a, i: m.take_along_axis(a, i, 1), [A],
                        [np.zeros((3, 2, 5), np.int64) + 2]),
    "take_along_dim": (lambda m, a, i: m.take_along_dim(a, i, 0), [(3, 4)],
                       [np.array([[2, 0, 1, 1]], np.int64)]),
    "put_along_axis": (lambda m, a, v, i: m.put_along_axis(a, i, v, 1),
                       [(3, 4), (3, 1)], [np.array([[1], [3], [0]])]),
    "put_along_axis_add": (lambda m, a, v, i: m.put_along_axis(
        a, i, v, 0, reduce="add"), [(3, 4), (1, 4)],
        [np.array([[1, 2, 0, 2]])]),
    "put_along_axis_mul": (lambda m, a, v, i: m.put_along_axis(
        a, i, v, 1, reduce="multiply"), [(2, 4), (2, 2)],
        [np.array([[1, 3], [0, 0]])]),
    "take": (lambda m, a, i: m.take(a, i), [(3, 4)], [_i(0, 11, 5)]),
    "take_wrap": (lambda m, a, i: m.take(a, i, mode="wrap"), [(3, 4)],
                  [_i(-1, 13, 5)]),
    "take_clip": (lambda m, a, i: m.take(a, i, mode="clip"), [(3, 4)],
                  [_i(-3, 20, 2)]),
}



def _tied(shape, seed):
    """Inputs with many ties (ReLU'd, rounded to halves)."""
    (x,) = _floats(shape, seed=seed)
    return (np.round(np.maximum(x, 0.0) * 2) / 2).astype(np.float32)


def _copy(dst, src):
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(src.numpy())))


# ------------------------------------------------------------- registry
# family -> {case: builder}; a builder returns (jax_fn, port_fn, float
# arrays, grad), the functions taking the arrays as tensors of their
# framework
REG = {}


def _reg(family, case, builder):
    REG.setdefault(family, {})[case] = builder


def _fn_pair(jfn, tfn, arrays, grad=True):
    return lambda: (jfn, tfn, arrays, grad)


for _c, _kw in ACT_CASES.items():
    _n = _c.split("_tanh")[0].split("_args")[0].split("_last")[0]
    _reg("act", _c, _fn_pair(
        lambda a, n=_n, kw=_kw: getattr(JF, n)(a, **kw),
        lambda a, n=_n, kw=_kw: getattr(F, n)(a, **kw),
        _floats(X, seed=sorted(ACT_CASES).index(_c), scale=3.0)))
for _c in ("channel", "one", "nhwc"):
    _kw = {"data_format": "NHWC"} if _c == "nhwc" else {}
    _reg("prelu", _c, _fn_pair(
        lambda a, w, kw=_kw: JF.prelu(a, w, **kw),
        lambda a, w, kw=_kw: F.prelu(a, w, **kw),
        _floats(X, (X[1] if _c == "channel" else X[-1] if _c == "nhwc"
                    else 1,), seed=3)))
for _n in ("relu_", "softmax_", "elu_"):
    _reg("inplace", _n, _fn_pair(
        lambda a, n=_n: getattr(JF, n)(a), lambda a, n=_n: getattr(F, n)(a),
        _floats(X, seed=5), grad=False))


def _act_layer(name):
    def build():
        jl = getattr(jnn, name)(**LAYER_CASES[name])
        tl = getattr(tnn, name)(**LAYER_CASES[name])
        jl.eval()
        tl.eval()
        if name == "PReLU":
            w = np.linspace(-0.5, 0.5, 6).astype(np.float32)
            jl.weight.set_value(w)
            _copy(tl.weight, jl.weight)
        return jl, tl, _floats((2, 6, 3, 4), seed=sorted(LAYER_CASES).index(
            name), scale=2.0), True
    return build


for _c in LAYER_CASES:
    _reg("act_layer", _c, _act_layer(_c))
for _c, (_pad, _kw) in PAD_CASES.items():
    _reg("pad", _c, _fn_pair(
        lambda a, p=_pad, kw=_kw: JF.pad(a, p, **kw),
        lambda a, p=_pad, kw=_kw: F.pad(a, p, **kw),
        _floats((2, 3, 5, 6), seed=4)))
for _c, (_make, _shapes) in COMMON_CASES.items():
    _reg("common", _c, _fn_pair(
        _make(JF), _make(F), _floats(*_shapes,
                                     seed=sorted(COMMON_CASES).index(_c))))
for _c, _kw in (("p0", {"p": 0.0}), ("eval", {"p": 0.5, "training": False})):
    for _n, _shape in (("dropout2d", (2, 3, 4, 5)),
                       ("dropout3d", (2, 3, 2, 4, 5)),
                       ("alpha_dropout", (2, 3))):
        _reg("dropout", f"{_n}_{_c}", _fn_pair(
            lambda a, n=_n, kw=_kw: getattr(JF, n)(a, **kw),
            lambda a, n=_n, kw=_kw: getattr(F, n)(a, **kw),
            _floats(_shape, seed=1)))
for _m, _d, _a in INTERP_CASES:
    _shape = INTERP_SHAPES[_m]
    _nsp = len(_shape) - 2
    _kw = dict(mode=_m, align_corners=_a, data_format={
        3: "NCW", 4: "NCHW", 5: "NCDHW"}[len(_shape)])
    if _d == "up":
        _kw["scale_factor"] = [2.0, 1.5, 1.7][:_nsp]
    else:
        _kw["size"] = [max(s // 2, 1) + i for i, s in enumerate(_shape[2:])]
    _reg("interpolate", f"{_m}-{_d}-{_a}", _fn_pair(
        lambda a, kw=_kw: JF.interpolate(a, **kw),
        lambda a, kw=_kw: F.interpolate(a, **kw),
        _floats(_shape, seed=len(_shape))))
for _j, _kw in enumerate((dict(size=[9, 4], mode="bilinear"),
                          dict(scale_factor=2, mode="nearest"),
                          dict(size=[3, 8], mode="bicubic"))):
    _reg("upsample_nhwc", _kw["mode"], _fn_pair(
        lambda a, kw=_kw: JF.upsample(a, data_format="NHWC", **kw),
        lambda a, kw=_kw: F.upsample(a, data_format="NHWC", **kw),
        _floats((2, 6, 5, 3), seed=9 + _j)))


def _common_layer(case):
    def build():
        kw, shapes = COMMON_LAYERS[case]
        name = case.split("_")[0]
        jl, tl = getattr(jnn, name)(**kw), getattr(tnn, name)(**kw)
        jl.eval()
        tl.eval()
        return jl, tl, _floats(*shapes, seed=sorted(COMMON_LAYERS).index(
            case)), True
    return build


for _c in COMMON_LAYERS:
    _reg("common_layer", _c, _common_layer(_c))


def _bilinear_layer():
    paddle.seed(0)
    jl, tl = jnn.Bilinear(3, 4, 5), tnn.Bilinear(3, 4, 5)
    _copy(tl.weight, jl.weight)
    _copy(tl.bias, jl.bias)
    return jl, tl, _floats((6, 3), (6, 4), seed=1), True


def _spectral_norm():
    paddle.seed(0)
    jl = jnn.SpectralNorm([4, 3, 2], dim=1, power_iters=3)
    tl = tnn.SpectralNorm([4, 3, 2], dim=1, power_iters=3)
    _copy(tl.weight_u, jl.weight_u)
    _copy(tl.weight_v, jl.weight_v)
    return jl, tl, _floats((4, 3, 2), seed=2), True


_reg("weighted_layer", "Bilinear", _bilinear_layer)
_reg("weighted_layer", "SpectralNorm", _spectral_norm)
for _m, _p, _a in GRID_CASES:
    _x, _g = _floats((2, 3, 5, 6), (2, 4, 7, 2),
                     seed=GRID_CASES.index((_m, _p, _a)))
    _kw = dict(mode=_m, padding_mode=_p, align_corners=_a)
    _reg("grid_sample", f"{_m}-{_p}-{_a}", _fn_pair(
        lambda a, b, kw=_kw: JF.grid_sample(a, b, **kw),
        lambda a, b, kw=_kw: F.grid_sample(a, b, **kw),
        [_x, np.clip(_g * 0.8, -1.6, 1.6).astype(np.float32)]))
for _c, (_n, _shape, _kw) in MASK_CASES.items():
    _reg("pool_mask", _c, _fn_pair(
        lambda a, n=_n, kw=_kw: getattr(JF, f"max_pool{n}d")(
            a, return_mask=True, **kw),
        lambda a, n=_n, kw=_kw: getattr(F, f"max_pool{n}d")(
            a, return_mask=True, **kw),
        [_tied(_shape, sorted(MASK_CASES).index(_c))]))


def _round_trip(ns, n, kw, out_size=None):
    pool, unpool = getattr(ns, f"max_pool{n}d"), getattr(ns,
                                                         f"max_unpool{n}d")
    ukw = {k: v for k, v in kw.items() if k != "ceil_mode"}
    if out_size is not None:
        ukw["output_size"] = out_size

    def fn(a):
        o, m = pool(a, return_mask=True, **kw)
        return unpool(o, m, **ukw)
    return fn


for _c in ("2d_k2", "2d_k3s2p1", "1d", "3d", "2d_nhwc"):
    _n, _shape, _kw = MASK_CASES[_c]
    _reg("unpool", _c, _fn_pair(
        _round_trip(JF, _n, _kw), _round_trip(F, _n, _kw),
        [_tied(_shape, 40 + sorted(MASK_CASES).index(_c))]))
_reg("unpool", "2d_output_size", _fn_pair(
    _round_trip(JF, 2, dict(kernel_size=2), [7, 8]),
    _round_trip(F, 2, dict(kernel_size=2), [7, 8]),
    [_tied((2, 3, 6, 7), 50)]))


def _pool_layers(n, kw, shape):
    def build():
        jp = getattr(jnn, f"MaxPool{n}D")(return_mask=True, **kw)
        tp = getattr(tnn, f"MaxPool{n}D")(return_mask=True, **kw)
        ju = getattr(jnn, f"MaxUnPool{n}D")(**kw)
        tu = getattr(tnn, f"MaxUnPool{n}D")(**kw)

        def run(p, u):
            def fn(a):
                o, m = p(a)
                return u(o, m), o, m
            return fn
        return run(jp, ju), run(tp, tu), [_tied(shape, 77 + n)], True
    return build


_reg("pool_layer", "2d_k2", _pool_layers(2, dict(kernel_size=2),
                                         (2, 3, 6, 8)))
_reg("pool_layer", "2d_k3s2p1", _pool_layers(
    2, dict(kernel_size=3, stride=2, padding=1), (2, 3, 6, 8)))
_reg("pool_layer", "1d", _pool_layers(1, dict(kernel_size=2), (2, 3, 8)))
_reg("pool_layer", "3d", _pool_layers(3, dict(kernel_size=2),
                                      (1, 2, 4, 4, 6)))


def _adaptive_ignore():
    jl = jnn.AdaptiveMaxPool2D(2, return_mask=True)
    tl = tnn.AdaptiveMaxPool2D(2, return_mask=True)
    return ((lambda a: (JF.adaptive_max_pool2d(a, 3, return_mask=True),
                        jl(a))),
            (lambda a: (F.adaptive_max_pool2d(a, 3, return_mask=True),
                        tl(a))), [_tied((2, 3, 7, 5), 5)], True)


_reg("adaptive_ignore", "2d", _adaptive_ignore)
for _c, (_fn, _shapes) in MANIP_CASES.items():
    _reg("manipulation", _c, _fn_pair(
        lambda *a, fn=_fn: fn(JM, *a), lambda *a, fn=_fn: fn(TM, *a),
        _floats(*_shapes, seed=sorted(MANIP_CASES).index(_c)),
        grad=_c != "cast"))


def _indexing(case):
    def build():
        fn, shapes, ints = INDEX_CASES[case]
        ji = [paddle.to_tensor(i) for i in ints]
        ti = [torch.from_numpy(i) for i in ints]
        return ((lambda *a: fn(JM, *a, *ji)), (lambda *a: fn(TM, *a, *ti)),
                _floats(*shapes, seed=sorted(INDEX_CASES).index(case)),
                case != "put_along_axis_mul")   # JAX: no gradient there
    return build


for _c in INDEX_CASES:
    _reg("indexing", _c, _indexing(_c))


def _masked(case):
    def build():
        x, v = _floats((4, 3), (2,), seed=3)
        mask = x > 0
        jm, tm = paddle.to_tensor(mask), torch.from_numpy(mask)
        idx = [_i(1, 3), _i(0, 2)]
        jidx = [paddle.to_tensor(i) for i in idx]
        tidx = [torch.from_numpy(i) for i in idx]
        if case.startswith("index_put"):
            acc = case.endswith("accumulate")
            return ((lambda a, b: JM.index_put(a, jidx, b, acc)),
                    (lambda a, b: TM.index_put(a, tidx, b, acc)), [x, v],
                    True)
        if case == "masked_fill":
            return ((lambda a: JM.masked_fill(a, jm, 2.5)),
                    (lambda a: TM.masked_fill(a, tm, 2.5)), [x], True)
        return ((lambda a, b: JM.where(jm, a, b)),
                (lambda a, b: TM.where(tm, a, b)), [x, -x], True)
    return build


for _c in ("index_put", "index_put_accumulate", "masked_fill", "where"):
    _reg("masked", _c, _masked(_c))


def _inplace_manip():
    x, u = _floats((4, 3), (2, 3), seed=6)
    idx = _i(3, 0)

    def run(m, ti):
        def fn(a, b):
            out = m.scatter_(a, ti, b)
            return out, m.reshape_(out, [3, 4])
        return fn
    return (run(JM, paddle.to_tensor(idx)), run(TM, torch.from_numpy(idx)),
            [x, u], False)


_reg("inplace_manipulation", "scatter_reshape", _inplace_manip)


def _one_hot_mask():
    lens = np.array([[3, 0, 5], [1, 2, 4]], np.int64)
    jl, tl = paddle.to_tensor(lens), torch.from_numpy(lens)
    return ((lambda: (JF.one_hot(jl, 6), JF.sequence_mask(jl, 7),
                      JF.sequence_mask(jl, 6, "float32"))),
            (lambda: (F.one_hot(tl, 6), F.sequence_mask(tl, 7).int(),
                      F.sequence_mask(tl, 6, "float32"))), [], False)


_reg("integer", "one_hot_sequence_mask", _one_hot_mask)


# XLA's CPU backend at its lowest optimisation: the references compile in
# less time and compute the same functions
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _unwrap(out):
    if isinstance(out, JTensor):
        return out._data
    if isinstance(out, (list, tuple)):
        return [_unwrap(o) for o in out]
    return out


@pytest.fixture(scope="module")
def jax_refs():
    """``{(family, case): (port_fn, arrays, grad, cotangent, JAX output,
    JAX gradients)}``: every JAX reference of the table from one
    ``jax.jit`` (outputs, and ``jax.vjp`` gradients under a seeded
    cotangent of the first output)."""
    built = {(f, c): b() for f, cases in REG.items()
             for c, b in cases.items()}

    def traced(jfn):
        def fn(*arrs):
            with paddle.no_grad():    # jax.vjp differentiates, not the tape
                return _unwrap(jfn(*[JTensor(a) for a in arrs]))
        return fn

    inputs = {k: [jnp.asarray(a) for a in v[2]] for k, v in built.items()}
    cots = {}
    for i, (k, (_, tfn, arrays, grad)) in enumerate(sorted(built.items())):
        if grad:        # the port's output shape: a wrong one fails _check
            with torch.no_grad():
                shape = _first(tfn(*[torch.from_numpy(a) for a in arrays]))
            cots[k] = np.random.RandomState(i).randn(*shape.shape).astype(
                np.float32)
    flat_in = {f"{f}|{c}": v for (f, c), v in inputs.items()}
    flat_cot = {f"{f}|{c}": jnp.asarray(v) for (f, c), v in cots.items()}

    def run(flat_in, flat_cot):
        res = {}
        for name, args in flat_in.items():
            f, c = name.split("|")
            jfn, _, _, grad = built[f, c]
            fn = traced(jfn)
            if grad:
                def both(*a, fn=fn):
                    out = fn(*a)
                    return _first(out), out

                _, pull, out = jax.vjp(both, *args, has_aux=True)
                res[name] = (out, pull(flat_cot[name]))
            else:
                res[name] = (fn(*args), ())
        return res

    out = jax.device_get(jax.jit(run).lower(flat_in, flat_cot).compile(
        compiler_options=FAST_COMPILE)(flat_in, flat_cot))
    return {k: (v[1], v[2], v[3], cots.get(k), out[f"{k[0]}|{k[1]}"][0],
                out[f"{k[0]}|{k[1]}"][1]) for k, v in built.items()}


def _check(jax_refs, family, case):
    tfn, arrays, grad, cot, jout, jgrads = jax_refs[family, case]
    tt = [torch.tensor(a, requires_grad=grad) for a in arrays]
    tout = tfn(*tt)
    _compare(tout, jout, f"{family} {case}")
    if not grad:
        return
    (_first(tout) * torch.from_numpy(cot)).sum().backward()
    for i, (t, j) in enumerate(zip(tt, jgrads)):
        got = (t.grad if t.grad is not None else torch.zeros_like(t))
        _close(got.numpy(), np.asarray(j), f"{family} {case} grad {i}")


def _cases(family):
    return sorted(REG[family])


@pytest.mark.parametrize("case", _cases("act"))
def test_activation_function_matches_jax(jax_refs, case):
    _check(jax_refs, "act", case)


@pytest.mark.parametrize("case", _cases("prelu"))
def test_prelu_matches_jax(jax_refs, case):
    _check(jax_refs, "prelu", case)


@pytest.mark.parametrize("name", _cases("inplace"))
def test_inplace_activation_matches_jax(jax_refs, name):
    _check(jax_refs, "inplace", name)
    x = torch.randn(3, 4)
    assert getattr(F, name)(x) is x


@pytest.mark.parametrize("name", _cases("act_layer"))
def test_activation_layer_matches_jax(jax_refs, name):
    _check(jax_refs, "act_layer", name)


@pytest.mark.parametrize("case", _cases("pad"))
def test_pad_matches_jax(jax_refs, case):
    _check(jax_refs, "pad", case)


@pytest.mark.parametrize("case", _cases("common"))
def test_common_functional_matches_jax(jax_refs, case):
    _check(jax_refs, "common", case)


@pytest.mark.parametrize("case", _cases("dropout"))
def test_dropouts_eval_and_p0_match_jax(jax_refs, case):
    _check(jax_refs, "dropout", case)


@pytest.mark.parametrize("case", _cases("interpolate"))
def test_interpolate_matches_jax(jax_refs, case):
    _check(jax_refs, "interpolate", case)


@pytest.mark.parametrize("case", _cases("upsample_nhwc"))
def test_interpolate_channels_last_and_upsample_match_jax(jax_refs, case):
    _check(jax_refs, "upsample_nhwc", case)


@pytest.mark.parametrize("case", _cases("common_layer"))
def test_common_layer_matches_jax(jax_refs, case):
    _check(jax_refs, "common_layer", case)


@pytest.mark.parametrize("case", _cases("weighted_layer"))
def test_weighted_layer_matches_jax(jax_refs, case):
    """``Bilinear`` and ``SpectralNorm`` on JAX's weights."""
    _check(jax_refs, "weighted_layer", case)


@pytest.mark.parametrize("case", _cases("grid_sample"))
def test_grid_sample_matches_jax(jax_refs, case):
    _check(jax_refs, "grid_sample", case)


@pytest.mark.parametrize("case", _cases("pool_mask"))
def test_max_pool_mask_matches_jax(jax_refs, case):
    _check(jax_refs, "pool_mask", case)


@pytest.mark.parametrize("case", _cases("unpool"))
def test_max_unpool_round_trip_matches_jax(jax_refs, case):
    _check(jax_refs, "unpool", case)


@pytest.mark.parametrize("case", _cases("pool_layer"))
def test_pool_layers_return_mask_and_unpool_match_jax(jax_refs, case):
    _check(jax_refs, "pool_layer", case)


def test_adaptive_max_pool_return_mask_is_ignored_as_jax(jax_refs):
    """JAX's adaptive max pools accept ``return_mask`` and return the
    pooled tensor alone (``pooling.py:152-163``; ROADMAP.md Queue 3)."""
    _check(jax_refs, "adaptive_ignore", "2d")
    x = torch.zeros(1, 1, 4, 4)
    assert isinstance(F.adaptive_max_pool2d(x, 2, return_mask=True),
                      torch.Tensor)


@pytest.mark.parametrize("case", _cases("manipulation"))
def test_manipulation_matches_jax(jax_refs, case):
    _check(jax_refs, "manipulation", case)


@pytest.mark.parametrize("case", _cases("indexing"))
def test_indexing_matches_jax(jax_refs, case):
    _check(jax_refs, "indexing", case)


@pytest.mark.parametrize("case", _cases("masked"))
def test_index_put_and_masked_match_jax(jax_refs, case):
    _check(jax_refs, "masked", case)


def test_inplace_manipulation_matches_jax(jax_refs):
    _check(jax_refs, "inplace_manipulation", "scatter_reshape")
    x = torch.zeros(4, 3)
    assert TM.scatter_(x, torch.tensor([1]), torch.ones(1, 3)) is x
    assert TM.reshape_(x, [3, 4]) is x and x.shape == (3, 4)


def test_integer_functionals_match_jax(jax_refs):
    _check(jax_refs, "integer", "one_hot_sequence_mask")
    lens = np.array([[3, 0, 5], [1, 2, 4]], np.int64)
    np.testing.assert_array_equal(
        F.sequence_mask(torch.from_numpy(lens)).numpy(),
        JF.sequence_mask(paddle.to_tensor(lens)).numpy())


def test_embedding_takes_jax_sparse_argument():
    """``sparse`` (JAX's fourth argument of ``F.embedding`` and of
    ``nn.Embedding``) is accepted and ignored, as JAX's (ROADMAP.md
    Queue 3)."""
    w = np.random.RandomState(0).randn(6, 3).astype(np.float32)
    ids = np.array([[1, 5], [0, 1]], np.int64)
    want = JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(w),
                        None, True).numpy()
    got = F.embedding(torch.from_numpy(ids), torch.from_numpy(w), None, True)
    np.testing.assert_array_equal(got.numpy(), want)
    layer = tnn.Embedding(6, 3, 0, True, device="cpu")
    assert layer(torch.from_numpy(ids))[1, 0].abs().sum() == 0


def test_hardsigmoid_is_jax_slope_not_torch():
    """0.1666667 x + 0.5, not torch's x / 6 + 0.5."""
    x = torch.tensor([1.0, 2.0, -1.0])
    want = np.clip(np.float32(0.1666667) * x.numpy() + np.float32(0.5),
                   0, 1)
    np.testing.assert_array_equal(F.hardsigmoid(x).numpy(), want)
    assert not torch.equal(F.hardsigmoid(x),
                           torch.nn.functional.hardsigmoid(x))


def test_rrelu_training_draws_from_the_stream():
    """Negative inputs times a slope in [lower, upper]; positive ones
    pass; the same seed draws the same slopes, one key a call."""
    x = -torch.rand(4, 64) - 0.5
    trandom.seed(3)
    a = F.rrelu(x, 0.1, 0.3, training=True)
    k = trandom.get_rng_state()[1]
    trandom.seed(3)
    b = F.rrelu(x, 0.1, 0.3, training=True)
    assert torch.equal(a, b) and k == 1
    slope = a / x
    assert slope.min() >= 0.1 - 1e-6 and slope.max() <= 0.3 + 1e-6
    assert slope.std() > 0.01
    assert torch.equal(F.rrelu(-x, training=True), -x)


def test_gumbel_softmax_properties():
    """Rows on the simplex; ``hard`` gives the one-hot of the soft
    sample's argmax and passes the soft sample's gradient; one key a
    call."""
    x = torch.randn(8, 10, requires_grad=True)
    trandom.seed(11)
    soft = F.gumbel_softmax(x, temperature=0.5)
    trandom.seed(11)
    hard = F.gumbel_softmax(x, temperature=0.5, hard=True)
    assert torch.allclose(soft.sum(-1), torch.ones(8))
    assert torch.equal(hard.argmax(-1), soft.argmax(-1))
    assert torch.allclose(hard.detach(), torch.nn.functional.one_hot(
        soft.argmax(-1), 10).float(), atol=1e-6)
    (hard * torch.arange(10.0)).sum().backward()
    g_hard = x.grad.clone()
    x.grad = None
    (soft * torch.arange(10.0)).sum().backward()
    assert torch.allclose(g_hard, x.grad)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_dropout2d_drops_whole_channels(fmt):
    x = torch.ones(4, 8, 5, 6) if fmt == "NCHW" else torch.ones(4, 5, 6, 8)
    trandom.seed(0)
    y = F.dropout2d(x, 0.5, data_format=fmt)
    dims = (2, 3) if fmt == "NCHW" else (1, 2)
    assert torch.equal(y.amax(dims), y.amin(dims))   # one draw a channel
    assert set(y.amax(dims).unique().tolist()) == {0.0, 2.0}


def test_alpha_dropout_keeps_moments():
    """Dropped values become SELU's saturation, then the affine map
    keeps zero mean and unit variance of a unit normal input."""
    trandom.seed(1)
    x = torch.randn(200000, generator=torch.Generator().manual_seed(0))
    y = F.alpha_dropout(x, 0.2)
    assert abs(y.mean().item()) < 0.02 and abs(y.std().item() - 1) < 0.02
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (0.8 + alpha_p ** 2 * 0.8 * 0.2) ** -0.5
    dropped = torch.tensor(a * alpha_p - a * 0.2 * alpha_p)
    assert (y == dropped).float().mean().item() == pytest.approx(0.2,
                                                                 abs=0.01)


def test_data_dependent_functions_match_jax():
    """``nonzero``, one-argument ``where``, ``unique`` (every return,
    with and without ``axis``), ``unique_consecutive``, ``masked_select``,
    ``shape`` and ``shard_index``, eagerly: values and JAX's int32 index
    dtype."""
    r = np.random.RandomState(0)
    x = r.randint(0, 4, (4, 5)).astype(np.float32)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    _compare(TM.nonzero(tx), JM.nonzero(jx), "nonzero")
    _compare(TM.nonzero(tx, as_tuple=True), JM.nonzero(jx, as_tuple=True),
             "nonzero tuple")
    _compare(TM.where(tx > 1), JM.where(jx > 1), "where one argument")
    _compare(TM.masked_select(tx, tx > 1), JM.masked_select(jx, jx > 1),
             "masked_select")
    kw = dict(return_index=True, return_inverse=True, return_counts=True)
    _compare(TM.unique(tx, **kw), JM.unique(jx, **kw), "unique")
    _compare(TM.unique(tx), JM.unique(jx), "unique values")
    rows = np.array([[1, 2], [0, 5], [1, 2], [0, 1]], np.float32)
    _compare(TM.unique(torch.from_numpy(rows), axis=0, **kw),
             JM.unique(paddle.to_tensor(rows), axis=0, **kw), "unique axis")
    seq = np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int32)
    _compare(TM.unique_consecutive(torch.from_numpy(seq),
                                   return_inverse=True, return_counts=True),
             JM.unique_consecutive(paddle.to_tensor(seq),
                                   return_inverse=True, return_counts=True),
             "unique_consecutive")
    _compare(TM.shape(tx), JM.shape(jx), "shape")
    ids = np.array([[1], [5], [9], [11], [0]], np.int32)
    _compare(TM.shard_index(torch.from_numpy(ids), 12, 3, 1),
             JM.shard_index(paddle.to_tensor(ids), 12, 3, 1), "shard_index")
    assert TM.broadcast_shape([3, 1], [1, 4]) == JM.broadcast_shape([3, 1],
                                                                    [1, 4])
    assert TM.tolist(tx) == JM.tolist(jx)


# --------------------------------------------------------- name sets
def _public(module):
    return {n for n, v in vars(module).items() if not n.startswith("_")
            and callable(v) and getattr(v, "__module__", None)
            == module.__name__}


def test_name_sets_match_jax():
    """Every export of JAX's activation, common, vision and pooling
    functionals, its activation, common, norm and pooling layers,
    ``tensor.manipulation``, ``vision.models`` and ``vision.ops`` exists
    in the port, less the deferrals (``sparse_attention``,
    ``SyncBatchNorm``)."""
    import paddle_tpu.vision.models as jmodels
    import paddle_tpu.vision.ops as jops
    from paddle_tpu.nn.functional import activation as jfa
    from paddle_tpu.nn.functional import common as jfc
    from paddle_tpu.nn.functional import pooling as jfp
    from paddle_tpu.nn.functional import vision as jfv
    from paddle_tpu.nn.layer import activation as jla
    from paddle_tpu.nn.layer import common as jlc
    from paddle_tpu.nn.layer import norm as jln
    from paddle_tpu.nn.layer import pooling as jlp
    from paddle_tpu_torch.vision import models as tmodels
    from paddle_tpu_torch.vision import ops as tops

    deferred = {"sparse_attention", "SyncBatchNorm"}
    functionals = set().union(*(_public(m) for m in (jfa, jfc, jfp, jfv)))
    functionals |= {"normalize", "local_response_norm", "elu_"}
    assert len(_public(jfa)) == 31
    assert functionals - deferred - set(dir(F)) == set()
    layers = set().union(*({n for n in _public(m) if n[0].isupper()}
                           for m in (jla, jlc, jln, jlp))) - deferred
    assert len(_public(jla)) == 29
    assert layers - set(tnn.__all__) == set()
    assert len(_public(JM)) == 75 and set(TM.__all__) == _public(JM)
    zoo = {n for n in dir(jmodels) if not n.startswith("_")
           and callable(getattr(jmodels, n))}
    assert zoo - set(tmodels.__all__) == set()
    assert set(jops.__all__) == set(tops.__all__)
