"""The port's ``vision.ops`` against the JAX package's on numpy-seeded
inputs on the CPU: ``box_iou``, ``nms`` (categories, ``top_k``, equal
scores, the default scores), ``roi_align`` (sampling ratios 2 and -1,
``aligned`` or not, a spatial scale), ``roi_pool`` (overlapping bins,
RoIs past the map's edge, empty bins) and ``box_coder`` (encode and
decode, per-prior and shared variances, normalised or not).

``nms`` indices are held exactly (and their int32 dtype); float outputs
to 1e-5 of their largest magnitude, and ``roi_align``'s and
``roi_pool``'s gradient to the map under one random cotangent to 1e-5
of its largest.  The JAX references of the float ops come from one
``jax.jit`` (a module fixture); JAX's ``nms`` sizes its result on the
host, so it runs eagerly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.ops as JV
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu_torch.vision import ops as TV

from _torch_port_util import one_thread  # noqa: F401


def _boxes(rng, n, size=32.0, min_wh=1.0):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(min_wh, size * 0.5, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


NMS_CASES = {
    "plain": dict(n=64, iou_threshold=0.5),
    "low_threshold": dict(n=48, iou_threshold=0.1),
    "categories_top_k": dict(n=80, iou_threshold=0.4, categories=4,
                             top_k=10),
    "equal_scores": dict(n=40, iou_threshold=0.3, ties=True),
    "default_scores": dict(n=30, iou_threshold=0.3, no_scores=True),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_matches_jax_exactly(case):
    kw = dict(NMS_CASES[case])
    rng = np.random.RandomState(sorted(NMS_CASES).index(case))
    boxes = _boxes(rng, kw.pop("n"))
    n = boxes.shape[0]
    scores = (np.round(rng.uniform(0, 1, n) * 4) / 4 if kw.pop("ties", False)
              else rng.uniform(0, 1, n)).astype(np.float32)
    if kw.pop("no_scores", False):
        scores = None
    cats = kw.pop("categories", None)
    cidx = None if cats is None else rng.randint(0, cats, n)
    jkw = dict(kw, scores=None if scores is None else paddle.to_tensor(
        scores), category_idxs=None if cidx is None else paddle.to_tensor(
        cidx), categories=cats)
    tkw = dict(kw, scores=None if scores is None else torch.from_numpy(
        scores), category_idxs=None if cidx is None else torch.from_numpy(
        cidx), categories=cats)
    want = JV.nms(paddle.to_tensor(boxes), **jkw).numpy()
    got = TV.nms(torch.from_numpy(boxes), **tkw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < len(want) < n


def test_greedy_walk_keeps_the_first_of_a_chain():
    """a suppresses b, b would suppress c: b goes, so c stays."""
    sup = np.zeros((3, 3), bool)
    sup[0, 1] = sup[1, 2] = True
    assert TV.greedy_keep(sup).tolist() == [True, False, True]


def _map(rng, n=2, c=3, h=12, w=10):
    return rng.randn(n, c, h, w).astype(np.float32)


def _rois(rng, counts, h=12, w=10, scale=1.0):
    boxes = []
    for _ in range(sum(counts)):
        x1, y1 = rng.uniform(-2, w * 0.7) / scale, rng.uniform(
            -2, h * 0.7) / scale
        boxes.append([x1, y1, x1 + rng.uniform(0.5, w) / scale,
                      y1 + rng.uniform(0.5, h) / scale])
    return np.array(boxes, np.float32), np.array(counts, np.int32)


ROI_CASES = {
    "align_s2": ("roi_align", dict(output_size=3, sampling_ratio=2)),
    "align_default": ("roi_align", dict(output_size=(2, 3))),
    "align_unaligned_scale": ("roi_align", dict(
        output_size=2, spatial_scale=0.5, sampling_ratio=3, aligned=False)),
    "pool": ("roi_pool", dict(output_size=3)),
    "pool_rect_scale": ("roi_pool", dict(output_size=(4, 2),
                                         spatial_scale=0.5)),
}


def _roi_inputs(case):
    rng = np.random.RandomState(10 + sorted(ROI_CASES).index(case))
    x = _map(rng)
    scale = ROI_CASES[case][1].get("spatial_scale", 1.0)
    boxes, num = _rois(rng, [3, 4], scale=scale)
    return x, boxes, num


_x = np.zeros((1, 1, 5, 1), np.float32)
_x[0, 0] = np.array([[0], [1], [9], [2], [3]], np.float32)
OVERLAP = (_x, np.array([[0, 0, 0, 4], [5, 9, 7, 12]], np.float32),
           np.array([2], np.int32))


@pytest.fixture(scope="module")
def jax_refs():
    """``{case: (output, map gradient, cotangent)}`` of every RoI case
    and ``box_coder``/``box_iou`` outputs, from one ``jax.jit``."""
    def roi_fn(case):
        op, kw = ROI_CASES[case]
        _, boxes, num = _roi_inputs(case)

        def fn(x):
            with paddle.no_grad():
                return getattr(JV, op)(JTensor(x), JTensor(
                    jnp.asarray(boxes)), JTensor(jnp.asarray(num)),
                    **kw)._data
        return fn

    cots, xs = {}, {}
    for case in ROI_CASES:
        x, boxes, num = _roi_inputs(case)
        op, kw = ROI_CASES[case]
        with torch.no_grad():
            shape = getattr(TV, op)(torch.from_numpy(x), torch.from_numpy(
                boxes), torch.from_numpy(num), **kw).shape
        xs[case] = x
        cots[case] = np.random.RandomState(1).randn(*shape).astype(
            np.float32)

    def run(xs, cots, coder_in):
        res = {}
        for case in ROI_CASES:
            out, pull = jax.vjp(roi_fn(case), xs[case])
            res[case] = (out, pull(cots[case])[0])
        res["coder"] = {k: _coder(JV, JTensor, *v, CODER_CASES[k][3])._data
                        for k, v in coder_in.items()}
        res["overlap"] = JV.roi_pool(*[JTensor(jnp.asarray(a))
                                       for a in OVERLAP],
                                     output_size=(2, 1))._data
        res["iou"] = JV.box_iou(JTensor(coder_in["encode"][0]),
                                JTensor(coder_in["encode"][2]))._data
        return res

    out = jax.device_get(jax.jit(run)(
        {k: jnp.asarray(v) for k, v in xs.items()},
        {k: jnp.asarray(v) for k, v in cots.items()},
        {k: tuple(None if a is None else jnp.asarray(a) for a in v[:3])
         for k, v in CODER_CASES.items()}))
    return out, xs, cots


@pytest.mark.parametrize("case", sorted(ROI_CASES))
def test_roi_op_matches_jax(jax_refs, case):
    refs, xs, cots = jax_refs
    want, want_grad = refs[case]
    _, boxes, num = _roi_inputs(case)
    op, kw = ROI_CASES[case]
    x = torch.tensor(xs[case], requires_grad=True)
    out = getattr(TV, op)(x, torch.from_numpy(boxes), torch.from_numpy(num),
                          **kw)
    scale = np.abs(want).max()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=1e-5 * scale, err_msg=case)
    (out * torch.from_numpy(cots[case])).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max(),
                               err_msg=f"{case} grad")


def test_roi_pool_overlapping_bins(jax_refs):
    """A roi of height 5 pooled to 2 bins: the bins overlap at pixel 2,
    so its maximum appears in both (as JAX's regression test); an RoI
    wholly off the map gives zeros."""
    x, boxes, num = OVERLAP
    got = TV.roi_pool(torch.from_numpy(x), torch.from_numpy(boxes),
                      torch.from_numpy(num), output_size=(2, 1)).numpy()
    np.testing.assert_array_equal(got, jax_refs[0]["overlap"])
    assert got[0, 0, :, 0].tolist() == [9.0, 9.0]
    assert not got[1].any()


def _coder(ns, wrap, prior, var, target, kind):
    return ns.box_coder(wrap(prior), None if var is None else wrap(var),
                        wrap(target), **CODER_KW[kind])


_r = np.random.RandomState(3)
_priors, _targets = _boxes(_r, 6), _boxes(_r, 4)
_deltas = (_r.randn(4, 6, 4) * 0.2).astype(np.float32)
CODER_KW = {"encode": dict(code_type="encode_center_size"),
            "encode_pixels": dict(code_type="encode_center_size",
                                  box_normalized=False),
            "decode": dict(code_type="decode_center_size"),
            "decode_2d_pixels": dict(code_type="decode_center_size",
                                     box_normalized=False)}
CODER_CASES = {
    "encode": (_priors, np.full((6, 4), 0.5, np.float32) + _r.uniform(
        0, 0.5, (6, 4)).astype(np.float32), _targets, "encode"),
    "encode_shared_var_pixels": (_priors, np.array(
        [0.1, 0.1, 0.2, 0.2], np.float32), _targets, "encode_pixels"),
    "encode_no_var": (_priors, None, _targets, "encode"),
    "decode": (_priors, np.array([0.1, 0.1, 0.2, 0.2], np.float32),
               _deltas, "decode"),
    "decode_2d_pixels": (_priors, None, _deltas[0], "decode_2d_pixels"),
}


@pytest.mark.parametrize("case", sorted(CODER_CASES))
def test_box_coder_matches_jax(jax_refs, case):
    want = jax_refs[0]["coder"][case]
    got = _coder(TV, torch.from_numpy, *CODER_CASES[case])
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max(), err_msg=case)


def test_box_coder_round_trip():
    """Decoding the encoding of targets against each prior gives the
    targets back."""
    p, v, t, _ = CODER_CASES["encode"]
    p, v, t = (torch.from_numpy(a).double() for a in (p, v, t))
    enc = TV.box_coder(p, v, t)                   # [targets, priors, 4]
    dec = TV.box_coder(p, v, enc, code_type="decode_center_size")
    assert torch.allclose(dec, t[:, None, :].expand_as(dec), atol=1e-9)


def test_box_iou_matches_jax(jax_refs):
    want = jax_refs[0]["iou"]
    got = TV.box_iou(torch.from_numpy(_priors), torch.from_numpy(_targets))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (want > 0).any()
