"""``paddle.vision.ops``, the counterparts of ``paddle_tpu/vision/ops.py``:
``box_iou``, ``nms``, ``roi_align``, ``roi_pool`` and ``box_coder``.  Each
runs where its tensors lie (the card, for a detection head there) and
computes JAX's function.

* :func:`nms` is JAX's greedy suppression (``ops.py:41-82``: boxes in
  score order, stable among equal scores; each kept box suppresses every
  later one whose IoU with it exceeds the threshold), but not as JAX's
  ``n`` sequential steps, which on the card would be ``n`` rounds of
  kernel launches: the score-sorted matrix of "box i suppresses later box
  j" is built on the device in one pass, copied to the host once, and
  walked there row by row.  Categories offset each box by ``category x
  (max coordinate + 1)``, as JAX's.  Returns int32 indices.
* :func:`roi_align` samples a fixed ``sampling_ratio`` (2 for -1, as
  JAX's; upstream Paddle adapts it to the RoI, ROADMAP.md Queue 3) points
  a bin and axis, bilinear from the four neighbours (clamped into the
  map), as one gather of every RoI's points from the channels-last map;
  the bin widths are divided exactly (``exact_div``), as JAX's, so the
  card samples where the CPU does.
* :func:`roi_pool` takes the exact max over JAX's overlapping bins
  (``[floor(i L / n), ceil((i + 1) L / n))`` of each rounded RoI, cut to
  the map; an empty bin gives 0) from a two-dimensional sparse table
  of the map (the max over every ``2^a x 2^b`` window, up to the largest
  bin), four lookups a bin; the bins are computed on the host from the
  boxes, copied there once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.functional_vision import exact_div


def box_iou(boxes1, boxes2):
    """Pairwise IoU ``[N, M]`` of boxes in xyxy."""
    a, b = boxes1, boxes2
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter).clamp(min=1e-10)


def suppression_matrix(boxes, scores, iou_threshold):
    """``(order, S)``: the stable descending score order, and the bool
    matrix ``S[i, j]`` = later box ``j`` overlaps box ``i`` of that order
    by more than ``iou_threshold``, with JAX's arithmetic
    (``ops.py:49-57``), on the boxes' device."""
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(b[:, None, :2], b[None, :, :2])
    rb = torch.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / (area[:, None] + area[None, :] - inter).clamp(min=1e-10)
    n = b.shape[0]
    later = torch.ones((n, n), dtype=torch.bool, device=b.device).triu(1)
    return order, later & (iou > iou_threshold)


def greedy_keep(suppress):
    """The greedy walk over a host bool matrix: box ``i`` (in order) is
    kept unless a kept box before it suppresses it."""
    n = suppress.shape[0]
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            keep[suppress[i]] = False
    return keep


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Kept box indices (int32, on the boxes' device) in descending score
    order; ``scores`` default to the boxes' reverse order; with
    ``category_idxs`` boxes of different categories never suppress each
    other; at most ``top_k``."""
    b = boxes
    n = b.shape[0]
    s = (scores if scores is not None else
         torch.arange(n, 0, -1, dtype=torch.float32, device=b.device))
    if category_idxs is not None:
        offset = category_idxs.to(b.dtype) * (b.max() + 1.0)
        b = b + offset[:, None]
    order, sup = suppression_matrix(b, s, float(iou_threshold))
    keep = greedy_keep(sup.cpu().numpy())
    kept = order.cpu().numpy()[np.nonzero(keep)[0]]
    if top_k is not None:
        kept = kept[:top_k]
    return torch.from_numpy(kept.astype(np.int32)).to(b.device)


def _rois_image(boxes_num, r, device):
    counts = torch.as_tensor(boxes_num, device=device).long()
    return torch.repeat_interleave(
        torch.arange(counts.shape[0], device=device), counts, output_size=r)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """RoIAlign: ``x`` [N, C, H, W], ``boxes`` [R, 4] xyxy in input
    coordinates, ``boxes_num`` [N] RoIs an image -> [R, C, out_h, out_w]
    (``ops.py:85-165``)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    out_h, out_w = output_size
    n, c, h, w = x.shape
    r = boxes.shape[0]
    img = _rois_image(boxes_num, r, x.device)
    off = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - off
    y1 = boxes[:, 1] * spatial_scale - off
    roi_w = boxes[:, 2] * spatial_scale - off - x1
    roi_h = boxes[:, 3] * spatial_scale - off - y1
    if not aligned:
        roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
    bin_w, bin_h = exact_div(roi_w, out_w), exact_div(roi_h, out_h)
    ns = sampling_ratio if sampling_ratio > 0 else 2
    kw = dict(dtype=boxes.dtype, device=x.device)
    frac = exact_div(torch.arange(ns, **kw) + 0.5, ns)
    ys = (y1[:, None, None] + (torch.arange(out_h, **kw)[None, :, None]
                               + frac[None, None, :]) * bin_h[:, None, None])
    xs = (x1[:, None, None] + (torch.arange(out_w, **kw)[None, :, None]
                               + frac[None, None, :]) * bin_w[:, None, None])
    shape = (r, out_h, ns, out_w, ns)
    yy = ys[:, :, :, None, None].expand(shape).clamp(0.0, h - 1.0)
    xx = xs[:, None, None, :, :].expand(shape).clamp(0.0, w - 1.0)
    y0, x0 = torch.floor(yy).long(), torch.floor(xx).long()
    y1_, x1_ = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    wy, wx = (yy - y0)[..., None], (xx - x0)[..., None]
    rows = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    base = img[:, None, None, None, None] * (h * w)

    def at(yi, xi):
        return rows.index_select(0, (base + yi * w + xi).reshape(-1)) \
            .reshape(shape + (c,))

    vals = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1_) * (1 - wy) * wx
            + at(y1_, x0) * wy * (1 - wx) + at(y1_, x1_) * wy * wx)
    return vals.mean(dim=(2, 4)).permute(0, 3, 1, 2)


def _roi_bins(boxes, spatial_scale, out_h, out_w, h, w):
    """Host int64 ``[R, out, 2]`` [start, end) rows and columns of each
    bin, cut to the map (``ops.py:188-214``, in float32 as JAX)."""
    f32 = np.float32
    b = boxes.astype(f32) * f32(spatial_scale)
    x1, y1, x2, y2 = (np.round(b[:, i]).astype(np.int64) for i in range(4))
    roi_w = np.maximum(x2 - x1 + 1, 1)
    roi_h = np.maximum(y2 - y1 + 1, 1)

    def bins(lo, length, n_bins, size):
        i = np.arange(n_bins, dtype=f32)[None, :]
        ln = length.astype(f32)[:, None]
        start = np.floor(i * ln / f32(n_bins)).astype(np.int64)
        end = np.ceil((i + 1) * ln / f32(n_bins)).astype(np.int64)
        end = np.minimum(end, length[:, None])
        return np.stack([np.clip(lo[:, None] + start, 0, size),
                         np.clip(lo[:, None] + end, 0, size)], -1)

    return bins(y1, roi_h, out_h, h), bins(x1, roi_w, out_w, w)


def _levels(n):
    return max(int(n).bit_length() - 1, 0)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """RoIPool: the max of each bin of each rounded RoI (see the module
    docstring), 0 for an empty bin -> [R, C, out_h, out_w]."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    out_h, out_w = output_size
    n, c, h, w = x.shape
    r = boxes.shape[0]
    img = np.repeat(np.arange(n), np.asarray(
        torch.as_tensor(boxes_num).cpu().numpy(), np.int64))
    ybins, xbins = _roi_bins(boxes.detach().cpu().numpy(), spatial_scale,
                             out_h, out_w, h, w)
    ylen, xlen = ybins[..., 1] - ybins[..., 0], xbins[..., 1] - xbins[..., 0]
    ky_max, kx_max = _levels(max(ylen.max(), 1)), _levels(max(xlen.max(), 1))
    # table[a][b][n, y, x] = max of the map over [y, y + 2^a) x [x, x + 2^b)
    neg = torch.finfo(x.dtype).min
    level = x.permute(0, 2, 3, 1)
    rows_of_a = []
    for a in range(ky_max + 1):
        if a:
            s = 1 << (a - 1)
            level = torch.maximum(level, torch.nn.functional.pad(
                level[:, s:], (0, 0, 0, 0, 0, s), value=neg))
        cols = [level]
        for b in range(1, kx_max + 1):
            s = 1 << (b - 1)
            prev = cols[-1]
            cols.append(torch.maximum(prev, torch.nn.functional.pad(
                prev[:, :, s:], (0, 0, 0, s), value=neg)))
        rows_of_a.append(torch.stack(cols))
    table = torch.stack(rows_of_a).reshape(-1, c)
    ky = np.array([_levels(v) for v in np.maximum(ylen, 1).ravel()]
                  ).reshape(ylen.shape)
    kx = np.array([_levels(v) for v in np.maximum(xlen, 1).ravel()]
                  ).reshape(xlen.shape)
    # an empty bin (zeroed below) may start past the map: clamp its reads
    y_lo, x_lo = np.minimum(ybins[..., 0], h - 1), np.minimum(xbins[..., 0],
                                                              w - 1)
    y_hi = np.clip(ybins[..., 1] - (1 << ky), y_lo, h - 1)
    x_hi = np.clip(xbins[..., 1] - (1 << kx), x_lo, w - 1)
    plane = n * h * w

    def flat(a, b, yv, xv):
        return ((a[:, :, None] * (kx_max + 1) + b[:, None, :]) * plane
                + img[:, None, None] * (h * w) + yv[:, :, None] * w
                + xv[:, None, :])

    idx = np.stack([flat(ky, kx, yv, xv) for yv in (y_lo, y_hi)
                    for xv in (x_lo, x_hi)], -1)
    got = table.index_select(0, torch.from_numpy(idx.reshape(-1)).to(
        x.device)).reshape(r, out_h, out_w, 4, c).amax(dim=3)
    empty = torch.from_numpy((ylen[:, :, None] <= 0) | (xlen[:, None, :]
                                                       <= 0)).to(x.device)
    return torch.where(empty[..., None], 0.0, got).permute(0, 3, 1, 2)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0):
    """Encode target boxes against priors into (dx, dy, dw, dh) ``[N, M,
    4]``, or decode deltas back into xyxy boxes (``ops.py:219-268``)."""
    if axis != 0:
        raise NotImplementedError("box_coder axis=1 layout not supported")
    pb, tb = prior_box, target_box
    pbv = prior_box_var
    if pbv is not None and pbv.dim() == 1:
        pbv = pbv[None, :].expand(pb.shape[0], 4)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw * 0.5
    pcy = pb[:, 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw * 0.5
        tcy = tb[:, 1] + th * 0.5
        out = torch.stack([(tcx[:, None] - pcx[None, :]) / pw[None, :],
                           (tcy[:, None] - pcy[None, :]) / ph[None, :],
                           torch.log(tw[:, None] / pw[None, :]),
                           torch.log(th[:, None] / ph[None, :])], dim=-1)
        return out if pbv is None else out / pbv[None, :, :]
    if code_type == "decode_center_size":
        d = tb[None] if tb.dim() == 2 else tb
        if pbv is not None:
            d = d * pbv[None, :, :]
        dcx = d[..., 0] * pw + pcx
        dcy = d[..., 1] * ph + pcy
        dw = torch.exp(d[..., 2]) * pw
        dh = torch.exp(d[..., 3]) * ph
        out = torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                           dcx + dw * 0.5 - norm, dcy + dh * 0.5 - norm],
                          dim=-1)
        return out[0] if tb.dim() == 2 else out
    raise ValueError(f"unknown code_type {code_type}")


__all__ = ["box_iou", "nms", "roi_align", "roi_pool", "box_coder"]
