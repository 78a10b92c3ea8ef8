"""``grid_sample``, ``affine_grid`` and ``temporal_shift``, the
counterparts of ``paddle_tpu/nn/functional/vision.py``; re-exported by
:mod:`paddle_tpu_torch.nn.functional`.

JAX's arithmetic term for term (``torch.nn.functional.grid_sample``
reflects and rounds by other rules): grid coordinates unnormalised by
``align_corners``, ``reflection`` folded into ``[0, size - 1]`` (or
``[-0.5, size - 0.5]`` and clipped), ``border`` clipped; ``nearest``
rounds half to even; ``bilinear`` weighs the four neighbours, each
outside the image read as 0.  Gathers of the flattened planes, so the
gradient reaches the image and, through the bilinear weights, the grid.
"""

from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs


def exact_div(a, n):
    """``a / n`` correctly rounded on every device, as JAX's division: a
    CUDA kernel divides by a Python number as a product with its
    reciprocal, one ulp off for most divisors (RoIAlign's bin widths,
    ``affine_grid``'s centres), so the divisor goes in as a tensor."""
    return a / torch.full((), n, dtype=a.dtype, device=a.device)


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _reflect(x, lo, hi):
    rng = hi - lo
    if rng <= 0:
        return torch.zeros_like(x)
    x = torch.remainder((x - lo).abs(), 2 * rng)
    return lo + torch.where(x > rng, 2 * rng - x, x)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """``x`` [N, C, H, W] sampled at ``grid`` [N, Hg, Wg, 2] (x, y in
    [-1, 1]) -> [N, C, Hg, Wg] (``vision.py:31-85``)."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample mode {mode!r} not supported")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"grid_sample padding_mode {padding_mode!r}")
    x, grid = cast_inputs("grid_sample", x, grid)
    n, c, h, w = x.shape
    gx = _unnormalize(grid[..., 0], w, align_corners)
    gy = _unnormalize(grid[..., 1], h, align_corners)
    if padding_mode == "reflection":
        if align_corners:
            gx, gy = _reflect(gx, 0.0, w - 1.0), _reflect(gy, 0.0, h - 1.0)
        else:
            gx = _reflect(gx, -0.5, w - 0.5).clamp(0, w - 1)
            gy = _reflect(gy, -0.5, h - 0.5).clamp(0, h - 1)
    elif padding_mode == "border":
        gx, gy = gx.clamp(0, w - 1), gy.clamp(0, h - 1)
    flat = x.reshape(n, c, h * w)
    hg, wg = grid.shape[1:3]

    def gather(iy, ix):
        inside = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
        idx = (iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long())
        out = flat.gather(2, idx.reshape(n, 1, hg * wg).expand(n, c, -1))
        return out.reshape(n, c, hg, wg) * inside[:, None].to(x.dtype)

    if mode == "nearest":
        return gather(torch.round(gy), torch.round(gx))
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    wx, wy = (gx - x0)[:, None], (gy - y0)[:, None]
    return (gather(y0, x0) * (1 - wy) * (1 - wx)
            + gather(y0, x1) * (1 - wy) * wx
            + gather(y1, x0) * wy * (1 - wx) + gather(y1, x1) * wy * wx)


def affine_grid(theta, out_shape, align_corners=True):
    """``theta`` [N, 2, 3] -> the sampling grid [N, H, W, 2] of
    ``out_shape`` (N, C, H, W)."""
    (theta,) = cast_inputs("affine_grid", theta)
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    n, c, h, w = [int(v) for v in out_shape]
    kw = dict(dtype=theta.dtype, device=theta.device)
    if align_corners:
        xs, ys = torch.linspace(-1.0, 1.0, w, **kw), torch.linspace(
            -1.0, 1.0, h, **kw)
    else:
        xs = exact_div(torch.arange(w, **kw) * 2 + 1, w) - 1.0
        ys = exact_div(torch.arange(h, **kw) * 2 + 1, h) - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,njk->nhwj", base, theta)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """TSM's shift of ``x`` [N T, C, H, W]: the first ``C shift_ratio``
    channels from the step before, the next as many from the step after
    (zeros past either end), the rest unchanged."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(data_format)
    (x,) = cast_inputs("temporal_shift", x)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    a = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    padded = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 0, 1, 1))
    out = torch.cat([padded[:, :seg_num, :fold],
                     padded[:, 2:, fold:2 * fold], a[:, :, 2 * fold:]],
                    dim=2).reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


__all__ = ["affine_grid", "grid_sample", "temporal_shift"]
