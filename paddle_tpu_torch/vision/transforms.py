"""Image transforms, the counterparts of ``paddle_tpu/vision/transforms.py``.

NumPy on the host, as JAX's: images are HWC NumPy arrays (or CHW, told
apart by the same rule) or CPU torch tensors; ``ToTensor`` turns HWC
uint8 into a CHW float32 tensor scaled by 1/255.  The random transforms
draw from Python's ``random`` with JAX's calls in JAX's order, so under
one ``random.seed`` they make the same choices.

``Resize`` computes ``jax.image.resize``'s function in NumPy float32
(:func:`_resize_np`): half-pixel centres, and for linear and cubic
kernels JAX's default ``antialias=True``, which widens the kernel by the
downscaling factor (``F.interpolate`` computes another function); a
uint8 image is cast back by the truncating ``clip(0, 255).astype``.
"""

from __future__ import annotations

import random as pyrandom

import numpy as np
import torch

from ..nn._resize import keys_cubic, nearest_index, triangle, weight_mat


def _resize_np(arr, shape, method):
    """``jax.image.resize(arr, shape, method)`` of a float32 array."""
    out = arr
    for d, (m, n) in enumerate(zip(arr.shape, shape)):
        if m == n:
            continue
        if method == "nearest":
            out = np.take(out, nearest_index(m, n), axis=d)
            continue
        w = weight_mat(m, n, triangle if method == "linear" else keys_cubic)
        out = np.moveaxis(np.tensordot(out, w, axes=([d], [0])), -1, d)
    return np.ascontiguousarray(out, dtype=np.float32)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


def _as_np(img):
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = _as_np(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        else:
            arr = arr.astype(np.float32)
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(arr))


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = _as_np(img).astype(np.float32)
        if self.data_format == "CHW":
            shape = (-1, 1, 1)
        else:
            shape = (1, 1, -1)
        out = (arr - self.mean.reshape(shape)) / self.std.reshape(shape)
        return torch.from_numpy(out) if isinstance(img, torch.Tensor) \
            else out


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = _as_np(img)
        chw = _is_chw(arr)
        h, w = arr.shape[1:3] if chw else arr.shape[:2]
        th, tw = self.size
        if chw:
            tgt = (arr.shape[0], th, tw)
        else:
            tgt = (th, tw) + ((arr.shape[2],) if arr.ndim == 3 else ())
        method = {"bilinear": "linear", "nearest": "nearest",
                  "bicubic": "cubic"}[self.interpolation]
        out = _resize_np(arr.astype(np.float32), tgt, method)
        if arr.dtype == np.uint8:
            out = out.clip(0, 255).astype(np.uint8)
        return out


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def _apply_image(self, img):
        arr = _as_np(img)
        chw = _is_chw(arr)
        h, w = arr.shape[1:3] if chw else arr.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        if chw:
            return arr[:, i:i + th, j:j + tw]
        return arr[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.padding = padding

    def _apply_image(self, img):
        arr = _as_np(img)
        chw = _is_chw(arr)
        if self.padding:
            p = (self.padding if isinstance(self.padding, (list, tuple))
                 else [self.padding] * 4)
            if chw:
                arr = np.pad(arr, [(0, 0), (p[1], p[3]), (p[0], p[2])])
            else:
                pads = [(p[1], p[3]), (p[0], p[2])] + (
                    [(0, 0)] if arr.ndim == 3 else [])
                arr = np.pad(arr, pads)
        h, w = arr.shape[1:3] if chw else arr.shape[:2]
        th, tw = self.size
        i = pyrandom.randint(0, max(h - th, 0))
        j = pyrandom.randint(0, max(w - tw, 0))
        if chw:
            return arr[:, i:i + th, j:j + tw]
        return arr[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        arr = _as_np(img)
        if pyrandom.random() < self.prob:
            chw = _is_chw(arr)
            return arr[:, :, ::-1].copy() if chw else arr[:, ::-1].copy()
        return arr


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        arr = _as_np(img)
        if pyrandom.random() < self.prob:
            chw = _is_chw(arr)
            return arr[:, ::-1].copy() if chw else arr[::-1].copy()
        return arr


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size, interpolation)

    def _apply_image(self, img):
        import math

        arr = _as_np(img)
        chw = _is_chw(arr)
        h, w = arr.shape[1:3] if chw else arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * pyrandom.uniform(*self.scale)
            aspect = math.exp(pyrandom.uniform(math.log(self.ratio[0]),
                                               math.log(self.ratio[1])))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                i = pyrandom.randint(0, h - ch)
                j = pyrandom.randint(0, w - cw)
                crop = (arr[:, i:i + ch, j:j + cw] if chw
                        else arr[i:i + ch, j:j + cw])
                return self._resize(crop)
        return self._resize(CenterCrop(min(h, w))(arr))


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = _as_np(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr.transpose(self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        arr = _as_np(img).astype(np.float32)
        factor = pyrandom.uniform(max(0, 1 - self.value), 1 + self.value)
        if _as_np(img).dtype == np.uint8:
            return (arr * factor).clip(0, 255).astype(np.uint8)
        return arr * factor


# functional API
def to_tensor(pic, data_format="CHW"):
    return ToTensor(data_format)(pic)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    arr = _as_np(img)
    chw = _is_chw(arr)
    return arr[:, :, ::-1].copy() if chw else arr[:, ::-1].copy()


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


def crop(img, top, left, height, width):
    arr = _as_np(img)
    chw = _is_chw(arr)
    if chw:
        return arr[:, top:top + height, left:left + width]
    return arr[top:top + height, left:left + width]


def _is_chw(arr):
    return (arr.ndim == 3 and arr.shape[0] in (1, 3)
            and arr.shape[0] < arr.shape[2])


def _to_hwc(arr):
    return (arr.transpose(1, 2, 0), True) if _is_chw(arr) else (arr, False)


def _from_hwc(arr, was_chw):
    return arr.transpose(2, 0, 1) if was_chw else arr


def vflip(img):
    arr = _as_np(img)
    chw = _is_chw(arr)
    return arr[:, ::-1].copy() if chw else arr[::-1].copy()


def pad(img, padding, fill=0, padding_mode="constant"):
    arr = _as_np(img)
    if isinstance(padding, int):
        pl = pt = pr = pb = padding
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    hwc, was_chw = _to_hwc(arr if arr.ndim == 3 else arr[..., None])
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    out = np.pad(hwc, ((pt, pb), (pl, pr), (0, 0)), mode=mode, **kw)
    out = _from_hwc(out, was_chw)
    if arr.ndim == 2:
        out = out[..., 0] if not was_chw else out[0]
    return out


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotation via inverse affine sampling (nearest / bilinear)."""
    arr = _as_np(img)
    squeeze2d = arr.ndim == 2
    if squeeze2d:
        arr = arr[..., None]
    hwc, was_chw = _to_hwc(arr)
    h, w = hwc.shape[:2]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None \
        else (center[1], center[0])
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    if expand:
        new_w = int(np.ceil(abs(w * cos) + abs(h * sin)))
        new_h = int(np.ceil(abs(w * sin) + abs(h * cos)))
    else:
        new_w, new_h = w, h
    oy, ox = (new_h - 1) / 2.0, (new_w - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(new_h), np.arange(new_w), indexing="ij")
    # inverse rotation from output to input coords
    xs = (xx - ox) * cos + (yy - oy) * sin + cx
    ys = -(xx - ox) * sin + (yy - oy) * cos + cy
    if interpolation == "bilinear":
        x0 = np.floor(xs).astype(int)
        y0 = np.floor(ys).astype(int)
        dx = (xs - x0)[..., None]
        dy = (ys - y0)[..., None]

        def sample(yi, xi):
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = hwc[np.clip(yi, 0, h - 1),
                    np.clip(xi, 0, w - 1)].astype(np.float32)
            return np.where(valid[..., None], v, fill)

        out = ((1 - dy) * (1 - dx) * sample(y0, x0)
               + (1 - dy) * dx * sample(y0, x0 + 1)
               + dy * (1 - dx) * sample(y0 + 1, x0)
               + dy * dx * sample(y0 + 1, x0 + 1))
        out = out.astype(hwc.dtype)
    else:
        xi = np.round(xs).astype(int)
        yi = np.round(ys).astype(int)
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        out = hwc[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        out = np.where(valid[..., None], out, fill).astype(hwc.dtype)
    out = _from_hwc(out, was_chw)
    if squeeze2d:
        out = out[0] if was_chw else out[..., 0]
    return out


def adjust_brightness(img, brightness_factor):
    arr = _as_np(img)
    out = arr.astype(np.float32) * brightness_factor
    return out.clip(0, 255).astype(np.uint8) if arr.dtype == np.uint8 else out


def adjust_contrast(img, contrast_factor):
    arr = _as_np(img)
    f = arr.astype(np.float32)
    hwc, _ = _to_hwc(f if f.ndim == 3 else f[..., None])
    # grayscale mean (ITU-R 601 luma) as the contrast pivot, like the ref
    gray = hwc[..., 0] * 0.299 + hwc[..., -1] * 0.114 + \
        (hwc[..., 1] if hwc.shape[-1] >= 2 else hwc[..., 0]) * 0.587
    mean = gray.mean()
    out = f * contrast_factor + mean * (1 - contrast_factor)
    return out.clip(0, 255).astype(np.uint8) if arr.dtype == np.uint8 else out


def adjust_saturation(img, saturation_factor):
    arr = _as_np(img)
    f = arr.astype(np.float32)
    hwc, was_chw = _to_hwc(f if f.ndim == 3 else f[..., None])
    gray = (hwc[..., :1] * 0.299 + hwc[..., 1:2] * 0.587
            + hwc[..., 2:3] * 0.114) if hwc.shape[-1] == 3 else hwc
    out = hwc * saturation_factor + gray * (1 - saturation_factor)
    out = _from_hwc(out, was_chw)
    return out.clip(0, 255).astype(np.uint8) if arr.dtype == np.uint8 else out


def adjust_hue(img, hue_factor):
    """Hue rotation in HSV space (reference semantics, hue_factor in
    [-0.5, 0.5])."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr = _as_np(img)
    f = arr.astype(np.float32)
    hwc, was_chw = _to_hwc(f if f.ndim == 3 else f[..., None])
    if hwc.shape[-1] != 3:
        return arr
    scale = 255.0 if arr.dtype == np.uint8 else 1.0
    rgb = hwc / scale
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    h = np.where(mx == r, ((g - b) / diff) % 6,
                 np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4)) / 6
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    v = mx
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6).astype(int)
    fpart = h * 6 - i
    p = v * (1 - s)
    q = v * (1 - fpart * s)
    t = v * (1 - (1 - fpart) * s)
    i = i % 6
    out = np.choose(i[..., None] * 0 + np.arange(3)[None, None, :] * 0
                    + i[..., None],
                    [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
                     np.stack([p, v, t], -1), np.stack([p, q, v], -1),
                     np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    out = (out * scale)
    out = _from_hwc(out, was_chw)
    return out.clip(0, 255).astype(np.uint8) if arr.dtype == np.uint8 else out


def to_grayscale(img, num_output_channels=1):
    arr = _as_np(img)
    f = arr.astype(np.float32)
    hwc, was_chw = _to_hwc(f if f.ndim == 3 else f[..., None])
    if hwc.shape[-1] == 3:
        gray = (hwc[..., :1] * 0.299 + hwc[..., 1:2] * 0.587
                + hwc[..., 2:3] * 0.114)
    else:
        gray = hwc[..., :1]
    out = np.repeat(gray, num_output_channels, axis=-1)
    out = _from_hwc(out, was_chw)
    return out.astype(np.uint8) if arr.dtype == np.uint8 else out


def erase(img, i, j, h, w, v, inplace=False):
    arr = _as_np(img)
    out = arr if inplace else arr.copy()
    if _is_chw(out):
        out[:, i:i + h, j:j + w] = v
    else:
        out[i:i + h, j:j + w] = v
    if isinstance(img, torch.Tensor):
        return torch.from_numpy(out)
    return out


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        f = pyrandom.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        f = pyrandom.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = min(value, 0.5)

    def _apply_image(self, img):
        return adjust_hue(img, pyrandom.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.transforms = []
        if brightness:
            self.transforms.append(BrightnessTransform(brightness))
        if contrast:
            self.transforms.append(ContrastTransform(contrast))
        if saturation:
            self.transforms.append(SaturationTransform(saturation))
        if hue:
            self.transforms.append(HueTransform(hue))

    def _apply_image(self, img):
        order = list(self.transforms)
        pyrandom.shuffle(order)
        for t in order:
            img = t(img)
        return img


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.kw = dict(interpolation=interpolation, expand=expand,
                       center=center, fill=fill)

    def _apply_image(self, img):
        angle = pyrandom.uniform(*self.degrees)
        return rotate(img, angle, **self.kw)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.args = (padding, fill, padding_mode)

    def _apply_image(self, img):
        return pad(img, *self.args)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.n = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.n)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def _apply_image(self, img):
        arr = _as_np(img)
        if pyrandom.random() > self.prob:
            return img
        if _is_chw(arr):
            h, w = arr.shape[1], arr.shape[2]
        else:
            h, w = arr.shape[0], arr.shape[1]
        area = h * w
        for _ in range(10):
            target = pyrandom.uniform(*self.scale) * area
            aspect = pyrandom.uniform(*self.ratio)
            eh = int(round(np.sqrt(target * aspect)))
            ew = int(round(np.sqrt(target / aspect)))
            if eh < h and ew < w:
                i = pyrandom.randint(0, h - eh)
                j = pyrandom.randint(0, w - ew)
                return erase(img, i, j, eh, ew, self.value,
                             inplace=self.inplace)
        return img
