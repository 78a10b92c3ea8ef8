"""The port's ``vision.datasets`` and ``vision.transforms`` against the
JAX package's on numpy-seeded images (no 224 px image on the CPU).

Exact: ``FakeData``'s images and labels, the local-file datasets, and
every NumPy transform on uint8 and float32 images, the random ones under
one ``random.seed``.  ``Resize`` (JAX's ``jax.image.resize`` against the
port's NumPy scale-and-translate, up and down, in its three modes) is
held to 1e-5 of the image's largest value in float32 (the same weights
summed in another order), and a uint8 result to 1 (the truncating cast
of a float32 value a few ulps either side of an integer)."""

import gzip
import pickle
import random
import struct

import numpy as np
import pytest
import torch

import paddle_tpu.vision.datasets as jds
import paddle_tpu.vision.transforms as jt
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as tt

from _torch_port_util import one_thread  # noqa: F401


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _images(kind):
    r = np.random.RandomState(7)
    hwc = r.rand(21, 30, 3) * 255
    return {"uint8_hwc": hwc.astype(np.uint8),
            "float32_hwc": (hwc / 255).astype(np.float32),
            "uint8_chw": hwc.astype(np.uint8).transpose(2, 0, 1).copy(),
            "float32_gray": (hwc[..., 0] / 255).astype(np.float32)}[kind]


def test_fake_data_matches_jax():
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    outs = []
    for t, d in ((jt, jds), (tt, tds)):
        random.seed(3)
        ds = d.FakeData(size=70, image_shape=(3, 16, 20), num_classes=10,
                        seed=5, transform=t.Compose([
                            t.RandomHorizontalFlip(),
                            t.Normalize(mean, std, data_format="CHW")]))
        outs.append([(ds[i][0], int(ds[i][1])) for i in (0, 1, 63, 64, 69)]
                    + [len(ds)])
    assert outs[0][-1] == outs[1][-1] == 70
    for (ji, jl), (ti, tl) in zip(outs[0][:-1], outs[1][:-1]):
        assert ti.dtype == ji.dtype == np.float32 and tl == jl
        np.testing.assert_array_equal(ti, ji)


TRANSFORMS = {
    "to_tensor": lambda t: t.ToTensor(),
    "to_tensor_hwc": lambda t: t.ToTensor(data_format="HWC"),
    "normalize_hwc": lambda t: t.Normalize([120.0, 1, 3], [50.0, 2, 4],
                                           data_format="HWC"),
    "center_crop": lambda t: t.CenterCrop((9, 14)),
    "random_crop_pad": lambda t: t.RandomCrop(12, padding=3),
    "hflip": lambda t: t.RandomHorizontalFlip(prob=1.0),
    "vflip": lambda t: t.RandomVerticalFlip(prob=1.0),
    "transpose": lambda t: t.Transpose(),
    "brightness": lambda t: t.BrightnessTransform(0.4),
    "contrast": lambda t: t.ContrastTransform(0.4),
    "saturation": lambda t: t.SaturationTransform(0.4),
    "hue": lambda t: t.HueTransform(0.3),
    "color_jitter": lambda t: t.ColorJitter(0.3, 0.3, 0.3, 0.1),
    "rotation_nearest": lambda t: t.RandomRotation(30),
    "rotation_bilinear_expand": lambda t: t.RandomRotation(
        40, interpolation="bilinear", expand=True, fill=7),
    "pad_reflect": lambda t: t.Pad((1, 2, 3, 4), padding_mode="reflect"),
    "pad_constant": lambda t: t.Pad(2, fill=9),
    "grayscale3": lambda t: t.Grayscale(3),
    "random_erasing": lambda t: t.RandomErasing(prob=1.0, value=5),
    "compose": lambda t: t.Compose([t.CenterCrop(16), t.RandomVerticalFlip(),
                                    t.Grayscale(1)]),
}


@pytest.mark.parametrize("image", ["uint8_hwc", "float32_hwc", "uint8_chw"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name, image):
    """Equal outputs, or the same error (an HWC Normalize of a CHW
    image)."""
    img = _images(image)
    outs = []
    for t in (jt, tt):
        random.seed(17)
        try:
            outs.append(_np(TRANSFORMS[name](t)(img.copy())))
        except ValueError as e:
            outs.append(type(e))
    if outs[0] is ValueError:
        assert outs[1] is ValueError
        return
    assert outs[1].dtype == outs[0].dtype
    np.testing.assert_array_equal(outs[1], outs[0])


FUNCTIONAL = {
    "hflip": lambda t, x: t.hflip(x),
    "vflip": lambda t, x: t.vflip(x),
    "crop": lambda t, x: t.crop(x, 2, 3, 7, 9),
    "center_crop": lambda t, x: t.center_crop(x, 8),
    "pad_edge": lambda t, x: t.pad(x, [1, 2], padding_mode="edge"),
    "rotate": lambda t, x: t.rotate(x, 33, interpolation="bilinear",
                                    center=(4, 6)),
    "adjust_brightness": lambda t, x: t.adjust_brightness(x, 1.3),
    "adjust_contrast": lambda t, x: t.adjust_contrast(x, 0.6),
    "adjust_saturation": lambda t, x: t.adjust_saturation(x, 1.7),
    "adjust_hue": lambda t, x: t.adjust_hue(x, -0.2),
    "to_grayscale": lambda t, x: t.to_grayscale(x, 3),
    "erase": lambda t, x: t.erase(x, 1, 2, 5, 6, 0),
    "normalize": lambda t, x: t.normalize(x, 0.5, 0.25, data_format="HWC"),
    "to_tensor": lambda t, x: t.to_tensor(x),
}


@pytest.mark.parametrize("image", ["uint8_hwc", "float32_gray"])
@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_functional_transforms_match_jax(name, image):
    img = _images(image)
    want = _np(FUNCTIONAL[name](jt, img.copy()))
    got = _np(FUNCTIONAL[name](tt, img.copy()))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_tensor_images_stay_tensors():
    img = torch.from_numpy(_images("float32_hwc").transpose(2, 0, 1).copy())
    out = tt.Normalize([0.5, 0.4, 0.3], [0.2, 0.2, 0.2])(img)
    assert isinstance(out, torch.Tensor)
    assert isinstance(tt.erase(img, 0, 0, 2, 2, 1.0), torch.Tensor)


@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bicubic"])
@pytest.mark.parametrize("size", [(40, 57), (9, 13), (30, 11)],
                         ids=["up", "down", "mixed"])
@pytest.mark.parametrize("image", ["uint8_hwc", "float32_hwc", "uint8_chw",
                                   "float32_gray"])
def test_resize_matches_jax(mode, size, image):
    img = _images(image)
    want = _np(jt.Resize(size, mode)(img))
    got = _np(tt.Resize(size, mode)(img))
    assert got.shape == want.shape and got.dtype == want.dtype
    if img.dtype == np.uint8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert (got != want).mean() < 0.01
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_random_resized_crop_matches_jax():
    img = _images("float32_hwc")
    outs = []
    for t in (jt, tt):
        random.seed(2)
        outs.append([_np(t.RandomResizedCrop(12)(img)) for _ in range(4)])
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_local_file_datasets_match_jax(tmp_path):
    r = np.random.RandomState(0)
    imgs = r.randint(0, 256, (5, 4, 6), dtype=np.uint8)
    lbls = r.randint(0, 10, 5).astype(np.uint8)
    ip, lp = tmp_path / "img.gz", tmp_path / "lbl"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 4, 6) + imgs.tobytes())
    lp.write_bytes(struct.pack(">II", 2049, 5) + lbls.tobytes())
    cp = tmp_path / "cifar"
    with open(cp, "wb") as f:
        pickle.dump({b"data": r.randint(0, 256, (3, 3072), dtype=np.uint8),
                     b"labels": [4, 1, 7]}, f)
    for c in ("a", "b"):
        (tmp_path / "folder" / c).mkdir(parents=True)
        for i in range(2):
            np.save(tmp_path / "folder" / c / f"{i}.npy", r.rand(2, 3))
    pairs = [(jds.MNIST(str(ip), str(lp)), tds.MNIST(str(ip), str(lp))),
             (jds.Cifar10(str(cp)), tds.Cifar10(str(cp))),
             (jds.Cifar100(str(cp)), tds.Cifar100(str(cp))),
             (jds.DatasetFolder(str(tmp_path / "folder")),
              tds.DatasetFolder(str(tmp_path / "folder")))]
    for j, t in pairs:
        assert len(j) == len(t)
        for i in range(len(t)):
            np.testing.assert_array_equal(t[i][0], j[i][0])
            assert t[i][1] == j[i][1]
    with pytest.raises(FileNotFoundError):
        tds.MNIST(str(tmp_path / "missing"))
