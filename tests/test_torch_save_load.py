"""The port's ``save``/``load`` against the JAX package's
``paddle.save``/``paddle.load`` on the CPU.

Exact throughout: the port reads files that JAX wrote, in both formats
(the small-object pickle and the ``PTCKPT01`` container at or above 1
MiB), bfloat16 leaves included, without importing the JAX package's
classes; its container has JAX's layout and payload bytes for the same
arrays; its own files round-trip, with ``return_numpy`` too."""

import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.hapi import Model as JModel
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.framework import load, save

from _torch_port_util import one_thread  # noqa: F401


def _jax_tree(big):
    r = np.random.RandomState(1 if big else 0)
    n = 600 if big else 6
    return {
        "w": paddle.to_tensor(r.randn(n, n).astype(np.float32)),
        "h": paddle.to_tensor(r.randn(n, 5).astype(np.float32)).astype(
            "bfloat16"),
        "i": paddle.to_tensor(np.arange(7, dtype=np.int32)),
        "nested": [paddle.to_tensor(r.randn(3).astype(np.float32)),
                   (paddle.to_tensor(np.ones(2, np.float16)), "tag")],
        "raw": np.arange(4.0), "step": 12, "lr": {"last_epoch": 3},
    }


def _f32(x):
    """A leaf of either package as float32 NumPy (exact for bfloat16)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    if hasattr(x, "astype") and hasattr(x, "_data"):
        return np.asarray(x.astype("float32").numpy()) \
            if str(x.dtype).endswith("bfloat16") else np.asarray(x.numpy())
    return np.asarray(x)


@pytest.mark.parametrize("big", [False, True], ids=["pickle", "container"])
@pytest.mark.parametrize("return_numpy", [False, True])
def test_port_reads_jax_files(tmp_path, big, return_numpy):
    tree = _jax_tree(big)
    path = str(tmp_path / "ckpt.pd")
    paddle.save(tree, path)
    with open(path, "rb") as f:
        assert (f.read(8) == b"PTCKPT01") == big
    got = load(path, return_numpy=return_numpy, device="cpu")
    assert got["step"] == 12 and got["lr"] == {"last_epoch": 3}
    assert got["nested"][1][1] == "tag"
    assert isinstance(got["h"], torch.Tensor)
    assert got["h"].dtype == torch.bfloat16     # NumPy has no bfloat16
    leaves = [("w", got["w"]), ("h", got["h"]), ("i", got["i"]),
              ("n0", got["nested"][0]), ("n1", got["nested"][1][0])]
    want = {"w": tree["w"], "h": tree["h"], "i": tree["i"],
            "n0": tree["nested"][0], "n1": tree["nested"][1][0]}
    for k, v in leaves:
        if k != "h":
            assert isinstance(v, np.ndarray if return_numpy
                              else torch.Tensor), k
        np.testing.assert_array_equal(_f32(v), _f32(want[k]))
    np.testing.assert_array_equal(got["raw"], tree["raw"])


def test_port_container_has_jax_layout_and_bytes(tmp_path):
    r = np.random.RandomState(2)
    a = r.randn(400, 700).astype(np.float32)
    b = (r.randn(33, 17) * 4).astype(np.float32)
    jp, tp = str(tmp_path / "j.pd"), str(tmp_path / "t.pd")
    paddle.save({"a": paddle.to_tensor(a), "l": [paddle.to_tensor(b).astype(
        "bfloat16"), paddle.to_tensor(np.arange(5, dtype=np.int32))]}, jp)
    save({"a": torch.from_numpy(a), "l": [torch.from_numpy(b).bfloat16(),
                                           torch.arange(5, dtype=torch.int32)]
          }, tp)
    regions = []
    for p in (jp, tp):
        with open(p, "rb") as f:
            structure, arrays = tio._load_container(f)
            f.seek(8)
            n = int.from_bytes(f.read(8), "little")
            f.seek((16 + n + 63) // 64 * 64)
            regions.append(([(dt, a.shape) for a, dt in arrays], f.read()))
    assert regions[0] == regions[1]
    assert regions[0][0] == [("float32", (400, 700)), ("bfloat16", (33, 17)),
                             ("int32", (5,))]
    assert not (tmp_path / "t.pd.tmp").exists()


@pytest.mark.parametrize("big", [False, True], ids=["pickle", "container"])
def test_port_round_trip(tmp_path, big):
    g = torch.Generator().manual_seed(0)
    n = 700 if big else 5
    tree = {"w": torch.randn(n, n, generator=g),
            "bf": torch.randn(n, 3, generator=g).bfloat16(),
            "ints": torch.arange(6), "half": torch.ones(3, dtype=torch.half),
            "list": [torch.zeros(2), ("x", 3.5)], "none": None}
    path = str(tmp_path / "p.pd")
    save(tree, path)
    got = load(path, device="cpu")
    for k in ("w", "bf", "ints", "half"):
        assert got[k].dtype == tree[k].dtype
        assert torch.equal(got[k], tree[k])
    assert torch.equal(got["list"][0], tree["list"][0])
    assert got["list"][1] == ("x", 3.5) and got["none"] is None
    npy = load(path, return_numpy=True)
    assert isinstance(npy["w"], np.ndarray)
    np.testing.assert_array_equal(npy["w"], tree["w"].numpy())
    assert torch.equal(npy["bf"], tree["bf"])


def test_port_reads_a_jax_model_checkpoint(tmp_path):
    paddle.seed(4)
    net = jnn.Sequential(jnn.Linear(4, 3), jnn.ReLU(), jnn.Linear(3, 2))
    opt = paddle.optimizer.Adam(learning_rate=0.1,
                                parameters=net.parameters())
    JModel(net).prepare(opt, jnn.MSELoss()).save(str(tmp_path / "m"))
    params = load(str(tmp_path / "m.pdparams"), device="cpu")
    want = net.state_dict()
    assert sorted(params) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(v.numpy()))
    load(str(tmp_path / "m.pdopt"), device="cpu")


def test_unknown_jax_class_is_refused(tmp_path):
    path = tmp_path / "bad.pd"
    path.write_bytes(b"cpaddle_tpu.core.tensor\nTensor\n.")
    with pytest.raises(pickle.UnpicklingError, match="no counterpart"):
        load(str(path), device="cpu")


def test_load_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    save({"x": torch.ones(2)}, str(tmp_path / "x.pd"))
    with pytest.raises(RuntimeError, match="CUDA"):
        load(str(tmp_path / "x.pd"))
