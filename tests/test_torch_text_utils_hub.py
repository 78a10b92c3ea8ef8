"""The port's ``text``, ``utils``, ``hub``, ``version`` and ``sysconfig``
against the JAX package's on the CPU.

* ``text.viterbi_decode``/``ViterbiDecoder``: scores and paths equal
  JAX's exactly (the same f32 adds and maxima), with and without the
  BOS/EOS tags, on ragged lengths and on integer-valued potentials that
  plant ties (the lowest tag index wins on both sides); and against
  brute-force enumeration (``tests/test_text_viterbi.py`` is the
  oracle), within 1e-4 (the enumeration adds in another order).
* ``utils``: ``unique_name`` sequences, ``dlpack`` (zero-copy, both
  ways with JAX), ``require_version``, ``try_import``, ``deprecated``,
  ``download`` from the local cache only, ``run_check`` on the CPU, and
  ``cpp_extension`` (``g++``): a host op's result, its missing gradient,
  ``CUDAExtension``/``setup`` refusing.
* ``hub`` from a ``hubconf.py`` under ``tmp_path``; other sources
  refused.  ``version``'s names and ``sysconfig``'s directories.
"""

import itertools
import shutil
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.hub as jhub
import paddle_tpu.utils as jutils
import paddle_tpu.version as jversion
from paddle_tpu.text import viterbi_decode as jax_viterbi

import paddle_tpu_torch as pt
import paddle_tpu_torch.hub as thub
import paddle_tpu_torch.utils as tutils
import paddle_tpu_torch.version as tversion
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.text import ViterbiDecoder, viterbi_decode
from paddle_tpu_torch.utils import cpp_extension, dlpack, unique_name

from _torch_port_util import one_thread  # noqa: F401

B, T, N = 6, 7, 5
LENGTHS = np.array([7, 5, 1, 3, 7, 2], np.int64)


def _inputs(ties):
    r = np.random.RandomState(3 if ties else 4)
    if ties:      # small integers: equal sums everywhere
        pot = r.randint(0, 3, (B, T, N)).astype(np.float32)
        trans = r.randint(0, 2, (N, N)).astype(np.float32)
    else:
        pot = r.randn(B, T, N).astype(np.float32)
        trans = r.randn(N, N).astype(np.float32)
    return pot, trans


def _brute(pot, trans, length, bos_eos):
    n = pot.shape[1]
    best, best_path = -np.inf, None
    for path in itertools.product(range(n), repeat=length):
        s = pot[0, path[0]] + (trans[n - 1, path[0]] if bos_eos else 0.0)
        for i in range(1, length):
            s += trans[path[i - 1], path[i]] + pot[i, path[i]]
        if bos_eos:
            s += trans[path[-1], n - 2]
        if s > best:
            best, best_path = s, path
    return best, list(best_path)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("bos_eos", [False, True], ids=["plain", "bos_eos"])
def test_viterbi_matches_jax_exactly(ties, bos_eos):
    pot, trans = _inputs(ties)
    js, jp = jax_viterbi(paddle.to_tensor(pot), paddle.to_tensor(trans),
                         paddle.to_tensor(LENGTHS), include_bos_eos_tag=bos_eos)
    ts, tp = viterbi_decode(torch.from_numpy(pot), torch.from_numpy(trans),
                            torch.from_numpy(LENGTHS),
                            include_bos_eos_tag=bos_eos)
    assert ts.dtype == torch.float32 and tp.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.numpy()))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp.numpy()))
    p = tp.numpy()
    for b, n in enumerate(LENGTHS):
        assert (p[b, n:] == p[b, n - 1]).all()
        if not ties:
            ref_s, ref_p = _brute(pot[b], trans, int(n), bos_eos)
            assert abs(float(ts[b]) - ref_s) < 1e-4
            assert p[b, :n].tolist() == ref_p


def test_viterbi_decoder_layer_and_lowest_index_on_ties():
    pot, trans = _inputs(True)
    dec = ViterbiDecoder(torch.from_numpy(trans), include_bos_eos_tag=False)
    s, p = dec(torch.from_numpy(pot), torch.from_numpy(LENGTHS))
    assert tuple(s.shape) == (B,) and tuple(p.shape) == (B, T)
    # every tag equal everywhere: the all-zero path, tag 0 wins each tie
    s, p = viterbi_decode(torch.zeros(2, 4, 3), torch.zeros(3, 3),
                          torch.tensor([4, 2]), include_bos_eos_tag=False)
    assert p.tolist() == [[0, 0, 0, 0], [0, 0, 0, 0]] and s.tolist() == \
        [0.0, 0.0]


def test_unique_name_matches_jax():
    seqs = []
    for mod in (jutils.unique_name, unique_name):
        with mod.guard():
            a = [mod.generate("fc"), mod.generate("fc"), mod.generate("w")]
            with mod.guard():
                b = [mod.generate("fc")]
            a.append(mod.generate("fc"))
            mod.switch()
            a.append(mod.generate("fc"))
        seqs.append((a, b))
    assert seqs[0] == seqs[1] == (["fc_0", "fc_1", "w_0", "fc_2", "fc_0"],
                                  ["fc_0"])


def test_dlpack_is_zero_copy_both_ways():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    back = dlpack.from_dlpack(dlpack.to_dlpack(t))
    assert back.data_ptr() == t.data_ptr() and torch.equal(back, t)
    capsule = torch.utils.dlpack.to_dlpack(t)          # a bare capsule
    assert dlpack.from_dlpack(capsule).data_ptr() == t.data_ptr()
    a = np.arange(4, dtype=np.float32)
    assert dlpack.from_dlpack(a).data_ptr() == a.ctypes.data
    j = jnp.from_dlpack(dlpack.to_dlpack(t))
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    x = jutils.dlpack.to_dlpack(paddle.to_tensor(np.arange(3.0, dtype=
                                                           np.float32)))
    np.testing.assert_array_equal(dlpack.from_dlpack(x).numpy(), [0, 1, 2])
    with pytest.raises(TypeError):
        dlpack.to_dlpack(np.zeros(2))


@pytest.mark.parametrize("lo,hi", [("0.0.1", None), ("0.1.0", "0.1.0"),
                                   ("0.2", None), ("0.0.1", "0.0.9")])
def test_require_version_and_version_match_jax(lo, hi):
    outcomes = []
    for mod in (jutils, tutils):
        try:
            outcomes.append(mod.require_version(lo, hi))
        except RuntimeError as e:
            outcomes.append(str(e).split()[3])
    assert outcomes[0] == outcomes[1]
    assert pt.__version__ == tversion.full_version == jversion.full_version
    public = lambda m: {n for n in vars(m) if not n.startswith("_")}  # noqa
    assert public(jversion) - {"jax"} <= public(tversion)
    assert tversion.tpu() == "none"


def test_try_import_deprecated_download_and_run_check(tmp_path, monkeypatch,
                                                      capsys):
    assert tutils.try_import("json").dumps([1]) == "[1]"
    with pytest.raises(ImportError, match="need it"):
        tutils.try_import("no_such_module_here", "need it")
    f = lambda: 3                                           # noqa: E731
    assert tutils.deprecated(since="2.0")(f) is f
    monkeypatch.setenv("PPTPU_DATA_HOME", str(tmp_path))
    (tmp_path / "data.bin").write_bytes(b"x")
    for mod in (jutils, tutils):
        assert mod.download("cache://data.bin") == \
            str(tmp_path / "data.bin")
        with pytest.raises(RuntimeError, match="missing.bin"):
            mod.download("cache://missing.bin")
    monkeypatch.setattr(tdevice, "_CURRENT", [None])
    pt.set_device("cpu")
    tutils.run_check()
    assert "works on cpu (CPU) (128.0)" in capsys.readouterr().out


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_cpp_extension_host_op(tmp_path):
    src = tmp_path / "myop.cc"
    src.write_text(textwrap.dedent("""
        extern "C" void double_plus_one(const float* in, float* out,
                                        long n) {
            for (long i = 0; i < n; ++i) out[i] = 2.0f * in[i] + 1.0f;
        }
    """))
    lib = cpp_extension.load("myop", [str(src)],
                             build_directory=str(tmp_path))
    op = cpp_extension.host_op(lib, "double_plus_one", lambda s: s)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    np.testing.assert_array_equal(op(x).numpy(), 2 * x.numpy() + 1)
    y = op(x.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="no gradient"):
        y.sum().backward()
    with pytest.raises(NotImplementedError, match="_build"):
        cpp_extension.CUDAExtension(["a.cu"])
    with pytest.raises(NotImplementedError):
        cpp_extension.setup(name="x")
    assert cpp_extension.CppExtension(["a.cc"]).sources == ["a.cc"]


def test_hub_from_a_local_hubconf_as_jax(tmp_path):
    (tmp_path / "hubconf.py").write_text(
        "def make(n=2):\n    'builds a list'\n    return list(range(n))\n"
        "def _hidden():\n    return 0\n")
    for hub in (jhub, thub):
        assert hub.list(str(tmp_path)) == ["make"]
        assert hub.help(str(tmp_path), "make") == "builds a list"
        assert hub.load(str(tmp_path), "make", n=3) == [0, 1, 2]
        with pytest.raises(RuntimeError):
            hub.load("user/repo", "make", source="github")
        with pytest.raises(ValueError, match="nope"):
            hub.load(str(tmp_path), "nope")
        with pytest.raises(FileNotFoundError):
            hub.list(str(tmp_path / "missing"))


def test_sysconfig_points_at_the_port():
    import os

    assert os.path.isfile(os.path.join(pt.sysconfig.get_include(),
                                       "kernels.h"))
    assert pt.sysconfig.get_lib().endswith(os.path.join("paddle_tpu_torch",
                                                        "build"))
