"""The port's CUDA build (``paddle_tpu_torch/_build.py``) and the CUDA
sources' dispatch, read on the CPU (no nvcc, no card): the library cache
key follows every header, and the head dims that the Python wrappers send
to the kernels are the ones the sources instantiate."""

import importlib
import math
import re

import pytest
import torch

from paddle_tpu_torch import _build

from _torch_port_util import one_thread  # noqa: F401

fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
pa = importlib.import_module("paddle_tpu_torch.serving.paged_attention")


def _source(name):
    return (_build.CSRC / name).read_text()


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc/ of one source and one header of each suffix."""
    (tmp_path / "k.cu").write_text('#include "kernels.h"\n')
    (tmp_path / "kernels.h").write_text("// C interface\n")
    (tmp_path / "mainloop.cuh").write_text("// device code\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edited", ["k.cu", "kernels.h", "mainloop.cuh"])
def test_library_path_changes_with_the_source_and_every_header(csrc, edited):
    src = csrc / "k.cu"
    before = _build._library_path(src)
    assert _build._library_path(src) == before          # stable
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    after = _build._library_path(src)
    assert after != before
    assert after.parent == _build.BUILD_DIR
    assert after.name.startswith("libk.") and after.suffix == ".so"


def test_library_path_changes_when_a_header_is_added(csrc):
    src = csrc / "k.cu"
    before = _build._library_path(src)
    (csrc / "extra.cuh").write_text("// new\n")
    assert _build._library_path(src) != before


def _flash_dispatch():
    """{dtype code: head dims} of FA_DISPATCH in flash_attention.cu."""
    text = _source("flash_attention.cu")
    block = text[text.index("#define FA_DISPATCH"):]
    block = block[:block.index("return cudaErrorInvalidValue")]
    out = {}
    for code, d, inst in re.findall(
            r"dtype == (\d) && head_dim == (\d+)\) return CALL(?:_SM90)?\((\d+)\)",
            block):
        assert d == inst, f"head_dim {d} dispatched to instantiation {inst}"
        out.setdefault(int(code), set()).add(int(d))
    return out


def _bf16_dispatch(macro):
    """The head dims FA_DISPATCH sends to CALL_SM90 for bf16 (dtype 1) and
    the function the entry point named ``macro`` maps CALL_SM90 to."""
    text = _source("flash_attention.cu")
    block = text[text.index("#define FA_DISPATCH"):]
    block = block[:block.index("return cudaErrorInvalidValue")]
    dims = {int(d) for d in re.findall(
        r"dtype == 1 && head_dim == (\d+)\) return CALL_SM90\(", block)}
    body = text[text.index(f"#define {macro}_SM90(D)"):]
    fn = re.search(r"(\w+)<D>\(", body).group(1)
    return dims, fn


def test_flash_head_dims_match_the_dispatch():
    want = {fa._DTYPE_CODES[dt]: set(dims)
            for dt, dims in fa._KERNEL_HEAD_DIMS.items()}
    assert _flash_dispatch() == want


def test_bf16_forward_widths_have_a_wgmma_instantiation():
    """The Hopper mainloop pads a head to whole 64-column swizzle atoms
    and runs P V at that width: every bf16 head dim needs its wgmma_rs
    shape in attention_sm90.cuh."""
    text = _source("attention_sm90.cuh")
    shapes = {int(n) for n in re.findall(r"void wgmma_rs_n(\d+)\(", text)}
    dispatched = {int(n) for n in re.findall(
        r"if constexpr \(N == (\d+)\) wgmma_rs_n\1\(", text)}
    for d in fa._KERNEL_HEAD_DIMS[torch.bfloat16] + pa._KERNEL_HEAD_DIMS:
        width = 64 * math.ceil(d / 64)
        assert width in shapes and width in dispatched, (d, width)


def test_paged_head_dims_and_block_size_match_the_dispatch():
    text = _source("paged_attention.cu")
    entry = text[text.index('extern "C" int paged_attention_fwd'):]
    pairs = re.findall(r"head_dim == (\d+)\)\s*return dispatch<(\d+)>", entry)
    assert all(a == b for a, b in pairs)
    assert {int(a) for a, _ in pairs} == set(pa._KERNEL_HEAD_DIMS)
    bs = re.search(r"constexpr int BS = (\d+);", text)
    assert int(bs.group(1)) == pa._KERNEL_BLOCK_SIZE


def test_paged_group_limit_matches_the_tile():
    """A 64-vector tile holds TR = 64 / G rows of G heads: the wrapper's
    group limit is the mainloop's tile height."""
    text = _source("attention_sm90.cuh")
    bm = re.search(r"constexpr int BM = (\d+);", text)
    assert int(bm.group(1)) == pa._KERNEL_MAX_GROUP


@pytest.mark.parametrize("macro,fn", [("FA_DQ", "bwd_dq_sm90"),
                                      ("FA_DKV", "bwd_dkv_sm90")])
def test_bf16_backward_dispatches_to_the_wgmma_kernels(macro, fn):
    """Every bf16 head dim of the wrappers reaches the TMA + wgmma
    backward of flash_bwd_sm90.cuh, whose launchers those functions
    call."""
    dims, got = _bf16_dispatch(macro)
    assert dims == set(fa._KERNEL_HEAD_DIMS[torch.bfloat16])
    assert got == fn
    text = _source("flash_attention.cu")
    body = text[text.index(f"cudaError_t {fn}("):]
    body = body[:body.index("\n}\n")]
    kernel = "launch_bwd_dq" if macro == "FA_DQ" else "launch_bwd_dkv"
    assert f"sm90::{kernel}<D>" in body
    assert '#include "flash_bwd_sm90.cuh"' in text


def test_bf16_backward_widths_have_a_wgmma_rs_shape():
    """dQ += dS K, dV += P^T dO and dK += dS^T Q run at the padded head
    width: each bf16 head dim needs its wgmma_rs shape."""
    text = _source("attention_sm90.cuh")
    shapes = {int(n) for n in re.findall(
        r"if constexpr \(N == (\d+)\) wgmma_rs_n\1\(", text)}
    for d in fa._KERNEL_HEAD_DIMS[torch.bfloat16]:
        assert 64 * math.ceil(d / 64) in shapes, d
    bwd = _source("flash_bwd_sm90.cuh")
    assert "issue_pv<T::DP>" in bwd and "wgmma" in bwd


@pytest.mark.parametrize("name", ["flash_attention.cu", "flash_bwd_sm90.cuh",
                                  "attention_sm90.cuh"])
def test_no_mma_sync_remains_in_the_bf16_attention(name):
    text = _source(name)
    assert "mma.sync" not in text
    for helper in ("mma16816", "load_b_trans", "c_to_a", "BQ2",
                   "flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel"):
        assert helper not in text, helper
