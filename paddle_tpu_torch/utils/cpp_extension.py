"""Custom host ops from C++, the counterpart of
``paddle_tpu/utils/cpp_extension.py``.

:func:`load` compiles C++ sources with the system ``g++`` (no CUDA, no
pybind11) into ``lib<name>_<hash>.so`` and returns its ``ctypes``
handle; :func:`host_op` wraps a C symbol ``void fn(const float* in,
float* out, long n)`` as an op on tensors: the input is copied to the
host, the function runs there, and the result comes back on the input's
device.  The op has no gradient, as JAX's ``pure_callback`` has none:
its backward raises.  The port's own CUDA kernels are built by
``paddle_tpu_torch._build``; ``CUDAExtension`` and ``setup`` raise, as
JAX's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig

import numpy as np
import torch

DEFAULT_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-march=native"]


def load(name, sources, extra_cxx_flags=None, extra_include_paths=None,
         build_directory=None, verbose=False, **kwargs):
    """Compile ``sources`` into ``lib<name>_<hash>.so`` (the hash of the
    sources' bytes: an edited source is rebuilt) under
    ``build_directory`` (default ``$PADDLE_TPU_EXT_DIR`` or
    ``~/.cache/paddle_tpu_ext``) and return a ``ctypes.CDLL``."""
    build_dir = build_directory or os.environ.get(
        "PADDLE_TPU_EXT_DIR", os.path.expanduser("~/.cache/paddle_tpu_ext"))
    os.makedirs(build_dir, exist_ok=True)
    src_key = hashlib.sha1()
    for s in sources:
        with open(s, "rb") as f:
            src_key.update(f.read())
    out = os.path.join(build_dir, f"lib{name}_{src_key.hexdigest()[:12]}.so")
    if not os.path.exists(out):
        cmd = ["g++", *DEFAULT_FLAGS]
        for inc in (extra_include_paths or []):
            cmd += ["-I", inc]
        cmd += ["-I", sysconfig.get_paths()["include"]]
        cmd += list(sources) + (extra_cxx_flags or []) + ["-o", out]
        if verbose:
            print(" ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=not verbose)
    return ctypes.CDLL(out)


class _HostOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, host_call):
        out = host_call(np.ascontiguousarray(x.detach().cpu().numpy()))
        return torch.from_numpy(out).to(x.device)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("a host_op has no gradient (JAX's pure_callback "
                           "has none either)")


def host_op(lib, fn_name, out_shape_fn, arg_dtypes=None):
    """The C function ``fn_name`` of ``lib`` as an op ``op(x)``: the
    output has shape ``out_shape_fn(x.shape)`` and x's dtype, and lies on
    x's device."""
    cfn = getattr(lib, fn_name)
    cfn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    cfn.restype = None

    def host_call(a):
        out = np.empty(out_shape_fn(a.shape), a.dtype)
        cfn(a.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(a.size))
        return out

    def op(x):
        return _HostOp.apply(x, host_call)

    return op


class CppExtension:
    def __init__(self, sources, *args, **kwargs):
        self.sources = sources


class CUDAExtension(CppExtension):
    def __init__(self, *a, **k):
        raise NotImplementedError(
            "CUDAExtension: the port builds its CUDA kernels with "
            "paddle_tpu_torch._build (nvcc, one library per csrc/*.cu)")


def setup(**kwargs):
    raise NotImplementedError(
        "setup: use paddle_tpu_torch.utils.cpp_extension.load for host "
        "ops, paddle_tpu_torch._build for CUDA kernels")
