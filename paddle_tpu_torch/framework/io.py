"""``save`` and ``load``, the counterparts of ``paddle_tpu/framework/io.py``.

Two formats, one API, the same bytes as JAX's:

* below 1 MiB of tensor payload, one pickle whose tensor leaves are
  ``_TensorPayload`` objects around NumPy arrays;
* at or above it, the ``PTCKPT01`` container: the magic, the header's
  length (8 bytes, little-endian), a pickled header ``{"structure",
  "metas"}`` whose tensor leaves are ``_PayloadRef(index)``, then each
  payload's raw bytes at a 64-byte-aligned offset (``metas`` holds
  ``(dtype name, shape, offset, nbytes)``).  It is written to
  ``path + ".tmp"`` and moved into place by ``os.replace``, so an
  interrupted save never leaves a well-formed file of zeros.  JAX writes
  the payloads through its native positional IO; plain file IO here
  writes the same bytes.

``load`` reads files written by either package without importing the
JAX package: its unpickler maps the class paths
``paddle_tpu.framework.io._TensorPayload`` and ``_PayloadRef`` to this
module's and refuses any other ``paddle_tpu`` class.  A bfloat16 leaf
(``"bfloat16"`` in a container's metas; an ``ml_dtypes.bfloat16`` NumPy
array inside a pickle) is read as its 16-bit patterns into a
``torch.bfloat16`` tensor, never through a NumPy bfloat16 dtype, so
``ml_dtypes`` is not needed.  The port writes a bfloat16 leaf as those
patterns (a uint16 array) tagged ``dtype="bfloat16"`` in a pickle, and
as ``"bfloat16"`` in a container.

``load`` returns torch tensors on ``device`` (the card unless the caller
passes ``"cpu"``), or with ``return_numpy`` NumPy arrays (a bfloat16
leaf, which NumPy cannot hold, stays a CPU ``torch.bfloat16`` tensor).
"""

from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch

from ..device import resolve_device
from ..observability.span import span as _obs_span

_MAGIC = b"PTCKPT01"
_ALIGN = 64
# below this many payload bytes the container's extra seeks cost more
# than they save
_CONTAINER_THRESHOLD = 1 << 20
_BF16 = "bfloat16"


class _TensorPayload:
    """A tensor leaf of a pickle: its NumPy array (for bfloat16, the
    uint16 bit patterns, with ``dtype`` "bfloat16")."""

    __slots__ = ("array", "dtype")

    def __init__(self, array, dtype=None):
        self.array = array
        self.dtype = dtype

    def __getstate__(self):
        return None, {"array": self.array, "dtype": self.dtype}

    def __setstate__(self, state):
        slots = state[1] if isinstance(state, tuple) else state
        self.array = _unwrap(slots["array"])
        self.dtype = slots.get("dtype")


class _PayloadRef:
    """A tensor leaf of a container's header: its payload's index."""

    __slots__ = ("index",)

    def __init__(self, index):
        self.index = index

    def __getstate__(self):
        return None, {"index": self.index}

    def __setstate__(self, state):
        slots = state[1] if isinstance(state, tuple) else state
        self.index = slots["index"]


class _BF16Scalar:
    """Stands in for ``ml_dtypes.bfloat16`` while unpickling."""


class _BF16Dtype:
    """Stands in for ``np.dtype(ml_dtypes.bfloat16)`` while unpickling."""

    def __setstate__(self, state):
        pass


def _np_dtype(*args):
    if args and args[0] is _BF16Scalar:
        return _BF16Dtype()
    return np.dtype(*args)


class _ArrayState:
    """Stands in for an unpickled ndarray: rebuilds it from its state, or
    a bfloat16 one as a ``torch.bfloat16`` tensor of its bit patterns."""

    def __init__(self, cls, shape, typecode):
        self.value = None

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        if isinstance(dtype, _BF16Dtype):
            bits = np.frombuffer(raw, np.uint16).copy().reshape(
                shape, order="F" if fortran else "C")
            self.value = _bf16_tensor(bits)
            return
        arr = np.ndarray.__new__(np.ndarray, (0,), np.uint8)
        arr.__setstate__(state)
        self.value = arr


def _unwrap(v):
    return v.value if isinstance(v, _ArrayState) else v


def _bf16_tensor(bits):
    """A ``torch.bfloat16`` tensor of the uint16 bit patterns ``bits``."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(
        torch.bfloat16)


class _Unpickler(pickle.Unpickler):
    _MAPPED = {
        ("paddle_tpu.framework.io", "_TensorPayload"): _TensorPayload,
        ("paddle_tpu.framework.io", "_PayloadRef"): _PayloadRef,
        ("ml_dtypes", "bfloat16"): _BF16Scalar,
        ("numpy", "dtype"): _np_dtype,
        ("numpy.core.multiarray", "_reconstruct"): _ArrayState,
        ("numpy._core.multiarray", "_reconstruct"): _ArrayState,
    }

    def find_class(self, module, name):
        mapped = self._MAPPED.get((module, name))
        if mapped is not None:
            return mapped
        if module.split(".")[0] in ("paddle_tpu", "ml_dtypes"):
            raise pickle.UnpicklingError(
                f"{module}.{name}: no counterpart in paddle_tpu_torch")
        return super().find_class(module, name)


# ---------------------------------------------------------------- saving
def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _TensorPayload(t.view(torch.int16).numpy().view(np.uint16),
                                  _BF16)
        return _TensorPayload(t.numpy())
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _payload_bytes(obj):
    if isinstance(obj, _TensorPayload):
        return obj.array.nbytes
    if isinstance(obj, dict):
        return sum(_payload_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_payload_bytes(v) for v in obj)
    return 0


def _swap_payloads(obj, payloads):
    """``_TensorPayload`` -> ``_PayloadRef``, appending ``(array, dtype
    name)`` to ``payloads``."""
    if isinstance(obj, _TensorPayload):
        a = np.ascontiguousarray(obj.array)
        payloads.append((a, obj.dtype or str(a.dtype)))
        return _PayloadRef(len(payloads) - 1)
    if isinstance(obj, dict):
        return {k: _swap_payloads(v, payloads) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_swap_payloads(v, payloads) for v in obj)
    return obj


def _save_container(saveable, path, protocol):
    payloads = []
    structure = _swap_payloads(saveable, payloads)
    metas = []
    offset = 0
    for a, dtype in payloads:
        offset = (offset + _ALIGN - 1) // _ALIGN * _ALIGN
        metas.append((dtype, a.shape, offset, a.nbytes))
        offset += a.nbytes
    header = pickle.dumps({"structure": structure, "metas": metas},
                          protocol=protocol)
    preamble = _MAGIC + len(header).to_bytes(8, "little") + header
    payload_start = (len(preamble) + _ALIGN - 1) // _ALIGN * _ALIGN
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(preamble)
        f.truncate(payload_start + offset)
        for (a, _), (_, _, off, nbytes) in zip(payloads, metas):
            if nbytes:
                f.seek(payload_start + off)
                f.write(memoryview(a.reshape(-1).view(np.uint8)))
    os.replace(tmp, path)


def save(obj, path, protocol=4, **configs):
    """Write ``obj`` (a tensor, or a dict/list/tuple tree holding
    tensors) to ``path``; each save is a ``checkpoint.save`` span on the
    observability timeline."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    saveable = _to_saveable(obj)
    nbytes = _payload_bytes(saveable)
    with _obs_span("checkpoint.save", cat="io",
                   event_args={"path": str(path), "payload_bytes": nbytes}):
        if nbytes >= _CONTAINER_THRESHOLD:
            _save_container(saveable, path, protocol)
            return
        with open(path, "wb") as f:
            pickle.dump(saveable, f, protocol=protocol)


# --------------------------------------------------------------- loading
def _leaf(array, dtype, return_numpy, device):
    """A loaded leaf: a NumPy array, or bfloat16 bits."""
    if dtype == _BF16:
        t = _bf16_tensor(array)
    elif isinstance(array, torch.Tensor):
        t = array
    elif return_numpy:
        return array
    else:
        t = torch.from_numpy(np.ascontiguousarray(array))
    return t if return_numpy else t.to(device)


def _resolve(obj, arrays, return_numpy, device):
    if isinstance(obj, _PayloadRef):
        return _leaf(*arrays[obj.index], return_numpy, device)
    if isinstance(obj, _TensorPayload):
        return _leaf(obj.array, obj.dtype, return_numpy, device)
    if isinstance(obj, _ArrayState):
        return obj.value
    if isinstance(obj, dict):
        return {k: _resolve(v, arrays, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_resolve(v, arrays, return_numpy, device)
                         for v in obj)
    return obj


def _load_container(f):
    f.seek(len(_MAGIC))
    header_len = int.from_bytes(f.read(8), "little")
    header = _Unpickler(io.BytesIO(f.read(header_len))).load()
    payload_start = (len(_MAGIC) + 8 + header_len + _ALIGN - 1) \
        // _ALIGN * _ALIGN
    arrays = []
    for dtype, shape, off, nbytes in header["metas"]:
        out = np.empty(shape, np.uint16 if dtype == _BF16 else
                       np.dtype(dtype))
        if nbytes:
            f.seek(payload_start + off)
            if f.readinto(memoryview(out.reshape(-1).view(np.uint8))) \
                    != nbytes:
                raise ValueError(f"truncated checkpoint payload at {off}")
        arrays.append((out, dtype))
    return header["structure"], arrays


def load(path, return_numpy=False, device=None, **configs):
    """Read a file that :func:`save` (or the JAX package's) wrote."""
    dev = None if return_numpy else resolve_device(device)
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) == _MAGIC:
            structure, arrays = _load_container(f)
        else:
            f.seek(0)
            structure, arrays = _Unpickler(f).load(), []
    return _resolve(structure, arrays, return_numpy, dev)
