"""Device resolution for the port's entry points, and Paddle's device
functions, the counterparts of ``paddle_tpu/core/device.py``.

Every entry point (model constructors, every ``nn`` layer and
initializer, ``to_tensor``, ``convert``, ``serving.Engine``) runs on the CUDA card unless the caller asks for the CPU by name, or
:func:`set_device` named the CPU before.  With no card present the
default raises: nothing falls back to the CPU silently, so a run that
was meant for the card can never measure the CPU by accident.  So
``set_device("gpu")`` raises without a card, where JAX's falls back to
any device it has (``ROADMAP.md``, reference caveats).

Paddle's names read as torch's: ``"gpu"``, ``"gpu:0"``, ``"cuda"`` and
``"cuda:0"`` are the card, ``"cpu"`` the CPU.
"""

from __future__ import annotations

import torch

_CURRENT = [None]          # the device set_device chose, or None


def _torch_device(device):
    """A ``torch.device`` from a torch device or a name, Paddle's
    ``"gpu[:i]"`` read as ``"cuda[:i]"``."""
    if isinstance(device, (torch.device, int)):
        return torch.device(device)
    name = str(device).lower()
    if name == "gpu" or name.startswith("gpu:"):
        name = "cuda" + name[3:]
    return torch.device(name)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the device :func:`set_device` chose, else the current
    CUDA device; ``"cpu"`` only when asked for.  Raises
    ``RuntimeError`` when a CUDA device is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false.  A CUDA device
    comes back with its index, so it compares equal to the device of the
    tensors made on it."""
    if device is None:
        device = _CURRENT[0] if _CURRENT[0] is not None else "cuda"
    dev = _torch_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_device(device):
    """``paddle.set_device``: make ``device`` (``"gpu"``, ``"gpu:1"``,
    ``"cuda"``, ``"cpu"``, ...) the default of every entry point and
    return it as a ``torch.device``.  Raises where that device is
    missing."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {dev.index}: "
                               f"{torch.cuda.device_count()} present")
        torch.cuda.set_device(dev)
    _CURRENT[0] = dev
    return dev


def get_device() -> str:
    """The default device as Paddle names it: ``"gpu:0"`` or
    ``"cpu:0"``; raises, as :func:`resolve_device`, where the default is
    the card and there is none."""
    dev = resolve_device(None)
    return f"gpu:{dev.index}" if dev.type == "cuda" else "cpu:0"


def device_count() -> int:
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def synchronize():
    """Wait for the card's queued work (nothing to wait for on the
    CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
