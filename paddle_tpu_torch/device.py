"""Device resolution for the port's entry points.

Every entry point (model constructors, ``convert``, ``serving.Engine``)
runs on the CUDA card unless the caller asks for the CPU by name.  With
no card present the default raises: nothing falls back to the CPU
silently, so a run that was meant for the card can never measure the
CPU by accident.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; ``"cpu"`` only when asked
    for.  Raises ``RuntimeError`` when a CUDA device is asked for
    (explicitly or by default) and ``torch.cuda.is_available()`` is
    false.  A CUDA device comes back with its index, so it compares
    equal to the device of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
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
