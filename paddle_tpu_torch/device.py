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

The rest is ``paddle.device`` (``paddle_tpu/device/__init__.py``): the
availability queries; ``cuda``, over ``torch.cuda`` (JAX's is a stub
without CUDA); ``tpu``, which finds no TPU; and ``Stream``, ``Event``,
``stream_guard``, ``current_stream``, ``set_stream`` and the ``stream``
namespace, with JAX's methods: real CUDA streams and events on the
card, and on the CPU, where work runs in order, a stream and an event
whose waits do nothing, as JAX's do.
"""

from __future__ import annotations

import contextlib

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


def get_default_device() -> torch.device:
    """The device every entry point defaults to (:func:`resolve_device`
    of None)."""
    return resolve_device(None)


def get_available_device():
    """``["gpu:0", ...]``, one a card; ``["cpu:0"]`` without one (JAX's
    lists its default backend's devices)."""
    n = torch.cuda.device_count()
    return [f"gpu:{i}" for i in range(n)] if n else ["cpu:0"]


def get_all_device_type():
    return ["gpu"] if torch.cuda.device_count() else ["cpu"]


def get_available_custom_device():
    return []


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    # the port runs eagerly: no graph compiler plays CINN's role (JAX's
    # says True for XLA)
    return False


def is_compiled_with_distribute() -> bool:
    return torch.distributed.is_available()


def get_cudnn_version():
    """cuDNN's version as an int (e.g. 90200), None without cuDNN."""
    if not torch.backends.cudnn.is_available():
        return None
    return torch.backends.cudnn.version()


def _cuda_index(device):
    """A card's index from None (the current card), an int, a name
    (``"gpu:1"``) or a torch device."""
    if device is None:
        return torch.cuda.current_device()
    dev = _torch_device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


class cuda:
    """``paddle.device.cuda`` over ``torch.cuda``: without a card it
    counts 0 devices and 0 bytes, as JAX's stub."""

    @staticmethod
    def device_count():
        return torch.cuda.device_count()

    @staticmethod
    def is_available():
        return torch.cuda.is_available()

    @staticmethod
    def empty_cache():
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    @staticmethod
    def synchronize(device=None):
        if torch.cuda.is_available():
            torch.cuda.synchronize(_cuda_index(device))

    @staticmethod
    def max_memory_allocated(device=None):
        if not torch.cuda.is_available():
            return 0
        return torch.cuda.max_memory_allocated(_cuda_index(device))

    @staticmethod
    def memory_allocated(device=None):
        if not torch.cuda.is_available():
            return 0
        return torch.cuda.memory_allocated(_cuda_index(device))


class tpu:
    """TPU introspection: the port finds no TPU."""

    @staticmethod
    def device_count():
        return 0

    @staticmethod
    def is_available():
        return False

    @staticmethod
    def synchronize():
        synchronize()

    @staticmethod
    def memory_stats(device=None):
        return {}


class Stream:
    """A stream on ``device`` (resolved as every entry point's): a new
    ``torch.cuda.Stream`` on the card; on the CPU a stream whose waits
    do nothing.  ``priority`` is accepted and ignored, as JAX's."""

    def __init__(self, device=None, priority=None):
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    @classmethod
    def _of(cls, device, raw):
        s = cls.__new__(cls)
        s.device, s._stream = device, raw
        return s

    def synchronize(self):
        if self._stream is not None:
            self._stream.synchronize()

    def wait_event(self, event):
        if self._stream is not None and event._event is not None:
            self._stream.wait_event(event._event)

    def wait_stream(self, stream):
        if self._stream is not None and stream._stream is not None:
            self._stream.wait_stream(stream._stream)

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event


class Event:
    """A ``torch.cuda.Event`` when the default device is the card, else
    an event that is always complete."""

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        self._event = (torch.cuda.Event(enable_timing=enable_timing,
                                        blocking=blocking,
                                        interprocess=interprocess)
                       if resolve_device(None).type == "cuda" else None)

    def record(self, stream=None):
        """Record on ``stream`` (default: the current stream)."""
        if self._event is None:
            return None
        raw = stream._stream if stream is not None else None
        self._event.record(raw if raw is not None
                           else torch.cuda.current_stream())
        return None

    def query(self):
        return True if self._event is None else self._event.query()

    def synchronize(self):
        if self._event is not None:
            self._event.synchronize()


def stream_guard(stream):
    """A context in which ``stream`` is the current stream."""
    if stream._stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream._stream)


def current_stream(device=None):
    dev = resolve_device(device)
    return Stream._of(dev, torch.cuda.current_stream(dev)
                      if dev.type == "cuda" else None)


def set_stream(stream):
    """Make ``stream`` the current stream; returns it, as JAX's."""
    if stream._stream is not None:
        torch.cuda.set_stream(stream._stream)
    return stream


class _StreamNS:
    Stream = Stream
    Event = Event
    stream_guard = staticmethod(stream_guard)
    current_stream = staticmethod(current_stream)
    set_stream = staticmethod(set_stream)


stream = _StreamNS()
