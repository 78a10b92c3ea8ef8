"""``paddle.fft``, the counterpart of ``paddle_tpu/fft.py`` (all 18 of
its names) over ``torch.fft`` (cuFFT on the card; JAX computes these with
``jnp.fft``, outside Pallas).

Each transform runs where its tensor lies, asks
:func:`~paddle_tpu_torch.amp.auto_cast.cast_inputs` for its input's
dtype under JAX's op name, and transforms 16-bit floats in f32 (as
``jnp.fft`` promotes them), so a real input gives complex64.  ``norm``
is ``"backward"``, ``"ortho"`` or ``"forward"``.  The 2-D family
(``fft2``, ``ifft2``, ``rfft2``, ``irfft2``) takes the last two axes when
``axes`` is None, as Paddle's (JAX's passes None on to ``jnp.fft`` and
raises).  ``fftfreq`` and
``rfftfreq`` make f32 on the card unless asked for the CPU (``dtype``
is ignored, as JAX's).
"""

from __future__ import annotations

import torch

from .amp.auto_cast import cast_inputs
from .device import resolve_device

__all__ = [
    "fft", "fft2", "fftfreq", "fftn", "fftshift", "hfft", "ifft", "ifft2",
    "ifftn", "ifftshift", "ihfft", "irfft", "irfft2", "irfftn", "rfft",
    "rfft2", "rfftfreq", "rfftn",
]


def _input(name, x):
    (x,) = cast_inputs(name, x)
    if x.dtype in (torch.float16, torch.bfloat16):
        return x.float()
    return x if x.is_floating_point() or x.is_complex() else x.to(
        torch.get_default_dtype())


def _mk(name, tfn):
    def f(x, n=None, axis=-1, norm="backward"):
        return tfn(_input(name, x), n=n, dim=axis, norm=norm).resolve_conj()

    f.__name__ = f.__qualname__ = name
    f.__doc__ = f"``torch.fft.{name}`` along ``axis`` (JAX's ``{name}``)."
    return f


fft = _mk("fft", torch.fft.fft)
ifft = _mk("ifft", torch.fft.ifft)
rfft = _mk("rfft", torch.fft.rfft)
irfft = _mk("irfft", torch.fft.irfft)
hfft = _mk("hfft", torch.fft.hfft)
ihfft = _mk("ihfft", torch.fft.ihfft)


def _mk_n(name, tfn, default_axes):
    def f(x, s=None, axes=None, norm="backward"):
        if axes is not None:
            dims = tuple(axes)
        elif s is not None:
            dims = tuple(range(-len(s), 0))
        else:
            dims = default_axes
        return tfn(_input(name, x), s=s, dim=dims, norm=norm).resolve_conj()

    f.__name__ = f.__qualname__ = name
    f.__doc__ = f"``torch.fft.{name}`` over ``axes`` (JAX's ``{name}``)."
    return f


fft2 = _mk_n("fft2", torch.fft.fftn, (-2, -1))
ifft2 = _mk_n("ifft2", torch.fft.ifftn, (-2, -1))
rfft2 = _mk_n("rfft2", torch.fft.rfftn, (-2, -1))
irfft2 = _mk_n("irfft2", torch.fft.irfftn, (-2, -1))
fftn = _mk_n("fftn", torch.fft.fftn, None)
ifftn = _mk_n("ifftn", torch.fft.ifftn, None)
rfftn = _mk_n("rfftn", torch.fft.rfftn, None)
irfftn = _mk_n("irfftn", torch.fft.irfftn, None)


def fftfreq(n, d=1.0, dtype=None, device=None):
    return torch.fft.fftfreq(n, d, device=resolve_device(device),
                             dtype=torch.float32)


def rfftfreq(n, d=1.0, dtype=None, device=None):
    return torch.fft.rfftfreq(n, d, device=resolve_device(device),
                              dtype=torch.float32)


def fftshift(x, axes=None):
    return torch.fft.fftshift(x, dim=None if axes is None else tuple(axes)
                              if isinstance(axes, (list, tuple)) else axes)


def ifftshift(x, axes=None):
    return torch.fft.ifftshift(x, dim=None if axes is None else tuple(axes)
                               if isinstance(axes, (list, tuple)) else axes)
