"""``paddle.signal``, the counterpart of ``paddle_tpu/signal.py``:
``stft`` and ``istft`` over ``torch.fft`` (cuFFT on the card).

``stft`` computes JAX's function: with ``center`` the signal is padded
by ``n_fft // 2`` on each side in ``pad_mode`` (``jnp.pad``'s modes:
``reflect``, ``constant``, ``edge``, ``symmetric``, ``wrap``); frames of
``n_fft`` every ``hop_length`` (default ``n_fft // 4``) are multiplied
by the window, a shorter window centred inside ``n_fft`` (None is
rectangular), then transformed (``rfft`` when ``onesided``); with
``normalized`` the spectrum is divided by ``sqrt(n_fft)``.  The result
is ``[..., freq, frames]``.  ``istft`` inverts it: the inverse
transform of each frame times the window, overlap-added
(``F.fold``, which sums each output sample in a fixed order), divided by
the summed squared window (floored at 1e-11), trimmed for ``center``
and cut or zero-padded to ``length``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from .amp.auto_cast import cast_inputs

__all__ = ["istft", "stft"]


def _pad_signal(a, p, mode):
    """``jnp.pad(a, [(0, 0), ..., (p, p)], mode)`` on the last dim."""
    if mode == "constant":
        return TF.pad(a, (p, p))
    idx = np.pad(np.arange(a.shape[-1]), (p, p), mode=mode)
    return a[..., torch.from_numpy(idx).to(a.device)]


def _window(w, n_fft, win_length, dtype, device):
    if w is None:
        return torch.ones(n_fft, dtype=dtype, device=device)
    if win_length < n_fft:        # centre the window inside the fft size
        lp = (n_fft - win_length) // 2
        w = TF.pad(w, (lp, n_fft - win_length - lp))
    return w


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True):
    """``[..., T] -> [..., n_fft // 2 + 1 (or n_fft), frames]``."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    x, window = cast_inputs("stft", x, window)
    if center:
        x = _pad_signal(x, n_fft // 2, pad_mode)
    if x.shape[-1] < n_fft:
        raise ValueError(
            f"input length {x.shape[-1]} is shorter than frame length "
            f"{n_fft}; pad the signal or use center=True")
    frames = x.unfold(-1, n_fft, hop_length)     # [..., frames, n_fft]
    if window is not None:
        frames = frames * _window(window, n_fft, win_length, x.dtype,
                                  x.device)
    sp = (torch.fft.rfft(frames, dim=-1) if onesided
          else torch.fft.fft(frames, dim=-1))
    if normalized:
        sp = sp / torch.sqrt(torch.tensor(float(n_fft), dtype=sp.real.dtype,
                                          device=sp.device))
    return sp.transpose(-1, -2)


def _overlap_add(frames, hop):
    """``[B, F, n] -> [B, n + hop (F - 1)]``: frame f added at ``f *
    hop``."""
    b, f, n = frames.shape
    t = n + hop * (f - 1)
    return TF.fold(frames.transpose(1, 2), (1, t), (1, n),
                   stride=(1, hop)).reshape(b, t)


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False):
    """Overlap-add inverse of :func:`stft`, divided by the window
    envelope."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    x, window = cast_inputs("istft", x, window)
    sp = x.transpose(-1, -2)                      # [..., frames, freq]
    if normalized:
        sp = sp * torch.sqrt(torch.tensor(float(n_fft), dtype=sp.real.dtype,
                                          device=sp.device))
    if onesided:
        frames = torch.fft.irfft(sp, n=n_fft, dim=-1)
    else:
        frames = torch.fft.ifft(sp, dim=-1)
        if not return_complex:
            frames = frames.real
    wv = _window(window, n_fft, win_length, frames.real.dtype, frames.device)
    frames = frames * wv
    lead, (nf, n) = frames.shape[:-2], frames.shape[-2:]
    flat = frames.reshape(-1, nf, n)
    if flat.is_complex():
        out = torch.complex(_overlap_add(flat.real, hop_length),
                            _overlap_add(flat.imag, hop_length))
    else:
        out = _overlap_add(flat, hop_length)
    env = _overlap_add((wv * wv).expand(1, nf, n), hop_length)[0]
    out = (out / torch.clamp(env, min=1e-11)).reshape(*lead, -1)
    t = out.shape[-1]
    if center:
        out = out[..., n_fft // 2: t - n_fft // 2]
    if length is not None:
        if out.shape[-1] < length:
            out = TF.pad(out, (0, length - out.shape[-1]))
        out = out[..., :length]
    return out
