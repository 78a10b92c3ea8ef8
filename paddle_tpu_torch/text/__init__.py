"""``paddle.text``, the counterpart of ``paddle_tpu/text/__init__.py``:
``viterbi_decode`` and ``ViterbiDecoder`` (the datasets need downloads,
as in JAX, and are not here).

The decode is JAX's recursion in plain torch on the tensors' device
(JAX scans it with ``lax.scan``; no Pallas kernel lies on it): one step
of a few ops per position, so the host issues about ``8 T`` small
kernels a call.  The conventions are JAX's: tag ``n - 1`` is BOS and
``n - 2`` EOS when ``include_bos_eos_tag``; steps past a sequence's
length carry alpha through; positions past it repeat the last valid
tag; among equal scores the lowest tag index wins (``torch.argmax``
returns the first maximum, as ``jnp.argmax``).  Scores are the
potentials' dtype, paths int32.
"""

from __future__ import annotations

import torch

from ..core import to_tensor
from ..nn.layers import Layer

__all__ = ["viterbi_decode", "ViterbiDecoder"]


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def _viterbi(potentials, trans, lengths, include_bos_eos_tag):
    """potentials [B, T, N], trans [N, N], lengths [B] -> (scores [B],
    paths [B, T] int32)."""
    b, t, n = potentials.shape
    lengths = lengths.to(device=potentials.device, dtype=torch.int64)
    alpha = potentials[:, 0]
    if include_bos_eos_tag:
        alpha = alpha + trans[n - 1][None, :]
    tags = torch.arange(n, device=potentials.device)[None, :]
    backptrs = []
    for step in range(1, t):
        # scores[b, i, j] = alpha[b, i] + trans[i, j]
        scores = alpha[:, :, None] + trans[None, :, :]
        best, best_prev = scores.amax(dim=1), scores.argmax(dim=1)
        active = (step < lengths)[:, None]
        alpha = torch.where(active, best + potentials[:, step], alpha)
        backptrs.append(torch.where(active, best_prev, tags))
    if include_bos_eos_tag:
        alpha = alpha + trans[:, n - 2][None, :]
    scores, tag = alpha.amax(dim=-1), alpha.argmax(dim=-1)
    path = [tag]
    for ptr in reversed(backptrs):        # ptr maps tag_{i+1} -> tag_i
        tag = ptr.gather(1, tag[:, None])[:, 0]
        path.append(tag)
    paths = torch.stack(path[::-1], dim=1)
    # positions past each length repeat the last valid tag
    last = paths.gather(1, ((lengths - 1) % t)[:, None])
    valid = torch.arange(t, device=paths.device)[None, :] < lengths[:, None]
    return scores, torch.where(valid, paths, last).to(torch.int32)


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """``(scores [B], paths [B, T])`` of the best tag sequences under
    ``potentials`` [B, T, N] and ``transition_params`` [N, N], each
    sequence ``lengths[b]`` long; on the potentials' device."""
    pot = _as_tensor(potentials)
    return _viterbi(pot, _as_tensor(transition_params).to(pot.device),
                    _as_tensor(lengths), bool(include_bos_eos_tag))


class ViterbiDecoder(Layer):
    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = _as_tensor(transitions)
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
