"""Activation recomputation, the counterpart of
``paddle_tpu/distributed/recompute.py:22-113``.

``recompute(function, *args)`` runs ``function`` under
``torch.utils.checkpoint`` (non-reentrant): the forward keeps only the
inputs, and the backward runs ``function`` again to rebuild what its
gradient needs.  Parameters the function closes over (a layer's) get
their gradients as without recompute.

Dropout draws from the port's counter stream
(:mod:`paddle_tpu_torch.random`), which ``checkpoint``'s
``preserve_rng_state`` does not see, so the wrapper replays the stream
itself, as JAX does (``recompute.py:29-31, 52-56``): it notes the
stream's state before the forward, and the recomputation starts from
that state and puts the caller's stream back afterwards.  So the
recomputed masks are the forward's, and the loss and the gradients
equal those of the same steps without recompute.  Unlike JAX's, the
forward advances the caller's stream as the function would without
recompute (JAX's leaves it where it was, so there every recomputed layer
draws the same keys).
"""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from .. import random as _random


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward.  ``use_reentrant`` and ``preserve_rng_state`` are
    accepted and ignored (the port's stream is always replayed)."""
    kwargs.pop("use_reentrant", None)
    kwargs.pop("preserve_rng_state", None)
    start = _random.get_rng_state()
    calls = []

    def run(*a):
        if not calls:                 # the forward: advance the stream
            calls.append(1)
            return function(*a, **kwargs)
        saved = _random.get_rng_state()
        _random.set_rng_state(start)
        try:
            return function(*a, **kwargs)
        finally:
            _random.set_rng_state(saved)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Run the layers ``functions`` in ``ctx["segments"]`` segments (1 if
    not given), each under :func:`recompute`."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    n = len(layers)
    per = max(n // max(segments, 1), 1)
    out = args[0] if len(args) == 1 else args

    def run_segment(seg):
        def seg_fn(x):
            for layer in seg:
                x = layer(x)
            return x

        return seg_fn

    for i in range(0, n, per):
        out = recompute(run_segment(layers[i:i + per]), out)
    return out
