"""The port's random stream, the counterpart of ``paddle_tpu/core/random.py``.

JAX folds a counter into a base key (``fold_in(PRNGKey(seed), n)``); the
port keeps the same stream of keys, ``(seed, counter)`` pairs, one per
draw, and turns a key into a ``torch.Generator`` on the device of the
tensor it fills, seeded by :func:`key_seed` of the pair.  The global
torch RNG is never read.  So a draw depends only on the seed and on how
many keys were taken before it: a recomputed forward that rewinds the
counter (``distributed.recompute``) draws the same masks again.

The bits differ from JAX's threefry bits by design (as sampled tokens do,
``serving/sampling.py``): tests hold dropout to its properties, and
compare with JAX at p = 0 or in ``eval()``.

The stream is per thread, as JAX's.

Under a capture the draws come from elsewhere, so that a replayed
program draws anew: inside ``torch.compile`` (``jit.to_static``) a draw
takes the torch generator of its device, which ``to_static`` seeds from
one key of this stream per call; while ``jit.TrainStep.many`` captures a
CUDA graph, a draw takes the generator registered with that graph (its
offset advances on every replay).
"""

from __future__ import annotations

import contextlib
import threading

import torch

_MASK64 = (1 << 64) - 1


def key_seed(seed, counter):
    """The 64-bit generator seed of key ``(seed, counter)``: the
    splitmix64 finalizer over the pair packed into 64 bits, so
    neighbouring keys give unrelated streams."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(counter) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class _KeyStream:
    def __init__(self, seed):
        self.seed = int(seed)
        self.counter = 0

    def next_key(self):
        key = (self.seed, self.counter)
        self.counter += 1
        return key


class _RandomState(threading.local):
    def __init__(self):
        self.stream = _KeyStream(0)
        self.graph_generator = None


_STATE = _RandomState()


def seed(s):
    """``paddle.seed``: restart this thread's stream at ``(s, 0)``."""
    _STATE.stream = _KeyStream(s)


def next_key():
    """The next key ``(seed, counter)``; advances the counter."""
    return _STATE.stream.next_key()


def get_rng_state():
    return (_STATE.stream.seed, _STATE.stream.counter)


def set_rng_state(state):
    s, counter = state
    _STATE.stream = _KeyStream(s)
    _STATE.stream.counter = int(counter)


@contextlib.contextmanager
def fork_rng(s):
    """Draw from a fresh stream seeded by ``s`` inside the block, and
    leave this thread's stream as it was (JAX's ``fork_rng``)."""
    prev = _STATE.stream
    _STATE.stream = _KeyStream(s)
    try:
        yield
    finally:
        _STATE.stream = prev


def generator(key, device):
    """A ``torch.Generator`` on ``device`` seeded by ``key`` (None on the
    meta device, whose tensors hold no values to draw)."""
    if torch.device(device).type == "meta":
        return None
    g = _STATE.graph_generator
    if g is not None and torch.device(device).type == "cuda":
        return g
    g = torch.Generator(device=device)
    g.manual_seed(key_seed(*key))
    return g


def next_generator(device):
    """:func:`generator` of :func:`next_key`; under ``torch.compile``
    None (the device's torch generator, seeded per call by
    ``jit.to_static``: the module docstring)."""
    if torch.compiler.is_compiling():
        return None
    return generator(next_key(), device)


@contextlib.contextmanager
def graph_generator(g):
    """Inside the block every CUDA draw of this thread takes ``g`` (a
    generator registered with the CUDA graph being captured), and the
    stream's keys are not taken."""
    prev = _STATE.graph_generator
    _STATE.graph_generator = g
    try:
        yield
    finally:
        _STATE.graph_generator = prev
