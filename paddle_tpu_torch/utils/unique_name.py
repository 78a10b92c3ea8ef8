"""``paddle.utils.unique_name``, the counterpart of
``paddle_tpu/utils/unique_name.py``: ``generate(key)`` gives ``key_0``,
``key_1``, ... from a counter per key; ``guard`` runs a block on fresh
counters and puts the old ones back, ``switch`` starts fresh ones."""

from __future__ import annotations

import contextlib

_COUNTERS = {}


def generate(key):
    idx = _COUNTERS.get(key, 0)
    _COUNTERS[key] = idx + 1
    return f"{key}_{idx}"


@contextlib.contextmanager
def guard(new_generator=None):
    global _COUNTERS
    saved = _COUNTERS
    _COUNTERS = {}
    try:
        yield
    finally:
        _COUNTERS = saved


def switch(new_generator=None):
    global _COUNTERS
    _COUNTERS = {}
