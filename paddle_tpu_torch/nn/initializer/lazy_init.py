"""``LazyGuard``, the counterpart of
``paddle_tpu/nn/initializer/lazy_init.py``: a context manager that
changes nothing, as JAX's (parameters are made at construction)."""

import contextlib


class LazyGuard(contextlib.AbstractContextManager):
    def __exit__(self, *exc):
        return False
