"""Paddle's flags, the counterpart of ``paddle_tpu/core/flags.py``: a dict
of flag values, set and read by :func:`set_flags` and :func:`get_flags`
(keys with or without the ``FLAGS_`` prefix).  JAX's five flags start at
JAX's defaults, or at their ``FLAGS_<name>`` environment variable, read
once at import and parsed by the default's type.  The values are stored
for the caller to read; setting ``check_nan_inf`` true turns on
``amp.debugging``'s tensor checker (JAX's turns on ``jax_debug_nans``),
and setting it false turns the checker off."""

from __future__ import annotations

import os

_DEFAULTS = {"check_nan_inf": False, "allocator_strategy": "xla_bfc",
             "deterministic": True, "embedding_deterministic": 1,
             "log_level": "INFO"}


def _norm(name):
    return name[6:] if name.startswith("FLAGS_") else name


def _parse(text, default):
    if isinstance(default, bool):
        return text.lower() in ("1", "true", "yes", "on")
    if isinstance(default, (int, float)):
        return type(default)(text)
    return text


_FLAGS = {k: _parse(os.environ[f"FLAGS_{k}"], v)
          if f"FLAGS_{k}" in os.environ else v
          for k, v in _DEFAULTS.items()}


def set_flags(flags):
    """Set each flag; a name not known yet is added."""
    flags = {_norm(k): v for k, v in flags.items()}
    _FLAGS.update(flags)
    if "check_nan_inf" in flags:
        from .amp import debugging

        if flags["check_nan_inf"]:
            debugging.enable_tensor_checker(
                debugging.TensorCheckerConfig(True))
        else:
            debugging.disable_tensor_checker()


def get_flags(names=None):
    """``{"FLAGS_<name>": value}`` of ``names`` (a name or a list; all
    flags by default), leaving out names not set."""
    if names is None:
        names = list(_FLAGS)
    if isinstance(names, str):
        names = [names]
    return {f"FLAGS_{_norm(n)}": _FLAGS[_norm(n)] for n in names
            if _norm(n) in _FLAGS}
