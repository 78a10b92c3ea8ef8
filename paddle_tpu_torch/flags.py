"""Paddle's flags, the counterpart of ``paddle_tpu/core/flags.py``: a dict
of flag values, set and read by :func:`set_flags` and :func:`get_flags`
(keys with or without the ``FLAGS_`` prefix).  JAX's five flags start at
JAX's defaults, or at their ``FLAGS_<name>`` environment variable, read
once at import and parsed by the default's type.  The values are stored
for the caller to read: nothing in the port reads them, and
``check_nan_inf``, which JAX's ``set_flags`` turns into
``jax_debug_nans``, raises when set true."""

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
    if flags.get("check_nan_inf"):
        raise NotImplementedError(
            "FLAGS_check_nan_inf: the port has no NaN/Inf check to turn on")
    _FLAGS.update(flags)


def get_flags(names=None):
    """``{"FLAGS_<name>": value}`` of ``names`` (a name or a list; all
    flags by default), leaving out names not set."""
    if names is None:
        names = list(_FLAGS)
    if isinstance(names, str):
        names = [names]
    return {f"FLAGS_{_norm(n)}": _FLAGS[_norm(n)] for n in names
            if _norm(n) in _FLAGS}
