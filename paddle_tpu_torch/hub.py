"""``paddle.hub``, the counterpart of ``paddle_tpu/hub.py``: ``list``,
``help`` and ``load`` over a local directory holding a ``hubconf.py``,
whose public callables are the entry points.  Any other source raises,
as JAX's: nothing is fetched."""

from __future__ import annotations

import importlib.util
import os
import sys

_HUBCONF = "hubconf.py"


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, _HUBCONF)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {_HUBCONF} in {repo_dir!r}")
    spec = importlib.util.spec_from_file_location("hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, repo_dir)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(repo_dir)
    return mod


def _require_local(source):
    if source != "local":
        raise RuntimeError(
            f"hub source {source!r} needs the network, which the port "
            "does not use; clone the repo and use source='local'")


def _entry(repo_dir, model):
    fn = getattr(_load_hubconf(repo_dir), model, None)
    if fn is None:
        raise ValueError(f"no entry point {model!r} in {repo_dir}")
    return fn


def list(repo_dir, source="local", force_reload=False):  # noqa: A001
    _require_local(source)
    mod = _load_hubconf(repo_dir)
    return [n for n in dir(mod)
            if callable(getattr(mod, n)) and not n.startswith("_")]


def help(repo_dir, model, source="local", force_reload=False):  # noqa: A001
    _require_local(source)
    return _entry(repo_dir, model).__doc__


def load(repo_dir, model, source="local", force_reload=False, **kwargs):
    _require_local(source)
    return _entry(repo_dir, model)(**kwargs)
