"""``paddle.utils``, the counterpart of ``paddle_tpu/utils/__init__.py``:
``unique_name``, ``cpp_extension``, ``dlpack``, ``try_import``,
``run_check``, ``deprecated``, ``require_version`` and ``download``
(which reads only a local cache, as JAX's: there is no network)."""

from . import cpp_extension, dlpack, unique_name


def try_import(module_name, err_msg=None):
    import importlib

    try:
        return importlib.import_module(module_name)
    except ImportError:
        raise ImportError(err_msg
                          or f"{module_name} is required but not installed")


def run_check():
    """Check that the default device works: a 128 x 128 product on it,
    its device printed."""
    import torch

    from ..device import resolve_device

    dev = resolve_device()
    x = torch.ones((128, 128), device=dev)
    y = x @ x
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"paddle_tpu_torch works on {dev} ({where}) "
          f"({float(y[0, 0])})")


def deprecated(update_to="", since="", reason="", level=0):
    def decorator(fn):
        return fn

    return decorator


def require_version(min_version, max_version=None):
    """True if the installed version lies in [min_version, max_version];
    raises otherwise."""
    from ..version import full_version

    def _key(v):
        return tuple(int(x) for x in str(v).split(".")[:3] if x.isdigit())

    cur = _key(full_version)
    if _key(min_version) > cur:
        raise RuntimeError(
            f"installed version {full_version} < required {min_version}")
    if max_version is not None and _key(max_version) < cur:
        raise RuntimeError(
            f"installed version {full_version} > allowed {max_version}")
    return True


def download(url, path=None, md5sum=None, method="get"):
    """The cached copy of ``url``'s file under ``$PPTPU_DATA_HOME``
    (default ``~/.cache/paddle_tpu``); raises where it is not there
    (nothing is fetched)."""
    import os

    cache = os.environ.get("PPTPU_DATA_HOME",
                           os.path.expanduser("~/.cache/paddle_tpu"))
    fname = os.path.join(cache, os.path.basename(url))
    if os.path.exists(fname):
        return fname
    raise RuntimeError(
        f"nothing is downloaded: place {os.path.basename(url)!r} under "
        f"{cache} (PPTPU_DATA_HOME) to use it")
