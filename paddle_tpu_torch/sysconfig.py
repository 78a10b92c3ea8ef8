"""``paddle.sysconfig``, the counterpart of ``paddle_tpu/sysconfig.py``:
where the port's kernel headers and built libraries live."""

import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def get_include():
    """The directory of the CUDA sources and headers (``csrc``)."""
    return os.path.join(_HERE, "csrc")


def get_lib():
    """The directory the kernels' shared libraries are built into."""
    return os.path.join(_HERE, "build")
