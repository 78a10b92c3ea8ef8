"""``paddle.version``, the counterpart of ``paddle_tpu/version/__init__.py``:
the package's version and the toolchain it runs on, here the CUDA and
cuDNN versions PyTorch was built with."""

import torch

full_version = "0.1.0"
major = "0"
minor = "1"
patch = "0"
rc = "0"
cuda_version = torch.version.cuda or "False"
cudnn_version = (str(torch.backends.cudnn.version())
                 if torch.backends.cudnn.is_available() else "False")
tensorrt_version = "None"
xpu_version = "False"
istaged = False
commit = "unknown"
with_pip_cuda_libraries = "OFF"


def show():
    print(f"full_version: {full_version}")
    print(f"major: {major}")
    print(f"minor: {minor}")
    print(f"patch: {patch}")
    print(f"rc: {rc}")
    print(f"commit: {commit}")
    print(f"cuda: {cuda_version}")
    print(f"cudnn: {cudnn_version}")


def cuda():
    return cuda_version


def cudnn():
    return cudnn_version


def xpu():
    return xpu_version


def tpu():
    """The TPU's device kind: ``"none"``, the port runs on CUDA."""
    return "none"
