"""``paddle.onnx``, the counterpart of ``paddle_tpu/onnx/__init__.py``:
``export`` writes the port's serving artifact through ``jit.save`` (a
``torch.export`` program, ``<path>.pdmodel``, and the weights,
``<path>.pdiparams``), loadable by ``jit.load`` and servable by
``inference`` Predictors.  It is not an ``.onnx`` protobuf: the
environment has no ``onnx`` package, and a consumer that needs true ONNX
runs paddle2onnx against the reference framework.
"""

from __future__ import annotations

import warnings

__all__ = ["export"]


def export(layer, path, input_spec=None, opset_version=9, **configs):
    """Export ``layer`` as the serving artifact.  Signature-compatible
    with ``paddle.onnx.export``: ``opset_version`` and extra configs are
    accepted and ignored.  ``path`` is a prefix without the format suffix
    (a trailing ``.onnx`` is dropped); the artifact lands at
    ``<path>.pdmodel`` + ``<path>.pdiparams``.  Returns the prefix."""
    if input_spec is None:
        raise ValueError(
            "paddle.onnx.export requires input_spec (the reference "
            "requires it for dynamic-graph export too)")
    if path.endswith(".onnx"):
        path = path[: -len(".onnx")]
    warnings.warn(
        "paddle_tpu_torch.onnx.export writes a torch.export artifact "
        f"('{path}.pdmodel'), not an ONNX protobuf (loadable via jit.load, "
        "servable via paddle_tpu_torch.inference).", stacklevel=2)
    from ..jit.api import save as jit_save

    jit_save(layer, path, input_spec=input_spec)
    return path
