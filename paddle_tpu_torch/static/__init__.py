"""``paddle.static``, the counterpart of ``paddle_tpu/static``: Paddle's
static-graph mode on the port.  Under ``paddle.enable_static()``,
``static.data`` placeholders are symbolic tensors, torch calls on them
are recorded as graph nodes (shapes from ``FakeTensorMode``), and
``Executor.run`` replays the fetched subgraph eagerly through the
port's kernels; ``Optimizer.minimize`` / ``append_backward`` train it
(``torch.autograd.grad`` over the replay and the optimizer's own
update), ``save_inference_model`` exports it as ``jit.save``'s artifact
(``inference.create_predictor`` serves it), ``static.nn`` holds ``fc``
and the control flow, and ``static.amp.decorate`` the mixed-precision
rewrite through the static meta-optimizer.  See ``graph.py``.
"""

import contextlib

from ..jit.api import InputSpec
from ..nn import Layer
from . import amp, nn
from .graph import (
    Executor,
    Program,
    StaticGraphError,
    append_backward,
    data,
    default_main_program,
    default_startup_program,
    disable_static,
    enable_static,
    in_static_mode,
    load_inference_model,
    parameters_of,
    program_guard,
    save_inference_model,
)


def name_scope(prefix=None):
    return contextlib.nullcontext()


__all__ = [
    "InputSpec", "Layer", "Executor", "Program", "StaticGraphError",
    "append_backward", "data", "default_main_program",
    "default_startup_program", "disable_static", "enable_static",
    "in_static_mode", "load_inference_model", "program_guard",
    "save_inference_model", "nn", "name_scope", "amp", "parameters_of",
]
