"""``paddle_tpu/inference`` (Paddle's ``paddle.inference``): the
Predictor over a program that ``jit.save`` wrote, through the
reference's handle workflow (``:1-137``) —

    config = Config("model.pdmodel", "model.pdiparams")
    predictor = create_predictor(config)
    inp = predictor.get_input_handle(predictor.get_input_names()[0])
    inp.copy_from_cpu(batch_np)
    predictor.run()
    out = predictor.get_output_handle(predictor.get_output_names()[0])
    result = out.copy_to_cpu()

— and ``create_llm_engine`` (``:139-215``), the predictor-style entry
point of LLM serving, over the port's ``serving.Engine``.  The predictor
runs on the card unless the config asks for the CPU
(``disable_gpu()``); the other toggles are accepted and change nothing
(the exported program is what runs)."""

from __future__ import annotations

import numpy as np
import torch


class Config:
    def __init__(self, model_path=None, params_path=None):
        self.model_path = model_path
        self.params_path = params_path
        self._use_gpu = True

    def enable_use_gpu(self, *a, **k):
        self._use_gpu = True

    def disable_gpu(self):
        """The caller asks for the CPU."""
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def switch_ir_optim(self, flag=True):
        pass

    def enable_memory_optim(self):
        pass

    def set_cpu_math_library_num_threads(self, n):
        pass

    def enable_mkldnn(self):
        pass

    def disable_glog_info(self):
        pass


class InferTensor:
    """Handle for one predictor input/output (``paddle.inference.Tensor``):
    host-side staging with copy_from_cpu/copy_to_cpu."""

    def __init__(self, name):
        self.name = name
        self._arr = None

    def copy_from_cpu(self, arr):
        self._arr = np.ascontiguousarray(arr)

    def copy_to_cpu(self):
        if self._arr is None:
            raise RuntimeError(f"tensor {self.name!r} holds no data")
        return np.asarray(self._arr)

    def reshape(self, shape):
        if self._arr is not None:
            self._arr = self._arr.reshape(shape)

    def shape(self):
        return [] if self._arr is None else list(self._arr.shape)


def _host(t):
    """An output as a NumPy array (bfloat16 values as float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Predictor:
    """Runs the program of ``jit.load`` (a :class:`jit.TranslatedLayer`):
    its output handles exist before the first run, named from the
    artifact; ``run()`` in handle mode or ``run([arrays])`` (returns the
    outputs as NumPy arrays)."""

    def __init__(self, config):
        from ..jit.api import load as jit_load

        prefix = config.model_path
        if prefix and prefix.endswith(".pdmodel"):
            prefix = prefix[: -len(".pdmodel")]
        self._layer = jit_load(prefix, params_path=config.params_path,
                               device=None if config.use_gpu() else "cpu")
        self._inputs = {n: InferTensor(n) for n in self._layer._input_names}
        self._output_order = list(self._layer._output_names)
        self._outputs = {n: InferTensor(n) for n in self._output_order}

    # ---------------- handle API (the reference workflow)
    def get_input_names(self):
        return list(self._inputs)

    def get_input_handle(self, name):
        if name not in self._inputs:
            raise KeyError(f"unknown input {name!r}; inputs are "
                           f"{list(self._inputs)}")
        return self._inputs[name]

    def get_output_names(self):
        return list(self._outputs)

    def get_output_handle(self, name):
        if name not in self._outputs:
            raise KeyError(f"unknown output {name!r}; outputs are "
                           f"{list(self._outputs)}")
        return self._outputs[name]

    # ---------------- execution
    def _call(self, arrays):
        outs = self._layer(*arrays)
        return outs if isinstance(outs, (list, tuple)) else [outs]

    def run(self, inputs=None):
        """Handle mode: run() after copy_from_cpu on every input handle.
        Legacy mode: run([np_arrays...]) returns a list of np arrays."""
        if inputs is not None:
            return [_host(o) for o in self._call(inputs)]
        missing = [n for n, h in self._inputs.items() if h._arr is None]
        if missing:
            raise RuntimeError(f"inputs not set: {missing}")
        outs = self._call([self._inputs[n]._arr for n in self._inputs])
        if len(outs) != len(self._output_order):
            raise RuntimeError(
                f"program returned {len(outs)} outputs but the artifact "
                f"declares {len(self._output_order)}")
        for name, o in zip(self._output_order, outs):
            # in place: previously fetched handles see fresh results
            self._outputs[name]._arr = _host(o)
        return True


def create_predictor(config):
    return Predictor(config)


def _mesh_shape(mesh_shape, tp):
    """JAX's ``MeshEngine._norm_mesh_knob``
    (``paddle_tpu/serving/sharded/mesh_engine.py:107-136``): the knob
    pair as ``(dp, tp)``, raising on nonsense as JAX does."""
    if mesh_shape is None:
        mesh_shape = (1, tp)
    try:
        shape = tuple(int(v) for v in mesh_shape)
    except (TypeError, ValueError):
        raise ValueError(f"unsupported mesh_shape {mesh_shape!r} "
                         "(expected a (dp, tp) pair of ints)") from None
    if len(shape) != 2:
        raise ValueError(f"unsupported mesh_shape {mesh_shape!r} "
                         "(expected exactly (dp, tp))")
    dp, tp_size = shape
    if tp is not None and int(tp) != tp_size:
        raise ValueError(f"tp={tp} contradicts mesh_shape {mesh_shape!r}")
    if tp_size < 1:
        raise ValueError(f"tp must be >= 1, got {tp_size}")
    if dp != 1:
        raise ValueError(
            f"dp={dp} is not supported yet: the dp axis is reserved for "
            "disaggregated prefill/decode (ROADMAP); use mesh_shape=(1, tp)")
    return shape


def create_llm_engine(model, mesh_shape=None, tp=None, **config_kwargs):
    """A ``serving.Engine`` over ``model`` (a ``GPTForCausalLM`` or
    ``LlamaForCausalLM``) on the model's device, the keyword arguments
    filling ``serving.EngineConfig`` (every knob JAX's docstring lists:
    slots, lengths, the prefix cache, chunked prefill, spec decoding, the
    int8 knobs, tracing, SLOs, telemetry, grammars, the host KV tier).
    ``tp`` / ``mesh_shape`` above 1 would pick JAX's tensor-parallel
    ``MeshEngine``, which the port does not have yet: they raise
    ``NotImplementedError`` (ROADMAP.md, port queue item 1, sharded
    serving); 1 (or None) gives the single-card engine."""
    from ..serving import Engine, EngineConfig

    if mesh_shape is not None or tp is not None:
        if _mesh_shape(mesh_shape, tp) != (1, 1):
            raise NotImplementedError(
                "create_llm_engine: tensor parallelism (tp > 1) needs the "
                "sharded MeshEngine, not ported yet (ROADMAP.md port queue "
                "item 1, sharded serving)")
    return Engine(model, EngineConfig(**config_kwargs), device=model.device)


__all__ = ["Config", "InferTensor", "Predictor", "create_predictor",
           "create_llm_engine"]
