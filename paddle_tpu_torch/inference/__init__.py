"""``paddle_tpu/inference`` (Paddle's ``paddle.inference``):
``create_llm_engine`` (``:139-215``), the predictor-style entry point of
LLM serving, over the port's ``serving.Engine``.  ``Config``,
``Predictor`` and ``create_predictor`` load programs saved by
``jit.save`` and wait for it (ROADMAP.md)."""

from __future__ import annotations


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


__all__ = ["create_llm_engine"]
