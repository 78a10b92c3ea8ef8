"""The static meta-optimizer, the counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/static_meta_optimizer.py``.

Paddle's fleet meta-optimizers rewrite the static program before the
executor runs it; here the recorded graph (``static/graph.py``) plays
the program, and :meth:`StaticMetaOptimizer.minimize` applies:

- **amp**: :func:`amp_rewrite` casts, in place, the floating inputs of
  every node the loss reads by its op name: the white list (matmul,
  linear, attention, ...) to the amp dtype, the black list (softmax,
  the norms, mean, ...) to f32, O2 every named op but the black list.
  float16 also trains behind dynamic loss scaling in the executor
  (scaled loss, unscaled gradients, the update skipped on a non-finite
  step, the scale grown and shrunk as JAX's ``_scaler_next``); bfloat16
  needs none;
- **recompute**: ``recompute_configs["checkpoints"]`` (symbolic tensors
  of the program) go on the owning Program; the executor runs each
  segment between checkpoints under ``torch.utils.checkpoint``;
- **gradient_merge**: gradients add up over ``k_steps`` runs and the
  update applies on every ``k``-th (``avg`` divides by the runs that
  landed);
- **lamb**: the inner optimizer becomes ``Lamb`` with
  ``lamb_configs["lamb_weight_decay"]`` and the name-substring
  ``exclude_from_weight_decay`` list.

The mesh strategies (static dp, mp, ZeRO-1 sharding) wait for ROADMAP.md
Queue 1 item 8 and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch


def _iter_nodes(root_refs):
    from ....static.graph import _Ref

    seen, stack = set(), [r.node for r in root_refs if r.node is not None]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        yield n
        for x in n.leaves:
            if isinstance(x, _Ref) and x.node is not None:
                stack.append(x.node)


def _cast(obj, dt):
    if isinstance(obj, torch.Tensor):
        return obj.to(dt) if obj.is_floating_point() and obj.dtype != dt \
            else obj
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_cast(o, dt) for o in obj)
    return obj


def _amp_cast_fn(fn, dt):
    """``fn`` with its floating tensor inputs cast to ``dt`` first (a
    differentiable ``Tensor.to``); the original stays reachable so a
    rewrite to another dtype replaces the cast instead of stacking."""
    def wrapped(*args, **kwargs):
        return fn(*_cast(args, dt),
                  **{k: _cast(v, dt) for k, v in kwargs.items()})

    wrapped._amp_static = dt
    wrapped._amp_orig = getattr(fn, "_amp_orig", fn)
    wrapped.__name__ = getattr(fn, "__name__", "op")
    return wrapped


def amp_rewrite(loss, dtype, level="O1", custom_white=(), custom_black=()):
    """The white/black-list cast rewrite of every node reachable from
    ``loss``, in place -> the number of nodes rewritten.  Idempotent per
    (node, dtype)."""
    from ....amp.auto_cast import BLACK_LIST, WHITE_LIST, to_torch_dtype
    from ....static.graph import StaticGraphError, is_symbolic

    if not is_symbolic(loss):
        raise StaticGraphError("amp rewrite expects a static loss Tensor")
    dtype = to_torch_dtype(dtype)
    white = set(WHITE_LIST) | set(custom_white)
    black = (set(BLACK_LIST) | set(custom_black)) - set(custom_white)
    n = 0
    for node in _iter_nodes([loss._ref()]):
        name = node.op_name or ""
        if not name or node.inplace:
            continue
        if name in black:
            dt = torch.float32
        elif level == "O2" or name in white:
            dt = dtype
        else:
            continue
        if getattr(node.fn, "_amp_static", None) == dt:
            continue
        node.fn = _amp_cast_fn(getattr(node.fn, "_amp_orig", node.fn), dt)
        n += 1
    return n


_META_ATTRS = ("_static_amp_scaler", "_gm_k", "_gm_avg", "_gm_buffers",
               "_gm_nacc", "_gm_count")


class StaticMetaOptimizer:
    """The optimizer that applies a ``DistributedStrategy`` to a static
    program: the inner optimizer's surface (its update, state, clip,
    rate; every read and write not of a meta attribute goes to it) plus
    the attributes the executor reads (``_static_amp_scaler``, ``_gm_k``,
    ``_gm_avg``)."""

    def __init__(self, optimizer, strategy=None):
        from ..base.distributed_strategy import DistributedStrategy

        self.__dict__["_inner"] = optimizer
        self.__dict__["_strategy"] = strategy or DistributedStrategy()
        self.__dict__["_static_amp_scaler"] = None
        self.__dict__["_gm_k"] = 1
        self.__dict__["_gm_avg"] = True
        self.__dict__["_gm_buffers"] = None
        self.__dict__["_gm_nacc"] = None
        self.__dict__["_gm_count"] = 0

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner"], name)

    def __setattr__(self, name, value):
        if name in self.__dict__ or name in _META_ATTRS:
            self.__dict__[name] = value
        else:
            setattr(self.__dict__["_inner"], name, value)

    @property
    def inner_opt(self):
        return self._inner

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        from ....static.graph import (StaticGraphError, is_symbolic,
                                      program_of, register_minimize)

        if not is_symbolic(loss):
            raise StaticGraphError(
                "StaticMetaOptimizer.minimize expects a static loss Tensor "
                "(build the model under paddle.enable_static())")
        strat = self._strategy
        h = strat.hybrid_configs
        if getattr(strat, "sharding", False) or any(
                h.get(k, 1) not in (1, -1) for k in
                ("dp_degree", "mp_degree", "pp_degree", "sharding_degree",
                 "sep_degree")):
            raise NotImplementedError(
                "static data/tensor parallel and ZeRO-1 sharding are not "
                "ported (ROADMAP.md, Queue 1 item 8)")
        if getattr(strat, "lamb", False):
            self.__dict__["_inner"] = self._as_lamb()
        if getattr(strat, "amp", False):
            cfg = strat.amp_configs
            use_bf16 = bool(cfg.get("use_bf16", True))
            dtype = torch.bfloat16 if use_bf16 else torch.float16
            level = "O2" if cfg.get("use_pure_fp16") else "O1"
            amp_rewrite(loss, dtype, level,
                        custom_white=cfg.get("custom_white_list") or (),
                        custom_black=cfg.get("custom_black_list") or ())
            if not use_bf16:
                dev = self._inner.device
                self._static_amp_scaler = {
                    "cfg": dict(cfg),
                    "state": {
                        "scale": torch.tensor(
                            float(cfg.get("init_loss_scaling", 32768.0)),
                            dtype=torch.float32, device=dev),
                        "good": torch.zeros((), dtype=torch.int32,
                                            device=dev),
                        "bad": torch.zeros((), dtype=torch.int32,
                                           device=dev),
                    },
                }
        if getattr(strat, "gradient_merge", False):
            gm = strat.gradient_merge_configs
            self._gm_k = max(1, int(gm.get("k_steps", 1)))
            self._gm_avg = bool(gm.get("avg", True))
            self._gm_buffers = None
            self._gm_count = 0
        result = register_minimize(self, loss, parameters=parameters,
                                   no_grad_set=no_grad_set)
        if getattr(strat, "recompute", False):
            cks = strat.recompute_configs.get("checkpoints") or []
            for t in cks:
                if not is_symbolic(t):
                    raise StaticGraphError(
                        "recompute_configs['checkpoints'] must be static "
                        "Tensors from the recorded program")
            program_of(loss)._recompute_checkpoints = list(cks)
        return result

    def _as_lamb(self):
        from ....optimizer.optimizers import Lamb

        inner = self._inner
        if isinstance(inner, Lamb):
            return inner
        cfg = self._strategy.lamb_configs
        excl = list(cfg.get("exclude_from_weight_decay") or [])
        fn = (lambda p: any(s in (getattr(p, "name", None) or "")
                            for s in excl)) if excl else None
        # an Adam-family inner optimizer keeps its betas and epsilon
        return Lamb(
            learning_rate=inner._learning_rate,
            lamb_weight_decay=float(cfg.get("lamb_weight_decay", 0.01)),
            beta1=float(getattr(inner, "_beta1", 0.9)),
            beta2=float(getattr(inner, "_beta2", 0.999)),
            epsilon=float(getattr(inner, "_epsilon", 1e-6)),
            parameters=inner._parameter_list,
            grad_clip=inner._grad_clip,
            exclude_from_weight_decay_fn=fn,
            device=inner.device,
        )

    def step(self):
        return self._inner.step()

    def clear_grad(self, *args, **kwargs):
        return self._inner.clear_grad(*args, **kwargs)

    clear_gradients = clear_grad

    @property
    def loss_scaling(self):
        """The current dynamic loss scale (1.0 without fp16 scaling)."""
        s = self._static_amp_scaler
        return float(s["state"]["scale"]) if s else 1.0

    def get_loss_scaling(self):
        return self.loss_scaling

    def amp_init(self, place=None, scope=None, test_program=None,
                 use_fp16_test=False):
        """Paddle's ``amp_init`` casts parameters for pure fp16; the cast
        rewrite already feeds each listed op the amp dtype and the
        parameters stay f32, so there is nothing to do."""
        return None
