"""``static.amp``, the counterpart of ``paddle_tpu/static/amp.py``:
``decorate(optimizer)`` returns the static meta-optimizer
(``distributed/fleet/meta_optimizers/static_meta_optimizer.py``) with
only its amp strategy on, so ``minimize`` applies the cast rewrite and,
in float16, dynamic loss scaling; bfloat16 (``dtype="bfloat16"``) needs
none."""

from __future__ import annotations

__all__ = ["decorate", "AutoMixedPrecisionLists", "CustomOpLists"]


class AutoMixedPrecisionLists:
    """Custom white and black op-name lists, merged over the default
    ones (``amp.auto_cast.WHITE_LIST`` / ``BLACK_LIST``)."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None, dtype="float16"):
        self.custom_white_list = set(custom_white_list or ())
        self.custom_black_list = set(custom_black_list or ())
        if custom_black_varnames:
            raise NotImplementedError(
                "custom_black_varnames (per-variable amp exclusion) is not "
                "supported; use custom_black_list with op names")
        self.dtype = dtype


CustomOpLists = AutoMixedPrecisionLists


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True, use_pure_fp16=False,
             use_fp16_guard=None, dtype=None, level="O1",
             master_weight=None):
    """``static.amp.decorate``: ``optimizer`` wrapped so that
    ``minimize`` applies the mixed-precision rewrite.  The dtype is
    ``dtype``, else ``amp_lists.dtype``, else float16.
    ``use_fp16_guard`` and ``master_weight`` are accepted for Paddle's
    signature: the rewrite is by op lists, and the parameters stay f32."""
    from ..distributed.fleet.base.distributed_strategy import (
        DistributedStrategy,
    )
    from ..distributed.fleet.meta_optimizers.static_meta_optimizer import (
        StaticMetaOptimizer,
    )

    if dtype is None:
        dtype = getattr(amp_lists, "dtype", None) or "float16"
    strategy = DistributedStrategy()
    strategy.amp = True
    strategy.amp_configs = {
        "use_bf16": str(dtype) in ("bfloat16", "uint16", "paddle.bfloat16",
                                   "torch.bfloat16"),
        "init_loss_scaling": float(init_loss_scaling),
        "incr_every_n_steps": int(incr_every_n_steps),
        "decr_every_n_nan_or_inf": int(decr_every_n_nan_or_inf),
        "incr_ratio": float(incr_ratio),
        "decr_ratio": float(decr_ratio),
        "use_dynamic_loss_scaling": bool(use_dynamic_loss_scaling),
        "use_pure_fp16": bool(use_pure_fp16 or level == "O2"),
        "custom_white_list": sorted(
            getattr(amp_lists, "custom_white_list", ()) or ()),
        "custom_black_list": sorted(
            getattr(amp_lists, "custom_black_list", ()) or ()),
    }
    return StaticMetaOptimizer(optimizer, strategy)
