"""``ParamAttr``, the counterpart of ``paddle_tpu/framework/param_attr.py``:
what ``nn.Layer.create_parameter`` gives a parameter (its name,
initializer, learning-rate multiplier, regularizer, trainability)."""

from __future__ import annotations


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """A ``ParamAttr`` from None or False (None: layers test for
        ``False`` first, which leaves the parameter out), a ``ParamAttr``,
        a name or an ``Initializer``; raises ``TypeError`` otherwise."""
        from ..nn.initializer.initializer import Initializer

        if attr is None or attr is False:
            return None
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")
