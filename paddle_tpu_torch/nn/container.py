"""The containers, the counterparts of ``paddle_tpu/nn/layer/container.py``:
``Sequential``, ``LayerList``, ``LayerDict`` and ``ParameterList``, each a
``Layer`` over torch's container of the same role (``nn.Sequential``,
``nn.ModuleList``, ``nn.ModuleDict``, ``nn.ParameterList``).

``Sequential`` takes layers, one list of them, or ``(name, layer)``
pairs; a child's name (its index, or the pair's name) is its
``state_dict`` prefix, as ``layer1.0.conv1.weight``.  A slice is a new
``Sequential`` of the sliced layers, numbered from 0."""

from __future__ import annotations

from torch import nn

from .layers import Layer


class Sequential(Layer, nn.Sequential):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = layers[0]
        for idx, layer in enumerate(layers):
            name, layer = (layer if isinstance(layer, tuple)
                           else (str(idx), layer))
            self.add_module(name, layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return nn.Sequential.__getitem__(self, idx)


class LayerList(Layer, nn.ModuleList):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.extend(sublayers)


class LayerDict(Layer, nn.ModuleDict):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)


class ParameterList(Layer, nn.ParameterList):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            self.extend(parameters)
