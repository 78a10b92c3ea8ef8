"""``Sequential`` and ``LayerList``, the counterparts of
``paddle_tpu/nn/layer/container.py:11-77``.

``Sequential`` takes layers, one list of them, or ``(name, layer)``
pairs; a child's name (its index, or the pair's name) is its
``state_dict`` prefix, as ``layer1.0.conv1.weight``.  A slice is a new
``Sequential`` of the sliced layers, numbered from 0."""

from __future__ import annotations

from torch import nn


class Sequential(nn.Sequential):
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
        return super().__getitem__(idx)


class LayerList(nn.ModuleList):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)
