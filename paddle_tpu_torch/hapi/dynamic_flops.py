"""``flops``, the counterpart of ``paddle_tpu/hapi/dynamic_flops.py``: the
FLOPs of one forward of ``input_size`` random normal inputs (drawn from
the port's counter stream), counted by
forward hooks in JAX's terms: a ``Linear`` 2 x its weight's size per
input row, a convolution 2 x its weight's size over its output channels
per output element; ``custom_ops`` maps a module type to its own count
``fn(module, x, output)``.  The network runs in ``eval()`` mode without
gradients, on its own device and dtype, and gets its mode back."""

from __future__ import annotations

import torch

from .. import random as _random


def flops(net, input_size, custom_ops=None, print_detail=False):
    from ..nn.common import Linear
    from ..nn.conv import _ConvNd

    total = [0]

    def count(layer, inputs, output):
        x = inputs[0] if inputs else None
        if custom_ops and type(layer) in custom_ops:
            total[0] += custom_ops[type(layer)](layer, x, output)
        elif isinstance(layer, Linear):
            rows = x.numel() // x.shape[-1] if x is not None else 1
            total[0] += 2 * layer.weight.numel() * rows
        elif isinstance(layer, _ConvNd) and isinstance(output, torch.Tensor):
            total[0] += (2 * output.numel() * layer.weight.numel()
                         // layer.weight.shape[0])

    ref = next(net.parameters())
    hooks = [m.register_forward_hook(count) for m in net.modules()]
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(torch.randn(list(input_size), device=ref.device,
                            dtype=ref.dtype, generator=(
                                _random.next_generator(ref.device))))
    finally:
        net.train(was_training)
        for h in hooks:
            h.remove()
    if print_detail:
        print(f"Total FLOPs: {total[0]:,}")
    return total[0]
