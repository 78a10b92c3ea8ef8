"""``summary``, the counterpart of ``paddle_tpu/hapi/model_summary.py``:
a table of each module's own parameters (a module with sublayers and
none of its own is left out) and the totals, printed and returned.
Trainable means ``requires_grad``."""

from __future__ import annotations


def summary(net, input_size=None, dtypes=None, input=None):
    rows = []
    total_params = 0
    trainable_params = 0
    for name, layer in net.named_modules():
        own = [p for p in layer._parameters.values() if p is not None]
        n_params = sum(p.numel() for p in own)
        if n_params == 0 and layer._modules:
            continue
        total_params += n_params
        trainable_params += sum(p.numel() for p in own if p.requires_grad)
        rows.append((name or type(layer).__name__, type(layer).__name__,
                     n_params))
    width = max((len(r[0]) for r in rows), default=10) + 2
    lines = [f"{'Layer':<{width}}{'Type':<28}{'Params':>12}",
             "-" * (width + 40)]
    for name, ty, n in rows:
        lines.append(f"{name:<{width}}{ty:<28}{n:>12,}")
    lines.append("-" * (width + 40))
    lines.append(f"Total params: {total_params:,}")
    lines.append(f"Trainable params: {trainable_params:,}")
    print("\n".join(lines))
    return {"total_params": total_params,
            "trainable_params": trainable_params}
