"""One optimizer step of a model, as ``paddle_tpu/jit/train_step.py``
``TrainStep.__call__``, run eagerly: zero the grads, ``loss_fn(model,
*batch)``, backward, then ``optimizer.step()`` (the grad clip, the
update of every parameter, the step count).  Returns the loss, detached.

The JAX step is one jitted XLA program; PyTorch runs eagerly, and the
hand-written kernels carry the attention and norms.  Not ported yet
(TPU/XLA machinery, each named in ROADMAP.md): AUTO layouts, the update
barrier, ``many()`` (whose Hopper counterpart is a CUDA graph of the
step), ``GradScaler``.  The grads are dropped after the update, as the
JAX step keeps none.
"""

from __future__ import annotations

from ..device import resolve_device


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, device=None):
        """``loss_fn(model, *batch) -> scalar loss``.  The model and the
        optimizer must live on ``device`` (``cuda`` unless the caller
        passes ``"cpu"``)."""
        self.device = resolve_device(device)
        for what, dev in (("model", next(model.parameters()).device),
                          ("optimizer", optimizer.device)):
            if dev != self.device:
                raise ValueError(f"{what} lives on {dev}, the step on "
                                 f"{self.device}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer

    def __call__(self, *batch):
        self.optimizer.clear_grad()
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()
